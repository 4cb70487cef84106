// Fused split-impulse contact solver for the one free plug body per env.
//
// Replaces the TPU kernel isaacgyminsertion_tpu/physics/solver_pallas.py::
// _solver_kernel (called through solve_contacts_fused). Computes what that
// kernel computes, in the port's own layout: 16 Jacobi velocity iterations
// (a normal pass — rigid: zero-bias inelastic impulse with lambda >= 0; soft
// gel: impulse-clamped spring-damper — then a Coulomb friction pass with the
// rotational tangential effective mass), followed by 8 rigid-only
// position-correction iterations. The plain PyTorch version is
// physics/solver_kernel.py::solve_contacts_fused_plain.
//
// Layout: contacts are read as the port's ContactSet, r/n/v_other [N, C, 3]
// and depth/mu/weight/stiffness [N, C]; per-env mass [N], I_inv [N, 3, 3],
// v/w [N, 3]. Outputs v, w, dx, dth [N, 3], lam_n [N, C], lam_t [N, C, 3].
//
// What bounds it on an H100. By the dense count it is bound by operations:
// about 2,800 f32 operations per contact per launch (FLOPS_* in
// solver_kernel.py) against 68 bytes per contact, ~0.73 GFLOP (~11 us at
// 67 TFLOP/s) vs ~17.9 MB (~5.3 us at 3.35 TB/s) at N = 1024, C = 255. What
// it really costs is neither: the 40 passes of one env are one serial chain
// (each pass needs the body state the pass before it left), so the launch
// takes as long as the slowest warp's chain of dependent instructions, and
// the card's throughput hardly enters. The design therefore shortens the chain:
//
//  - Only active contacts are solved. A contact with depth <= 0 or weight == 0
//    has zero effective mass, so its impulses stay exactly 0 in every pass and
//    it adds exact zeros to every sum. At setup each warp reads depth and
//    weight coalesced, and a __ballot_sync + __popc prefix gives every active
//    contact its slot, in contact order (so the order of summation is fixed
//    and two launches on the same inputs agree bit for bit). An env in
//    contact typically has 10-40 active contacts of its 255: they sit one per
//    lane instead of eight per lane, and the chain is that of one contact.
//  - One warp per env. Lane l holds the active contacts of slots l, l + 32,
//    ... in registers for all iterations; a warp-uniform branch on the env's
//    active count K picks the body with ceil(K / 32) rounded up to 1, 2, 4 or
//    8 slots per lane, so C up to 256 with every contact active still runs.
//    The contact data is gathered from device memory once, the impulses are
//    written once; inert contacts get zeros from a coalesced fill at setup.
//  - Two light envs share a warp. On a substep after reset every env has
//    10-15 active contacts (the gel pads on the plug). Envs 2i and 2i + 1
//    with at most 16 active contacts each are solved by one warp, one per
//    half warp: at 1024 envs two warps no longer share a scheduler (the solve
//    then costs what it costs at 256 envs), and the butterfly is 4 steps.
//  - The per-env body state (v, w, dx, dth, inverse inertia) is replicated in
//    every lane; each pass ends with a 6-value xor-butterfly all-reduce of
//    (sum f, sum r x f). A xor butterfly adds the same two operands in the
//    same order in every lane pair, so all lanes end with bit-identical sums
//    and the replicated state never drifts. No atomics.
//  - Fewer slow instructions on the chain: the tangent direction vt / |vt| is
//    one IEEE reciprocal and three multiplies (not three divisions); the
//    normal and position passes use r x n and n . v_other, formed once per
//    contact (n . (v + w x r - v_other) = n . v + (r x n) . w - n . v_other);
//    the soft-contact gate (depth > 0) is dropped because it is 1 for every
//    contact that is solved. Against the plain version these move a term by
//    1-2 ulp, far inside the solver tolerances (rtol 2e-3 .. 5e-3), which
//    exist because the order of summation differs anyway.
//  - The position phase is skipped when the env has no active rigid contact
//    (every impulse of that phase is then exactly 0, and so are dx and dth).
//  - An env with no active contact returns its input velocities.
//
// fp32 throughout; division and sqrtf stay IEEE (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxContacts = 256;
constexpr unsigned kFull = 0xffffffffu;

struct SolverArgs {
  const float *r, *nrm, *vother, *depth, *mu, *weight, *stiff, *mass, *I_inv, *v_in, *w_in;
  float *out_v, *out_w, *out_dx, *out_dth, *lam_n, *lam_t;
  int N, C;
  float h;
  int iters, pos_iters;
  float beta_pos, slop, max_corr;
};

// Sum over the lanes that hold one env: the whole warp, or each half of it.
template <bool HALF>
__device__ __forceinline__ float env_allsum(float x) {
#pragma unroll
  for (int o = HALF ? 8 : 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The solve of one env by the lanes that hold it: K active contacts, their
// contact indices in idx[0..K). HALF = false: the env has the whole warp, slot
// s sits in lane s % 32 as its (s / 32)-th contact (slot0 = lane). HALF =
// true: two envs of at most 16 active contacts share the warp, one per half,
// slot s in lane s of its half (slot0 = lane % 16, CPL = 1); env, K, idx and
// all body state are then per half, and the butterfly stays inside a half.
// `writer` marks the one lane per env that stores the body outputs.
template <int CPL, bool HALF>
__device__ __forceinline__ void solve_env(const SolverArgs& a, int env, int slot0, int K,
                                          const unsigned char* idx, bool writer) {
  static_assert(!HALF || CPL == 1, "a half warp holds one contact per lane");
  const long long cbase = (long long)env * a.C;
  const float h = a.h;

  float RX[CPL], RY[CPL], RZ[CPL], NX[CPL], NY[CPL], NZ[CPL];
  float VOX[CPL], VOY[CPL], VOZ[CPL], D[CPL], MU[CPL];
  float TX[CPL], TY[CPL], TZ[CPL], NVO[CPL];  // r x n and n . v_other
  float act[CPL], meff[CPL], spring[CPL], cimp[CPL];
  bool soft[CPL];
  float lam[CPL], ltx[CPL], lty[CPL], ltz[CPL];
  int cid[CPL];

  // per-env scalars, replicated in every lane (same-address broadcast loads)
  const float inv_m = 1.0f / fmaxf(a.mass[env], 1e-12f);
  const float ms = 1.0f / fmaxf(inv_m, 1e-12f);
  const float* Ie = a.I_inv + (long long)env * 9;
  const float I00 = Ie[0], I01 = Ie[1], I02 = Ie[2];
  const float I10 = Ie[3], I11 = Ie[4], I12 = Ie[5];
  const float I20 = Ie[6], I21 = Ie[7], I22 = Ie[8];
  float vx = a.v_in[env * 3 + 0], vy = a.v_in[env * 3 + 1], vz = a.v_in[env * 3 + 2];
  float wx = a.w_in[env * 3 + 0], wy = a.w_in[env * 3 + 1], wz = a.w_in[env * 3 + 2];

  // gather the active contacts; a slot past K is inert (zero mass, depth -1)
  float part = 0.0f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int s = slot0 + 32 * k;
    float st = 0.0f;
    if (s < K) {
      const int c = idx[s];
      const long long i = cbase + c;
      cid[k] = c;
      RX[k] = a.r[3 * i + 0]; RY[k] = a.r[3 * i + 1]; RZ[k] = a.r[3 * i + 2];
      NX[k] = a.nrm[3 * i + 0]; NY[k] = a.nrm[3 * i + 1]; NZ[k] = a.nrm[3 * i + 2];
      VOX[k] = a.vother[3 * i + 0]; VOY[k] = a.vother[3 * i + 1]; VOZ[k] = a.vother[3 * i + 2];
      D[k] = a.depth[i]; MU[k] = a.mu[i]; act[k] = a.weight[i]; st = a.stiff[i];
    } else {
      cid[k] = -1;
      RX[k] = RY[k] = RZ[k] = NX[k] = NY[k] = NZ[k] = 0.0f;
      VOX[k] = VOY[k] = VOZ[k] = 0.0f;
      D[k] = -1.0f; MU[k] = 0.0f; act[k] = 0.0f;
    }
    TX[k] = RY[k] * NZ[k] - RZ[k] * NY[k];
    TY[k] = RZ[k] * NX[k] - RX[k] * NZ[k];
    TZ[k] = RX[k] * NY[k] - RY[k] * NX[k];
    NVO[k] = NX[k] * VOX[k] + NY[k] * VOY[k] + NZ[k] * VOZ[k];
    soft[k] = st > 0.0f;
    spring[k] = st;  // stiffness until the masses are known
    part += act[k];
  }
  const float n_active = fmaxf(env_allsum<HALF>(part), 1.0f);
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const float st = spring[k];
    const float d_pos = fmaxf(D[k], 0.0f);
    meff[k] = act[k] * ms / n_active;
    spring[k] = fminf(h * st * d_pos, 0.25f * meff[k] * d_pos / h);
    cimp[k] = fminf(0.5f * sqrtf(st * ms) * h, 0.5f * meff[k]);
    lam[k] = ltx[k] = lty[k] = ltz[k] = 0.0f;
  }

  for (int it = 0; it < a.iters; ++it) {
    // ---- normal pass (zero bias: split impulse)
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, tx = 0.0f, ty = 0.0f, tz = 0.0f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      // n . (v + w x r - v_other) = n . v + (r x n) . w - n . v_other
      const float vn = (NX[k] * vx + NY[k] * vy + NZ[k] * vz) +
                       (TX[k] * wx + TY[k] * wy + TZ[k] * wz) - NVO[k];
      const float lam_rigid = fmaxf(lam[k] - vn * meff[k], 0.0f);
      const float lam_soft = fmaxf(spring[k] - cimp[k] * vn, 0.0f);
      const float lnew = soft[k] ? lam_soft : lam_rigid;
      const float dl = lnew - lam[k];
      lam[k] = lnew;
      fx += NX[k] * dl; fy += NY[k] * dl; fz += NZ[k] * dl;
      tx += TX[k] * dl; ty += TY[k] * dl; tz += TZ[k] * dl;   // r x (n dl)
    }
    fx = env_allsum<HALF>(fx); fy = env_allsum<HALF>(fy); fz = env_allsum<HALF>(fz);
    tx = env_allsum<HALF>(tx); ty = env_allsum<HALF>(ty); tz = env_allsum<HALF>(tz);
    vx = vx + fx * inv_m; vy = vy + fy * inv_m; vz = vz + fz * inv_m;
    wx = wx + I00 * tx + I01 * ty + I02 * tz;
    wy = wy + I10 * tx + I11 * ty + I12 * tz;
    wz = wz + I20 * tx + I21 * ty + I22 * tz;

    // ---- friction pass
    fx = fy = fz = tx = ty = tz = 0.0f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float vcx = vx + (wy * RZ[k] - wz * RY[k]) - VOX[k];
      const float vcy = vy + (wz * RX[k] - wx * RZ[k]) - VOY[k];
      const float vcz = vz + (wx * RY[k] - wy * RX[k]) - VOZ[k];
      const float vn = NX[k] * vcx + NY[k] * vcy + NZ[k] * vcz;
      const float vtx = vcx - vn * NX[k];
      const float vty = vcy - vn * NY[k];
      const float vtz = vcz - vn * NZ[k];
      const float inv_vt = 1.0f / sqrtf(vtx * vtx + vty * vty + vtz * vtz + 1e-16f);
      const float hx = vtx * inv_vt, hy = vty * inv_vt, hz = vtz * inv_vt;
      const float ux = RY[k] * hz - RZ[k] * hy;
      const float uy = RZ[k] * hx - RX[k] * hz;
      const float uz = RX[k] * hy - RY[k] * hx;
      const float ang = ux * (I00 * ux + I01 * uy + I02 * uz) +
                        uy * (I10 * ux + I11 * uy + I12 * uz) +
                        uz * (I20 * ux + I21 * uy + I22 * uz);
      const float meff_t = act[k] / (n_active * (inv_m + ang));
      float ntx = ltx[k] - vtx * meff_t;
      float nty = lty[k] - vty * meff_t;
      float ntz = ltz[k] - vtz * meff_t;
      const float lt_mag = sqrtf(ntx * ntx + nty * nty + ntz * ntz);
      const float lt_max = MU[k] * lam[k];
      const float scale = fminf(1.0f, lt_max / fmaxf(lt_mag, 1e-12f));
      ntx *= scale; nty *= scale; ntz *= scale;
      const float ax = ntx - ltx[k], ay = nty - lty[k], az = ntz - ltz[k];
      ltx[k] = ntx; lty[k] = nty; ltz[k] = ntz;
      fx += ax; fy += ay; fz += az;
      tx += RY[k] * az - RZ[k] * ay;
      ty += RZ[k] * ax - RX[k] * az;
      tz += RX[k] * ay - RY[k] * ax;
    }
    fx = env_allsum<HALF>(fx); fy = env_allsum<HALF>(fy); fz = env_allsum<HALF>(fz);
    tx = env_allsum<HALF>(tx); ty = env_allsum<HALF>(ty); tz = env_allsum<HALF>(tz);
    vx = vx + fx * inv_m; vy = vy + fy * inv_m; vz = vz + fz * inv_m;
    wx = wx + I00 * tx + I01 * ty + I02 * tz;
    wy = wy + I10 * tx + I11 * ty + I12 * tz;
    wz = wz + I20 * tx + I21 * ty + I22 * tz;
  }

  // the velocity-phase impulses are final: write them over the zero fill
  // (ordered after it by the __syncwarp of the caller), free the registers
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (cid[k] >= 0) {
      const long long i = cbase + cid[k];
      a.lam_n[i] = lam[k];
      a.lam_t[3 * i + 0] = ltx[k];
      a.lam_t[3 * i + 1] = lty[k];
      a.lam_t[3 * i + 2] = ltz[k];
    }
  }

  // ---- position correction (rigid contacts only)
  part = 0.0f;
  bool any_rigid = false;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    act[k] = soft[k] ? 0.0f : act[k];
    any_rigid = any_rigid || act[k] != 0.0f;
    part += act[k];
  }
  float dx = 0.0f, dy = 0.0f, dz = 0.0f, thx = 0.0f, thy = 0.0f, thz = 0.0f;
  if (__any_sync(kFull, any_rigid)) {  // warp-uniform
    const float n_act_pos = fmaxf(env_allsum<HALF>(part), 1.0f);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      meff[k] = act[k] * ms / n_act_pos;
      lam[k] = 0.0f;
    }
    for (int it = 0; it < a.pos_iters; ++it) {
      float fx = 0.0f, fy = 0.0f, fz = 0.0f, tx = 0.0f, ty = 0.0f, tz = 0.0f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const float move_n = (NX[k] * dx + NY[k] * dy + NZ[k] * dz) +
                             (TX[k] * thx + TY[k] * thy + TZ[k] * thz);
        const float depth_cur = D[k] - move_n;
        const float corr = fminf(fmaxf(a.beta_pos * (depth_cur - a.slop), 0.0f), a.max_corr);
        const float lnew = fmaxf(lam[k] + corr * meff[k], 0.0f);
        const float dl = lnew - lam[k];
        lam[k] = lnew;
        fx += NX[k] * dl; fy += NY[k] * dl; fz += NZ[k] * dl;
        tx += TX[k] * dl; ty += TY[k] * dl; tz += TZ[k] * dl;
      }
      fx = env_allsum<HALF>(fx); fy = env_allsum<HALF>(fy); fz = env_allsum<HALF>(fz);
      tx = env_allsum<HALF>(tx); ty = env_allsum<HALF>(ty); tz = env_allsum<HALF>(tz);
      dx = dx + fx * inv_m; dy = dy + fy * inv_m; dz = dz + fz * inv_m;
      thx = thx + I00 * tx + I01 * ty + I02 * tz;
      thy = thy + I10 * tx + I11 * ty + I12 * tz;
      thz = thz + I20 * tx + I21 * ty + I22 * tz;
    }
  }

  if (writer) {
    a.out_v[env * 3 + 0] = vx; a.out_v[env * 3 + 1] = vy; a.out_v[env * 3 + 2] = vz;
    a.out_w[env * 3 + 0] = wx; a.out_w[env * 3 + 1] = wy; a.out_w[env * 3 + 2] = wz;
    a.out_dx[env * 3 + 0] = dx; a.out_dx[env * 3 + 1] = dy; a.out_dx[env * 3 + 2] = dz;
    a.out_dth[env * 3 + 0] = thx; a.out_dth[env * 3 + 1] = thy; a.out_dth[env * 3 + 2] = thz;
  }
}

// Which of this lane's contacts (lane, lane + 32, ...) of one env are active,
// as a bit per contact. All loads are independent, so they are in flight
// together (a load per ballot would put eight memory latencies on the chain).
__device__ __forceinline__ unsigned active_bits(const SolverArgs& a, int env, int lane) {
  const long long cbase = (long long)env * a.C;
  float d[kMaxContacts / 32], wt[kMaxContacts / 32];
#pragma unroll
  for (int k = 0; k < kMaxContacts / 32; ++k) {
    const int c = lane + 32 * k;
    d[k] = c < a.C ? a.depth[cbase + c] : 0.0f;
    wt[k] = c < a.C ? a.weight[cbase + c] : 0.0f;
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kMaxContacts / 32; ++k)
    if (d[k] > 0.0f && wt[k] != 0.0f) bits |= 1u << k;
  return bits;
}

// Compact the active contacts of one env, in contact order, into idx -> K.
__device__ __forceinline__ int compact_env(unsigned bits, int lane, unsigned char* idx) {
  int K = 0;
#pragma unroll
  for (int k = 0; k < kMaxContacts / 32; ++k) {
    const bool active = (bits >> k) & 1u;
    const unsigned m = __ballot_sync(kFull, active);
    if (active) idx[K + __popc(m & ((1u << lane) - 1u))] = (unsigned char)(lane + 32 * k);
    K += __popc(m);
  }
  return K;
}

// Zeros for every impulse of one env; the active contacts' are written over
// them at the end of the solve, by the same warp.
__device__ __forceinline__ void zero_impulses(const SolverArgs& a, int env, int lane) {
  const long long cbase = (long long)env * a.C;
  for (int i = lane; i < a.C; i += 32) a.lam_n[cbase + i] = 0.0f;
  for (int i = lane; i < 3 * a.C; i += 32) a.lam_t[3 * cbase + i] = 0.0f;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock) contact_solver_kernel(SolverArgs a) {
  __shared__ unsigned char slots[kWarpsPerBlock][2][kMaxContacts];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + warp;
  if (env >= a.N) return;  // uniform per warp
  unsigned char* idx = slots[warp][0];
  unsigned char* idx_pair = slots[warp][1];

  // Envs 2i and 2i + 1 are a pair. Both their warps count both envs; when
  // neither has more than 16 active contacts the even warp solves both, one
  // per half warp, and the odd warp leaves: half as many warps then share a
  // scheduler and each butterfly is one step shorter.
  const int pair = env ^ 1;
  const unsigned bits = active_bits(a, env, lane);
  const unsigned bits_pair = pair < a.N ? active_bits(a, pair, lane) : 0u;
  const int K = compact_env(bits, lane, idx);
  const int K_pair = pair < a.N ? compact_env(bits_pair, lane, idx_pair) : kMaxContacts;
  if (K <= 16 && K_pair <= 16 && (K | K_pair) != 0) {
    if (env & 1) return;
    zero_impulses(a, env, lane);
    zero_impulses(a, pair, lane);
    __syncwarp();  // orders the slot tables and the zero fill before what follows
    const bool second = lane >= 16;
    solve_env<1, true>(a, second ? pair : env, lane & 15, second ? K_pair : K,
                       second ? idx_pair : idx, (lane & 15) == 0);
    return;
  }
  zero_impulses(a, env, lane);
  __syncwarp();

  if (K == 0) {
    if (lane < 3) {
      a.out_v[env * 3 + lane] = a.v_in[env * 3 + lane];
      a.out_w[env * 3 + lane] = a.w_in[env * 3 + lane];
      a.out_dx[env * 3 + lane] = 0.0f;
      a.out_dth[env * 3 + lane] = 0.0f;
    }
  } else if (K <= 32) {
    solve_env<1, false>(a, env, lane, K, idx, lane == 0);
  } else if (K <= 64) {
    solve_env<2, false>(a, env, lane, K, idx, lane == 0);
  } else if (K <= 128) {
    solve_env<4, false>(a, env, lane, K, idx, lane == 0);
  } else {
    solve_env<8, false>(a, env, lane, K, idx, lane == 0);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing. Returns cudaGetLastError() after the
// launch; 1 (cudaErrorInvalidValue) when C is outside (0, 256].
extern "C" int contact_solver_launch(const void* r, const void* n, const void* v_other,
                                     const void* depth, const void* mu, const void* weight,
                                     const void* stiffness, const void* mass, const void* I_inv,
                                     const void* v, const void* w, void* out_v, void* out_w,
                                     void* out_dx, void* out_dth, void* lam_n, void* lam_t, int N,
                                     int C, float h, int iters, int pos_iters, float beta_pos,
                                     float slop, float max_corr, void* stream) {
  if (N <= 0) return 0;
  if (C <= 0 || C > kMaxContacts) return (int)cudaErrorInvalidValue;
  SolverArgs a;
  a.r = (const float*)r; a.nrm = (const float*)n; a.vother = (const float*)v_other;
  a.depth = (const float*)depth; a.mu = (const float*)mu; a.weight = (const float*)weight;
  a.stiff = (const float*)stiffness; a.mass = (const float*)mass; a.I_inv = (const float*)I_inv;
  a.v_in = (const float*)v; a.w_in = (const float*)w;
  a.out_v = (float*)out_v; a.out_w = (float*)out_w; a.out_dx = (float*)out_dx;
  a.out_dth = (float*)out_dth; a.lam_n = (float*)lam_n; a.lam_t = (float*)lam_t;
  a.N = N; a.C = C; a.h = h; a.iters = iters; a.pos_iters = pos_iters;
  a.beta_pos = beta_pos; a.slop = slop; a.max_corr = max_corr;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  contact_solver_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
