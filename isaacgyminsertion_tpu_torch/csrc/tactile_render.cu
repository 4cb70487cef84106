// Tactile gel renderer: row = (env, finger), four neighbouring pixels a thread.
//
// Replaces the Pallas kernel `_tactile_kernel` of
// isaacgyminsertion_tpu/sensors/render_pallas.py (reached through
// `tactile_march_fused`). For each gel pixel: the ray direction in the plug
// frame (M * ray), the first hit on the plug prism, the force-proportional
// indentation height, 3-light Lambert RGB, and the fused epilogue (gel mask,
// glow, Gaussian pixel noise, clip to [0, 1]).
//
//   EXACT = true : closed-form hit on the packed section (6 half-planes, a
//                  quadratic and the z-slab) with the entry-face normal, and
//                  the nearest-face normal for origins inside the prism.
//   EXACT = false: fixed-trip SDF sphere march with a tetrahedron
//                  finite-difference normal.
//   NOISE = 0 none, 1 Box-Muller Gaussian, 2 Irwin-Hall(4).
//
// What bounds it on an H100: instruction throughput. A pixel needs a few hundred
// f32 operations against 12 output bytes (the ray table and the mask stay in
// L2), so by the count it is bound by operations, about twice over bytes; but
// an IEEE division or sqrtf is ten or more instructions, the noise is a
// 10-round integer Philox, and nothing is reused across pixels. The design
// executes fewer instructions per pixel and lets independent ones overlap:
//
//  - Row-only terms are formed once per block, in the prologue that reads the
//    row's 43 scalars into shared memory: the ray origin is per row, so u.o,
//    c - u.o, the inside flags, which half-plane slots are in use, the
//    quadratic's origin terms, the slab's origin terms and the indentation
//    are all per row. A pixel computes only the u.d terms.
//  - Unused constraints cost nothing: a neutral half-plane slot (u = 0) and an
//    inactive quadratic are skipped on block-uniform branches (a box has 4
//    half-planes and no quadratic, a circle only the quadratic).
//  - What a pixel's result does not use is skipped on warp votes, so warps
//    stay together: the interior gradient unless __any_sync says a lane's
//    origin is inside the prism; normal, lighting and height unless a lane
//    hit under the gel mask (height * hit * mask = 0 leaves glow * mask).
//    Every pixel still gets its noise.
//  - Four neighbouring pixels per thread, in stages (intervals, interior
//    gradient, shading, noise), so four independent chains overlap; the ray
//    table and the mask are read and the three colour planes are written as
//    float4. A pixel count that is not a multiple of 4, or a pointer that is
//    not 16-byte aligned, takes scalar loads and stores in the same kernel.
//  - One-instruction approximations where an image tolerates 1-2 ulp: one
//    reciprocal per half-plane and one for the slab's two faces, rcp/rsqrt/
//    sqrt.approx, __logf and __sincosf for the Box-Muller (argument in
//    [0, 2 pi)). The image is stored as f16 downstream.
//  - Philox counters stay (pixel, row, draw) under the same key, so a pixel's
//    noise does not depend on how pixels are grouped into threads.
//
// Row layout (TACTILE_ROW floats): M 0-8 (camera->plug rotation, row major),
// o 9-11 (ray origin, plug frame), kind one-hot 12-17, hx 18, hy 19,
// length 20, force 21, half-planes 22-39 (6 x (ux, uy, c)), quad 40-42.

#include "render_common.cuh"

#define TACTILE_ROW 43
#define TACTILE_THREADS 128
#define TACTILE_VEC 4

struct TactileParams {
    int rows, pixels, iters, vec_ok;
    float max_range, max_deformation, force_range, t0, noise_std, glow;
};

// Row-only terms, formed once per block beside the raw row in shared memory.
struct TactileRowTerms {
    float cmn[RC_HP_SLOTS];   // c - u.o
    float lo0[RC_HP_SLOTS];   // the interval of a ray parallel to the half-plane
    float hi0[RC_HP_SLOTS];
    float qox, qoy, qc;       // the quadratic's origin terms
    float za_num, zb_num;     // slab: length - oz and oz
    float za_lo0, za_hi0, zb_lo0, zb_hi0;
    float indent, inv_range;
    int hp_used;              // bit j: half-plane slot j is not neutral
    int qact;
};

template <bool EXACT, int NOISE>
__global__ void __launch_bounds__(TACTILE_THREADS)
tactile_render_kernel(const float* __restrict__ scal, const float* __restrict__ rays,
                      const float* __restrict__ mask, const unsigned long long* __restrict__ seed,
                      float* __restrict__ out, TactileParams p) {
    constexpr int V = TACTILE_VEC;
    __shared__ float S[TACTILE_ROW];
    __shared__ TactileRowTerms T;
    const int chunks = (p.pixels + TACTILE_THREADS * V - 1) / (TACTILE_THREADS * V);
    const int row = blockIdx.x / chunks;
    const int pix0 = ((blockIdx.x % chunks) * TACTILE_THREADS + threadIdx.x) * V;
    if (threadIdx.x < TACTILE_ROW) S[threadIdx.x] = scal[(size_t)row * TACTILE_ROW + threadIdx.x];
    __syncthreads();
    if (threadIdx.x < RC_HP_SLOTS) {
        const int j = threadIdx.x;
        const float ux = S[22 + 3 * j], uy = S[23 + 3 * j], cc = S[24 + 3 * j];
        const float no = ux * S[9] + uy * S[10];
        const bool in = no <= cc;
        T.cmn[j] = cc - no;
        T.lo0[j] = in ? -RC_BIG : RC_BIG;
        T.hi0[j] = in ? RC_BIG : -RC_BIG;
    } else if (threadIdx.x == RC_HP_SLOTS) {
        int used = 0;
        for (int j = 0; j < RC_HP_SLOTS; ++j)
            if (S[22 + 3 * j] != 0.0f || S[23 + 3 * j] != 0.0f) used |= 1 << j;
        T.hp_used = used;
        T.qact = S[42] > 0.5f;
        const float qox = S[9] * S[40], qoy = S[10] * S[41];
        T.qox = qox;
        T.qoy = qoy;
        T.qc = qox * qox + qoy * qoy - 1.0f;
    } else if (threadIdx.x == RC_HP_SLOTS + 1) {
        const float oz = S[11], length = S[20];
        T.za_num = length - oz;
        T.zb_num = oz;
        T.za_lo0 = oz <= length ? -RC_BIG : RC_BIG;
        T.za_hi0 = oz <= length ? RC_BIG : -RC_BIG;
        T.zb_lo0 = -oz <= 0.0f ? -RC_BIG : RC_BIG;
        T.zb_hi0 = -oz <= 0.0f ? RC_BIG : -RC_BIG;
        T.indent = p.max_deformation * clampf(S[21] / p.force_range, 0.0f, 1.0f);
        T.inv_range = 1.0f / p.max_range;
    }
    __syncthreads();

    const float* m = S;
    const float ox = S[9], oy = S[10], oz = S[11];
    const float* oh = S + 12;
    const float hx = S[18], hy = S[19], length = S[20];
    const float* hp = S + 22;
    const float qia = S[40], qib = S[41];
    const float max_range = p.max_range, t0 = p.t0;
    const bool vec = p.vec_ok != 0;

    // ---- loads: four neighbouring pixels (a thread past the row loads pixel 0
    // and stores nothing; it stays for the warp votes)
    float rx[V], ry[V], rz[V], msk[V];
    bool valid[V];
    if (vec) {
        const int at = pix0 < p.pixels ? pix0 : 0;
        const float4 a = *reinterpret_cast<const float4*>(rays + at);
        const float4 b = *reinterpret_cast<const float4*>(rays + p.pixels + at);
        const float4 c = *reinterpret_cast<const float4*>(rays + 2 * (size_t)p.pixels + at);
        const float4 k = *reinterpret_cast<const float4*>(mask + at);
        rx[0] = a.x; rx[1] = a.y; rx[2] = a.z; rx[3] = a.w;
        ry[0] = b.x; ry[1] = b.y; ry[2] = b.z; ry[3] = b.w;
        rz[0] = c.x; rz[1] = c.y; rz[2] = c.z; rz[3] = c.w;
        msk[0] = k.x; msk[1] = k.y; msk[2] = k.z; msk[3] = k.w;
#pragma unroll
        for (int v = 0; v < V; ++v) valid[v] = pix0 < p.pixels;
    } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
            valid[v] = pix0 + v < p.pixels;
            const int at = valid[v] ? pix0 + v : 0;
            rx[v] = rays[at];
            ry[v] = rays[p.pixels + at];
            rz[v] = rays[2 * (size_t)p.pixels + at];
            msk[v] = mask[at];
        }
    }

    float dx[V], dy[V], dz[V], t[V], nx[V], ny[V], nz[V];
    bool hit[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        dx[v] = m[0] * rx[v] + m[1] * ry[v] + m[2] * rz[v];
        dy[v] = m[3] * rx[v] + m[4] * ry[v] + m[5] * rz[v];
        dz[v] = m[6] * rx[v] + m[7] * ry[v] + m[8] * rz[v];
    }

    if (EXACT) {
        // ---- stage 1: the ray's interval and the entry normal
        bool inside[V];
        bool any_inside = false;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            float s_lo = -RC_BIG, s_hi = RC_BIG, snx = 0.0f, sny = 0.0f;
#pragma unroll
            for (int j = 0; j < RC_HP_SLOTS; ++j) {
                if (!((T.hp_used >> j) & 1)) continue;   // block-uniform
                const float ux = hp[3 * j], uy = hp[3 * j + 1];
                const float nd = ux * dx[v] + uy * dy[v];
                const bool pos = nd > RC_EPS, neg = nd < -RC_EPS;
                const float tc = T.cmn[j] * rcp_fast(nd);     // read only where |nd| > eps
                const float lo = neg ? tc : (pos ? -RC_BIG : T.lo0[j]);
                const float hi = pos ? tc : (neg ? RC_BIG : T.hi0[j]);
                if (lo > s_lo) {
                    snx = ux;
                    sny = uy;
                }
                s_lo = fmaxf(s_lo, lo);
                s_hi = fminf(s_hi, hi);
            }
            if (T.qact) {   // block-uniform
                const float qdx = dx[v] * qia, qdy = dy[v] * qib;
                const float qa = fmaxf(qdx * qdx + qdy * qdy, 1e-9f);
                const float qb = T.qox * qdx + T.qoy * qdy;
                const float disc = qb * qb - qa * T.qc;
                const float sq = sqrt_fast(fmaxf(disc, 0.0f));
                const float inv_a = rcp_fast(qa);
                const float q_lo = disc <= 0.0f ? RC_BIG : (-qb - sq) * inv_a;
                const float q_hi = disc <= 0.0f ? -RC_BIG : (-qb + sq) * inv_a;
                if (q_lo > s_lo) {
                    snx = (ox + dx[v] * q_lo) * qia * qia;
                    sny = (oy + dy[v] * q_lo) * qib * qib;
                }
                s_lo = fmaxf(s_lo, q_lo);
                s_hi = fminf(s_hi, q_hi);
            }
            // z-slab [0, length]: its two faces share one reciprocal
            const bool pos = dz[v] > RC_EPS, neg = dz[v] < -RC_EPS;
            const float inv_dz = rcp_fast(dz[v]);
            const float tca = T.za_num * inv_dz, tcb = -T.zb_num * inv_dz;
            const float z_lo = fmaxf(neg ? tca : (pos ? -RC_BIG : T.za_lo0),
                                     pos ? tcb : (neg ? -RC_BIG : T.zb_lo0));
            const float z_hi = fminf(pos ? tca : (neg ? RC_BIG : T.za_hi0),
                                     neg ? tcb : (pos ? RC_BIG : T.zb_hi0));
            const float entry = fmaxf(s_lo, z_lo);
            const float t_in = fmaxf(entry, t0);
            const float t_out = fminf(s_hi, z_hi);
            t[v] = t_in <= t_out ? fminf(t_in, max_range) : max_range;
            hit[v] = t[v] < max_range - 1e-4f;
            const bool cap = z_lo > s_lo;
            nx[v] = cap ? 0.0f : snx;
            ny[v] = cap ? 0.0f : sny;
            nz[v] = cap ? -sgnf(dz[v]) : 0.0f;
            inside[v] = (entry < t0 - 1e-9f) && (t_in <= t_out);
            any_inside = any_inside || inside[v];
        }
        // ---- stage 2: origin inside the prism (deep indentation): no entry
        // face, so take the nearest-face gradient at the hit point
        if (__any_sync(0xffffffffu, any_inside)) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float px = ox + dx[v] * t[v], py = oy + dy[v] * t[v], pz = oz + dz[v] * t[v];
                float d2g = -RC_BIG, gxg = 0.0f, gyg = 0.0f;
#pragma unroll
                for (int j = 0; j < RC_HP_SLOTS; ++j) {
                    if (!((T.hp_used >> j) & 1)) continue;
                    const float ux = hp[3 * j], uy = hp[3 * j + 1], cc = hp[3 * j + 2];
                    const float dk = ux * px + uy * py - cc;
                    if (dk > d2g) {
                        gxg = ux;
                        gyg = uy;
                    }
                    d2g = fmaxf(d2g, dk);
                }
                if (T.qact) {
                    const float rxq = px * qia * qia, ryq = py * qib * qib;
                    const float ex = px * qia, ey = py * qib;
                    const float k0 = sqrt_fast(ex * ex + ey * ey + 1e-18f);
                    const float k1 = fmaxf(sqrt_fast(rxq * rxq + ryq * ryq), 1e-9f);
                    const float inv_k1 = rcp_fast(k1);
                    const float dq = k0 * (k0 - 1.0f) * inv_k1;
                    const float c1 = (2.0f * k0 - 1.0f) * rcp_fast(fmaxf(k0, 1e-9f)) * inv_k1;
                    const float c2 = dq * inv_k1 * inv_k1;
                    if (dq > d2g) {
                        gxg = c1 * rxq - c2 * rxq * qia * qia;
                        gyg = c1 * ryq - c2 * ryq * qib * qib;
                    }
                    d2g = fmaxf(d2g, dq);
                }
                const float wz = fabsf(pz - 0.5f * length) - 0.5f * length;
                const bool cap_in = wz > d2g;
                if (inside[v]) {
                    nx[v] = cap_in ? 0.0f : gxg;
                    ny[v] = cap_in ? 0.0f : gyg;
                    nz[v] = cap_in ? sgnf(pz - 0.5f * length) : 0.0f;
                }
            }
        }
    } else {
        bool any_hit = false;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            float tt = t0;
            for (int i = 0; i < p.iters; ++i) {
                const float d = plug_sdf(ox + dx[v] * tt, oy + dy[v] * tt, oz + dz[v] * tt, oh, hx, hy, length);
                tt = fminf(tt + fmaxf(d, 1e-4f), max_range);
            }
            t[v] = tt;
            const float d_final = plug_sdf(ox + dx[v] * tt, oy + dy[v] * tt, oz + dz[v] * tt, oh, hx, hy, length);
            hit[v] = d_final < 2e-3f && tt < max_range - 1e-4f;
            nx[v] = ny[v] = nz[v] = 0.0f;
            any_hit = any_hit || hit[v];
        }
        if (__any_sync(0xffffffffu, any_hit)) {
            // tetrahedron finite-difference normal (plug frame)
            const float e = 2.0e-5f;
            const float tet[4][3] = {{1.0f, -1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f}, {-1.0f, 1.0f, -1.0f},
                                     {1.0f, 1.0f, 1.0f}};
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float px = ox + dx[v] * t[v], py = oy + dy[v] * t[v], pz = oz + dz[v] * t[v];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float dd = plug_sdf(px + e * tet[k][0], py + e * tet[k][1], pz + e * tet[k][2], oh,
                                              hx, hy, length);
                    nx[v] = nx[v] + tet[k][0] * dd;
                    ny[v] = ny[v] + tet[k][1] * dd;
                    nz[v] = nz[v] + tet[k][2] * dd;
                }
            }
        }
    }

    // ---- stage 3: height and shading, where a lane of the warp is lit; a
    // pixel that missed or lies off the gel is glow * mask whatever its normal
    float r[V], g[V], b[V];
    bool any_lit = false;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        r[v] = g[v] = b[v] = p.glow * msk[v];
        any_lit = any_lit || (hit[v] && msk[v] != 0.0f);
    }
    if (__any_sync(0xffffffffu, any_lit)) {
        const float lights[3][6] = {{0.7f, 0.0f, 0.714f, 1.0f, 0.25f, 0.25f},
                                    {-0.35f, 0.6062177826491071f, 0.714f, 0.25f, 1.0f, 0.25f},
                                    {-0.35f, -0.6062177826491071f, 0.714f, 0.25f, 0.25f, 1.0f}};
        const float indent = T.indent, inv_range = T.inv_range;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            // 1 / max(|n|, 1e-9)
            const float inv = fminf(rsqrt_fast(nx[v] * nx[v] + ny[v] * ny[v] + nz[v] * nz[v]), 1.0e9f);
            const float ux = nx[v] * inv, uy = ny[v] * inv, uz = nz[v] * inv;
            const float height =
                hit[v] ? clampf(1.0f - (t[v] - indent) * inv_range, 0.0f, 1.0f) : 0.0f;
            // normal back to the camera frame: n_c = M^T n_p; three lights at 120 degrees
            const float ncx = m[0] * ux + m[3] * uy + m[6] * uz;
            const float ncy = m[1] * ux + m[4] * uy + m[7] * uz;
            const float ncz = m[2] * ux + m[5] * uy + m[8] * uz;
            float cr = 0.0f, cg = 0.0f, cb = 0.0f;
#pragma unroll
            for (int l = 0; l < 3; ++l) {
                const float lam =
                    clampf(-(ncx * lights[l][0] + ncy * lights[l][1] + ncz * lights[l][2]), 0.0f, 1.0f);
                cr = cr + lam * lights[l][3];
                cg = cg + lam * lights[l][4];
                cb = cb + lam * lights[l][5];
            }
            const float hm = height * msk[v];
            r[v] = cr * hm + p.glow * msk[v];
            g[v] = cg * hm + p.glow * msk[v];
            b[v] = cb * hm + p.glow * msk[v];
        }
    }

    // ---- stage 4: noise, counted by (pixel, row, draw) under the launch's key
    if (NOISE != 0) {
        const unsigned long long sd = seed[0];
        const uint32_t k0 = (uint32_t)sd, k1 = (uint32_t)(sd >> 32);
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const uint32_t pix = (uint32_t)(pix0 + v);
            float g1, g2, g3;
            if (NOISE == 2) {
                // Irwin-Hall(4): 4 uniforms summed, recentred and rescaled to unit variance
                float s[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const Philox4 w = philox4x32_10(pix, (uint32_t)row, (uint32_t)c, 0u, k0, k1);
                    s[c] = ((u24(w.x) + u24(w.y) + u24(w.z) + u24(w.w)) - 2.0f) * 1.7320508075688772f;
                }
                g1 = s[0];
                g2 = s[1];
                g3 = s[2];
            } else {
                const Philox4 w = philox4x32_10(pix, (uint32_t)row, 0u, 0u, k0, k1);
                const float rad1 = sqrt_fast(fmaxf(-2.0f * __logf(u24(w.x) + 1e-7f), 0.0f));
                const float rad2 = sqrt_fast(fmaxf(-2.0f * __logf(u24(w.z) + 1e-7f), 0.0f));
                float s1, c1;
                __sincosf(6.283185307179586f * u24(w.y), &s1, &c1);
                g1 = rad1 * c1;
                g2 = rad1 * s1;
                g3 = rad2 * __cosf(6.283185307179586f * u24(w.w));
            }
            r[v] = r[v] + p.noise_std * g1;
            g[v] = g[v] + p.noise_std * g2;
            b[v] = b[v] + p.noise_std * g3;
        }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
        r[v] = clampf(r[v], 0.0f, 1.0f);
        g[v] = clampf(g[v], 0.0f, 1.0f);
        b[v] = clampf(b[v], 0.0f, 1.0f);
    }

    const size_t plane = (size_t)p.rows * p.pixels;
    const size_t at = (size_t)row * p.pixels + pix0;
    if (vec) {
        if (valid[0]) {
            *reinterpret_cast<float4*>(out + at) = make_float4(r[0], r[1], r[2], r[3]);
            *reinterpret_cast<float4*>(out + plane + at) = make_float4(g[0], g[1], g[2], g[3]);
            *reinterpret_cast<float4*>(out + 2 * plane + at) = make_float4(b[0], b[1], b[2], b[3]);
        }
    } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
            if (valid[v]) {
                out[at + v] = r[v];
                out[plane + at + v] = g[v];
                out[2 * plane + at + v] = b[v];
            }
        }
    }
}

// scal [rows, TACTILE_ROW], rays [3, pixels], mask [pixels], seed [1] (u64,
// read only when noise_kind != 0), out [3, rows, pixels]. Returns the CUDA
// error code of the launch.
extern "C" int tactile_render_launch(const void* scal, const void* rays, const void* mask, const void* seed,
                                     void* out, int rows, int pixels, int exact, int noise_kind, int iters,
                                     float max_range, float max_deformation, float force_range, float t0,
                                     float noise_std, float glow, void* stream) {
    if (rows <= 0 || pixels <= 0) return (int)cudaErrorInvalidValue;
    TactileParams p;
    p.rows = rows;
    p.pixels = pixels;
    p.iters = iters;
    // float4 loads and stores need every plane and row to start on 16 bytes
    p.vec_ok = pixels % TACTILE_VEC == 0 &&
               (((uintptr_t)rays | (uintptr_t)mask | (uintptr_t)out) & 15u) == 0;
    p.max_range = max_range;
    p.max_deformation = max_deformation;
    p.force_range = force_range;
    p.t0 = t0;
    p.noise_std = noise_std;
    p.glow = glow;
    const long long per_block = (long long)TACTILE_THREADS * TACTILE_VEC;
    const long long chunks = (pixels + per_block - 1) / per_block;
    const long long blocks = chunks * rows;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)blocks), block(TACTILE_THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    const float* a = (const float*)scal;
    const float* b = (const float*)rays;
    const float* c = (const float*)mask;
    const unsigned long long* d = (const unsigned long long*)seed;
    float* o = (float*)out;
#define LAUNCH(E, N) tactile_render_kernel<E, N><<<grid, block, 0, s>>>(a, b, c, d, o, p)
    if (exact) {
        if (noise_kind == 0) LAUNCH(true, 0);
        else if (noise_kind == 1) LAUNCH(true, 1);
        else LAUNCH(true, 2);
    } else {
        if (noise_kind == 0) LAUNCH(false, 0);
        else if (noise_kind == 1) LAUNCH(false, 1);
        else LAUNCH(false, 2);
    }
#undef LAUNCH
    return (int)cudaGetLastError();
}
