// External depth/segmentation camera: one env per block, four neighbouring
// pixels a thread.
//
// Replaces the Pallas kernel `_camera_kernel` of
// isaacgyminsertion_tpu/sensors/render_pallas.py (reached through
// `camera_march_fused`). For each pixel: the first hit along the ray among the
// plug prism, the socket plate-minus-hole, the table half-space and the robot
// proxy (5 spheres and one cylinder segment), with ties going to the first of
// table, plug, socket, robot. Outputs three planes: t, d_min and the
// component id (0 table, 1 plug, 2 socket, 3 robot).
//
//   camera_exact_kernel: closed-form intervals; d_min is 0 on a hit, 1 on a
//                        miss. The main path's variant.
//   camera_march_kernel: fixed-trip SDF sphere march over the same scene, one
//                        pixel a thread; d_min is the scene distance at the
//                        end of the march.
//
// What bounds it on an H100: instruction issue. A pixel is 475-689 f32
// operations by its section family (`render_kernels.camera_flops`) against 12
// output bytes (the ray table stays in L2), so operations bound it twice over
// bytes; and a straight port spends more
// than that, since an IEEE division or sqrtf is ten or more instructions and
// every pixel recomputes what depends on its env only. The exact kernel
// executes fewer instructions per pixel and lets independent ones overlap:
//
//  - Row-only terms are formed once per block, in the prologue that reads the
//    env's 98 scalars into shared memory (CameraRowTerms): c - u.o and the
//    parallel-ray interval of each half-plane, the quadratics' origin terms,
//    the four slabs' origin terms, |c|^2 - r^2 of the 5 spheres, the
//    capsule's o_par, qc and 1/|ab|, the plug's bounding sphere. A pixel forms
//    only its three rotated directions, dwz and the u.d terms.
//  - Unused constraints cost nothing, on block-uniform branches: a neutral
//    half-plane slot (u = 0) and an inactive quadratic (a box has 4 slots and
//    no quadratic, a circle only the quadratic). Each skipped term is
//    (-BIG, BIG) in the plain version.
//  - Work no lane needs is skipped on warp votes, so warps stay together: the
//    plug's section and slab, and the plate's three slabs, unless a ray of the
//    warp meets the shape's bounding sphere; the hole's interval unless a ray
//    enters the plate; a sphere's or the cylinder's root unless a
//    discriminant is positive.
//  - Four neighbouring pixels a thread, in stages (table, proxy, plug,
//    socket), so four independent chains overlap; the ray table is read and
//    the three planes are written as float4. A pixel count that is not a
//    multiple of 4, or a pointer that is not 16-byte aligned, takes scalar
//    loads and stores in the same kernel.
//  - One-instruction approximations where a depth image tolerates 1-2 ulp
//    (depth is clipped, normalised and stored as f16 downstream): one
//    reciprocal per half-plane, one per slab for both of its faces, one for
//    the table and the cylinder; sqrt.approx for the roots. The tie order and
//    the hole-entry slack stay.
//
// Row layout (CAMERA_ROW floats): Mp 0-8 (camera->plug rotation), o_plug 9-11,
// Ms 12-20 (camera->socket), o_sock 21-23, world-z row of the camera rotation
// 24-26, camera z 27, kind one-hot 28-33, plug hx hy length 34-36, hole hx hy
// and socket height 37-39, table height 40, fingertip centres 41-49 (camera
// frame), capsule end a 50-52 (wrist), end b 53-55 (hand), plug half-planes
// 56-73 and quad 74-76, hole half-planes 77-94 and quad 95-97.

#include "render_common.cuh"

#define CAMERA_ROW 98
#define CAMERA_THREADS 128
#define CAMERA_VEC 4
// does a lane of the warp need this work?
#define WARP_ANY(x) __any_sync(0xffffffffu, (x))

struct CameraParams {
    int envs, pixels, iters, vec_ok;
    float near_clip, far_clip, plate_hx, plate_hy, tip_radius, hand_radius;
};

// The row-only terms of a packed section (the ray origin is per env).
struct SectionTerms {
    float cmn[RC_HP_SLOTS];   // c - u.o
    float lo0[RC_HP_SLOTS];   // the interval of a ray parallel to the half-plane
    float hi0[RC_HP_SLOTS];
    float qox, qoy, qc;       // the quadratic's origin terms
    int used;                 // bit j: half-plane slot j is not neutral
    int qact;                 // the quadratic is active
};

// The row-only terms of a slab {lo <= o + d t <= hi}.
struct SlabTerms {
    float num_hi, num_lo;     // hi - o and lo - o
    float lo0, hi0;           // the interval of a ray parallel to the slab
};

struct CameraRowTerms {
    SectionTerms plug, hole;
    SlabTerms slab[4];        // plug z, plate x, plate y, plate z
    float bs_ox, bs_oy, bs_oz, bs_cc;   // plug bounding sphere: o - c (plug frame), |o - c|^2 - R^2
    float bp_ox, bp_oy, bp_oz, bp_cc;   // the same for the socket plate (socket frame)
    float table_num;          // table height - camera z
    float sph_cc[5];          // |c|^2 - r^2: capsule ends a, b, then the 3 fingertips
    float abx, aby, abz, ab2, inv_lab, o_par, cyl_qc;
};

// ---------------------------------------------------------------- prologue

// Forms the row-only terms; threads 0-25 each take a part.
__device__ __forceinline__ void camera_row_terms(const float* S, CameraRowTerms& R, const CameraParams& p) {
    const int i = threadIdx.x;
    if (i < 2 * RC_HP_SLOTS) {
        // half-plane slot j of the plug (i < 6) or of the hole
        const bool hole = i >= RC_HP_SLOTS;
        const int j = hole ? i - RC_HP_SLOTS : i;
        const float* hp = S + (hole ? 77 : 56) + 3 * j;
        const float ox = hole ? S[21] : S[9], oy = hole ? S[22] : S[10];
        SectionTerms& T = hole ? R.hole : R.plug;
        const float no = hp[0] * ox + hp[1] * oy;
        const bool in = no <= hp[2];
        T.cmn[j] = hp[2] - no;
        T.lo0[j] = in ? -RC_BIG : RC_BIG;
        T.hi0[j] = in ? RC_BIG : -RC_BIG;
    } else if (i < 2 * RC_HP_SLOTS + 2) {
        // the quadratic and the used slots of the plug or of the hole
        const bool hole = i == 2 * RC_HP_SLOTS + 1;
        const float* hp = S + (hole ? 77 : 56);
        const float* quad = S + (hole ? 95 : 74);
        const float ox = hole ? S[21] : S[9], oy = hole ? S[22] : S[10];
        SectionTerms& T = hole ? R.hole : R.plug;
        int used = 0;
        for (int j = 0; j < RC_HP_SLOTS; ++j)
            if (hp[3 * j] != 0.0f || hp[3 * j + 1] != 0.0f) used |= 1 << j;
        T.used = used;
        T.qact = quad[2] > 0.5f;
        const float qox = ox * quad[0], qoy = oy * quad[1];
        T.qox = qox;
        T.qoy = qoy;
        T.qc = qox * qox + qoy * qoy - 1.0f;
    } else if (i < 2 * RC_HP_SLOTS + 6) {
        // slab k: plug z in [0, length], plate x, plate y, plate z in [0, height]
        const int k = i - (2 * RC_HP_SLOTS + 2);
        const float o = S[k == 0 ? 11 : 20 + k];
        const float lo = k == 1 ? -p.plate_hx : (k == 2 ? -p.plate_hy : 0.0f);
        const float hi = k == 0 ? S[36] : (k == 1 ? p.plate_hx : (k == 2 ? p.plate_hy : S[39]));
        const bool in_hi = o <= hi, in_lo = -o <= -lo;
        SlabTerms& L = R.slab[k];
        L.num_hi = hi - o;
        L.num_lo = lo - o;
        L.lo0 = fmaxf(in_hi ? -RC_BIG : RC_BIG, in_lo ? -RC_BIG : RC_BIG);
        L.hi0 = fminf(in_hi ? RC_BIG : -RC_BIG, in_lo ? RC_BIG : -RC_BIG);
    } else if (i < 2 * RC_HP_SLOTS + 11) {
        // sphere k: capsule ends a and b (hand radius), then the fingertips
        const int k = i - (2 * RC_HP_SLOTS + 6);
        const float* c = k < 2 ? S + 50 + 3 * k : S + 41 + 3 * (k - 2);
        const float radius = k < 2 ? p.hand_radius : p.tip_radius;
        R.sph_cc[k] = c[0] * c[0] + c[1] * c[1] + c[2] * c[2] - radius * radius;
    } else if (i == 2 * RC_HP_SLOTS + 11) {
        // the cylinder segment from a to b
        const float ax = S[50], ay = S[51], az = S[52];
        const float abx = S[53] - ax, aby = S[54] - ay, abz = S[55] - az;
        const float ab2 = abx * abx + aby * aby + abz * abz + 1e-9f;
        const float inv_lab = 1.0f / sqrtf(ab2);
        const float o_par = -(ax * abx + ay * aby + az * abz) * inv_lab;
        R.abx = abx;
        R.aby = aby;
        R.abz = abz;
        R.ab2 = ab2;
        R.inv_lab = inv_lab;
        R.o_par = o_par;
        R.cyl_qc = ax * ax + ay * ay + az * az - o_par * o_par - p.hand_radius * p.hand_radius;
    } else if (i == 2 * RC_HP_SLOTS + 12) {
        // a sphere around the plug prism (plug frame, centre (0, 0, length / 2)):
        // every family's section lies within 1.35 (hx^2 + 4 hy^2) of its axis
        // (the hexagon's circumradius is 1.155 hx); 2 % more for rounding
        const float hx = S[34], hy = S[35], half = 0.5f * S[36];
        const float r2 = 1.02f * (1.35f * (hx * hx + 4.0f * hy * hy) + half * half) + 1e-6f;
        const float ox = S[9], oy = S[10], oz = S[11] - half;
        R.bs_ox = ox;
        R.bs_oy = oy;
        R.bs_oz = oz;
        R.bs_cc = ox * ox + oy * oy + oz * oz - r2;
        R.table_num = S[40] - S[27];
    } else if (i == 2 * RC_HP_SLOTS + 13) {
        // a sphere around the socket plate (socket frame, centre (0, 0, height / 2))
        const float half = 0.5f * S[39];
        const float r2 = 1.02f * (p.plate_hx * p.plate_hx + p.plate_hy * p.plate_hy + half * half) + 1e-6f;
        const float ox = S[21], oy = S[22], oz = S[23] - half;
        R.bp_ox = ox;
        R.bp_oy = oy;
        R.bp_oz = oz;
        R.bp_cc = ox * ox + oy * oy + oz * oz - r2;
    }
}

// ------------------------------------------------------------ ray intervals

// Interval of a slab for V rays: both faces share one reciprocal.
template <int V>
__device__ __forceinline__ void slab_rays(const SlabTerms& L, const float (&d)[V], float (&lo)[V],
                                          float (&hi)[V]) {
    const float num_hi = L.num_hi, num_lo = L.num_lo, lo0 = L.lo0, hi0 = L.hi0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const bool pos = d[v] > RC_EPS, neg = d[v] < -RC_EPS;
        const float inv = rcp_fast(d[v]);
        const float t_hi = num_hi * inv, t_lo = num_lo * inv;   // the faces o + d t = hi and = lo
        lo[v] = fmaxf(pos ? t_lo : (neg ? t_hi : lo0), -RC_BIG);
        hi[v] = fminf(pos ? t_hi : (neg ? t_lo : hi0), RC_BIG);
    }
}

// Interval of a packed section for V rays (xy directions dx, dy).
template <int V>
__device__ __forceinline__ void section_rays(const SectionTerms& T, const float* hp, const float* quad,
                                             const float (&dx)[V], const float (&dy)[V], float (&lo)[V],
                                             float (&hi)[V]) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
        lo[v] = -RC_BIG;
        hi[v] = RC_BIG;
    }
    const int used = T.used;
#pragma unroll
    for (int j = 0; j < RC_HP_SLOTS; ++j) {
        if (!((used >> j) & 1)) continue;   // block-uniform
        const float ux = hp[3 * j], uy = hp[3 * j + 1];
        const float cmn = T.cmn[j], lo0 = T.lo0[j], hi0 = T.hi0[j];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const float nd = ux * dx[v] + uy * dy[v];
            const bool pos = nd > RC_EPS, neg = nd < -RC_EPS;
            const float tc = cmn * rcp_fast(nd);     // read only where |nd| > eps
            lo[v] = fmaxf(lo[v], neg ? tc : (pos ? -RC_BIG : lo0));
            hi[v] = fminf(hi[v], pos ? tc : (neg ? RC_BIG : hi0));
        }
    }
    if (T.qact) {   // block-uniform
        const float qia = quad[0], qib = quad[1], qox = T.qox, qoy = T.qoy, qc = T.qc;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const float qdx = dx[v] * qia, qdy = dy[v] * qib;
            const float qa = fmaxf(qdx * qdx + qdy * qdy, 1e-9f);
            const float qb = qox * qdx + qoy * qdy;
            const float disc = qb * qb - qa * qc;
            const float sq = sqrt_fast(fmaxf(disc, 0.0f));
            const float inv_a = rcp_fast(qa);
            lo[v] = fmaxf(lo[v], disc <= 0.0f ? RC_BIG : (-qb - sq) * inv_a);
            hi[v] = fminf(hi[v], disc <= 0.0f ? -RC_BIG : (-qb + sq) * inv_a);
        }
    }
}

// -------------------------------------------------------------- exact kernel

__global__ void __launch_bounds__(CAMERA_THREADS)
camera_exact_kernel(const float* __restrict__ scal, const float* __restrict__ rays, float* __restrict__ out,
                    CameraParams p) {
    constexpr int V = CAMERA_VEC;
    __shared__ float S[CAMERA_ROW];
    __shared__ CameraRowTerms R;
    const int chunks = (p.pixels + CAMERA_THREADS * V - 1) / (CAMERA_THREADS * V);
    const int env = blockIdx.x / chunks;
    const int first = (blockIdx.x % chunks) * CAMERA_THREADS;   // the block's first thread in the row
    const int pix0 = (first + (int)threadIdx.x) * V;
    // ---- loads: four neighbouring pixels, issued before the row's prologue so
    // that their latency overlaps it (a lane past the row loads pixel 0 and
    // stores nothing; it stays for the warp votes)
    const bool vec = p.vec_ok != 0;
    float rx[V], ry[V], rz[V];
    bool valid[V];
    bool loaded = false;
    if constexpr (V == 4) {
        if (vec) {
            const int at = pix0 < p.pixels ? pix0 : 0;
            const float4 a = *reinterpret_cast<const float4*>(rays + at);
            const float4 b = *reinterpret_cast<const float4*>(rays + p.pixels + at);
            const float4 c = *reinterpret_cast<const float4*>(rays + 2 * (size_t)p.pixels + at);
            rx[0] = a.x; rx[1] = a.y; rx[2] = a.z; rx[3] = a.w;
            ry[0] = b.x; ry[1] = b.y; ry[2] = b.z; ry[3] = b.w;
            rz[0] = c.x; rz[1] = c.y; rz[2] = c.z; rz[3] = c.w;
#pragma unroll
            for (int v = 0; v < V; ++v) valid[v] = pix0 < p.pixels;
            loaded = true;
        }
    }
    if (!loaded) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
            valid[v] = pix0 + v < p.pixels;
            const int at = valid[v] ? pix0 + v : 0;
            rx[v] = rays[at];
            ry[v] = rays[p.pixels + at];
            rz[v] = rays[2 * (size_t)p.pixels + at];
        }
    }

    for (int i = threadIdx.x; i < CAMERA_ROW; i += CAMERA_THREADS) S[i] = scal[(size_t)env * CAMERA_ROW + i];
    __syncthreads();
    camera_row_terms(S, R, p);
    __syncthreads();
    // a warp wholly past the row stores nothing (and takes no part in a vote)
    if ((first + (int)(threadIdx.x & ~31u)) * V >= p.pixels) return;

    // ---- stage 1: the table half-space seen from above
    float t_t[V];
    {
        const float wz0 = S[24], wz1 = S[25], wz2 = S[26], num = R.table_num;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const float dwz = wz0 * rx[v] + wz1 * ry[v] + wz2 * rz[v];   // world-frame ray z component
            const float tt = num * rcp_fast(dwz);                        // read only where dwz < -eps
            t_t[v] = (dwz < -1e-9f && tt > 0.0f) ? tt : RC_BIG;
        }
    }

    // ---- stage 2: the robot proxy (camera frame, ray origin 0, |d| = 1)
    float t_k[V];
#pragma unroll
    for (int v = 0; v < V; ++v) t_k[v] = RC_BIG;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const float* c = k < 2 ? S + 50 + 3 * k : S + 41 + 3 * (k - 2);
        const float cx = c[0], cy = c[1], cz = c[2], cc = R.sph_cc[k];
        float b[V], disc[V];
        bool any = false;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            b[v] = -(cx * rx[v] + cy * ry[v] + cz * rz[v]);
            disc[v] = b[v] * b[v] - cc;
            any = any || disc[v] > 0.0f;
        }
        if (WARP_ANY(any)) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float th = -b[v] - sqrt_fast(fmaxf(disc[v], 0.0f));
                t_k[v] = fminf(t_k[v], (disc[v] > 0.0f && th > 0.0f) ? th : RC_BIG);
            }
        }
    }
    {   // the cylinder segment from a to b
        const float ax = S[50], ay = S[51], az = S[52];
        const float abx = R.abx, aby = R.aby, abz = R.abz, ab2 = R.ab2, inv_lab = R.inv_lab;
        const float o_par = R.o_par, qc = R.cyl_qc;
        float d_par[V], qa[V], qb[V], disc[V];
        bool any = false;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            d_par[v] = (rx[v] * abx + ry[v] * aby + rz[v] * abz) * inv_lab;
            qa[v] = fmaxf(1.0f - d_par[v] * d_par[v], 1e-9f);
            qb[v] = -(ax * rx[v] + ay * ry[v] + az * rz[v]) - o_par * d_par[v];
            disc[v] = qb[v] * qb[v] - qa[v] * qc;
            any = any || disc[v] > 0.0f;
        }
        if (WARP_ANY(any)) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float t_cyl = (-qb[v] - sqrt_fast(fmaxf(disc[v], 0.0f))) * rcp_fast(qa[v]);
                const float hseg = o_par + d_par[v] * t_cyl;
                const bool on_seg = hseg >= 0.0f && hseg * hseg <= ab2;
                t_k[v] = fminf(t_k[v], (disc[v] > 0.0f && t_cyl > 0.0f && on_seg) ? t_cyl : RC_BIG);
            }
        }
    }

    // ---- stage 3: the plug prism (plug frame), where a ray of the warp meets
    // its bounding sphere
    float t_p[V];
    {
        const float* mp = S;
        float dpx[V], dpy[V], dpz[V];
        bool any = false;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            dpx[v] = mp[0] * rx[v] + mp[1] * ry[v] + mp[2] * rz[v];
            dpy[v] = mp[3] * rx[v] + mp[4] * ry[v] + mp[5] * rz[v];
            dpz[v] = mp[6] * rx[v] + mp[7] * ry[v] + mp[8] * rz[v];
            const float b = R.bs_ox * dpx[v] + R.bs_oy * dpy[v] + R.bs_oz * dpz[v];
            any = any || b * b - R.bs_cc > 0.0f;
            t_p[v] = RC_BIG;
        }
        if (WARP_ANY(any)) {
            float s_lo[V], s_hi[V], z_lo[V], z_hi[V];
            section_rays<V>(R.plug, S + 56, S + 74, dpx, dpy, s_lo, s_hi);
            slab_rays<V>(R.slab[0], dpz, z_lo, z_hi);
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float t_in = fmaxf(fmaxf(s_lo[v], z_lo[v]), 0.0f);
                t_p[v] = t_in <= fminf(s_hi[v], z_hi[v]) ? t_in : RC_BIG;
            }
        }
    }

    // ---- stage 4: the socket plate minus the hole (socket frame), where a ray
    // of the warp meets the plate's bounding sphere: entering the plate outside
    // the hole hits at the entry; entering inside the hole hits the wall where
    // the ray leaves the hole prism, if still inside the plate. The hole's
    // interval only where a ray of the warp enters the plate.
    float t_s[V];
    {
        const float* ms = S + 12;
        float dsx[V], dsy[V], dsz[V], a0[V], a1[V];
        bool near = false;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            dsx[v] = ms[0] * rx[v] + ms[1] * ry[v] + ms[2] * rz[v];
            dsy[v] = ms[3] * rx[v] + ms[4] * ry[v] + ms[5] * rz[v];
            dsz[v] = ms[6] * rx[v] + ms[7] * ry[v] + ms[8] * rz[v];
            const float b = R.bp_ox * dsx[v] + R.bp_oy * dsy[v] + R.bp_oz * dsz[v];
            near = near || b * b - R.bp_cc > 0.0f;
            t_s[v] = RC_BIG;
        }
        if (WARP_ANY(near)) {
            float x_lo[V], x_hi[V], y_lo[V], y_hi[V], z_lo[V], z_hi[V];
            slab_rays<V>(R.slab[1], dsx, x_lo, x_hi);
            slab_rays<V>(R.slab[2], dsy, y_lo, y_hi);
            slab_rays<V>(R.slab[3], dsz, z_lo, z_hi);
            bool any = false;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                a0[v] = fmaxf(fmaxf(fmaxf(x_lo[v], y_lo[v]), z_lo[v]), 0.0f);
                a1[v] = fminf(fminf(x_hi[v], y_hi[v]), z_hi[v]);
                t_s[v] = a0[v] <= a1[v] ? a0[v] : RC_BIG;
                any = any || a0[v] <= a1[v];
            }
            if (WARP_ANY(any)) {
                float h_lo[V], h_hi[V];
                section_rays<V>(R.hole, S + 77, S + 95, dsx, dsy, h_lo, h_hi);
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    const bool entered_in_hole = (a0[v] >= h_lo[v] - 1e-7f) && (a0[v] <= h_hi[v] + 1e-7f);
                    const float wall_t = h_hi[v] <= a1[v] ? h_hi[v] : RC_BIG;
                    t_s[v] = a0[v] <= a1[v] ? (entered_in_hole ? wall_t : a0[v]) : RC_BIG;
                }
            }
        }
    }

    // ---- the first hit, ties to the first of table, plug, socket, robot
    float t_o[V], dmin_o[V], comp_o[V];
    const float far_clip = p.far_clip;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const float t = fminf(fminf(fminf(t_t[v], t_p[v]), t_s[v]), t_k[v]);
        comp_o[v] = t_t[v] <= t ? 0.0f : (t_p[v] <= t ? 1.0f : (t_s[v] <= t ? 2.0f : 3.0f));
        dmin_o[v] = t < far_clip - 1e-6f ? 0.0f : 1.0f;
        t_o[v] = fminf(t, far_clip);
    }

    const size_t plane = (size_t)p.envs * p.pixels;
    const size_t at = (size_t)env * p.pixels + pix0;
    bool stored = false;
    if constexpr (V == 4) {
        if (vec) {
            if (valid[0]) {
                *reinterpret_cast<float4*>(out + at) = make_float4(t_o[0], t_o[1], t_o[2], t_o[3]);
                *reinterpret_cast<float4*>(out + plane + at) =
                    make_float4(dmin_o[0], dmin_o[1], dmin_o[2], dmin_o[3]);
                *reinterpret_cast<float4*>(out + 2 * plane + at) =
                    make_float4(comp_o[0], comp_o[1], comp_o[2], comp_o[3]);
            }
            stored = true;
        }
    }
    if (!stored) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
            if (valid[v]) {
                out[at + v] = t_o[v];
                out[plane + at + v] = dmin_o[v];
                out[2 * plane + at + v] = comp_o[v];
            }
        }
    }
}

// -------------------------------------------------------------- march kernel

__global__ void __launch_bounds__(RENDER_THREADS)
camera_march_kernel(const float* __restrict__ scal, const float* __restrict__ rays, float* __restrict__ out,
                    CameraParams p) {
    __shared__ float S[CAMERA_ROW];
    const int chunks = (p.pixels + RENDER_THREADS - 1) / RENDER_THREADS;
    const int env = blockIdx.x / chunks;
    const int pix = (blockIdx.x % chunks) * RENDER_THREADS + threadIdx.x;
    if (threadIdx.x < CAMERA_ROW) S[threadIdx.x] = scal[(size_t)env * CAMERA_ROW + threadIdx.x];
    __syncthreads();
    if (pix >= p.pixels) return;

    const float* mp = S;
    const float opx = S[9], opy = S[10], opz = S[11];
    const float* ms = S + 12;
    const float osx = S[21], osy = S[22], osz = S[23];
    const float cam_z = S[27];
    const float* oh = S + 28;
    const float phx = S[34], phy = S[35], plen = S[36];
    const float hhx = S[37], hhy = S[38], sheight = S[39];
    const float table_h = S[40];
    const float* tips = S + 41;
    const float ax = S[50], ay = S[51], az = S[52];
    const float abx = S[53] - ax, aby = S[54] - ay, abz = S[55] - az;
    const float ab2 = abx * abx + aby * aby + abz * abz + 1e-9f;

    const float rx = rays[pix], ry = rays[p.pixels + pix], rz = rays[2 * p.pixels + pix];
    const float dpx = mp[0] * rx + mp[1] * ry + mp[2] * rz;
    const float dpy = mp[3] * rx + mp[4] * ry + mp[5] * rz;
    const float dpz = mp[6] * rx + mp[7] * ry + mp[8] * rz;
    const float dsx = ms[0] * rx + ms[1] * ry + ms[2] * rz;
    const float dsy = ms[3] * rx + ms[4] * ry + ms[5] * rz;
    const float dsz = ms[6] * rx + ms[7] * ry + ms[8] * rz;
    const float dwz = S[24] * rx + S[25] * ry + S[26] * rz;  // world-frame ray z component

    float t = p.near_clip;
    float dt, dp, ds, dk;
    for (int i = 0; i <= p.iters; ++i) {
        dp = plug_sdf(opx + dpx * t, opy + dpy * t, opz + dpz * t, oh, phx, phy, plen);
        ds = socket_sdf(osx + dsx * t, osy + dsy * t, osz + dsz * t, oh, hhx, hhy, sheight, p.plate_hx,
                        p.plate_hy);
        dt = (cam_z + dwz * t) - table_h;
        // robot proxy SDF: 3 fingertip spheres and the wrist->hand capsule
        const float px = rx * t, py = ry * t, pz = rz * t;
        dk = RC_BIG;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float ex = px - tips[3 * k], ey = py - tips[3 * k + 1], ez = pz - tips[3 * k + 2];
            dk = fminf(dk, sqrtf(ex * ex + ey * ey + ez * ez + 1e-12f) - p.tip_radius);
        }
        const float qx = px - ax, qy = py - ay, qz = pz - az;
        const float h = clampf((qx * abx + qy * aby + qz * abz) / ab2, 0.0f, 1.0f);
        const float cx = qx - h * abx, cy = qy - h * aby, cz = qz - h * abz;
        dk = fminf(dk, sqrtf(cx * cx + cy * cy + cz * cz + 1e-12f) - p.hand_radius);
        if (i == p.iters) break;  // the last trip only evaluates the scene at the final t
        const float d = fminf(fminf(fminf(dt, dp), ds), dk);
        t = fminf(t + fmaxf(d, 1e-4f), p.far_clip);
    }
    const float dmin = fminf(fminf(fminf(dt, dp), ds), dk);
    const size_t plane = (size_t)p.envs * p.pixels;
    const size_t at = (size_t)env * p.pixels + pix;
    out[at] = t;
    out[plane + at] = dmin;
    out[2 * plane + at] = dt <= dmin ? 0.0f : (dp <= dmin ? 1.0f : (ds <= dmin ? 2.0f : 3.0f));
}

// scal [envs, CAMERA_ROW], rays [3, pixels], out [3, envs, pixels]. Returns
// the CUDA error code of the launch.
extern "C" int camera_render_launch(const void* scal, const void* rays, void* out, int envs, int pixels,
                                    int exact, int iters, float near_clip, float far_clip, float plate_hx,
                                    float plate_hy, float tip_radius, float hand_radius, void* stream) {
    if (envs <= 0 || pixels <= 0) return (int)cudaErrorInvalidValue;
    CameraParams p;
    p.envs = envs;
    p.pixels = pixels;
    p.iters = iters;
    // float4 loads and stores need every plane and row to start on 16 bytes
    p.vec_ok = CAMERA_VEC == 4 && pixels % 4 == 0 && (((uintptr_t)rays | (uintptr_t)out) & 15u) == 0;
    p.near_clip = near_clip;
    p.far_clip = far_clip;
    p.plate_hx = plate_hx;
    p.plate_hy = plate_hy;
    p.tip_radius = tip_radius;
    p.hand_radius = hand_radius;
    const long long per_block = exact ? (long long)CAMERA_THREADS * CAMERA_VEC : RENDER_THREADS;
    const long long chunks = (pixels + per_block - 1) / per_block;
    const long long blocks = chunks * envs;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = (cudaStream_t)stream;
    if (exact)
        camera_exact_kernel<<<(unsigned)blocks, CAMERA_THREADS, 0, s>>>((const float*)scal, (const float*)rays,
                                                                       (float*)out, p);
    else
        camera_march_kernel<<<(unsigned)blocks, RENDER_THREADS, 0, s>>>((const float*)scal, (const float*)rays,
                                                                       (float*)out, p);
    return (int)cudaGetLastError();
}
