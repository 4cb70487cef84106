// Tactile gel renderer: one thread per (row, pixel), row = (env, finger).
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
// Bound on an H100: the work is a few hundred f32 operations per pixel against
// 12 output bytes per pixel, so bytes and operations bound it about equally;
// nothing is reused across pixels. The design keeps both minimal: the row's
// 43 scalars are read once per block into shared memory, the constant ray
// table and mask are read coalesced (they stay in L2), every intermediate
// lives in registers, and the three colour planes are stored coalesced. There
// is no padding of the pixel axis and no chunking of rows.
//
// Row layout (TACTILE_ROW floats): M 0-8 (camera->plug rotation, row major),
// o 9-11 (ray origin, plug frame), kind one-hot 12-17, hx 18, hy 19,
// length 20, force 21, half-planes 22-39 (6 x (ux, uy, c)), quad 40-42.

#include "render_common.cuh"

#define TACTILE_ROW 43

struct TactileParams {
    int rows, pixels, iters;
    float max_range, max_deformation, force_range, t0, noise_std, glow;
};

template <bool EXACT, int NOISE>
__global__ void __launch_bounds__(RENDER_THREADS)
tactile_render_kernel(const float* __restrict__ scal, const float* __restrict__ rays,
                      const float* __restrict__ mask, const unsigned long long* __restrict__ seed,
                      float* __restrict__ out, TactileParams p) {
    __shared__ float S[TACTILE_ROW];
    const int chunks = (p.pixels + RENDER_THREADS - 1) / RENDER_THREADS;
    const int row = blockIdx.x / chunks;
    const int pix = (blockIdx.x % chunks) * RENDER_THREADS + threadIdx.x;
    if (threadIdx.x < TACTILE_ROW) S[threadIdx.x] = scal[(size_t)row * TACTILE_ROW + threadIdx.x];
    __syncthreads();
    if (pix >= p.pixels) return;

    const float* m = S;
    const float ox = S[9], oy = S[10], oz = S[11];
    const float* oh = S + 12;
    const float hx = S[18], hy = S[19], length = S[20], force = S[21];
    const float* hp = S + 22;
    const float* quad = S + 40;
    const float max_range = p.max_range, t0 = p.t0;

    const float rx = rays[pix], ry = rays[p.pixels + pix], rz = rays[2 * p.pixels + pix];
    const float dx = m[0] * rx + m[1] * ry + m[2] * rz;
    const float dy = m[3] * rx + m[4] * ry + m[5] * rz;
    const float dz = m[6] * rx + m[7] * ry + m[8] * rz;

    float t, d_final, nx, ny, nz;
    if (EXACT) {
        // one constraint sweep: the interval and, from whichever constraint
        // bound the entry, the outward normal
        float s_lo = -RC_BIG, s_hi = RC_BIG, snx = 0.0f, sny = 0.0f;
#pragma unroll
        for (int j = 0; j < RC_HP_SLOTS; ++j) {
            const float ux = hp[3 * j], uy = hp[3 * j + 1], cc = hp[3 * j + 2];
            const Interval h = halfplane_interval(ux * ox + uy * oy, ux * dx + uy * dy, cc);
            if (h.lo > s_lo) {
                snx = ux;
                sny = uy;
            }
            s_lo = fmaxf(s_lo, h.lo);
            s_hi = fminf(s_hi, h.hi);
        }
        const float qia = quad[0], qib = quad[1];
        const bool qact = quad[2] > 0.5f;
        const Interval q = packed_quadratic(ox, oy, dx, dy, quad);
        if (q.lo > s_lo) {
            snx = (ox + dx * q.lo) * qia * qia;
            sny = (oy + dy * q.lo) * qib * qib;
        }
        s_lo = fmaxf(s_lo, q.lo);
        s_hi = fminf(s_hi, q.hi);
        const Interval z = slab_interval(oz, dz, 0.0f, length);
        const float entry = fmaxf(s_lo, z.lo);
        const float t_in = fmaxf(entry, t0);
        const float t_out = fminf(s_hi, z.hi);
        t = t_in <= t_out ? fminf(t_in, max_range) : max_range;
        d_final = t < max_range - 1e-6f ? 0.0f : 1.0f;
        const bool cap = z.lo > s_lo;
        nx = cap ? 0.0f : snx;
        ny = cap ? 0.0f : sny;
        nz = cap ? -sgnf(dz) : 0.0f;
        // origin inside the prism (deep indentation): no entry face, so take
        // the nearest-face gradient at the hit point
        const bool inside = (entry < t0 - 1e-9f) && (t_in <= t_out);
        const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
        float d2g = -RC_BIG, gxg = 0.0f, gyg = 0.0f;
#pragma unroll
        for (int j = 0; j < RC_HP_SLOTS; ++j) {
            const float ux = hp[3 * j], uy = hp[3 * j + 1], cc = hp[3 * j + 2];
            const float dk = ux * px + uy * py - cc;
            if (dk > d2g) {
                gxg = ux;
                gyg = uy;
            }
            d2g = fmaxf(d2g, dk);
        }
        const float rxq = px * qia * qia, ryq = py * qib * qib;
        const float ex = px * qia, ey = py * qib;
        const float k0 = sqrtf(ex * ex + ey * ey + 1e-18f);
        const float k1 = fmaxf(sqrtf(rxq * rxq + ryq * ryq), 1e-9f);
        float dq = k0 * (k0 - 1.0f) / k1;
        const float c1 = (2.0f * k0 - 1.0f) / (fmaxf(k0, 1e-9f) * k1);
        const float c2 = k0 * (k0 - 1.0f) / (k1 * k1 * k1);
        if (!qact) dq = -RC_BIG;
        if (dq > d2g) {
            gxg = c1 * rxq - c2 * rxq * qia * qia;
            gyg = c1 * ryq - c2 * ryq * qib * qib;
        }
        d2g = fmaxf(d2g, dq);
        const float wz = fabsf(pz - 0.5f * length) - 0.5f * length;
        const bool cap_in = wz > d2g;
        if (inside) {
            nx = cap_in ? 0.0f : gxg;
            ny = cap_in ? 0.0f : gyg;
            nz = cap_in ? sgnf(pz - 0.5f * length) : 0.0f;
        }
    } else {
        t = t0;
        for (int i = 0; i < p.iters; ++i) {
            const float d = plug_sdf(ox + dx * t, oy + dy * t, oz + dz * t, oh, hx, hy, length);
            t = fminf(t + fmaxf(d, 1e-4f), max_range);
        }
        const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
        d_final = plug_sdf(px, py, pz, oh, hx, hy, length);
        // tetrahedron finite-difference normal (plug frame)
        const float e = 2.0e-5f;
        const float tet[4][3] = {{1.0f, -1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f}, {-1.0f, 1.0f, -1.0f},
                                 {1.0f, 1.0f, 1.0f}};
        nx = ny = nz = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float dd = plug_sdf(px + e * tet[k][0], py + e * tet[k][1], pz + e * tet[k][2], oh, hx,
                                      hy, length);
            nx = nx + tet[k][0] * dd;
            ny = ny + tet[k][1] * dd;
            nz = nz + tet[k][2] * dd;
        }
    }
    const float inv = 1.0f / fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-9f);
    nx *= inv;
    ny *= inv;
    nz *= inv;

    const float hit = (d_final < 2e-3f && t < max_range - 1e-4f) ? 1.0f : 0.0f;
    const float indent = p.max_deformation * clampf(force / p.force_range, 0.0f, 1.0f);
    const float height = clampf(1.0f - (t - indent) / max_range, 0.0f, 1.0f) * hit;

    // normal back to the camera frame: n_c = M^T n_p; three lights at 120 degrees
    const float ncx = m[0] * nx + m[3] * ny + m[6] * nz;
    const float ncy = m[1] * nx + m[4] * ny + m[7] * nz;
    const float ncz = m[2] * nx + m[5] * ny + m[8] * nz;
    const float lights[3][6] = {{0.7f, 0.0f, 0.714f, 1.0f, 0.25f, 0.25f},
                                {-0.35f, 0.6062177826491071f, 0.714f, 0.25f, 1.0f, 0.25f},
                                {-0.35f, -0.6062177826491071f, 0.714f, 0.25f, 0.25f, 1.0f}};
    float r = 0.0f, g = 0.0f, b = 0.0f;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
        const float lam = clampf(-(ncx * lights[l][0] + ncy * lights[l][1] + ncz * lights[l][2]), 0.0f, 1.0f);
        r = r + lam * lights[l][3];
        g = g + lam * lights[l][4];
        b = b + lam * lights[l][5];
    }
    const float msk = mask[pix];
    const float hm = height * msk;
    r = r * hm + p.glow * msk;
    g = g * hm + p.glow * msk;
    b = b * hm + p.glow * msk;

    if (NOISE != 0) {
        const unsigned long long sd = seed[0];
        const uint32_t k0 = (uint32_t)sd, k1 = (uint32_t)(sd >> 32);
        float g1, g2, g3;
        if (NOISE == 2) {
            // Irwin-Hall(4): 4 uniforms summed, recentred and rescaled to unit variance
            float s[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const Philox4 w = philox4x32_10((uint32_t)pix, (uint32_t)row, (uint32_t)c, 0u, k0, k1);
                s[c] = ((u24(w.x) + u24(w.y) + u24(w.z) + u24(w.w)) - 2.0f) * 1.7320508075688772f;
            }
            g1 = s[0];
            g2 = s[1];
            g3 = s[2];
        } else {
            const Philox4 w = philox4x32_10((uint32_t)pix, (uint32_t)row, 0u, 0u, k0, k1);
            const float rad1 = sqrtf(-2.0f * logf(u24(w.x) + 1e-7f));
            const float rad2 = sqrtf(-2.0f * logf(u24(w.z) + 1e-7f));
            float s1, c1, s2, c2;
            sincosf(6.283185307179586f * u24(w.y), &s1, &c1);
            sincosf(6.283185307179586f * u24(w.w), &s2, &c2);
            g1 = rad1 * c1;
            g2 = rad1 * s1;
            g3 = rad2 * c2;
        }
        r = r + p.noise_std * g1;
        g = g + p.noise_std * g2;
        b = b + p.noise_std * g3;
    }
    r = clampf(r, 0.0f, 1.0f);
    g = clampf(g, 0.0f, 1.0f);
    b = clampf(b, 0.0f, 1.0f);

    const size_t plane = (size_t)p.rows * p.pixels;
    const size_t at = (size_t)row * p.pixels + pix;
    out[at] = r;
    out[plane + at] = g;
    out[2 * plane + at] = b;
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
    p.max_range = max_range;
    p.max_deformation = max_deformation;
    p.force_range = force_range;
    p.t0 = t0;
    p.noise_std = noise_std;
    p.glow = glow;
    const long long chunks = (pixels + RENDER_THREADS - 1) / RENDER_THREADS;
    const long long blocks = chunks * rows;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)blocks), block(RENDER_THREADS);
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
