// External depth/segmentation camera: one thread per (env, pixel).
//
// Replaces the Pallas kernel `_camera_kernel` of
// isaacgyminsertion_tpu/sensors/render_pallas.py (reached through
// `camera_march_fused`). For each pixel: the first hit along the ray among the
// plug prism, the socket plate-minus-hole, the table half-space and the robot
// proxy (5 spheres and one cylinder segment), with ties going to the first of
// table, plug, socket, robot. Outputs three planes: t, d_min and the
// component id (0 table, 1 plug, 2 socket, 3 robot).
//
//   EXACT = true : closed-form intervals; d_min is 0 on a hit, 1 on a miss.
//   EXACT = false: fixed-trip SDF sphere march over the same scene; d_min is
//                  the scene distance at the end of the march.
//
// Bound on an H100: ~300 f32 operations per pixel against 12 output bytes, so
// operations and bytes bound it about equally. The design: the env's 98
// scalars are read once per block into shared memory, the constant ray table
// is read coalesced, every intermediate lives in registers, and the three
// planes are stored coalesced. The pixel axis is not padded.
//
// Row layout (CAMERA_ROW floats): Mp 0-8 (camera->plug rotation), o_plug 9-11,
// Ms 12-20 (camera->socket), o_sock 21-23, world-z row of the camera rotation
// 24-26, camera z 27, kind one-hot 28-33, plug hx hy length 34-36, hole hx hy
// and socket height 37-39, table height 40, fingertip centres 41-49 (camera
// frame), capsule end a 50-52 (wrist), end b 53-55 (hand), plug half-planes
// 56-73 and quad 74-76, hole half-planes 77-94 and quad 95-97.

#include "render_common.cuh"

#define CAMERA_ROW 98

struct CameraParams {
    int envs, pixels, iters;
    float near_clip, far_clip, plate_hx, plate_hy, tip_radius, hand_radius;
};

// first hit of a sphere for a unit ray from the origin
__device__ __forceinline__ float sphere0(float cx, float cy, float cz, float radius, float rx, float ry,
                                         float rz) {
    const float b = -(cx * rx + cy * ry + cz * rz);
    const float cc = cx * cx + cy * cy + cz * cz - radius * radius;
    const float disc = b * b - cc;
    const float th = -b - sqrtf(fmaxf(disc, 0.0f));
    return (disc > 0.0f && th > 0.0f) ? th : RC_BIG;
}

template <bool EXACT>
__global__ void __launch_bounds__(RENDER_THREADS)
camera_render_kernel(const float* __restrict__ scal, const float* __restrict__ rays, float* __restrict__ out,
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
    const float bx = S[53], by = S[54], bz = S[55];
    const float abx = bx - ax, aby = by - ay, abz = bz - az;
    const float ab2 = abx * abx + aby * aby + abz * abz + 1e-9f;

    const float rx = rays[pix], ry = rays[p.pixels + pix], rz = rays[2 * p.pixels + pix];
    const float dpx = mp[0] * rx + mp[1] * ry + mp[2] * rz;
    const float dpy = mp[3] * rx + mp[4] * ry + mp[5] * rz;
    const float dpz = mp[6] * rx + mp[7] * ry + mp[8] * rz;
    const float dsx = ms[0] * rx + ms[1] * ry + ms[2] * rz;
    const float dsy = ms[3] * rx + ms[4] * ry + ms[5] * rz;
    const float dsz = ms[6] * rx + ms[7] * ry + ms[8] * rz;
    const float dwz = S[24] * rx + S[25] * ry + S[26] * rz;  // world-frame ray z component

    float t_o, dmin_o, comp_o;
    if (EXACT) {
        // plug prism (plug frame) and the hole's section (socket frame)
        const Interval pi = packed_interval(opx, opy, dpx, dpy, S + 56, S + 74);
        const Interval hi = packed_interval(osx, osy, dsx, dsy, S + 77, S + 95);
        const Interval z = slab_interval(opz, dpz, 0.0f, plen);
        const float t_in = fmaxf(fmaxf(pi.lo, z.lo), 0.0f);
        const float t_p = t_in <= fminf(pi.hi, z.hi) ? t_in : RC_BIG;
        // socket plate minus hole: entering the plate outside the hole hits at
        // the entry; entering inside the hole hits the wall where the ray
        // leaves the hole prism, if still inside the plate
        const Interval sx = slab_interval(osx, dsx, -p.plate_hx, p.plate_hx);
        const Interval sy = slab_interval(osy, dsy, -p.plate_hy, p.plate_hy);
        const Interval sz = slab_interval(osz, dsz, 0.0f, sheight);
        const float a0 = fmaxf(fmaxf(fmaxf(sx.lo, sy.lo), sz.lo), 0.0f);
        const float a1 = fminf(fminf(sx.hi, sy.hi), sz.hi);
        const bool entered_in_hole = (a0 >= hi.lo - 1e-7f) && (a0 <= hi.hi + 1e-7f);
        const float wall_t = hi.hi <= a1 ? hi.hi : RC_BIG;
        const float t_s = a0 <= a1 ? (entered_in_hole ? wall_t : a0) : RC_BIG;
        // table half-space seen from above
        float t_t = (table_h - cam_z) / (fabsf(dwz) < 1e-9f ? -1e-9f : dwz);
        t_t = (dwz < -1e-9f && t_t > 0.0f) ? t_t : RC_BIG;
        // robot proxy (camera frame, ray origin 0, |d| = 1)
        float t_k = sphere0(ax, ay, az, p.hand_radius, rx, ry, rz);
        t_k = fminf(t_k, sphere0(bx, by, bz, p.hand_radius, rx, ry, rz));
#pragma unroll
        for (int i = 0; i < 3; ++i)
            t_k = fminf(t_k, sphere0(tips[3 * i], tips[3 * i + 1], tips[3 * i + 2], p.tip_radius, rx, ry, rz));
        const float inv_lab = 1.0f / sqrtf(ab2);
        const float d_par = (rx * abx + ry * aby + rz * abz) * inv_lab;
        const float o_par = -(ax * abx + ay * aby + az * abz) * inv_lab;
        const float qa = fmaxf(1.0f - d_par * d_par, 1e-9f);
        const float qb = -(ax * rx + ay * ry + az * rz) - o_par * d_par;
        const float qc = ax * ax + ay * ay + az * az - o_par * o_par - p.hand_radius * p.hand_radius;
        const float disc = qb * qb - qa * qc;
        const float t_cyl = (-qb - sqrtf(fmaxf(disc, 0.0f))) / qa;
        const float hseg = o_par + d_par * t_cyl;
        const bool on_seg = hseg >= 0.0f && hseg * hseg <= ab2;
        t_k = fminf(t_k, (disc > 0.0f && t_cyl > 0.0f && on_seg) ? t_cyl : RC_BIG);

        const float t = fminf(fminf(fminf(t_t, t_p), t_s), t_k);
        comp_o = t_t <= t ? 0.0f : (t_p <= t ? 1.0f : (t_s <= t ? 2.0f : 3.0f));
        dmin_o = t < p.far_clip - 1e-6f ? 0.0f : 1.0f;
        t_o = fminf(t, p.far_clip);
    } else {
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
        comp_o = dt <= dmin ? 0.0f : (dp <= dmin ? 1.0f : (ds <= dmin ? 2.0f : 3.0f));
        dmin_o = dmin;
        t_o = t;
    }
    const size_t plane = (size_t)p.envs * p.pixels;
    const size_t at = (size_t)env * p.pixels + pix;
    out[at] = t_o;
    out[plane + at] = dmin_o;
    out[2 * plane + at] = comp_o;
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
    p.near_clip = near_clip;
    p.far_clip = far_clip;
    p.plate_hx = plate_hx;
    p.plate_hy = plate_hy;
    p.tip_radius = tip_radius;
    p.hand_radius = hand_radius;
    const long long chunks = (pixels + RENDER_THREADS - 1) / RENDER_THREADS;
    const long long blocks = chunks * envs;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)blocks), block(RENDER_THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (exact)
        camera_render_kernel<true><<<grid, block, 0, s>>>((const float*)scal, (const float*)rays, (float*)out, p);
    else
        camera_render_kernel<false><<<grid, block, 0, s>>>((const float*)scal, (const float*)rays, (float*)out, p);
    return (int)cudaGetLastError();
}
