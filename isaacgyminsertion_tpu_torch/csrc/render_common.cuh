// Device functions shared by the tactile and camera ray-cast renderers:
// closed-form ray intervals on the packed section (sensors/raycast.py), the
// plane-form SDF family of the march variants (ops/sdf.py), and a
// counter-based random generator (Philox-4x32-10).
//
// Every function mirrors its plain PyTorch counterpart term by term; fmaxf
// and fminf stand where the plain version has maximum/minimum, and selects
// where it has where(). BIG stands in for infinity.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RC_BIG 1.0e9f
#define RC_EPS 1.0e-9f
#define RC_HP_SLOTS 6
#define RENDER_THREADS 256

struct Interval {
    float lo, hi;
};

__device__ __forceinline__ float sgnf(float x) { return (x > 0.0f ? 1.0f : 0.0f) - (x < 0.0f ? 1.0f : 0.0f); }

// t-interval of {t : no + nd t <= c}
__device__ __forceinline__ Interval halfplane_interval(float no, float nd, float c) {
    const float den = fabsf(nd) < RC_EPS ? (nd >= 0.0f ? RC_EPS : -RC_EPS) : nd;
    const float tc = (c - no) / den;
    const bool inside = no <= c;
    Interval r;
    r.lo = nd < -RC_EPS ? tc : (nd > RC_EPS ? -RC_BIG : (inside ? -RC_BIG : RC_BIG));
    r.hi = nd > RC_EPS ? tc : (nd < -RC_EPS ? RC_BIG : (inside ? RC_BIG : -RC_BIG));
    return r;
}

// t-interval of {lo <= o + d t <= hi}
__device__ __forceinline__ Interval slab_interval(float o, float d, float lo, float hi) {
    const Interval a = halfplane_interval(o, d, hi);
    const Interval b = halfplane_interval(-o, -d, -lo);
    Interval r;
    r.lo = fmaxf(a.lo, b.lo);
    r.hi = fminf(a.hi, b.hi);
    return r;
}

// t-interval of {a t^2 + 2 b t + c <= 0}, a > 0
__device__ __forceinline__ Interval quadratic_interval(float a, float b, float c) {
    const float disc = b * b - a * c;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float inv_a = 1.0f / fmaxf(a, RC_EPS);
    Interval r;
    r.lo = (-b - sq) * inv_a;
    r.hi = (-b + sq) * inv_a;
    if (disc <= 0.0f) {
        r.lo = RC_BIG;
        r.hi = -RC_BIG;
    }
    return r;
}

// The quadratic constraint of a packed section: quad = (1/a, 1/b, active).
__device__ __forceinline__ Interval packed_quadratic(float ox, float oy, float dx, float dy,
                                                     const float* quad) {
    const float qia = quad[0], qib = quad[1];
    const float qox = ox * qia, qoy = oy * qib;
    const float qdx = dx * qia, qdy = dy * qib;
    const float qa = fmaxf(qdx * qdx + qdy * qdy, 1e-9f);
    const float qb = qox * qdx + qoy * qdy;
    const float qc = qox * qox + qoy * qoy - 1.0f;
    Interval q = quadratic_interval(qa, qb, qc);
    if (!(quad[2] > 0.5f)) {
        q.lo = -RC_BIG;
        q.hi = RC_BIG;
    }
    return q;
}

// Ray interval of a packed section: hp = 6 x (ux, uy, c), quad = (1/a, 1/b, active).
__device__ __forceinline__ Interval packed_interval(float ox, float oy, float dx, float dy,
                                                    const float* hp, const float* quad) {
    Interval s;
    s.lo = -RC_BIG;
    s.hi = RC_BIG;
#pragma unroll
    for (int j = 0; j < RC_HP_SLOTS; ++j) {
        const float ux = hp[3 * j], uy = hp[3 * j + 1], cc = hp[3 * j + 2];
        const Interval h = halfplane_interval(ux * ox + uy * oy, ux * dx + uy * dy, cc);
        s.lo = fmaxf(s.lo, h.lo);
        s.hi = fminf(s.hi, h.hi);
    }
    const Interval q = packed_quadratic(ox, oy, dx, dy, quad);
    s.lo = fmaxf(s.lo, q.lo);
    s.hi = fminf(s.hi, q.hi);
    return s;
}

// ---------------------------------------------------------------- plane SDFs

__device__ __forceinline__ float pnorm2(float x, float y) { return sqrtf(x * x + y * y + 1e-18f); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

__device__ __forceinline__ float sd_circle(float px, float py, float hx) { return pnorm2(px, py) - hx; }

__device__ __forceinline__ float sd_box2d(float px, float py, float hx, float hy) {
    const float dx = fabsf(px) - hx, dy = fabsf(py) - hy;
    return pnorm2(fmaxf(dx, 0.0f), fmaxf(dy, 0.0f)) + fminf(fmaxf(dx, dy), 0.0f);
}

__device__ __forceinline__ float sd_hexagon(float px, float py, float hx) {
    const float kx = -0.8660254037844386f, ky = 0.5f, kz = 0.5773502691896258f;
    float qx = fabsf(px), qy = fabsf(py);
    const float m = 2.0f * fminf(kx * qx + ky * qy, 0.0f);
    qx = qx - m * kx;
    qy = qy - m * ky;
    const float cx = clampf(qx, -kz * hx, kz * hx);
    return pnorm2(qx - cx, qy - hx) * sgnf(qy - hx);
}

__device__ __forceinline__ float sd_ellipse(float px, float py, float hx, float hy) {
    const float ex = px / hx, ey = py / hy;
    const float k0 = sqrtf(ex * ex + ey * ey + 1e-18f);
    const float fx = px / (hx * hx), fy = py / (hy * hy);
    const float k1 = fmaxf(sqrtf(fx * fx + fy * fy + 1e-18f), 1e-9f);
    return k0 < 1e-6f ? -fminf(hx, hy) : k0 * (k0 - 1.0f) / k1;
}

__device__ __forceinline__ float sd_trapezoid(float px_in, float py_in, float hx, float hy) {
    const float r1 = hx, r2 = 0.6f * hx, he = hy;
    const float px = fabsf(px_in);
    const float y_c = 2.0f * hy * (r1 + 2.0f * r2) / (3.0f * (r1 + r2)) - hy;
    const float py = py_in + y_c;
    const float k1x = r2, k1y = he, k2x = r2 - r1, k2y = 2.0f * he;
    const float ca_x = px - fminf(px, py < 0.0f ? r1 : r2);
    const float ca_y = fabsf(py) - he;
    const float k2n = fmaxf(k2x * k2x + k2y * k2y, 1e-12f);
    const float t = clampf(((k1x - px) * k2x + (k1y - py) * k2y) / k2n, 0.0f, 1.0f);
    const float cbx = px - k1x + k2x * t, cby = py - k1y + k2y * t;
    const float s = (cbx < 0.0f && ca_y < 0.0f) ? -1.0f : 1.0f;
    const float d2 = fminf(ca_x * ca_x + ca_y * ca_y, cbx * cbx + cby * cby);
    return s * sqrtf(d2 + 1e-18f);
}

__device__ __forceinline__ float sd_segment(float px, float py, float ax, float ay, float bx, float by) {
    const float pax = px - ax, pay = py - ay, bax = bx - ax, bay = by - ay;
    const float h = clampf((pax * bax + pay * bay) / fmaxf(bax * bax + bay * bay, 1e-12f), 0.0f, 1.0f);
    return pnorm2(pax - bax * h, pay - bay * h);
}

__device__ __forceinline__ float edge_fn(float px, float py, float e0x, float e0y, float e1x, float e1y) {
    return (e1x - e0x) * (py - e0y) - (e1y - e0y) * (px - e0x);
}

__device__ __forceinline__ float sd_triangle_iso(float px, float py, float hx, float hy) {
    const float y0 = -2.0f * hy / 3.0f;
    const float ax = -hx, ay = y0, bx = hx, by = y0, cx = 0.0f, cy = y0 + 2.0f * hy;
    const float d = fminf(fminf(sd_segment(px, py, ax, ay, bx, by), sd_segment(px, py, bx, by, cx, cy)),
                          sd_segment(px, py, cx, cy, ax, ay));
    const bool inside = edge_fn(px, py, ax, ay, bx, by) > 0.0f && edge_fn(px, py, bx, by, cx, cy) > 0.0f &&
                        edge_fn(px, py, cx, cy, ax, ay) > 0.0f;
    return inside ? -d : d;
}

// One-hot blend of the six families, oh[0..5] in KIND_* order. A family with
// weight 0 adds 0 in the plain version; it is skipped here (the weights are
// the same for every thread of a block, so the branch does not diverge).
__device__ __forceinline__ float section_sdf(float px, float py, const float* oh, float hx, float hy) {
    float d = 0.0f;
    if (oh[0] != 0.0f) d += sd_circle(px, py, hx) * oh[0];
    if (oh[1] != 0.0f) d += sd_box2d(px, py, hx, hy) * oh[1];
    if (oh[2] != 0.0f) d += sd_hexagon(px, py, hx) * oh[2];
    if (oh[3] != 0.0f) d += sd_ellipse(px, py, hx, hy) * oh[3];
    if (oh[4] != 0.0f) d += sd_trapezoid(px, py, hx, hy) * oh[4];
    if (oh[5] != 0.0f) d += sd_triangle_iso(px, py, hx, hy) * oh[5];
    return d;
}

__device__ __forceinline__ float extrude(float d2, float z, float half_len, float z_center) {
    const float wz = fabsf(z - z_center) - half_len;
    const float dx = fmaxf(d2, 0.0f), dz = fmaxf(wz, 0.0f);
    return sqrtf(dx * dx + dz * dz + 1e-18f) + fminf(fmaxf(d2, wz), 0.0f);
}

__device__ __forceinline__ float plug_sdf(float px, float py, float pz, const float* oh, float hx, float hy,
                                          float length) {
    return extrude(section_sdf(px, py, oh, hx, hy), pz, 0.5f * length, 0.5f * length);
}

__device__ __forceinline__ float socket_sdf(float px, float py, float pz, const float* oh, float hole_hx,
                                            float hole_hy, float height, float plate_hx, float plate_hy) {
    const float plate = extrude(sd_box2d(px, py, plate_hx, plate_hy), pz, 0.5f * height, 0.5f * height);
    return fmaxf(plate, -section_sdf(px, py, oh, hole_hx, hole_hy));
}

// ---------------------------------------------------------------- random bits

struct Philox4 {
    uint32_t x, y, z, w;
};

// Philox-4x32 with 10 rounds (Salmon et al. 2011): a keyed bijection of the
// 128-bit counter, so every (row, pixel, draw) gets its own independent words
// with no state carried between threads or launches.
__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        // one 32 x 32 -> 64 bit multiply gives both halves of each product
        const uint64_t p0 = (uint64_t)0xD2511F53u * c0, p1 = (uint64_t)0xCD9E8D57u * c2;
        const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0, n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
        c0 = n0;
        c1 = (uint32_t)p1;
        c2 = n2;
        c3 = (uint32_t)p0;
        k0 += 0x9E3779B9u;
        k1 += 0xBB67AE85u;
    }
    Philox4 out;
    out.x = c0;
    out.y = c1;
    out.z = c2;
    out.w = c3;
    return out;
}

// Uniform in [0, 1) from the top 24 bits of an UNSIGNED word (a signed shift
// would keep the sign and feed log() a negative number).
__device__ __forceinline__ float u24(uint32_t w) { return (float)(w >> 8) * 5.9604644775390625e-8f; }

// ------------------------------------------------------- approximate math
// The special-function unit's one-instruction approximations (about 1-2 ulp),
// for the renderers' images only: an IEEE division or sqrtf is an instruction
// sequence of ten or more.

__device__ __forceinline__ float rcp_fast(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float sqrt_fast(float x) {
    float y;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rsqrt_fast(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
