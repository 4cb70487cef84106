// Contact generation of one physics substep: the plug's contact set against
// the three fingertip gel pads, the socket and the table, one launch.
//
// Replaces no TPU kernel. The JAX package computes this chain
// (physics/contact.py: fingertip_plug_contacts, plug_env_contacts,
// concat_contacts) in plain jnp and leaves it to XLA, which fuses it into a
// few loops; eager PyTorch cannot fuse, and ran it as ~2,000 tiny launches a
// substep plus the autograd engine's bookkeeping for the SDF normals. The
// plain PyTorch version is physics/contact_kernel.py::generate_contacts_plain.
//
// Layout: one thread per (env, contact slot), N x C threads with C = 255, in
// the slot order of the engine: slots 0-14 the 3 fingertip pads x 5 patch
// points (finger-major), then the Ps = 144 socket points
// (surface_points[:, :Ps]), then the Pt = 96 table points (surface_points
// gathered by table_idx). Each thread writes its slot of r, n, v_other
// [N, C, 3] and depth, mu, weight, stiffness [N, C]: the ContactSet the
// contact solver reads (contact_solver.cu).
//
//  - A patch thread recomputes its own pad's centre normal and tangent basis
//    (pass 1 of fingertip_plug_contacts): two SDF evaluations, and no
//    synchronisation between threads. The centre point of a pad is the pad
//    centre itself, so its thread evaluates once.
//  - Frame changes (quat_to_matrix, R p + t, R^T (w - t)) and the table
//    gather happen here.
//  - Gradients are in closed form (forward mode over the section plane and
//    z) and follow the autograd rules of the plain version exactly: maximum /
//    minimum split the gradient evenly at a tie, abs and sign give 0 at 0,
//    where() takes the selected branch, and every + 1e-18 inside a sqrt
//    stays. Ties do occur: symmetric sample points at axis-aligned poses.
//  - The six section families are blended as sum_k oh_k d_k and
//    sum_k oh_k grad d_k; a family whose weight is exactly 0 is skipped, so a
//    one-hot row evaluates one family.
//
// What bounds it on an H100: bytes. Per env it reads (Ps + Pt) points and
// weights and ~50 per-env floats and writes 13 floats per slot, ~17 KB; at
// 8192 envs ~142 MB, ~0.042 ms at 3.35 TB/s, against ~0.5 GFLOP of SDF
// arithmetic (~0.007 ms at 67 TFLOP/s; contact_kernel.py counts both). The
// design keeps each slot in registers from its inputs to its outputs and
// writes each output once: the 3-vectors go through shared memory so that a
// block stores its contiguous range of r, n and v_other coalesced. On the
// card it runs at ~28% of that bound at 8192 envs (PERF.md section 6), and a
// launch with the L2 cache warm takes as long as one with it flushed: what
// holds it back is chains of IEEE divisions and square roots, not bytes. So
// the gradient-only divisions are one reciprocal and multiplies, and
// __launch_bounds__(256, 4) caps the registers at 64, so that four blocks
// reside on an SM, where an 80-register build fits three.
//
// fp32 throughout, built with --fmad=false: every product and sum rounds as
// the plain version's separate elementwise operations do, so the frame
// changes agree with it to the bit and the tie tests above see the same
// numbers. Division and sqrtf stay IEEE (no fast math): the normals feed the
// solve.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CG_FN __device__ __forceinline__
#else
#include <math.h>
#define CG_FN inline
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kFingers = 3;
constexpr int kPatch = 5;
constexpr int kFingerSlots = kFingers * kPatch;
constexpr int kKinds = 6;
constexpr float kTrapTop = 0.6f;  // TRAPEZOID_TOP_RATIO

struct GenArgs {
  const float *tip_pos, *tip_vel, *plug_q, *plug_pos, *com, *socket_q, *socket_pos, *kind;
  const float *plug_hx, *plug_hy, *plug_len, *hole_hx, *hole_hy, *socket_h, *table_h;
  const float *mu_socket, *mu_table, *mu_finger;
  const float *points, *weights;
  const int* table_idx;
  float *r, *n, *depth, *v_other, *mu, *weight, *stiffness;
  int N, P, Ps, Pt, C;
  int mu_socket_stride, mu_table_stride, mu_finger_stride;
  float plate_hx, plate_hy;
  // the gel pad (physics/contact.py): radius, the ring points' effective
  // radius and offset, the stiffness of one patch point
  float radius, ring_radius, ring_off, patch_stiffness;
};

// ------------------------------------------------------------ tie rules
// d max(a, b) / da and d min(a, b) / da as autograd takes them: the whole
// gradient to the larger (smaller) input, half to each at a tie.
CG_FN float gmax(float a, float b) { return a > b ? 1.0f : (a == b ? 0.5f : 0.0f); }
CG_FN float gmin(float a, float b) { return a < b ? 1.0f : (a == b ? 0.5f : 0.0f); }
// sign, and the derivative of abs: 0 at 0
CG_FN float sgn(float x) { return (x > 0.0f ? 1.0f : 0.0f) - (x < 0.0f ? 1.0f : 0.0f); }
CG_FN float maxf(float a, float b) { return a > b ? a : b; }
CG_FN float minf(float a, float b) { return a < b ? a : b; }

// A value of the section plane and its gradient over (px, py).
struct D2 {
  float v, x, y;
};

// ------------------------------------------------ section families (ops/sdf.py)

CG_FN D2 sd_circle(float px, float py, float hx) {
  const float s = sqrtf(px * px + py * py + 1e-18f);
  const float is = 1.0f / s;
  return {s - hx, px * is, py * is};
}

CG_FN D2 sd_box2d(float px, float py, float hx, float hy) {
  const float dx = fabsf(px) - hx, dy = fabsf(py) - hy;
  const float ax = maxf(dx, 0.0f), ay = maxf(dy, 0.0f);
  const float gx = gmax(dx, 0.0f) * sgn(px), gy = gmax(dy, 0.0f) * sgn(py);
  const float s = sqrtf(ax * ax + ay * ay + 1e-18f);
  const float is = 1.0f / s;
  const float m = maxf(dx, dy);
  const float gm = gmin(m, 0.0f);
  return {s + minf(m, 0.0f), ax * gx * is + gm * gmax(dx, dy) * sgn(px),
          ay * gy * is + gm * gmax(dy, dx) * sgn(py)};
}

CG_FN D2 sd_hexagon(float px, float py, float hx) {
  const float kx = -0.8660254037844386f, ky = 0.5f, kz = 0.5773502691896258f;
  const float q0 = fabsf(px), q1 = fabsf(py);
  const float sx = sgn(px), sy = sgn(py);
  const float dot = kx * q0 + ky * q1;
  const float g = gmin(dot, 0.0f);
  const float m2 = 2.0f * minf(dot, 0.0f);
  const float r0 = q0 - m2 * kx, r1 = q1 - m2 * ky;
  // d dot = (kx sx, ky sy); d r = d q - 2 k g d dot
  const float r0x = sx - 2.0f * kx * g * kx * sx, r0y = -2.0f * kx * g * ky * sy;
  const float r1x = -2.0f * ky * g * kx * sx, r1y = sy - 2.0f * ky * g * ky * sy;
  const float lo = -kz * hx, hi = kz * hx;
  const float mx = maxf(r0, lo);
  const float gc = gmin(mx, hi) * gmax(r0, lo);
  const float e0 = r0 - minf(mx, hi), e1 = r1 - hx;
  const float s = sqrtf(e0 * e0 + e1 * e1 + 1e-18f);
  const float sg = sgn(e1);
  const float c = sg / s;
  const float e0x = r0x - gc * r0x, e0y = r0y - gc * r0y;
  return {s * sg, c * (e0 * e0x + e1 * r1x), c * (e0 * e0y + e1 * r1y)};
}

CG_FN D2 sd_ellipse(float px, float py, float hx, float hy) {
  const float ex = px / hx, ey = py / hy;
  const float k0 = sqrtf(ex * ex + ey * ey + 1e-18f);
  const float hx2 = hx * hx, hy2 = hy * hy;
  const float fx = px / hx2, fy = py / hy2;
  const float s1 = sqrtf(fx * fx + fy * fy + 1e-18f);
  const float k1 = maxf(s1, 1e-9f);
  if (k0 < 1e-6f) return {-minf(hx, hy), 0.0f, 0.0f};
  const float v = k0 * (k0 - 1.0f) / k1;
  const float ik1 = 1.0f / k1;
  const float a = (2.0f * k0 - 1.0f) * ik1 / k0;     // d v / d k0, over k0
  const float b = gmax(s1, 1e-9f) * v * ik1 / s1;    // - d v / d s1, over s1
  return {v, a * ex / hx - b * fx / hx2, a * ey / hy - b * fy / hy2};
}

CG_FN D2 sd_trapezoid(float px_in, float py_in, float hx, float hy) {
  const float r1 = hx, r2 = kTrapTop * hx, he = hy;
  const float px = fabsf(px_in);
  const float sx = sgn(px_in);                       // d px / d px_in
  const float y_c = 2.0f * hy * (r1 + 2.0f * r2) / (3.0f * (r1 + r2)) - hy;
  const float py = py_in + y_c;
  const float k1x = r2, k1y = he, k2x = r2 - r1, k2y = 2.0f * he;
  const float rr = py < 0.0f ? r1 : r2;
  const float ca_x = px - minf(px, rr);
  const float ca_y = fabsf(py) - he;
  const float cax_x = sx - gmin(px, rr) * sx;        // d ca_x / d px_in (ca_x has no py term)
  const float cay_y = sgn(py);                       // d ca_y / d py_in
  const float k2n = maxf(k2x * k2x + k2y * k2y, 1e-12f);
  const float tt = ((k1x - px) * k2x + (k1y - py) * k2y) / k2n;
  const float t0 = maxf(tt, 0.0f);
  const float t = minf(t0, 1.0f);
  const float gt = gmin(t0, 1.0f) * gmax(tt, 0.0f);
  const float gk = gt / k2n;
  const float t_x = -gk * k2x * sx, t_y = -gk * k2y;
  const float cbx = px - k1x + k2x * t, cby = py - k1y + k2y * t;
  const float cbx_x = sx + k2x * t_x, cbx_y = k2x * t_y;
  const float cby_x = k2y * t_x, cby_y = 1.0f + k2y * t_y;
  const float s = (cbx < 0.0f && ca_y < 0.0f) ? -1.0f : 1.0f;
  const float A = ca_x * ca_x + ca_y * ca_y, B = cbx * cbx + cby * cby;
  const float d2 = minf(A, B);
  const float ga = gmin(A, B), gb = gmin(B, A);
  const float q = sqrtf(d2 + 1e-18f);
  const float c = s / q;                             // d v / d d2 = s / (2 q), times the 2 of d A
  return {s * q, c * (ga * (ca_x * cax_x) + gb * (cbx * cbx_x + cby * cby_x)),
          c * (ga * (ca_y * cay_y) + gb * (cbx * cbx_y + cby * cby_y))};
}

CG_FN D2 sd_segment(float px, float py, float ax, float ay, float bx, float by) {
  const float pax = px - ax, pay = py - ay, bax = bx - ax, bay = by - ay;
  const float den = maxf(bax * bax + bay * bay, 1e-12f);
  const float hh = (pax * bax + pay * bay) / den;
  const float h0 = maxf(hh, 0.0f);
  const float h = minf(h0, 1.0f);
  const float gh = gmin(h0, 1.0f) * gmax(hh, 0.0f);
  const float gd = gh / den;
  const float h_x = gd * bax, h_y = gd * bay;
  const float ex = pax - bax * h, ey = pay - bay * h;
  const float s = sqrtf(ex * ex + ey * ey + 1e-18f);
  const float is = 1.0f / s;
  return {s, (ex * (1.0f - bax * h_x) + ey * (-bay * h_x)) * is,
          (ex * (-bax * h_y) + ey * (1.0f - bay * h_y)) * is};
}

CG_FN float edge_fn(float px, float py, float e0x, float e0y, float e1x, float e1y) {
  return (e1x - e0x) * (py - e0y) - (e1y - e0y) * (px - e0x);
}

CG_FN D2 sd_triangle_iso(float px, float py, float hx, float hy) {
  const float y0 = -2.0f * hy / 3.0f;
  const float ax = -hx, ay = y0, bx = hx, by = y0, cx = 0.0f, cy = y0 + 2.0f * hy;
  const D2 d1 = sd_segment(px, py, ax, ay, bx, by);
  const D2 d2 = sd_segment(px, py, bx, by, cx, cy);
  const D2 d3 = sd_segment(px, py, cx, cy, ax, ay);
  const float g1 = gmin(d1.v, d2.v), g2 = gmin(d2.v, d1.v);
  const float m12 = minf(d1.v, d2.v);
  const float gm = gmin(m12, d3.v), g3 = gmin(d3.v, m12);
  D2 d = {minf(m12, d3.v), gm * (g1 * d1.x + g2 * d2.x) + g3 * d3.x,
          gm * (g1 * d1.y + g2 * d2.y) + g3 * d3.y};
  const bool inside = edge_fn(px, py, ax, ay, bx, by) > 0.0f && edge_fn(px, py, bx, by, cx, cy) > 0.0f &&
                      edge_fn(px, py, cx, cy, ax, ay) > 0.0f;
  if (inside) d = {-d.v, -d.x, -d.y};
  return d;
}

// One-hot blend of the six families, oh[0..5] in KIND_* order (circle, box,
// hexagon, ellipse, trapezoid, triangle).
CG_FN D2 section_sdf(float px, float py, const float* oh, float hx, float hy) {
  D2 d = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kKinds; ++k) {
    const float w = oh[k];
    if (w == 0.0f) continue;
    D2 e;
    switch (k) {
      case 0: e = sd_circle(px, py, hx); break;
      case 1: e = sd_box2d(px, py, hx, hy); break;
      case 2: e = sd_hexagon(px, py, hx); break;
      case 3: e = sd_ellipse(px, py, hx, hy); break;
      case 4: e = sd_trapezoid(px, py, hx, hy); break;
      default: e = sd_triangle_iso(px, py, hx, hy); break;
    }
    d.v = d.v + e.v * w;
    d.x = d.x + e.x * w;
    d.y = d.y + e.y * w;
  }
  return d;
}

// A solid's value and its gradient over (px, py, pz).
struct D3 {
  float v, x, y, z;
};

// Extrude a section over z in [z_center - half_len, z_center + half_len].
CG_FN D3 extrude(D2 d2, float z, float half_len, float z_center) {
  const float wz = fabsf(z - z_center) - half_len;
  const float wz_z = sgn(z - z_center);
  const float dx = maxf(d2.v, 0.0f), dz = maxf(wz, 0.0f);
  const float s = sqrtf(dx * dx + dz * dz + 1e-18f);
  const float is = 1.0f / s;
  const float m = maxf(d2.v, wz);
  const float gm = gmin(m, 0.0f);
  const float a = dx * gmax(d2.v, 0.0f) * is + gm * gmax(d2.v, wz);   // d v / d d2
  const float b = dz * gmax(wz, 0.0f) * is + gm * gmax(wz, d2.v);     // d v / d wz
  return {s + minf(m, 0.0f), a * d2.x, a * d2.y, b * wz_z};
}

CG_FN D3 plug_sdf(float px, float py, float pz, const float* oh, float hx, float hy, float length) {
  const float half = 0.5f * length;
  return extrude(section_sdf(px, py, oh, hx, hy), pz, half, half);
}

// Rectangular plate (z in [0, height]) minus the through-hole.
CG_FN D3 socket_sdf(float px, float py, float pz, const float* oh, float hole_hx, float hole_hy, float height,
                    float plate_hx, float plate_hy) {
  const float half = 0.5f * height;
  const D3 plate = extrude(sd_box2d(px, py, plate_hx, plate_hy), pz, half, half);
  const D2 hole = section_sdf(px, py, oh, hole_hx, hole_hy);
  const float nh = -hole.v;
  const float gp = gmax(plate.v, nh), gh = gmax(nh, plate.v);
  return {maxf(plate.v, nh), gp * plate.x - gh * hole.x, gp * plate.y - gh * hole.y, gp * plate.z};
}

// ------------------------------------------------------------- frames

struct Mat3 {
  float m[9];
};

CG_FN Mat3 quat_to_matrix(const float* q) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  Mat3 R;
  R.m[0] = 1.0f - 2.0f * (yy + zz); R.m[1] = 2.0f * (xy - wz); R.m[2] = 2.0f * (xz + wy);
  R.m[3] = 2.0f * (xy + wz); R.m[4] = 1.0f - 2.0f * (xx + zz); R.m[5] = 2.0f * (yz - wx);
  R.m[6] = 2.0f * (xz - wy); R.m[7] = 2.0f * (yz + wx); R.m[8] = 1.0f - 2.0f * (xx + yy);
  return R;
}

// R p
CG_FN void rot(const Mat3& R, float px, float py, float pz, float* o) {
  o[0] = R.m[0] * px + R.m[1] * py + R.m[2] * pz;
  o[1] = R.m[3] * px + R.m[4] * py + R.m[5] * pz;
  o[2] = R.m[6] * px + R.m[7] * py + R.m[8] * pz;
}

// R^T p
CG_FN void rot_t(const Mat3& R, float px, float py, float pz, float* o) {
  o[0] = R.m[0] * px + R.m[3] * py + R.m[6] * pz;
  o[1] = R.m[1] * px + R.m[4] * py + R.m[7] * pz;
  o[2] = R.m[2] * px + R.m[5] * py + R.m[8] * pz;
}

// The SDF's gradient as a unit vector (clamped norm), rotated by R.
CG_FN void unit_normal(const Mat3& R, const D3& d, float* o) {
  const float ign = 1.0f / maxf(sqrtf(d.x * d.x + d.y * d.y + d.z * d.z), 1e-9f);
  rot(R, d.x * ign, d.y * ign, d.z * ign, o);
}

// A world point against the plug SDF → (distance, outward unit normal, world).
CG_FN float plug_query(const GenArgs& a, int env, const Mat3& Rp, const float* w, float* out) {
  const float* t = a.plug_pos + 3 * env;
  float p[3];
  rot_t(Rp, w[0] - t[0], w[1] - t[1], w[2] - t[2], p);
  const D3 d = plug_sdf(p[0], p[1], p[2], a.kind + kKinds * env, a.plug_hx[env], a.plug_hy[env], a.plug_len[env]);
  unit_normal(Rp, d, out);
  return d.v;
}

CG_FN void cross(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

struct Slot {
  float r[3], n[3], v_other[3], depth, mu, weight, stiffness;
};

// Patch point `p` of finger `f`'s gel pad against the plug SDF.
CG_FN Slot finger_slot(const GenArgs& a, int env, int f, int p, const Mat3& Rp, const float* com) {
  const float* tip = a.tip_pos + 3 * (kFingers * env + f);
  float out_c[3];
  const float d_c = plug_query(a, env, Rp, tip, out_c);
  float pt[3] = {tip[0], tip[1], tip[2]}, out[3] = {out_c[0], out_c[1], out_c[2]};
  float d = d_c;
  if (p > 0) {
    // the pad's tangent basis from its centre normal: t1 = out_c x ref, ref = e_x or e_z
    const bool near_z = fabsf(out_c[2]) > 0.9f;
    const float ref[3] = {near_z ? 1.0f : 0.0f, 0.0f, near_z ? 0.0f : 1.0f};
    float t1[3], t2[3];
    cross(out_c, ref, t1);
    const float tn = maxf(sqrtf(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-9f);
    t1[0] = t1[0] / tn; t1[1] = t1[1] / tn; t1[2] = t1[2] / tn;
    cross(out_c, t1, t2);
    const float off = (p & 1) ? a.ring_off : -a.ring_off;
#pragma unroll
    for (int k = 0; k < 3; ++k) pt[k] = tip[k] + off * (p <= 2 ? t1[k] : t2[k]);
    d = plug_query(a, env, Rp, pt, out);
  }
  const float pen = minf(d, a.radius);
  const float* tv = a.tip_vel + 3 * (kFingers * env + f);
  Slot s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.r[k] = (pt[k] - out[k] * pen) - com[k];
    s.n[k] = -out[k];
    s.v_other[k] = tv[k];
  }
  s.depth = (p == 0 ? a.radius : a.ring_radius) - d;
  s.mu = a.mu_finger[a.mu_finger_stride * env];
  s.weight = 1.0f;
  s.stiffness = a.patch_stiffness;
  return s;
}

// Surface point `j` of the plug in world coordinates.
CG_FN void plug_point_world(const GenArgs& a, int env, int j, const Mat3& Rp, float* w) {
  const float* q = a.points + 3 * ((long long)env * a.P + j);
  const float* t = a.plug_pos + 3 * env;
  rot(Rp, q[0], q[1], q[2], w);
  w[0] = w[0] + t[0];
  w[1] = w[1] + t[1];
  w[2] = w[2] + t[2];
}

// Socket point `j` against the socket SDF, in the socket's frame.
CG_FN Slot socket_slot(const GenArgs& a, int env, int j, const Mat3& Rp, const float* com) {
  float w[3], p[3];
  plug_point_world(a, env, j, Rp, w);
  const Mat3 Rs = quat_to_matrix(a.socket_q + 4 * env);
  const float* ts = a.socket_pos + 3 * env;
  rot_t(Rs, w[0] - ts[0], w[1] - ts[1], w[2] - ts[2], p);
  const D3 d = socket_sdf(p[0], p[1], p[2], a.kind + kKinds * env, a.hole_hx[env], a.hole_hy[env],
                          a.socket_h[env], a.plate_hx, a.plate_hy);
  Slot s;
  unit_normal(Rs, d, s.n);
  for (int k = 0; k < 3; ++k) {
    s.r[k] = w[k] - com[k];
    s.v_other[k] = 0.0f;
  }
  s.depth = -d.v;
  s.mu = a.mu_socket[a.mu_socket_stride * env];
  s.weight = a.weights[(long long)env * a.P + j];
  s.stiffness = 0.0f;
  return s;
}

// Table point `j` against the halfspace z >= table height.
CG_FN Slot table_slot(const GenArgs& a, int env, int j, const Mat3& Rp, const float* com) {
  float w[3];
  plug_point_world(a, env, j, Rp, w);
  Slot s;
  for (int k = 0; k < 3; ++k) {
    s.r[k] = w[k] - com[k];
    s.v_other[k] = 0.0f;
  }
  s.n[0] = 0.0f;
  s.n[1] = 0.0f;
  s.n[2] = 1.0f;
  s.depth = a.table_h[env] - w[2];
  s.mu = a.mu_table[a.mu_table_stride * env];
  s.weight = a.weights[(long long)env * a.P + j];
  s.stiffness = 0.0f;
  return s;
}

// The contact of slot `slot` of env `env`.
CG_FN Slot contact_slot(const GenArgs& a, int env, int slot) {
  const Mat3 Rp = quat_to_matrix(a.plug_q + 4 * env);
  const float* com = a.com + 3 * env;
  if (slot < kFingerSlots) return finger_slot(a, env, slot / kPatch, slot % kPatch, Rp, com);
  if (slot < kFingerSlots + a.Ps) return socket_slot(a, env, slot - kFingerSlots, Rp, com);
  return table_slot(a, env, a.table_idx[slot - kFingerSlots - a.Ps], Rp, com);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads, 4) contact_gen_kernel(GenArgs a) {
  __shared__ float sh_r[3 * kThreads], sh_n[3 * kThreads], sh_v[3 * kThreads];
  const long long total = (long long)a.N * a.C;
  const long long base = (long long)blockIdx.x * kThreads;
  const long long i = base + threadIdx.x;
  const int count = (int)(total - base < kThreads ? total - base : kThreads);
  if (i < total) {
    const int env = (int)(i / a.C), slot = (int)(i % a.C);
    const Slot s = contact_slot(a, env, slot);
    for (int k = 0; k < 3; ++k) {
      sh_r[3 * threadIdx.x + k] = s.r[k];
      sh_n[3 * threadIdx.x + k] = s.n[k];
      sh_v[3 * threadIdx.x + k] = s.v_other[k];
    }
    a.depth[i] = s.depth;
    a.mu[i] = s.mu;
    a.weight[i] = s.weight;
    a.stiffness[i] = s.stiffness;
  }
  __syncthreads();
  // the block's slots are one contiguous range of each [N, C, 3] output
  for (int k = threadIdx.x; k < 3 * count; k += kThreads) {
    a.r[3 * base + k] = sh_r[k];
    a.n[3 * base + k] = sh_n[k];
    a.v_other[3 * base + k] = sh_v[k];
  }
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int contact_gen_launch(const void* tip_pos, const void* tip_vel, const void* plug_q,
                                  const void* plug_pos, const void* com, const void* socket_q,
                                  const void* socket_pos, const void* kind, const void* plug_hx,
                                  const void* plug_hy, const void* plug_len, const void* hole_hx,
                                  const void* hole_hy, const void* socket_h, const void* table_h,
                                  const void* mu_socket, const void* mu_table, const void* mu_finger,
                                  const void* points, const void* weights, const void* table_idx, void* r,
                                  void* n, void* depth, void* v_other, void* mu, void* weight, void* stiffness,
                                  int N, int P, int Ps, int Pt, int mu_socket_stride, int mu_table_stride,
                                  int mu_finger_stride, float plate_hx, float plate_hy, float radius,
                                  float ring_radius, float ring_off, float patch_stiffness, void* stream) {
  if (N <= 0) return 0;
  if (Ps < 0 || Pt < 0 || Ps > P) return (int)cudaErrorInvalidValue;
  GenArgs a;
  a.tip_pos = (const float*)tip_pos; a.tip_vel = (const float*)tip_vel; a.plug_q = (const float*)plug_q;
  a.plug_pos = (const float*)plug_pos; a.com = (const float*)com; a.socket_q = (const float*)socket_q;
  a.socket_pos = (const float*)socket_pos; a.kind = (const float*)kind; a.plug_hx = (const float*)plug_hx;
  a.plug_hy = (const float*)plug_hy; a.plug_len = (const float*)plug_len; a.hole_hx = (const float*)hole_hx;
  a.hole_hy = (const float*)hole_hy; a.socket_h = (const float*)socket_h; a.table_h = (const float*)table_h;
  a.mu_socket = (const float*)mu_socket; a.mu_table = (const float*)mu_table;
  a.mu_finger = (const float*)mu_finger; a.points = (const float*)points; a.weights = (const float*)weights;
  a.table_idx = (const int*)table_idx;
  a.r = (float*)r; a.n = (float*)n; a.depth = (float*)depth; a.v_other = (float*)v_other; a.mu = (float*)mu;
  a.weight = (float*)weight; a.stiffness = (float*)stiffness;
  a.N = N; a.P = P; a.Ps = Ps; a.Pt = Pt; a.C = kFingerSlots + Ps + Pt;
  a.mu_socket_stride = mu_socket_stride; a.mu_table_stride = mu_table_stride;
  a.mu_finger_stride = mu_finger_stride; a.plate_hx = plate_hx; a.plate_hy = plate_hy;
  a.radius = radius; a.ring_radius = ring_radius; a.ring_off = ring_off; a.patch_stiffness = patch_stiffness;
  const long long total = (long long)N * a.C;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  contact_gen_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
