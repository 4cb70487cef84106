"""What holds the hand-written kernels back on the card.

    python -m isaacgyminsertion_tpu_torch.kernel_ablation [--kernel solver|tactile|camera|all]

The card's machine has no kernel profiler, so the question is answered by
ablation: each variant below is the shipped CUDA source with a few lines
replaced (a pass removed, a division replaced, another number of pixels per
thread or warps per block), built beside the shipped kernel and timed on CUDA
events on the inputs the main path gives the kernel: the contact problem of a
real physics substep at 1024 and at 256 envs and the random contact set (one
third of the contacts active); the packed tactile rows (768 rows x 4096
pixels) and camera rows (256 envs x 5184 pixels) of a sensors-on env three
steps after reset, and for the camera also a random scene of 256 envs; the
renderers with the L2 flushed before every launch. `--kernel camera` also
times the shipped march variants (exact=False) of both renderers at those
shapes. The shipped sources carry no switch: the variants live only here, as
text replacements that must match the source exactly (a replacement that no
longer matches fails the run, so the table cannot go stale silently).

Some variants are wrong on purpose (fast math in the physics, a 4-step
butterfly that is right only for 16 active contacts or fewer): they are timed
to price a cost, and their error column says what they break. Prints the
card's name and power limit, one line per variant, and one JSON object, which
`--out FILE` also writes to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from .assets import build_subassembly_set
from .envs.config import default_task_config
from .physics import solver_kernel as sk
from .physics.robot import build_kuka_openhand
from .physics.solver import ContactSet
from .sensors import render_kernels as rk
from .utils import capture
from .utils.cuda_build import BUILD_DIR, CSRC_DIR, CudaKernel, build_all

H = 1.0 / 180.0

# (name, [(old, new, occurrences)], extra nvcc flags)
_TANGENT_FAST = ("const float inv_vt = 1.0f / sqrtf(vtx * vtx + vty * vty + vtz * vtz + 1e-16f);\n"
                 "      const float hx = vtx * inv_vt, hy = vty * inv_vt, hz = vtz * inv_vt;")
_TANGENT_DIV = ("const float vt_mag = sqrtf(vtx * vtx + vty * vty + vtz * vtz + 1e-16f);\n"
                "      const float hx = vtx / vt_mag, hy = vty / vt_mag, hz = vtz / vt_mag;")
_DENSE = [("if (d[k] > 0.0f && wt[k] != 0.0f) bits |= 1u << k;", "if (lane + 32 * k < a.C) bits |= 1u << k;", 1),
          ("act[k] = a.weight[i];", "act[k] = D[k] > 0.0f ? a.weight[i] : 0.0f;", 1)]
_MEFF_T = [("const float meff_t = act[k] / (n_active * (inv_m + ang));",
            "const float meff_t = act[k] / n_active / (inv_m + ang);", 1)]
_NORMAL_PRE = ("      const float vn = (NX[k] * vx + NY[k] * vy + NZ[k] * vz) +\n"
               "                       (TX[k] * wx + TY[k] * wy + TZ[k] * wz) - NVO[k];\n")
_NORMAL_FULL = ("      const float vn = NX[k] * (vx + (wy * RZ[k] - wz * RY[k]) - VOX[k]) +\n"
                "                       NY[k] * (vy + (wz * RX[k] - wx * RZ[k]) - VOY[k]) +\n"
                "                       NZ[k] * (vz + (wx * RY[k] - wy * RX[k]) - VOZ[k]);\n")
_TORQUE_PRE = "      tx += TX[k] * dl; ty += TY[k] * dl; tz += TZ[k] * dl;   // r x (n dl)\n"
_TORQUE_FULL = ("      tx += RY[k] * (NZ[k] * dl) - RZ[k] * (NY[k] * dl);\n"
                "      ty += RZ[k] * (NX[k] * dl) - RX[k] * (NZ[k] * dl);\n"
                "      tz += RX[k] * (NY[k] * dl) - RY[k] * (NX[k] * dl);\n")
_WARPS = "constexpr int kWarpsPerBlock = 4;"
SOLVER_VARIANTS = [
    ("shipped", [], []),
    ("three divisions for the tangent direction", [(_TANGENT_FAST, _TANGENT_DIV, 1)], []),
    ("act / n_active formed once per contact, not per pass", _MEFF_T, []),
    ("the friction cone's division only when a lane of the warp slides",
     [("const float scale = fminf(1.0f, lt_max / fmaxf(lt_mag, 1e-12f));",
       "const float lt_den = fmaxf(lt_mag, 1e-12f);\n      float scale = 1.0f;\n"
       "      if (__any_sync(kFull, lt_den > lt_max && lt_mag > 0.0f)) scale = fminf(1.0f, lt_max / lt_den);",
       1)], []),
    ("normal pass through v + w x r and r x (n dl), not the precomputed r x n",
     [(_NORMAL_PRE, _NORMAL_FULL, 1), (_TORQUE_PRE, _TORQUE_FULL, 1)], []),
    ("position phase for every env", [("if (__any_sync(kFull, any_rigid)) {", "if (true) {", 1)], []),
    ("no compaction: every contact a slot", _DENSE, []),
    ("no compaction, three divisions and position phase always",
     _DENSE + [(_TANGENT_FAST, _TANGENT_DIV, 1),
               ("if (__any_sync(kFull, any_rigid)) {", "if (true) {", 1)], []),
    ("1 warp per block", [(_WARPS, "constexpr int kWarpsPerBlock = 1;", 1)], []),
    ("2 warps per block", [(_WARPS, "constexpr int kWarpsPerBlock = 2;", 1)], []),
    ("8 warps per block", [(_WARPS, "constexpr int kWarpsPerBlock = 8;", 1)], []),
    ("one env per warp always: no two light envs in one warp",
     [("if (K <= 16 && K_pair <= 16 && (K | K_pair) != 0) {", "if (false) {", 1)], []),
    ("fast-math division and sqrt (not IEEE: prices them, breaks the physics rule)", [],
     ["-use_fast_math"]),
    ("no friction pass (wrong: prices the pass)",
     [("    // ---- friction pass\n    fx = fy = fz = tx = ty = tz = 0.0f;\n#pragma unroll\n"
       "    for (int k = 0; k < CPL; ++k) {",
       "    // ---- friction pass\n    fx = fy = fz = tx = ty = tz = 0.0f;\n#pragma unroll\n"
       "    for (int k = 0; k < 0; ++k) {", 1)], []),
]

_IEEE = ('#include "render_common.cuh"\n',
         '#include "render_common.cuh"\n#define rcp_fast(x) (1.0f / (x))\n#define sqrt_fast(x) sqrtf(x)\n'
         '#define rsqrt_fast(x) (1.0f / sqrtf(x))\n#define __logf logf\n#define __sincosf sincosf\n'
         '#define __cosf cosf\n', 1)
_SCALAR = ("const bool vec = p.vec_ok != 0;", "constexpr bool vec = false;", 1)
_VEC = "#define TACTILE_VEC 4"
_THREADS = "#define TACTILE_THREADS 128"
TACTILE_VARIANTS = [
    ("shipped", [], []),
    ("IEEE division, sqrtf, logf, sincosf", [_IEEE], []),
    ("no vote skips: interior gradient and shading for every warp",
     [("if (__any_sync(0xffffffffu, any_inside)) {", "if (true) {", 1),
      ("if (__any_sync(0xffffffffu, any_lit)) {", "if (true) {", 1)], []),
    ("interior gradient for every warp",
     [("if (__any_sync(0xffffffffu, any_inside)) {", "if (true) {", 1)], []),
    ("neutral half-plane slots not skipped",
     [("if (!((T.hp_used >> j) & 1)) continue;", "", 2)], []),
    ("scalar loads and stores, 4 pixels per thread", [_SCALAR], []),
    ("scalar loads and stores, 2 pixels per thread", [_SCALAR, (_VEC, "#define TACTILE_VEC 2", 1)], []),
    ("scalar loads and stores, 1 pixel per thread", [_SCALAR, (_VEC, "#define TACTILE_VEC 1", 1)], []),
    ("64 threads per block", [(_THREADS, "#define TACTILE_THREADS 64", 1)], []),
    ("256 threads per block", [(_THREADS, "#define TACTILE_THREADS 256", 1)], []),
]

_CAM_SCALAR = ("const bool vec = p.vec_ok != 0;", "constexpr bool vec = false;", 1)
_CAM_VEC = "#define CAMERA_VEC 4"
_CAM_THREADS = "#define CAMERA_THREADS 128"
_CAM_BOUNDS = "__global__ void __launch_bounds__(CAMERA_THREADS)\ncamera_exact_kernel"


CAMERA_VARIANTS = [
    ("shipped", [], []),
    ("at most 48 registers (10 blocks per SM)",
     [(_CAM_BOUNDS, _CAM_BOUNDS.replace("(CAMERA_THREADS)", "(CAMERA_THREADS, 10)"), 1)], []),
    ("IEEE division and sqrtf", [_IEEE], []),
    ("neutral half-plane slots and inactive quadratic not skipped",
     [("if (!((used >> j) & 1)) continue;   // block-uniform", "", 1),
      ("if (T.qact) {   // block-uniform", "if (true) {", 1)], []),
    ("no warp-vote skips", [("#define WARP_ANY(x) __any_sync(0xffffffffu, (x))", "#define WARP_ANY(x) true", 1)],
     []),
    ("no plug bounding-sphere vote (the other votes kept)",
     [("any = any || b * b - R.bs_cc > 0.0f;", "any = true;", 1)], []),
    ("no plate bounding-sphere vote (the other votes kept)",
     [("near = near || b * b - R.bp_cc > 0.0f;", "near = true;", 1)], []),
    ("no robot proxy (wrong: prices the proxy stage)",
     [("for (int k = 0; k < 5; ++k) {", "for (int k = 0; k < 0; ++k) {", 1),
      ("{   // the cylinder segment from a to b", "if (false) {", 1)], []),
    ("no plug (wrong: prices the plug stage)", [("any = any || b * b - R.bs_cc > 0.0f;", "", 1)], []),
    ("no socket (wrong: prices the socket stage)", [("near = near || b * b - R.bp_cc > 0.0f;", "", 1)], []),
    ("scalar loads and stores, 4 pixels per thread", [_CAM_SCALAR], []),
    ("scalar loads and stores, 2 pixels per thread", [_CAM_SCALAR, (_CAM_VEC, "#define CAMERA_VEC 2", 1)], []),
    ("scalar loads and stores, 1 pixel per thread", [_CAM_SCALAR, (_CAM_VEC, "#define CAMERA_VEC 1", 1)], []),
    ("64 threads per block", [(_CAM_THREADS, "#define CAMERA_THREADS 64", 1)], []),
    ("256 threads per block", [(_CAM_THREADS, "#define CAMERA_THREADS 256", 1)], []),
]


def _variant_kernels(shipped: CudaKernel, variants, tag):
    """One CudaKernel per variant, its source written under the build directory."""
    with open(shipped.source) as f:
        text = f.read()
    out_dir = os.path.join(BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    kernels = []
    for i, (name, edits, flags) in enumerate(variants):
        src = text
        for old, new, count in edits:
            if src.count(old) != count:
                raise RuntimeError(f"{tag} variant {name!r}: {old!r} occurs {src.count(old)} times "
                                   f"in {shipped.source}, expected {count}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{tag}_{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        kernels.append(CudaKernel(f"{tag}_ablation_{i}", path, shipped.entry, shipped.argtypes,
                                  headers=[os.path.relpath(h, CSRC_DIR) for h in shipped.headers],
                                  extra_flags=flags))
    return kernels


def _registers(k: CudaKernel, kernel: str = "") -> int:
    """The most registers a kernel of the build uses (those whose name holds `kernel`)."""
    regs = [r for name, r in k.register_counts().items() if kernel in name]
    return max(regs) if regs else -1


def ablate_solver(dev):
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    T = lambda a: torch.as_tensor(a, device=dev)
    sets = {}
    for n in (1024, 256):
        sets[f"captured_{n}"] = capture.substep_problem(cfg, model, subs, n, H, dev)
        mass, I_inv, v, w, cs = sk.random_problem(n, 255, seed=0)
        sets[f"random_{n}"] = (T(mass), T(I_inv), T(v), T(w), ContactSet(**{k: T(x) for k, x in cs.items()}))
    plain = {k: sk.solve_contacts_fused_plain(*a, H) for k, a in sets.items() if k.endswith("1024")}
    kernels = _variant_kernels(sk.KERNEL, SOLVER_VARIANTS, "solver")
    build_all(kernels)
    shipped, rows = sk.KERNEL, []
    try:
        for (name, _, _), k in zip(SOLVER_VARIANTS, kernels):
            sk.KERNEL = k
            row = dict(variant=name, registers=_registers(k))
            for key, args in sets.items():
                row[f"ms_{key}"] = capture.cuda_time_ms(lambda: sk.solve_contacts_fused_cuda(*args, H), reps=50)
            for key, ref in plain.items():
                out = sk.solve_contacts_fused_cuda(*sets[key], H)
                torch.cuda.synchronize()
                worst, bad, finite = capture.solver_errors(out, ref)
                row[f"max_abs_err_{key}"] = worst
                row[f"outside_tolerance_{key}"] = sum(b[1] for b in bad)
            rows.append(row)
            print(f"solver: {name}: {row['registers']} registers; captured 1024 envs "
                  f"{row['ms_captured_1024']:.4f} ms, 256 envs {row['ms_captured_256']:.4f} ms; random "
                  f"1024 envs {row['ms_random_1024']:.4f} ms, 256 envs {row['ms_random_256']:.4f} ms; "
                  f"captured max_abs_err {row['max_abs_err_captured_1024']:.3e} "
                  f"({row['outside_tolerance_captured_1024']} outside tolerance), random "
                  f"{row['outside_tolerance_random_1024']} outside tolerance", flush=True)
    finally:
        sk.KERNEL = shipped
    return rows


_SCENES = {}


def _render_scenes(dev):
    """The renderers' (args, kwargs) on a sensors-on env of 256 envs three steps
    after reset, and on a random scene of 256 envs (built once per run)."""
    if not _SCENES:
        cfg_s = capture.sensors_on(default_task_config())
        model = build_kuka_openhand()
        state, _, _ = capture.sensor_state(cfg_s, model, build_subassembly_set(), 256, dev)
        with torch.no_grad():
            _SCENES["env"] = capture.sensor_inputs(model, state)
            _SCENES["random"] = capture.random_scene(256, 7, dev)
    return _SCENES


def _flush(dev):
    return torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)   # 1 GB: 20 x L2


def ablate_tactile(dev):
    from .envs import insertion

    (t_args, t_kw), _ = _render_scenes(dev)["env"]
    with torch.no_grad():
        rows_in, kw = capture.tactile_packed(t_args, t_kw)
        ref = rk.tactile_rows_plain(*rows_in, **kw)
    flush = _flush(dev)
    kernels = _variant_kernels(rk.TACTILE_KERNEL, TACTILE_VARIANTS, "tactile")
    build_all(kernels)
    shipped, rows = rk.TACTILE_KERNEL, []
    noise = {"gauss": dict(noise_std=0.01, noise_kind="gauss"), "ih4": dict(noise_std=0.01, noise_kind="ih4"),
             "none": {}}
    try:
        for (name, _, _), k in zip(TACTILE_VARIANTS, kernels):
            rk.TACTILE_KERNEL = k
            row = dict(variant=name, registers=_registers(k))
            for key, nkw in noise.items():
                gen = insertion.make_generator(9, dev) if nkw else None
                row[f"ms_{key}"] = capture.cuda_time_ms(
                    lambda: rk.tactile_rows_cuda(*rows_in, **kw, generator=gen, **nkw), reps=30, flush=flush)
            out = rk.tactile_rows_cuda(*rows_in, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            flipped = err > 1e-3
            row["flipped_share"] = float(flipped.float().mean())
            row["max_abs_err"] = float(err[~flipped].max())
            rows.append(row)
            print(f"tactile: {name}: {row['registers']} registers; gauss {row['ms_gauss']:.4f} ms, ih4 "
                  f"{row['ms_ih4']:.4f} ms, no noise {row['ms_none']:.4f} ms; max_abs_err "
                  f"{row['max_abs_err']:.3e}, {row['flipped_share']:.5%} of pixels flipped", flush=True)
    finally:
        rk.TACTILE_KERNEL = shipped
    return rows


def ablate_camera(dev):
    scenes = _render_scenes(dev)
    sets, refs = {}, {}
    with torch.no_grad():
        for key in ("env", "random"):
            _, (c_args, c_kw) = scenes[key]
            sets[key] = capture.camera_packed(c_args, c_kw)
            refs[key] = rk.camera_rows_plain(*sets[key][0], **sets[key][1])
    flush = _flush(dev)
    kernels = _variant_kernels(rk.CAMERA_KERNEL, CAMERA_VARIANTS, "camera")
    build_all(kernels)
    shipped, rows = rk.CAMERA_KERNEL, []
    try:
        for (name, _, _), k in zip(CAMERA_VARIANTS, kernels):
            rk.CAMERA_KERNEL = k
            row = dict(variant=name, registers=_registers(k, "camera_exact_kernel"))
            for key, (rows_in, kw) in sets.items():
                row[f"ms_{key}"] = capture.cuda_time_ms(lambda: rk.camera_rows_cuda(*rows_in, **kw), reps=30,
                                                        flush=flush)
                kt, kd, kc = rk.camera_rows_cuda(*rows_in, **kw)
                torch.cuda.synchronize()
                pt, pd, pc = refs[key]
                err = (kt - pt).abs()
                flipped = err > 1e-3
                row[f"flipped_share_{key}"] = float(flipped.float().mean())
                row[f"max_abs_err_{key}"] = float(err[~flipped].max())
                row[f"ids_off_{key}"] = float((((kc != pc) | (kd != pd)) & ~flipped).float().mean())
            rows.append(row)
            print(f"camera: {name}: {row['registers']} registers; env state {row['ms_env']:.4f} ms, random "
                  f"{row['ms_random']:.4f} ms; env max_abs_err {row['max_abs_err_env']:.3e}, "
                  f"{row['flipped_share_env']:.5%} flipped, ids off {row['ids_off_env']:.5%}; random "
                  f"{row['flipped_share_random']:.5%} flipped, ids off {row['ids_off_random']:.5%}", flush=True)
    finally:
        rk.CAMERA_KERNEL = shipped
    return rows


def time_march(dev):
    """The shipped march variants (exact=False) of both renderers at the main
    path's shapes, on the env state, L2 flushed: times only."""
    from .envs import insertion

    (t_args, t_kw), (c_args, c_kw) = _render_scenes(dev)["env"]
    t_rows, t_kw2 = capture.tactile_packed(t_args, t_kw)
    c_rows, c_kw2 = capture.camera_packed(c_args, c_kw)
    flush = _flush(dev)
    gen = insertion.make_generator(9, dev)
    out = dict(
        tactile_iters=t_kw2["iters"], camera_iters=c_kw2["iters"],
        tactile_march_gauss_ms=capture.cuda_time_ms(
            lambda: rk.tactile_rows_cuda(*t_rows, **t_kw2, exact=False, generator=gen, noise_std=0.01),
            reps=30, flush=flush),
        tactile_exact_gauss_ms=capture.cuda_time_ms(
            lambda: rk.tactile_rows_cuda(*t_rows, **t_kw2, generator=gen, noise_std=0.01), reps=30, flush=flush),
        camera_march_ms=capture.cuda_time_ms(lambda: rk.camera_rows_cuda(*c_rows, **c_kw2, exact=False),
                                             reps=30, flush=flush),
        camera_exact_ms=capture.cuda_time_ms(lambda: rk.camera_rows_cuda(*c_rows, **c_kw2), reps=30,
                                             flush=flush))
    print(f"march: tactile {t_rows[0].shape[0]} rows x {t_rows[1].shape[1]} px, {out['tactile_iters']} trips, "
          f"Gauss noise: {out['tactile_march_gauss_ms']:.4f} ms (exact {out['tactile_exact_gauss_ms']:.4f}); "
          f"camera {c_rows[0].shape[0]} envs x {c_rows[1].shape[1]} px, {out['camera_iters']} trips: "
          f"{out['camera_march_ms']:.4f} ms (exact {out['camera_exact_ms']:.4f})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=["solver", "tactile", "camera", "all"], default="all")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation needs an NVIDIA GPU: the variants are CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    result = dict(card=card)
    if opts.kernel in ("solver", "all"):
        result["solver"] = ablate_solver(dev)
    if opts.kernel in ("tactile", "all"):
        result["tactile"] = ablate_tactile(dev)
    if opts.kernel in ("camera", "all"):
        result["camera"] = ablate_camera(dev)
        result["march"] = time_march(dev)
    print(json.dumps(result), flush=True)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
