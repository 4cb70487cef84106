"""Benchmark: PPO train-epoch throughput of the port on one GPU.

    python -m isaacgyminsertion_tpu_torch.bench [N_SENSORS N_STATE HORIZON]
    python -m isaacgyminsertion_tpu_torch.bench --worker MODE N HORIZON [DEVICE]

Port of the root `bench.py`, with its functions, modes, sizes, fall-backs,
subprocess bounds, budget and JSON keys. The headline is env-steps/s of the
whole PPO train epoch (physics, DR, resets, the sensors, the rollout, GAE
and the minibatch updates) at 8192 envs with the tactile and the depth + seg
cameras on (`sensors`), then the same with the point cloud (`pcl`), then the
state-only epoch at 1024 envs (`state`). `vs_baseline` divides by the same
assumed 10k A100 pin as the JAX bench: a pin, not a measured number.

Each measurement runs in a bounded subprocess (`--worker`): a worker that
hangs costs one phase's timeout, and one that fails (out of memory at 8192
sensors-on envs, say) exits nonzero, its last lines go into `error`, and the
sensors-on phase falls back to 4096, then 2048 envs. After every phase the
combined JSON is printed and written to `BENCH_torch_partial.json` at the
repo root, and a total budget skips the phases it cannot fit. Each worker's
own line (peak memory, FLOPs, launches) goes to stderr.

The worker runs on CUDA, or raises where there is none, unless it is given
a device (`cpu` for the tests). `measure` counts FLOPs over the warm-up epoch
with `torch.utils.flop_counter.FlopCounterMode` (the count slows an epoch
several times, so it never runs on a timed one) and divides them by the
timed epoch's seconds and the card's dense fp32 peak (TF32 is off): the
matmul-family ops only, so `mfu` is a floor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTIAL_PATH = os.path.join(ROOT, "BENCH_torch_partial.json")
ASSUMED_A100_BASELINE = 10_000.0  # env-steps/sec, IsaacGym factory insertion (assumed pin)

# dense fp32 peak FLOP/s outside the tensor cores (TF32 is off), keyed by substrings of
# torch.cuda.get_device_name, the most specific first (NVIDIA data sheets); an unknown
# card has no peak and no mfu
PEAK_F32_FLOPS_BY_NAME = [
    ("H100 PCIe", 51e12),
    ("H100", 67e12),      # SXM: "NVIDIA H100 80GB HBM3"
]
FLOPS_COUNTED = ("matmul-family aten ops (mm, addmm, bmm, convolution, attention) of the warm-up epoch, forward "
                 "and backward, by torch.utils.flop_counter; not counted: the elementwise physics and the three "
                 "hand-written kernels (contact solver, tactile and camera renderers)")

# Each worker is bounded. The slowest one is the first sensors-on worker at 8192 envs:
# it builds the three kernels with nvcc, resets, runs the FLOP-counted warm-up and
# three timed epochs. On an H100 the three workers took 382 s together and a state-only
# worker at 8192 envs 110 s (PERF.md §6): the default is ~4x a worker's time
WORKER_TIMEOUT_S = int(os.environ.get("IGT_BENCH_TIMEOUT", "600"))

MODES = ("sensors", "pcl", "state")


def peak_flops(device_name: str) -> float | None:
    name = device_name.lower()
    for key, peak in PEAK_F32_FLOPS_BY_NAME:
        if key.lower() in name:
            return peak
    return None


def task_config(mode: str):
    """The default `TaskConfig` with the sensors of `mode`."""
    from .envs.config import default_task_config

    base = default_task_config()
    if mode == "sensors":
        # render_capacity=0.75: render-on-demand gathers only the env rows that
        # consume a fresh frame this step (expected consume fraction 0.675 with
        # max_skip=2 + delay 0.1), so what the policy observes is unchanged up to
        # the vanishing binomial tail
        return base.replace(env=dataclasses.replace(
            base.env, tactile=True, external_cam=True, depth_cam=True, seg_cam=True, render_capacity=0.75))
    if mode == "pcl":
        # full visuotactile: tactile + depth/seg + the point cloud
        return base.replace(env=dataclasses.replace(
            base.env, tactile=True, external_cam=True, depth_cam=True, seg_cam=True, pcl_cam=True,
            render_capacity=0.75))
    if mode == "state":
        return base
    raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")


# --------------------------------------------------------------------------
# worker: one measurement in one process (bounded by the orchestrator)
# --------------------------------------------------------------------------

def build_epoch(cfg, n_envs, horizon=64, device=None):
    """→ (train_epoch, its initial state, ppo_cfg): a fresh network, seed 0."""
    from .algo import ppo
    from .assets import build_subassembly_set
    from .physics.robot import build_kuka_openhand

    ppo_cfg = ppo.PPOConfig(horizon=horizon)
    _, _, state, train_epoch = ppo.build(cfg, ppo_cfg, build_kuka_openhand(), build_subassembly_set(), n_envs, 0,
                                         device=device)
    return train_epoch, state, ppo_cfg


def measure(step, state, n_envs, horizon, epochs=3):
    """One warm-up epoch (the kernels build on first use; its FLOPs are
    counted), then `epochs` timed ones → (the worker's line: rate, mfu, the
    card, peak memory, FLOPs, and the timed epochs' launches and steps with
    rendered rows; the final state; the last epoch's metrics)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .utils.profiling import launches

    dev = state.obs_rms.mean.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    with counter:
        state, metrics = step(state)
    flops = float(counter.get_total_flops())
    sync()
    before, rows = launches(), []
    t0 = time.perf_counter()
    for _ in range(epochs):
        state, metrics = step(state)
        rows += step.render_rows
    sync()
    dt = (time.perf_counter() - t0) / epochs
    after = launches()
    device_kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = peak_flops(device_kind) if cuda else None
    return {
        "rate": horizon * n_envs / dt,
        "mfu": flops / dt / peak if peak and flops else None,
        "device_kind": device_kind,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
        "flops": flops,
        "flops_counted": FLOPS_COUNTED,
        "seconds_per_epoch": dt,
        "epochs": epochs,
        "launches": {k: after[k] - before[k] for k in after},
        "steps_with_rows": {"tactile_render": sum(1 for t, _ in rows if t),
                            "camera_render": sum(1 for _, c in rows if c)},
        "loss": metrics["loss"],
        "kl": metrics["kl"],
    }, state, metrics


def worker(mode: str, n_envs: int, horizon: int, device=None) -> None:
    """Run one measurement; print one JSON line; exit 0 on success."""
    from . import resolve_device

    dev = resolve_device(device)
    cfg = task_config(mode)
    step, state, ppo_cfg = build_epoch(cfg, n_envs, horizon, device=dev)
    line, _, _ = measure(step, state, n_envs, ppo_cfg.horizon)
    print(json.dumps(line), flush=True)


def run_worker(mode: str, n_envs: int, horizon: int, timeout: int, device=None):
    """Bounded subprocess around one measurement. Returns (dict|None, err|None)."""
    cmd = [sys.executable, "-m", "isaacgyminsertion_tpu_torch.bench", "--worker", mode, str(n_envs), str(horizon)]
    if device is not None:
        cmd.append(str(device))
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return None, f"{mode}@{n_envs}: timeout after {timeout}s"
    if out.returncode != 0:
        tail = (out.stderr or out.stdout or "").strip().splitlines()[-3:]
        return None, f"{mode}@{n_envs}: rc={out.returncode}: " + " | ".join(tail)[-400:]
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            return json.loads(line), None
        except json.JSONDecodeError:
            continue
    return None, f"{mode}@{n_envs}: no JSON in worker output"


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

# the three workers together (382 s on an H100, PERF.md §6), with room for the
# sensors-on fall-backs and a slower host
TOTAL_BUDGET_S = int(os.environ.get("IGT_BENCH_TOTAL_BUDGET", "1500"))


def main(n_ns=8192, n_so=1024, horizon=64):
    t_start = time.perf_counter()
    errors = []
    results = {"sensors": None, "pcl": None, "state": None}
    n_used = n_ns

    def emit(final=False):
        """Print + persist the current combined snapshot (never lose a
        landed phase). The stdout tail is always the latest complete JSON."""
        ns, pc, so = results["sensors"], results["pcl"], results["state"]
        rate_ns = ns["rate"] if ns else None
        out = {
            "metric": f"ppo_env_steps_per_sec_sensors_on_{n_used}",
            "value": round(rate_ns, 1) if rate_ns is not None else None,
            "unit": "env-steps/s",
            "vs_baseline": round(rate_ns / ASSUMED_A100_BASELINE, 3) if rate_ns is not None else None,
            "vs_baseline_note": "divisor is the driver's assumed 10k A100 env-steps/s pin (reference publishes no numbers)",
            f"state_only_{n_so}": round(so["rate"], 1) if so else None,
            f"full_visuotactile_pcl_{n_used}": round(pc["rate"], 1) if pc else None,
            "mfu_estimate": (round(ns["mfu"], 4) if ns["mfu"] is not None else None) if ns else 0.0,
            "device_kind": next((r["device_kind"] for r in (ns, pc, so) if r), "unknown"),
            "config": f"{n_used} envs, tactile 3x64x64 + depth/seg 96x54, "
                      f"render_capacity 0.75, horizon {horizon}",
            "elapsed_s": round(time.perf_counter() - t_start, 1),
        }
        if not final:
            out["partial"] = True
        if errors:
            out["error"] = "; ".join(e for e in errors if e)
        line = json.dumps(out)
        print(line, flush=True)
        try:
            with open(PARTIAL_PATH, "w") as f:
                f.write(line + "\n")
        except OSError:
            pass
        return out

    def budget_left():
        return TOTAL_BUDGET_S - (time.perf_counter() - t_start)

    def bounded(mode, n, min_need=240):
        """Run one phase inside the remaining total budget (skip, don't die)."""
        left = budget_left()
        if left < min_need:
            err = f"{mode}@{n}: skipped (total budget: {left:.0f}s left)"
            errors.append(err)
            print(f"bench: {err}", file=sys.stderr)
            return None
        res, err = run_worker(mode, n, horizon, int(min(WORKER_TIMEOUT_S, left)))
        if res is None:
            errors.append(err)
            print(f"bench: {err}", file=sys.stderr)
        else:
            print(f"bench: {mode}@{n}: {json.dumps(res)}", file=sys.stderr, flush=True)
        return res

    # the headline first: 8192 envs, tactile + depth/seg cameras on. If the card can't
    # take the full batch, degrade to the largest sensors-on batch that runs rather
    # than reporting nothing.
    for n_try in (n_ns, n_ns // 2, n_ns // 4):
        res = bounded("sensors", n_try)
        if res is not None:
            results["sensors"] = res
            n_used = n_try
            break
    emit()

    # full visuotactile (tactile + depth/seg + pcl) at the batch the sensors-on
    # number landed at
    results["pcl"] = bounded("pcl", n_used)
    emit()

    results["state"] = bounded("state", n_so)
    emit(final=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:6])
    else:
        main(*[int(a) for a in sys.argv[1:4]])
