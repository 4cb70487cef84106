"""One run of one benchmark cell on one card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the process's start): imports, the
kernels' `.so` files (built by nvcc into the port's `_build/` on a
checkout's first run), the program's model, env and reset, the benchmark's
weights, and one training epoch through the window's own call —
the first step, which warms every shape the cell uses and is recorded for
the reference. The window then runs whole epochs, starting one only while it
is expected to end within `--seconds` (at least three), between two device
synchronizations; `env_steps_per_s` is their agent steps over that time.
Without `--trace` the result holds the cell's end-to-end metrics. With
`--trace 1` the same window reads the program's phase timers, and a
short slice after it (a few control steps, then one update phase) runs under
torch.profiler for the per-layer metrics. Then the program's state is freed
and the plain reference (`reference/`) follows the recorded first epoch:
each number compared is printed beside its limit, as the last lines on
standard error and as the last key of the result line.

Exits nonzero without a result when no CUDA card is present, when the
cell's chips are not there, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "isaacgyminsertion_tpu")
TRACE_STEPS = 4
MIN_EPOCHS = 3


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def cell_spec(name: str, root: str = ROOT):
    """(BENCHMARK.json, workload entry, configuration, traffic mix) of a cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", f"{cell['traffic']}.json")) as f:
        mix = json.load(f)
    return bench, cell, cfg, mix


def metric_module(name: str):
    """The reader of a metric: `metrics/<quantity>.py`, the quantity being
    the name up to its first dot (`mfu.mem` is `mfu` in other cells)."""
    return importlib.import_module(f"portbench.metrics.{name.split('.')[0]}")


def cell_metrics(bench: dict, cell: str, kind: str = "per_layer") -> list:
    """The metrics of `kind` (`per_layer` or `end_to_end`) this cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def host_sample() -> dict:
    """This process's CPU seconds and context switches, and the machine's CPU
    time by kind (seconds summed over its CPUs, from /proc/stat)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"wall": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
           "majflt": ru.ru_majflt}
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
        hz = os.sysconf("SC_CLK_TCK")
        kinds = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")
        out.update({k: v / hz for k, v in zip(kinds, ticks)})
    except (OSError, ValueError):
        pass
    return out


def host_line(a: dict, b: dict) -> str:
    """What the host did between two `host_sample`s: this process's share of
    one CPU, the other processes' busy CPUs, the CPUs the hypervisor stole."""
    wall = b["wall"] - a["wall"]
    line = (f"host: this process {100 * (b['cpu'] - a['cpu']) / wall:.1f}% of a CPU, "
            f"{b['nivcsw'] - a['nivcsw']} involuntary switches, {b['majflt'] - a['majflt']} major faults")
    d = {k: b[k] - a[k] for k in ("user", "nice", "system", "irq", "softirq", "steal", "idle", "iowait")
         if k in a and k in b}
    if len(d) == 8 and sum(d.values()) > 0:   # a sandboxed /proc/stat may read all zeros
        busy = d["user"] + d["nice"] + d["system"] + d["irq"] + d["softirq"]
        line += (f"; machine: {os.cpu_count()} CPUs, {(busy - (b['cpu'] - a['cpu'])) / wall:.2f} busy "
                 f"with other processes, {d['steal'] / wall:.2f} stolen, {d['idle'] / wall:.2f} idle")
    return line


def window(system, seconds: float, first_epoch_s: float, sync) -> tuple:
    """Whole epochs between two synchronizations → (epoch metrics, seconds):
    at least `MIN_EPOCHS`, and another only while it is expected (from the
    last epoch's time) to end within `seconds`."""
    epochs, times = [], [first_epoch_s]
    sync()
    before = host_sample()
    t0 = time.perf_counter()
    while len(epochs) < MIN_EPOCHS or time.perf_counter() - t0 + times[-1] <= seconds:
        t = time.perf_counter()
        epochs.append(system.epoch())
        sync()
        times.append(time.perf_counter() - t)
    window_s = time.perf_counter() - t0
    log(f"epoch seconds: first {times[0]:.3f}, window {[round(x, 3) for x in times[1:]]}")
    log(host_line(before, host_sample()))
    return epochs, window_s


def limits(cfg: dict, mix: dict) -> dict:
    """The check's limits: the configuration's, where the traffic mix sets
    none of its own (sensors on add the renderers' rounding to a step)."""
    return {**cfg["limits"], **mix.get("limits", {})}


def _finite(x):
    """A JSON number, or None for a reading that is not finite."""
    return x if math.isfinite(x) else None


def run(bench: dict, cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, dev) -> tuple:
    """Set-up, window, traced slice and the reference's check of one cell on
    `dev` → (result line, checks)."""
    import torch

    from . import systems, trace
    from .reference import check

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    system = systems.build(cfg, mix, seed, dev, ROOT)
    log(f"built {cfg['name']} x {cell['traffic']} in {time.time() - T_START:.2f} s")
    steps = check.followed_steps(mix, system.control_steps, seed)
    t = time.perf_counter()
    cap, _ = system.capture_epoch(steps)
    sync()
    first_epoch_s = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - T_START
    log(f"first epoch {first_epoch_s:.2f} s; set-up {setup_s:.2f} s")

    epochs, window_s = window(system, seconds, first_epoch_s, sync)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rate = system.agent_steps * len(epochs) / window_s
    log(f"window: {len(epochs)} epochs in {window_s:.3f} s = {rate:.1f} env-steps/s")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded forbidden modules: {found}")

    ctx = types.SimpleNamespace(system=system, epochs=epochs, window_s=window_s, peak_bytes=peak, setup_s=setup_s,
                                parts={}, n_steps=TRACE_STEPS, records={})
    breakdown, device_extra = None, {}
    if traced:
        wanted = cell_metrics(bench, cell["name"])
        undo = [u for u in (getattr(metric_module(m["name"]), "install", lambda c: None)(ctx) for m in wanted) if u]
        try:
            control_step, update = system.profile_parts(cap)
            control_step(0)   # the slice's first step outside the profiler
            for rec in ctx.records.values():
                rec.clear()
            ctx.parts["steps"] = trace.profile(lambda: [control_step(i) for i in range(1, TRACE_STEPS + 1)], sync)
            ctx.parts["update"] = trace.profile(update, sync)
        finally:
            for u in undo:
                u()
        parts = list(ctx.parts.values())
        for name in ("contact_solver", "camera_", "tactile_"):
            log(f"traced slice: {sum(1 for p in parts for op in p['device_ops'] if name in op[0])} device ops "
                f"named like {name!r}")
        device_extra = {"busy_s": sum(p["busy_s"] for p in parts), "window_s": sum(p["wall_s"] for p in parts)}
        breakdown = {"device_ops": trace.top_device_ops(parts), "idle_gaps": trace.idle_gaps(parts)}
    else:
        wanted = cell_metrics(bench, cell["name"], "end_to_end")
    metrics = {}
    for m in wanted:
        value = metric_module(m["name"]).read(ctx)
        if value is None:
            log(f"{m['name']}: nothing to read in this run")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for m in epochs if not all(math.isfinite(v) for v in m.values()))
    device = {"platform": "gpu" if cuda else dev.type, "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": int(max(setup_peak, peak)), **device_extra}

    system.free()
    del system, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.compare(check.outputs_of_capture(cap, cfg, steps), check.follow(cap, cfg, mix, seed, dev, steps))
    log(f"reference: {len(steps)} control steps and {check.N_ADAM} Adam steps in {time.perf_counter() - t:.2f} s; "
        f"worst followed step {numbers['worst_step']}; worst leaves {numbers['worst_leaf']}")
    checks = {k: {"value": _finite(numbers[k]), "limit": limit} for k, limit in limits(cfg, mix).items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(epochs), "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, cell, cfg, mix = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA card(s); torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)   # one host thread: the port's host work is its Python dispatch
    log(f"card {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s); {card_line()}")
    result, checks = run(bench, cell, cfg, mix, args.seed, args.seconds, bool(args.trace), dev)
    found = forbidden_modules()
    if found:
        log(f"loaded forbidden modules: {found}")
        return 3
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
