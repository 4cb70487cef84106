"""The readings of `control` with one more fault, for a student that reads
tactile frames, on the card at the cell's own size:

    python3 -m portbench.control_frames --workload <cell> --seeds <n> ... [--faulted <k>]

For each seed, one process builds the cell, runs its first epoch with the
recording of a benchmark run, frees the program and runs the reference:
  - `sound`: the program against the reference (the lower readings);
  - for the first `--faulted` seeds, the reference put in the program's place
    and compared with itself: `tf32`, `half_batch` and `token` as `control`
    plants them, and `tactile_frame`: one env's tactile frame (one finger's
    image) raised by 1.0 in the reference's input at its first followed
    rollout step.
Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time

import torch

from . import run, systems
from .reference import check
from .reference.kinds import dagger


@contextlib.contextmanager
def altered_tactile_frame():
    """The reference's first student input with env 0's second finger's
    tactile frame raised by 1.0."""
    inputs = dagger.student_inputs
    calls = [0]

    def altered(s, *a, **kw):
        inp = inputs(s, *a, **kw)
        calls[0] += 1
        if calls[0] == 1:
            tactile = inp["tactile"].clone()
            tactile[0, 0, 1] += 1.0
            inp = {**inp, "tactile": tactile}
        return inp

    dagger.student_inputs = altered
    try:
        yield
    finally:
        dagger.student_inputs = inputs


def readings(cell_name: str, seed: int, faulted: bool, dev) -> dict:
    bench, cell, cfg, mix = run.cell_spec(cell_name)
    t0 = time.perf_counter()
    system = systems.build(cfg, mix, seed, dev, run.ROOT)
    steps = check.followed_steps(mix, system.control_steps, seed)
    cap, _ = system.capture_epoch(steps)
    system.free()
    del system
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = check.follow(cap, cfg, mix, seed, dev, steps)
    out = {"seed": seed, "sound": check.compare(check.outputs_of_capture(cap, cfg, steps), ref)}
    t2 = time.perf_counter()
    if faulted:
        out["tf32"] = check.compare(check.follow(cap, cfg, mix, seed, dev, steps, tf32=True), ref)
        for fault in ("half_batch", "token"):
            out[fault] = check.compare(check.follow(cap, cfg, mix, seed, dev, steps, fault=fault,
                                                    rollout=ref["rollout"]), ref)
        with altered_tactile_frame():
            out["tactile_frame"] = check.compare(check.follow(cap, cfg, mix, seed, dev, steps), ref)
    out["seconds"] = {"program": t1 - t0, "reference": t2 - t1, "faults": time.perf_counter() - t2}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faulted", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the control readings are taken on a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    run.log(f"card {torch.cuda.get_device_name(0)}; {run.card_line()}")
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(args.workload, seed, i < args.faulted, dev)), flush=True)


if __name__ == "__main__":
    main()
