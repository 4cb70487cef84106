"""Dry run of data-parallel PPO over N ranks: one full train epoch (env
rollout, GAE, minibatch updates), state-only and then with the sensor stack
on, each rank a process with its own rows of the env batch.

Port of `__graft_entry__.dryrun_multichip`:

    python -m isaacgyminsertion_tpu_torch.parallel.dryrun N [--backend gloo|nccl] [--device cpu|cuda]

The ranks are spawned with `torch.multiprocessing` and meet through a
`file://` rendezvous in a temporary directory (no TCP port). The config is
the reference's reduced one (1 substep, 4 solver iterations, one
subassembly, horizon 2, 8 envs for N ≤ 8, else N); the sensors-on epoch adds
tactile, depth, seg and point clouds at `render_capacity=0.75`. Each run
prints the reference's `ok` line with rank 0's scalar metrics, after checking
that the loss is finite and that every rank ends with the same parameters,
Adam moments and normalizers, bit for bit. `gloo` serves the CPU and several
ranks on one card; `nccl` takes one card per rank.

`run_rank` is the rank function: `chip_smoke.py` drives it at other sizes
through `RunSpec`.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import torch

from ..algo import ppo
from ..assets import build_subassembly_set
from ..envs.config import TaskConfig, default_task_config
from ..physics.robot import build_kuka_openhand
from ..utils import profiling
from . import mesh

SENSOR_QUEUES = {"tactile_queue": (0.0, 1.0), "img_queue": (-1.0, 0.0), "seg_queue": (0.0, 3.0),
                 "pcl_queue": (-math.inf, math.inf)}


@dataclass(frozen=True)
class RunSpec:
    """One data-parallel training run of `run_rank`."""

    n_envs: int                 # the global env batch
    horizon: int = 2
    mini_epochs: int = 1
    reduced: bool = True        # 1 substep, 4 solver iterations, one subassembly
    sensors: bool = False       # tactile + depth/seg/pcl at render_capacity 0.75
    seed: int = 0


def task_config(spec: RunSpec) -> TaskConfig:
    cfg = default_task_config()
    if spec.reduced:
        cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, substeps=1, solver_iters=4))
    if spec.sensors:
        cfg = cfg.replace(env=dataclasses.replace(
            cfg.env, tactile=True, external_cam=True, depth_cam=True, seg_cam=True, pcl_cam=True,
            render_capacity=0.75))
    return cfg


def state_digest(state: ppo.PPOState) -> str:
    """sha256 of the parameters, the Adam moments and step counts, and the
    three normalizers: equal digests are equal bits."""
    h = hashlib.sha256()
    tensors = [t for _, t in sorted(state.net.state_dict().items())]
    for p in state.net.parameters():
        st = state.optimizer.state.get(p, {})
        tensors += [st[k] for k in ("step", "exp_avg", "exp_avg_sq") if k in st]
    for rms in (state.obs_rms, state.priv_rms, state.value_rms):
        tensors += list(rms)
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _zero_counts():
    profiling.clear_counters("kernels.")


def _counts() -> dict:
    return profiling.launches()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _frames(env_state) -> dict:
    """{queue: (min, max, all finite)} of the sensor queues that are on."""
    out = {}
    for name in SENSOR_QUEUES:
        q = getattr(env_state, name)
        if q.numel():
            q = q.float()
            out[name] = (float(q.min()), float(q.max()), bool(torch.isfinite(q).all()))
    return out


def run_spec(dp: mesh.DataParallel, spec: RunSpec) -> dict:
    """One training epoch on this rank → its result (metrics, launch counts,
    seconds, the state's digest, ...)."""
    cfg = task_config(spec)
    model = build_kuka_openhand()
    subs = build_subassembly_set(names=("yellow_round_peg_2in",) if spec.reduced else None)
    ppo_cfg = ppo.PPOConfig(horizon=spec.horizon, mini_epochs=spec.mini_epochs)
    _, _, state, train_epoch = ppo.build(cfg, ppo_cfg, model, subs, spec.n_envs, spec.seed, dp=dp)
    dev = dp.device
    draw = torch.Generator(device=dev)
    draw.set_state(state.train_gen.get_state())
    first = dict(socket_pos=state.env_state.params.socket_pos[0].tolist(),
                 noise=torch.randn(4, generator=draw, device=dev).tolist())
    _sync(dev)
    _zero_counts()
    t0 = time.perf_counter()
    state, metrics = train_epoch(state)
    _sync(dev)
    secs = time.perf_counter() - t0
    counts = _counts()
    return dict(rank=dp.rank, metrics=metrics, counts=counts, secs=secs,
                env_steps_per_s=spec.n_envs // dp.world_size * spec.horizon / secs,
                agent_steps=state.agent_steps, digest=state_digest(state),
                render_rows=[list(r) for r in train_epoch.render_rows],
                frames=_frames(state.env_state), first=first,
                finite=all(bool(torch.isfinite(p).all()) for p in state.net.parameters()))


def run_rank(rank: int, world_size: int, backend: str, init_method: str, device, specs, out_dir: str):
    """The rank function: join the group, run each spec, write the results to
    `out_dir/rank<r>.json`."""
    dp = mesh.init(backend, rank, world_size, init_method, device)
    try:
        if dp.device.type == "cpu":
            torch.set_num_threads(1)   # tiny batches: threads would only contend with the other ranks
        results = [run_spec(dp, s) for s in specs]
    finally:
        mesh.close(dp)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def _entry(rank, world_size, backend, init_method, device, specs, out_dir):
    if sys.platform == "linux":   # a rank dies with the process that spawned it
        import ctypes
        import signal

        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    run_rank(rank, world_size, backend, init_method, device, specs, out_dir)


def spawn(world_size: int, backend: str, device, specs) -> list[list[dict]]:
    """Run `specs` on `world_size` spawned ranks → [rank][spec] results."""
    import torch.multiprocessing as tmp

    from . import dryrun as this   # pickled by its package path, also under `python -m`

    with tempfile.TemporaryDirectory(prefix="dryrun_") as d:
        init_method = "file://" + os.path.join(d, "rendezvous")
        tmp.spawn(this._entry, args=(world_size, backend, init_method, device, list(specs), d),
                  nprocs=world_size, join=True)
        results = []
        for r in range(world_size):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def check(results, i: int) -> dict:
    """Spec `i`'s results over the ranks: a finite loss and finite parameters,
    one digest on every rank → rank 0's scalar metrics. Raises otherwise."""
    runs = [r[i] for r in results]
    m = runs[0]["metrics"]
    if not math.isfinite(m["loss"]) or not all(r["finite"] for r in runs):
        raise RuntimeError(f"dryrun: loss {m['loss']} or a parameter not finite")
    digests = {r["digest"] for r in runs}
    if len(digests) != 1:
        raise RuntimeError(f"dryrun: the ranks' parameters, moments or normalizers differ: {digests}")
    return m


def dryrun(n_ranks: int, backend: str = "gloo", device=None):
    """The reference's two dry-run epochs over `n_ranks` ranks; prints its two
    `ok` lines → the results."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    n_envs = n_ranks * max(1, 8 // n_ranks)
    specs = [RunSpec(n_envs=n_envs, seed=0), RunSpec(n_envs=n_envs, sensors=True, seed=1)]
    results = spawn(n_ranks, backend, device, specs)
    for i, label in enumerate(("ok", "sensors-on ok")):
        m = check(results, i)
        print(f"dryrun_multichip({n_ranks}) {label}:", {k: float(v) for k, v in m.items()}, flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", type=int, nargs="?", default=8)
    ap.add_argument("--backend", choices=mesh.BACKENDS, default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="cpu, or cuda (the default: rank r on card r mod the cards)")
    args = ap.parse_args(argv)
    dryrun(args.n_ranks, args.backend, "cpu" if args.device == "cpu" else None)


if __name__ == "__main__":
    main()
