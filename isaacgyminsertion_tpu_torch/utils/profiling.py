"""Profiling / determinism aux subsystems (SURVEY.md §5).

Port of `isaacgyminsertion_tpu/utils/profiling.py`. The reference's
observability is wall-clock FPS meters only (frozen_ppo.py:279-321); here
`trace` records a `torch.profiler` trace (the host's ops and, on a card, its
kernels) as a Chrome trace, `check_determinism` is the determinism knob
(reference `torch_deterministic`, utils.py:87-117: a same-input replay
check), and `StepTimer` keeps per-phase EMAs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(out_dir: str = "outputs/trace"):
    """Profile the block with `torch.profiler` (CPU, and CUDA where there is a
    card) and write `out_dir/trace.json`, a Chrome trace for Perfetto or
    chrome://tracing → yields that path (written when the block ends)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def leaves(tree):
    """The leaves of a tree of tensors, dataclasses, NamedTuples, tuples,
    lists and dicts, in order; tensors as host copies."""
    if isinstance(tree, torch.Tensor):
        yield tree.detach().cpu()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from leaves(x)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield k
            yield from leaves(v)
    else:
        yield tree


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        a, b = a.numpy(force=True), b.numpy(force=True)
    if isinstance(a, (np.ndarray, np.generic, float, int, complex)):
        if type(a) is not type(b):
            return False
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def check_determinism(fn, *args, n: int = 2) -> bool:
    """Run `fn(*args)` n times and check that the outputs are the same bits,
    leaf by leaf (NaNs included)."""
    ref = list(leaves(fn(*args)))
    for _ in range(n - 1):
        out = list(leaves(fn(*args)))
        if len(out) != len(ref) or not all(_same_bits(a, b) for a, b in zip(ref, out)):
            return False
    return True


class StepTimer:
    """Per-phase step timing with EMA (first-class perf telemetry)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.ema[name] = (1 - self.alpha) * self.ema.get(name, dt) + self.alpha * dt

    def summary(self) -> dict[str, float]:
        return dict(self.ema)
