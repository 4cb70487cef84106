"""Profiling / determinism aux subsystems (SURVEY.md §5), and the port's
spans and counters.

Port of `isaacgyminsertion_tpu/utils/profiling.py`. The reference's
observability is wall-clock FPS meters only (frozen_ppo.py:279-321); here
`trace` records a `torch.profiler` trace (the host's ops and, on a card, its
kernels) as a Chrome trace, and `check_determinism` is the determinism knob
(reference `torch_deterministic`, utils.py:87-117: a same-input replay
check).

The recorder is one process-wide registry, because its spans sit in plain
functions (`engine.step`, `insertion.step`) that have no object to carry it:

- `span(name)` adds the block's host seconds to a total per name (no device
  synchronize: a microsecond or two a span). While a `torch.profiler` is
  recording it also opens `torch.profiler.record_function(name)`, so the
  span sits on the profiler's timeline beside the device's kernels. A
  child's name starts with its parent's (`physics.contacts` is inside
  `physics`). `spans()` reads the totals; `TrainEpoch.__call__` reports each
  one's delta over the epoch as `time/<name>_s`.
- `count(name, value)` adds to a counter: a host number at once; a device
  tensor (or a callable giving one) only while `tracing(True)` is on, kept
  as it is and reduced when `counters()` reads it, so that no counter
  launches a kernel where it counts. With tracing off a device count costs
  nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

_seconds: dict[str, float] = {}
_counts: dict[str, float] = {}
_pending: dict[str, list] = {}
_tracing = False
_profiler_on = torch._C._autograd._profiler_enabled   # True while a torch.profiler records


class span:
    """`with span(name):` adds the block's host seconds to `name`'s total,
    and marks the block on a recording profiler's timeline."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiler_on():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _seconds[self.name] = _seconds.get(self.name, 0.0) + (time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def spans() -> dict[str, float]:
    """Host seconds per span name, summed since the process started."""
    return dict(_seconds)


def spans_since(before: dict[str, float]) -> dict[str, float]:
    """Host seconds per span entered since `before` (a `spans()` reading)."""
    return {k: v - before.get(k, 0.0) for k, v in _seconds.items() if v != before.get(k)}


def tracing(on: bool) -> bool:
    """Keep (on) or drop (off) device counts → the previous setting."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


def count(name: str, value):
    """Add `value` to the counter `name`: an int or float at once; a tensor,
    or a callable giving a tensor or a number, only while tracing is on,
    reduced (summed) when the counters are read."""
    if isinstance(value, (int, float)):
        _counts[name] = _counts.get(name, 0) + value
    elif _tracing:
        _pending.setdefault(name, []).append(value)


def counters() -> dict[str, float]:
    """Every counter's total; the kept device counts are reduced here."""
    for name, kept in _pending.items():
        _counts[name] = _counts.get(name, 0) + sum(_reduce(v) for v in kept)
    _pending.clear()
    return dict(_counts)


def _reduce(value):
    value = value() if callable(value) else value
    return value.sum().item() if isinstance(value, torch.Tensor) else value


def launches() -> dict[str, int]:
    """The hand-written kernels' launches in this process, by kernel (their
    wrappers count them as `kernels.<kernel>`)."""
    counts = counters()
    return {k: counts.get(f"kernels.{k}", 0)
            for k in ("contact_solver", "contact_gen", "tactile_render", "camera_render")}


def clear_counters(prefix: str = ""):
    """Drop the counters whose names start with `prefix` (all by default)."""
    for table in (_counts, _pending):
        for name in [k for k in table if k.startswith(prefix)]:
            del table[name]


@contextlib.contextmanager
def trace(out_dir: str = "outputs/trace"):
    """Profile the block with `torch.profiler` (CPU, and CUDA where there is a
    card) and write `out_dir/trace.json`, a Chrome trace for Perfetto or
    chrome://tracing, with the spans opened in the block → yields that path
    (written when the block ends)."""
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
