"""The traced slice: torch.profiler over a few control steps, then over one
update phase, read into device busy time, kernel launches, kernel time by
name, and the longest idle gaps with what the host was doing.

The arithmetic follows the port's `profile_eval._profile`: busy is the time
in which a device operation ran (kernels, copies and sets, merged where they
overlap), a launch is a `cudaLaunchKernel`-family call on the host.
"""

from __future__ import annotations

import time

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def _device_events(events):
    """Device operations; not the device-side spans of annotations such as
    `Optimizer.step#Adam.step`, which cover kernels already counted."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and "#" not in e.name]


def _merged_busy_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile(fn, sync) -> dict:
    """`fn()` under torch.profiler → wall seconds, busy seconds, launches, the
    device operations [(name, start_us, end_us)] and the host ops [(name,
    start_us, end_us)], on one clock."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    sync()
    with prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in _device_events(events)]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    launches = sum(1 for name, _, _ in host if name in LAUNCH_CALLS)
    return {"wall_s": wall, "busy_s": _merged_busy_us([(a, b) for _, a, b in dev]) / 1e6,
            "launches": launches, "device_ops": dev, "host_ops": host}


def top_device_ops(parts: list, k: int = 10) -> list:
    """The k device operations with the most time over the parts, [name, seconds]."""
    total: dict = {}
    for p in parts:
        for name, a, b in p["device_ops"]:
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
    return [[name, s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(parts: list, k: int = 10) -> list:
    """The k longest gaps between device operations, each labelled with the
    innermost host op running at its middle, [label, seconds]."""
    gaps = []
    for i, p in enumerate(parts):
        end = None
        for a, b in sorted((a, b) for _, a, b in p["device_ops"]):
            if end is not None and a > end:
                gaps.append((a - end, 0.5 * (a + end), i))
            end = b if end is None else max(end, b)
    out = []
    for length, mid, i in sorted(gaps, reverse=True)[:k]:
        inner = [h for h in parts[i]["host_ops"] if h[1] <= mid <= h[2] and h[0] not in LAUNCH_CALLS]
        out.append([min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host (no op)", length / 1e6])
    return out


def kernel_seconds(parts: list, pattern: str) -> float:
    """Device seconds of the operations whose name holds `pattern`."""
    return sum((b - a) / 1e6 for p in parts for name, a, b in p["device_ops"] if pattern in name)
