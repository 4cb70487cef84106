"""Trees of tensors as plain data: a NamedTuple becomes a dict with its class
name under `__type__`, so that the program's state can be kept on the host
and rebuilt with the reference's own classes."""

from __future__ import annotations

import torch


def to_data(x, device="cpu"):
    """A copy of `x` on `device`, NamedTuples as tagged dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"__type__": type(x).__name__, **{f: to_data(getattr(x, f), device) for f in x._fields}}
    if isinstance(x, dict):
        return {k: to_data(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_data(v, device) for v in x)
    return x


def from_data(d, types: dict, device):
    """Rebuild a tagged tree with the classes in `types` (by name) on `device`."""
    if isinstance(d, torch.Tensor):
        return d.to(device)
    if isinstance(d, dict) and "__type__" in d:
        cls = types[d["__type__"]]
        return cls(**{k: from_data(v, types, device) for k, v in d.items() if k != "__type__"})
    if isinstance(d, dict):
        return {k: from_data(v, types, device) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(from_data(v, types, device) for v in d)
    return d


def leaves(x, prefix="") -> dict:
    """{path: tensor} of a tree (NamedTuples, tagged dicts, dicts)."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        x = {f: getattr(x, f) for f in x._fields}
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k != "__type__":
                out.update(leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {}
