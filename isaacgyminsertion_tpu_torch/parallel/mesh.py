"""Data parallelism over torch.distributed: one process per rank, each with
its own rows of the env batch and a full copy of the parameters.

Port of `isaacgyminsertion_tpu/parallel/mesh.py`. The JAX package shards the
envs over a mesh's `dp` axis, replicates the parameters, and lets XLA insert
the gradient psum because the loss is a mean over the global batch. In
PyTorch nothing is implicit: `algo/ppo.py::TrainEpoch` (with `dp=`) turns
each global reduction of the epoch into one of the collectives below, and
`envs/insertion.step` (with `dp=`) selects the render-on-demand rows over
the global batch. Unlike the reference's `shard_env_batch`, which replicates
a leaf whose leading axis the mesh does not divide, `shard_env_batch` here
raises: a replicated env leaf would make each rank step the same envs.

Collectives on the gloo backend are staged through host memory, so gloo
serves both CPU tensors and several ranks sharing one card (NCCL refuses
two ranks on one device). The backend is always the caller's choice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.checkpoint import tree_map

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel group."""

    rank: int
    world_size: int
    group: object            # the torch.distributed process group
    device: torch.device     # where this rank's tensors live
    backend: str

    def rows(self, n_global: int) -> tuple[int, int]:
        """[lo, hi): this rank's contiguous rows of a global batch of `n_global`."""
        if n_global % self.world_size:
            raise ValueError(f"{n_global} env rows do not split over {self.world_size} ranks")
        n = n_global // self.world_size
        return self.rank * n, (self.rank + 1) * n


def init(backend: str, rank: int, world_size: int, init_method: str, device=None) -> DataParallel:
    """Join the process group → this rank's `DataParallel`. The device is
    `cuda:<rank mod cards>` unless one is given (`"cpu"` for the CPU)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = resolve_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"nccl takes one card per rank: {world_size} ranks on "
                             f"{torch.cuda.device_count()} cards; use gloo to share a card")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return DataParallel(rank=rank, world_size=world_size, group=dist.group.WORLD, device=device,
                        backend=backend)


def close(dp: DataParallel):
    dist.destroy_process_group(dp.group)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generators: `seed` on rank 0 (a world of one
    repeats the single process), another one on every other rank. The ranks
    differ in the low 32 bits, the only ones a CPU generator's Mersenne
    twister keeps."""
    if rank == 0:
        return int(seed)
    return (int(seed) + int(rank) * 0x9E3779B9) & 0xFFFFFFFF


# --------------------------------------------------------------- collectives
# Each takes `dp=None` (a single process) as the identity, so a caller has one
# path for both.


def size(dp: DataParallel | None) -> int:
    """The number of ranks (1 for a single process)."""
    return 1 if dp is None else dp.world_size


def _host_staged(op, t: torch.Tensor, dp: DataParallel):
    """op(t), through a host copy where gloo holds a CUDA tensor."""
    if dp.backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        op(host)
        t.copy_(host)
    else:
        op(t)
    return t


def all_reduce_(t: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """Sum `t` over the ranks, in place; every rank gets the same bits."""
    if dp is None:
        return t
    return _host_staged(lambda x: dist.all_reduce(x, group=dp.group), t, dp)


def broadcast_(t: torch.Tensor, dp: DataParallel | None, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` on every rank, in place."""
    if dp is None:
        return t
    return _host_staged(lambda x: dist.broadcast(x, src, group=dp.group), t, dp)


def all_gather_rows(t: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """The ranks' equal-sized [n, ...] tensors stacked in rank order → [W·n, ...]."""
    if dp is None:
        return t
    src = t.cpu() if dp.backend == "gloo" else t
    parts = [torch.empty_like(src) for _ in range(dp.world_size)]
    dist.all_gather(parts, src.contiguous(), group=dp.group)
    return torch.cat(parts).to(t.device)


def sum_(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """The sum of `x` over its elements and the ranks (a scalar)."""
    return all_reduce_(torch.sum(x).reshape(1), dp)[0]


def mean(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """The mean of `x` over its elements and the ranks (equal sizes on every rank)."""
    if dp is None:
        return torch.mean(x)
    return sum_(x, dp) / (x.numel() * dp.world_size)


def moments(x: torch.Tensor, dims, dp: DataParallel | None):
    """Count, mean and population variance of `x` over `dims` and the ranks
    (each rank's count is the same): the ranks' (mean, M2), gathered and
    combined in rank order by Chan's rule, so every rank computes the same
    bits."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    m, var = torch.mean(x, dim=dims), torch.var(x, dim=dims, correction=0)
    if dp is None:
        return n, m, var
    parts = all_gather_rows(torch.stack([m, var * n])[None], dp)
    mean_, m2 = parts[0, 0], parts[0, 1]
    for r in range(1, dp.world_size):
        delta = parts[r, 0] - mean_
        mean_ = mean_ + delta / (r + 1)
        m2 = m2 + parts[r, 1] + delta ** 2 * (n * r / (r + 1))
    return n * dp.world_size, mean_, m2 / (n * dp.world_size)


# ------------------------------------------------------------------ layout


def shard_env_batch(env_state, dp: DataParallel):
    """This rank's contiguous rows [r·N/W, (r+1)·N/W) of every env-batch leaf
    (every tensor with a leading axis); scalars and host values stay. Raises
    when a leading axis is not divisible by the world size."""

    def take(x):
        if x.ndim == 0:
            return x
        lo, hi = dp.rows(x.shape[0])
        return x[lo:hi].clone()

    return tree_map(take, env_state)


@torch.no_grad()
def replicate(module: torch.nn.Module, dp: DataParallel, src: int = 0) -> torch.nn.Module:
    """Rank `src`'s parameters and buffers on every rank, in place."""
    for t in list(module.parameters()) + list(module.buffers()):
        broadcast_(t.data, dp, src)
    return module
