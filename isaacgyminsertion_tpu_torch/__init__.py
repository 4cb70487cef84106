"""PyTorch + CUDA port of `isaacgyminsertion_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; module paths and names
mirror it so each function has an obvious counterpart. This package imports
`torch` and never `jax`, and nothing of the JAX package.

Entry points run on CUDA unless the caller passes `device="cpu"` (the tests
do); without a GPU and without an explicit CPU request they raise.

Top-level surface, as the JAX package's:
    isaacgyminsertion_tpu_torch.make("FactoryTaskInsertionTactile", num_envs=...)
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def make(task_name: str, **kwargs):
    """A vectorized task env by its reference name (`envs.vec_env.make`);
    `device=` passes through, and without it the env runs on CUDA."""
    from .envs.vec_env import make as _make

    return _make(task_name, **kwargs)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only when
    asked for. Raises rather than falling back to the CPU.

    On CUDA the float32 matmul precision is pinned to full fp32 (no TF32):
    the physics is fp32-only — a reduced-precision env went NaN within 23
    steps in the reference package."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return device
