"""Package install (reference setup.py parity)."""

from setuptools import find_packages, setup

setup(
    name="isaacgyminsertion_tpu",
    version="0.1.0",
    description=(
        "TPU-native visuotactile insertion framework (JAX/XLA): batched SDF "
        "physics, on-device tactile/depth sensing, PPO teacher + DAgger "
        "student training in one jit graph"
    ),
    # the JAX/TPU package and its PyTorch + CUDA port (CUDA C++ sources under
    # csrc/, built with nvcc at first use)
    packages=find_packages(include=["isaacgyminsertion_tpu*", "isaacgyminsertion_tpu_torch*"]),
    package_data={"isaacgyminsertion_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "einops", "torch",
    ],
    extras_require={
        "logging": ["tensorboardX", "imageio", "matplotlib"],
    },
)
