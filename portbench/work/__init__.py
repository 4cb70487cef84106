"""Frozen counts of work: the kernels' operations and bytes, the networks'
matmul FLOPs, and the H100's peaks. They count what the run's data needs, so
they stay the same whatever later implements the kernels or the networks."""

# NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
