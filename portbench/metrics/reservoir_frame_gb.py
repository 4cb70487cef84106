"""The device memory that DAgger's reservoir holds in stored frames (tactile,
depth, segmentation, point cloud), in GB: the program's host counter
`dagger.reservoir_frame_bytes`, which the reservoir adds once as it
allocates its buffers. Its part of `device_mem_peak_gb`."""


def read(ctx):
    from isaacgyminsertion_tpu_torch.utils import profiling

    frame_bytes = profiling.counters().get("dagger.reservoir_frame_bytes")
    return frame_bytes / 1e9 if frame_bytes else None
