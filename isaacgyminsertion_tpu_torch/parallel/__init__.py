"""Data-parallel training over torch.distributed (`mesh`) and its multi-rank
dry run (`dryrun`)."""

from .mesh import DataParallel, init, replicate, shard_env_batch  # noqa: F401
