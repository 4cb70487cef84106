"""A frozen copy of the port's env (`envs/`), physics (`physics/`), sensors
(`sensors/`), batched math (`ops/`) and assets, taken when the benchmark was
added (when the repo's CPU tests held that code to the JAX package), with
the contact solver and the two renderers in their plain PyTorch versions on
every device and without data parallelism. The reference steps
it from the program's state; a later change to the program's env that
changes what a step computes shows as a gap. It is the port against a
snapshot of itself, not an independent restatement: a fault that the port's
env had when the snapshot was taken is in both sides. What the check holds
independently is the kernels (against their plain versions here), the
networks (`reference/nets.py`) and the algorithms (`reference/algo.py`)."""
