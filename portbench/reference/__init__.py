"""The plain reference that decides `correct`: plain PyTorch in float32 with
TF32 off, importing nothing of the port.

- `frozen/`: a frozen copy of the port's env, physics and sensors, its three
  hand-written kernels replaced by their plain versions;
- `nets.py`: the networks' forward passes, written out from their published
  layer equations;
- `ppo.py`, `dagger.py`: GAE, the normalizers, the losses, the gradient clip
  and Adam of the two algorithms, and the reservoir's slot arithmetic;
- `check.py`: the numbers compared, from the program's recorded epoch.
"""
