"""The plain reference that decides `correct`: plain PyTorch in float32 with
TF32 off, importing nothing of the port.

- `frozen/`: a frozen copy of the port's env, physics and sensors, its three
  hand-written kernels replaced by their plain versions;
- `nets/`: the networks, one module per kind (a network block's `kind`):
  weight layout, matmul counts, forward and action, written out from their
  published layer equations;
- `kinds/`: the algorithms, one module per `algo`: the followed rollout, the
  update's inputs, the policy outputs compared, the tiny test cut;
- `algo.py`: GAE, the normalizers, the losses, the gradient clip, Adam and
  the reservoir's slot arithmetic;
- `check.py`: the numbers compared, from the program's recorded epoch.
"""
