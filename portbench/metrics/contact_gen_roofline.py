"""The contact generation kernel's share of its roofline in the traced
slice's control steps: Σ bound ÷ Σ device time of the kernels named
`contact_gen_kernel`. Each launch's bound is the larger of its operations ÷
67 TFLOP/s and its bytes ÷ 3.35 TB/s, both counted here from the launch's own
inputs at the wrapper: its envs, their section kinds and the per-env floats it
is handed. The wrapper only keeps the kinds; they are counted once the
profiler has stopped. A program without the kernel has nothing to read."""

from .. import trace
from ..work import kernels

KERNEL = "contact_gen_kernel"

# f32 operations per contact slot, counted from csrc/contact_gen.cu (an add, a
# multiply, a division, a sqrt, an abs, a min/max and a select count as one
# each; a tie-rule factor as 2 and a sign as 3), by section kind (circle, box,
# hexagon, ellipse, trapezoid, triangle): a fingertip patch slot, a socket
# slot; a table slot costs the same for every kind
FLOPS_FINGER_SLOT = (277, 349, 391, 346, 434, 605)
FLOPS_SOCKET_SLOT = (264, 304, 327, 302, 351, 446)
FLOPS_TABLE_SLOT = 68
FINGER_SLOTS, SOCKET_SLOTS, TABLE_SLOTS = 15, 144, 96


def flops(per_kind: list, n: int) -> int:
    """Operations of one launch over `n` envs, `per_kind[k]` of them of section kind k."""
    return sum(k * (FINGER_SLOTS * f + SOCKET_SLOTS * s) for k, f, s in
               zip(per_kind, FLOPS_FINGER_SLOT, FLOPS_SOCKET_SLOT)) + n * TABLE_SLOTS * FLOPS_TABLE_SLOT


def nbytes(n: int, per_env: int) -> int:
    """Bytes one launch must move: the socket and table points (3 floats) and
    weights read once, `per_env` floats of per-env inputs, and 13 floats of
    each contact slot written once."""
    c = FINGER_SLOTS + SOCKET_SLOTS + TABLE_SLOTS
    return 4 * n * ((SOCKET_SLOTS + TABLE_SLOTS) * 4 + per_env + 13 * c)


def _per_env_floats(args) -> int:
    """The launch's per-env floats: every argument but the surface points and
    weights (the 15 per-env tensors, then the friction coefficients)."""
    *per_env, _points, _weights, mat = args
    n = per_env[2].shape[0]
    return sum(t.numel() // n for t in (*per_env, *mat))


def install(ctx):
    try:
        from isaacgyminsertion_tpu_torch.physics import contact_kernel as ck
    except ImportError:
        return None
    rec = ctx.records.setdefault("contact_gen", [])
    original = ck.generate_contacts_cuda

    def wrapped(*args):
        rec.append((args[7], _per_env_floats(args)))
        return original(*args)

    ck.generate_contacts_cuda = wrapped
    return lambda: setattr(ck, "generate_contacts_cuda", original)


def read(ctx):
    rec = ctx.records.get("contact_gen", [])
    device_s = trace.kernel_seconds([ctx.parts["steps"]], KERNEL) if ctx.parts.get("steps") else 0.0
    if not rec or device_s <= 0:
        return None
    bound = 0.0
    for kind_onehot, per_env in rec:
        n = kind_onehot.shape[0]
        bound += kernels.bound_s(flops((kind_onehot != 0).sum(dim=0).tolist(), n), nbytes(n, per_env))
    return bound / device_s * 100.0
