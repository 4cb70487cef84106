"""The contact solver kernel's share of its roofline in the traced slice's
control steps: Σ bound ÷ Σ device time of the kernels named
`contact_solver_kernel`. Each launch's bound is the larger of its operations
÷ 67 TFLOP/s and its bytes ÷ 3.35 TB/s, counted (`work.kernels`) from the
launch's own inputs at the wrapper: envs, contact slots, active contacts.
The wrapper only keeps the inputs; the active contacts are counted once the
profiler has stopped, so the slice holds the program's launches alone."""

from .. import trace
from ..work import kernels

KERNEL = "contact_solver_kernel"


def install(ctx):
    from isaacgyminsertion_tpu_torch.physics import solver_kernel as sk

    rec = ctx.records.setdefault("contact_solver", [])
    original = sk.solve_contacts_fused_cuda

    def wrapped(mass, I_inv_w, v, w, cs, h, iters=16, pos_iters=8, **kw):
        rec.append((cs.depth, cs.weight, iters, pos_iters))
        return original(mass, I_inv_w, v, w, cs, h, iters=iters, pos_iters=pos_iters, **kw)

    sk.solve_contacts_fused_cuda = wrapped
    return lambda: setattr(sk, "solve_contacts_fused_cuda", original)


def read(ctx):
    rec = ctx.records.get("contact_solver", [])
    device_s = trace.kernel_seconds([ctx.parts["steps"]], KERNEL) if ctx.parts.get("steps") else 0.0
    if not rec or device_s <= 0:
        return None
    bound = 0.0
    for depth, weight, it, pit in rec:
        n, c = depth.shape
        active = int(((depth > 0) & (weight != 0)).sum())
        bound += kernels.bound_s(kernels.solver_flops(n, c, active, it, pit), kernels.solver_bytes(n, c))
    return bound / device_s * 100.0
