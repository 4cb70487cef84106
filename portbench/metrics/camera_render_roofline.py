"""The camera renderer kernel's share of its roofline in the traced slice's
control steps: Σ bound ÷ Σ device time of the kernels named
`camera_exact_kernel` / `camera_march_kernel`. Each launch's operations are
counted (`work.kernels`) from its packed rows (the used half-planes and
quadratics of each env's sections) and pixels; the wrapper keeps the packed
rows (fresh for each launch) and counts nothing inside the profiled slice."""

from .. import trace
from ..work import kernels


def install(ctx):
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk

    rec = ctx.records.setdefault("camera_render", [])
    original = rk.camera_rows_cuda

    def wrapped(scal, rays, *, iters, exact=True, **kw):
        rec.append((scal, rays.shape[1], exact, iters))
        return original(scal, rays, iters=iters, exact=exact, **kw)

    rk.camera_rows_cuda = wrapped
    return lambda: setattr(rk, "camera_rows_cuda", original)


def read(ctx):
    rec = ctx.records.get("camera_render", [])
    if not rec or not ctx.parts.get("steps"):
        return None
    names = {"camera_exact_kernel" if exact else "camera_march_kernel" for _, _, exact, _ in rec}
    device_s = sum(trace.kernel_seconds([ctx.parts["steps"]], name) for name in names)
    if device_s <= 0:
        return None
    bound = sum(kernels.bound_s(kernels.camera_flops(scal, p, exact, it), kernels.camera_bytes(scal.shape[0], p))
                for scal, p, exact, it in rec)
    return bound / device_s * 100.0
