"""The tactile renderer kernel's share of its roofline in the traced slice's
control steps: Σ bound ÷ Σ device time of the kernels named
`tactile_render_kernel`. Each launch's operations are counted
(`work.kernels`) from its packed rows (each gel's used half-planes and
quadratic), its pixels and its noise kind; the wrapper keeps the packed rows
(fresh for each launch) and counts nothing inside the profiled slice."""

from .. import trace
from ..work import kernels


def install(ctx):
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk

    rec = ctx.records.setdefault("tactile_render", [])
    original = rk.tactile_rows_cuda

    def wrapped(scal, rays, mask, *, iters, exact=True, generator=None, noise_std=0.0, noise_kind="gauss",
                **kw):
        kind = noise_kind if noise_std > 0.0 and generator is not None else None
        rec.append((scal, rays.shape[1], exact, iters, kind))
        return original(scal, rays, mask, iters=iters, exact=exact, generator=generator, noise_std=noise_std,
                        noise_kind=noise_kind, **kw)

    rk.tactile_rows_cuda = wrapped
    return lambda: setattr(rk, "tactile_rows_cuda", original)


def read(ctx):
    rec = ctx.records.get("tactile_render", [])
    device_s = trace.kernel_seconds([ctx.parts["steps"]], "tactile_render_kernel") if ctx.parts.get("steps") else 0.0
    if not rec or device_s <= 0:
        return None
    bound = sum(kernels.bound_s(kernels.tactile_flops(scal, p, exact, it, kind),
                                kernels.tactile_bytes(scal.shape[0], p))
                for scal, p, exact, it, kind in rec)
    return bound / device_s * 100.0
