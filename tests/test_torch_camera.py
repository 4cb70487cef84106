"""The camera renderer's plain version on the scenes the CUDA kernel branches
on, port vs the JAX reference on the same numpy inputs.

The card checks (`tests/test_torch_cuda.py`, `chip_smoke.py`) hold the kernel
to `camera_render_plain` on these scenes; here that plain version is held to
the JAX package's `camera_march_fused(exact=True)`, its Pallas kernel run in
interpret mode. The scenes (`render_kernels.camera_edge_inputs`): one env per
section family (the quadratic active for the circle and the ellipse, inactive
for the rest), rays exactly parallel to half-plane faces and plate slabs, the
robot proxy parked or in view with a capsule across the plug and a fingertip
wholly behind the camera. Tolerance as for the other render parity tests:
mean abs < 1e-4 on t, fewer than 0.5 % of the pixels off by more than 1e-3,
d_min and component ids equal off those pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.sensors import render_pallas as j_rp
from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk

torch.set_num_threads(1)

PROXY = ("tips_cam", "wrist_cam", "hand_cam")


@pytest.mark.parametrize("proxy,tilt", [(True, 0.0), (False, 0.0), (True, 0.1)],
                         ids=["proxy_in_view", "proxy_parked", "proxy_in_view_tilted"])
def test_camera_edge_scenes_match_the_pallas_kernel(proxy, tilt):
    args, kw = rk.camera_edge_inputs(6, proxy=proxy, tilt=tilt, seed=2)
    assert args[14].shape[0] % 128 == 0                      # the Pallas kernel's lane multiple
    if tilt == 0.0:
        # rays parallel to the faces with normal (1, 0) or (0, 1): u.d is exactly 0
        assert (args[14][:, 0] == 0.0).any() and (args[14][:, 1] == 0.0).any()
    proxy_kw = {k: kw[k] for k in PROXY if k in kw}
    rest = {k: v for k, v in kw.items() if k not in PROXY}
    j_out = j_rp.camera_march_fused(*[jnp.asarray(a) for a in args], rest["iters"], rest["near"],
                                    rest["far"], rest["plate_hx"], rest["plate_hy"],
                                    **{k: jnp.asarray(v) for k, v in proxy_kw.items()},
                                    tip_radius=rest["tip_radius"], hand_radius=rest["hand_radius"],
                                    interpret=True, exact=True)
    t_out = rk.camera_render_plain(*[torch.as_tensor(a) for a in args],
                                   **{k: torch.as_tensor(v) for k, v in proxy_kw.items()}, **rest,
                                   exact=True)
    jt, jd, jc = (np.asarray(x) for x in j_out)
    tt, td, tc = (x.numpy() for x in t_out)
    assert np.isfinite(tt).all()
    d = np.abs(jt - tt)
    assert d.mean() < 1e-4, d.mean()
    flipped = d > 1e-3
    assert flipped.mean() < 5e-3, flipped.mean()
    assert ((jd != td) & ~flipped).mean() < 1e-4
    assert ((jc != tc) & ~flipped).mean() < 1e-4
    # every env (one per family) sees the socket, the proxy only when in view, and the
    # plug unless the capsule hides it
    counts = np.stack([np.bincount(jc[e].astype(int), minlength=4) for e in range(6)])
    assert (counts[:, 2] > 0).all() and ((counts[:, 3] > 0) == proxy).all(), counts
    assert (counts[:, 1] > 0).sum() >= (4 if proxy else 6), counts


def test_renderer_flops_count_each_familys_constraints():
    """The renderers' operation counts take only the half-plane slots and the
    quadratic each row's section family uses (family k of env k: circle, box,
    hexagon, ellipse, trapezoid, triangle); every slot and quadratic counted
    gives the dense 763 (camera) and 489 (tactile) a pixel."""
    args, _ = rk.camera_edge_inputs(6, proxy=False)
    scal, rays = rk.camera_rows(*[torch.as_tensor(a) for a in args])
    p = rays.shape[1]
    slots, quad = (0, 4, 6, 0, 4, 3), (1, 0, 0, 1, 0, 0)
    for e in range(6):
        section = 24 * slots[e] + 37 * quad[e]
        assert rk.camera_flops(scal[e:e + 1], p) == p * (401 + 2 * section)
    assert 401 + 2 * (24 * 6 + 37) == 763
    n = 6
    t_scal = rk.pack_tactile_rows(torch.eye(3).expand(n, 3, 3), torch.zeros(n, 3), torch.eye(6),
                                  torch.full((n,), 0.01), torch.full((n,), 0.012), torch.full((n,), 0.04),
                                  torch.ones(n))
    for e in range(6):
        section = 35 * slots[e] + 98 * quad[e]
        assert rk.tactile_flops(t_scal[e:e + 1], 100, noise_kind=None) == 100 * (181 + section)
        assert rk.tactile_flops(t_scal[e:e + 1], 100) == 100 * (181 + 31 + section)
    assert 181 + 35 * 6 + 98 == 489
