"""Closed-form ray intersections, port vs JAX reference on the same numpy
inputs: the interval primitives, the packed section (constraints, interval
with entry normal, interior gradient) for all six section families, and the
solids. Tolerance 1e-5 (fp32 elementwise math in another operation order);
BIG-valued misses compare relative to BIG."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.sensors import raycast as j_rc
from isaacgyminsertion_tpu_torch.sensors import raycast as t_rc

torch.set_num_threads(1)

KINDS = ["circle", "box", "hexagon", "ellipse", "trapezoid", "triangle"]


def _close(j, t, what=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5, err_msg=what)


def _both(*arrays):
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


def _rays(rng, n, p, spread=0.03):
    """Origins a few cm off the section, directions mostly toward it."""
    o = rng.uniform(-spread, spread, (n, p, 3)) + np.array([0.0, 0.0, 0.08])
    d = -o + rng.normal(size=(n, p, 3)) * 0.01
    d[..., :2] += rng.normal(size=(n, p, 2)) * 0.005
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_interval_primitives_match():
    rng = np.random.default_rng(0)
    no, nd, c = rng.normal(size=(3, 64, 33))
    nd[:, :4] = 0.0                      # parallel rays: the always / never branch
    nd[:, 4:6] = 1e-12
    (jno, jnd, jc), (tno, tnd, tc) = _both(no, nd, c)
    for j, t in zip(j_rc._halfplane_interval(jno, jnd, jc), t_rc._halfplane_interval(tno, tnd, tc)):
        _close(j, t, "halfplane")
    lo, hi = np.minimum(no, c), np.maximum(no, c) + 0.1
    (jlo, jhi), (tlo, thi) = _both(lo, hi)
    for j, t in zip(j_rc._slab_interval(jc, jnd, jlo, jhi), t_rc._slab_interval(tc, tnd, tlo, thi)):
        _close(j, t, "slab")
    a = np.abs(no) + 0.1
    (ja,), (ta,) = _both(a)
    for j, t in zip(j_rc._quadratic_interval(ja, jnd, jc), t_rc._quadratic_interval(ta, tnd, tc)):
        _close(j, t, "quadratic")


def test_section_halfplanes_match():
    rng = np.random.default_rng(1)
    n = 24
    oh = np.eye(6, dtype=np.float32)[np.arange(n) % 6]
    hx, hy = rng.uniform(0.004, 0.02, (2, n))
    (joh, jhx, jhy), (toh, thx, thy) = _both(oh, hx, hy)
    j_hp, j_quad = j_rc.section_halfplanes(joh, jhx, jhy)
    t_hp, t_quad = t_rc.section_halfplanes(toh, thx, thy)
    assert tuple(t_hp.shape) == (n, t_rc.HP_SLOTS, 3) and tuple(t_quad.shape) == (n, 3)
    _close(j_hp, t_hp, "hp")
    _close(j_quad, t_quad, "quad")


@pytest.mark.parametrize("kind", range(6), ids=KINDS)
def test_packed_section_interval_normal_and_gradient_match(kind):
    rng = np.random.default_rng(10 + kind)
    n, p = 4, 200
    oh = np.tile(np.eye(6, dtype=np.float32)[kind], (n, 1))
    hx, hy = rng.uniform(0.005, 0.02, (2, n))
    o, d = _rays(rng, n, p)
    (joh, jhx, jhy, jo, jd), (toh, thx, thy, to, td) = _both(oh, hx, hy, o, d)
    j_hp, j_quad = j_rc.section_halfplanes(joh, jhx, jhy)
    t_hp, t_quad = t_rc.section_halfplanes(toh, thx, thy)
    j_out = j_rc.packed_interval_normal(jo[..., 0], jo[..., 1], jd[..., 0], jd[..., 1],
                                        j_hp[:, None], j_quad[:, None])
    t_out = t_rc.packed_interval_normal(to[..., 0], to[..., 1], td[..., 0], td[..., 1],
                                        t_hp[:, None], t_quad[:, None])
    hits = np.asarray(j_out[0]) < np.asarray(j_out[1])
    assert hits.mean() > 0.2                       # the rays do cross the section
    for j, t, name in zip(j_out, t_out, ("t_lo", "t_hi", "nx", "ny")):
        if name in ("nx", "ny") and kind in (0, 3):
            # the quadratic's normal scales with 1/a² (~1e4): compare its direction
            continue
        _close(j, t, name)
    jn = np.stack([np.asarray(j_out[2]), np.asarray(j_out[3])], -1)
    tn = np.stack([t_out[2].numpy(), t_out[3].numpy()], -1)
    unit = lambda v: v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    np.testing.assert_allclose(unit(tn)[hits], unit(jn)[hits], atol=1e-4)
    # interior gradient at points inside the section
    pts = rng.uniform(-0.6, 0.6, (n, p, 2)) * np.stack([hx, hy], -1)[:, None] * 0.6
    (jp,), (tp,) = _both(pts)
    j_g = j_rc.packed_inner_grad(jp[..., 0], jp[..., 1], j_hp[:, None], j_quad[:, None])
    t_g = t_rc.packed_inner_grad(tp[..., 0], tp[..., 1], t_hp[:, None], t_quad[:, None])
    _close(j_g[0], t_g[0], "inner distance")
    jg = unit(np.stack([np.asarray(j_g[1]), np.asarray(j_g[2])], -1))
    tg = unit(np.stack([t_g[1].numpy(), t_g[2].numpy()], -1))
    np.testing.assert_allclose(tg, jg, atol=1e-4)


@pytest.mark.parametrize("kind", range(6), ids=KINDS)
def test_plug_and_socket_hits_match_the_one_hot_reference(kind):
    """The port's solids run on the packed section; the reference's
    `plug_hit`/`socket_hit` blend the six per-family intervals. Same hits."""
    rng = np.random.default_rng(20 + kind)
    n, p = 4, 300
    oh = np.tile(np.eye(6, dtype=np.float32)[kind], (n, 1))
    hx, hy = rng.uniform(0.005, 0.02, (2, n))
    length = rng.uniform(0.03, 0.06, n)
    o, d = _rays(rng, n, p)
    (joh, jhx, jhy, jlen, jo, jd), (toh, thx, thy, tlen, to, td) = _both(oh, hx, hy, length, o, d)
    ex = lambda a: a[:, None]
    j_t = j_rc.plug_hit(jo, jd, ex(joh), ex(jhx), ex(jhy), ex(jlen))
    t_hp, t_quad = t_rc.section_halfplanes(toh, thx, thy)
    planes = lambda o, d: [o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2]]
    t_t = t_rc.plug_hit(*planes(to, td), ex(t_hp), ex(t_quad), ex(tlen))
    assert (np.asarray(j_t) < 1.0).mean() > 0.2
    _close(j_t, t_t, "plug_hit")
    height = rng.uniform(0.015, 0.03, n)
    (jh,), (th,) = _both(height)
    o2 = o * np.array([2.5, 2.5, 1.0], np.float32)       # spread over plate and hole
    d2 = -o2 / np.linalg.norm(o2, axis=-1, keepdims=True) * np.array([0.3, 0.3, 1.0], np.float32)
    d2 = d2 / np.linalg.norm(d2, axis=-1, keepdims=True)
    (jo2, jd2), (to2, td2) = _both(o2, d2)
    j_s = j_rc.socket_hit(jo2, jd2, ex(joh), ex(jhx), ex(jhy), ex(jh), 0.0508, 0.04572)
    t_s = t_rc.socket_hit(*planes(to2, td2), ex(t_hp), ex(t_quad), ex(th), 0.0508, 0.04572)
    assert (np.asarray(j_s) < 1.0).mean() > 0.5
    bad = np.abs(t_s.numpy() - np.asarray(j_s)) > 1e-5 + 1e-5 * np.abs(np.asarray(j_s))
    # a ray that enters the plate within 1e-7 of the hole's rim may fall on either side
    assert bad.mean() < 2e-3, bad.mean()


def test_table_sphere_and_capsule_hits_match():
    rng = np.random.default_rng(3)
    n, p = 3, 400
    o = rng.uniform(-0.02, 0.02, (n, p, 3)) + np.array([0.0, 0.0, 0.2])
    d = rng.normal(size=(n, p, 3)) * 0.3 + np.array([0.0, 0.0, -1.0])
    d[:, :5, 2] = 0.0                                     # rays parallel to the table
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    center = rng.uniform(-0.03, 0.03, (n, 1, 3)) + np.array([0.0, 0.0, 0.1])
    a = center + np.array([0.0, 0.02, 0.03])
    b = center + np.array([0.01, -0.02, -0.03])
    table_h = rng.uniform(0.0, 0.01, (n, 1))
    (jo, jd, jc, ja, jb, jt), (to, td, tc, ta, tb, tt) = _both(o, d, center, a, b, table_h)
    _close(j_rc.table_hit(jo, jd, jt), t_rc.table_hit(to, td, tt), "table")
    js, ts = j_rc.sphere_hit(jo, jd, jc, 0.03), t_rc.sphere_hit(to, td, tc, 0.03)
    assert (np.asarray(js) < 1.0).mean() > 0.05
    _close(js, ts, "sphere")
    jcap, tcap = j_rc.capsule_hit(jo, jd, ja, jb, 0.02), t_rc.capsule_hit(to, td, ta, tb, 0.02)
    assert (np.asarray(jcap) < 1.0).mean() > 0.05
    _close(jcap, tcap, "capsule")
