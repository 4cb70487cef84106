"""The port's contact solver: its plain PyTorch version against both JAX
solver paths (the XLA reference and the Pallas kernel in interpret mode).
The CUDA kernel is held against the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.physics import solver as j_solver
from isaacgyminsertion_tpu.physics.solver_pallas import solve_contacts_fused as j_fused
from isaacgyminsertion_tpu_torch.physics import solver_kernel as sk
from isaacgyminsertion_tpu_torch.physics.solver import ContactSet
from isaacgyminsertion_tpu_torch.utils import profiling

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

H = 1.0 / 180.0


def _problem(n, c, seed):
    mass, I_inv, v, w, cs = sk.random_problem(n, c, seed)
    j_args = (jnp.asarray(mass), jnp.asarray(I_inv), jnp.asarray(v), jnp.asarray(w),
              j_solver.ContactSet(**{k: jnp.asarray(x) for k, x in cs.items()}))
    t_args = (torch.as_tensor(mass), torch.as_tensor(I_inv), torch.as_tensor(v),
              torch.as_tensor(w), ContactSet(**{k: torch.as_tensor(x) for k, x in cs.items()}))
    return j_args, t_args


def _assert_solver_tolerances(out, ref):
    """The reference's fused-vs-XLA tolerances: summation order differs, and
    across 16 iterations with discontinuous friction-cone projections tiny fp
    deltas grow to ~1e-3 — physically negligible."""
    a = lambda x: np.asarray(x)
    np.testing.assert_allclose(a(out.v), a(ref["v"]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(a(out.w), a(ref["w"]), rtol=5e-3, atol=2e-2)
    np.testing.assert_allclose(a(out.lam_n), a(ref["lam_n"]), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(a(out.lam_t), a(ref["lam_t"]), rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(a(out.dx), a(ref["dx"]), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(a(out.dth), a(ref["dth"]), rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("c,seed", [(37, 0), (37, 1), (255, 2)])
def test_plain_matches_jax_reference(c, seed):
    j_args, t_args = _problem(5, c, seed)
    ref = j_solver.solve_contacts(*j_args, H, iters=16, beta=0.0)
    dx, dth = j_solver.position_correction(j_args[0], j_args[1], j_args[4])
    out = sk.solve_contacts_fused_plain(*t_args, H)
    _assert_solver_tolerances(out, dict(v=ref.v, w=ref.w, lam_n=ref.lam_n, lam_t=ref.lam_t,
                                        dx=dx, dth=dth))


@pytest.mark.parametrize("c,seed", [(37, 3), (255, 4)])
def test_plain_matches_pallas_interpret(c, seed):
    j_args, t_args = _problem(5, c, seed)
    ref = j_fused(*j_args, H, interpret=True)
    out = sk.solve_contacts_fused_plain(*t_args, H)
    _assert_solver_tolerances(out, ref._asdict())


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    _, t_args = _problem(3, 20, 5)
    before = profiling.launches()["contact_solver"]
    out = sk.solve_contacts_fused(*t_args, H)
    ref = sk.solve_contacts_fused_plain(*t_args, H)
    assert profiling.launches()["contact_solver"] == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sk.solve_contacts_fused_cuda(*t_args, H)


def test_work_counts():
    # ~2,800 f32 operations per contact per launch; 68 bytes per contact
    assert sk.flops(1, 1) == 21 + 16 * 153 + 8 * 44
    # only the active contacts are iterated
    assert sk.flops(4, 255, active=40) == 4 * 255 * 21 + 40 * (16 * 153 + 8 * 44)
    assert sk.bytes_moved(1024, 255) == 1024 * 255 * 68 + 1024 * 112


# ------------------------------------------------------- inert contacts
# The CUDA kernel solves only the active contacts of an env (depth > 0 and
# weight != 0), compacted in contact order. These cases hold the fact it
# rests on, with the plain version: an inert contact has zero effective mass,
# so its impulses are exact zeros and dropping it only reorders the sums.


def _tame_problem(n, c, seed):
    """A random problem that stays bounded over the iterations (shorter lever
    arms than `random_problem`, whose 37-contact sets diverge), with env 1
    free of active contacts and every other weight of env 2 zero."""
    mass, I_inv, v, w, cs = sk.random_problem(n, c, seed)
    cs["r"] = cs["r"] * np.float32(0.2)
    cs["depth"][1] = -np.abs(cs["depth"][1])
    cs["weight"][2, ::2] = 0.0
    return mass, I_inv, v, w, cs


def _solve_plain(mass, I_inv, v, w, cs):
    T = torch.as_tensor
    return sk.solve_contacts_fused_plain(T(mass), T(I_inv), T(v), T(w),
                                         ContactSet(**{k: T(x) for k, x in cs.items()}), H)


@pytest.mark.parametrize("c,seed", [(37, 0), (255, 2)])
def test_inert_contacts_can_be_dropped(c, seed):
    mass, I_inv, v, w, cs = _tame_problem(5, c, seed)
    active = (cs["depth"] > 0) & (cs["weight"] != 0)
    assert active[1].sum() == 0 and active[2, ::2].sum() == 0 and active[2].sum() > 0
    # active contacts first, in contact order; the inert tail cut off
    order = np.argsort(~active, axis=1, kind="stable")
    k = int(active.sum(1).max())
    assert 0 < k < c
    take = lambda a: np.take_along_axis(a, order.reshape(order.shape + (1,) * (a.ndim - 2)), 1)[:, :k]
    full = _solve_plain(mass, I_inv, v, w, cs)
    cut = _solve_plain(mass, I_inv, v, w, {f: np.ascontiguousarray(take(a)) for f, a in cs.items()})
    for f in ("v", "w", "dx", "dth"):
        np.testing.assert_allclose(getattr(cut, f).numpy(), getattr(full, f).numpy(), rtol=0, atol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(cut.lam_n.numpy(), take(full.lam_n.numpy()), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cut.lam_t.numpy(), take(full.lam_t.numpy()), rtol=0, atol=1e-5)
    assert (full.lam_n.numpy()[~active] == 0.0).all()
    assert (full.lam_t.numpy()[~active] == 0.0).all()
    assert np.abs(full.lam_n.numpy()[active]).max() > 1e-4     # the active ones do push


@pytest.mark.parametrize("c", [37, 255])
def test_env_without_active_contact_keeps_its_velocity(c):
    mass, I_inv, v, w, cs = _tame_problem(3, c, seed=7)
    out = _solve_plain(mass, I_inv, v, w, cs)
    assert np.array_equal(out.v.numpy()[1], v[1]) and np.array_equal(out.w.numpy()[1], w[1])
    assert not out.dx.numpy()[1].any() and not out.dth.numpy()[1].any()
    assert not out.lam_n.numpy()[1].any() and not out.lam_t.numpy()[1].any()
    assert not np.array_equal(out.v.numpy()[0], v[0])          # an env in contact does move


def test_soft_only_env_has_no_position_correction():
    """The position phase sees rigid contacts only: an env whose active
    contacts are all soft (gel pads) gets dx = dth = 0 exactly, which is why
    the kernel may skip that phase for it."""
    mass, I_inv, v, w, cs = _tame_problem(3, 37, seed=8)
    cs["depth"][0, 3:] = -1.0e-3          # env 0 keeps only its three soft pad contacts
    out = _solve_plain(mass, I_inv, v, w, cs)
    assert (cs["depth"][0, :3] > 0).any() or not out.lam_n.numpy()[0].any()
    assert not out.dx.numpy()[0].any() and not out.dth.numpy()[0].any()
    assert out.dx.numpy()[2].any()


def test_default_random_set_is_order_sensitive():
    """Why the kernel's edge cases use `lever=0.01`: with the default lever
    arms some envs of the random set diverge, and there the plain version's
    own f32 result moves by more than 1e-3 (relative) when the contacts are
    merely solved in another order, which is all a kernel with another order
    of summation does. The bounded set moves by less than 1e-5."""
    perm = np.random.default_rng(0).permutation(255)

    def moved(lever, envs):
        mass, I_inv, v, w, cs = sk.random_problem(1024, 255, seed=0, lever=lever)
        cs = {k: a[envs] for k, a in cs.items()}
        args = (mass[envs], I_inv[envs], v[envs], w[envs])
        a = _solve_plain(*args, cs).lam_n.numpy()
        b = _solve_plain(*args, {k: np.ascontiguousarray(x[:, perm]) for k, x in cs.items()}).lam_n.numpy()
        return float((np.abs(b - a[:, perm]) / (0.05 + np.abs(a[:, perm]))).max()), float(np.abs(a).max())

    rel, biggest = moved(0.05, slice(700, 740))
    assert biggest > 1e3 and rel > 1e-3          # impulses of a resting plug are ~1e-2
    rel, biggest = moved(0.01, slice(700, 740))
    assert biggest < 1.0 and rel < 1e-5
