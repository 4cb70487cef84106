"""The port's model zoo (`models/zoo.py`) and the contact autoencoder of
`ActorCriticSplit` against the reference's flax modules, on the same weights
carried across by `zoo.load_jax_params` / `convert_jax_params`, at batch 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.models import zoo as jzoo
from isaacgyminsertion_tpu.models.actor_critic import ActorCriticSplit as JaxActorCritic
from isaacgyminsertion_tpu.models.actor_critic import ContactAE as JaxContactAE
from isaacgyminsertion_tpu_torch.models import zoo
from isaacgyminsertion_tpu_torch.models.actor_critic import (
    ActorCriticSplit,
    ContactAE,
    actor_critic_from_jax_params,
    convert_jax_params,
    to_jax_params,
)

torch.set_num_threads(1)


def np_tree(tree):
    """A flax tree (dict or FrozenDict, jax leaves) as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), rtol=tol, atol=tol, err_msg=what)


RNG = np.random.default_rng(0)
F32 = lambda *s: RNG.normal(size=s).astype(np.float32)
IMG = RNG.uniform(-1.0, 1.0, (2, 64, 64, 3)).astype(np.float32)

# name → (flax module, flax inputs, port module, tolerance); 1e-5 for the
# dense and 1-D nets, 1e-4 for the 2-D conv nets at 64 × 64
CASES = {
    "AdaptTConv": (jzoo.AdaptTConv(), (F32(2, 30, 6),), lambda: zoo.AdaptTConv(6, 8, 30), 1e-5),
    "ActorCritic": (jzoo.ActorCritic(use_ft=True), (F32(2, 15), F32(2, 30, 6)),
                    lambda: zoo.ActorCritic(use_ft=True), 1e-5),
    "TemporalBlock": (jzoo.TemporalBlock(16, 2), (F32(2, 10, 5),), lambda: zoo.TemporalBlock(5, 16, 2), 1e-5),
    "TCN": (jzoo.TCN(), (F32(2, 10, 5),), lambda: zoo.TCN(5), 1e-5),
    "TactileTransformer": (jzoo.TactileTransformer(), (F32(2, 5, 7),),
                           lambda: zoo.TactileTransformer(7, 5), 1e-5),
    "PointMAE": (jzoo.PointMAE(), (F32(2, 50, 3), (RNG.uniform(size=(2, 50)) > 0.3).astype(np.float32)),
                 lambda: zoo.PointMAE(), 1e-5),
    "TactileResNet": (jzoo.TactileResNet(), (IMG,), lambda: zoo.TactileResNet(), 1e-4),
    "ResnetGenerator": (jzoo.ResnetGenerator(), (IMG,), lambda: zoo.ResnetGenerator(), 1e-4),
    "PatchDiscriminator": (jzoo.PatchDiscriminator(), (IMG,), lambda: zoo.PatchDiscriminator(), 1e-4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_module_matches_flax(name):
    """Every output of the port's module equals flax apply on the same
    weights; a fresh port module has the reference's parameter tree (names
    and shapes), and its weights carry back to the same tree."""
    jmod, inputs, make, tol = CASES[name]
    params = np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(1), *[jnp.asarray(x) for x in inputs]))
    fresh = zoo.init_like_flax(make(), torch.Generator().manual_seed(0))
    assert shapes(zoo.to_jax_params(fresh)) == shapes(params)
    net = zoo.load_jax_params(make(), params)
    j_out = jax.jit(jmod.apply)(params, *[jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        t_out = net(*[torch.as_tensor(x) for x in inputs])
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    assert len(j_out) == len(t_out)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        assert tuple(a.shape) == tuple(b.shape), (name, i)
        _close(a, b, tol, f"{name} output {i}")
    back = zoo.to_jax_params(net)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_tactile_vae_matches_flax_with_the_same_eps():
    jmod = jzoo.TactileVAE()
    params = np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(2), jnp.asarray(IMG), jax.random.PRNGKey(3)))
    net = zoo.load_jax_params(zoo.TactileVAE(), params)
    key = jax.random.PRNGKey(4)
    recon_j, mu_j, logvar_j = jax.jit(jmod.apply)(params, jnp.asarray(IMG), key)
    eps = np.asarray(jax.random.normal(key, mu_j.shape))   # the draw the reference makes from `rng`
    with torch.no_grad():
        recon, mu, logvar = net(torch.as_tensor(IMG), eps=torch.as_tensor(eps))
    for a, b, what in ((recon, recon_j, "recon"), (mu, mu_j, "mu"), (logvar, logvar_j, "logvar")):
        _close(a, b, 1e-4, what)
    assert tuple(recon.shape) == (2, 64, 64, 3)


def test_flax_conv_transpose_pads_and_does_not_flip():
    """5 × 5 → 10 × 10 with flax's pads (2, 1) for k = 3 and (2, 2) for k = 4,
    the kernel correlated as stored."""
    import flax.linen as nn

    x = F32(1, 5, 5, 2)
    for k, pads in ((3, (2, 1)), (4, (2, 2))):
        jmod = nn.ConvTranspose(3, (k, k), strides=(2, 2))
        params = np_tree(jmod.init(jax.random.PRNGKey(k), jnp.asarray(x)))
        conv = zoo.FlaxConvTranspose(2, 3, k)
        assert conv.pads == pads
        zoo.load_jax_params(conv, params)
        with torch.no_grad():
            out = zoo._nhwc(conv(zoo._nchw(torch.as_tensor(x))))
        j_out = jmod.apply(params, jnp.asarray(x))
        assert tuple(out.shape) == (1, 10, 10, 3)
        _close(out, j_out, 1e-5, f"ConvTranspose k={k}")


def test_losses_match_flax():
    a, b = F32(2, 40, 3), F32(2, 30, 3)
    _close(zoo.chamfer_distance(torch.as_tensor(a), torch.as_tensor(b)),
           jzoo.chamfer_distance(jnp.asarray(a), jnp.asarray(b)), 1e-6, "chamfer")
    pred = F32(2, 8, 8, 1)
    for real in (True, False):
        _close(zoo.lsgan_loss(torch.as_tensor(pred), real), jzoo.lsgan_loss(jnp.asarray(pred), real),
               1e-6, f"lsgan {real}")


def test_point_mae_gradient_shares_tied_maxima():
    """The masked max-pool's gradient is shared among tied maxima, as jnp.max's is."""
    net = zoo.init_like_flax(zoo.PointMAE(8, 4), torch.Generator().manual_seed(0))
    pts = torch.zeros((1, 4, 3), requires_grad=True)   # four identical points: every feature ties
    out, feat = net(pts, torch.ones((1, 4)))
    feat.sum().backward()
    g = pts.grad[0]
    assert torch.allclose(g, g[0].expand_as(g))


def test_contact_ae_and_split_actor_critic_match_flax():
    """`ContactAE` and `ActorCriticSplit(use_contact_ae=True)`: the code, the
    reconstruction, mu, value and latent at 1e-5; the `contact_ae` subtree
    converts both ways."""
    contacts = RNG.uniform(size=(2, 400)).astype(np.float32)
    jae = JaxContactAE()
    ae_params = np_tree(jax.jit(jae.init)(jax.random.PRNGKey(5), jnp.asarray(contacts)))
    ae = ContactAE()
    ae.load_state_dict(_mlp_tree(ae_params["params"]))
    z_j, recon_j = jax.jit(jae.apply)(ae_params, jnp.asarray(contacts))
    with torch.no_grad():
        z, recon = ae(torch.as_tensor(contacts))
    _close(z, z_j, 1e-5, "ContactAE code")
    _close(recon, recon_j, 1e-5, "ContactAE recon")

    jnet = JaxActorCritic(use_contact_ae=True)
    obs, priv = F32(2, 15), F32(2, 64)
    init = jax.jit(jnet.init, static_argnums=3)
    params = np_tree(init(jax.random.PRNGKey(6), jnp.asarray(obs), jnp.asarray(priv), None, jnp.asarray(contacts)))
    net = actor_critic_from_jax_params(params, "cpu")
    assert isinstance(net, ActorCriticSplit) and net.use_contact_ae
    mu_j, log_std_j, v_j, lat_j, ex_j = jax.jit(jnet.apply, static_argnums=3)(
        params, jnp.asarray(obs), jnp.asarray(priv), None, jnp.asarray(contacts))
    with torch.no_grad():
        mu, log_std, v, lat, ex = net(torch.as_tensor(obs), torch.as_tensor(priv),
                                      contacts=torch.as_tensor(contacts))
    for a, b, what in ((mu, mu_j, "mu"), (v, v_j, "value"), (lat, lat_j, "latent"),
                       (ex["contact_recon"], ex_j["contact_recon"], "contact_recon")):
        _close(a, b, 1e-5, what)
    back = to_jax_params(net.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    assert set(convert_jax_params(params)) == set(net.state_dict())


def _mlp_tree(p):
    """The flax `ContactAE` params as the state dict keys of the port's one
    (its MLPs hold `layers.i`, the flax ones `Dense_i`)."""
    sd = {}
    for mlp in ("enc", "dec_h"):
        for name, leaf in p[mlp].items():
            i = int(name.split("_")[1])
            sd[f"{mlp}.layers.{i}.weight"] = torch.as_tensor(leaf["kernel"]).T.contiguous()
            sd[f"{mlp}.layers.{i}.bias"] = torch.as_tensor(leaf["bias"])
    sd["dec_out.weight"] = torch.as_tensor(p["dec_out"]["kernel"]).T.contiguous()
    sd["dec_out.bias"] = torch.as_tensor(p["dec_out"]["bias"])
    return sd
