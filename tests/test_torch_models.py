"""The port's checkpoint loader, running-mean-std normalizer and actor-critic
against the reference's flax model on the banked r2b teacher."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.models.actor_critic import ActorCriticSplit as JaxActorCritic
from isaacgyminsertion_tpu.models.running_mean_std import rms_normalize as j_rms_normalize
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch.models.actor_critic import (
    ActorCriticSplit,
    actor_critic_from_jax_params,
    convert_jax_params,
)
from isaacgyminsertion_tpu_torch.models.running_mean_std import RMSState, rms_normalize, rms_to
from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "teacher_r2b", "best_success")


def test_checkpoint_loader_maps_rms_state_without_the_reference():
    tree = restore_path(CKPT)
    ref = j_restore(CKPT)
    assert isinstance(tree["obs_rms"], RMSState) and isinstance(tree["priv_rms"], RMSState)
    for key in ("obs_rms", "priv_rms", "value_rms"):
        for a, b in zip(tree[key], ref[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    k = tree["params"]["params"]["actor_mlp"]["Dense_0"]["kernel"]
    assert k.shape == (23, 512)


def test_checkpoint_loader_refuses_foreign_globals(tmp_path):
    path = tmp_path / "bad.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"x": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError):
        restore_path(str(path))


def test_actor_critic_matches_flax_apply():
    """mu and value of the converted r2b params vs flax apply on the same
    normalized inputs (1e-5: fp32 matmuls of widths ≤ 512)."""
    ref = j_restore(CKPT)
    tree = restore_path(CKPT)
    net = actor_critic_from_jax_params(tree["params"], "cpu")
    assert isinstance(net, ActorCriticSplit)
    sd = convert_jax_params(tree["params"])
    assert sd["actor_mlp.layers.0.weight"].shape == (512, 23)   # flax [in, out] → torch [out, in]
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, 15)).astype(np.float32)
    priv = rng.normal(size=(64, 64)).astype(np.float32) * 3.0
    o_j = j_rms_normalize(ref["obs_rms"], jnp.asarray(obs))
    p_j = j_rms_normalize(ref["priv_rms"], jnp.asarray(priv))
    o_t = rms_normalize(rms_to(tree["obs_rms"], "cpu"), torch.as_tensor(obs))
    p_t = rms_normalize(rms_to(tree["priv_rms"], "cpu"), torch.as_tensor(priv))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6, atol=1e-6)
    assert float(p_t.abs().max()) <= 5.0   # normalized inputs are clipped at ±5
    mu_j, log_std_j, v_j, lat_j, _ = JaxActorCritic().apply(ref["params"], o_j, p_j)
    with torch.no_grad():
        mu_t, log_std_t, v_t, lat_t, extras_t = net(o_t, p_t)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), rtol=1e-5, atol=1e-5)
    assert extras_t == {}   # no contact autoencoder in r2b
    np.testing.assert_array_equal(log_std_t.detach().numpy(), np.asarray(log_std_j))
