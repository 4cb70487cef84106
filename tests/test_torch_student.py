"""The student model, port vs JAX reference on the same numpy inputs.

Every encoder and the whole `MultiModalModel` (student_r5's and student_r3's
configurations) run on freshly initialised flax parameters converted with
`convert_flax_params`, and on both banked checkpoints. Tolerance 1e-5 absolute
and relative: fp32 convolutions and matrix products summed in another order
(inputs and activations are O(1))."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.algo.ext_adapt import DAggerConfig as JDAggerConfig
from isaacgyminsertion_tpu.models import student as j_st
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch.algo.ext_adapt import DAggerConfig
from isaacgyminsertion_tpu_torch.envs.config import EnvConfig
from isaacgyminsertion_tpu_torch.models import student as t_st
from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

torch.set_num_threads(1)

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
R5 = dict(use_obs=True, use_pcl=True, only_bc=True)
R3 = dict(use_obs=True, use_tactile=True, use_seg=True, use_pcl=True, only_bc=False)


def _close(j, t, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-5, atol=1e-5, err_msg=what)


def _load(module, params):
    module.load_state_dict(t_st.convert_flax_params(jax.device_get(params)))
    return module.eval()


def _inputs(rng, b, tactile=False, seg=False, pcl=True, n_pcl=800):
    inp = {"obs": rng.normal(size=(b, 15)).astype(np.float32)}
    if tactile:
        inp["tactile"] = rng.uniform(0, 1, (b, 1, 3, 64, 64, 3)).astype(np.float32)
    if seg:
        inp["seg"] = (rng.uniform(size=(b, 1, 54, 96, 2)) > 0.7).astype(np.float32)
    if pcl:
        inp["pcl"] = rng.normal(size=(b, n_pcl, 3)).astype(np.float32)
    return inp


@pytest.mark.parametrize("name", ["spatial_softargmax", "tactile_cnn", "efficient_tactile", "mbconv",
                                  "depth_cnn_1ch", "depth_cnn_2ch", "pointnet", "decoder"])
def test_module_matches_on_fresh_flax_params(name):
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    f32 = lambda a: np.asarray(a, np.float32)
    if name == "spatial_softargmax":
        x = f32(rng.normal(size=(2, 8, 8, 5)) * 3)
        j = j_st.SpatialSoftArgmax().apply({}, jnp.asarray(x))
        t = t_st.SpatialSoftArgmax()(torch.as_tensor(x).permute(0, 3, 1, 2))
        return _close(j, t)
    if name in ("tactile_cnn", "efficient_tactile"):
        x = f32(rng.uniform(0, 1, (2, 3, 64, 64, 3)))
        j_mod = j_st.TactileCNN() if name == "tactile_cnn" else j_st.EfficientTactileEncoder()
        t_mod = t_st.TactileCNN(9) if name == "tactile_cnn" else t_st.EfficientTactileEncoder(9)
    elif name == "mbconv":
        # NHWC in the reference, NCHW in the port; stride 2 on an even size pads (0, 1)
        x = f32(rng.normal(size=(2, 8, 8, 16)))
        params = j_st.MBConv(24, stride=2).init(key, jnp.asarray(x))
        j = j_st.MBConv(24, stride=2).apply(params, jnp.asarray(x))
        t = _load(t_st.MBConv(16, 24, stride=2), params)(torch.as_tensor(x).permute(0, 3, 1, 2))
        return _close(j, t.permute(0, 2, 3, 1))
    elif name.startswith("depth_cnn"):
        ch = 1 if name.endswith("1ch") else 2
        x = f32(rng.uniform(-1, 0, (2, 54, 96))) if ch == 1 else f32(rng.uniform(0, 1, (2, 54, 96, 2)))
        j_mod, t_mod = j_st.DepthCNN(), t_st.DepthCNN(ch)
    elif name == "pointnet":
        x = f32(rng.normal(size=(2, 400, 3)))
        j_mod, t_mod = j_st.PointNet(), t_st.PointNet()
    else:
        x = f32(rng.normal(size=(2, 4, 64)))
        j_mod, t_mod = j_st.MultiLayerDecoder(), t_st.MultiLayerDecoder(4)
    params = j_mod.init(key, jnp.asarray(x))
    if name == "decoder":
        # flax initialises biases and LayerNorm offsets to 0: randomise them so they are tested
        leaves, tree = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
        params = jax.tree_util.tree_unflatten(
            tree, [a + 0.1 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
    _close(j_mod.apply(params, jnp.asarray(x)), _load(t_mod, params)(torch.as_tensor(x)), name)


def _models(flags, tactile_encoder="cnn"):
    kw = {k: v for k, v in flags.items() if k != "only_bc"}
    j_model = j_st.MultiModalModel(latent_dim=6 if flags["only_bc"] else 8, bc_mode=flags["only_bc"],
                                   num_points_goal=0, tactile_encoder=tactile_encoder, **kw)
    return j_model, DAggerConfig(**flags)


@pytest.mark.parametrize("flags,encoder", [(R5, "cnn"), (R3, "cnn"), (R3, "efficientnet")],
                         ids=["r5", "r3", "r3_efficientnet"])
def test_multimodal_model_matches_on_fresh_flax_params(flags, encoder):
    rng = np.random.default_rng(1)
    inp = _inputs(rng, 3, tactile=flags.get("use_tactile", False), seg=flags.get("use_seg", False))
    j_model, da_cfg = _models(flags, encoder)
    params = j_model.init(jax.random.PRNGKey(2), **{k: jnp.asarray(v) for k, v in inp.items()})
    j_out = j_model.apply(params, **{k: jnp.asarray(v) for k, v in inp.items()})
    net = t_st.student_from_jax_params(jax.device_get(params), da_cfg, EnvConfig(), "cpu")
    # the converter round-trips: every flax leaf lands in the state dict, and nothing else is there
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(net.state_dict()) == n_leaves
    with torch.no_grad():
        t_out = net(**{k: torch.as_tensor(v) for k, v in inp.items()})
    assert tuple(t_out.shape) == (3, 6 if flags["only_bc"] else 8)
    _close(j_out, t_out)


@pytest.mark.parametrize("name,flags", [("student_r5", R5), ("student_r3", R3)])
def test_banked_student_matches(name, flags):
    path = os.path.join(CKPTS, name, "best_success")
    j_tree, t_tree = j_restore(path), restore_path(path)
    rng = np.random.default_rng(3)
    inp = _inputs(rng, 4, tactile=flags.get("use_tactile", False), seg=flags.get("use_seg", False))
    j_model, da_cfg = _models(flags)
    j_out = j_model.apply(j_tree["student_params"], **{k: jnp.asarray(v) for k, v in inp.items()})
    net = t_st.student_from_jax_params(t_tree["student_params"], da_cfg, EnvConfig(), "cpu")
    with torch.no_grad():
        t_out = net(**{k: torch.as_tensor(v) for k, v in inp.items()})
    assert float(np.abs(np.asarray(j_out)).max()) > 1e-3
    _close(j_out, t_out, name)
    # the loader hands the normalizers over as the port's RMSState
    assert type(t_tree["stud_obs_rms"]).__module__.startswith("isaacgyminsertion_tpu_torch")
    np.testing.assert_array_equal(np.asarray(t_tree["pcl_rms"].mean), np.asarray(j_tree["pcl_rms"].mean))
    assert np.asarray(t_tree["stud_obs_rms"].mean).shape == (15,)
    assert JDAggerConfig(**flags).only_bc == da_cfg.only_bc


def test_same_padding_follows_xla():
    """Stride 2 on an even size pads (0, 1); on an odd size (1, 1); stride 1 (1, 1)."""
    ones = lambda h, w: torch.ones((1, 1, h, w))
    pad = lambda x, s: t_st._same_pad(x, 3, s)
    assert tuple(pad(ones(64, 64), 2).shape[-2:]) == (65, 65)
    assert float(pad(ones(64, 64), 2)[0, 0, 0, 0]) == 1.0 and float(pad(ones(64, 64), 2)[0, 0, -1, -1]) == 0.0
    p = pad(ones(27, 48), 2)
    assert tuple(p.shape[-2:]) == (29, 49)
    assert float(p[0, 0, 0, 5]) == 0.0 and float(p[0, 0, -1, 5]) == 0.0     # H odd: (1, 1)
    assert float(p[0, 0, 5, 0]) == 1.0 and float(p[0, 0, 5, -1]) == 0.0     # W even: (0, 1)
    assert tuple(pad(ones(7, 7), 1).shape[-2:]) == (9, 9)
