"""ExtrinsicAdapt, the serving half: a trained student drives the env.

Port of the inference path of `isaacgyminsertion_tpu/algo/ext_adapt.py`: the
student's input preprocessing (seg → {plug, socket} masks, depth masked to
plug|socket pixels, per-point cloud normalizer, student-obs normalizer) and
the student forward, either a 6-dim tanh action head (`only_bc`) or an 8-dim
latent injected into the frozen teacher actor. The DAgger training epoch and
its replay reservoirs are not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..envs import insertion
from ..models.actor_critic import ActorCriticSplit
from ..models.running_mean_std import RMSState, rms_normalize
from ..models.student import MultiModalModel
from ..sensors.camera import SEG_PLUG, SEG_SOCKET


@dataclass(frozen=True)
class DAggerConfig:
    """The reference's DAgger settings. The serving half reads `only_bc` and
    the modality flags; the rest is kept so recipes carry over unchanged."""

    horizon: int = 64
    mini_epochs: int = 8
    learning_rate: float = 3.0e-4
    grad_norm: float = 0.5
    teacher_only_steps: float = 1.0e6
    beta_anneal_steps: float = 3.0e6
    latent_loss_coef: float = 0.0
    action_z_weight: float = 0.1
    only_bc: bool = False
    # modality flags (train cfg ppo.{obs,tactile,img,seg,pcl}_info)
    use_obs: bool = True
    use_tactile: bool = False
    use_img: bool = False
    use_seg: bool = False
    use_pcl: bool = False
    # triage-only control: also feed the normalized privileged vector
    use_priv: bool = False
    replay_size: int = 0
    replay_mode: str = "device_split"
    replay_stratify: bool = False
    replay_freeze_beta: float = 0.5

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class TeacherBundle(NamedTuple):
    net: ActorCriticSplit
    obs_rms: RMSState
    priv_rms: RMSState


class StudentBundle(NamedTuple):
    net: MultiModalModel
    stud_obs_rms: RMSState
    pcl_rms: RMSState       # per-point xyz normalizer


def _seg_masks(seg: torch.Tensor) -> torch.Tensor:
    """{plug, socket} binary masks stacked as channels [..., H, W, 2]."""
    return torch.stack([(seg == SEG_PLUG).float(), (seg == SEG_SOCKET).float()], dim=-1)


def _student_inputs(da_cfg: DAggerConfig, state: StudentBundle, out_obs, out, teacher=None) -> dict:
    """Normalize / preprocess the modalities into the student's input dict."""
    inp = {}
    if da_cfg.use_obs:
        obs_in = rms_normalize(state.stud_obs_rms, out_obs)
        if da_cfg.use_priv and out.priv_info is not None and teacher is not None:
            obs_in = torch.cat([obs_in, rms_normalize(teacher.priv_rms, out.priv_info)], dim=-1)
        inp["obs"] = obs_in
    if da_cfg.use_tactile:
        inp["tactile"] = out.tactile
    if da_cfg.use_img:
        img = out.img
        if da_cfg.use_seg:
            # the depth image is masked to plug|socket pixels when seg is available
            img = img * ((out.seg == SEG_PLUG) | (out.seg == SEG_SOCKET)).to(img.dtype)
        inp["img"] = img
    if da_cfg.use_seg:
        inp["seg"] = _seg_masks(out.seg[:, -1])[:, None]
    if da_cfg.use_pcl:
        p = out.pcl[:, -1] if out.pcl.ndim == 4 else out.pcl
        inp["pcl"] = rms_normalize(state.pcl_rms, p)
    return inp


def make_student_act(cfg_task, da_cfg: DAggerConfig, teacher: TeacherBundle):
    """Student forward: modalities → 6-dim action (`only_bc`), or → latent →
    frozen-actor action with the student's latent injected.

    Returns `student_act(student: StudentBundle, obs_n, out) → (action, pred)`."""

    def student_act(student: StudentBundle, obs_n, out):
        pred = student.net(**_student_inputs(da_cfg, student, obs_n, out, teacher=teacher))
        if da_cfg.only_bc:
            return pred, pred
        # the priv input is a placeholder: the injected latent overrides it
        o = rms_normalize(teacher.obs_rms, obs_n)
        zeros_priv = torch.zeros(obs_n.shape[:-1] + (cfg_task.env.num_states,), dtype=obs_n.dtype,
                                 device=obs_n.device)
        mu = teacher.net(o, zeros_priv, latent=pred)[0]
        return torch.clamp(mu, -1.0, 1.0), pred

    return student_act


def _prev_out_of(env_state: insertion.EnvState, cfg_task) -> insertion.StepOutput:
    """The env-state queues as a StepOutput for the CURRENT state (the student
    acts on the modalities produced by the previous step)."""
    obs = env_state.obs_queue
    return insertion.StepOutput(
        obs=obs, student_obs=env_state.obs_stud_queue, priv_info=None,
        rew=torch.zeros(obs.shape[0], device=obs.device), reset=env_state.reset_buf,
        timeout=env_state.timeout_reset_buf, extras={},
        tactile=env_state.tactile_queue.float(), img=env_state.img_queue.float(),
        seg=env_state.seg_queue.float(), pcl=env_state.pcl_queue,
        contacts=env_state.contact_queue)
