"""ExtrinsicAdapt: stage-2 student distillation by online DAgger, and the
student driving the env.

Port of `isaacgyminsertion_tpu/algo/ext_adapt.py`. The serving half is the
student's input preprocessing (seg → {plug, socket} masks, depth masked to
plug|socket pixels, per-point cloud normalizer, student-obs normalizer) and
its forward, either a 6-dim tanh action head (`only_bc`) or an 8-dim latent
injected into the frozen teacher actor. The training half is one DAgger
epoch (`TrainEpoch`):
  - a rollout of `horizon` control steps in which each env executes the
    teacher's action with probability β = clip(1 − agent_steps /
    beta_anneal_steps, 0, 1) and the student's otherwise (one Bernoulli(β)
    per env and step), with a teacher-only window below `teacher_only_steps`
    when tactile is off; each step stores a labeled sample (the student's
    inputs, the teacher's action and latent);
  - the student-obs and point-cloud normalizer updates;
  - optionally an Algorithm-R reservoir of `replay_size` samples
    (`Reservoir`), uniform or stratified into a frozen teacher-era half and a
    rolling half;
  - `mini_epochs` passes of `B // mini_epochs`-row minibatches, each an Adam
    step behind a clip by global norm on the action MSE (z axis weighted by
    `action_z_weight`) plus, when the student predicts a latent, the latent
    MSE (`latent_loss_coef`).
The reference runs its reservoir as three jits (`replay_mode="device_split"`)
or inside one (`"in_graph"`) to work around XLA buffer donation; eager
PyTorch needs neither, so both names select the same reservoir. Randomness
comes from explicit generators, and an epoch also takes its mix coins,
reservoir draws and minibatch rows from the caller.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..envs import insertion
from ..envs.config import TaskConfig
from ..models.actor_critic import ActorCriticSplit
from ..models.running_mean_std import RMSState, rms_init, rms_normalize, rms_update
from ..models.student import MultiModalModel, decoder_only_mask, init_student_like_flax
from ..sensors.camera import SEG_PLUG, SEG_SOCKET
from ..utils import profiling
from .ppo import _sync, clip_by_global_norm_, make_optimizer


@dataclass(frozen=True)
class DAggerConfig:
    """The reference's DAgger settings (`replay_mode` is accepted for the
    reference's recipes: both of its values run the same reservoir)."""

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


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #

FRAME_KEYS = ("tactile", "img", "seg", "pcl")   # stored float16 in the reservoir
REPLAY_MODES = ("device_split", "in_graph")


class DAggerState(NamedTuple):
    net: MultiModalModel           # the student's parameters (updated in place)
    optimizer: torch.optim.Adam    # over the trainable parameters only
    stud_obs_rms: RMSState
    pcl_rms: RMSState              # per-point xyz normalizer
    env_state: insertion.EnvState
    env_gen: torch.Generator       # the env's resets and DR
    train_gen: torch.Generator     # mix coins, reservoir slots, minibatch rows
    epoch: int
    agent_steps: int               # exact (the reference keeps an f32)

    def student(self) -> StudentBundle:
        return StudentBundle(self.net, self.stud_obs_rms, self.pcl_rms)


def _sample_modalities(da_cfg: DAggerConfig, env_state: insertion.EnvState) -> dict:
    """The sensor frames of one stored sample, as the env queues hold them,
    with every modality the student does not read replaced by an [N, 0]
    placeholder. `seg` is kept when either `use_seg` or `use_img` is on (the
    depth image is seg-masked)."""
    empty = torch.zeros((env_state.obs_queue.shape[0], 0), device=env_state.obs_queue.device)
    return dict(
        tactile=env_state.tactile_queue if da_cfg.use_tactile else empty,
        img=env_state.img_queue if da_cfg.use_img else empty,
        seg=env_state.seg_queue if (da_cfg.use_seg or da_cfg.use_img) else empty,
        pcl=env_state.pcl_queue if da_cfg.use_pcl else empty,
    )


def _make_student(cfg_task: TaskConfig, da_cfg: DAggerConfig) -> MultiModalModel:
    """The reference's `MultiModalModel` for `da_cfg`'s modalities, with the
    widths flax infers from the first input written out."""
    e = cfg_task.env
    obs_dim = e.num_obs_stud_hist * e.num_obs_student + (e.num_states if da_cfg.use_priv else 0)
    num_tokens = (int(da_cfg.use_obs) + e.tactile_history_len * int(da_cfg.use_tactile)
                  + e.img_history_len * int(da_cfg.use_img) + int(da_cfg.use_seg) + int(da_cfg.use_pcl))
    return MultiModalModel(
        use_obs=da_cfg.use_obs, use_tactile=da_cfg.use_tactile, use_img=da_cfg.use_img,
        use_seg=da_cfg.use_seg, use_pcl=da_cfg.use_pcl,
        latent_dim=6 if da_cfg.only_bc else 8, bc_mode=da_cfg.only_bc,
        num_points=e.num_points if e.include_plug_pcl else 0,
        num_points_socket=e.num_points_socket if e.merge_socket_pcl else 0,
        num_points_goal=e.num_points_goal if e.merge_goal_pcl else 0,
        obs_dim=obs_dim, num_tokens=num_tokens)


def build(cfg_task: TaskConfig, da_cfg: DAggerConfig, model, subs, n_envs: int,
          teacher: TeacherBundle, seed: int, phase3: bool = False, device=None, gan=None):
    """A fresh student (flax's default init), its optimizer, the initial
    DAggerState and the epoch → (state, train_epoch). With `phase3` only the
    decoder and the latent head train: the other parameters get no gradient
    and no optimizer state, and the gradient clip covers the trainable ones
    only (the reference's `optax.multi_transform`). `gan`, a CycleGAN
    `ResnetGenerator`, translates the rollout's tactile frames sim → real."""
    if da_cfg.replay_mode not in REPLAY_MODES:
        raise ValueError(f"replay_mode {da_cfg.replay_mode!r} is not one of {REPLAY_MODES}")
    dev = resolve_device(device)
    net = init_student_like_flax(_make_student(cfg_task, da_cfg), torch.Generator().manual_seed(int(seed) + 1))
    net = net.to(dev)
    env_gen = insertion.make_generator(seed, dev)
    with torch.no_grad():
        env_state = insertion.reset_all(cfg_task, model, subs, env_gen, n_envs)
    e = cfg_task.env
    state = DAggerState(
        net=net, optimizer=student_optimizer(net, da_cfg, phase3),
        stud_obs_rms=rms_init((e.num_obs_hist * e.num_observations,), dev),
        pcl_rms=rms_init((3,), dev), env_state=env_state, env_gen=env_gen,
        train_gen=insertion.make_generator(int(seed) + 2, dev), epoch=0, agent_steps=0)
    return state, TrainEpoch(cfg_task, da_cfg, model, subs, teacher, gan=gan)


def student_optimizer(net: MultiModalModel, da_cfg: DAggerConfig, phase3: bool = False):
    """Adam (no weight decay) over the trainable parameters: all of them, or
    with `phase3` the decoder's and the latent head's, the others set to
    need no gradient."""
    if phase3:
        mask = decoder_only_mask(net)
        for name, p in net.named_parameters():
            p.requires_grad_(mask[name])
    return make_optimizer([p for p in net.parameters() if p.requires_grad], da_cfg.learning_rate)


def reservoir_slots(cursor: int, u: torch.Tensor, cap: int) -> torch.Tensor:
    """Algorithm R's slot for each of B samples whose global indices are
    g = cursor … cursor + B − 1: g itself while g < cap, else
    r = int32(u · float32(g + 1)) when r < cap, else `cap` (dropped). The
    product is taken in float32 as the reference takes it (above 2²⁴ the
    float32 of g + 1 rounds)."""
    g = cursor + torch.arange(u.shape[0], device=u.device)
    r = (u * (g + 1).to(torch.float32)).to(torch.int32).long()
    return torch.where(g < cap, g, torch.where(r < cap, r, torch.full_like(g, cap)))


def _last_per_slot(slot: torch.Tensor, cap: int):
    """→ (slots, batch rows): each slot drawn by several samples goes to the
    last of them in batch order (as the reference's scatter writes on the
    CPU), dropped samples left out; the slots come out unique, so the write
    does not depend on the device's order of updates."""
    s, order = torch.sort(slot, stable=True)
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    keep = last & (s < cap)
    return s[keep], order[keep]


class Reservoir:
    """DAgger aggregation (Ross et al.): an Algorithm-R reservoir of
    `capacity` labeled samples, allocated on the device at the first write
    and written in place.

    Uniform: one reservoir over every sample seen. Stratified: the first
    half (A, `capacity // 2` rows) collects while the host β, computed from
    the cursor before this epoch's write, is ≥ `freeze_beta`, then freezes
    for good; the second half (B) keeps rolling over everything, and each
    minibatch draws `mb_size // 2` rows from A and the rest from B. Frame
    fields are stored float16 and read back as float32."""

    def __init__(self, capacity: int, stratify: bool = False, freeze_beta: float = 0.5,
                 beta_anneal_steps: float = 3.0e6):
        self.k_a = capacity // 2 if stratify else 0
        self.k_b = capacity - self.k_a
        self.stratify, self.freeze_beta, self.beta_anneal_steps = stratify, freeze_beta, beta_anneal_steps
        self.rows: dict | None = None
        self.cursor = 0        # samples seen (reservoir B)
        self.cursor_a = 0      # teacher-era samples captured (reservoir A)
        self.a_frozen = False

    @property
    def fill_b(self) -> int:
        return min(self.cursor, self.k_b)

    @property
    def fill_a(self) -> int:
        return min(max(self.cursor_a, 1), self.k_a)

    def _alloc(self, batch: dict):
        """One buffer per key, [capacity, ...]; each key filled with its own
        small value, as the reference fills them (rows are drawn below the
        fill count, so only an empty A's first row is ever read unwritten).
        The frame buffers' bytes go to the counter
        `dagger.reservoir_frame_bytes`."""
        k = self.k_a + self.k_b
        self.rows = {}
        for i, (key, v) in enumerate(batch.items()):
            dtype = torch.float16 if key in FRAME_KEYS and v.dtype == torch.float32 else v.dtype
            self.rows[key] = torch.full((k,) + tuple(v.shape[1:]), (i + 1) * 1e-6, dtype=dtype,
                                        device=v.device)
        profiling.count("dagger.reservoir_frame_bytes", sum(buf.nbytes for key, buf in self.rows.items()
                                                            if key in FRAME_KEYS))

    def _scatter(self, batch: dict, offset: int, cap: int, cursor: int, u: torch.Tensor):
        slots, rows = _last_per_slot(reservoir_slots(cursor, u, cap), cap)
        for key, buf in self.rows.items():
            buf[offset + slots] = batch[key][rows].to(buf.dtype)

    def write(self, batch: dict, u: torch.Tensor, u_a: torch.Tensor | None = None):
        """One epoch's flattened [B, ...] batch; `u` ([B] uniforms) places it
        in B, `u_a` in A."""
        if self.rows is None:
            self._alloc(batch)
        n = next(iter(batch.values())).shape[0]
        if self.stratify:
            beta = max(0.0, 1.0 - self.cursor / self.beta_anneal_steps)
            if beta >= self.freeze_beta and not self.a_frozen:
                self._scatter(batch, 0, self.k_a, self.cursor_a, u_a)
                self.cursor_a += n
            else:
                self.a_frozen = True
        self._scatter(batch, self.k_a, self.k_b, self.cursor, u)
        self.cursor += n

    def draw_rows(self, n_mb: int, mb_size: int, gen: torch.Generator) -> torch.Tensor:
        """[n_mb, mb_size] row indices: uniform below the fill count (A's
        rows first, then B's, in the stratified reservoir)."""
        dev = gen.device
        mb_a = mb_size // 2 if self.stratify else 0
        b = torch.randint(0, max(self.fill_b, 1), (n_mb, mb_size - mb_a), generator=gen, device=dev)
        if not self.stratify:
            return b
        a = torch.randint(0, max(self.fill_a, 1), (n_mb, mb_a), generator=gen, device=dev)
        return torch.cat([a, self.k_a + b], dim=1)


class TrainEpoch:
    """One DAgger epoch: `train_epoch(state, mix=None, res_u=None,
    res_u_a=None, rows=None)` → (state', metrics). `mix` holds the [N, 1]
    uniforms of each rollout step (an env executes the teacher's action where
    its uniform is below β), `res_u` and `res_u_a` the [B] uniforms of the
    reservoir writes (B and A), and `rows` the [n_mb, mb_size] minibatch rows
    of each mini-epoch, into the epoch's batch without a reservoir (a
    permutation's first n_mb · mb_size) or into the reservoir (A's rows
    before B's, offset by A's size); where they are not given they come from
    `state.train_gen`. The phases (`rollout`, `normalizers`, `scatter`,
    `update`) are methods so that a profiler can take them apart; each is a
    `profiling.span` closed by a device synchronize, and the metrics hold
    every span's host seconds over the epoch as `time/<span>_s`."""

    def __init__(self, cfg_task: TaskConfig, da_cfg: DAggerConfig, model, subs, teacher: TeacherBundle,
                 gan=None):
        self.cfg_task, self.da_cfg, self.model, self.subs = cfg_task, da_cfg, model, subs
        self.teacher = teacher
        self.gan = gan   # the CycleGAN generator on the rollout's tactile frames, or None
        self.student_act = make_student_act(cfg_task, da_cfg, teacher)
        self.reservoir = Reservoir(da_cfg.replay_size, da_cfg.replay_stratify, da_cfg.replay_freeze_beta,
                                   da_cfg.beta_anneal_steps) if da_cfg.replay_size > 0 else None

    def beta(self, agent_steps: int) -> float:
        """β = clip(1 − agent_steps / beta_anneal_steps, 0, 1), in float32."""
        b = np.float32(1.0) - np.float32(agent_steps) / np.float32(self.da_cfg.beta_anneal_steps)
        return float(np.clip(b, np.float32(0.0), np.float32(1.0)))

    # ------------------------------------------------------------ rollout
    @torch.no_grad()
    def teacher_act(self, obs, priv):
        t = self.teacher
        mu, _, _, latent_gt, _ = t.net(rms_normalize(t.obs_rms, obs), rms_normalize(t.priv_rms, priv))
        return torch.clamp(mu, -1.0, 1.0), latent_gt

    @torch.no_grad()
    def rollout_step(self, state: DAggerState, env_state, agent_steps: int, mix_u=None):
        """One control step with the β-mixed action → (env_state', sample,
        per-step metrics [reward, success], β)."""
        c = self.da_cfg
        obs, stud_obs = env_state.obs_queue, env_state.obs_stud_queue
        priv = insertion.priv_info_of(self.cfg_task, self.model, env_state)
        with profiling.span("rollout.policy"):
            with profiling.span("rollout.policy.teacher"):
                t_actions, latent_gt = self.teacher_act(obs, priv)
            with profiling.span("rollout.policy.student"):
                prev_out = _prev_out_of(env_state, self.cfg_task)._replace(priv_info=priv)
                s_actions, _ = self.student_act(state.student(), stud_obs, prev_out)
        beta = self.beta(agent_steps)
        if not c.use_tactile and agent_steps < c.teacher_only_steps:
            mixed = t_actions          # the teacher-only window
        else:
            if mix_u is None:
                mix_u = torch.rand((obs.shape[0], 1), generator=state.train_gen, device=obs.device)
            mixed = torch.where(mix_u < beta, t_actions, s_actions)
        sample = dict(obs=obs, student_obs=stud_obs, t_actions=t_actions, latent_gt=latent_gt,
                      **_sample_modalities(c, env_state))
        if c.use_priv:
            sample["priv"] = priv
        env_state, out = insertion.step(self.cfg_task, self.model, self.subs, env_state, mixed,
                                        state.env_gen, gan=self.gan)
        return env_state, sample, torch.stack([out.rew.mean(), out.extras["successes"].mean()]), beta

    def rollout(self, state: DAggerState, mix=None):
        """`horizon` steps → (env_state, trajectory {key: [T, N, ...]}, step
        metrics [T, 2], the β of each step)."""
        env_state, samples, ms, betas = state.env_state, [], [], []
        n = env_state.obs_queue.shape[0]
        for t in range(self.da_cfg.horizon):
            env_state, sample, m, beta = self.rollout_step(
                state, env_state, state.agent_steps + t * n, None if mix is None else mix[t])
            samples.append(sample)
            ms.append(m)
            betas.append(beta)
        traj = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
        return env_state, traj, torch.stack(ms), betas

    @torch.no_grad()
    def normalizers(self, state: DAggerState, traj: dict):
        """→ (stud_obs_rms, pcl_rms) updated with the epoch's samples; the
        cloud's normalizer sees every point of the horizon."""
        stud_obs_rms = rms_update(state.stud_obs_rms, traj["student_obs"])
        pcl_rms = state.pcl_rms
        if self.da_cfg.use_pcl and traj["pcl"].numel():
            pcl_rms = rms_update(state.pcl_rms, traj["pcl"].reshape(-1, 3))
        return stud_obs_rms, pcl_rms

    @torch.no_grad()
    def scatter(self, batch: dict, res_u=None, res_u_a=None, gen=None):
        """The reservoir write of the flattened batch."""
        n, dev = batch["obs"].shape[0], batch["obs"].device
        draw = lambda: torch.rand((n,), generator=gen, device=dev)
        self.reservoir.write(batch, draw() if res_u is None else res_u,
                             (draw() if res_u_a is None else res_u_a) if self.reservoir.stratify else None)

    # ------------------------------------------------------------ update
    def loss(self, student: StudentBundle, mb: dict):
        """The distillation loss of one minibatch → (loss, aux dict of scalars)."""
        c = self.da_cfg
        out_like = insertion.StepOutput(
            obs=mb["obs"], student_obs=mb["student_obs"], priv_info=mb.get("priv"), rew=None,
            reset=None, timeout=None, extras={}, tactile=mb["tactile"], img=mb["img"], seg=mb["seg"],
            pcl=mb["pcl"], contacts=None)
        s_actions, s_latent = self.student_act(student, mb["student_obs"], out_like)
        w = torch.ones((s_actions.shape[-1],), device=s_actions.device)
        w[2] = c.action_z_weight
        action_loss = torch.mean(w * torch.square(s_actions - mb["t_actions"]))
        loss, latent_loss = action_loss, torch.zeros((), device=action_loss.device)
        if not c.only_bc and c.latent_loss_coef > 0:
            latent_loss = torch.mean(torch.square(s_latent - mb["latent_gt"]))
            loss = loss + c.latent_loss_coef * latent_loss
        return loss, {"action_loss": action_loss, "latent_loss": latent_loss}

    def minibatch_shape(self, n_rows: int):
        """(mb_size, n_mb) for a batch of `n_rows`: minibatches of
        B // mini_epochs rows, as the reference sizes them."""
        mb_size = max(n_rows // self.da_cfg.mini_epochs, 1)
        return mb_size, n_rows // mb_size

    def update(self, student: StudentBundle, optimizer, source: dict, n_rows: int, gen,
               rows=None) -> dict:
        """`mini_epochs` passes of `n_mb` Adam steps on minibatches gathered
        from `source` (the batch or the reservoir) → the losses, averaged per
        mini-epoch, then over them."""
        mb_size, n_mb = self.minibatch_shape(n_rows)
        params = optimizer.param_groups[0]["params"]
        dev = source["obs"].device
        per_epoch = []
        for k in range(self.da_cfg.mini_epochs):
            if rows is not None:
                idx = rows[k]
            elif self.reservoir is None:
                idx = torch.randperm(n_rows, generator=gen, device=dev)
            else:
                idx = self.reservoir.draw_rows(n_mb, mb_size, gen)
            idx = idx.reshape(-1)[: n_mb * mb_size].reshape(n_mb, mb_size)
            out = []
            for i in range(n_mb):
                with profiling.span("update.adam_step"):
                    mb = {key: v[idx[i]].float() if v.dtype == torch.float16 else v[idx[i]]
                          for key, v in source.items()}
                    loss, aux = self.loss(student, mb)
                    optimizer.zero_grad(set_to_none=False)
                    loss.backward()
                    clip_by_global_norm_(params, self.da_cfg.grad_norm)
                    optimizer.step()
                aux["loss"] = loss
                out.append(torch.stack([v.detach() for v in aux.values()]))
            per_epoch.append(torch.stack(out).mean(0))
        return dict(zip(aux.keys(), torch.stack(per_epoch).mean(0)))

    # ------------------------------------------------------------ epoch
    def _phase(self, name: str, dev, fn, *args, **kw):
        """fn(*args) in the span `name`, closed by a device synchronize."""
        with profiling.span(name):
            out = fn(*args, **kw)
            _sync(dev)
        return out

    def __call__(self, state: DAggerState, mix=None, res_u=None, res_u_a=None, rows=None):
        dev = state.stud_obs_rms.mean.device
        before = profiling.spans()
        env_state, traj, roll, betas = self._phase("rollout", dev, self.rollout, state, mix)
        stud_obs_rms, pcl_rms = self._phase("normalizers", dev, self.normalizers, state, traj)
        n_rows = traj["obs"].shape[0] * traj["obs"].shape[1]
        batch = {k: v.reshape((n_rows,) + tuple(v.shape[2:])) for k, v in traj.items()}
        source = batch
        if self.reservoir is not None:
            self._phase("scatter", dev, self.scatter, batch, res_u, res_u_a, state.train_gen)
            source = self.reservoir.rows
        student = StudentBundle(state.net, stud_obs_rms, pcl_rms)
        aux = self._phase("update", dev, self.update, student, state.optimizer, source, n_rows,
                          state.train_gen, rows)
        roll = roll.mean(0)
        metrics = {**aux, "episode/reward": roll[0], "episode/success": roll[1]}
        names = list(metrics)
        metrics = dict(zip(names, torch.stack([metrics[k].float() for k in names]).tolist()))
        metrics["episode/beta"] = float(np.mean(np.asarray(betas, np.float32)))
        for name, seconds in profiling.spans_since(before).items():
            metrics[f"time/{name}_s"] = seconds
        return state._replace(stud_obs_rms=stud_obs_rms, pcl_rms=pcl_rms, env_state=env_state,
                              epoch=state.epoch + 1, agent_steps=state.agent_steps + n_rows), metrics
