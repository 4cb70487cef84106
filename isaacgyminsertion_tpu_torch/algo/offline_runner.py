"""Offline student training from trajectory datasets — multimodal — and its
live-env replay evaluation.

Port of `isaacgyminsertion_tpu/algo/offline_runner.py` (the reference's
transformer/runner.py:150-304 + data.py:337-374): offline training of the
`MultiModalModel` over any subset of {obs, tactile, img, seg, pcl} from
collected trajectories, with latent / action losses, optional frozen-teacher
action regularization (runner.py:237-241), AdamW + warmup-cosine schedule,
and checkpointing. Validation batches come from a trajectory-level held-out
split (`data.dataset.split_trajectory_files`).

Preprocessing (host-side numpy, then one copy to the device per batch):
  - tactile differenced against trajectory frame 1 (data.py:337-347)
  - seg masked to {plug=2, socket=3} binary channels (ext_adapt.py:391-402)
  - img+seg synchronized random spatial jitter (the same `np.roll` shift for
    both, SyncRandomReshapeTransform parity)
  - pcl normalized by dataset xyz stats

The optimizer is what `optax.adamw(warmup_cosine_decay_schedule(0, lr,
warmup, max(total, warmup + 1)))` does: weight decay 1e-4 on every
parameter (torch's AdamW default is 1e-2), and the schedule evaluated at the
count of updates made BEFORE the step, so the first update has lr 0 and
changes nothing (its moments still count). `decay_steps` includes the
warmup. Checkpoints hold `student_params` in the flax layout, so the JAX
package loads them and `restore` loads its.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import DataNormalizer, TrajectoryDataset, split_trajectory_files
from ..models.actor_critic import actor_critic_from_jax_params
from ..models.running_mean_std import RMSState, rms_init, rms_normalize, rms_to
from ..models.student import (MultiModalModel, convert_flax_params, init_student_like_flax,
                              student_to_jax_params)
from ..sensors.camera import SEG_PLUG, SEG_SOCKET
from ..utils.checkpoint import Checkpointer, restore_path
from ..utils.metrics import MetricsWriter
from .ppo import set_lr

WEIGHT_DECAY = 1e-4   # optax.adamw's default


@dataclass(frozen=True)
class OfflineConfig:
    batch_size: int = 256
    epochs: int = 10
    learning_rate: float = 1.0e-4
    warmup_steps: int = 100
    action_z_weight: float = 0.1
    latent_loss_coef: float = 1.0
    action_reg_coef: float = 1.0     # frozen-teacher action regularization
    val_fraction: float = 0.1
    seq_len: int = 1
    only_bc: bool = False
    # modality flags (offline_config.yaml model dims / runner.py:86-95)
    use_obs: bool = True
    use_tactile: bool = False
    use_img: bool = False
    use_seg: bool = False
    use_pcl: bool = False
    tactile_diff: bool = True
    img_jitter: int = 3              # max sync spatial jitter (pixels)


def _seg_masks_np(seg: np.ndarray) -> np.ndarray:
    plug = (seg == SEG_PLUG).astype(np.float32)
    sock = (seg == SEG_SOCKET).astype(np.float32)
    return np.stack([plug, sock], axis=-1)  # [..., H, W, 2]


def warmup_cosine_lr(count: int, peak: float, warmup: int, decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps) at
    `count`: linear from 0 over `warmup` steps, then a cosine to 0 over the
    remaining `decay_steps - warmup`."""
    if count < warmup:
        return peak * count / warmup
    span = decay_steps - warmup
    return peak * 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, span) / span))


def pcl_slices(n_points: int, counts=(400, 400, 400)) -> tuple:
    """The (plug, socket, goal) slice sizes the reference's student takes
    from an [P, 3] cloud: each default slice that still fits, else 0 (its
    PointNet is never created)."""
    out, ofs = [], 0
    for c in counts:
        fits = c > 0 and ofs + c <= n_points
        out.append(c if fits else 0)
        ofs += c if fits else 0
    return tuple(out), n_points > ofs


class OfflineRunner:
    """runner.py:25 parity (offline_training path of train_supervised.py)."""

    def __init__(self, cfg: OfflineConfig, data_dir: str, out_dir: str,
                 obs_dim: int = 15, act_dim: int = 6, latent_dim: int = 8,
                 seed: int = 0, teacher_ckpt: str = "", device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.normalizer = DataNormalizer(data_dir)
        self.normalizer.run()
        keys = ["student_obs", "actions", "latent"]
        if teacher_ckpt:
            keys += ["obs", "priv_info"]
        if cfg.use_tactile:
            keys.append("tactile")
        if cfg.use_img:
            keys.append("img")
        if cfg.use_seg:
            keys.append("seg")
        if cfg.use_pcl:
            keys.append("pcl")
        train_files, val_files = split_trajectory_files(data_dir, cfg.val_fraction, seed=seed)
        mk = lambda files: TrajectoryDataset(
            data_dir, seq_len=cfg.seq_len, keys=tuple(keys),
            normalizer=self.normalizer, files=files,
            tactile_diff=cfg.tactile_diff and cfg.use_tactile,
        )
        self.dataset = mk(train_files)
        self.val_dataset = mk(val_files) if val_files else None

        self.student = init_student_like_flax(
            self._make_student(obs_dim, act_dim if cfg.only_bc else latent_dim),
            torch.Generator().manual_seed(int(seed))).to(self.device)
        # frozen-teacher action regularization (runner.py:237-241): predicted
        # latent → frozen actor → action MSE vs the logged teacher action
        self.teacher = None
        if teacher_ckpt and not cfg.only_bc:
            tree = restore_path(teacher_ckpt)
            self.teacher = dict(
                net=actor_critic_from_jax_params(tree["params"], self.device).requires_grad_(False),
                obs_rms=rms_to(tree["obs_rms"], self.device),
                priv_rms=rms_to(tree["priv_rms"], self.device))

        self.total_steps = max(len(self.dataset) // cfg.batch_size, 1) * cfg.epochs
        self.decay_steps = max(self.total_steps, cfg.warmup_steps + 1)
        self.optimizer = torch.optim.AdamW(self.student.parameters(), lr=0.0, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=WEIGHT_DECAY)
        self.updates = 0     # optax's schedule count
        self.ckpt = Checkpointer(out_dir)
        self.writer = MetricsWriter(out_dir)

    def _make_student(self, obs_dim: int, out_dim: int) -> MultiModalModel:
        """The reference's `MultiModalModel` with the widths flax infers from
        the first trajectory's stored arrays written out."""
        cfg = self.cfg
        traj0 = self.dataset._trajs[0]
        kw = {}
        if cfg.use_tactile:
            f, _, _, c = traj0["tactile"].shape[1:]
            kw["tactile_channels"] = f * c
        (plug, socket, goal), scene = pcl_slices(traj0["pcl"].shape[1] if cfg.use_pcl else 0)
        return MultiModalModel(
            use_obs=cfg.use_obs, use_tactile=cfg.use_tactile, use_img=cfg.use_img,
            use_seg=cfg.use_seg, use_pcl=cfg.use_pcl, latent_dim=out_dim, bc_mode=cfg.only_bc,
            num_points=plug, num_points_socket=socket, num_points_goal=goal, scene_points=scene,
            obs_dim=obs_dim * cfg.seq_len,
            num_tokens=(int(cfg.use_obs) + cfg.seq_len * (int(cfg.use_tactile) + int(cfg.use_img))
                        + int(cfg.use_seg) + int(cfg.use_pcl)), **kw)

    def load_params(self, tree):
        """Load a flax `student_params` tree (a checkpoint's) into the student."""
        self.student.load_state_dict(convert_flax_params(tree))

    def restore(self, path: str):
        """The student of a checkpoint written by this runner or the JAX one."""
        self.load_params(restore_path(path)["student_params"])

    def lr_at(self, count: int) -> float:
        return warmup_cosine_lr(count, self.cfg.learning_rate, self.cfg.warmup_steps, self.decay_steps)

    # ------------------------------------------------------------------ #
    # batch preprocessing (host-side numpy)
    # ------------------------------------------------------------------ #

    def _prepare(self, batch: dict, rng: np.random.Generator, augment: bool) -> dict:
        cfg = self.cfg
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)
        out = {"actions": dev(batch["actions"][:, -1])}
        if "latent" in batch:
            out["latent"] = dev(batch["latent"][:, -1])
        if self.teacher is not None:
            out["t_obs"] = dev(batch["obs"][:, -1])
            out["t_priv"] = dev(batch["priv_info"][:, -1])
        inp = {}
        if cfg.use_obs:
            so = batch["student_obs"]
            inp["obs"] = dev(so.reshape(so.shape[0], -1))
        if cfg.use_tactile:
            inp["tactile"] = dev(batch["tactile"])
        img = batch.get("img")
        seg = batch.get("seg")
        if augment and cfg.img_jitter > 0 and (img is not None or seg is not None):
            # synchronized random spatial jitter: the SAME shift for img and
            # seg of a sample (SyncRandomReshapeTransform parity)
            ref = img if img is not None else seg
            B = ref.shape[0]
            dy = rng.integers(-cfg.img_jitter, cfg.img_jitter + 1, B)
            dx = rng.integers(-cfg.img_jitter, cfg.img_jitter + 1, B)

            def shift(a):
                a = a.copy()
                for i in range(B):
                    a[i] = np.roll(a[i], (int(dy[i]), int(dx[i])), axis=(-2, -1))
                return a
            if img is not None:
                img = shift(img)
            if seg is not None:
                seg = shift(seg)
        if cfg.use_img and img is not None:
            inp["img"] = dev(img)
        if cfg.use_seg and seg is not None:
            inp["seg"] = dev(_seg_masks_np(seg[:, -1])[:, None])
        if cfg.use_pcl:
            inp["pcl"] = dev(batch["pcl"][:, -1])
        out["inputs"] = inp
        return out

    # ------------------------------------------------------------------ #
    # loss / steps
    # ------------------------------------------------------------------ #

    def _loss(self, batch):
        cfg = self.cfg
        pred = self.student(**batch["inputs"])
        target_act = batch["actions"]
        w = torch.ones(target_act.shape[-1], device=self.device)
        w[2] = cfg.action_z_weight
        aux = {}
        if cfg.only_bc:
            loss = torch.mean(w * torch.square(pred - target_act))
            aux["action_loss"] = loss
        else:
            lat_loss = torch.mean(torch.square(pred - batch["latent"]))
            loss = cfg.latent_loss_coef * lat_loss
            aux["latent_loss"] = lat_loss
            if self.teacher is not None:
                t = self.teacher
                o = rms_normalize(t["obs_rms"], batch["t_obs"])
                p = rms_normalize(t["priv_rms"], batch["t_priv"])
                mu = t["net"](o, p, latent=pred)[0]
                act_loss = torch.mean(w * torch.square(mu - target_act))
                loss = loss + cfg.action_reg_coef * act_loss
                aux["action_loss"] = act_loss
        aux["loss"] = loss
        return loss, aux

    def train_step(self, batch: dict) -> dict:
        """One AdamW update on a prepared batch → its loss terms (tensors,
        from before the update)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self._loss(batch)
        loss.backward()
        set_lr(self.optimizer, self.lr_at(self.updates))
        self.optimizer.step()
        self.updates += 1
        return {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        return self._loss(batch)[1]

    def _ckpt_tree(self) -> dict:
        return {"student_params": student_to_jax_params(self.student.state_dict())}

    # ------------------------------------------------------------------ #
    # training loop
    # ------------------------------------------------------------------ #

    def run(self) -> dict:
        rng = np.random.default_rng(0)
        step = 0
        last = {}
        for epoch in range(self.cfg.epochs):
            train_losses = []
            for batch in self.dataset.batches(self.cfg.batch_size, rng):
                jb = self._prepare(batch, rng, augment=True)
                train_losses.append(self.train_step(jb)["loss"])
                step += 1
            val_losses = []
            if self.val_dataset is not None:
                bs = min(self.cfg.batch_size, max(len(self.val_dataset), 1))
                for batch in self.val_dataset.batches(bs, np.random.default_rng(1)):
                    jb = self._prepare(batch, rng, augment=False)
                    val_losses.append(self.eval_step(jb)["loss"])
            # one device → host copy of the epoch's losses
            train_losses = torch.stack(train_losses).tolist() if train_losses else []
            val_losses = torch.stack(val_losses).tolist() if val_losses else []
            last = {
                "train/loss": float(np.mean(train_losses)) if train_losses else float("nan"),
                "val/loss": float(np.mean(val_losses)) if val_losses else float("nan"),
            }
            self.writer.write(step, last)
            self.ckpt.save_last(self._ckpt_tree(), step)
            # best-checkpoint selection on HELD-OUT loss (train loss only as
            # a fallback when the dataset is too small to split)
            score = -last["val/loss"] if val_losses else -last["train/loss"]
            if np.isfinite(score):
                self.ckpt.maybe_save_best(self._ckpt_tree(), score, float("-inf"))
        return last

    # ------------------------------------------------------------------ #
    # live-env replay evaluation (offline_training_w_env parity:
    # reference train.py:124-128 + transformer/runner.py:194-304 — an
    # offline-trained student is validated by driving the live vectorized
    # env with it and measuring first-episode success)
    # ------------------------------------------------------------------ #

    def _rms_of(self, key: str) -> RMSState:
        """Adapt DataNormalizer {mean, std} stats to the RMSState the env
        eval path normalizes with (var = std², effectively infinite count)."""
        s = self.normalizer.stats.get(key)
        if s is None:
            return rms_init((3,) if key == "pcl" else (15,), self.device)
        std = torch.as_tensor(s["std"], dtype=torch.float32, device=self.device)
        return RMSState(mean=torch.as_tensor(s["mean"], dtype=torch.float32, device=self.device),
                        var=std ** 2, count=torch.tensor(1e8, dtype=torch.float32, device=self.device))

    def replay_eval(self, cfg_task, n_envs: int = 64, seed: int = 1234,
                    teacher_ckpt: str = "") -> float:
        """Replay the trained student against the live env; returns the
        first-episode success rate under the reference eval convention
        (resets disabled, the true clearance distribution). An only-BC
        student never queries the teacher; a latent one needs `teacher_ckpt`."""
        from ..assets import build_subassembly_set
        from ..physics.robot import build_kuka_openhand
        from . import ext_adapt as ea
        from .trainer import eval_task_config, make_student_eval_fn

        cfg = self.cfg
        if not cfg.only_bc and not teacher_ckpt:
            raise ValueError("a latent student's replay needs teacher_ckpt: its latent drives the "
                             "frozen teacher's actor")
        da_cfg = ea.DAggerConfig(
            only_bc=cfg.only_bc, use_obs=cfg.use_obs, use_tactile=cfg.use_tactile,
            use_img=cfg.use_img, use_seg=cfg.use_seg, use_pcl=cfg.use_pcl,
        )
        teacher = None
        if teacher_ckpt:
            tree = restore_path(teacher_ckpt)
            teacher = ea.TeacherBundle(actor_critic_from_jax_params(tree["params"], self.device),
                                       rms_to(tree["obs_rms"], self.device),
                                       rms_to(tree["priv_rms"], self.device))
        eval_fn = make_student_eval_fn(eval_task_config(cfg_task), da_cfg, build_kuka_openhand(),
                                       build_subassembly_set(), teacher, n_envs, device=self.device)
        student = ea.StudentBundle(self.student.eval(), self._rms_of("student_obs"), self._rms_of("pcl"))
        sr = eval_fn(student, seed)
        self.student.train()
        self.replay_success = sr
        self.writer.write(0, {"replay/success_rate": sr})
        print(f"Replay Success Rate: {sr:.4f}")
        return sr
