"""PPO teacher (stage 1): rollout, GAE and the clipped-surrogate update.

Port of `isaacgyminsertion_tpu/algo/ppo.py`, the rl_games-derived PPO of the
reference: an asymmetric actor-critic with a privileged encoder, GAE
(γ 0.99, τ 0.95), ratio clip 0.2, a clipped value loss ×0.5×critic_coef,
a bounds loss, grad-norm clipping, obs/priv/value running normalizers, the
timeout value bootstrap (reward×0.01 + γV, `value_bootstrap`) and
minibatch = batch // mini_epochs (the reference's quirk). The options are
those of the reference: `lr_schedule="kl"`, `anchor_coef`,
`critic_warmup_steps` (+ `warmup_freeze_rms`) and `bootstrap_mask_success`.

One epoch is a Python loop: `horizon` env steps with the policy sampling
actions (no autograd; on the CPU the env's plain contact generation takes its
SDF normals by autograd), the bootstrap value and GAE, the normalizer
updates, the flattened batch, then
`mini_epochs` passes over `batch // mini_epochs`-row minibatches, each an
autograd step of Adam behind a clip by global norm with optax's semantics.
The parameters live in the `ActorCriticSplit` module and are updated in
place; the optimizer's learning rate sits in its `param_groups`. Randomness
comes from explicit generators: the env's (resets and DR) and the trainer's
(action noise and minibatch permutations); `train_epoch` also takes the
noise of each step and the permutation of each mini-epoch from the caller.

Data parallel (`dp=`, a `parallel.mesh.DataParallel`): each rank steps its
own rows of the env batch, and the epoch computes what the single process
computes on the whole batch, as the JAX package's mesh does. The normalizers
fold the ranks' moments (Chan's rule), the advantages are normalized by the
global mean and std, every rank draws the same permutation of the global
B = horizon · N rows and takes the rows it owns of each minibatch, its loss
scaled by its share so that the summed gradients (one all-reduce a
minibatch, before the clip by global norm) are those of the global mean,
and the metrics, the KL that sets the learning rate and `agent_steps` are
global. The env and the action noise draw from generators seeded from
(seed, rank); the permutations from one seeded alike on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import resolve_device
from ..envs import insertion
from ..envs.config import TaskConfig
from ..models.actor_critic import (
    ActorCriticSplit,
    gaussian_neglogp,
    init_like_flax,
    policy_kl,
    sample_actions,
)
from ..models.running_mean_std import (
    RMSState,
    rms_fold,
    rms_init,
    rms_normalize,
    rms_unnormalize,
)
from ..parallel import mesh
from ..utils import profiling


@dataclass(frozen=True)
class PPOConfig:
    horizon: int = 64
    mini_epochs: int = 8
    gamma: float = 0.99
    tau: float = 0.95
    e_clip: float = 0.2
    critic_coef: float = 4.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.0001
    grad_norm: float = 1.0
    learning_rate: float = 2.5e-4
    kl_threshold: float = 0.02
    # "fixed" (the reference's default) | "kl": kl > 2·thr → lr/1.5,
    # kl < thr/2 → lr·1.5, clamped to [1e-6, 1e-2], applied once per epoch
    # on the epoch-mean KL
    lr_schedule: str = "fixed"
    # eval-gated anneal ladder (trainer side): after `anneal_patience`
    # evals below the best by more than `anneal_margin`, restore the best,
    # multiply the LR by `anneal_decay` (floored at `anneal_min_lr`) and
    # start Adam's moments afresh
    anneal_ladder: bool = False
    anneal_decay: float = 0.5
    anneal_patience: int = 2
    anneal_min_lr: float = 1e-6
    anneal_margin: float = 0.02
    # > 0 adds anchor_coef · KL(π ‖ π_anchor), π_anchor a frozen snapshot
    # (the starting policy; the trainer re-points it at each new eval best)
    anchor_coef: float = 0.0
    value_bootstrap: bool = True
    # no γV timeout bootstrap on states that are inserted
    bootstrap_mask_success: bool = False
    # while agent_steps < critic_warmup_steps only the critic and the value
    # head get gradients; with warmup_freeze_rms the obs/priv normalizers
    # keep their statistics too (value_rms keeps updating)
    critic_warmup_steps: float = 0.0
    warmup_freeze_rms: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    clip_value: bool = True
    max_agent_steps: float = 1.5e9

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class PPOState(NamedTuple):
    net: ActorCriticSplit          # the parameters (updated in place)
    optimizer: torch.optim.Adam
    obs_rms: RMSState
    priv_rms: RMSState
    value_rms: RMSState
    env_state: insertion.EnvState
    env_gen: torch.Generator       # the env's resets and DR
    train_gen: torch.Generator     # action noise and minibatch permutations
    epoch: int
    agent_steps: int               # exact (the reference keeps an f32)
    # frozen policy snapshot for the anchor-KL loss (None when anchor_coef=0)
    anchor: ActorCriticSplit | None = None
    # the minibatch permutations under data parallelism (seeded alike on every
    # rank); None: they come from train_gen
    perm_gen: torch.Generator | None = None


class Transition(NamedTuple):
    obs: torch.Tensor
    priv: torch.Tensor
    actions: torch.Tensor
    neglogp: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    succ: torch.Tensor  # inserted before the step, for the diagnostics only


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    root); the learning rate lives in `param_groups` (`set_lr`)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by max_norm / norm when their global norm exceeds
    max_norm (optax.clip_by_global_norm; `clip_grad_norm_` adds 1e-6 to the
    norm and differs) → the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = ~(norm < max_norm)
    for g in grads:   # (g / norm) · max_norm, in optax's order
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def _is_critic(name: str) -> bool:
    return name.startswith(("critic_mlp.", "value."))


def build(cfg_task: TaskConfig, ppo_cfg: PPOConfig, model, subs, n_envs: int, seed: int,
          device=None, grasp_data=None, dp=None):
    """Network (flax's default init), optimizer, the initial PPOState and the
    epoch → (net, optimizer, state, train_epoch). `grasp_data`
    (`envs.grasp_gen.GraspData`) makes the training env's resets replay a
    grasp-dataset table. With `dp` the run is data parallel on `dp.device`:
    `n_envs` is the global batch, of which this rank resets its N / W rows."""
    dev = resolve_device(device) if dp is None else dp.device
    rank = 0 if dp is None else dp.rank
    n_local = n_envs if dp is None else n_envs // dp.world_size
    if dp is not None:
        dp.rows(n_envs)   # raises unless the ranks split the batch evenly
    obs_dim = cfg_task.env.num_obs_hist * cfg_task.env.num_observations
    net = ActorCriticSplit(num_actions=cfg_task.env.num_actions, obs_dim=obs_dim,
                           priv_dim=cfg_task.env.num_states)
    init_like_flax(net, torch.Generator().manual_seed(int(seed) + 1))
    net = net.to(dev)
    if dp is not None:
        mesh.replicate(net, dp)
    env_gen = insertion.make_generator(mesh.rank_seed(seed, rank), dev)
    with torch.no_grad():
        env_state = insertion.reset_all(cfg_task, model, subs, env_gen, n_local, grasp_data=grasp_data)
    optimizer = make_optimizer(net.parameters(), ppo_cfg.learning_rate)
    state = PPOState(
        net=net, optimizer=optimizer,
        obs_rms=rms_init((obs_dim,), dev), priv_rms=rms_init((cfg_task.env.num_states,), dev),
        value_rms=rms_init((), dev), env_state=env_state, env_gen=env_gen,
        train_gen=insertion.make_generator(mesh.rank_seed(int(seed) + 2, rank), dev), epoch=0,
        agent_steps=0, anchor=frozen_copy(net) if ppo_cfg.anchor_coef > 0 else None,
        perm_gen=None if dp is None else insertion.make_generator(int(seed) + 3, dev))
    return net, optimizer, state, TrainEpoch(cfg_task, ppo_cfg, model, subs, grasp_data=grasp_data,
                                             dp=dp)


def frozen_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A detached snapshot of `net` (the anchor policy)."""
    anchor = copy.deepcopy(net)
    for p in anchor.parameters():
        p.requires_grad_(False)
    return anchor


def make_act_fn(cfg_task: TaskConfig, net):
    """Inference policy: (obs_rms, priv_rms, obs, priv) → clamped
    deterministic actions (the test path)."""

    def act(obs_rms, priv_rms, obs, priv):
        mu = net(rms_normalize(obs_rms, obs), rms_normalize(priv_rms, priv))[0]
        return torch.clamp(mu, -1.0, 1.0)

    return act


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TrainEpoch:
    """One PPO epoch: `train_epoch(state, noise=None, perms=None)` →
    (state', metrics). `noise` holds the [N, A] standard-normal draw of each
    rollout step and `perms` the [B] permutation of each mini-epoch; where
    they are not given they come from `state.train_gen` (`state.perm_gen` for
    the permutations when it is set). With `dp` the noise is this rank's
    [N / W, A] rows and the permutations are of the global B. The phases
    (`rollout`, `advantages`, `normalizers`, `batch`, `update`) are methods so
    that a profiler can take them apart; each is a `profiling.span` closed by
    a device synchronize, and the metrics hold every span's host seconds over
    the epoch as `time/<span>_s`. `render_rows` keeps the last
    rollout's (tactile rows, camera rows) that this process rendered at each
    step, as host ints."""

    def __init__(self, cfg_task: TaskConfig, ppo_cfg: PPOConfig, model, subs, grasp_data=None,
                 dp=None):
        self.cfg_task, self.ppo_cfg, self.model, self.subs = cfg_task, ppo_cfg, model, subs
        self.grasp_data = grasp_data
        self.dp = dp
        self.render_rows = []

    # ------------------------------------------------ global reductions (dp)
    def _sum(self, x):
        return mesh.sum_(x, self.dp)

    def _mean(self, x):
        return mesh.mean(x, self.dp)

    def _mean_std(self, x):
        """Mean and population std of `x`, over the ranks with `dp`."""
        _, mean, var = mesh.moments(x, tuple(range(x.ndim)), self.dp)
        return mean, torch.sqrt(var)

    def _rms_update(self, rms: RMSState, x):
        count, mean, var = mesh.moments(x, tuple(range(x.ndim - rms.mean.ndim)), self.dp)
        return rms_fold(rms, mean, var, count)

    def _unnorm_value(self, value_rms, v):
        return rms_unnormalize(value_rms, v) if self.ppo_cfg.normalize_value else v

    # ------------------------------------------------------------ rollout
    @torch.no_grad()
    def rollout_step(self, state: PPOState, env_state, eps=None):
        """One control step with sampled actions → (env_state', Transition,
        per-step metrics as a tensor [reward, success, dones, render_overflow]);
        the rows the renderers drew in `last_render_rows`."""
        c, net = self.ppo_cfg, state.net
        obs = env_state.obs_queue
        succ_pre = env_state.success_reset_buf.float()
        priv = insertion.priv_info_of(self.cfg_task, self.model, env_state)
        with profiling.span("rollout.policy"):
            mu, log_std, value_n, _, _ = net(rms_normalize(state.obs_rms, obs),
                                             rms_normalize(state.priv_rms, priv))
            actions, neglogp = sample_actions(mu, log_std, state.train_gen, noise=eps)
            value = self._unnorm_value(state.value_rms, value_n)
        env_state, out = insertion.step(self.cfg_task, self.model, self.subs, env_state,
                                        torch.clamp(actions, -1.0, 1.0), state.env_gen,
                                        grasp_data=self.grasp_data, dp=self.dp)
        if c.value_bootstrap:
            boot = out.timeout.to(out.rew.dtype)
            if c.bootstrap_mask_success:
                boot = boot * (1.0 - env_state.success_reset_buf.to(out.rew.dtype))
            shaped = 0.01 * out.rew + c.gamma * value * boot
        else:
            shaped = out.rew
        dones = out.reset.float()
        tr = Transition(obs=obs, priv=priv, actions=actions, neglogp=neglogp, values=value,
                        rewards=shaped, dones=dones, mu=mu,
                        sigma=torch.exp(log_std) * torch.ones_like(mu), succ=succ_pre)
        m = torch.stack([out.rew.mean(), out.extras["successes"].mean(), dones.sum(),
                         out.extras["render_overflow"][0].float()])
        self.last_render_rows = out.extras["render_rows"]
        return env_state, tr, m

    def rollout(self, state: PPOState, noise=None):
        """`horizon` steps → (env_state, trajectory [T, N, ...], step metrics [T, 4])."""
        env_state, trs, ms = state.env_state, [], []
        self.render_rows = []
        for t in range(self.ppo_cfg.horizon):
            env_state, tr, m = self.rollout_step(state, env_state,
                                                 None if noise is None else noise[t])
            trs.append(tr)
            ms.append(m)
            self.render_rows.append(self.last_render_rows)
        traj = Transition(*[torch.stack(x) for x in zip(*trs)])
        return env_state, traj, torch.stack(ms)

    # ------------------------------------------------------------ returns
    @torch.no_grad()
    def advantages(self, state: PPOState, env_state, traj: Transition):
        """Bootstrap value of the last state, then GAE backwards → (advs, returns)."""
        c = self.ppo_cfg
        priv_last = insertion.priv_info_of(self.cfg_task, self.model, env_state)
        last_value_n = state.net(rms_normalize(state.obs_rms, env_state.obs_queue),
                                 rms_normalize(state.priv_rms, priv_last))[2]
        v_next = self._unnorm_value(state.value_rms, last_value_n)
        adv_next = torch.zeros_like(v_next)
        nd_next = 1.0 - traj.dones[-1]
        advs = [None] * c.horizon
        for t in reversed(range(c.horizon)):
            delta = traj.rewards[t] + c.gamma * v_next * nd_next - traj.values[t]
            adv_next = delta + c.gamma * c.tau * nd_next * adv_next
            advs[t] = adv_next
            v_next, nd_next = traj.values[t], 1.0 - traj.dones[t]
        advs = torch.stack(advs)
        return advs, advs + traj.values

    @torch.no_grad()
    def normalizers(self, state: PPOState, traj: Transition, returns):
        """The batch-level normalizer updates → (obs_rms, priv_rms, value_rms)."""
        c = self.ppo_cfg
        obs_rms = self._rms_update(state.obs_rms, traj.obs) if c.normalize_input else state.obs_rms
        priv_rms = self._rms_update(state.priv_rms, traj.priv) if c.normalize_input else state.priv_rms
        value_rms = self._rms_update(state.value_rms, returns) if c.normalize_value else state.value_rms
        if c.critic_warmup_steps > 0 and c.warmup_freeze_rms \
                and state.agent_steps < c.critic_warmup_steps:
            obs_rms, priv_rms = state.obs_rms, state.priv_rms
        return obs_rms, priv_rms, value_rms

    @torch.no_grad()
    def batch(self, traj: Transition, advs, returns, value_rms):
        """The flattened [B, ...] batch and the collapse diagnostics."""
        c = self.ppo_cfg
        returns_n = rms_normalize(value_rms, returns, clip=1e6) if c.normalize_value else returns
        values_n = rms_normalize(value_rms, traj.values, clip=1e6) if c.normalize_value else traj.values
        fl = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        batch = dict(obs=fl(traj.obs), priv=fl(traj.priv), actions=fl(traj.actions),
                     neglogp=fl(traj.neglogp), values=fl(values_n), returns=fl(returns_n),
                     advs=fl(advs), mu=fl(traj.mu), sigma=fl(traj.sigma))
        if c.normalize_advantage:
            a = batch["advs"]
            a_mean, a_std = self._mean_std(a)
            batch["advs"] = (a - a_mean) / (a_std + 1e-8)
        S, M = self._sum, self._mean
        succ_m = traj.succ
        fail_m = 1.0 - succ_m
        n_s = S(succ_m) + 1e-8
        n_f = S(fail_m) + 1e-8
        verr = returns - traj.values  # unnormalized TD(λ) value error
        diag = {
            "diag/value_error_abs": M(torch.abs(verr)),
            "diag/value_error_success": S(torch.abs(verr) * succ_m) / n_s,
            "diag/value_error_fail": S(torch.abs(verr) * fail_m) / n_f,
            "diag/adv_success": S(advs * succ_m) / n_s,
            "diag/adv_fail": S(advs * fail_m) / n_f,
            "diag/adv_std": self._mean_std(advs)[1],
            "diag/success_state_frac": M(succ_m),
            "diag/value_mean": M(traj.values),
            "diag/return_mean": M(returns),
        }
        return batch, diag

    # ------------------------------------------------------------ update
    def loss(self, state: PPOState, obs_rms, priv_rms, mb: dict, rows: int | None = None):
        """The PPO loss of one minibatch → (loss, aux dict of scalars). With
        `rows` (data parallel: the global minibatch's row count) each mean
        over rows is this rank's sum over `rows`, and a term that does not
        depend on the rows is this rank's 1 / W share: the ranks' losses and
        aux values sum to the global minibatch's."""
        c = self.ppo_cfg
        mean = torch.mean if rows is None else (lambda x: torch.sum(x) / rows)
        o = rms_normalize(obs_rms, mb["obs"])
        p = rms_normalize(priv_rms, mb["priv"])
        mu, log_std, value, _, _ = state.net(o, p)
        neglogp = gaussian_neglogp(mb["actions"], mu, log_std)
        ratio = torch.exp(mb["neglogp"] - neglogp)
        surr1 = mb["advs"] * ratio
        surr2 = mb["advs"] * torch.clamp(ratio, 1.0 - c.e_clip, 1.0 + c.e_clip)
        a_loss = mean(torch.maximum(-surr1, -surr2))
        if c.clip_value:
            v_clipped = mb["values"] + torch.clamp(value - mb["values"], -c.e_clip, c.e_clip)
            v_loss = torch.maximum(torch.square(value - mb["returns"]),
                                   torch.square(v_clipped - mb["returns"]))
        else:
            v_loss = torch.square(value - mb["returns"])
        c_loss = mean(v_loss)
        # one scalar from log_std alone (state-independent std)
        entropy = torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e))
        if rows is not None:
            entropy = entropy / self.dp.world_size
        mu_excess = torch.clamp(mu - 1.1, min=0.0) ** 2 + torch.clamp(mu + 1.1, max=0.0) ** 2
        b_loss = mean(torch.sum(mu_excess, dim=-1))
        loss = (a_loss + 0.5 * c_loss * c.critic_coef - entropy * c.entropy_coef
                + b_loss * c.bounds_loss_coef)
        sigma = torch.exp(log_std) * torch.ones_like(mu)
        kl = policy_kl(mu, sigma, mb["mu"], mb["sigma"], reduce=mean)
        clip_frac = mean((torch.abs(ratio - 1.0) > c.e_clip).float())
        aux = {"a_loss": a_loss, "c_loss": c_loss, "b_loss": b_loss, "kl": kl,
               "diag/entropy": entropy, "diag/clip_frac": clip_frac}
        if c.anchor_coef > 0:
            with torch.no_grad():
                mu_a, log_std_a, _, _, _ = state.anchor(o, p)
            kl_anchor = policy_kl(mu, sigma, mu_a, torch.exp(log_std_a) * torch.ones_like(mu_a),
                                  reduce=mean)
            loss = loss + c.anchor_coef * kl_anchor
            aux["kl_anchor"] = kl_anchor
        return loss, aux

    def update(self, state: PPOState, obs_rms, priv_rms, batch: dict, perms=None) -> dict:
        """`mini_epochs` passes of `B // mini_epochs`-row minibatches → the
        losses and diagnostics, averaged per mini-epoch, then over them. With
        `dp`, B and the minibatches are global and each rank computes on the
        rows of each minibatch that it owns."""
        c, net, opt, dp = self.ppo_cfg, state.net, state.optimizer, self.dp
        dev = batch["obs"].device
        B = batch["obs"].shape[0] * mesh.size(dp)
        mb_size = B // c.mini_epochs
        n_mb = B // mb_size
        warm = c.critic_warmup_steps > 0 and state.agent_steps < c.critic_warmup_steps
        frozen = [p for n, p in net.named_parameters() if not _is_critic(n)] if warm else []
        params = list(net.parameters())
        perm_gen = state.perm_gen if state.perm_gen is not None else state.train_gen
        per_epoch = []
        for k in range(c.mini_epochs):
            perm = perms[k] if perms is not None else torch.randperm(B, generator=perm_gen, device=dev)
            perm = perm.reshape(n_mb, mb_size)
            if dp is not None:
                perm, owned = self._local_rows(perm, batch["obs"].shape[0])
            rows = []
            for i in range(n_mb):
                with profiling.span("update.adam_step"):
                    idx = perm[i] if dp is None else perm[i][owned[i]]
                    mb = {key: v[idx] for key, v in batch.items()}
                    loss, aux = self.loss(state, obs_rms, priv_rms, mb,
                                          rows=None if dp is None else mb_size)
                    opt.zero_grad(set_to_none=False)
                    loss.backward()
                    _all_reduce_grads(params, dp)
                    for p in frozen:   # critic warmup: only the critic's gradients count
                        p.grad.zero_()
                    clip_by_global_norm_(params, c.grad_norm)
                    opt.step()
                aux["loss"] = loss
                rows.append(torch.stack([v.detach() for v in aux.values()]))
            per_epoch.append(torch.stack(rows).mean(0))
        names = list(aux.keys())
        return dict(zip(names, mesh.all_reduce_(torch.stack(per_epoch).mean(0), dp)))

    def _local_rows(self, perm, n_rows: int):
        """Global row indices [n_mb, mb] of the flattened [T, N] batch → (this
        rank's local indices, the mask of the rows it owns)."""
        n_global = self.dp.world_size * (n_rows // self.ppo_cfg.horizon)
        lo, hi = self.dp.rows(n_global)
        t, env = perm // n_global, perm % n_global
        owned = (env >= lo) & (env < hi)
        return t * (hi - lo) + env - lo, owned

    # ------------------------------------------------------------ epoch
    def _phase(self, name: str, dev, fn, *args):
        """fn(*args) in the span `name`, closed by a device synchronize."""
        with profiling.span(name):
            out = fn(*args)
            _sync(dev)
        return out

    def __call__(self, state: PPOState, noise=None, perms=None):
        c = self.ppo_cfg
        dev = state.obs_rms.mean.device
        before = profiling.spans()
        env_state, traj, roll = self._phase("rollout", dev, self.rollout, state, noise)
        advs, returns = self._phase("advantages", dev, self.advantages, state, env_state, traj)
        obs_rms, priv_rms, value_rms = self._phase("normalizers", dev, self.normalizers, state, traj,
                                                   returns)
        batch, diag = self._phase("batch", dev, self.batch, traj, advs, returns, value_rms)
        aux = self._phase("update", dev, self.update, state, obs_rms, priv_rms, batch, perms)
        roll = roll.mean(0)   # reward and success are means over the ranks, dones and overflow sums
        roll = mesh.all_reduce_(torch.cat([roll[:2] / mesh.size(self.dp), roll[2:]]), self.dp)
        metrics = {**aux, **diag, "episode/reward": roll[0], "episode/success": roll[1],
                   "episode/dones": roll[2], "episode/render_overflow": roll[3]}
        names = list(metrics)
        metrics = dict(zip(names, torch.stack([metrics[k].float() for k in names]).tolist()))
        if c.lr_schedule == "kl":
            cur = state.optimizer.param_groups[0]["lr"]
            thr = c.kl_threshold
            new_lr = cur / 1.5 if metrics["kl"] > 2.0 * thr else (
                cur * 1.5 if metrics["kl"] < 0.5 * thr else cur)
            new_lr = min(max(new_lr, 1e-6), 1e-2)
            set_lr(state.optimizer, new_lr)
            metrics["info/lr"] = new_lr
        for name, seconds in profiling.spans_since(before).items():
            metrics[f"time/{name}_s"] = seconds
        n_envs = traj.obs.shape[1] * mesh.size(self.dp)
        return state._replace(obs_rms=obs_rms, priv_rms=priv_rms, value_rms=value_rms,
                              env_state=env_state, epoch=state.epoch + 1,
                              agent_steps=state.agent_steps + c.horizon * n_envs), metrics


@torch.no_grad()
def _all_reduce_grads(params, dp):
    """Sum the ranks' gradients, in one flat collective."""
    if dp is None:
        return
    grads = [p.grad for p in params]
    flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), dp)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
