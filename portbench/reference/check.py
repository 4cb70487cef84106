"""The numbers that decide `correct`, from the program's recorded first epoch.

The reference follows the program control step by step from the program's
own env state (teacher forcing: a contact-rich simulation amplifies float
rounding, so two independent rollouts part ways within an epoch), and checks
the stage this skips by itself:

- the start: its own reset from the seed against the program's first state;
- each followed control step: from the program's state before the step and
  the generators' states (the action noise or mix coins redrawn from the
  policy's), its own policy forward (the teacher's and the student's in
  DAgger) and its env step (`frozen/`: a snapshot of the port's env with the
  plain contact solve and renderers, so the port against itself as of the
  benchmark's first commit, not an independent restatement) against the
  program's state after the step and the program's rollout outputs;
- the update: from the rollout it computed itself (the program's states in
  between), its own GAE or reservoir, normalizers and first three Adam steps
  on the rows the program drew (the permutations redrawn from the
  generator's state before the update; the reservoir's uniforms and rows as
  recorded) against the program's.

`follow` computes the reference's outputs, `outputs_of_capture` puts the
program's recorded epoch in the same form, and `compare` reads the gaps:

- `reset_gap`, `env_step_gap`: the worst field's largest absolute gap over
  the largest magnitude of that field in the reference (integer and boolean
  fields count the share of elements that differ);
- `policy_gap`: the same over the rollout's policy outputs;
- `loss_gap`: the worst of the first three Adam steps' losses, relative;
- `grad_gap`: the first gradient as Adam holds it, by the worst leaf: the gap
  between the program's norm and the reference's, over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
- `update_gap`: the parameters' change after three Adam steps, measured as
  `grad_gap`, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (a leaf with no gradient moves under Adam
  by round-off alone).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .. import tree
from . import algo, nets
from .frozen.assets import build_subassembly_set
from .frozen.envs import insertion
from .frozen.envs.config import default_task_config
from .frozen.physics import contact, engine
from .frozen.physics.robot import build_kuka_openhand

TYPES = {"EnvState": insertion.EnvState, "PhysicsState": engine.PhysicsState,
         "PhysicsParams": engine.PhysicsParams, "MaterialParams": contact.MaterialParams}
N_ADAM = 3


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls in full precision, or (the control) in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _task(mix: dict):
    base = default_task_config()
    return base.replace(env=dataclasses.replace(base.env, **mix["env"]), **mix["task"])


def followed_steps(mix: dict, horizon: int, seed: int) -> list:
    """The control steps the reference follows: every step, or `check_steps`
    of them drawn from the seed (always the first and the last)."""
    k = int(mix.get("check_steps", horizon))
    if k >= horizon:
        return list(range(horizon))
    g = torch.Generator().manual_seed(int(seed) & 0xFFFFFFFF)
    inner = (torch.randperm(horizon - 2, generator=g)[:k - 2] + 1).tolist()
    return sorted({0, horizon - 1, *inner})


# ------------------------------------------------------------------ gaps

# the sensors' frame queues: pixels and sampled points, compared by the share
# of elements that differ (a pixel on a silhouette's edge may flip between two
# renderers' rounding, and the point cloud is sampled from the flipped mask)
FRAMES = ("tactile_queue", "img_queue", "seg_queue", "pcl_queue", "contact_queue")
FRAME_TOL = 1e-3


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    if p.shape != r.shape:
        return float("inf")
    if not r.numel():
        return 0.0
    if r.dtype.is_floating_point:
        p, r = p.float(), r.float()
        if not bool(torch.isfinite(p).all()):
            return float("inf")
        scale, diff = float(r.abs().max()), float((p - r).abs().max())
        return diff / scale if scale > 0 else diff
    return float((p != r).float().mean())


def _share_differing(p: torch.Tensor, r: torch.Tensor) -> float:
    if p.shape != r.shape:
        return float("inf")
    if not r.numel():
        return 0.0
    p, r = p.float(), r.float()
    if not bool(torch.isfinite(p).all()):
        return float("inf")
    return float(((p - r).abs() > FRAME_TOL * max(float(r.abs().max()), 1.0)).float().mean())


def tree_gaps(prog, ref) -> tuple:
    """(state gap, frame gap, {field: gap}) of two trees of tensors (program,
    reference): the worst non-frame field's gap and the worst frame queue's
    share of differing elements."""
    lp, lr = tree.leaves(prog), tree.leaves(ref)
    if set(lp) != set(lr):
        return float("inf"), float("inf"), {"fields": float("inf")}
    dev = next(iter(lr.values())).device
    fields = {k: (_share_differing if k in FRAMES else _gap)(lp[k].to(dev), lr[k]) for k in lr}
    state = max((v for k, v in fields.items() if k not in FRAMES), default=0.0)
    frames = max((v for k, v in fields.items() if k in FRAMES), default=0.0)
    return state, frames, fields


def tree_gap(prog, ref) -> float:
    return tree_gaps(prog, ref)[0]


def _leaf_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """(the worst leaf's |‖program‖ − ‖reference‖| over the larger of the
    reference's norm of that leaf and of the median leaf, that leaf's name)."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in names}
    med = float(torch.tensor(sorted(rn.values())).median())
    worst, at = 0.0, None
    for n in names:
        pn = float(torch.linalg.vector_norm(prog[n].float().to(ref[n].device)))
        if pn != pn:
            return float("inf"), n
        gap = abs(pn - rn[n]) / max(rn[n], med)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: program (or control) outputs against the reference's."""
    reset_gap = max(tree_gaps(prog["reset"], ref["reset"])[:2]) if ref["reset_draws"] else float("inf")
    steps = {t: tree_gaps(prog["post"][t], ref["post"][t]) for t in ref["post"]}
    worst = max(steps, key=lambda t: steps[t][0])
    out = {"reset_gap": reset_gap,
           "env_step_gap": steps[worst][0],
           "frame_gap": max(g[1] for g in steps.values()),
           "policy_gap": max(tree_gap(prog["policy"][t], ref["policy"][t]) for t in ref["policy"]),
           "worst_step": {"step": worst, **{k: v for k, v in sorted(steps[worst][2].items(),
                                                                      key=lambda kv: -kv[1])[:3]}}}
    lp, lr = [float(x) for x in prog["losses"]], [float(x) for x in ref["losses"]]
    out["loss_gap"] = max(abs(a - b) / abs(b) if a == a else float("inf") for a, b in zip(lp, lr)) \
        if len(lp) == len(lr) else float("inf")
    out["grad_gap"], grad_leaf = _leaf_gap(prog["grad1"], ref["grad1"])
    gn = {n: float(torch.linalg.vector_norm(g)) for n, g in ref["grad1"].items()}
    med = float(torch.tensor(sorted(gn.values())).median())
    moved = {n for n, v in gn.items() if v >= 1e-3 * med}
    delta = lambda o: {n: o["params3"][n].to(ref["params0"][n].device) - ref["params0"][n] for n in ref["params0"]}
    out["update_gap"], update_leaf = _leaf_gap(delta(prog), delta(ref), keep=moved)
    out["worst_leaf"] = {"grad": grad_leaf, "update": update_leaf, "left_out": sorted(set(gn) - moved)}
    return out


# ------------------------------------------------------------------ the program's side

def outputs_of_capture(cap: dict, cfg: dict, steps: list) -> dict:
    """The program's recorded epoch in the form `compare` reads."""
    keys = ("actions", "neglogp", "values", "mu", "priv") if cfg["algo"] == "ppo" else ("t_actions", "latent_gt")
    policy = {t: {k: cap["traj"][t][k] for k in keys} for t in steps}
    if cfg["algo"] != "ppo":
        for t in steps:
            policy[t]["s_actions"] = cap["s_actions"][t]
    return {"reset": cap["states"][0],
            "post": {t: cap["states"][t + 1] for t in steps},
            "policy": policy,
            "losses": cap["losses"], "grad1": cap["grad1"], "params3": cap["params3"]}


# ------------------------------------------------------------------ the reference's side

def _generator(state, dev) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.set_state(state)
    return gen


class _Env:
    def __init__(self, mix: dict, dev):
        self.cfg, self.model, self.subs = _task(mix), build_kuka_openhand(), build_subassembly_set()
        self.dev = dev

    def reset(self, seed: int, n: int):
        gen = torch.Generator(device=self.dev).manual_seed(int(seed))
        return insertion.reset_all(self.cfg, self.model, self.subs, gen, n), gen.get_state()

    def state(self, data):
        return tree.from_data(data, TYPES, self.dev)

    def step(self, pre, actions, gen_state, alter=None):
        post, out = insertion.step(self.cfg, self.model, self.subs, pre, actions, _generator(gen_state, self.dev))
        if alter is not None:
            post = alter(post)
        return post, out


def follow(cap: dict, cfg: dict, mix: dict, seed: int, dev, steps: list, tf32: bool = False,
           fault: str | None = None, rollout: dict | None = None) -> dict:
    """The reference's outputs for the recorded epoch. `fault` plants one of
    the faults the check must catch in the reference put in the program's
    place: "half_batch" (each loss over half of its minibatch) or "token"
    (one env's observation altered in one step's result). `rollout`, the
    `rollout` entry of an earlier result, reuses its followed steps."""
    algo_ppo = cfg["algo"] == "ppo"
    with precision(tf32), torch.no_grad():
        if rollout is None:
            env = _Env(mix, dev)
            reset, gen0 = env.reset(seed, int(mix["envs"]))
            rollout = (_roll_ppo if algo_ppo else _roll_dagger)(cap, cfg, mix, env, dev, steps)
            # the program's reset drew as many random values as the reference's
            rollout.update(reset=reset, reset_draws=bool(torch.equal(gen0, cap["gen"][0])))
        post = dict(rollout["post"])
        if fault == "token":
            mid = steps[len(steps) // 2]
            obs = post[mid].obs_queue.clone()
            obs[0, 0] += 1.0
            post[mid] = post[mid]._replace(obs_queue=obs)
        update = (_update_ppo if algo_ppo else _update_dagger)(cap, cfg, mix, dev, rollout, fault)
        return {"reset": rollout["reset"], "reset_draws": rollout["reset_draws"], "post": post,
                "policy": rollout["policy"], **update, "rollout": rollout}


def _adam_steps(params: dict, loss_of, h_lr: float, grad_norm: float, batches: list):
    """Three Adam steps from `params` (name → tensor) → losses, first
    gradient (clipped, as Adam gets it), parameters after the third."""
    names = list(params)
    ps = [params[k].clone().requires_grad_(True) for k in names]
    opt = algo.Adam(ps, h_lr)
    losses, grad1 = [], None
    for mb in batches:
        with torch.enable_grad():
            loss = loss_of(dict(zip(names, ps)), mb)
            grads = torch.autograd.grad(loss, ps)
        grads = algo.clip_by_global_norm(list(grads), grad_norm)
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in zip(names, grads)}
        opt.step(ps, grads)
        losses.append(loss.detach())
    return {"losses": losses, "grad1": grad1, "params3": {k: p.detach().clone() for k, p in zip(names, ps)},
            "params0": params}


def _half(mb: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in mb.items()}


def _roll_ppo(cap, cfg, mix, env, dev, steps):
    p, h = cfg["policy"], cfg["ppo"]
    w = {k: v.to(dev) for k, v in cap["weights"].items()}
    obs_rms0, priv_rms0, val_rms0 = algo.rms_init((p["obs_dim"],), dev), algo.rms_init((p["priv_dim"],), dev), \
        algo.rms_init((), dev)
    traj = {k: torch.stack([cap["traj"][t][k] for t in range(len(cap["traj"]))]).to(dev)
            for k in ("obs", "priv", "actions", "neglogp", "values", "rewards", "dones")}
    post, policy = {}, {}
    for t in steps:
        pre = env.state(cap["states"][t])
        priv = insertion.priv_info_of(env.cfg, env.model, pre)
        mu, log_std, v_n, _ = nets.actor_critic(w, p, algo.rms_norm(obs_rms0, pre.obs_queue),
                                                algo.rms_norm(priv_rms0, priv))
        noise = torch.randn(mu.shape, generator=_generator(cap["train_gen"][t], dev), device=dev, dtype=mu.dtype)
        actions = mu + torch.exp(log_std) * noise
        value = algo.rms_unnorm(val_rms0, v_n)
        post[t], out = env.step(pre, torch.clamp(actions, -1.0, 1.0), cap["gen"][t])
        policy[t] = {"actions": actions, "neglogp": algo.neglogp(actions, mu, log_std), "values": value, "mu": mu,
                     "priv": priv}
        traj["obs"][t], traj["priv"][t], traj["actions"][t] = pre.obs_queue, priv, actions
        traj["neglogp"][t], traj["values"][t] = policy[t]["neglogp"], value
        traj["rewards"][t] = 0.01 * out.rew + h["gamma"] * value * out.timeout.to(out.rew.dtype)
        traj["dones"][t] = out.reset.float()
    last = env.state(cap["states"][len(cap["traj"])])
    v_last = algo.rms_unnorm(val_rms0, nets.actor_critic(
        w, p, algo.rms_norm(obs_rms0, last.obs_queue),
        algo.rms_norm(priv_rms0, insertion.priv_info_of(env.cfg, env.model, last)))[2])
    return {"post": post, "policy": policy, "traj": traj, "v_last": v_last, "weights": w}


def _update_ppo(cap, cfg, mix, dev, roll, fault):
    p, h = cfg["policy"], cfg["ppo"]
    traj, w = roll["traj"], roll["weights"]
    advs, returns = algo.gae(traj["rewards"], traj["values"], traj["dones"], roll["v_last"], h["gamma"], h["tau"])
    obs_rms = algo.rms_update(algo.rms_init((p["obs_dim"],), dev), traj["obs"])
    priv_rms = algo.rms_update(algo.rms_init((p["priv_dim"],), dev), traj["priv"])
    val_rms = algo.rms_update(algo.rms_init((), dev), returns)
    fl = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    batch = {"obs": fl(traj["obs"]), "priv": fl(traj["priv"]), "actions": fl(traj["actions"]),
             "neglogp": fl(traj["neglogp"]), "values": fl(algo.rms_norm(val_rms, traj["values"], 1e6)),
             "returns": fl(algo.rms_norm(val_rms, returns, 1e6)), "advs": fl(advs)}
    a = batch["advs"]
    batch["advs"] = (a - a.mean()) / (a.var(correction=0).sqrt() + 1e-8)
    b = batch["obs"].shape[0]
    mb = b // h["mini_epochs"]
    n_mb = b // mb
    gen = _generator(cap["perm_gen"], dev)
    perms = [torch.randperm(b, generator=gen, device=dev) for _ in range((N_ADAM - 1) // n_mb + 1)]
    mbs = [{k: v[perms[j // n_mb].reshape(n_mb, mb)[j % n_mb]] for k, v in batch.items()} for j in range(N_ADAM)]
    if fault == "half_batch":
        mbs = [_half(m) for m in mbs]

    def loss_of(wp, m):
        mu, log_std, value, _ = nets.actor_critic(wp, p, algo.rms_norm(obs_rms, m["obs"]),
                                                  algo.rms_norm(priv_rms, m["priv"]))
        return algo.ppo_loss(mu, log_std, value, m, h)

    return _adam_steps(w, loss_of, h["learning_rate"], h["grad_norm"], mbs)


def _roll_dagger(cap, cfg, mix, env, dev, steps):
    s, d, tc = cfg["student"], cfg["dagger"], cfg["teacher"]
    td = cap["teacher"]
    tw = {k: v.to(dev) for k, v in td["weights"].items()}
    t_obs_rms = algo.RMS(*[x.to(dev) for x in td["obs_rms"]])
    t_priv_rms = algo.RMS(*[x.to(dev) for x in td["priv_rms"]])
    w = {k: v.to(dev) for k, v in cap["weights"].items()}
    n = int(mix["envs"])
    stud_rms0, pcl_rms0 = algo.rms_init((s["obs_dim"],), dev), algo.rms_init((3,), dev)
    keys = ("obs", "student_obs", "t_actions", "latent_gt", "pcl")
    traj = {k: torch.stack([cap["traj"][t][k] for t in range(len(cap["traj"]))]).to(dev) for k in keys}
    post, policy = {}, {}
    for t in steps:
        pre = env.state(cap["states"][t])
        priv = insertion.priv_info_of(env.cfg, env.model, pre)
        mu, _, _, latent = nets.actor_critic(tw, tc, algo.rms_norm(t_obs_rms, pre.obs_queue),
                                             algo.rms_norm(t_priv_rms, priv))
        t_actions = torch.clamp(mu, -1.0, 1.0)
        pcl = algo.rms_norm(pcl_rms0, pre.pcl_queue[:, -1])
        s_actions = nets.student(w, s, algo.rms_norm(stud_rms0, pre.obs_stud_queue), pcl)
        agent_steps = cap["agent_steps"] + t * n
        beta = min(max(1.0 - agent_steps / d["beta_anneal_steps"], 0.0), 1.0)
        if agent_steps < d["teacher_only_steps"] and not mix["env"].get("tactile", False):
            actions = t_actions
        else:
            coins = torch.rand((n, 1), generator=_generator(cap["train_gen"][t], dev), device=dev)
            actions = torch.where(coins < beta, t_actions, s_actions)
        post[t], _ = env.step(pre, actions, cap["gen"][t])
        policy[t] = {"t_actions": t_actions, "latent_gt": latent, "s_actions": s_actions}
        traj["obs"][t], traj["student_obs"][t] = pre.obs_queue, pre.obs_stud_queue
        traj["t_actions"][t], traj["latent_gt"][t], traj["pcl"][t] = t_actions, latent, pre.pcl_queue
    return {"post": post, "policy": policy, "traj": traj, "weights": w}


def _update_dagger(cap, cfg, mix, dev, roll, fault):
    s, d = cfg["student"], cfg["dagger"]
    traj, w = roll["traj"], roll["weights"]
    n = int(mix["envs"])
    stud_rms = algo.rms_update(algo.rms_init((s["obs_dim"],), dev), traj["student_obs"])
    pcl_rms = algo.rms_update(algo.rms_init((3,), dev), traj["pcl"].reshape(-1, 3))
    b = traj["obs"].shape[0] * n
    batch = {k: v.reshape((b,) + tuple(v.shape[2:])) for k, v in traj.items()}
    batch["pcl"] = batch["pcl"].half().float()          # the reservoir keeps frames in float16
    k_a = d["replay_size"] // 2 if d["replay_stratify"] else 0
    k_b = d["replay_size"] - k_a
    if cap["agent_steps"] != 0:
        raise ValueError("the reference follows the first epoch, into an empty reservoir")
    slot_b = algo.reservoir_rows(0, cap["res_u"].to(dev), k_b)
    slot_a = algo.reservoir_rows(0, cap["res_u_a"].to(dev), k_a) if k_a else {}
    rows = torch.stack(cap["rows"])
    mbs = []
    for j in range(N_ADAM):
        drawn = rows[j // rows.shape[1]][j % rows.shape[1]].tolist()
        idx = torch.tensor([slot_a[r] if r < k_a else slot_b[r - k_a] for r in drawn], device=dev)
        mbs.append({k: v[idx] for k, v in batch.items()})
    if fault == "half_batch":
        mbs = [_half(m) for m in mbs]
    wz = torch.ones(s["out_dim"], device=dev)
    wz[2] = d["action_z_weight"]

    def loss_of(wp, m):
        pred = nets.student(wp, s, algo.rms_norm(stud_rms, m["student_obs"]), algo.rms_norm(pcl_rms, m["pcl"][:, -1]))
        return torch.mean(wz * (pred - m["t_actions"]) ** 2)

    return _adam_steps(w, loss_of, d["learning_rate"], d["grad_norm"], mbs)
