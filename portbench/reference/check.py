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

What depends on the algorithm (the rollout, the update's inputs, the policy
outputs compared) is the reference's module of the configuration's `algo`
(`kinds/<algo>.py`). `follow` computes the reference's outputs,
`outputs_of_capture` puts the program's recorded epoch in the same form, and
`compare` reads the gaps:

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
from . import algo, kinds
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
    kind = kinds.of(cfg)
    return {"reset": cap["states"][0],
            "post": {t: cap["states"][t + 1] for t in steps},
            "policy": {t: kind.policy_outputs(cap, t) for t in steps},
            "losses": cap["losses"], "grad1": cap["grad1"], "params3": cap["params3"]}


# ------------------------------------------------------------------ the reference's side

class _Env:
    def __init__(self, mix: dict, dev):
        self.cfg, self.model, self.subs = _task(mix), build_kuka_openhand(), build_subassembly_set()
        self.dev = dev

    def reset(self, seed: int, n: int):
        gen = torch.Generator(device=self.dev).manual_seed(int(seed))
        return insertion.reset_all(self.cfg, self.model, self.subs, gen, n), gen.get_state()

    def state(self, data):
        return tree.from_data(data, TYPES, self.dev)

    def priv(self, state):
        return insertion.priv_info_of(self.cfg, self.model, state)

    def step(self, pre, actions, gen_state, alter=None):
        post, out = insertion.step(self.cfg, self.model, self.subs, pre, actions, algo.generator(gen_state, self.dev))
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
    kind = kinds.of(cfg)
    with precision(tf32), torch.no_grad():
        if rollout is None:
            env = _Env(mix, dev)
            reset, gen0 = env.reset(seed, int(mix["envs"]))
            rollout = kind.roll(cap, cfg, mix, env, dev, steps)
            # the program's reset drew as many random values as the reference's
            rollout.update(reset=reset, reset_draws=bool(torch.equal(gen0, cap["gen"][0])))
        post = dict(rollout["post"])
        if fault == "token":
            mid = steps[len(steps) // 2]
            obs = post[mid].obs_queue.clone()
            obs[0, 0] += 1.0
            post[mid] = post[mid]._replace(obs_queue=obs)
        update = kind.update(cap, cfg, mix, dev, rollout, N_ADAM)
        mbs = update["minibatches"]
        if fault == "half_batch":
            mbs = [_half(m) for m in mbs]
        steps_out = _adam_steps(update["params"], update["loss_of"], update["lr"], update["grad_norm"], mbs)
        return {"reset": rollout["reset"], "reset_draws": rollout["reset_draws"], "post": post,
                "policy": rollout["policy"], **steps_out, "rollout": rollout}


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
