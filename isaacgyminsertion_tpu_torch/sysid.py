"""Sim-parameter system identification (parity: factory_task_optimize.py).

Port of `isaacgyminsertion_tpu/sysid.py`. The reference fits sim parameters
to a recorded trajectory with hyperopt's TPE (`objective()`,
factory_task_optimize.py:669); this module carries the same self-contained
numpy TPE (the good/bad-split kernel-density estimator of Bergstra et al.),
copied as is so that one seed gives the same suggestions to the bit. Each
trial resets one env from a generator seeded 0, scales the plug mass, the
arm's PD gains and the three friction pairs by the trial's values, replays
the recorded actions through `insertion.step` and scores plug-pose tracking
error. The trials run one after another, as the reference's code runs them
(its docstring's batching of trials as env rows is not what it does); one
host sync per trial.

    python -m isaacgyminsertion_tpu_torch.sysid --traj rec.npz [--trials 50] [--device cpu]

`rec.npz` holds `actions` [T, 6], `plug_pos` [T, 3] and `plug_quat` [T, 4]
(what `scripts/sys_id.sh` reads). Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import resolve_device


# ----------------------------------------------------------------- numpy TPE


@dataclass
class Uniform:
    lo: float
    hi: float

    def sample(self, rng, n=1):
        return rng.uniform(self.lo, self.hi, size=n)


def tpe_suggest(space: dict[str, Uniform], history: list[tuple[dict, float]],
                rng: np.random.Generator, gamma: float = 0.25,
                n_candidates: int = 24) -> dict:
    """One TPE suggestion: maximize l(x)/g(x) from the good/bad KDE split."""
    if len(history) < 8:
        return {k: float(v.sample(rng)[0]) for k, v in space.items()}
    srt = sorted(history, key=lambda h: h[1])
    n_good = max(int(gamma * len(srt)), 2)
    good = srt[:n_good]
    bad = srt[n_good:]

    def kde_logpdf(samples: np.ndarray, x: np.ndarray, lo: float, hi: float):
        bw = max(0.5 * (hi - lo) / max(len(samples), 1) ** 0.5, 1e-8)
        d = (x[:, None] - samples[None, :]) / bw
        return np.log(np.mean(np.exp(-0.5 * d * d), axis=1) / (bw * np.sqrt(2 * np.pi)) + 1e-12)

    out = {}
    for k, dist in space.items():
        g_s = np.asarray([h[0][k] for h in good])
        b_s = np.asarray([h[0][k] for h in bad]) if bad else g_s
        # candidates drawn from the good KDE
        cands = np.clip(
            g_s[rng.integers(0, len(g_s), n_candidates)]
            + rng.normal(0, 0.1 * (dist.hi - dist.lo), n_candidates),
            dist.lo, dist.hi,
        )
        score = kde_logpdf(g_s, cands, dist.lo, dist.hi) - kde_logpdf(b_s, cands, dist.lo, dist.hi)
        out[k] = float(cands[np.argmax(score)])
    return out


def tpe_minimize(objective: Callable[[dict], float], space: dict[str, Uniform],
                 n_trials: int = 50, seed: int = 0):
    """hyperopt.fmin(tpe.suggest) equivalent; returns (best_params, history)."""
    rng = np.random.default_rng(seed)
    history: list[tuple[dict, float]] = []
    for _ in range(n_trials):
        params = tpe_suggest(space, history, rng)
        loss = float(objective(params))
        history.append((params, loss))
    best = min(history, key=lambda h: h[1])
    return best[0], history


# ------------------------------------------------------- sim-param objective

DEFAULT_SPACE = {
    "mu_scale": Uniform(0.5, 2.0),        # friction pair scaling
    "kp_scale": Uniform(0.5, 2.0),        # arm PD stiffness scale
    "kd_scale": Uniform(0.5, 2.0),
    "mass_scale": Uniform(0.5, 1.5),      # plug mass
}


def scale_params(params, trial_params: dict):
    """`PhysicsParams` with the plug mass, PD gains and friction pairs scaled
    by a trial's values (1 where a key is absent)."""
    c = params.contact
    mu = trial_params.get("mu_scale", 1.0)
    return params._replace(
        plug_mass=params.plug_mass * trial_params.get("mass_scale", 1.0),
        kp=params.kp * trial_params.get("kp_scale", 1.0),
        kd=params.kd * trial_params.get("kd_scale", 1.0),
        contact=c._replace(mu_socket=c.mu_socket * mu, mu_table=c.mu_table * mu,
                           mu_finger=c.mu_finger * mu),
    )


def make_replay_objective(cfg_task, model, subs, recorded: dict, n_envs: int = 1, device=None):
    """Objective: replay recorded actions, compare plug trajectories.

    `recorded`: dict with 'actions' [T, 6], 'plug_pos' [T, 3], 'plug_quat'
    [T, 4] (one reference trajectory, e.g. from the data logger or hardware).
    Every trial resets from a generator seeded 0 (the reference's PRNGKey(0)).
    """
    from .envs import insertion

    dev = resolve_device(device)
    actions = torch.as_tensor(np.tile(np.asarray(recorded["actions"], np.float32)[:, None], (1, n_envs, 1)),
                              device=dev)
    target_pos = torch.as_tensor(np.asarray(recorded["plug_pos"], np.float32), device=dev)
    target_quat = torch.as_tensor(np.asarray(recorded["plug_quat"], np.float32), device=dev)

    @torch.no_grad()
    def objective(trial_params: dict) -> float:
        gen = insertion.make_generator(0, dev)
        state = insertion.reset_all(cfg_task, model, subs, gen, n_envs)
        state = state._replace(params=scale_params(state.params, trial_params))
        pos, quat = [], []
        for act in actions:
            state, _ = insertion.step(cfg_task, model, subs, state, act, gen)
            pos.append(state.phys.plug_pos[0])
            quat.append(state.phys.plug_quat[0])
        pos, quat = torch.stack(pos), torch.stack(quat)
        pos_err = torch.mean(torch.sum(torch.square(pos - target_pos), dim=-1))
        quat_err = torch.mean(1.0 - torch.abs(torch.sum(quat * target_quat, dim=-1)))
        return float(pos_err + 0.1 * quat_err)

    return objective


def optimize_sim_params(cfg_task, model, subs, recorded: dict,
                        space: dict | None = None, n_trials: int = 50, seed: int = 0, device=None):
    """FactoryTaskOptimizeTactile.objective() driver parity."""
    obj = make_replay_objective(cfg_task, model, subs, recorded, device=device)
    return tpe_minimize(obj, space or DEFAULT_SPACE, n_trials=n_trials, seed=seed)


def main(argv=None):
    """`scripts/sys_id.sh`: TPE over DEFAULT_SPACE on a recorded trajectory."""
    from .assets import build_subassembly_set
    from .envs.config import default_task_config
    from .physics.robot import build_kuka_openhand

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traj", required=True, help="npz with actions, plug_pos, plug_quat")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with np.load(args.traj) as rec:
        recorded = {k: np.asarray(rec[k]) for k in ("actions", "plug_pos", "plug_quat")}
    best, history = optimize_sim_params(default_task_config(), build_kuka_openhand(),
                                        build_subassembly_set(), recorded, n_trials=args.trials,
                                        seed=args.seed, device=device)
    print("best sim params:", best, "loss", min(loss for _, loss in history))
    return best, history


if __name__ == "__main__":
    main()
