"""PPO (`teacher_ppo`): the Gaussian policy's rollout with the value
bootstrap, GAE, the normalizers and the clipped losses on the permuted
minibatches."""

from __future__ import annotations

import torch

from .. import algo, nets

POLICY_KEYS = ("actions", "neglogp", "values", "mu", "priv")


def tiny(cfg: dict, horizon: int, mini_epochs: int):
    cfg["ppo"].update(horizon=horizon, mini_epochs=mini_epochs)


def policy_outputs(cap: dict, t: int) -> dict:
    return {k: cap["traj"][t][k] for k in POLICY_KEYS}


def roll(cap, cfg, mix, env, dev, steps):
    p, h = cfg["policy"], cfg["ppo"]
    net = nets.kind(p)
    w = {k: v.to(dev) for k, v in cap["weights"].items()}
    obs_rms0, priv_rms0, val_rms0 = algo.rms_init((p["obs_dim"],), dev), algo.rms_init((p["priv_dim"],), dev), \
        algo.rms_init((), dev)
    traj = {k: torch.stack([cap["traj"][t][k] for t in range(len(cap["traj"]))]).to(dev)
            for k in ("obs", "priv", "actions", "neglogp", "values", "rewards", "dones")}
    post, policy = {}, {}
    for t in steps:
        pre = env.state(cap["states"][t])
        priv = env.priv(pre)
        mu, log_std, v_n, _ = net.forward(w, p, {"obs": algo.rms_norm(obs_rms0, pre.obs_queue),
                                                 "priv": algo.rms_norm(priv_rms0, priv)})
        noise = torch.randn(mu.shape, generator=algo.generator(cap["train_gen"][t], dev), device=dev,
                            dtype=mu.dtype)
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
    v_last = algo.rms_unnorm(val_rms0, net.forward(w, p, {"obs": algo.rms_norm(obs_rms0, last.obs_queue),
                                                          "priv": algo.rms_norm(priv_rms0, env.priv(last))})[2])
    return {"post": post, "policy": policy, "traj": traj, "v_last": v_last, "weights": w}


def update(cap, cfg, mix, dev, roll, n):
    p, h = cfg["policy"], cfg["ppo"]
    net = nets.kind(p)
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
    gen = algo.generator(cap["perm_gen"], dev)
    perms = [torch.randperm(b, generator=gen, device=dev) for _ in range((n - 1) // n_mb + 1)]
    mbs = [{k: v[perms[j // n_mb].reshape(n_mb, mb)[j % n_mb]] for k, v in batch.items()} for j in range(n)]

    def loss_of(wp, m):
        mu, log_std, value, _ = net.forward(wp, p, {"obs": algo.rms_norm(obs_rms, m["obs"]),
                                                    "priv": algo.rms_norm(priv_rms, m["priv"])})
        return algo.ppo_loss(mu, log_std, value, m, h)

    return {"params": w, "loss_of": loss_of, "lr": h["learning_rate"], "grad_norm": h["grad_norm"],
            "minibatches": mbs}
