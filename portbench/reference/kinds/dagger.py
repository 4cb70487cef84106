"""DAgger (`student_dagger_*`): the β-mixed rollout of the frozen teacher and
the student, the normalizers, the reservoir's slots and the action loss on
the rows the program drew.

The student block names the modalities with the port's own flags
(`use_obs`, `use_tactile`, `use_img`, `use_seg`, `use_pcl`; the reference's
defaults: obs on, the others off) and its output with `only_bc` (a tanh
action, or a latent injected into the teacher's actor). The student reads
each modality it uses from the env's queues, as the port's `_student_inputs`
prepares them; a sample stores the frames it reads, and the reservoir keeps
frames in float16.
"""

from __future__ import annotations

import torch

from .. import algo, nets
from ..frozen.sensors.camera import SEG_PLUG, SEG_SOCKET

FRAMES = ("tactile", "img", "seg", "pcl")


def uses(s: dict, modality: str) -> bool:
    return bool(s.get(f"use_{modality}", modality == "obs"))


def stored_frames(s: dict) -> list:
    """The frame queues a sample stores: those the student reads, and the
    segmentation wherever the depth image is read (it masks the image)."""
    return [k for k in FRAMES if uses(s, k) or (k == "seg" and uses(s, "img"))]


def student_inputs(s: dict, obs_rms, pcl_rms, student_obs, frames: dict) -> dict:
    """The student's inputs from the raw student obs and the frame queues
    ([N, T, ...], as float): the obs normalized; the tactile frames as they
    are; the depth frames masked to plug and socket pixels when the
    segmentation is read too; the last segmentation frame as {plug, socket}
    masks; the last point cloud normalized per point."""
    inp = {}
    if uses(s, "obs"):
        inp["obs"] = algo.rms_norm(obs_rms, student_obs)
    if uses(s, "tactile"):
        inp["tactile"] = frames["tactile"]
    if uses(s, "img"):
        img = frames["img"]
        if uses(s, "seg"):
            img = img * ((frames["seg"] == SEG_PLUG) | (frames["seg"] == SEG_SOCKET)).to(img.dtype)
        inp["img"] = img
    if uses(s, "seg"):
        last = frames["seg"][:, -1]
        inp["seg"] = torch.stack([(last == SEG_PLUG).float(), (last == SEG_SOCKET).float()], dim=-1)[:, None]
    if uses(s, "pcl"):
        p = frames["pcl"]
        inp["pcl"] = algo.rms_norm(pcl_rms, p[:, -1] if p.ndim == 4 else p)
    return inp


def _injector(teacher: dict, student_obs):
    """The port's latent path: the frozen teacher's actor over the student obs
    (normalized by the teacher's obs normalizer) ⊕ the student's latent,
    clipped to [-1, 1]."""
    tc, tw = teacher["block"], teacher["weights"]
    return lambda z: torch.clamp(nets.kind(tc).actor(tw, tc, algo.rms_norm(teacher["obs_rms"], student_obs), z),
                                 -1.0, 1.0)


def tiny(cfg: dict, horizon: int, mini_epochs: int):
    cfg["dagger"].update(horizon=horizon, mini_epochs=mini_epochs, replay_size=64)


def policy_outputs(cap: dict, t: int) -> dict:
    return {"t_actions": cap["traj"][t]["t_actions"], "latent_gt": cap["traj"][t]["latent_gt"],
            "s_actions": cap["s_actions"][t]}


def roll(cap, cfg, mix, env, dev, steps):
    s, d, tc = cfg["student"], cfg["dagger"], cfg["teacher"]
    snet, tnet = nets.kind(s), nets.kind(tc)
    td = cap["teacher"]
    teacher = {"block": tc, "weights": {k: v.to(dev) for k, v in td["weights"].items()},
               "obs_rms": algo.RMS(*[x.to(dev) for x in td["obs_rms"]]),
               "priv_rms": algo.RMS(*[x.to(dev) for x in td["priv_rms"]])}
    tw = teacher["weights"]
    w = {k: v.to(dev) for k, v in cap["weights"].items()}
    n = int(mix["envs"])
    stud_rms0, pcl_rms0 = algo.rms_init((s["obs_dim"],), dev), algo.rms_init((3,), dev)
    frames = stored_frames(s)
    keys = ("obs", "student_obs", "t_actions", "latent_gt", *frames)
    traj = {k: torch.stack([cap["traj"][t][k] for t in range(len(cap["traj"]))]).to(dev) for k in keys}
    post, policy = {}, {}
    for t in steps:
        pre = env.state(cap["states"][t])
        priv = env.priv(pre)
        t_out = tnet.forward(tw, tc, {"obs": algo.rms_norm(teacher["obs_rms"], pre.obs_queue),
                                      "priv": algo.rms_norm(teacher["priv_rms"], priv)})
        t_actions = tnet.act(t_out, tc)
        queues = {k: getattr(pre, f"{k}_queue") for k in frames}
        inputs = student_inputs(s, stud_rms0, pcl_rms0, pre.obs_stud_queue, {k: q.float() for k, q in queues.items()})
        s_actions = snet.act(snet.forward(w, s, inputs), s, _injector(teacher, pre.obs_stud_queue))
        agent_steps = cap["agent_steps"] + t * n
        beta = min(max(1.0 - agent_steps / d["beta_anneal_steps"], 0.0), 1.0)
        if agent_steps < d["teacher_only_steps"] and not uses(s, "tactile"):
            actions = t_actions
        else:
            coins = torch.rand((n, 1), generator=algo.generator(cap["train_gen"][t], dev), device=dev)
            actions = torch.where(coins < beta, t_actions, s_actions)
        post[t], _ = env.step(pre, actions, cap["gen"][t])
        policy[t] = {"t_actions": t_actions, "latent_gt": t_out[3], "s_actions": s_actions}
        traj["obs"][t], traj["student_obs"][t] = pre.obs_queue, pre.obs_stud_queue
        traj["t_actions"][t], traj["latent_gt"][t] = t_actions, t_out[3]
        for k, q in queues.items():
            traj[k][t] = q
    return {"post": post, "policy": policy, "traj": traj, "weights": w, "teacher": teacher}


def update(cap, cfg, mix, dev, roll, n):
    s, d = cfg["student"], cfg["dagger"]
    if not d["replay_size"] or cap["agent_steps"] != 0:
        raise ValueError("the reference follows the first epoch's draws from an empty reservoir")
    snet = nets.kind(s)
    traj, w, teacher = roll["traj"], roll["weights"], roll["teacher"]
    n_envs = int(mix["envs"])
    stud_rms = algo.rms_update(algo.rms_init((s["obs_dim"],), dev), traj["student_obs"])
    pcl_rms = algo.rms_init((3,), dev)
    if uses(s, "pcl"):
        pcl_rms = algo.rms_update(pcl_rms, traj["pcl"].reshape(-1, 3))
    b = traj["obs"].shape[0] * n_envs
    batch = {k: v.reshape((b,) + tuple(v.shape[2:])) for k, v in traj.items()}
    frames = stored_frames(s)
    for k in frames:
        batch[k] = batch[k].half().float()          # the reservoir keeps frames in float16
    k_a = d["replay_size"] // 2 if d["replay_stratify"] else 0
    k_b = d["replay_size"] - k_a
    slot_b = algo.reservoir_rows(0, cap["res_u"].to(dev), k_b)
    slot_a = algo.reservoir_rows(0, cap["res_u_a"].to(dev), k_a) if k_a else {}
    rows = torch.stack(cap["rows"])
    mbs = []
    for j in range(n):
        drawn = rows[j // rows.shape[1]][j % rows.shape[1]].tolist()
        idx = torch.tensor([slot_a[r] if r < k_a else slot_b[r - k_a] for r in drawn], device=dev)
        mbs.append({k: v[idx] for k, v in batch.items()})
    latent_coef = 0.0 if s.get("only_bc", False) else d.get("latent_loss_coef", 0.0)

    def loss_of(wp, m):
        inputs = student_inputs(s, stud_rms, pcl_rms, m["student_obs"], {k: m[k] for k in frames})
        pred = snet.forward(wp, s, inputs)
        actions = snet.act(pred, s, _injector(teacher, m["student_obs"]))
        wz = torch.ones(actions.shape[-1], device=dev)
        wz[2] = d["action_z_weight"]
        loss = torch.mean(wz * (actions - m["t_actions"]) ** 2)
        if latent_coef > 0:
            loss = loss + latent_coef * torch.mean((pred - m["latent_gt"]) ** 2)
        return loss

    return {"params": w, "loss_of": loss_of, "lr": d["learning_rate"], "grad_norm": d["grad_norm"],
            "minibatches": mbs}
