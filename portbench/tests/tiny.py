"""A cell cut to a size the CPU runs in seconds, for the tests."""

import copy

import torch

from portbench import run
from portbench.reference import kinds


def cut(cfg: dict, mix: dict, envs: int = 4, horizon: int = 4, mini_epochs: int = 4):
    """Copies of a configuration and a traffic mix at the tiny size, cut by the
    algorithm kind's own hook."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    mix["envs"] = envs
    kinds.of(cfg).tiny(cfg, horizon, mini_epochs)
    return cfg, mix


def cell(name: str, envs: int = 4, horizon: int = 4, mini_epochs: int = 4, root: str = run.ROOT):
    bench, spec, cfg, mix = run.cell_spec(name, root=root)
    return (bench, spec, *cut(cfg, mix, envs, horizon, mini_epochs))


CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def written(tmp_path, config: dict, traffic: str, **size):
    """A cell of a new configuration that arrives as data alone: its file
    written under a copy of the benchmark's configurations and traffic
    mixes, with its entry and a workload `<name>.<traffic>` added to a copy
    of BENCHMARK.json; the cell cut to the tiny size."""
    import json
    import os
    import shutil

    for part in ("configs", "traffic"):
        shutil.copytree(os.path.join(run.ROOT, "portbench", part), tmp_path / "portbench" / part)
    name = config["name"]
    (tmp_path / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(config))
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": config["source"], "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": f"{name}.{traffic}", "config": name, "traffic": traffic, "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell(f"{name}.{traffic}", root=str(tmp_path), **size)


def config(name: str) -> dict:
    """A copy of a configuration of the benchmark, by name."""
    import json
    import os

    with open(os.path.join(run.ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def obs_only_config() -> dict:
    """`student_dagger_r5` with the obs token alone: no point cloud, one
    token, r5's widths."""
    c = config("student_dagger_r5")
    c["name"] = "student_dagger_obs"
    s = c["student"]
    s.update(use_pcl=False, num_tokens=1)
    del s["pcl_points"], s["pointnet_units"]
    return c


LATENT_KIND = "latent_student_of_a_test"


def latent_config() -> dict:
    """`student_dagger_r5` with a latent output injected into the teacher's
    actor, as a network kind that no harness file names (`latent_kind`)."""
    c = config("student_dagger_r5")
    c["name"] = "student_dagger_latent"
    c["student"].update(kind=LATENT_KIND, only_bc=False, out_dim=8)
    return c


def latent_kind():
    """The module of `LATENT_KIND`, composed from the parts that the
    `multimodal` and `actor_critic_split` kinds expose; register it under
    `portbench.reference.nets` in `sys.modules`."""
    import types

    from portbench.reference.nets import actor_critic_split, multimodal as mm

    m = types.ModuleType(f"portbench.reference.nets.{LATENT_KIND}")
    m.shapes = lambda s: mm.obs_shapes(s) + mm.pcl_shapes(s) + mm.decoder_shapes(s) + mm.head_shapes(s)
    m.ops = lambda s, cfg: (mm.obs_ops(s) + mm.pcl_ops(s) + mm.decoder_ops(s) + mm.head_ops(s)
                            + actor_critic_split.injected_ops(cfg["teacher"]))
    m.forward = lambda w, s, x: mm.head(w, s, mm.decoder(w, s, [mm.obs_token(w, s, x["obs"]),
                                                                mm.pcl_token(w, s, x["pcl"])]))
    m.act = mm.act
    return m
