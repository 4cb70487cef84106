"""Scene / pose export (reference factory_base.py:597-633 parity).

Port of `isaacgyminsertion_tpu/utils/scene_export.py`, on the port's
`EnvState`. The reference exports the sim scene to USD via IsaacGym's
built-in exporter (`export_scene`, factory_base.py:597-605) and dumps
per-frame body pose arrays (`extract_poses`, factory_base.py:617-632). Here:

  - `export_scene_usda` writes a self-contained USDA (text USD) stage with
    the table, socket and plug prims of one env: the analytic shape families
    map to USD primitives (Cylinder/Cube) with the env's dimensions and world
    transforms, in the JAX package's formatting (the same state gives the
    same bytes).
  - `PoseExtractor` accumulates the robot's body poses (forward kinematics on
    the state's device) and the plug's per frame and saves
    `body_position.npy` / `body_rotation.npy` with the reference's filenames.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _fmt(v) -> str:
    return "(" + ", ".join(f"{float(x):.6f}" for x in v) + ")"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def export_scene_usda(cfg, model, subs, env_state, path: str, env: int = 0) -> str:
    """Write a USDA stage of one env's current scene. Returns the path."""
    from ..assets import SOCKET_PLATE_HX, SOCKET_PLATE_HY

    params = env_state.params
    phys = env_state.phys
    kind = int(torch.argmax(params.kind_onehot[env]))
    is_round = kind == 0

    plug_pos = _host(phys.plug_pos[env])
    plug_quat = _host(phys.plug_quat[env])  # xyzw
    sock_pos = _host(params.socket_pos[env])
    sock_quat = _host(params.socket_quat[env])
    hx = float(params.plug_hx[env])
    hy = float(params.plug_hy[env])
    length = float(params.plug_length[env])
    sh = float(params.socket_height[env])
    th = float(params.table_height[env])

    def orient(q_xyzw):
        # USD quatf is (w, x, y, z)
        return f"({q_xyzw[3]:.6f}, {q_xyzw[0]:.6f}, {q_xyzw[1]:.6f}, {q_xyzw[2]:.6f})"

    if is_round:
        plug_geom = (f'        def Cylinder "geom" {{\n'
                     f"            double radius = {hx:.6f}\n"
                     f"            double height = {length:.6f}\n"
                     f'            token axis = "Z"\n'
                     f"            double3 xformOp:translate = (0, 0, {length / 2:.6f})\n"
                     f'            uniform token[] xformOpOrder = ["xformOp:translate"]\n'
                     f"        }}\n")
    else:
        plug_geom = (f'        def Cube "geom" {{\n'
                     f"            double size = 1\n"
                     f"            double3 xformOp:scale = {_fmt([2 * hx, 2 * max(hy, 1e-4), length])}\n"
                     f"            double3 xformOp:translate = (0, 0, {length / 2:.6f})\n"
                     f'            uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:scale"]\n'
                     f"        }}\n")

    usda = (
        '#usda 1.0\n(\n    upAxis = "Z"\n    metersPerUnit = 1\n)\n\n'
        'def Xform "World" {\n'
        '    def Cube "table" {\n'
        "        double size = 1\n"
        "        double3 xformOp:scale = (1.0, 1.0, 0.02)\n"
        f"        double3 xformOp:translate = (0.5, 0.0, {th - 0.01:.6f})\n"
        '        uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:scale"]\n'
        "    }\n"
        '    def Xform "socket" {\n'
        f"        double3 xformOp:translate = {_fmt(sock_pos)}\n"
        f"        quatf xformOp:orient = {orient(sock_quat)}\n"
        '        uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:orient"]\n'
        '        def Cube "plate" {\n'
        "            double size = 1\n"
        f"            double3 xformOp:scale = {_fmt([2 * SOCKET_PLATE_HX, 2 * SOCKET_PLATE_HY, sh])}\n"
        f"            double3 xformOp:translate = (0, 0, {sh / 2:.6f})\n"
        '            uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:scale"]\n'
        "        }\n"
        "    }\n"
        '    def Xform "plug" {\n'
        f"        double3 xformOp:translate = {_fmt(plug_pos)}\n"
        f"        quatf xformOp:orient = {orient(plug_quat)}\n"
        '        uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:orient"]\n'
        f"{plug_geom}"
        "    }\n"
        "}\n"
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(usda)
    return path


class PoseExtractor:
    """Per-frame body pose recorder (extract_poses parity: same filenames,
    [T, nb+1 (plug), 3] / [T, nb+1, 4] arrays saved on `save`)."""

    def __init__(self, model):
        self.model = model
        self.positions: list[np.ndarray] = []
        self.rotations: list[np.ndarray] = []

    @torch.no_grad()
    def record(self, env_state, env: int = 0):
        from ..physics.kinematics import forward_kinematics

        fk = forward_kinematics(self.model, env_state.phys.q[env: env + 1])
        pos = torch.cat([fk.body_t[0], env_state.phys.plug_pos[env][None]], 0)
        rotq = torch.cat([fk.body_q[0], env_state.phys.plug_quat[env][None]], 0)
        self.positions.append(_host(pos))
        self.rotations.append(_host(rotq))

    def save(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "body_position.npy"), np.stack(self.positions))
        np.save(os.path.join(out_dir, "body_rotation.npy"), np.stack(self.rotations))
        return out_dir
