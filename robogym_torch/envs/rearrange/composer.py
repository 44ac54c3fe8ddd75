"""The composer rearrange env (robogym's envs/rearrange/composer.py): each
object a random composition of up to `max_geoms_per_object` mesh
sub-geoms attached at random offsets.

Counterpart of `robogym_tpu/envs/rearrange/composer.py`. The world holds
each object slot as one free body of `max_geoms_per_object` mesh geoms
(`object{i}`, the root, then `object{i}:g{k}`), each owning its mesh, and
each episode's composition is data. A reset draws per slot and sub-geom a
candidate ("cand", (B, O, K)), per slot the number of active sub-geoms in
[1, K] ("num_geoms", (B, O)) and the attachment offsets ("off_u", (B, O,
K, 3) uniform in [0, 1), mapped to [-r, r) with r = `attachment_radius`
x `normalized_mesh_size`; the root's offset is 0). An inactive sub-geom
takes `tiny`, a 1 mm box of 8 verts appended to the bank, at the body
origin. Each env's model fields: the sub-geoms' hulls
(`mesh_convex_vert`, `mesh_convex_mask`) and offsets (`geom_pos`, each
env's own: the physics places each sub-geom by it), the body's mass (the
sub-hulls' sum) and diagonal inertia about its origin (each sub-hull's
principal inertia plus its parallel-axis term), a zero `body_ipos`, the
root's `geom_size` set to the composition's half-span and every sub-geom's
colour its slot's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import mesh as mesh_lib
from robogym_torch.envs.rearrange import simulation as sim_lib
from robogym_torch.mjcf import xml_tools
from robogym_torch.mjcf.compiler import compile_xml
from robogym_torch.mjcf.model import Model
from robogym_torch.mjcf.xml_tools import MjcfXML
from robogym_torch.worlds import rearrange_mesh_family_like, rearrange_ycb_like


@dataclasses.dataclass(frozen=True)
class ComposerEnvConstants(mesh_lib.MeshRearrangeEnvConstants):
    max_geoms_per_object: int = 3
    # the sub-geoms' attachment offsets, relative to normalized_mesh_size
    attachment_radius: float = 0.6


def _tiny_row(bank: mesh_lib.MeshObjectBank) -> Dict[str, np.ndarray]:
    """The placeholder candidate of inactive sub-geoms: the 8 corners of a
    1 mm box, padded to the bank's verts, mass 1e-6, inertia 1e-10."""
    V = bank.hull_vert.shape[1]
    vert = np.zeros((1, V, 3), np.float32)
    vert[0, :8] = np.asarray([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                              for sz in (-1, 1)]) * 1e-3
    return dict(hull_vert=vert, hull_mask=(np.arange(V) < 8)[None].astype(np.float32),
                mass=np.asarray([1e-6]), inertia=np.asarray([[1e-10] * 3]),
                iquat=np.asarray([[1.0, 0.0, 0.0, 0.0]]), bbox_half=np.asarray([[1e-3] * 3]))


class ComposerRearrangeEnv(mesh_lib.MeshRearrangeEnv):
    """Composed objects (module docstring); `tiny_idx` is the placeholder's
    bank row, after the C real candidates."""

    @staticmethod
    def _compile_world(constants: "ComposerEnvConstants", parameters, device,
                       build_world_xml=sim_lib.build_blocks_world_xml,
                       mesh_files: Optional[Dict[str, List[str]]] = None) -> Model:
        """The composer's main world (composer.py `_compile_world`): the world
        with no blocks plus `max_num_objects` slots of `max_geoms_per_object`
        mesh sub-geoms each (`object{i}`, `object{i}:g{k}`), every sub-geom the
        first STL of the first candidate by name in `mesh_files`, with the
        contact budgets of the slots and their extra sub-geoms; for
        `blocks.compile_worlds`."""
        sp = parameters.simulation_params
        first = sorted(mesh_files)[0]
        rel = os.path.relpath(mesh_files[first][0],
                              os.path.join(xml_tools.assets_dir(mesh_files[first][0]), "stls"))
        K = constants.max_geoms_per_object
        xml = build_world_xml(0, robot_control_params=parameters.robot_control_params,
                              mujoco_timestep=constants.mujoco_timestep)
        for i in range(sp.max_num_objects):
            geoms = "\n".join(
                f'<geom name="object{i}{"" if k == 0 else f":g{k}"}" type="mesh" '
                f'mesh="object{i}:mesh{k}" rgba="0.8 0.4 0.1 1.0" density="1000"/>'
                for k in range(K))
            assets = "\n".join(f'<mesh name="object{i}:mesh{k}" file="{rel}"/>' for k in range(K))
            xml.append(MjcfXML.from_string(f"""
            <mujoco>
              <asset>{assets}</asset>
              <worldbody>
                <body name="object{i}" pos="0.0 0.0 0.0">
                  {geoms}
                  <joint name="object{i}:joint" type="free"/>
                </body>
              </worldbody>
            </mujoco>
            """))
        model = compile_xml(xml, device=device)
        return sim_lib.scale_contact_budgets(model, sp.max_num_objects,
                                             sp.max_num_objects * (K - 1))

    def __init__(self, constants: ComposerEnvConstants,
                 parameters: blocks_lib.RearrangeEnvParameters, model: Model,
                 bank: mesh_lib.MeshObjectBank, solver_model: Optional[Model] = None,
                 seed: int = 0):
        super().__init__(constants, parameters, model, bank, solver_model, seed)
        c = self.model.const
        gn = c.names["geom"]
        K = constants.max_geoms_per_object
        sub = [[gn[f"object{i}"]] + [gn[f"object{i}:g{k}"] for k in range(1, K)]
               for i in range(self.max_num_objects)]
        self._sub_geom_ids = np.asarray(sub, np.int64)                     # (O, K)
        self._sub_mesh_ids = np.asarray([[c.geom_dataid[g] for g in row] for row in sub],
                                        np.int64)
        self.tiny_idx = self.bank.num_candidates
        tiny = _tiny_row(self.bank)
        self.bank = dataclasses.replace(self.bank, names=self.bank.names + ("tiny",), **{
            k: torch.cat([getattr(self.bank, k), torch.as_tensor(
                v, dtype=self.dtype, device=self.device)]) for k, v in tiny.items()})

    def draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        """The blocks env's reset draws and the composition's: "cand" (n, O,
        K) of the C real candidates, "num_geoms" (n, O) in [1, K] and
        "off_u" (n, O, K, 3) uniform in [0, 1)."""
        O, K = self.max_num_objects, self.constants.max_geoms_per_object
        gen, dev = self.generator, self.device
        return dict(blocks_lib.BlocksRearrangeEnv.draw_reset(self, n),
                    cand=torch.randint(0, self.tiny_idx, (n, O, K), generator=gen, device=dev),
                    num_geoms=torch.randint(1, K + 1, (n, O), generator=gen, device=dev),
                    off_u=self._u(n, O, K, 3))

    def _reset_model_fields(self, draws: Dict[str, torch.Tensor], batch: int):
        """(composer.py:140-214): (fields, the compositions' half-spans
        (B, O, 3), group ids (B, O))."""
        cst, bank, dev = self.constants, self.bank, self.device
        O, K = self.max_num_objects, cst.max_geoms_per_object
        active = torch.arange(K, device=dev) < draws["num_geoms"].to(dev)[..., None]   # (B, O, K)
        cand = torch.where(active, draws["cand"].to(torch.long),
                           torch.full_like(draws["cand"], self.tiny_idx, dtype=torch.long))
        # u 2r - r rounded once, as XLA's fused multiply-add in the JAX
        # package's draw rounds it (float64 holds u 2r exactly)
        r = torch.tensor(cst.attachment_radius * cst.normalized_mesh_size, dtype=self.dtype)
        offs = torch.clamp(draws["off_u"].to(torch.float64) * float(2 * r) - float(r),
                           min=-float(r)).to(self.dtype)
        offs = torch.where(active[..., None] & (torch.arange(K, device=dev) > 0)[:, None],
                           offs, torch.zeros_like(offs))                           # (B, O, K, 3)
        sub_m = bank.mass[cand]                                                    # (B, O, K)
        mass = sub_m[..., 0]
        for k in range(1, K):
            mass = mass + sub_m[..., k]
        eye = torch.eye(3, dtype=self.dtype, device=dev)
        r2 = offs[..., 0] ** 2 + offs[..., 1] ** 2 + offs[..., 2] ** 2
        inertia = (bank.inertia[cand][..., None] * eye
                   + sub_m[..., None, None] * (r2[..., None, None] * eye
                                               - offs[..., :, None] * offs[..., None, :]))
        total = inertia[:, :, 0]
        for k in range(1, K):
            total = total + inertia[:, :, k]
        inertia_diag = torch.clamp(torch.diagonal(total, dim1=-2, dim2=-1), min=1e-10)
        span = torch.amax(torch.abs(offs) + bank.bbox_half[cand], dim=2)           # (B, O, 3)
        if cst.use_grey_colors:
            colors = torch.tensor([0.5, 0.5, 0.5, 1.0], dtype=self.dtype,
                                  device=dev).expand(batch, O, 4)
            group_ids = torch.arange(O, device=dev).expand(batch, O)
        else:
            group_ids, colors = self.sample_object_groups(draws["lam_u"], draws["gumbel"],
                                                          draws["color_u"])
        mids = torch.as_tensor(self._sub_mesh_ids.reshape(-1), device=dev)
        gids = torch.as_tensor(self._sub_geom_ids.reshape(-1), device=dev)
        _, bids, root = self._slot_ids()
        flat = cand.reshape(batch, O * K)
        fields = {
            "mesh_convex_vert": self._per_env("mesh_convex_vert", mids, bank.hull_vert[flat],
                                              batch),
            "mesh_convex_mask": self._per_env("mesh_convex_mask", mids, bank.hull_mask[flat],
                                              batch),
            "geom_pos": self._per_env("geom_pos", gids, offs.reshape(batch, O * K, 3), batch),
            "body_mass": self._per_env("body_mass", bids, mass, batch),
            "body_inertia": self._per_env("body_inertia", bids, inertia_diag, batch),
            "body_ipos": self._per_env("body_ipos", bids, torch.zeros((batch, O, 3),
                                                                      device=dev), batch),
            "geom_size": self._per_env("geom_size", root, span, batch),
            "geom_rgba": self._per_env("geom_rgba", gids,
                                       torch.repeat_interleave(colors, K, dim=1), batch),
        }
        return fields, span, group_ids


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             mesh_names: Optional[List[str]] = None,
             mesh_files_by_name: Optional[Dict[str, List[str]]] = None, device="cuda",
             seed: int = 0, worlds: Optional[Dict[str, Model]] = None) -> ComposerRearrangeEnv:
    """The composer env on `device` (the card unless the caller asks for the
    CPU), as the JAX package's `make_env(constants, parameters,
    mesh_names)` builds it: the bank of `mesh_files_by_name` (by default
    the YCB stand-ins of `rearrange_ycb_like.MESH_DIR`) kept to
    `mesh_names` where given, on the compiled `worlds` (by default the
    stand-in's composer world: 8 slots of 3 sub-geoms)."""
    par = dict(parameters or {})
    mesh_names = par.pop("mesh_names", mesh_names)
    cst, par = blocks_lib.configs(constants, par, constants_cls=ComposerEnvConstants)
    files = dict(mesh_files_by_name if mesh_files_by_name is not None
                 else mesh_lib.find_meshes_by_dirname(rearrange_ycb_like.MESH_DIR))
    if mesh_names is not None:
        files = {k: v for k, v in files.items() if k in mesh_names}
    if not files:
        raise ValueError(f"no meshes for {mesh_names}")
    bank = mesh_lib.MeshObjectBank.build(files, normalized_mesh_size=cst.normalized_mesh_size)
    worlds = worlds or blocks_lib.load_worlds(
        cst, par, device, main=rearrange_mesh_family_like.SNAPSHOTS["composer"])
    worlds = {k: v for k, v in worlds.items() if k != "settle_model"}
    return ComposerRearrangeEnv(cst, par, bank=bank, seed=seed, **worlds)
