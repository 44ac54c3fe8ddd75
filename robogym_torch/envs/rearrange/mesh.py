"""The mesh rearrange env: the blocks env over mesh objects whose meshes
each episode draws from a bank of candidates, and the YCB env on it.

Counterpart of `robogym_tpu/envs/rearrange/mesh.py`. The world is compiled
once with `max_num_objects` mesh slots; `MeshObjectBank.build` computes,
for every candidate, its convex hull normalised to `normalized_mesh_size`
(largest half-extent) and centred at its centre of mass, padded to the
compiler's 64 verts, its mass and principal inertia at density 1000, its
principal frame and its bbox half-extents. Each reset draws a candidate
per slot (`draw_reset`'s "cand", with or without replacement) and the
objects' colour groups, and writes the bank's rows into each env's model
fields (`_reset_model_fields`): `mesh_convex_vert` and `mesh_convex_mask`
(the whole mesh table per env, (B, nmesh, 64, 3) and (B, nmesh, 64), as
the JAX env's fields are), `body_mass`, `body_inertia`, `body_iquat`,
`body_ipos` (zero), `geom_size` (the bbox half-extents, which drive the
placement and the broadphase) and `geom_rgba`. Collision, dynamics and
placement read the model with those fields, so no episode recompiles.

`make_env` builds the bank from STL files (by default the YCB-like
stand-ins of `worlds/rearrange_ycb_like.py`) on the compiled world
`worlds=` (by default its snapshot; `_compile_world` with
`blocks.compile_worlds` compiles it).
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import ConvexHull

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import simulation as sim_lib
from robogym_torch.mjcf import mesh as mesh_lib
from robogym_torch.mjcf import xml_tools
from robogym_torch.mjcf.compiler import compile_xml
from robogym_torch.mjcf.xml_tools import MjcfXML
from robogym_torch.mjcf.model import GeomType, Model
from robogym_torch.utils.rotation import _np_mat2quat
from robogym_torch.worlds import rearrange_ycb_like


def find_meshes_by_dirname(root_mesh_dir: str) -> Dict[str, List[str]]:
    """{name -> STL files} under `root_mesh_dir`: each `.stl` file by its
    stem, each directory with STL files by its name (robogym's
    common/utils.py find_meshes_by_dirname)."""
    out: Dict[str, List[str]] = {}
    for entry in sorted(os.listdir(root_mesh_dir)):
        path = os.path.join(root_mesh_dir, entry)
        if path.endswith(".stl"):
            out[os.path.splitext(entry)[0]] = [path]
        elif os.path.isdir(path):
            stls = sorted(glob.glob(os.path.join(path, "*.stl")))
            if stls:
                out[entry] = stls
    return out


@dataclasses.dataclass(frozen=True)
class MeshObjectBank:
    """Padded per-candidate mesh tables, C candidates by name."""

    names: Tuple[str, ...]
    hull_vert: torch.Tensor      # (C, MAXV, 3) zero-padded, centre-of-mass frame
    hull_mask: torch.Tensor      # (C, MAXV)
    mass: torch.Tensor           # (C,)
    inertia: torch.Tensor        # (C, 3) principal body inertia
    iquat: torch.Tensor          # (C, 4) principal frame
    bbox_half: torch.Tensor      # (C, 3) half-extents in the hull frame

    @classmethod
    def build(cls, mesh_files_by_name: Dict[str, List[str]], max_verts: int = 64,
              normalized_mesh_size: float = 0.05, density: float = 1000.0,
              device="cpu", dtype=torch.float32) -> "MeshObjectBank":
        """The bank of the candidates `mesh_files_by_name` (name -> STL
        files, whose points form one hull), sorted by name."""
        rows = {k: [] for k in ("hull", "mask", "mass", "inertia", "iquat", "bbox")}
        names = []
        for name, files in sorted(mesh_files_by_name.items()):
            verts = np.concatenate([mesh_lib.load_stl(f)[0] for f in files], axis=0)
            hull = mesh_lib.convex_hull(verts, max_verts=max_verts)
            half = (hull.max(0) - hull.min(0)) / 2.0
            hull = hull * (normalized_mesh_size / max(half.max(), 1e-9))
            # qhull's simplices are not consistently wound: each is flipped
            # to face away from the centroid for the signed-volume sums
            faces = ConvexHull(hull).simplices.astype(np.int32)
            fa, fb, fc = hull[faces[:, 0]], hull[faces[:, 1]], hull[faces[:, 2]]
            flip = np.einsum("ij,ij->i", np.cross(fb - fa, fc - fa), fa - hull.mean(0)) < 0
            faces[flip] = faces[flip][:, [0, 2, 1]]
            vol, com, inertia = mesh_lib.mesh_volume_com_inertia(hull, faces)
            hull = hull - com
            w, v = np.linalg.eigh(inertia * density)
            if np.linalg.det(v) < 0:
                v[:, 0] *= -1
            pad = np.zeros((max_verts, 3))
            pad[:len(hull)] = hull
            names.append(name)
            rows["hull"].append(pad)
            rows["mask"].append(np.arange(max_verts) < len(hull))
            rows["mass"].append(max(abs(vol), 1e-9) * density)
            rows["inertia"].append(np.maximum(w[::-1].copy(), 1e-10))
            rows["iquat"].append(_np_mat2quat(v[:, ::-1].copy()))
            rows["bbox"].append((hull.max(0) - hull.min(0)) / 2.0)

        def t(k):
            return torch.as_tensor(np.stack(rows[k]).astype(np.float64), dtype=dtype,
                                   device=device)

        return cls(names=tuple(names), hull_vert=t("hull"), hull_mask=t("mask"), mass=t("mass"),
                   inertia=t("inertia"), iquat=t("iquat"), bbox_half=t("bbox"))

    @property
    def num_candidates(self) -> int:
        return len(self.names)

    def to(self, device) -> "MeshObjectBank":
        return dataclasses.replace(self, **{f.name: getattr(self, f.name).to(device)
                                            for f in dataclasses.fields(self) if f.name != "names"})


def make_mesh_object_xml(name: str, stl_path: str, scale: float) -> MjcfXML:
    """One mesh-object slot body, one collision hull per object (robogym's
    common/utils.py make_mesh_object); the mesh file relative to
    `xml_tools.ASSETS_DIR`'s `stls`."""
    rel = os.path.relpath(stl_path, os.path.join(xml_tools.assets_dir(stl_path), "stls"))
    src = f"""
    <mujoco>
      <asset>
        <mesh name="{name}:mesh" file="{rel}" scale="{scale} {scale} {scale}"/>
      </asset>
      <worldbody>
        <body name="{name}" pos="0.0 0.0 0.0">
          <geom name="{name}" type="mesh" mesh="{name}:mesh"
                rgba="0.8 0.4 0.1 1.0" density="1000"/>
          <joint name="{name}:joint" type="free"/>
        </body>
      </worldbody>
    </mujoco>
    """
    return MjcfXML.from_string(src)


@dataclasses.dataclass(frozen=True)
class MeshRearrangeEnvConstants(blocks_lib.RearrangeEnvConstants):
    """(common/mesh.py:31-41)."""

    use_grey_colors: bool = False
    normalize_mesh: bool = True
    normalized_mesh_size: float = 0.05
    sample_with_replacement: bool = True


class MeshRearrangeEnv(blocks_lib.BlocksRearrangeEnv):
    """The blocks env over mesh objects, each episode's meshes drawn from
    `bank` and written into its model fields (module docstring)."""

    def __init__(self, constants: MeshRearrangeEnvConstants,
                 parameters: blocks_lib.RearrangeEnvParameters, model: Model,
                 bank: MeshObjectBank, solver_model: Optional[Model] = None, seed: int = 0,
                 settle_model: Optional[Model] = None):
        self.bank = bank.to(model.device)
        super().__init__(constants, parameters, model, solver_model, seed, settle_model)
        c = self.model.const
        self._slot_mesh_ids = np.asarray([c.geom_dataid[g] for g in self.idx.object_geom_ids],
                                         np.int64)
        if len(set(self._slot_mesh_ids.tolist())) != len(self._slot_mesh_ids):
            raise ValueError("each object slot must own its mesh")
        if not constants.sample_with_replacement and bank.num_candidates < self.max_num_objects:
            raise ValueError(f"{bank.num_candidates} candidates cannot fill "
                             f"{self.max_num_objects} slots without replacement")

    @staticmethod
    def _compile_world(constants, parameters, device,
                       build_world_xml=sim_lib.build_blocks_world_xml,
                       mesh_files: Optional[Dict[str, List[str]]] = None) -> Model:
        """The mesh env's main world (mesh.py `_compile_world`): the world with
        no blocks plus `max_num_objects` mesh slots, each the first STL of the
        first candidate by name in `mesh_files`, with that many objects'
        contact budgets."""
        sp = parameters.simulation_params
        first = sorted(mesh_files)[0]
        xml = build_world_xml(0, robot_control_params=parameters.robot_control_params,
                              mujoco_timestep=constants.mujoco_timestep)
        for i in range(sp.max_num_objects):
            xml.append(make_mesh_object_xml(f"object{i}", mesh_files[first][0], 1.0))
        model = compile_xml(xml, device=device)
        return sim_lib.scale_contact_budgets(model, sp.max_num_objects)

    def _check_objects(self) -> None:
        types = np.asarray(self.model.const.geom_type)[self.idx.object_geom_ids]
        if not (types == GeomType.MESH).all():
            raise ValueError("the model's object slots must be meshes")

    def draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        """The blocks env's reset draws and each env's candidates `cand`
        (n, O) (without replacement: the first O of a random permutation)."""
        C, O = self.bank.num_candidates, self.max_num_objects
        if self.constants.sample_with_replacement:
            cand = torch.randint(0, C, (n, O), generator=self.generator, device=self.device)
        else:
            cand = torch.argsort(self._u(n, C), dim=-1)[:, :O]
        return dict(super().draw_reset(n), cand=cand)

    def _reset_model_fields(self, draws: Dict[str, torch.Tensor], batch: int):
        """Each episode's model fields from its candidates `draws["cand"]`
        (B, O) and its colour groups (mesh.py:230-271): (fields, the
        objects' half-sizes (B, O, 3), group ids (B, O))."""
        O = self.max_num_objects
        if self.constants.use_grey_colors:
            colors = torch.tensor([0.5, 0.5, 0.5, 1.0], dtype=self.dtype,
                                  device=self.device).expand(batch, O, 4)
            group_ids = torch.arange(O, device=self.device).expand(batch, O)
        else:
            group_ids, colors = self.sample_object_groups(draws["lam_u"], draws["gumbel"],
                                                          draws["color_u"])
        return self._fields_for_candidates(draws["cand"].to(torch.long), group_ids, colors, batch)

    def _per_env(self, field: str, rows: torch.Tensor, values: torch.Tensor, batch: int):
        """Model field `field` for `batch` envs, its rows `rows` each env's
        `values` (B, len(rows), ...)."""
        v = getattr(self.model, field)
        out = v.expand((batch,) + tuple(v.shape)).clone()
        out[:, rows] = values.to(out.dtype)
        return out

    def _slot_ids(self):
        """The object slots' mesh, body and geom ids on the device."""
        dev = self.device
        return (torch.as_tensor(self._slot_mesh_ids, device=dev),
                torch.as_tensor(np.asarray(self.idx.object_body_ids, np.int64), device=dev),
                torch.as_tensor(np.asarray(self.idx.object_geom_ids, np.int64), device=dev))

    def _fields_for_candidates(self, cand: torch.Tensor, group_ids, colors, batch: int):
        """The bank's rows of the candidates `cand` (B, O) written into each
        env's model fields, with the objects' colours (B, O, 4): (fields,
        half-sizes (B, O, 3), group_ids)."""
        O, bank = self.max_num_objects, self.bank
        mids, bids, gids = self._slot_ids()
        per_env = functools.partial(self._per_env, batch=batch)
        fields = {
            "mesh_convex_vert": per_env("mesh_convex_vert", mids, bank.hull_vert[cand]),
            "mesh_convex_mask": per_env("mesh_convex_mask", mids, bank.hull_mask[cand]),
            "body_mass": per_env("body_mass", bids, bank.mass[cand]),
            "body_inertia": per_env("body_inertia", bids, bank.inertia[cand]),
            "body_iquat": per_env("body_iquat", bids, bank.iquat[cand]),
            "body_ipos": per_env("body_ipos", bids, torch.zeros((batch, O, 3),
                                                                device=self.device)),
            "geom_size": per_env("geom_size", gids, bank.bbox_half[cand]),
            "geom_rgba": per_env("geom_rgba", gids, colors),
        }
        return fields, bank.bbox_half[cand], group_ids


class YcbRearrangeEnv(MeshRearrangeEnv):
    """(ycb.py:43-91): the candidates are the YCB model directories."""


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             mesh_names: Optional[List[str]] = None,
             mesh_files_by_name: Optional[Dict[str, List[str]]] = None, device="cuda",
             seed: int = 0, worlds: Optional[Dict[str, Model]] = None) -> YcbRearrangeEnv:
    """The YCB env on `device` (the card unless the caller asks for the
    CPU), as the JAX package's `make_env(constants, parameters,
    mesh_names)` builds it, its draws seeded by `seed`: the bank of
    `mesh_files_by_name` (by default the stand-in candidates under
    `rearrange_ycb_like.MESH_DIR`), kept to `mesh_names` where given, on the
    compiled `worlds` ({"model", "solver_model"}; by default the
    `rearrange_ycb_like` snapshot, 8 mesh slots)."""
    par = dict(parameters or {})
    mesh_names = par.pop("mesh_names", mesh_names)
    cst, par = blocks_lib.configs(constants, par, constants_cls=MeshRearrangeEnvConstants)
    files = dict(mesh_files_by_name if mesh_files_by_name is not None
                 else find_meshes_by_dirname(rearrange_ycb_like.MESH_DIR))
    if mesh_names is not None:
        files = {k: v for k, v in files.items() if k in mesh_names}
    if not files:
        raise ValueError(f"no meshes for {mesh_names}")
    bank = MeshObjectBank.build(files, normalized_mesh_size=cst.normalized_mesh_size)
    worlds = worlds or blocks_lib.load_worlds(cst, par, device, main=rearrange_ycb_like.SNAPSHOT)
    worlds = {k: v for k, v in worlds.items() if k != "settle_model"}
    return YcbRearrangeEnv(cst, par, bank=bank, seed=seed, **worlds)
