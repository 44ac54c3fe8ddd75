"""Materials of the rearrange objects: each episode's per-group material as
per-env model field rows of the object geoms and bodies.

Counterpart of `robogym_tpu/envs/rearrange/materials.py`. A material is a
jsonnet file in `MATERIAL_DIR` whose `geom` object may set `friction` (3
numbers in a string), `solref` (2), `margin` and `density`; what it leaves
out keeps the compiled value (friction the compiler's default, density
1000). `MaterialTable` stacks the materials' rows once; `model_fields`
gathers them for each env's (B, O) material index.

`MATERIAL_DIR` is read from `ROBOGYM_TORCH_MATERIALS` when the module is
imported, as the JAX module reads its directory; by default it is the
stand-in materials committed in `robogym_torch/worlds/materials/`.
"""

from __future__ import annotations

import glob
import os
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np
import torch

from robogym_torch.mjcf.model import Model
from robogym_torch.utils import jsonnet

MATERIAL_DIR = os.environ.get(
    "ROBOGYM_TORCH_MATERIALS",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "worlds", "materials"))

# the compiler's defaults that a material leaves in place
_DEFAULT_DENSITY = 1000.0
_DEFAULT_FRICTION = (1.0, 0.005, 0.0001)


def load_all_materials() -> List[str]:
    """The names of every material jsonnet in `MATERIAL_DIR`, sorted."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(MATERIAL_DIR, "*.jsonnet")))


@lru_cache()
def load_material_args(material_name: str) -> dict:
    """One material jsonnet, evaluated."""
    return jsonnet.evaluate_file(os.path.join(MATERIAL_DIR, f"{material_name}.jsonnet"))


def _parse_vec(s, n: int) -> np.ndarray:
    v = np.array([float(x) for x in str(s).split()], np.float64)
    if len(v) != n:
        raise ValueError(f"expected {n} components, got {s!r}")
    return v


class MaterialTable:
    """The materials' rows, stacked: friction (M, 3), solref (M, 2; 0 where
    the material leaves it as compiled), margin (M,) and density over the
    compiler's default (M,)."""

    def __init__(self, material_names: Sequence[str]):
        self.names = list(material_names)
        fric, solref, margin, dens = [], [], [], []
        for name in self.names:
            g: Dict = load_material_args(name).get("geom", {})
            fric.append(_parse_vec(g["friction"], 3) if "friction" in g
                        else np.asarray(_DEFAULT_FRICTION))
            solref.append(_parse_vec(g["solref"], 2) if "solref" in g else np.zeros(2))
            margin.append(float(g.get("margin", 0.0)))
            dens.append(float(g.get("density", _DEFAULT_DENSITY)) / _DEFAULT_DENSITY)
        self.friction = np.stack(fric)
        self.solref = np.stack(solref)
        self.margin = np.asarray(margin)
        self.density_ratio = np.asarray(dens)

    def draw(self, gen: torch.Generator, B: int, O: int, device=None) -> torch.Tensor:
        """(B, O) a material index for each of B envs' O object groups."""
        return torch.randint(0, len(self.names), (B, O), generator=gen, device=device)

    def model_fields(self, m: Model, object_geom_ids: np.ndarray, object_body_ids: np.ndarray,
                     mat_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-env model fields for each env's (B, O) object material index:
        the objects' geom friction, solref (the compiled one where the
        material sets none) and margin, and their bodies' mass and inertia
        scaled by the density ratio at fixed geometry."""
        B = mat_idx.shape[0]
        dev = m.geom_friction.device
        gids = torch.as_tensor(np.asarray(object_geom_ids), device=dev)
        bids = torch.as_tensor(np.asarray(object_body_ids), device=dev)

        def rows(table, like):
            return torch.as_tensor(table, dtype=like.dtype, device=dev)[mat_idx]

        def per_env(x):
            return x.expand((B,) + tuple(x.shape)).clone()

        fric = rows(self.friction, m.geom_friction)
        sref = rows(self.solref, m.geom_solref)
        dr = rows(self.density_ratio, m.body_mass)
        out = {k: per_env(getattr(m, k)) for k in ("geom_friction", "geom_solref", "geom_margin",
                                                   "body_mass", "body_inertia")}
        out["geom_friction"][:, gids] = fric
        out["geom_solref"][:, gids] = torch.where((sref != 0.0).any(-1, keepdim=True), sref,
                                                  m.geom_solref[gids])
        out["geom_margin"][:, gids] = rows(self.margin, m.geom_margin)
        out["body_mass"][:, bids] = out["body_mass"][:, bids] * dr
        out["body_inertia"][:, bids] = out["body_inertia"][:, bids] * dr[..., None]
        return out
