"""The local-mesh object dataset (robogym's
envs/rearrange/datasets/objects/local_mesh.py): a named pool of mesh
objects from one mesh directory, which envstate datasets and the mixture
env draw from.

Counterpart of `robogym_tpu/envs/rearrange/datasets/objects/local_mesh.py`,
which scans `assets/stls/<mesh_dirname>`. Those assets are not part of this
repository: a `mesh_dirname` of `MESH_DIRS` resolves to its stand-in
directory, any other to the directory it names.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from robogym_torch.worlds import rearrange_mesh_family_like, rearrange_ycb_like

MESH_DIRS = {"ycb": rearrange_ycb_like.MESH_DIR, "geom": rearrange_mesh_family_like.GEOM_DIR,
             "chess": rearrange_mesh_family_like.CHESS_DIR}


@dataclasses.dataclass(frozen=True)
class LocalMeshObjectDataset:
    name: str
    mesh_dirname: str
    mesh_files: Dict[str, List[str]]

    @property
    def object_names(self):
        return sorted(self.mesh_files)


def create(mesh_dirname: str, name: str = "",
           mesh_names: Optional[List[str]] = None) -> LocalMeshObjectDataset:
    """The dataset of the meshes under `mesh_dirname` (`MESH_DIRS`), kept to
    `mesh_names` where given."""
    from robogym_torch.envs.rearrange.mesh import find_meshes_by_dirname

    files = find_meshes_by_dirname(MESH_DIRS.get(mesh_dirname, os.path.abspath(mesh_dirname)))
    if mesh_names is not None:
        files = {k: v for k, v in files.items() if k in mesh_names}
    return LocalMeshObjectDataset(name=name or mesh_dirname, mesh_dirname=mesh_dirname,
                                  mesh_files=files)
