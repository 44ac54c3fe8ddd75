"""The mixture rearrange env (robogym's envs/rearrange/mixture.py): each
episode's objects drawn from a mixture of envstate datasets, each drawing
meshes from object datasets.

Counterpart of `robogym_tpu/envs/rearrange/mixture.py`. The datasets come
from `{"function": "module:fn", "args": {...}}` configs
(`utils/env_utils.get_function`, `robogym.` resolving under
`robogym_torch.`); every object dataset's meshes go into one bank under
"<dirname>/<object>", and each envstate dataset reduces to a weight per
candidate. A reset draws each env's dataset from `dataset_sampling_config`
("ds", (B,)), then each slot's candidate from that dataset's weights
("cand", (B, O)); a candidate of weight 0 is never drawn. The JAX package
draws both by `jax.random.categorical` over the logits log(max(w,
1e-12)).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import mesh as mesh_lib
from robogym_torch.mjcf.model import Model
from robogym_torch.utils.env_utils import get_function
from robogym_torch.worlds import rearrange_mesh_family_like

_LOCAL_MESH = "robogym.envs.rearrange.datasets.objects.local_mesh:create"
_RANDOM = "robogym.envs.rearrange.datasets.envstates.random:create"
DEFAULT_OBJECT_CONFIG = {
    "ycb": {"function": _LOCAL_MESH, "args": {"mesh_dirname": "ycb"}},
    "geom": {"function": _LOCAL_MESH, "args": {"mesh_dirname": "geom"}},
}
DEFAULT_DATASET_CONFIG = {
    "ycb_dataset": {"function": _RANDOM, "args": {"object_sample_prob": {"ycb": 1.0}}},
    "geom_dataset": {"function": _RANDOM, "args": {"object_sample_prob": {"geom": 1.0}}},
    "mixed_dataset": {"function": _RANDOM,
                      "args": {"object_sample_prob": {"ycb": 0.5, "geom": 0.5}}},
}
DEFAULT_SAMPLING_CONFIG = {"ycb_dataset": 0.3, "geom_dataset": 0.3, "mixed_dataset": 0.4}


def datasets(object_config=None, dataset_config=None):
    """(object datasets, envstate datasets, merged candidates
    {"<dirname>/<object>": files}) of the configs (by default the JAX
    package's)."""
    objects = {n: get_function(c)() for n, c in (object_config or DEFAULT_OBJECT_CONFIG).items()}
    envstates = {n: get_function(c)()
                 for n, c in (dataset_config or DEFAULT_DATASET_CONFIG).items()}
    merged: Dict[str, List[str]] = {}
    for ds in objects.values():
        for obj, files in ds.mesh_files.items():
            merged[f"{ds.mesh_dirname}/{obj}"] = files
    return objects, envstates, merged


class MixtureRearrangeEnv(mesh_lib.MeshRearrangeEnv):
    """The mesh env over a mixture of datasets (module docstring):
    `dataset_names` (D,) in sorted order, `dataset_probs` (D,) and
    `candidate_weights` (D, C) over the bank's candidates."""

    def __init__(self, constants: mesh_lib.MeshRearrangeEnvConstants,
                 parameters: blocks_lib.RearrangeEnvParameters, model: Model,
                 bank: mesh_lib.MeshObjectBank, object_datasets, envstate_datasets,
                 dataset_sampling_config=None, solver_model: Optional[Model] = None,
                 seed: int = 0):
        super().__init__(constants, parameters, model, bank, solver_model, seed)
        sampling = dataset_sampling_config or DEFAULT_SAMPLING_CONFIG
        self.dataset_names = sorted(envstate_datasets)
        self.candidate_weights = np.stack([
            np.asarray(envstate_datasets[n].candidate_weights(object_datasets,
                                                              list(self.bank.names)))
            for n in self.dataset_names])
        probs = np.asarray([sampling.get(n, 0.0) for n in self.dataset_names])
        self.dataset_probs = probs / probs.sum()

    def draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        """The blocks env's reset draws, each env's dataset "ds" (n,) and
        each slot's candidate "cand" (n, O) from that dataset's weights."""
        dev = self.device
        probs = torch.as_tensor(self.dataset_probs, dtype=torch.float64, device=dev)
        weights = torch.as_tensor(self.candidate_weights, dtype=torch.float64, device=dev)
        ds = torch.multinomial(probs.expand(n, -1), 1, generator=self.generator)[:, 0]
        cand = torch.multinomial(weights[ds], self.max_num_objects, replacement=True,
                                 generator=self.generator)
        return dict(blocks_lib.BlocksRearrangeEnv.draw_reset(self, n), ds=ds, cand=cand)

    def _reset_model_fields(self, draws: Dict[str, torch.Tensor], batch: int):
        """The bank's rows of the drawn candidates and the colour groups
        (mixture.py:102-146: always the groups' colours)."""
        group_ids, colors = self.sample_object_groups(draws["lam_u"], draws["gumbel"],
                                                      draws["color_u"])
        return self._fields_for_candidates(draws["cand"].to(torch.long), group_ids, colors,
                                           batch)


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> MixtureRearrangeEnv:
    """The mixture env on `device` (the card unless the caller asks for the
    CPU), as the JAX package's `make_env(constants, parameters)` builds it:
    the constants' `object_config`, `dataset_config` and
    `dataset_sampling_config` (by default the JAX package's), on the
    compiled `worlds` (by default the `rearrange_mesh_family_like` mixture
    world, 8 mesh slots)."""
    cst_kw = dict(constants or {})
    object_config = cst_kw.pop("object_config", None)
    dataset_config = cst_kw.pop("dataset_config", None)
    sampling = cst_kw.pop("dataset_sampling_config", None)
    cst, par = blocks_lib.configs(cst_kw, parameters,
                                  constants_cls=mesh_lib.MeshRearrangeEnvConstants)
    objects, envstates, merged = datasets(object_config, dataset_config)
    bank = mesh_lib.MeshObjectBank.build(merged, normalized_mesh_size=cst.normalized_mesh_size)
    worlds = worlds or blocks_lib.load_worlds(
        cst, par, device, main=rearrange_mesh_family_like.SNAPSHOTS["mixture"])
    worlds = {k: v for k, v in worlds.items() if k != "settle_model"}
    return MixtureRearrangeEnv(cst, par, bank=bank, object_datasets=objects,
                               envstate_datasets=envstates, dataset_sampling_config=sampling,
                               seed=seed, **worlds)
