"""The random envstate dataset (robogym's
envs/rearrange/datasets/envstates/random.py): env states whose objects are
drawn from object datasets with configured probabilities.

Counterpart of `robogym_tpu/envs/rearrange/datasets/envstates/random.py`:
a dataset reduces to a weight for each candidate of the mixture env's
merged bank; the mixture env draws from those weights at each reset.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class RandomEnvstateDataset:
    name: str
    # object-dataset name -> probability of drawing each object from it
    object_sample_prob: Dict[str, float]

    def candidate_weights(self, object_datasets, bank_names: List[str]) -> List[float]:
        """The weight of each bank candidate ("<dirname>/<object>") under
        this dataset: a dataset's probability shared evenly among its
        objects, 0 for a candidate of no dataset of this one."""
        weights: Dict[str, float] = {}
        for ds_name, prob in self.object_sample_prob.items():
            ds = object_datasets[ds_name]
            for obj in ds.object_names:
                key = f"{ds.mesh_dirname}/{obj}"
                weights[key] = weights.get(key, 0.0) + prob / max(len(ds.object_names), 1)
        return [weights.get(n, 0.0) for n in bank_names]


def create(object_sample_prob: Dict[str, float], name: str = "") -> RandomEnvstateDataset:
    return RandomEnvstateDataset(name=name or "+".join(sorted(object_sample_prob)),
                                 object_sample_prob=dict(object_sample_prob))
