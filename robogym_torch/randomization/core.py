"""The randomizer graph: a host-side registry of ADR parameters, and
batched transforms.

Counterpart of `robogym_tpu/randomization/core.py` (reference
randomization/common.py:96-243 and env.py:45-262). A `Randomizer` is a
host object that carries its ADR-addressable parameters and applies its
distributions to a batch in two steps: `draw(gen, batch)` makes the
samples of the batch from a `torch.Generator`, and `apply(target, draws,
values)` turns them into the batch's new target, with `values` the
randomizer's current parameter vector (`param_values`). Where the JAX
package vmaps `apply(target, key, values)` over one key per env, the
port draws for the whole batch at once, and a caller (or a test) may pass
draws of its own.

Paths follow the reference ADR interface (env.py:196-249;
docs/env_param_interface.md): `"<randomizer>:<param>"`, nested groups
joined with `:`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Generic, List, Sequence, TypeVar

import numpy as np
import torch

from robogym_torch.randomization.parameters import (
    FloatRandomizerParameter,
    RandomizerParameter,
)

TType = TypeVar("TType")


class Randomizer(Generic[TType]):
    """Base randomizer (common.py:96-170). Subclasses implement `_draw`
    and `_apply`."""

    def __init__(self, name: str, enabled: bool = True):
        self.name = name
        self._parameters: "OrderedDict[str, RandomizerParameter]" = OrderedDict()
        self._enabled = enabled

    # host API
    def register_parameter(self, parameter: RandomizerParameter):
        assert parameter.name not in self._parameters, (
            f"Parameter with name {parameter.name} already exists."
        )
        self._parameters[parameter.name] = parameter
        return parameter

    def get_parameters(self) -> List[RandomizerParameter]:
        return list(self._parameters.values())

    def get_parameter(self, name: str) -> RandomizerParameter:
        assert name in self._parameters, (
            f"Parameter {name} does not exist in randomizer {self.name}."
        )
        return self._parameters[name]

    def _register_sim_parameter(self, name="value", initial_value=0.0, value_min=-4.0,
                                value_max=4.0, delta=None):
        """(sim.py:66-92)."""
        if delta is None:
            delta = (value_max - value_min) / 10
        return self.register_parameter(FloatRandomizerParameter(
            name, initial_value=initial_value, value_range=(value_min, value_max), delta=delta))

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def param_values(self) -> np.ndarray:
        """The current parameter vector, as `apply` takes it."""
        return np.asarray([p.get_value() for p in self._parameters.values()], np.float64)

    # batch API
    def draw(self, gen: torch.Generator, batch: int) -> Dict[str, Any]:
        """The samples of `batch` envs, each `(batch, ...)`; a disabled
        randomizer draws nothing."""
        if not self._enabled:
            return {}
        return self._draw(gen, batch)

    def apply(self, target: TType, draws: Dict[str, Any], values) -> TType:
        """The batch's target with `draws` applied under parameter vector
        `values`. A disabled randomizer returns `target` itself."""
        if not self._enabled:
            return target
        return self._apply(target, draws, values)

    def _draw(self, gen: torch.Generator, batch: int) -> Dict[str, Any]:
        return {}

    def _apply(self, target: TType, draws: Dict[str, Any], values) -> TType:
        raise NotImplementedError


class ChainedRandomizer(Randomizer[TType]):
    """A list of randomizers applied in order (common.py:173-243).
    `draw` and `apply` take and give one entry per child, by name; the
    JAX package splits its key once per child, in this order."""

    def __init__(self, name: str, randomizers: Sequence[Randomizer]):
        super().__init__(name, enabled=True)
        self._randomizers: "OrderedDict[str, Randomizer]" = OrderedDict()
        for r in randomizers:
            self.register_randomizer(r)

    def register_randomizer(self, randomizer: Randomizer) -> Randomizer:
        assert randomizer.name not in self._randomizers, (
            f"Randomizer with name {randomizer.name} already exists."
        )
        self._randomizers[randomizer.name] = randomizer
        return randomizer

    def get_randomizers(self) -> List[Randomizer]:
        return list(self._randomizers.values())

    def get_randomizer(self, name: str) -> Randomizer:
        assert name in self._randomizers, f"Randomizer {name} does not exist."
        return self._randomizers[name]

    def get_parameters(self) -> List[RandomizerParameter]:
        return [p for r in self._randomizers.values() for p in r.get_parameters()]

    def param_values(self) -> Dict[str, np.ndarray]:
        return {name: r.param_values() for name, r in self._randomizers.items()}

    def draw(self, gen: torch.Generator, batch: int) -> Dict[str, Any]:
        return {name: r.draw(gen, batch) for name, r in self._randomizers.items()}

    def apply(self, target, draws: Dict[str, Any], values: Dict[str, Any]):
        for name, r in self._randomizers.items():
            target = r.apply(target, draws[name], values[name])
        return target


class EnvRandomization:
    """ADR-facing registry over all the env's randomizers (env.py:151-262).
    `get_parameter` and `update_parameter` take `:`-joined paths, e.g.
    `"sim:gravity:value"` or `"parameters:num_objects"`."""

    def __init__(self, randomizers: Sequence[Randomizer]):
        self._randomizers: "OrderedDict[str, Randomizer]" = OrderedDict(
            (r.name, r) for r in randomizers)

    def get_randomizer(self, name: str) -> Randomizer:
        return self._randomizers[name]

    def enumerate_randomizers(self) -> List[Randomizer]:
        return list(self._randomizers.values())

    def _walk(self, path: str) -> RandomizerParameter:
        parts = path.split(":")
        node: Randomizer = self._randomizers[parts[0]]
        for part in parts[1:-1]:
            node = node.get_randomizer(part)  # type: ignore[attr-defined]
        return node.get_parameter(parts[-1])

    def get_parameter(self, path: str) -> RandomizerParameter:
        """(env.py:196-226)."""
        return self._walk(path)

    def update_parameter(self, path: str, value):
        """(env.py:228-249)."""
        self._walk(path).set_value(value)

    def get_parameters(self) -> List[RandomizerParameter]:
        return [p for r in self._randomizers.values() for p in r.get_parameters()]

    def reset(self):
        pass
