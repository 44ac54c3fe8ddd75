"""The ADR-facing env randomization registry.

Counterpart of `robogym_tpu/randomization/env.py` (reference
randomization/env.py:45-262), over dataclass parameters (the reference
uses attrs): `randomizable(...)` declares a dataclass field with its range;
`enumerate_randomizable_params` finds them recursively;
`EnvParameterRandomizer` gives them to ADR under `parameters:<name>` paths
and writes the current values into a new (frozen) parameter dataclass. The
action, observation and simulation chains hold batched randomizers
(`randomization.core`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, NamedTuple, Tuple

import numpy as np

from robogym_torch.randomization.core import ChainedRandomizer, EnvRandomization, Randomizer
from robogym_torch.randomization.parameters import (
    FloatRandomizerParameter,
    IntRandomizerParameter,
)


def randomizable(default, low=None, high=None, **kw):
    """Dataclass field with ADR range metadata
    (reference build_randomizable_param, env.py:45-78)."""
    low = -np.inf if low is None else low
    high = np.inf if high is None else high
    return dataclasses.field(
        default=default,
        metadata={"randomizable": True, "low": low, "high": high},
        **kw,
    )


class RandomizableParam(NamedTuple):
    name: str            # ":"-joined path relative to the parameters root
    value_type: type
    default: Any
    value_range: Tuple[Any, Any]
    parent_instance: Any


def enumerate_randomizable_params(parameters) -> Iterable[RandomizableParam]:
    """Recursive discovery over nested dataclasses (env.py:94-130)."""
    for field in dataclasses.fields(type(parameters)):
        value = getattr(parameters, field.name)
        if field.metadata.get("randomizable", False):
            yield RandomizableParam(
                name=field.name,
                value_type=type(value),
                default=value,
                value_range=(field.metadata["low"], field.metadata["high"]),
                parent_instance=parameters,
            )
        elif dataclasses.is_dataclass(value) and not isinstance(value, type):
            for p in enumerate_randomizable_params(value):
                yield RandomizableParam(
                    name=f"{field.name}:{p.name}",
                    value_type=p.value_type,
                    default=p.default,
                    value_range=p.value_range,
                    parent_instance=p.parent_instance,
                )


class EnvParameterRandomizer(Randomizer):
    """Registry of randomizable env parameters (env.py:133-159). `apply`
    writes current ADR values back into a new frozen dataclass instance."""

    def __init__(self, parameters):
        super().__init__("parameters")
        for p in enumerate_randomizable_params(parameters):
            cls = (
                IntRandomizerParameter
                if issubclass(p.value_type, (int, np.integer)) and not issubclass(p.value_type, bool)
                else FloatRandomizerParameter
            )
            self.register_parameter(cls(p.name, p.default, p.value_range))

    def draw(self, gen=None, batch=None):
        return {}

    def apply(self, parameters, draws=None, values=None):
        for param in self.get_parameters():
            parts = param.name.split(":")
            parameters = _replace_nested(parameters, parts, param.get_value())
        return parameters


def _replace_nested(obj, parts: List[str], value):
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(
        obj, **{parts[0]: _replace_nested(child, parts[1:], value)}
    )


class EnvActionRandomizer(ChainedRandomizer):
    """(env.py:162-170)."""

    def __init__(self, randomizers):
        super().__init__("action", randomizers)


class EnvObservationRandomizer(ChainedRandomizer):
    """(env.py:173-181)."""

    def __init__(self, randomizers):
        super().__init__("observation", randomizers)


class EnvSimulationRandomizer(ChainedRandomizer):
    """(env.py:184-192)."""

    def __init__(self, randomizers):
        super().__init__("sim", randomizers)


def build_env_randomization(
    parameters=None,
    parameter_randomizers: List[Randomizer] = (),
    observation_randomizers: List[Randomizer] = (),
    action_randomizers: List[Randomizer] = (),
    simulation_randomizers: List[Randomizer] = (),
) -> EnvRandomization:
    """(robot_env.py:1031-1049 build_randomization)."""
    randomizers: List[Randomizer] = []
    if parameters is not None:
        randomizers.append(EnvParameterRandomizer(parameters))
    randomizers.extend(parameter_randomizers)
    randomizers.append(EnvObservationRandomizer(list(observation_randomizers)))
    randomizers.append(EnvActionRandomizer(list(action_randomizers)))
    randomizers.append(EnvSimulationRandomizer(list(simulation_randomizers)))
    return EnvRandomization(randomizers)
