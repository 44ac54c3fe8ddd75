"""Typed randomizer parameters (host side).

Counterpart of `robogym_tpu/randomization/parameters.py` (reference
randomization/common.py:16-93 and parameters.py:10-53): named values with
a range and a step size, which ADR moves to steer domain randomization.
Host-side Python; a randomizer reads the current values when it applies
its draws, so an ADR update needs no rebuild.
"""

from __future__ import annotations

from typing import Generic, Optional, Tuple, TypeVar

VType = TypeVar("VType", int, float)


class RandomizerParameter(Generic[VType]):
    """Named scalar with range + ADR step size (common.py:16-93)."""

    INT = "int"
    FLOAT = "float"

    def __init__(
        self,
        name: str,
        initial_value: VType,
        value_range: Tuple[VType, VType],
        delta: Optional[VType] = None,
    ):
        self.name = name
        self._value_range = (
            self._convert_type(value_range[0]),
            self._convert_type(value_range[1]),
        )
        self._delta = self._convert_type(delta) if delta is not None else None
        self._value = self._convert_value(initial_value)

    def get_value(self) -> VType:
        return self._value

    def set_value(self, value: VType):
        self._value = self._convert_value(value)

    def get_range(self) -> Tuple[VType, VType]:
        return self._value_range

    def get_delta(self) -> Optional[VType]:
        return self._delta

    @property
    def dtype(self):
        raise NotImplementedError

    def _convert_value(self, value: VType) -> VType:
        low, high = self._value_range
        value = self._convert_type(value)
        assert low <= value <= high, (
            f"Value {value} is not within range of [{low}, {high}]"
        )
        return value

    @classmethod
    def _convert_type(cls, val):
        raise NotImplementedError

    def __repr__(self):
        return (
            f"{type(self).__name__}(name={self.name}, value={self._value}, "
            f"range={self._value_range})"
        )


class FloatRandomizerParameter(RandomizerParameter[float]):
    """(parameters.py:10-29)."""

    @classmethod
    def _convert_type(cls, val) -> float:
        return float(val)

    @property
    def dtype(self):
        return RandomizerParameter.FLOAT


class IntRandomizerParameter(RandomizerParameter[int]):
    """(parameters.py:32-53)."""

    @classmethod
    def _convert_type(cls, val) -> int:
        return int(val)

    @property
    def dtype(self):
        return RandomizerParameter.INT
