"""`chip_smoke.capture_ends` records the arguments of the kernels' calls
on a path by reference, without copies, so that recording adds nothing to
the path's timed step. That record is exact only if no caller writes into
an argument after its call: here, on the CPU, the records that
`capture_rearrange` and `capture_family_step` take of one step of the
blocks env (TCP control through its solver sim, goals settled in the
settle world) equal, bit for bit, the records of a recorder that copies
every argument at its call."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from robogym_torch.envs.rearrange import blocks

FAST = {"mujoco_substeps": 2, "stabilize_steps": 1, "goal_args": {"stabilize_goal": True}}


def _copying_capture_ends(targets, run, last=1):
    """`capture_ends` as it was with copies: every tensor argument cloned
    at its call."""
    store = {}

    def recorder(name, fn):
        def rec(*args):
            c = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            calls = store.setdefault(name, [c] * (1 + last))
            calls[1:] = calls[2:] + [c]
            return fn(*args)
        return rec

    with chip_smoke.patched([((module, name), recorder(name, getattr(module, name)))
                             for module, name in targets]):
        run()
    return store


def _assert_same(got, want, where="record"):
    assert type(got) is type(want), where
    if isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    elif isinstance(got, np.ndarray):
        assert np.array_equal(got, want), where
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want), where
        for k in got:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    elif dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    else:
        assert got == want, where


@pytest.mark.parametrize("capture", ["capture_rearrange", "capture_family_step"])
def test_records_by_reference_equal_copies(capture, monkeypatch):
    env = blocks.make_env(FAST, {}, device="cpu")
    state, _ = env.reset(2)
    draws = env.generator.get_state()
    got = getattr(chip_smoke, capture)(env, state)
    env.generator.set_state(draws)
    monkeypatch.setattr(chip_smoke, "capture_ends", _copying_capture_ends)
    want = getattr(chip_smoke, capture)(env, state)
    _assert_same(got, want)
