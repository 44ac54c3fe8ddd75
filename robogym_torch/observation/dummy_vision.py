"""The dummy vision providers, batched.

Counterpart of `robogym_tpu/observation/dummy_vision.py` (reference
observation/dummy_vision.py:11-53): zero images of the configured cameras
and size, the vision observations of an env with no renderer (the
reference's default for the locked env's vision configs,
envs/dactyl/common/cube_env.py:295-306).
"""

from __future__ import annotations

from typing import Sequence

import torch

from robogym_torch.observation.common import ObservationProvider, SyncType

DEFAULT_CAMERA_NAMES = ["vision_cam_top", "vision_cam_right", "vision_cam_left"]


def zero_images(camera_names: Sequence[str], image_size: int, batch: int, device=None,
                dtype=torch.uint8) -> torch.Tensor:
    """(batch, cameras, size, size, 3) zeros."""
    return torch.zeros((batch, len(camera_names), image_size, image_size, 3), dtype=dtype,
                       device=device)


def _batch_zeros(camera_names, image_size, state):
    q = state.physics.qpos
    return zero_images(camera_names, image_size, q.shape[0], q.device)


def make_dummy_vision_provider(camera_names: Sequence[str] = tuple(DEFAULT_CAMERA_NAMES),
                               image_size: int = 200) -> ObservationProvider:
    """(dummy_vision.py:11-33 DummyVisionObservationProvider): `vision`,
    read every step."""
    return ObservationProvider(
        name="dummy_vision",
        read=lambda env, state: {"vision": _batch_zeros(camera_names, image_size, state)},
        sync_type=SyncType.STEP)


def make_dummy_goal_vision_provider(camera_names: Sequence[str] = tuple(DEFAULT_CAMERA_NAMES),
                                    image_size: int = 200) -> ObservationProvider:
    """(dummy_vision.py:36-53 DummyVisionGoalObservationProvider):
    `vision_goal`, read at each goal reset."""
    return ObservationProvider(
        name="goal_dummy_vision",
        read=lambda env, state: {"vision_goal": _batch_zeros(camera_names, image_size, state)},
        sync_type=SyncType.RESET_GOAL)
