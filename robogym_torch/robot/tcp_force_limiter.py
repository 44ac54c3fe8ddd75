"""The force-based TCP control limiter, batched: above a trigger force or
torque each axis's TCP command is scaled down along a normalised logistic
sigmoid, to MINIMUM_SCALING_FACTOR at MAXIMUM_TCP_FORCE_TORQUE, and above
that maximum it reverses by OVER_MAX_REVERSE_SCALE.

Counterpart of `robogym_tpu/robot/tcp_force_limiter.py`, which the JAX
blocks env applies on its mocap_ik TCP path when `use_force_limiter` is set
(the default).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

LOGISTIC_ALPHA_PARAMETER = 0.81
MAXIMUM_TCP_FORCE_TORQUE = 40.0   # N
TRIGGER_FORCE_TORQUE_THRESHOLD = MAXIMUM_TCP_FORCE_TORQUE * 0.50
MINIMUM_SCALING_FACTOR = 0.0
OVER_MAX_REVERSE_SCALE = -0.1


def logistic_sigmoid(x: torch.Tensor, a: float) -> torch.Tensor:
    """(logistic_functions.py:13-40): the normalised sigmoid of slope a."""
    a = float(np.clip(a, 1e-4, 1.0 - 1e-4))
    a = 1.0 / (1.0 - a) - 1.0
    A = 1.0 / (1.0 + torch.exp(-((x - 0.5) * a * 2.0)))
    B = 1.0 / (1.0 + np.exp(a))
    C = 1.0 / (1.0 + np.exp(-a))
    return (A - B) / (C - B)


def clipped_logistic_sigmoid(x: torch.Tensor, a: float) -> torch.Tensor:
    """(logistic_functions.py:44-75): the input clipped to [0, 1]."""
    return logistic_sigmoid(torch.clamp(x, 0.0, 1.0), a)


def get_element_wise_tcp_control_limits(tcp_force_and_torque: torch.Tensor,
                                        reverse_over_max: bool = True
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(force_based_tcp_control_limiter.py:30-86): from the measured
    |force| and |torque| per axis (B, 6), (scales (B, 6), triggered (B,))."""
    f = tcp_force_and_torque
    over = f > TRIGGER_FORCE_TORQUE_THRESHOLD
    x = torch.clamp(MAXIMUM_TCP_FORCE_TORQUE - f, min=0.0) / (
        MAXIMUM_TCP_FORCE_TORQUE - TRIGGER_FORCE_TORQUE_THRESHOLD)
    scaled = (clipped_logistic_sigmoid(x, LOGISTIC_ALPHA_PARAMETER)
              * (1.0 - MINIMUM_SCALING_FACTOR) + MINIMUM_SCALING_FACTOR)
    scales = torch.where(over, scaled, torch.ones_like(f))
    if reverse_over_max:
        scales = torch.where(f > MAXIMUM_TCP_FORCE_TORQUE,
                             torch.full_like(f, OVER_MAX_REVERSE_SCALE), scales)
    return scales, over.any(-1)
