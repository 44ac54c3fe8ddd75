"""Camera and lighting randomization of the vision observations, batched.

Counterpart of `robogym_tpu/randomization/vision.py` (the reference's
per-reset jitter of cameras and lights, rearrange/common/base.py:637-730):
each episode's cameras (fovy, position, orientation), lights (position and
direction) and headlight become per-env model fields. `draw_vision(gen, B,
model)` makes a batch's draws from a `torch.Generator`; `apply_vision(model,
draws, params)` turns them into the (B, ...) fields, so that a caller (or a
test) may pass draws of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.mjcf.model import Model
from robogym_torch.utils import rotation as rot


@dataclasses.dataclass(frozen=True)
class VisionRandomizationParams:
    """(rearrange/simulation/base.py:115-128): all off until raised."""

    camera_fovy_radius: float = 0.0   # degrees, uniform +-
    camera_pos_radius: float = 0.0    # m, a point on a sphere of this radius
    camera_quat_radius: float = 0.0   # rad, a fixed angle about a uniform axis
    light_pos_range: float = 0.0      # the share of the lights' reachable cap
    light_diffuse_intensity: float = 0.4   # the headlight's diffuse (set, not drawn)
    light_ambient_intensity: float = 0.1   # the headlight's ambient

    def any_active(self) -> bool:
        return (self.camera_fovy_radius > 0 or self.camera_pos_radius > 0
                or self.camera_quat_radius > 0 or self.light_pos_range > 0
                or self.light_diffuse_intensity != 0.4 or self.light_ambient_intensity != 0.1)


def draw_vision(gen: torch.Generator, B: int, m: Model) -> Dict[str, torch.Tensor]:
    """The draws of `apply_vision` for B envs: per camera a fovy uniform
    (B, ncam), a normal 3-vector (B, ncam, 3) and three uniforms of a
    random quaternion (B, ncam, 3); per light three uniforms (B, nlight,
    3)."""
    dev, dtype = m.device, m.dtype
    nc, nl = m.const.ncam, m.const.nlight

    def u(*shape):
        return torch.rand(shape, generator=gen, dtype=dtype, device=dev)

    return dict(fovy_u=u(B, nc), pos_n=torch.randn((B, nc, 3), generator=gen, dtype=dtype,
                                                    device=dev),
                axis_u=u(B, nc, 3), light_u=u(B, nl, 3))


def apply_vision(m: Model, draws: Dict[str, torch.Tensor],
                 p: VisionRandomizationParams) -> Dict[str, torch.Tensor]:
    """Per-env model fields (B, ...) of the cameras and lights from
    `draws`, jittered about the compiled model's values."""
    B = draws["fovy_u"].shape[0]
    dtype = m.dtype
    out = {}
    if m.const.ncam:
        delta = uniform_apply(draws["fovy_u"].to(dtype), -1.0, 1.0) * p.camera_fovy_radius
        out["cam_fovy"] = m.cam_fovy + delta
        vec = draws["pos_n"].to(dtype)
        vec = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-12)
        out["cam_pos"] = m.cam_pos + vec * p.camera_pos_radius
        # a fixed-angle turn about a uniform axis (base.py:662-677: the axis
        # is a uniform quaternion applied to +y)
        uq = rot.uniform_quat_apply(draws["axis_u"]).to(dtype)
        up = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=m.device)
        axis = rot.quat_rot_vec(uq, up.expand_as(uq[..., 1:]))
        angle = torch.full(axis.shape[:-1], p.camera_quat_radius, dtype=dtype, device=m.device)
        out["cam_quat"] = rot.quat_mul(m.cam_quat.expand(B, -1, 4),
                                       rot.quat_from_angle_and_axis(angle, axis))
    if m.const.nlight:
        # the lights stay 4 m from the origin, on a cap that grows with the
        # range (base.py:680-717)
        f = p.light_pos_range
        lu = draws["light_u"].to(m.light_pos.dtype)
        x = uniform_apply(lu[..., 0], -0.25 * f, 0.75 * f)
        y = f * uniform_apply(lu[..., 1], -4.0, 4.0)
        z = uniform_apply(lu[..., 2], 4.0 - 4.0 * f, 4.0)
        raw = torch.stack([x, y, z], -1)
        nrm = torch.linalg.norm(raw, dim=-1, keepdim=True) + 1e-12
        out["light_pos"] = raw / nrm * 4.0
        out["light_dir"] = -raw / nrm
    # the headlight is set to the parameters' intensities (base.py:719-730)
    out["headlight_diffuse"] = torch.full((B,), p.light_diffuse_intensity, dtype=dtype,
                                          device=m.device)
    out["headlight_ambient"] = torch.full((B,), p.light_ambient_intensity, dtype=dtype,
                                          device=m.device)
    return out


def sample_vision_fields(gen: torch.Generator, B: int, m: Model,
                         p: VisionRandomizationParams) -> Dict[str, torch.Tensor]:
    """`apply_vision` on draws from `gen`."""
    return apply_vision(m, draw_vision(gen, B, m), p)
