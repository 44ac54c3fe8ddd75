"""The wrapper layer's registry (counterpart of `robogym_tpu/wrappers/__init__.py`;
reference robogym/wrappers/__init__ and named_wrappers.py): every transform
by name for `apply_named_wrappers`, the default dactyl stack, and that
stack with the face-damping transform for the face-perpendicular env, and
that with the perpendicular cube-size transform for the full-perpendicular
env."""

from robogym_torch.wrappers.core import (
    Transform,
    WrappedEnv,
    apply_named_wrappers,
    edit_wrappers,
)
from robogym_torch.wrappers.dactyl import (
    AngleObservationWrapper,
    CubeFreezingPhasespaceBody,
    FingerSeparationWrapper,
    FingersFreezingPhasespaceMarkers,
    FingersOccludedPhasespaceMarkers,
    FixedWristWrapper,
    FreezingPhasespaceBody,
    RandomizedCubeSizeWrapper,
    RandomizedPhasespaceFingersWrapper,
    RandomizedWindWrapper,
    StopOnFallWrapper,
)
from robogym_torch.wrappers.face import RandomizedFaceDampingWrapper
from robogym_torch.wrappers.parametric import RandomizedPerpendicularCubeSizeWrapper
from robogym_torch.wrappers.randomizations import (
    ActionDelayWrapper,
    ActionNoiseWrapper,
    BacklashWrapper,
    FreezingPhasespaceMarkers,
    ObservationDelayWrapper,
    RandomizeObservationWrapper,
    RandomizedActionLatency,
    RandomizedBodyInertiaWrapper,
    RandomizedBrokenActuatorWrapper,
    RandomizedCubeFrictionWrapper,
    RandomizedDampingWrapper,
    RandomizedFrictionWrapper,
    RandomizedGravityWrapper,
    RandomizedJointLimitWrapper,
    RandomizedKpWrapper,
    RandomizedRobotDampingWrapper,
    RandomizedRobotFrictionWrapper,
    RandomizedRobotKpWrapper,
    RandomizedTendonRangeWrapper,
    RandomizedTimestepWrapper,
)
from robogym_torch.wrappers.randomizations import RandomizedWindWrapper as RandomizedOptWindWrapper
from robogym_torch.wrappers.util import (
    ClipActionWrapper,
    ClipObservationWrapper,
    ClipRewardWrapper,
    DiscretizeActionWrapper,
    PreviousActionObservationWrapper,
    RelativeGoalWrapper,
    RewardNameWrapper,
    RewardObservationWrapper,
    SmoothActionWrapper,
    SummedRewardsWrapper,
    UnifiedGoalObservationWrapper,
)

__all__ = [n for n in dir() if not n.startswith("_")]

# the locked env's observation noise (locked.py:231-244)
LOCKED_NOISE_LEVELS = {
    "fingertip_pos": {"uncorrelated": 0.002, "additive": 0.001},
    "hand_angle": {"additive": 0.1, "uncorrelated": 0.1},
    "cube_pos": {"additive": 0.005, "uncorrelated": 0.001},
    "cube_quat": {"additive": 0.1, "uncorrelated": 0.09},
}


def construct_default_dactyl_wrappers(*, randomize: bool = True, n_action_bins: int = 11,
                                      fixed_wrist: bool = False,
                                      relative_goal_wrapper: bool = True,
                                      drop_reward: float = -20.0, min_episode_length: int = -1,
                                      noise_levels=None, observation_delay_levels=None):
    """The default dactyl wrapper stack
    (reference envs/dactyl/common/dactyl_cube_wrappers.py:8-91), innermost
    first."""
    wrappers = []
    if fixed_wrist:
        wrappers.append(["FixedWristWrapper"])
    wrappers.append(["ClipActionWrapper"])
    wrappers.append(["StopOnFallWrapper",
                     dict(min_episode_length=min_episode_length, drop_reward=drop_reward)])
    if randomize:
        wrappers.append(["BacklashWrapper"])
        wrappers += [[name] for name in (
            "RandomizedActionLatency", "RandomizedCubeSizeWrapper",
            "RandomizedBodyInertiaWrapper", "RandomizedTimestepWrapper",
            "RandomizedRobotFrictionWrapper", "RandomizedCubeFrictionWrapper",
            "RandomizedGravityWrapper", "RandomizedWindWrapper",
            "RandomizedPhasespaceFingersWrapper", "RandomizedRobotDampingWrapper",
            "RandomizedRobotKpWrapper", "RandomizedJointLimitWrapper",
            "RandomizedTendonRangeWrapper")]
        if noise_levels is None:
            noise_levels = LOCKED_NOISE_LEVELS
    else:
        noise_levels = noise_levels or {}
    observation_delay_levels = observation_delay_levels or {
        "interpolators": {"cube_quat": "QuatInterpolator"}, "groups": {}}
    wrappers.append(["ObservationDelayWrapper", dict(levels=observation_delay_levels)])
    wrappers.append(["RandomizeObservationWrapper", dict(levels=noise_levels)])
    wrappers.append(["SmoothActionWrapper"])
    if relative_goal_wrapper:
        wrappers.append(["RelativeGoalWrapper", dict(obs_prefix="cube_")])
    if randomize:
        wrappers += [["FingersFreezingPhasespaceMarkers"], ["CubeFreezingPhasespaceBody"],
                     ["ActionNoiseWrapper"]]
    wrappers.append(["AngleObservationWrapper"])
    wrappers.append(["UnifiedGoalObservationWrapper", dict(goal_parts=["pos", "quat"])])
    wrappers.append(["ClipObservationWrapper"])
    wrappers.append(["ClipRewardWrapper"])
    wrappers.append(["PreviousActionObservationWrapper"])
    wrappers.append(["RewardObservationWrapper", {"reward_inds": [1, 2]}])
    wrappers.append(["DiscretizeActionWrapper", {"n_action_bins": n_action_bins}])
    return wrappers


def apply_dactyl_wrappers(env, **kwargs) -> WrappedEnv:
    """The default dactyl stack around `env` (dactyl_cube_wrappers.apply_wrappers)."""
    return apply_named_wrappers(env, construct_default_dactyl_wrappers(**kwargs))


def construct_face_wrappers(**kwargs):
    """The default dactyl stack with the face drivers' damping randomized
    (`RandomizedFaceDampingWrapper`) added outermost, the stack the
    face-perpendicular env is wrapped in."""
    return construct_default_dactyl_wrappers(**kwargs) + [["RandomizedFaceDampingWrapper"]]


def apply_face_wrappers(env, **kwargs) -> WrappedEnv:
    """`construct_face_wrappers` around `env`."""
    return apply_named_wrappers(env, construct_face_wrappers(**kwargs))


def construct_full_wrappers(**kwargs):
    """The face stack with the perpendicular cube's size randomized
    (`RandomizedPerpendicularCubeSizeWrapper`) added outermost, the stack
    the full-perpendicular env is wrapped in."""
    return construct_face_wrappers(**kwargs) + [["RandomizedPerpendicularCubeSizeWrapper"]]


def apply_full_wrappers(env, **kwargs) -> WrappedEnv:
    """`construct_full_wrappers` around `env`."""
    return apply_named_wrappers(env, construct_full_wrappers(**kwargs))
