"""Model / Data / Contact for the PyTorch port.

Counterpart of `robogym_tpu/mjcf/model.py`. The field names are the JAX
package's, so the bridge (`robogym_torch/bridge.py`) can carry a compiled
model and a state across by name.

  * `ModelConst` is the static structure of the kinematic tree: host numpy
    arrays plus ints, identical for every env.
  * `Model` holds the episode-constant tensors on one device. A field is
    shared by the whole batch and carries no env axis, or, where its name
    is in `env_fields` (per-episode fields, `envs.core.apply_model_fields`),
    it is each env's own, `(B, ...)`. Either way it broadcasts against
    `Data`; `Model.take` gathers rows of a field that may be either.
  * `Data` is the per-env state. Every tensor has a leading env axis
    `(B, ...)`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Enums (values match MuJoCo where a counterpart exists)
# ---------------------------------------------------------------------------


class JointType:
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3

    QPOS_WIDTH = {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}
    DOF_WIDTH = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}


class GeomType:
    PLANE = 0
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class TrnType:
    JOINT = 0
    TENDON = 3
    SITE = 4


class GainType:
    FIXED = 0
    USER = 2


class BiasType:
    NONE = 0
    AFFINE = 1
    USER = 2


class EqType:
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3
    DISTANCE = 4


class WrapType:
    JOINT = 1
    PULLEY = 2
    SITE = 3
    SPHERE = 4


class ConeType:
    PYRAMIDAL = 0
    ELLIPTIC = 1


class IntegratorType:
    EULER = 0
    RK4 = 1


class DynType:
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2


@dataclasses.dataclass(frozen=True, eq=False)
class ModelConst:
    """Static structural description of the kinematic tree (host numpy)."""

    nq: int
    nv: int
    nu: int
    na: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    nmesh: int
    ntendon: int
    nwrap: int
    neq: int
    nmocap: int
    nsensor: int

    body_parentid: np.ndarray
    body_rootid: np.ndarray
    body_weldid: np.ndarray
    body_jntadr: np.ndarray
    body_jntnum: np.ndarray
    body_dofadr: np.ndarray
    body_dofnum: np.ndarray
    body_mocapid: np.ndarray
    body_tree: Tuple[Tuple[int, ...], ...]

    jnt_type: np.ndarray
    jnt_qposadr: np.ndarray
    jnt_dofadr: np.ndarray
    jnt_bodyid: np.ndarray
    jnt_limited: np.ndarray

    dof_jntid: np.ndarray
    dof_bodyid: np.ndarray
    dof_parentid: np.ndarray

    geom_type: np.ndarray
    geom_bodyid: np.ndarray
    geom_dataid: np.ndarray
    geom_contype: np.ndarray
    geom_conaffinity: np.ndarray
    geom_condim: np.ndarray

    site_bodyid: np.ndarray

    tendon_adr: np.ndarray
    tendon_num: np.ndarray
    tendon_limited: np.ndarray
    wrap_type: np.ndarray
    wrap_objid: np.ndarray

    actuator_trntype: np.ndarray
    actuator_trnid: np.ndarray
    actuator_gaintype: np.ndarray
    actuator_biastype: np.ndarray
    actuator_dyntype: np.ndarray
    actuator_actadr: np.ndarray
    actuator_user: np.ndarray
    actuator_ctrllimited: np.ndarray
    actuator_forcelimited: np.ndarray

    eq_type: np.ndarray
    eq_obj1id: np.ndarray
    eq_obj2id: np.ndarray

    collision_pairs: np.ndarray
    pair_ncon: np.ndarray

    body_dof_mask: np.ndarray = None
    dof_has_frictionloss: np.ndarray = None

    ncam: int = 0
    cam_bodyid: np.ndarray = None
    nlight: int = 0
    light_bodyid: np.ndarray = None
    light_directional: np.ndarray = None

    names: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v.setflags(write=False)

    def name2id(self, kind: str, name: str) -> int:
        return self.names[kind][name]


@dataclasses.dataclass(frozen=True)
class Option:
    """Physics options: tensors on the model's device plus static config."""

    timestep: torch.Tensor
    gravity: torch.Tensor
    wind: torch.Tensor
    density: torch.Tensor
    viscosity: torch.Tensor
    impratio: torch.Tensor
    iterations: int = 20
    cg_iterations: int = 15
    ls_iterations: int = 8
    ncon_active: int = 32
    group_cap: int = 48
    solver: str = "cg"
    tolerance: float = 1e-8
    cone: int = ConeType.PYRAMIDAL
    integrator: int = IntegratorType.EULER


OPTION_TENSORS = ("timestep", "gravity", "wind", "density", "viscosity", "impratio")
OPTION_STATIC = ("iterations", "cg_iterations", "ls_iterations", "ncon_active",
                 "group_cap", "solver", "tolerance", "cone", "integrator")


def env_col(x: torch.Tensor, n: int) -> torch.Tensor:
    """An option value `x`, shared (0-dim) or each env's own (B,), shaped
    to broadcast against a (B, ...) tensor of `n` more dims."""
    return x.reshape(x.shape + (1,) * n) if x.dim() else x


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """Episode-constant model tensors, shared by every env of a batch."""

    const: ModelConst
    opt: Option

    qpos0: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_range: torch.Tensor
    jnt_margin: torch.Tensor
    jnt_stiffness: torch.Tensor
    jnt_springref: torch.Tensor
    jnt_solref: torch.Tensor
    jnt_solimp: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_solref: torch.Tensor
    dof_solimp: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_friction: torch.Tensor
    geom_solref: torch.Tensor
    geom_solimp: torch.Tensor
    geom_solmix: torch.Tensor
    geom_margin: torch.Tensor
    geom_gap: torch.Tensor
    geom_priority: torch.Tensor
    geom_rgba: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    mesh_convex_vert: torch.Tensor
    mesh_convex_mask: torch.Tensor
    mesh_convex_center: torch.Tensor
    tendon_range: torch.Tensor
    tendon_stiffness: torch.Tensor
    tendon_damping: torch.Tensor
    tendon_lengthspring: torch.Tensor
    tendon_margin: torch.Tensor
    tendon_solref: torch.Tensor
    tendon_solimp: torch.Tensor
    tendon_frictionloss: torch.Tensor
    wrap_prm: torch.Tensor
    actuator_gainprm: torch.Tensor
    actuator_biasprm: torch.Tensor
    actuator_dynprm: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    actuator_forcerange: torch.Tensor
    actuator_gear: torch.Tensor
    eq_active: torch.Tensor
    eq_data: torch.Tensor
    eq_solref: torch.Tensor
    eq_solimp: torch.Tensor

    cam_pos: Optional[torch.Tensor] = None
    cam_quat: Optional[torch.Tensor] = None
    cam_fovy: Optional[torch.Tensor] = None
    light_pos: Optional[torch.Tensor] = None
    light_dir: Optional[torch.Tensor] = None
    light_ambient: Optional[torch.Tensor] = None
    light_diffuse: Optional[torch.Tensor] = None
    light_active: Optional[torch.Tensor] = None
    headlight_diffuse: Optional[torch.Tensor] = None
    headlight_ambient: Optional[torch.Tensor] = None
    mesh_face_plane: Optional[torch.Tensor] = None
    mesh_face_mask: Optional[torch.Tensor] = None
    # names of the fields that carry a leading env axis ("opt:<name>" for
    # an Option field)
    env_fields: frozenset = frozenset()

    def per_env(self, name: str) -> bool:
        return name in self.env_fields

    def take(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows `ids` of field `name`: ids (k,) gives (k, ...) of a shared
        field and (B, k, ...) of a per-env one; ids (B, k), each env's own
        rows, gives (B, k, ...) of either."""
        v = getattr(self, name)
        if name not in self.env_fields:
            return v[ids]
        if ids.dim() == 2:
            return v[torch.arange(v.shape[0], device=v.device)[:, None], ids]
        return v[:, ids]

    @property
    def nv(self) -> int:
        return self.const.nv

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype

    def replace(self, **kwargs) -> "Model":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class Contact:
    """Fixed-size contact set, `(B, ncon)` per field; `wtab` holds the
    solver parameters per broadphase winner, `(B, W, 12)`."""

    dist: torch.Tensor
    pos: torch.Tensor
    normal: torch.Tensor
    includemargin: torch.Tensor
    geom1: torch.Tensor
    geom2: torch.Tensor
    active: torch.Tensor
    condim: torch.Tensor
    body1: torch.Tensor
    body2: torch.Tensor
    wtab: torch.Tensor

    def replace(self, **kwargs) -> "Contact":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class Data:
    """Per-env state and derived quantities, each `(B, ...)`."""

    time: torch.Tensor
    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor
    ctrl: torch.Tensor
    qfrc_applied: torch.Tensor
    xfrc_applied: torch.Tensor
    mocap_pos: torch.Tensor
    mocap_quat: torch.Tensor

    xpos: torch.Tensor
    xquat: torch.Tensor
    xmat: torch.Tensor
    xipos: torch.Tensor
    ximat: torch.Tensor
    geom_xpos: torch.Tensor
    geom_xmat: torch.Tensor
    site_xpos: torch.Tensor
    site_xmat: torch.Tensor

    subtree_com: torch.Tensor
    cdof: torch.Tensor
    cinert: torch.Tensor
    cvel: torch.Tensor

    qM: torch.Tensor
    qLD: torch.Tensor
    qfrc_bias: torch.Tensor
    qfrc_passive: torch.Tensor
    qfrc_actuator: torch.Tensor
    actuator_length: torch.Tensor
    actuator_velocity: torch.Tensor
    actuator_force: torch.Tensor
    ten_length: torch.Tensor
    ten_velocity: torch.Tensor
    ten_J: torch.Tensor
    act_dot: torch.Tensor
    act_vel_damping: torch.Tensor

    contact: Contact
    qacc_smooth: torch.Tensor
    qacc: torch.Tensor
    qfrc_constraint: torch.Tensor
    efc_force_contact: torch.Tensor

    @property
    def batch(self) -> int:
        return self.qpos.shape[0]

    def replace(self, **kwargs) -> "Data":
        return dataclasses.replace(self, **kwargs)


def make_data(model: Model, batch: int, qpos: Optional[torch.Tensor] = None) -> Data:
    """Initial state for `batch` envs (mj_makeData + qpos0), on the model's
    device and in its dtype. `qpos` (B, nq), if given, replaces qpos0."""
    from robogym_torch.physics.collision import driver

    c = model.const
    dev, dtype = model.device, model.dtype
    B = batch
    if c.collision_pairs.size:
        ncon = driver.n_contact_slots(c, model.opt.group_cap)
        nwin = driver.n_winner_rows(c, model.opt.group_cap)
    else:
        ncon = nwin = 0

    def z(*s):
        return torch.zeros((B,) + s, dtype=dtype, device=dev)

    def tile(row, n):
        return torch.tensor(row, dtype=dtype, device=dev).expand(B, n, len(row)).clone()

    def eye(n):
        return torch.eye(3, dtype=dtype, device=dev).expand(B, n, 3, 3).clone()

    if qpos is None:
        qpos = model.qpos0.expand(B, c.nq).clone()
    contact = Contact(
        dist=z(ncon), pos=z(ncon, 3), normal=tile([1.0, 0.0, 0.0], ncon),
        includemargin=z(ncon),
        geom1=torch.zeros((B, ncon), dtype=torch.int32, device=dev),
        geom2=torch.zeros((B, ncon), dtype=torch.int32, device=dev),
        active=torch.zeros((B, ncon), dtype=torch.bool, device=dev),
        condim=torch.full((B, ncon), 3, dtype=torch.int32, device=dev),
        body1=torch.zeros((B, ncon), dtype=torch.int32, device=dev),
        body2=torch.zeros((B, ncon), dtype=torch.int32, device=dev),
        wtab=z(nwin, 12),
    )
    return Data(
        time=z(), qpos=qpos.to(dtype=dtype, device=dev), qvel=z(c.nv), act=z(c.na),
        ctrl=z(c.nu), qfrc_applied=z(c.nv), xfrc_applied=z(c.nbody, 6),
        mocap_pos=z(c.nmocap, 3), mocap_quat=tile([1.0, 0.0, 0.0, 0.0], c.nmocap),
        xpos=z(c.nbody, 3), xquat=tile([1.0, 0.0, 0.0, 0.0], c.nbody), xmat=eye(c.nbody),
        xipos=z(c.nbody, 3), ximat=eye(c.nbody),
        geom_xpos=z(c.ngeom, 3), geom_xmat=eye(c.ngeom),
        site_xpos=z(c.nsite, 3), site_xmat=eye(c.nsite),
        subtree_com=z(c.nbody, 3), cdof=z(c.nv, 6), cinert=z(c.nbody, 6, 6),
        cvel=z(c.nbody, 6),
        qM=z(c.nv, c.nv), qLD=z(c.nv, c.nv),
        qfrc_bias=z(c.nv), qfrc_passive=z(c.nv), qfrc_actuator=z(c.nv),
        actuator_length=z(c.nu), actuator_velocity=z(c.nu), actuator_force=z(c.nu),
        ten_length=z(c.ntendon), ten_velocity=z(c.ntendon), ten_J=z(c.ntendon, c.nv),
        act_dot=z(c.na), act_vel_damping=z(c.nv),
        contact=contact,
        qacc_smooth=z(c.nv), qacc=z(c.nv), qfrc_constraint=z(c.nv),
        efc_force_contact=z(ncon),
    )
