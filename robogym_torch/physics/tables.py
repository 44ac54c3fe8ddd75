"""Derived static tables for vectorized smooth dynamics (host numpy).

A copy of `robogym_tpu/physics/tables.py` that reads the port's
`ModelConst`: every tree recursion becomes a masked matmul or a per-level
batched op.

  * `body_subtree_mask` S: S[b, b'] = 1 iff b' is in the subtree of b.
  * `dof_ancestor_mask` D: D[i, j] = 1 iff dof j is a strict ancestor of
    dof i.
  * FK level tables: bodies grouped by tree depth, partitioned by joint
    type.
  * flat dof tables for the cdof pass, scalar-joint tables for
    integrate/passive/limits, actuator transmission and fixed-tendon
    tables.

All tables are derived once per ModelConst and cached on it; `on_device`
caches their torch copies per device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from robogym_torch.mjcf.model import JointType, ModelConst, TrnType, WrapType


def _cached(c: ModelConst, key: str, make):
    val = getattr(c, key, None)
    if val is None:
        val = make(c)
        object.__setattr__(c, key, val)
    return val


# ---------------------------------------------------------------------------
# Ancestor masks
# ---------------------------------------------------------------------------


def body_subtree_mask(c: ModelConst) -> np.ndarray:
    """(nbody, nbody) float: S[b, b'] = 1 iff b' in subtree(b) (incl self)."""

    def build(c):
        n = c.nbody
        S = np.zeros((n, n), np.float32)
        for b2 in range(n):
            a = b2
            while True:
                S[a, b2] = 1.0
                if a == 0:
                    break
                a = int(c.body_parentid[a])
        return S

    return _cached(c, "_body_subtree_mask", build)


def dof_ancestor_mask(c: ModelConst) -> np.ndarray:
    """(nv, nv) float: D[i, j] = 1 iff dof j is a strict ancestor of dof i."""

    def build(c):
        nv = c.nv
        D = np.zeros((nv, nv), np.float32)
        for i in range(nv):
            j = int(c.dof_parentid[i])
            while j >= 0:
                D[i, j] = 1.0
                j = int(c.dof_parentid[j])
        return D

    return _cached(c, "_dof_ancestor_mask", build)


def dof_ancestor_or_self_upper(c: ModelConst) -> np.ndarray:
    """(nv, nv) float: A[i, j] = 1 iff i is an ancestor-or-equal dof of j.
    This is the sparsity pattern of the upper "ancestor" half of qM."""

    def build(c):
        D = dof_ancestor_mask(c)  # D[j, i] == i strict ancestor of j
        return (D.T + np.eye(c.nv, dtype=np.float32)).astype(np.float32)

    return _cached(c, "_dof_anc_or_self_upper", build)


# ---------------------------------------------------------------------------
# FK level tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FkLevel:
    bids: np.ndarray                       # (nb,) body ids at this level
    pids: np.ndarray                       # (nb,) parent ids
    # joint slots: for s in range(maxj), per-type local row partitions
    # slots[s] = {jt: (local_rows, jids)}
    slots: Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]], ...]
    mocap_rows: np.ndarray                 # local rows that are mocap bodies
    mocap_ids: np.ndarray                  # their mocapids


def fk_levels(c: ModelConst) -> Tuple[FkLevel, ...]:
    def build(c):
        levels: List[FkLevel] = []
        for lvl in c.body_tree:
            bids = np.asarray(lvl, np.int32)
            pids = c.body_parentid[bids].astype(np.int32)
            maxj = int(c.body_jntnum[bids].max()) if len(bids) else 0
            slots = []
            for s in range(maxj):
                per_type: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
                rows_all = np.nonzero(c.body_jntnum[bids] > s)[0]
                jids_all = (c.body_jntadr[bids[rows_all]] + s).astype(np.int32)
                types = c.jnt_type[jids_all]
                for jt in np.unique(types):
                    sel = types == jt
                    per_type[int(jt)] = (
                        rows_all[sel].astype(np.int32),
                        jids_all[sel],
                    )
                slots.append(per_type)
            mocap_rows = np.nonzero(c.body_mocapid[bids] >= 0)[0].astype(np.int32)
            mocap_ids = c.body_mocapid[bids[mocap_rows]].astype(np.int32)
            levels.append(
                FkLevel(
                    bids=bids, pids=pids, slots=tuple(slots),
                    mocap_rows=mocap_rows, mocap_ids=mocap_ids,
                )
            )
        return tuple(levels)

    return _cached(c, "_fk_levels", build)


# ---------------------------------------------------------------------------
# cdof flat dof tables
# ---------------------------------------------------------------------------

# dof classes for the cdof pass
DOF_FREE_LIN = 0   # translational dof of a free joint: cdof = [0, e_k]
DOF_ROT_COL = 1    # rotational dof of free/ball: axis = xmat[:, k]
DOF_SLIDE = 2      # cdof = [0, axis_w]
DOF_HINGE = 3      # cdof = [axis_w, axis_w x offset]


def dof_tables(c: ModelConst):
    """Per-dof static tables for the vectorized cdof computation:
    (dclass, kcol, jid, bid) each (nv,) plus masks."""

    def build(c):
        nv = c.nv
        dclass = np.zeros(nv, np.int32)
        kcol = np.zeros(nv, np.int32)
        for j in range(c.njnt):
            jt = int(c.jnt_type[j])
            dadr = int(c.jnt_dofadr[j])
            if jt == JointType.FREE:
                for k in range(3):
                    dclass[dadr + k] = DOF_FREE_LIN
                    kcol[dadr + k] = k
                for k in range(3):
                    dclass[dadr + 3 + k] = DOF_ROT_COL
                    kcol[dadr + 3 + k] = k
            elif jt == JointType.BALL:
                for k in range(3):
                    dclass[dadr + k] = DOF_ROT_COL
                    kcol[dadr + k] = k
            elif jt == JointType.SLIDE:
                dclass[dadr] = DOF_SLIDE
            else:
                dclass[dadr] = DOF_HINGE
        return dict(
            dclass=dclass,
            kcol=kcol,
            jid=c.dof_jntid.astype(np.int32),
            bid=c.dof_bodyid.astype(np.int32),
            is_free_lin=(dclass == DOF_FREE_LIN),
            is_rot_col=(dclass == DOF_ROT_COL),
            is_slide=(dclass == DOF_SLIDE),
            is_hinge=(dclass == DOF_HINGE),
        )

    return _cached(c, "_dof_tables", build)


# ---------------------------------------------------------------------------
# scalar-joint tables (integrate / passive / limits)
# ---------------------------------------------------------------------------


def scalar_joint_tables(c: ModelConst):
    """Index arrays for 1-dof joints (hinge+slide) and quaternion joints."""

    def build(c):
        sc_j, sc_q, sc_d = [], [], []
        quat = []  # (jt, qadr, dadr)
        for j in range(c.njnt):
            jt = int(c.jnt_type[j])
            qadr = int(c.jnt_qposadr[j])
            dadr = int(c.jnt_dofadr[j])
            if jt in (JointType.HINGE, JointType.SLIDE):
                sc_j.append(j)
                sc_q.append(qadr)
                sc_d.append(dadr)
            else:
                quat.append((jt, qadr, dadr))
        lim_rows = [
            i for i, j in enumerate(sc_j) if bool(c.jnt_limited[j])
        ]
        return dict(
            jid=np.asarray(sc_j, np.int32),
            qadr=np.asarray(sc_q, np.int32),
            dadr=np.asarray(sc_d, np.int32),
            quat=tuple(quat),
            lim_rows=np.asarray(lim_rows, np.int32),
        )

    return _cached(c, "_scalar_joint_tables", build)


# ---------------------------------------------------------------------------
# transmission tables
# ---------------------------------------------------------------------------


def transmission_tables(c: ModelConst):
    def build(c):
        uj, uj_q, uj_d = [], [], []
        ut, ut_t = [], []
        for u in range(c.nu):
            tt = int(c.actuator_trntype[u])
            tid = int(c.actuator_trnid[u])
            if tt == TrnType.JOINT:
                uj.append(u)
                uj_q.append(int(c.jnt_qposadr[tid]))
                uj_d.append(int(c.jnt_dofadr[tid]))
            else:
                ut.append(u)
                ut_t.append(tid)
        # one-hot (n_joint_act, nv) moment pattern for joint actuators
        onehot = np.zeros((len(uj), c.nv), np.float32)
        for r, dadr in enumerate(uj_d):
            onehot[r, dadr] = 1.0
        return dict(
            uj=np.asarray(uj, np.int32), uj_q=np.asarray(uj_q, np.int32),
            uj_d=np.asarray(uj_d, np.int32), onehot=onehot,
            ut=np.asarray(ut, np.int32), ut_t=np.asarray(ut_t, np.int32),
        )

    return _cached(c, "_transmission_tables", build)


# ---------------------------------------------------------------------------
# fixed-tendon tables
# ---------------------------------------------------------------------------


def tendon_tables(c: ModelConst):
    """Partition tendons into fixed (all-JOINT wraps) and spatial. For fixed
    tendons return flat wrap->(tendon, qadr, dadr) index arrays so length and
    jacobian are one segment-sum / scatter each."""

    def build(c):
        fixed_t, spatial_t = [], []
        w_t, w_q, w_d, w_i = [], [], [], []
        for t in range(c.ntendon):
            adr, num = int(c.tendon_adr[t]), int(c.tendon_num[t])
            wtypes = c.wrap_type[adr : adr + num]
            if all(int(wt) == WrapType.JOINT for wt in wtypes):
                fixed_t.append(t)
                for w in range(adr, adr + num):
                    jid = int(c.wrap_objid[w])
                    w_t.append(t)
                    w_q.append(int(c.jnt_qposadr[jid]))
                    w_d.append(int(c.jnt_dofadr[jid]))
                    w_i.append(w)
            else:
                spatial_t.append(t)
        return dict(
            fixed=np.asarray(fixed_t, np.int32),
            spatial=tuple(spatial_t),
            w_t=np.asarray(w_t, np.int32),
            w_q=np.asarray(w_q, np.int32),
            w_d=np.asarray(w_d, np.int32),
            w_i=np.asarray(w_i, np.int32),
        )

    return _cached(c, "_tendon_tables", build)


# ---------------------------------------------------------------------------
# torch copies of static tables
# ---------------------------------------------------------------------------


def on_device(c: ModelConst, key: str, array, device, dtype=None):
    """Torch copy of a static numpy table, cached on the const per device
    and dtype so the hot path never re-uploads index arrays."""
    import torch

    cache = getattr(c, "_torch_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(c, "_torch_tables", cache)
    k = (key, str(torch.device(device)), dtype)
    t = cache.get(k)
    if t is None:
        t = torch.as_tensor(np.array(array), device=device)
        if dtype is not None:
            t = t.to(dtype)
        cache[k] = t
    return t
