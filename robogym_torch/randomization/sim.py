"""Simulation (model-field) randomizers, batched.

Counterpart of `robogym_tpu/randomization/sim.py` (reference
randomization/sim.py:28-589). The JAX package applies each randomizer as
`(Model, key, values) -> Model` under `jax.vmap`, so that each env gets a
model of its own. Here a randomizer draws for the whole batch
(`draw(gen, batch)`) and `apply(fields, draws, values)` writes the batch's
per-env model fields: `fields` is the dict of `envs.core.apply_model_fields`
(field name -> `(B, ...)`, `"opt:<name>"` for an Option field), and a field
that is not in it yet starts from the compiled model's. The result goes into
`EnvState.model_fields`, and `reset`/`step` apply it.

Includes GravityRandomizer, PidRandomizer, JointMarginRandomizer,
GeomSolimpRandomizer, GeomSolrefRandomizer, and GenericSimRandomizer with
all 13 apply modes (sim.py:520-589) and its name-prefix id selection
(sim.py:446-498).

Dtypes follow the JAX package's arithmetic with x64 on: the parameter
values are float64, so where the JAX randomizer mixes them with a field's
draws it computes in float64 (gravity, PID gains, joint margins, solimp,
solref) and the port does so too, before it rounds the result to the
model's dtype; GenericSimRandomizer casts the values to the field's dtype
first, as the JAX one does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.mjcf.model import Model
from robogym_torch.randomization.core import Randomizer
from robogym_torch.utils import rotation as rot

# PID user-gain parameter order (reference robogym/mujoco/constants.py:34-53)
PID_GAIN_PARAMS = [
    "pid_kp", "pid_ti", "pid_imax_clamp", "pid_td", "pid_dsmooth",
    "pid_error_deadband",
]

# fields living on model.opt rather than model (constants.py OPT_FIELDS)
OPT_FIELDS = {"gravity", "wind", "density", "viscosity", "impratio", "timestep"}

Fields = Dict[str, torch.Tensor]


def field_key(field: str) -> str:
    """The `model_fields` key of a model field."""
    return "opt:" + field if field in OPT_FIELDS else field


def _get_field(m: Model, field: str) -> torch.Tensor:
    return getattr(m.opt, field) if field in OPT_FIELDS else getattr(m, field)


def _has_prefixes(name: str, prefixes: Union[str, Sequence[str]]) -> bool:
    if isinstance(prefixes, str):
        prefixes = [prefixes]
    return any(name.startswith(p) for p in prefixes)


def _floats(values) -> List[float]:
    """A parameter vector (numpy, a tensor or a sequence) as floats."""
    if isinstance(values, torch.Tensor):
        return [float(v) for v in values.detach().cpu().reshape(-1)]
    return [float(v) for v in np.asarray(values, np.float64).reshape(-1)]


class SimRandomizer(Randomizer[Fields]):
    """Base of the model-field randomizers. `initialize(model)` binds the
    randomizer to the compiled model and captures its initial values (the
    reference captures them at `initialize`, sim.py:40-51)."""

    def __init__(self, name: str):
        super().__init__(name)
        self._initial_value: Optional[np.ndarray] = None
        self._model: Optional[Model] = None

    def initialize(self, model: Model):
        self._model = model
        self._initialize(model)

    def _initialize(self, model: Model):
        pass

    def _field(self, field: str) -> torch.Tensor:
        return _get_field(self._model, field)

    def _init(self, dtype=None) -> torch.Tensor:
        """The captured initial values on the model's device."""
        return torch.as_tensor(self._initial_value, device=self._model.device,
                               dtype=dtype or self._model.dtype)

    def _base(self, fields: Fields, field: str, batch: int) -> torch.Tensor:
        """Field `field` of the batch, `(B, ...)`: as `fields` has it, else
        the compiled model's, once per env."""
        key = field_key(field)
        if fields and key in fields:
            return fields[key].clone()
        v = self._field(field)
        return v.expand((batch,) + tuple(v.shape)).clone()

    def _normal(self, gen, shape, dtype=None):
        return torch.randn(shape, generator=gen, device=self._model.device,
                           dtype=dtype or self._model.dtype)

    def _uniform(self, gen, shape, dtype=None):
        return torch.rand(shape, generator=gen, device=self._model.device,
                          dtype=dtype or self._model.dtype)


class GravityRandomizer(SimRandomizer):
    """(sim.py:115-137): gravity += a uniform random direction times
    (exp(value) - 1). Draws: `unity` (B, 2) uniform in [0, 1) in float64,
    the direction's azimuth and polar cosine (`rot.random_unity2`, whose
    draws the JAX package makes in its default float dtype)."""

    def __init__(self):
        super().__init__("gravity")
        self._register_sim_parameter(value_min=0.0)

    def _initialize(self, model: Model):
        self._initial_value = model.opt.gravity.detach().cpu().numpy()

    def _draw(self, gen, batch):
        return {"unity": self._uniform(gen, (batch, 2), torch.float64)}

    def _apply(self, fields, draws, values):
        dtype = self._model.opt.gravity.dtype
        direction = rot.random_unity2_apply(draws["unity"]).to(dtype).double()
        mag = math.exp(_floats(values)[0]) - 1.0
        gravity = self._init(dtype).double() + direction * mag
        return dict(fields or {}, **{"opt:gravity": gravity.to(dtype)})


class PidRandomizer(SimRandomizer):
    """(sim.py:140-167): lognormal noise on one PID user-gain column of
    every actuator. Draws: `normal` (B, nu)."""

    def __init__(self, field_name: str):
        super().__init__(field_name)
        self._idx = PID_GAIN_PARAMS.index(field_name)
        self._register_sim_parameter("mean")
        self._register_sim_parameter("std", value_min=0.0)

    def _initialize(self, model: Model):
        self._initial_value = model.actuator_gainprm[:, self._idx].detach().cpu().numpy()

    def _draw(self, gen, batch):
        return {"normal": self._normal(gen, (batch,) + self._initial_value.shape)}

    def _apply(self, fields, draws, values):
        mean, std = _floats(values)[:2]
        noise = mean + abs(std) * draws["normal"].double()
        B = noise.shape[0]
        gp = self._base(fields, "actuator_gainprm", B)
        gp[:, :, self._idx] = (self._init().double() * torch.exp(noise)).to(gp.dtype)
        return dict(fields or {}, actuator_gainprm=gp)


class JointMarginRandomizer(SimRandomizer):
    """(sim.py:170-187): jnt_margin = initial + u (exp(value) - 1) 0.15.
    Draws: `uniform` (B, njnt) in [0, 1)."""

    def __init__(self):
        super().__init__("jnt_margin")
        self._register_sim_parameter(value_min=0.0)

    def _initialize(self, model: Model):
        self._initial_value = model.jnt_margin.detach().cpu().numpy()

    def _draw(self, gen, batch):
        return {"uniform": self._uniform(gen, (batch,) + self._initial_value.shape)}

    def _apply(self, fields, draws, values):
        scale = (math.exp(_floats(values)[0]) - 1.0) * 0.15
        margin = self._init().double() + draws["uniform"].double() * scale
        return dict(fields or {}, jnt_margin=margin.to(self._model.jnt_margin.dtype))


class GeomSolimpRandomizer(SimRandomizer):
    """(sim.py:190-266): lognormal perturbation of (dmin, dmax, width),
    dmin <= dmax, both clipped into `drange`. Draws: `dmax`, `delta` and
    `width`, each (B, ngeom) normal (the JAX package's three split keys,
    in that order)."""

    def __init__(self, drange=(0.5, 0.99)):
        super().__init__("geom_solimp")
        self._drange = drange
        for nm in ("dmax", "delta", "width"):
            self._register_sim_parameter(name=f"{nm}_mean")
            self._register_sim_parameter(name=f"{nm}_std", value_min=0.0)

    def _initialize(self, model: Model):
        self._initial_value = model.geom_solimp[:, :3].detach().cpu().numpy()

    def _draw(self, gen, batch):
        n = self._initial_value.shape[0]
        return {k: self._normal(gen, (batch, n)) for k in ("dmax", "delta", "width")}

    def _apply(self, fields, draws, values):
        dmax_mean, dmax_std, delta_mean, delta_std, width_mean, width_std = _floats(values)[:6]
        init = self._init().double()
        lo, hi = self._drange
        dmax = 1.0 - (1.0 - init[:, 1]) * torch.exp(
            dmax_mean + abs(dmax_std) * draws["dmax"].double())
        dmax = torch.clamp(dmax, lo, hi)
        delta = (init[:, 1] - init[:, 0]) * torch.exp(
            delta_mean + abs(delta_std) * draws["delta"].double())
        dmin = torch.clamp(dmax - delta, lo, hi)
        width = init[:, 2] * torch.exp(width_mean + abs(width_std) * draws["width"].double())
        si = self._base(fields, "geom_solimp", dmax.shape[0])
        si[..., :3] = torch.stack([dmin, dmax, width], dim=-1).to(si.dtype)
        return dict(fields or {}, geom_solimp=si)


class GeomSolrefRandomizer(SimRandomizer):
    """(sim.py:269-314): lognormal noise on the time constant and the
    damping ratio. Draws: `timeconst` and `dampratio`, each (B, ngeom)
    normal (the JAX package's two split keys, in that order)."""

    def __init__(self):
        super().__init__("geom_solref")
        self._register_sim_parameter("timeconst_mean")
        self._register_sim_parameter("timeconst_std", value_min=0.0)
        self._register_sim_parameter("dampratio_mean")
        self._register_sim_parameter("dampratio_std", value_min=0.0)

    def _initialize(self, model: Model):
        self._initial_value = model.geom_solref.detach().cpu().numpy()

    def _draw(self, gen, batch):
        n = self._initial_value.shape[0]
        return {k: self._normal(gen, (batch, n)) for k in ("timeconst", "dampratio")}

    def _apply(self, fields, draws, values):
        tc_mean, tc_std, dr_mean, dr_std = _floats(values)[:4]
        init = self._init().double()
        tc = init[:, 0] * torch.exp(tc_mean + abs(tc_std) * draws["timeconst"].double())
        dr = init[:, 1] * torch.exp(dr_mean + abs(dr_std) * draws["dampratio"].double())
        sr = self._base(fields, "geom_solref", tc.shape[0])
        sr[..., :2] = torch.stack([tc, dr], dim=-1).to(sr.dtype)
        return dict(fields or {}, geom_solref=sr)


class GenericSimRandomizer(SimRandomizer):
    """Any model field, with the reference's 13 apply modes
    (sim.py:343-589) and its name-prefix id selection (sim.py:446-498).
    Draws (B, *selected shape): `normal` for the modes that draw normals,
    `uniform` in [0, 1) for the modes that draw uniforms (`coupled_ranges`
    one a env, (B,)); `coupled` and `coupled_additive` draw nothing, and
    their draws only name the batch (`{"batch": B}`)."""

    MODES_ONE_PARAM = (
        "coupled", "uncoupled", "coupled_mean_variance", "max_additive",
        "coupled_additive", "coupled_symmetric_ranges", "variance",
        "variance_additive",
    )
    MODES_TWO_PARAM = (
        "ranges", "coupled_ranges", "semicorrelated", "variance_mean_additive",
        "uncoupled_mean_variance",
    )
    _NORMAL = ("uncoupled", "variance", "variance_additive", "variance_mean_additive",
               "coupled_mean_variance", "uncoupled_mean_variance")
    _UNIFORM = ("ranges", "semicorrelated", "coupled_symmetric_ranges", "max_additive")

    def __init__(self, name: str, field_name: str, apply_mode: str = "uncoupled_mean_variance",
                 coef: float = 1.0, geom_prefix=None, body_prefix=None, dof_jnt_prefix=None,
                 jnt_prefix=None, positive_only: bool = False, zero_threshold: float = 0.0):
        super().__init__(name)
        self._field_name = field_name
        self._apply_mode = apply_mode
        self._coef = coef
        self._positive_only = positive_only
        self._geom_prefix = geom_prefix
        self._body_prefix = body_prefix
        self._dof_jnt_prefix = dof_jnt_prefix
        self._jnt_prefix = jnt_prefix
        self._zero_threshold = zero_threshold
        self._ids: Optional[np.ndarray] = None

        if apply_mode in ("coupled", "uncoupled", "coupled_mean_variance", "max_additive"):
            self._register_sim_parameter()
        elif apply_mode in ("coupled_additive", "coupled_symmetric_ranges", "variance",
                            "variance_additive"):
            self._register_sim_parameter(value_min=0.0)
        elif apply_mode in ("ranges", "coupled_ranges", "semicorrelated"):
            self._register_sim_parameter(name="low")
            self._register_sim_parameter(name="high")
        elif apply_mode == "variance_mean_additive":
            self._register_sim_parameter(name="mean", value_min=0.0)
            self._register_sim_parameter(name="std", value_min=0.0)
        elif apply_mode == "uncoupled_mean_variance":
            self._register_sim_parameter(name="mean")
            self._register_sim_parameter(name="std", value_min=0.0)
        else:
            raise ValueError(f"Invalid mode: {apply_mode}")

    @property
    def field_name(self) -> str:
        return self._field_name

    @property
    def ids(self) -> Optional[np.ndarray]:
        """The selected ids (rows of the field), or None for all."""
        return self._ids

    # host-side binding
    def _identify_ids(self, model: Model) -> Optional[np.ndarray]:
        """(sim.py:446-498): ids by name prefix."""
        c = model.const
        if self._geom_prefix is not None:
            assert self._field_name.startswith("geom_")
            ids = [gid for name, gid in c.names["geom"].items()
                   if _has_prefixes(name, self._geom_prefix)]
        elif self._body_prefix is not None:
            assert self._field_name.startswith("body_")
            ids = [bid for name, bid in c.names["body"].items()
                   if _has_prefixes(name, self._body_prefix)]
        elif self._dof_jnt_prefix is not None:
            assert self._field_name.startswith("dof_")
            jnt_names = {jid: name for name, jid in c.names["joint"].items()}
            ids = [idx for idx, jid in enumerate(np.asarray(c.dof_jntid))
                   if _has_prefixes(jnt_names[int(jid)], self._dof_jnt_prefix)]
        elif self._jnt_prefix is not None:
            assert self._field_name.startswith("jnt_")
            ids = [jid for name, jid in c.names["joint"].items()
                   if _has_prefixes(name, self._jnt_prefix)]
        else:
            return None
        ids = np.asarray(sorted(ids), np.int64)
        assert len(ids) > 0, f"no IDs matched for {self._field_name}"
        return ids

    def _initialize(self, model: Model):
        self._ids = self._identify_ids(model)
        full = _get_field(model, self._field_name).detach().cpu().numpy()
        self._initial_value = full[self._ids] if self._ids is not None else full
        self._sanity_check()

    def _sanity_check(self):
        multiplicative = {
            "coupled", "uncoupled", "ranges", "coupled_ranges", "semicorrelated",
            "coupled_symmetric_ranges", "variance", "coupled_mean_variance",
            "uncoupled_mean_variance",
        }
        if self._apply_mode in multiplicative:
            zeros = np.isclose(self._initial_value, 0.0).mean()
            assert zeros <= self._zero_threshold, (
                f"Mode is multiplicative on field {self._field_name}, but "
                f"{zeros:.3f} of values are zero (max {self._zero_threshold:.3f})"
            )

    def _draw(self, gen, batch):
        dtype = self._field(self._field_name).dtype
        shape = (batch,) + self._initial_value.shape
        if self._apply_mode in self._NORMAL:
            return {"normal": self._normal(gen, shape, dtype)}
        if self._apply_mode in self._UNIFORM:
            return {"uniform": self._uniform(gen, shape, dtype)}
        if self._apply_mode == "coupled_ranges":
            return {"uniform": self._uniform(gen, (batch,), dtype)}
        return {"batch": batch}

    # batched apply
    def _apply(self, fields, draws, values):
        assert self._initial_value is not None, (
            f"randomizer {self.name} not initialized: call initialize(model)")
        dtype = self._field(self._field_name).dtype
        init = self._init(dtype)
        pv = (torch.as_tensor(_floats(values), dtype=torch.float64) * self._coef).to(dtype)
        pv = pv.to(init.device)
        mode = self._apply_mode
        nd = init.dim()

        def per_env(x):
            """A draw (B,) of one value an env, against (B, *shape)."""
            return x.reshape(x.shape + (1,) * nd)

        if mode == "coupled":
            new = init * torch.exp(pv[0])
        elif mode == "coupled_additive":
            new = init + (torch.exp(pv[0]) - 1.0)
        elif mode == "uncoupled":
            n = pv[0] + draws["normal"]
            new = init * torch.exp(n * torch.abs(pv[0]))
        elif mode in ("ranges", "semicorrelated"):
            low = torch.clamp(-pv[0], max=0.0)
            high = torch.clamp(pv[1], min=0.0)
            new = init * torch.exp(uniform_apply(draws["uniform"], low, high))
        elif mode == "coupled_ranges":
            low = torch.clamp(-pv[0], max=0.0)
            high = torch.clamp(pv[1], min=0.0)
            new = init * torch.exp(per_env(uniform_apply(draws["uniform"], low, high)))
        elif mode == "coupled_symmetric_ranges":
            low, high = -torch.abs(pv[0]), torch.abs(pv[0])
            new = init * torch.exp(uniform_apply(draws["uniform"], low, high))
        elif mode == "variance":
            new = init * torch.exp(draws["normal"] * torch.abs(pv[0]))
        elif mode == "variance_additive":
            scale = torch.exp(torch.abs(pv[0])) - 1.0
            new = init + scale * draws["normal"]
        elif mode == "variance_mean_additive":
            pos = torch.exp(pv[0]) - 1.0
            scale = torch.exp(torch.abs(pv[1])) - 1.0
            new = init + torch.abs(pos + scale * draws["normal"])
        elif mode == "coupled_mean_variance":
            new = init * torch.exp(pv[0] + torch.abs(pv[0]) * draws["normal"])
        elif mode == "uncoupled_mean_variance":
            new = init * torch.exp(pv[0] + torch.abs(pv[1]) * draws["normal"])
        elif mode == "max_additive":
            high = torch.exp(torch.abs(pv[0])) - 1.0
            new = init + uniform_apply(draws["uniform"], torch.zeros_like(high), high)
        else:
            raise RuntimeError(mode)

        if self._positive_only:
            new = torch.clamp(new, min=0.0)

        B = draws["batch"] if "batch" in draws else next(iter(draws.values())).shape[0]
        new = new.expand((B,) + tuple(init.shape))
        if self._ids is not None:
            full = self._base(fields, self._field_name, B)
            full[:, torch.as_tensor(self._ids, device=full.device)] = new.to(full.dtype)
        else:
            full = new.to(dtype).clone()
        return dict(fields or {}, **{field_key(self._field_name): full})
