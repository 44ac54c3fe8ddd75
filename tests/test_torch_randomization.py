"""The port's randomizer framework against the JAX package's, on the CPU.

Mirrors tests/test_randomization.py on the same inline world (a hinged
palm with a PID user actuator, a free cube on a floor), compiled in
float32: the parameter registry and the ADR paths exactly; every sim
randomizer and all 13 modes of `GenericSimRandomizer` against the JAX
randomizer under `jax.vmap` over one key per env, the port fed the samples
the JAX randomizer draws from each key (the same `jax.random` call on the
same split key, in the dtype the JAX call uses: float64 where it names
none, since conftest turns x64 on), to 1e-6; prefix selection; a chain.

Then per-env fields through the physics: `jnt_margin`, `geom_solref`,
`geom_solimp`, `dof_damping`, `geom_friction` and gravity, each env's
own, one substep against the JAX vmapped step to 1e-4 (test_torch_step.py's
substep tolerance) and ten substeps to the env-step envelope of
`_torch_common`. The physics once read `jnt_margin`, `geom_solref` and
`geom_solimp` by plain indexing, which indexes a per-env field's env axis;
`test_per_env_margin_and_solref_reach_the_physics` fails on those reads."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import QPOS_TOL, QVEL_TOL, to_jax
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import step as t_step
from robogym_torch.randomization import core as t_rcore
from robogym_torch.randomization import env as t_renv
from robogym_torch.randomization import parameters as t_params
from robogym_torch.randomization import sim as t_sim
from robogym_tpu.envs import core as j_core
from robogym_tpu.mjcf.compiler import compile_xml
from robogym_tpu.physics import setconst as j_setconst
from robogym_tpu.physics import step as j_step
from robogym_tpu.randomization import core as j_rcore
from robogym_tpu.randomization import env as j_renv
from robogym_tpu.randomization import sim as j_sim

B = 4
TOL = 1e-6

WORLD = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 1" pos="0 0 0"/>
    <body name="robot0:palm" pos="0 0 0.2">
      <joint name="robot0:WRJ1" type="hinge" axis="0 1 0" damping="0.1"
             limited="true" range="-0.5 0.5"/>
      <geom name="robot0:palm_geom" type="box" size="0.04 0.04 0.04" density="500"/>
    </body>
    <body name="cube:middle" pos="0.3 0 0.2">
      <freejoint name="cube:free_j"/>
      <geom name="cube:middle_geom" type="box" size="0.03 0.03 0.03" density="400"/>
    </body>
  </worldbody>
  <actuator>
    <general name="robot0:A_WRJ1" joint="robot0:WRJ1" gaintype="user"
             biastype="user" gainprm="10 0.1 1 0 0 0"/>
  </actuator>
</mujoco>
"""


@pytest.fixture(scope="module")
def models():
    """(JAX Model, port Model on the CPU), float32."""
    jm = compile_xml(WORLD, dtype=jnp.float32)
    return jm, bridge.model_from_numpy(bridge.model_to_numpy(jm), "cpu")


def _keys(seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def _stack(ds):
    out = {}
    for k in ds[0]:
        out[k] = ds[0][k] if k == "batch" else torch.as_tensor(np.stack([d[k] for d in ds]))
    return out


def jax_draws(jr, key):
    """The samples JAX randomizer `jr` draws from `key`, as the port's
    randomizer takes them (one env)."""
    f32 = jnp.float32
    if isinstance(jr, j_sim.GravityRandomizer):
        k1, k2 = jax.random.split(key)
        return {"unity": np.stack([np.asarray(jax.random.uniform(k1, ())),
                                   np.asarray(jax.random.uniform(k2, ()))])}
    if isinstance(jr, j_sim.PidRandomizer):
        return {"normal": np.asarray(jax.random.normal(key, jr._initial_value.shape, f32))}
    if isinstance(jr, j_sim.JointMarginRandomizer):
        return {"uniform": np.asarray(jax.random.uniform(key, jr._initial_value.shape, f32))}
    if isinstance(jr, j_sim.GeomSolimpRandomizer):
        n = jr._initial_value.shape[0]
        return {name: np.asarray(jax.random.normal(k, (n,), f32))
                for name, k in zip(("dmax", "delta", "width"), jax.random.split(key, 3))}
    if isinstance(jr, j_sim.GeomSolrefRandomizer):
        n = jr._initial_value.shape[0]
        return {name: np.asarray(jax.random.normal(k, (n,), f32))
                for name, k in zip(("timeconst", "dampratio"), jax.random.split(key))}
    if isinstance(jr, j_sim.GenericSimRandomizer):
        shape = jr._initial_value.shape
        mode = jr._apply_mode
        if mode in t_sim.GenericSimRandomizer._NORMAL:
            return {"normal": np.asarray(jax.random.normal(key, shape, f32))}
        if mode in t_sim.GenericSimRandomizer._UNIFORM:
            return {"uniform": np.asarray(jax.random.uniform(key, shape, f32))}
        if mode == "coupled_ranges":
            return {"uniform": np.asarray(jax.random.uniform(key, (), f32))}
        return {"batch": B}
    if isinstance(jr, j_rcore.ChainedRandomizer):
        out = {}
        for name, child in jr._randomizers.items():
            key, k = jax.random.split(key)
            out[name] = jax_draws(child, k)
        return out
    raise TypeError(type(jr))


def batch_draws(jr, keys):
    """The port's draws of the batch from the JAX keys."""
    per_env = [jax_draws(jr, k) for k in keys]
    if isinstance(jr, j_rcore.ChainedRandomizer):
        return {name: _stack([d[name] for d in per_env]) for name in per_env[0]}
    return _stack(per_env)


def jax_fields(jr, jm, keys, values, names):
    """The JAX randomizer under `jax.vmap` over the keys: {field: (B, ...)}."""
    out = jax.vmap(jr.apply, in_axes=(None, 0, None))(jm, keys, values)
    return {n: np.asarray(getattr(out.opt, n[4:]) if n.startswith("opt:") else getattr(out, n))
            for n in names}


def assert_fields(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert g.dtype == np.float32, (k, g.dtype)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=TOL,
                                   atol=TOL, err_msg=k)


def _pair(models, make, set_values=None):
    """(JAX randomizer, port randomizer), initialized, with the same values."""
    jm, tm = models
    jr, tr = make(j_sim), make(t_sim)
    jr.initialize(jm)
    tr.initialize(tm)
    if set_values:
        for jp, tp in zip(jr.get_parameters(), tr.get_parameters()):
            assert jp.name == tp.name
            v = set_values(jp)
            jp.set_value(v)
            tp.set_value(v)
    return jr, tr


# ---------------------------------------------------------------------------
# registry and paths
# ---------------------------------------------------------------------------

def test_parameter_registry():
    p = t_params.FloatRandomizerParameter("x", 0.5, (0.0, 1.0), delta=0.1)
    assert p.get_value() == 0.5
    p.set_value(0.7)
    assert p.get_value() == 0.7
    assert p.get_range() == (0.0, 1.0)
    assert p.get_delta() == 0.1
    assert p.dtype == t_params.RandomizerParameter.FLOAT
    with pytest.raises(AssertionError):
        p.set_value(2.0)
    q = t_params.IntRandomizerParameter("n", 3, (1, 8))
    q.set_value(5.9)
    assert q.get_value() == 5 and q.dtype == t_params.RandomizerParameter.INT
    assert repr(q) == "IntRandomizerParameter(name=n, value=5, range=(1, 8))"


def _all_sim(lib):
    return [lib.GravityRandomizer(), lib.PidRandomizer("pid_kp"), lib.JointMarginRandomizer(),
            lib.GeomSolimpRandomizer(), lib.GeomSolrefRandomizer(),
            lib.GenericSimRandomizer("cube_friction", "geom_friction", "coupled",
                                     geom_prefix="cube:")]


def test_env_randomization_paths_match_jax(models):
    """The same registry built in both packages gives the same paths, in
    order, with the same values, ranges and steps; updates by path agree."""
    jm, tm = models
    built = []
    for lib, renv, m in ((j_sim, j_renv, jm), (t_sim, t_renv, tm)):
        sims = _all_sim(lib)
        for r in sims:
            r.initialize(m)
        built.append(renv.build_env_randomization(parameters=Params(),
                                                  simulation_randomizers=sims))
    jrand, trand = built

    def paths(rand):
        out = []
        for r in rand.enumerate_randomizers():
            children = r.get_randomizers() if hasattr(r, "get_randomizers") else [None]
            for child in children:
                params = child.get_parameters() if child is not None else r.get_parameters()
                prefix = r.name + (":" + child.name if child is not None else "")
                out += [(f"{prefix}:{p.name}", p.get_value(), p.get_range(), p.get_delta())
                        for p in params]
        return out

    assert paths(trand) == paths(jrand)
    assert [r.name for r in trand.enumerate_randomizers()] == \
        ["parameters", "observation", "action", "sim"]
    for path, v in (("sim:gravity:value", 1.5), ("sim:geom_solimp:width_std", 0.25),
                    ("sim:cube_friction:value", -0.5), ("parameters:n_random_initial_steps", 7)):
        jrand.update_parameter(path, v)
        trand.update_parameter(path, v)
        assert trand.get_parameter(path).get_value() == jrand.get_parameter(path).get_value() == v
    # a nested dataclass parameter's name holds a ":" of its own, which the
    # path walk of both packages reads as a group (ROADMAP section 3); it
    # is reached through its randomizer
    nested = "simulation_params:cube_size_multiplier"
    for rand in (jrand, trand):
        rand.get_randomizer("parameters").get_parameter(nested).set_value(1.25)
        with pytest.raises(AttributeError):
            rand.get_parameter("parameters:" + nested)
    assert [p.get_value() for p in trand.get_parameters()] == \
        [p.get_value() for p in jrand.get_parameters()]
    with pytest.raises(AssertionError):
        trand.update_parameter("sim:gravity:value", -1.0)


# ---------------------------------------------------------------------------
# sim randomizers against jax.vmap(r.apply)
# ---------------------------------------------------------------------------

SIM_CASES = {
    "gravity": (lambda lib: lib.GravityRandomizer(), ["opt:gravity"], lambda p: 0.7),
    "pid_kp": (lambda lib: lib.PidRandomizer("pid_kp"), ["actuator_gainprm"],
               lambda p: 0.4 if p.name == "std" else 0.5),
    "jnt_margin": (lambda lib: lib.JointMarginRandomizer(), ["jnt_margin"], lambda p: 0.8),
    "geom_solimp": (lambda lib: lib.GeomSolimpRandomizer(), ["geom_solimp"],
                    lambda p: 1.0 if "std" in p.name else 0.5),
    "geom_solref": (lambda lib: lib.GeomSolrefRandomizer(), ["geom_solref"],
                    lambda p: 0.2 if "std" in p.name else 0.1),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_randomizer_matches_jax(models, case):
    make, names, value = SIM_CASES[case]
    jr, tr = _pair(models, make, value)
    keys = _keys(1)
    values = jr.param_values()
    want = jax_fields(jr, models[0], keys, jnp.asarray(values), names)
    got = tr.apply({}, batch_draws(jr, keys), tr.param_values())
    assert_fields(got, want)
    for k in names:       # each env its own draw
        assert (got[k] != got[k][:1]).any(), k


def test_gravity_magnitude_and_identity(models):
    """Value 0 leaves gravity as compiled; value 1 moves it by e - 1."""
    _, tm = models
    r = t_sim.GravityRandomizer()
    r.initialize(tm)
    gen = torch.Generator().manual_seed(0)
    g0 = tm.opt.gravity.double()
    out = r.apply({}, r.draw(gen, B), r.param_values())["opt:gravity"]
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(tm.opt.gravity.numpy(), (B, 3)),
                               atol=1e-12)
    r.get_parameter("value").set_value(1.0)
    out = r.apply({}, r.draw(gen, B), r.param_values())["opt:gravity"]
    np.testing.assert_allclose(torch.linalg.vector_norm(out.double() - g0, dim=-1).numpy(),
                               np.e - 1.0, rtol=1e-6)


def test_solimp_invariant(models):
    """drange[0] <= dmin <= dmax <= drange[1] under wide noise."""
    _, tm = models
    r = t_sim.GeomSolimpRandomizer()
    r.initialize(tm)
    for p in r.get_parameters():
        p.set_value(1.0 if "std" in p.name else 0.5)
    si = r.apply({}, r.draw(torch.Generator().manual_seed(5), 64), r.param_values())
    si = si["geom_solimp"].numpy()
    assert (si[..., 0] <= si[..., 1] + 1e-7).all()
    assert (si[..., 0] >= 0.5 - 1e-7).all() and (si[..., 1] <= 0.99 + 1e-7).all()


MODES = t_sim.GenericSimRandomizer.MODES_ONE_PARAM + t_sim.GenericSimRandomizer.MODES_TWO_PARAM


@pytest.mark.parametrize("mode", MODES)
def test_generic_mode_matches_jax(models, mode):
    """Each of the 13 modes on dof_damping (positive only), the first value
    0.3 and the second 0.5, against the JAX mode under vmap."""
    assert len(MODES) == 13

    def make(lib):
        return lib.GenericSimRandomizer(f"m_{mode}", field_name="dof_damping", apply_mode=mode,
                                        positive_only=True, zero_threshold=1.0)

    values = iter([0.3, 0.5])
    first = {}

    def value(p):
        if p.name not in first:
            first[p.name] = next(values)
        lo, hi = p.get_range()
        return min(max(first[p.name], lo), hi)

    jr, tr = _pair(models, make, value)
    keys = _keys(3)
    want = jax_fields(jr, models[0], keys, jnp.asarray(jr.param_values()), ["dof_damping"])
    got = tr.apply({}, batch_draws(jr, keys), tr.param_values())
    assert_fields(got, want)
    out = got["dof_damping"].numpy()
    assert out.shape == (B, models[1].const.nv) and np.isfinite(out).all() and (out >= 0).all()


@pytest.mark.parametrize("mode", ["coupled", "uncoupled_mean_variance", "coupled_ranges"])
def test_generic_prefix_selection_matches_jax(models, mode):
    """geom_friction on the `cube:` geoms only: the selected rows against
    JAX, the others the compiled model's in every env."""
    jm, tm = models

    def make(lib):
        return lib.GenericSimRandomizer("cube_friction", field_name="geom_friction",
                                        apply_mode=mode, geom_prefix="cube:")

    jr, tr = _pair(models, make, lambda p: 0.6 if p.name != "std" else 0.3)
    names = tm.const.names["geom"]
    np.testing.assert_array_equal(tr.ids, [names["cube:middle_geom"]])
    keys = _keys(2)
    want = jax_fields(jr, jm, keys, jnp.asarray(jr.param_values()), ["geom_friction"])
    got = tr.apply({}, batch_draws(jr, keys), tr.param_values())
    assert_fields(got, want)
    g = got["geom_friction"].numpy()
    for other in ("floor", "robot0:palm_geom"):
        np.testing.assert_array_equal(g[:, names[other]],
                                      np.broadcast_to(tm.geom_friction[names[other]].numpy(),
                                                      (B, 3)))
    if mode == "coupled":
        np.testing.assert_allclose(g[:, names["cube:middle_geom"]],
                                   np.broadcast_to(tm.geom_friction[names["cube:middle_geom"]]
                                                   .numpy() * np.exp(0.6), (B, 3)), rtol=1e-6)


def _chain(lib):
    return [lib.GravityRandomizer(), lib.JointMarginRandomizer(), lib.GeomSolrefRandomizer(),
            lib.GeomSolimpRandomizer(),
            lib.GenericSimRandomizer("damping", "dof_damping", "uncoupled_mean_variance",
                                     dof_jnt_prefix="robot0:"),
            lib.GenericSimRandomizer("friction", "geom_friction", "ranges",
                                     geom_prefix=["cube:", "robot0:"])]


def _chain_pair(models):
    jm, tm = models
    out = []
    for lib, m in ((j_sim, jm), (t_sim, tm)):
        rs = _chain(lib)
        for r in rs:
            r.initialize(m)
        rs[2].disable()       # a disabled child draws nothing and changes nothing
        out.append(rs)
    jrs, trs = out
    jchain = j_renv.EnvSimulationRandomizer(jrs)
    tchain = t_renv.EnvSimulationRandomizer(trs)
    for jp, tp in zip(jchain.get_parameters(), tchain.get_parameters()):
        v = min(max(0.4 if "std" not in jp.name else 0.2, jp.get_range()[0]), jp.get_range()[1])
        jp.set_value(v)
        tp.set_value(v)
    return jchain, tchain


CHAIN_FIELDS = ["opt:gravity", "jnt_margin", "geom_solimp", "dof_damping", "geom_friction"]


def test_chain_matches_jax(models):
    """A simulation chain (one child disabled): the JAX chain splits its
    key once per child, in order; the port's children get those keys'
    draws."""
    jm, _ = models
    jchain, tchain = _chain_pair(models)
    keys = _keys(4)
    jvalues = {k: jnp.asarray(v) for k, v in jchain.param_values().items()}
    want = jax_fields(jchain, jm, keys, jvalues, CHAIN_FIELDS)
    draws = batch_draws(jchain, keys)
    draws["geom_solref"] = {}
    got = tchain.apply({}, draws, tchain.param_values())
    assert_fields(got, want)
    assert tchain.get_randomizer("geom_solref").draw(torch.Generator(), B) == {}


# ---------------------------------------------------------------------------
# per-env fields through the physics
# ---------------------------------------------------------------------------

def _start(tm):
    """B envs: the palm's hinge 0.1 rad inside its upper limit, the cube
    0.5 mm into the floor at a seeded yaw, settled by nothing."""
    rng = np.random.default_rng(0)
    qpos = np.tile(tm.qpos0.numpy(), (B, 1))
    qpos[:, 0] = 0.4
    qpos[:, 3] = 0.0295
    yaw = rng.uniform(-np.pi, np.pi, B)
    qpos[:, 4:8] = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1)
    qvel = np.zeros((B, tm.const.nv), np.float32)
    qvel[:, 0] = 0.5
    return make_data(tm, B, torch.as_tensor(qpos, dtype=torch.float32)).replace(
        qvel=torch.as_tensor(qvel), ctrl=torch.full((B, tm.const.nu), 0.45))


def seeded_fields(tm):
    """Each env's own jnt_margin (the hinge's margin 0, 0.06, 0.12, 0.2 against its
    0.1 rad to the limit: the limit row is live in the last two envs
    only), geom_solref (time constants 0.02, 0.005, 0.04, 0.01 s),
    geom_solimp, dof_damping, geom_friction and gravity."""
    rng = np.random.default_rng(1)
    f = {}
    jm = np.zeros((B, tm.const.njnt), np.float32)
    jm[:, 0] = [0.0, 0.06, 0.12, 0.2]
    f["jnt_margin"] = jm
    sr = np.broadcast_to(tm.geom_solref.numpy(), (B,) + tuple(tm.geom_solref.shape)).copy()
    sr[..., 0] = np.array([0.02, 0.005, 0.04, 0.01])[:, None]
    sr[..., 1] = rng.uniform(0.7, 1.3, (B, 1))
    f["geom_solref"] = sr
    si = np.broadcast_to(tm.geom_solimp.numpy(), (B,) + tuple(tm.geom_solimp.shape)).copy()
    si[..., 0] = rng.uniform(0.6, 0.9, (B, 1))
    f["geom_solimp"] = si
    f["dof_damping"] = (tm.dof_damping.numpy() * rng.uniform(0.5, 2.0, (B, tm.const.nv))
                        + rng.uniform(0, 0.05, (B, tm.const.nv)))
    f["geom_friction"] = tm.geom_friction.numpy() * rng.uniform(0.5, 2.0, (B, tm.const.ngeom, 1))
    f["opt:gravity"] = tm.opt.gravity.numpy() + 0.5 * rng.standard_normal((B, 3))
    return {k: np.asarray(v, np.float32) for k, v in f.items()}


def _jax_steps(jm, fields, d, n):
    j_setconst.invweight0(jm)
    step = jax.jit(jax.vmap(lambda mf, x: j_step.step(j_core.apply_model_fields(jm, mf), x)))
    mf = {k: jnp.asarray(v) for k, v in fields.items()}
    jd = to_jax(d)
    for _ in range(n):
        jd = step(mf, jd)
    return bridge.data_to_numpy(jd)


def test_per_env_margin_and_solref_reach_the_physics(models):
    """Each env's own jnt_margin and geom_solref (and solimp, damping,
    friction, gravity): one substep to 1e-4 and ten to the env-step
    envelope against the JAX vmapped step. The margin decides whether the
    hinge's limit row is live, so a read of another env's margin changes
    the force on the palm; the solref sets the floor contact's
    stiffness."""
    jm, tm = models
    fields = seeded_fields(tm)
    m = t_core.apply_model_fields(tm, {k: torch.as_tensor(v) for k, v in fields.items()})
    d = _start(tm)
    one = bridge.data_to_numpy(t_step.step(m, d))
    assert one["contact.active"].any(1).all()
    want = _jax_steps(jm, fields, d, 1)
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(one[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    ten = bridge.data_to_numpy(t_step.step_n(m, d, 10))
    want = _jax_steps(jm, fields, d, 10)
    np.testing.assert_allclose(ten["qpos"], want["qpos"], rtol=0, atol=QPOS_TOL)
    np.testing.assert_allclose(ten["qvel"], want["qvel"], rtol=0, atol=QVEL_TOL)
    # the fields matter: the same start under the shared model moves otherwise
    shared = bridge.data_to_numpy(t_step.step_n(tm, d, 10))
    assert np.abs(shared["qvel"][:, 0] - ten["qvel"][:, 0]).max() > 10 * QVEL_TOL


def test_randomized_fields_reach_the_physics(models):
    """The chain's own fields (its draws from the JAX keys) through one
    substep, against the JAX vmapped step on the same fields."""
    jm, tm = models
    _, tchain = _chain_pair(models)
    jchain, _ = _chain_pair(models)
    keys = _keys(6)
    draws = batch_draws(jchain, keys)
    draws["geom_solref"] = {}
    fields = tchain.apply({}, draws, tchain.param_values())
    assert sorted(fields) == sorted(CHAIN_FIELDS)
    m = t_core.apply_model_fields(tm, fields)
    d = _start(tm)
    got = bridge.data_to_numpy(t_step.step(m, d))
    want = _jax_steps(jm, {k: v.numpy() for k, v in fields.items()}, d, 1)
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# dataclass ADR parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubParams:
    cube_size_multiplier: float = t_renv.randomizable(1.0, low=0.5, high=2.0)


@dataclasses.dataclass(frozen=True)
class Params:
    n_random_initial_steps: int = t_renv.randomizable(10, low=0, high=50)
    simulation_params: SubParams = dataclasses.field(default_factory=SubParams)


def test_enumerate_randomizable_params_matches_jax():
    got = [(p.name, p.value_type, p.default, p.value_range)
           for p in t_renv.enumerate_randomizable_params(Params())]
    want = [(p.name, p.value_type, p.default, p.value_range)
            for p in j_renv.enumerate_randomizable_params(Params())]
    assert got == want
    assert {g[0] for g in got} == {"n_random_initial_steps",
                                   "simulation_params:cube_size_multiplier"}


def test_env_parameter_randomizer_roundtrip():
    params = Params()
    r = t_renv.EnvParameterRandomizer(params)
    assert isinstance(r.get_parameter("n_random_initial_steps"),
                      t_params.IntRandomizerParameter)
    assert r.get_parameter("n_random_initial_steps").get_value() == 10
    r.get_parameter("n_random_initial_steps").set_value(20)
    r.get_parameter("simulation_params:cube_size_multiplier").set_value(1.5)
    new = r.apply(params)
    assert new.n_random_initial_steps == 20
    assert new.simulation_params.cube_size_multiplier == 1.5
    assert params.n_random_initial_steps == 10


def test_build_env_randomization_and_disable(models):
    _, tm = models
    grav = t_sim.GravityRandomizer()
    grav.initialize(tm)
    rand = t_renv.build_env_randomization(parameters=Params(), simulation_randomizers=[grav])
    rand.update_parameter("parameters:n_random_initial_steps", 5)
    assert rand.get_parameter("parameters:n_random_initial_steps").get_value() == 5
    rand.update_parameter("sim:gravity:value", 2.0)
    assert rand.get_parameter("sim:gravity:value").get_value() == 2.0
    assert isinstance(rand.get_randomizer("sim"), t_rcore.ChainedRandomizer)
    grav.disable()
    fields = {"jnt_margin": tm.jnt_margin.expand(B, -1)}
    assert grav.apply(fields, {}, grav.param_values()) is fields
    assert grav.draw(torch.Generator(), B) == {}
