"""The port's PPO learner (`robogym_torch/train/ppo.py`) against the JAX
package's (`robogym_tpu/train/ppo.py`), on the CPU.

Parameters are drawn with numpy and carried across (`policy_from_numpy`),
batches too. `policy_apply`, `gaussian_logp`, `gae` and `ppo_loss` to
1e-10 in float64 and 1e-5 in float32; the loss's gradients against
`jax.grad` to 1e-5 relative (float32) and `ppo_update`'s new parameters to
1e-5. Then `train_step` on the reach stand-in at B=4 (the reach env of
tests/test_torch_reach.py, whose fixtures this file takes), from the JAX
reset state carried across, fed the noise the JAX step draws from its key:
the observations, actions, log densities and values before the step to
1e-5; the physics after it by the nudge rule of
`_torch_common.assert_physics_close` (both packages' nudged runs, as
test_torch_reach.py holds a step), the rewards on the calm envs to the
envelope's qpos tolerance; the update against the JAX update of the same
batch to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogym_torch.train import ppo as t_ppo
from robogym_tpu.train import ppo as j_ppo
from test_torch_reach import (B, QPOS_TOL, _np, _t, assert_physics_close, bridge,  # noqa: F401
                              jax_env, jax_nudged, jax_reset, port_built, port_env, step_draws,
                              to_port)

OBS, ACT, HIDDEN, N = 11, 4, 16, 32
TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _params(seed=0, obs=OBS, act=ACT, hidden=HIDDEN):
    rng = np.random.default_rng(seed)
    return dict(w1=rng.standard_normal((obs, hidden)) / np.sqrt(obs),
                b1=0.1 * rng.standard_normal(hidden),
                w2=rng.standard_normal((hidden, 2 * act)) / np.sqrt(hidden),
                b2=0.1 * rng.standard_normal(2 * act),
                vw=rng.standard_normal((hidden, 1)) / np.sqrt(hidden))


def _batch(seed=1, n=N):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.standard_normal((n, OBS)), actions=rng.uniform(-1, 1, (n, ACT)),
                logp_old=rng.normal(-4.0, 1.0, n), advantages=rng.standard_normal(n),
                returns=rng.standard_normal(n), values_old=rng.standard_normal(n))


def _both(params, batch, dt):
    """(port policy, port batch, JAX params, JAX batch) in dtype `dt`."""
    tdt = torch.float64 if dt is np.float64 else torch.float32
    policy = t_ppo.policy_from_numpy({k: v.astype(dt) for k, v in params.items()},
                                     device="cpu", dtype=tdt)
    jp = j_ppo.PolicyParams(**{k: jnp.asarray(v.astype(dt)) for k, v in params.items()})
    tb = t_ppo.PPOBatch(**{k: torch.as_tensor(v.astype(dt)) for k, v in batch.items()})
    jb = j_ppo.PPOBatch(**{k: jnp.asarray(v.astype(dt)) for k, v in batch.items()})
    return policy, tb, jp, jb


def _close(got, want, tol, rel=False):
    g, w = _np(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(w).max(), 1e-30) if rel else 1.0
    np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("dt", [np.float64, np.float32], ids=["f64", "f32"])
def test_policy_functions_match_jax(dt):
    """`policy_apply`, `gaussian_logp`, `flatten_obs`, `gae` (T=5, with
    dones) and `ppo_loss` (with and without the entropy bonus)."""
    tol = TOL[dt]
    params, batch = _params(), _batch()
    policy, tb, jp, jb = _both(params, batch, dt)
    for got, want in zip(t_ppo.policy_apply(policy, tb.obs), j_ppo.policy_apply(jp, jb.obs)):
        _close(got, want, tol)
    mean, log_std, _ = j_ppo.policy_apply(jp, jb.obs)
    _close(t_ppo.gaussian_logp(torch.as_tensor(np.asarray(mean)),
                               torch.as_tensor(np.asarray(log_std)), tb.actions),
           j_ppo.gaussian_logp(mean, log_std, jb.actions), tol)
    rng = np.random.default_rng(2)
    obs = {k: rng.standard_normal((N, n)).astype(dt) for k, n in (("b", 6), ("a", 5), ("c", 1))}
    np.testing.assert_array_equal(
        _np(t_ppo.flatten_obs({k: torch.as_tensor(v) for k, v in obs.items()})),
        np.asarray(j_ppo.flatten_obs({k: jnp.asarray(v) for k, v in obs.items()})))
    T = 5
    r, v = rng.standard_normal((T, N)).astype(dt), rng.standard_normal((T, N)).astype(dt)
    d = (rng.random((T, N)) < 0.2).astype(dt)
    last = rng.standard_normal(N).astype(dt)
    for got, want in zip(t_ppo.gae(*map(torch.as_tensor, (r, v, d, last))),
                         j_ppo.gae(*map(jnp.asarray, (r, v, d, last)))):
        _close(got, want, tol)
    for kw in ({}, {"ent_coef": 0.01, "clip_eps": 0.1}):
        _close(t_ppo.ppo_loss(policy, tb, **kw), j_ppo.ppo_loss(jp, jb, **kw), tol)


def test_gradients_and_update_match_jax():
    """The loss's gradients (`ppo_grads`) against `jax.grad` in float32 to
    1e-5 of each gradient's largest entry, and `ppo_update`'s new
    parameters and loss to 1e-5."""
    params, batch = _params(3), _batch(4)
    policy, tb, jp, jb = _both(params, batch, np.float32)
    loss, grads = t_ppo.ppo_grads(policy, tb)
    jgrads = jax.grad(j_ppo.ppo_loss)(jp, jb)
    for k in t_ppo.FIELDS:
        _close(grads[k], getattr(jgrads, k), 1e-5, rel=True)
    new, loss2 = t_ppo.ppo_update(policy, tb, lr=0.05)
    jnew, jloss = j_ppo.ppo_update(jp, jb, lr=0.05)
    _close(loss2, jloss, 1e-5)
    for k in t_ppo.FIELDS:
        _close(getattr(new, k), getattr(jnew, k), 1e-5)
    assert not torch.equal(new.w1, policy.w1)
    # the policy's own parameters are left as they were
    np.testing.assert_array_equal(_np(policy.w1), params["w1"].astype(np.float32))


def test_init_policy_shapes_and_scales():
    """`init_policy`: the JAX shapes, zero biases, weights scaled by
    1/sqrt(fan in), and the same draws from the same seed."""
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (t_ppo.init_policy(g, 79, 20, hidden=256) for g in gens)
    assert tuple(a.w1.shape) == (79, 256) and tuple(a.w2.shape) == (256, 40)
    assert tuple(a.vw.shape) == (256, 1) and not bool(a.b1.any()) and not bool(a.b2.any())
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in t_ppo.FIELDS)
    assert abs(float(a.w1.detach().std()) * np.sqrt(79) - 1) < 0.05
    assert abs(float(a.w2.detach().std()) * np.sqrt(256) - 1) < 0.05


def _jax_act(env, params, state_b, key):
    """The rollout half of the JAX package's dry-run `train_step`
    (`__graft_entry__.py`): its batch, its step's outputs and the noise."""
    obs_flat = j_ppo.flatten_obs(jax.vmap(env._observe)(state_b))
    mean, log_std, value = j_ppo.policy_apply(params, obs_flat)
    noise = jax.random.normal(key, mean.shape, mean.dtype)
    actions = jnp.clip(mean + noise * jnp.exp(log_std), -1.0, 1.0)
    logp_old = j_ppo.gaussian_logp(mean, log_std, actions)
    out = jax.jit(jax.vmap(env.step))(state_b, actions)
    r = out[2].sum(-1)
    adv, ret = j_ppo.gae(r[None], value[None], out[3].astype(r.dtype)[None], value)
    return j_ppo.PPOBatch(obs_flat, actions, logp_old, adv[0], ret[0], value), out, noise


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x


def float64_act(env, policy, state, noise, draws):
    """`act` in float64 (the env's model, the state, the policy and the
    noise) from the same state: a run perturbed by rounding alone. Its new
    state."""
    from robogym_torch.envs import core as t_core

    model = env.model
    env.model = bridge.model_to(model, "cpu", torch.float64)
    p64 = t_ppo.policy_from_numpy({k: _np(getattr(policy, k)) for k in t_ppo.FIELDS},
                                  device="cpu", dtype=torch.float64)
    try:
        return t_ppo.act(env, p64, t_core.tree_map(_f64, state), noise.double(), draws)[0]
    finally:
        env.model = model


def test_train_step_on_the_reach_stand_in_matches_jax(port_env, jax_env, jax_reset):
    """One `train_step` at B=4 from the JAX reset state, hidden 32, fed
    the JAX draw's noise (the env's step draws from the JAX state's keys).
    The port's perturbed runs are three nudged ones and its float64 run:
    with these saturated actions env 1 meets a float32 discontinuity that
    no nudge moves (the port's float32 step parts from its float64 step,
    and from the JAX package's, by 0.051 rad/s, while the float64 step and
    the JAX package's agree to 9e-6)."""
    _, jstate, _ = jax_reset
    obs_size = int(j_ppo.flatten_obs(jax.vmap(jax_env._observe)(jstate)).shape[-1])
    params = _params(6, obs=obs_size, act=20, hidden=32)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jp = j_ppo.PolicyParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jbatch, jout, noise = _jax_act(jax_env, jp, jstate, jax.random.PRNGKey(2))
    policy = t_ppo.policy_from_numpy(params, device="cpu")
    state, draws = to_port(jstate), step_draws(jstate)
    new_state, batch, reward = t_ppo.act(port_env, policy, state, _t(noise), draws)
    for k in ("obs", "actions", "logp_old", "values_old"):
        _close(getattr(batch, k), getattr(jbatch, k), 1e-5)

    def run(qvel):
        s = state.replace(physics=state.physics.replace(qvel=qvel))
        return t_ppo.act(port_env, policy, s, _t(noise), draws)[0]

    from _torch_common import nudged_runs

    runs = nudged_runs(run, state.physics.qvel) + [float64_act(port_env, policy, state,
                                                               _t(noise), draws)]
    nudged = [bridge.data_to_numpy(s.physics) for s in runs]
    jstep = jax.jit(jax.vmap(jax_env.step))
    calm = ~assert_physics_close(bridge.data_to_numpy(new_state.physics),
                                 bridge.data_to_numpy(jout[0].physics), None, nudged,
                                 ref_nudged=jax_nudged(jstep, jstate, jbatch.actions))
    np.testing.assert_allclose(_np(reward)[calm], np.asarray(jout[2])[calm], rtol=0,
                               atol=QPOS_TOL)
    # the update: the port's train_step against the JAX update of its batch
    new_policy, st2, rmean, loss = t_ppo.train_step(port_env, policy, state, noise=_t(noise),
                                                    draws=draws)
    assert all(np.array_equal(a, b) for a, b in zip(bridge.data_to_numpy(st2.physics).values(),
                                                     bridge.data_to_numpy(new_state.physics).values()))
    jb = j_ppo.PPOBatch(*(jnp.asarray(_np(x)) for x in batch))
    jnew, jloss = j_ppo.ppo_update(jp, jb)
    _close(loss, jloss, 1e-5)
    for k in t_ppo.FIELDS:
        _close(getattr(new_policy, k), getattr(jnew, k), 1e-5)
    _close(rmean, _np(reward).mean(), 1e-6)
    assert bool(torch.isfinite(loss)) and not torch.equal(new_policy.w1, policy.w1)
