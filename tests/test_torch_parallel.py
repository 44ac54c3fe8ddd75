"""The port's data and tensor parallelism (`robogym_torch/parallel/`,
`robogym_torch/train/ppo.py` under a mesh), on the CPU over
`torch.distributed` with the gloo backend.

Each multi-rank test spawns its ranks as processes (one torch thread each)
that join a gloo group on localhost and write what they computed to files;
the test joins them with a timeout of at most 300 s and holds their
results to a one-rank run made in the test's own process:
  * `make_mesh`'s (dp, tp) layouts, by rank, at world sizes 1 and 4;
  * two ranks at dp=2: `sharded_reset` and a 3-step `make_rollout_fn` of
    the reach stand-in at a global batch of 4 (2 envs a rank) equal the
    one-rank run's blocks bit for bit, and their metrics its metrics;
  * two ranks at tp=2: the sharded policy's outputs and its slices of the
    gradients equal the unsharded policy's (float64, 1e-12);
  * two ranks at dp=2: `ppo_update` on each rank's half of a batch gives
    the full batch's update (float64, 1e-12) and loss.
The rollout metrics are also held to the JAX package's `make_rollout_fn`
on the same draws: both packages drive one stub env (a deterministic
step) with a deterministic policy, so each step's reward, done and
success are the same in both: the reward's mean to 1e-12 (float64), the
done and success shares to 1e-7 (the JAX package takes a flag's mean in
float32, the port in the reward's dtype)."""

import dataclasses
import multiprocessing as mp
import os
import socket
import traceback

import numpy as np
import pytest
import torch

JOIN_TIMEOUT = 300   # s, each multi-rank test's ranks together


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, out, args):
    """A rank: join the gloo group, run `fn(rank, world, *args)`, save its
    dict of arrays (or the error) to `out`/<rank>.npz."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        res = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        np.savez(os.path.join(out, f"{rank}.npz"), **res)
    except BaseException:
        with open(os.path.join(out, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())


def run_ranks(fn, world, tmp_path, *args):
    """`fn` on `world` gloo ranks, each a spawned process; their results by
    rank. Fails on an error or on ranks still running after JOIN_TIMEOUT."""
    ctx = mp.get_context("spawn")
    port, out = _free_port(), str(tmp_path)
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errs = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))
            if f.endswith(".err")]
    assert not errs, errs[0]
    assert not alive, f"{len(alive)} ranks still running after {JOIN_TIMEOUT} s"
    return [dict(np.load(os.path.join(out, f"{r}.npz"))) for r in range(world)]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _layout(rank, world):
    from robogym_torch.parallel import mesh as mesh_lib

    out = {}
    for name, kw in (("all", {}), ("tp2", {"tp": 2}), ("half", {"n_devices": 2})):
        m = mesh_lib.make_mesh(device="cpu", **kw)
        out[name] = np.array([m.dp, m.tp, m.dp_index, m.tp_index, int(m.member),
                              m.dp_group is not None, m.tp_group is not None])
    return out


def test_make_mesh_one_rank():
    """With no process group: one rank, dp = tp = 1, no group, this rank's
    block the whole batch; a tp or size the world cannot hold raises."""
    from robogym_torch.parallel import mesh as mesh_lib

    m = mesh_lib.make_mesh(device="cpu")
    assert m.shape == {"dp": 1, "tp": 1} and (m.dp_index, m.tp_index) == (0, 0)
    assert m.member and m.dp_group is None and m.tp_group is None
    x = {"a": torch.arange(6.0).reshape(3, 2), "t": torch.tensor(1.0)}
    got = mesh_lib.shard_env_batch(m, x)
    assert torch.equal(got["a"], x["a"]) and torch.equal(got["t"], x["t"])
    assert torch.equal(mesh_lib.replicate(m, x)["a"], x["a"])
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(tp=2, device="cpu")
    m2 = mesh_lib.make_mesh(axis_names=("data", "model"), device="cpu")
    assert m2.shape == {"data": 1, "model": 1} and m2.dp == 1


def test_make_mesh_layouts_on_four_ranks(tmp_path):
    """World 4: rank r at (r, 0) of dp=4; at tp=2 at (r // 2, r % 2) with
    both groups; over the first 2 ranks dp=2, ranks 2 and 3 not members."""
    res = run_ranks(_layout, 4, tmp_path)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["all"], [4, 1, r, 0, 1, 1, 0])
        np.testing.assert_array_equal(got["tp2"], [2, 2, r // 2, r % 2, 1, 1, 1])
        want = [2, 1, r, 0, 1, 1, 0] if r < 2 else [2, 1, -1, -1, 0, 0, 0]
        np.testing.assert_array_equal(got["half"], want)


# ---------------------------------------------------------------------------
# data parallel rollouts of the reach stand-in
# ---------------------------------------------------------------------------

GLOBAL_B, STEPS = 4, 3


def _rollout(rank, world):
    """The reach stand-in (seed 0) reset at a global batch of GLOBAL_B and
    rolled out STEPS steps (actions from a generator seeded 3), on this
    rank's block: its physics after each, and the metrics."""
    from robogym_torch import bridge
    from robogym_torch.envs.dactyl import reach
    from robogym_torch.parallel import mesh as mesh_lib
    from robogym_torch.parallel import rollout

    m = mesh_lib.make_mesh(device="cpu")
    env = reach.make_env(device="cpu", seed=0)
    state, obs = rollout.sharded_reset(env, m, GLOBAL_B)
    out = {"reset." + k: v for k, v in bridge.data_to_numpy(state.physics).items()}
    out["reset.goal"] = state.goal["fingertip_pos"].numpy()
    gen = torch.Generator().manual_seed(3)
    state, metrics = rollout.make_rollout_fn(env, m, STEPS)(state, gen)
    out.update({"rollout." + k: v for k, v in bridge.data_to_numpy(state.physics).items()})
    out.update({"metric." + k: np.asarray(float(v)) for k, v in metrics.items()})
    sm_state, sm = rollout.make_shardmap_rollout_fn(env, m, 1, seed=5)(state)
    out.update({"shardmap." + k: np.asarray(float(v)) for k, v in sm.items()})
    return out


def test_dp2_reset_and_rollout_equal_one_rank(tmp_path):
    """Two ranks at dp=2: each rank's reset and 3-step rollout are its
    block of the one-rank run, bit for bit; the global metrics equal the
    one-rank run's (float32 means of the same values in another order,
    1e-6)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    one = _rollout(0, 1)
    ranks = run_ranks(_rollout, 2, tmp_path)
    for k, v in one.items():
        if k.startswith("shardmap."):   # each rank's own draws: the ranks agree
            continue
        if k.startswith("metric."):
            for r in ranks:
                np.testing.assert_allclose(r[k], v, rtol=0, atol=1e-6, err_msg=k)
            continue
        np.testing.assert_array_equal(np.concatenate([r[k] for r in ranks]), v, err_msg=k)
    assert np.isfinite(ranks[0]["shardmap.reward_mean"])
    assert float(ranks[0]["shardmap.reward_mean"]) == float(ranks[1]["shardmap.reward_mean"])


# ---------------------------------------------------------------------------
# tensor and data parallel policy
# ---------------------------------------------------------------------------

OBS, ACT, HIDDEN, N = 9, 3, 8, 16


def _params():
    rng = np.random.default_rng(0)
    return dict(w1=rng.standard_normal((OBS, HIDDEN)) / 3, b1=0.1 * rng.standard_normal(HIDDEN),
                w2=rng.standard_normal((HIDDEN, 2 * ACT)) / 3, b2=0.1 * rng.standard_normal(2 * ACT),
                vw=rng.standard_normal((HIDDEN, 1)) / 3)


def _batch():
    from robogym_torch.train import ppo

    rng = np.random.default_rng(1)
    return ppo.PPOBatch(*(torch.as_tensor(a) for a in (
        rng.standard_normal((N, OBS)), rng.uniform(-1, 1, (N, ACT)), rng.normal(-3, 1, N),
        rng.standard_normal(N), rng.standard_normal(N), rng.standard_normal(N))))


def _policy_run(rank, world, tp):
    """The policy of `_params` under a mesh of `world` ranks at `tp`: its
    outputs on the whole batch (tp) or its loss and update on this rank's
    block (dp), in float64."""
    from robogym_torch.parallel import mesh as mesh_lib
    from robogym_torch.train import ppo

    m = mesh_lib.make_mesh(tp=tp, device="cpu") if world > 1 else None
    policy = ppo.policy_from_numpy(_params(), m, device="cpu", dtype=torch.float64)
    batch = _batch()
    if m is not None and m.dp > 1:
        batch = ppo.PPOBatch(*mesh_lib.shard_env_batch(m, tuple(batch)))
    out = {f"apply{i}": o.detach().numpy()
           for i, o in enumerate(ppo.policy_apply(policy, batch.obs))}
    loss, grads = ppo.ppo_grads(policy, batch)
    new, loss2 = ppo.ppo_update(policy, batch, lr=0.1)
    out.update({"grad." + k: v.numpy() for k, v in grads.items()})
    out.update({"new." + k: getattr(new, k).detach().numpy() for k in ppo.FIELDS})
    out["loss"], out["loss2"] = loss.numpy(), loss2.numpy()
    return out


def _tp_slice(k, v, r, world):
    n = HIDDEN // world
    s = slice(r * n, (r + 1) * n)
    return {"w1": lambda: v[:, s], "b1": lambda: v[s], "w2": lambda: v[s],
            "vw": lambda: v[s], "b2": lambda: v}[k]()


def test_tp2_policy_outputs_and_gradients_equal_unsharded(tmp_path):
    """Two ranks at tp=2, each with half of the hidden layer: the outputs
    on the whole batch, the loss, and each rank's gradients and updated
    parameters are the unsharded policy's (its slice of them)."""
    one = _policy_run(0, 1, 1)
    for r, got in enumerate(run_ranks(_policy_run, 2, tmp_path, 2)):
        for i in range(3):
            np.testing.assert_allclose(got[f"apply{i}"], one[f"apply{i}"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=0, atol=1e-12)
        for k in ("w1", "b1", "w2", "b2", "vw"):
            for kind in ("grad.", "new."):
                np.testing.assert_allclose(got[kind + k], _tp_slice(k, one[kind + k], r, 2),
                                           rtol=0, atol=1e-12, err_msg=kind + k)


def test_dp2_update_equals_the_full_batch_update(tmp_path):
    """Two ranks at dp=2, each with half of the batch: the advantages
    normalized over the global batch and the gradients averaged over dp
    give the full batch's loss and update on every rank."""
    one = _policy_run(0, 1, 1)
    for got in run_ranks(_policy_run, 2, tmp_path, 1):
        for k in ("loss", "loss2") + tuple("new." + f for f in ("w1", "b1", "w2", "b2", "vw")):
            np.testing.assert_allclose(got[k], one[k], rtol=0, atol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# rollout metrics against the JAX package's
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _StubState:
    t: torch.Tensor
    x: torch.Tensor


class _TorchStub:
    """A batched env with a deterministic step: x' = x + a / 4, reward
    (x'_0, -|a|_1, x'_1 > 0.3), done where |x'_0| > 0.5, success where
    x'_2 > 0."""

    action_size = 3

    def __init__(self):
        self.generator = torch.Generator().manual_seed(0)

    def draw_step(self, n):
        return {}

    def _observe(self, state):
        return {"x": state.x, "t": state.t[:, None].to(state.x.dtype)}

    def step(self, state, action, draws=None):
        x = state.x + action / 4
        reward = torch.stack([x[:, 0], -action.abs().sum(-1), (x[:, 1] > 0.3).to(x.dtype)], -1)
        st = _StubState(state.t + 1, x)
        return st, self._observe(st), reward, x[:, 0].abs() > 0.5, {"is_successful": x[:, 2] > 0}


class _JaxStub:
    """`_TorchStub` for one env, as the JAX package's env API takes it."""

    action_size = 3

    def _observe(self, state):
        import jax.numpy as jnp

        return {"x": state["x"], "t": jnp.asarray(state["t"], state["x"].dtype)[None]}

    def step(self, state, action):
        import jax.numpy as jnp

        x = state["x"] + action / 4
        st = {"t": state["t"] + 1, "x": x}
        reward = jnp.stack([x[0], -jnp.abs(action).sum(), (x[1] > 0.3).astype(x.dtype)])
        return st, self._observe(st), reward, jnp.abs(x[0]) > 0.5, {"is_successful": x[2] > 0}


W = np.random.default_rng(4).standard_normal((4, 3)) / 2


def test_rollout_metrics_match_jax():
    """`make_rollout_fn` with a policy (tanh of the observations through a
    fixed matrix; the noise unused, as the JAX policy leaves its key) on
    the stub env at B=8 for 5 steps, both packages from the same start:
    the same reward, done and success means, the state after the steps
    too."""
    import jax
    import jax.numpy as jnp

    from robogym_torch.parallel import mesh as t_mesh
    from robogym_torch.parallel import rollout as t_rollout
    from robogym_tpu.parallel import mesh as j_mesh
    from robogym_tpu.parallel import rollout as j_rollout

    x0 = np.random.default_rng(5).uniform(-0.5, 0.5, (8, 3))

    def t_policy(obs, noise):
        return torch.tanh(torch.cat([obs["t"], obs["x"]], -1) @ torch.as_tensor(W))

    def j_policy(key, obs):
        return jnp.tanh(jnp.concatenate([obs["t"], obs["x"]], -1) @ jnp.asarray(W))

    tstate = _StubState(torch.zeros(8, dtype=torch.int64), torch.as_tensor(x0))
    tout, tm = t_rollout.make_rollout_fn(_TorchStub(), t_mesh.make_mesh(device="cpu"), 5,
                                         t_policy)(tstate, torch.Generator().manual_seed(0))
    jstate = {"t": jnp.zeros(8, jnp.int32), "x": jnp.asarray(x0)}
    jout, jm = j_rollout.make_rollout_fn(_JaxStub(), j_mesh.make_mesh(1), 5, j_policy)(
        jstate, jax.random.key(0))
    for k, tol in (("reward_mean", 1e-12), ("done_frac", 1e-7), ("success_rate", 1e-7)):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(tout.x.numpy(), np.asarray(jout["x"]), rtol=0, atol=1e-12)
    assert 0 < float(tm["done_frac"]) < 1 and 0 < float(tm["success_rate"]) < 1
