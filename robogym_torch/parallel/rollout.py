"""Batch-parallel rollouts over the dp ranks of a mesh.

Counterpart of `robogym_tpu/parallel/rollout.py`. The port's envs step a
batch, so each rank steps its own block of envs in a Python loop over the
steps; no physics crosses ranks. Two drivers, as in the JAX package:

  * `make_rollout_fn`: the global batch's draws (actions, the env's step
    draws) made on every rank from one seeded generator and sliced to the
    rank's block, so a dp=2 run equals the dp=1 run; metrics are means
    over the global batch (`all_reduce` over the dp group).
  * `make_shardmap_rollout_fn`: each rank draws its own actions from a
    generator derived from (seed, dp index); metrics averaged over dp.

`sharded_reset` makes the global batch's reset draws on every rank and
slices them, so the reset too is the dp=1 reset cut into blocks. The envs
these drive take their draws from the caller (`reset(batch, draws)`,
`step(state, action, draws)`: the reach env, the rearrange family).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from robogym_torch.parallel import mesh as mesh_lib


def _reset_draws(env, n: int):
    draw = getattr(env, "draw_reset", None) or env.draw_step
    return draw(n)


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the ranks of `group` of this rank's mean of a per-env
    quantity (B_local,)."""
    return mesh_lib.all_reduce_mean(x.mean(), group)


def sharded_reset(env, mesh: mesh_lib.Mesh, batch_size: int, draws=None):
    """`env.reset` of this rank's block of a global batch of `batch_size`
    envs: the global batch's reset draws (`draws`, or the env's own from
    its generator, the same on every rank of equally seeded envs) sliced
    to the block. Returns (state, obs) of the block."""
    if batch_size % mesh.dp:
        raise ValueError(f"sharded_reset: {batch_size} envs over dp={mesh.dp}")
    draws = _reset_draws(env, batch_size) if draws is None else draws
    return env.reset(batch_size // mesh.dp, draws=mesh_lib.shard_env_batch(mesh, draws))


def _metrics(reward, done, info, mean) -> Dict[str, torch.Tensor]:
    """A step's metrics, the flags' shares in the reward's dtype."""
    succ = info.get("is_successful")
    dt = reward.dtype
    return {"reward_mean": mean(reward.sum(-1)), "done_frac": mean(done.to(dt)),
            "success_rate": mean(succ.to(dt)) if succ is not None else torch.zeros((), dtype=dt)}


def make_rollout_fn(env, mesh: mesh_lib.Mesh, n_steps: int,
                    policy_fn: Optional[Callable] = None):
    """A rollout of `n_steps` env steps: (state, generator) -> (state,
    metrics), `state` this rank's block, `generator` seeded alike on every
    rank. Each step draws the global batch's actions, uniform in [-1, 1]
    (or, with `policy_fn(obs, noise) -> actions`, a standard normal noise
    (B, action_size) that the policy reads beside the block's
    observations), and the env's step draws, all sliced to the block.
    Metrics (`reward_mean`: the reward summed over its parts, `done_frac`,
    `success_rate`) are means over the global batch and the steps."""

    def rollout(state, generator: torch.Generator):
        local = state.t.shape[0]
        B = local * mesh.dp
        dev = state.t.device
        shard = lambda t: mesh_lib.shard_env_batch(mesh, t)  # noqa: E731
        mean = lambda x: _mean(x, mesh.dp_group)  # noqa: E731
        steps = []
        for _ in range(n_steps):
            if policy_fn is None:
                u = torch.rand((B, env.action_size), generator=generator, device=dev)
                actions = shard(u * 2.0 - 1.0)
            else:
                noise = torch.randn((B, env.action_size), generator=generator, device=dev)
                actions = policy_fn(env._observe(state), shard(noise))
            state, _, reward, done, info = env.step(state, actions,
                                                   draws=shard(env.draw_step(B)))
            steps.append(_metrics(reward, done, info, mean))
        return state, {k: torch.stack([s[k].to(dev) for s in steps]).mean() for k in steps[0]}

    return rollout


def make_shardmap_rollout_fn(env, mesh: mesh_lib.Mesh, n_steps: int, seed: int = 0):
    """A rollout of `n_steps` env steps in which each rank draws its own
    block's actions, uniform in [-1, 1], from a generator seeded by (seed,
    its dp index), and the env its step draws from its own generator:
    state -> (state, metrics), metrics averaged over dp (each rank's
    means, then their mean over the dp group), as `make_rollout_fn`'s."""

    def rollout(state):
        local, dev = state.t.shape[0], state.t.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1_000_003 + mesh.dp_index)
        mean = lambda x: _mean(x, mesh.dp_group)  # noqa: E731
        steps = []
        for _ in range(n_steps):
            u = torch.rand((local, env.action_size), generator=gen, device=dev)
            state, _, reward, done, info = env.step(state, u * 2.0 - 1.0)
            steps.append(_metrics(reward, done, info, mean))
        return state, {k: torch.stack([s[k].to(dev) for s in steps]).mean() for k in steps[0]}

    return rollout


def scaling_report(env, batch_per_device: int = 128, n_steps: int = 10, seed: int = 0,
                   device=None) -> Dict[str, Any]:
    """Env-steps/s of `make_rollout_fn` at one rank and at the whole world
    (`steps_per_s@<n>dev`), and the scaling efficiency between them when
    the world has more than one rank. Every rank calls it; the one-rank
    run is rank 0's, and every rank returns rank 0's readings."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    out = {}
    for n in sorted({1, world}):
        mesh = mesh_lib.make_mesh(n, device=device)
        drawn = env.generator.get_state()   # the world's run starts from the same draws
        if mesh.member:
            B = batch_per_device * n
            state, _ = sharded_reset(env, mesh, B)
            fn = make_rollout_fn(env, mesh, n_steps)
            gen = torch.Generator(device=mesh.device)
            gen.manual_seed(seed)
            state, _ = fn(state, gen)
            _sync(mesh.device)
            t0 = time.perf_counter()
            state, _ = fn(state, gen)
            _sync(mesh.device)
            out[f"steps_per_s@{n}dev"] = B * n_steps / (time.perf_counter() - t0)
        env.generator.set_state(drawn)
        if world > 1:
            dist.barrier()
    if world > 1:
        box = [out]
        dist.broadcast_object_list(box, src=0)
        out = dict(box[0])
        out["scaling_efficiency"] = (out[f"steps_per_s@{world}dev"]
                                     / (world * out["steps_per_s@1dev"]))
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
