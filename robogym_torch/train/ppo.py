"""A colocated PPO learner: a Gaussian policy MLP, GAE and the clipped
surrogate, updated by plain SGD.

Counterpart of `robogym_tpu/train/ppo.py`, with its names and arithmetic:
`policy_apply`, `flatten_obs`, `gaussian_logp`, `gae` (a reverse loop over
the T steps), `PPOBatch`, `ppo_loss` (clipped ratio, clipped value loss,
entropy bonus), `ppo_update` (autograd, then `sgd_update`) and `train_step`,
the body of the JAX package's multi-chip dry run (`__graft_entry__.py`):
observe, sample clipped actions, one env step, one-step GAE bootstrapped by
the value, one update.

Parallelism over a `parallel.mesh.Mesh`, as the dry run shards the policy:
under tp > 1 each rank holds a slice of the hidden layer (`w1`'s columns,
`b1`, `w2`'s rows and `vw`'s rows; `b2` whole), and the second layer's and
the value head's partial products are summed over the tp group (forward
only: the gradient of a replicated output is each rank's own). Under
dp > 1 each rank holds a block of the batch: the advantages are
normalized by the global batch's mean and deviation, and the gradients
are averaged over the dp group, so the update equals the full batch's.
No kernel: the gradient runs through the policy only.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from robogym_torch.parallel import mesh as mesh_lib

FIELDS = ("w1", "b1", "w2", "b2", "vw")


class Policy(nn.Module):
    """The policy's parameters, named as the JAX `PolicyParams`: w1 (obs,
    hidden), b1 (hidden,), w2 (hidden, 2 act), b2 (2 act,), vw (hidden, 1);
    under tp > 1 this rank's slice of the hidden layer. `mesh` names the
    groups its sums and the update reduce over (None: one rank)."""

    def __init__(self, w1, b1, w2, b2, vw, mesh: Optional[mesh_lib.Mesh] = None):
        super().__init__()
        for name, t in zip(FIELDS, (w1, b1, w2, b2, vw)):
            setattr(self, name, nn.Parameter(t.detach().clone()))
        self.mesh = mesh

    def forward(self, obs: torch.Tensor):
        return policy_apply(self, obs)

    def replace(self, **params) -> "Policy":
        """A policy with the given parameters in place of its own."""
        return Policy(*(params.get(k, getattr(self, k)) for k in FIELDS), mesh=self.mesh)


def _tp_slices(mesh: Optional[mesh_lib.Mesh], hidden: int) -> slice:
    if mesh is None or mesh.tp == 1:
        return slice(None)
    if hidden % mesh.tp:
        raise ValueError(f"hidden {hidden} over tp={mesh.tp}")
    n = hidden // mesh.tp
    return slice(mesh.tp_index * n, (mesh.tp_index + 1) * n)


def policy_from_numpy(params, mesh: Optional[mesh_lib.Mesh] = None, device=None,
                      dtype=torch.float32) -> Policy:
    """A policy from the five arrays of a full (unsharded) parameter set:
    a dict or an object with attributes `w1 b1 w2 b2 vw` (the JAX
    `PolicyParams` carried across as numpy), on `device` (the mesh's by
    default). Under tp > 1 it takes this rank's slice."""
    get = params.get if isinstance(params, dict) else lambda k: getattr(params, k)
    device = device if device is not None else (mesh.device if mesh is not None else "cuda")
    w = {k: torch.as_tensor(get(k), dtype=dtype, device=device) for k in FIELDS}
    s = _tp_slices(mesh, w["w1"].shape[1])
    return Policy(w["w1"][:, s], w["b1"][s], w["w2"][s], w["b2"], w["vw"][s], mesh=mesh)


def init_policy(generator: torch.Generator, obs_size: int, act_size: int, hidden: int = 256,
                mesh: Optional[mesh_lib.Mesh] = None) -> Policy:
    """A new policy drawn from `generator` (on its device), as the JAX
    `init_policy` draws: normal weights scaled by 1/sqrt(fan in), zero
    biases. The full set is drawn on every rank (the same from the same
    seed) and sliced under tp."""
    dev = generator.device
    s1, s2 = 1.0 / math.sqrt(obs_size), 1.0 / math.sqrt(hidden)
    w1 = torch.randn((obs_size, hidden), generator=generator, device=dev) * s1
    w2 = torch.randn((hidden, act_size * 2), generator=generator, device=dev) * s2
    vw = torch.randn((hidden, 1), generator=generator, device=dev) * s2
    full = dict(w1=w1, b1=torch.zeros(hidden, device=dev), w2=w2,
                b2=torch.zeros(act_size * 2, device=dev), vw=vw)
    return policy_from_numpy(full, mesh, device=dev)


class _SumOverTP(torch.autograd.Function):
    """Sum of the tp group's partial products in the forward pass; the
    gradient passes through as it is (every rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_sum(x, policy: Policy):
    mesh = policy.mesh
    if mesh is None or mesh.tp_group is None:
        return x
    return _SumOverTP.apply(x, mesh.tp_group)


def policy_apply(policy: Policy, obs: torch.Tensor):
    """(mean, log_std, value) of a batch of flat observations (N, obs):
    mean = tanh of the first half of the output, log_std its second
    half."""
    h = torch.tanh(obs @ policy.w1 + policy.b1)
    out = _tp_sum(h @ policy.w2, policy) + policy.b2
    act = out.shape[-1] // 2
    value = _tp_sum(h @ policy.vw, policy).squeeze(-1)
    return torch.tanh(out[..., :act]), out[..., act:], value


def flatten_obs(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """An observation dict as one flat vector per env, keys sorted (the
    JAX `flatten_obs`'s reshapes)."""
    parts = [obs[k].reshape(obs[k].shape[:-1] + (-1,)) if obs[k].dim() > 1 else obs[k]
             for k in sorted(obs.keys())]
    return torch.cat([p.reshape(p.shape[:max(p.dim() - 1, 0)] + (-1,)) if p.dim() > 1 else p
                      for p in parts], dim=-1)


def gaussian_logp(mean: torch.Tensor, log_std: torch.Tensor,
                  actions: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log density, summed over the action dim."""
    z = (actions - mean) / torch.exp(log_std)
    return -0.5 * torch.sum(z ** 2 + 2.0 * log_std + math.log(2.0 * math.pi), dim=-1)


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float = 0.99,
        lam: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a (T, B) rollout with the
    bootstrap `last_value` (B,): (advantages, returns), both (T, B), by a
    reverse loop over T."""
    adv_next, v_next = torch.zeros_like(last_value), last_value
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = values[t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


class PPOBatch(NamedTuple):
    obs: torch.Tensor         # (N, obs)
    actions: torch.Tensor     # (N, act)
    logp_old: torch.Tensor    # (N,)
    advantages: torch.Tensor  # (N,)
    returns: torch.Tensor     # (N,)
    values_old: torch.Tensor  # (N,)


def _normalized(adv: torch.Tensor, mesh: Optional[mesh_lib.Mesh]) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8) over the global batch (the population
    deviation, as `jnp.std`)."""
    group = None if mesh is None else mesh.dp_group
    if group is None:
        return (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    mean = mesh_lib.all_reduce_mean(adv.mean(), group)
    var = mesh_lib.all_reduce_mean(((adv - mean) ** 2).mean(), group)
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def ppo_loss(policy: Policy, batch: PPOBatch, clip_eps: float = 0.2, vf_coef: float = 0.5,
             ent_coef: float = 0.0, vf_clip: float = 0.2) -> torch.Tensor:
    """Clipped-surrogate PPO loss with the clipped value loss and the
    entropy bonus, over this rank's block of the batch (its mean; the
    blocks' mean is the global batch's)."""
    mean, log_std, value = policy_apply(policy, batch.obs)
    logp = gaussian_logp(mean, log_std, batch.actions)
    ratio = torch.exp(logp - batch.logp_old)
    adv = _normalized(batch.advantages, policy.mesh)
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv).mean()
    v_clipped = batch.values_old + torch.clamp(value - batch.values_old, -vf_clip, vf_clip)
    v_loss = 0.5 * torch.maximum((value - batch.returns) ** 2,
                                 (v_clipped - batch.returns) ** 2).mean()
    entropy = torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
    return pg + vf_coef * v_loss - ent_coef * entropy.mean()


def sgd_update(policy: Policy, grads: Dict[str, torch.Tensor], lr: float = 1e-4) -> Policy:
    """A policy with p - lr g for each parameter p and its gradient g."""
    with torch.no_grad():
        return policy.replace(**{k: getattr(policy, k) - lr * grads[k] for k in FIELDS})


def ppo_grads(policy: Policy, batch: PPOBatch, **loss_kw):
    """(loss, gradients by name): the loss's gradient on this rank,
    averaged over the dp group, and the global batch's loss."""
    params = [getattr(policy, k) for k in FIELDS]
    loss = ppo_loss(policy, batch, **loss_kw)
    grads = torch.autograd.grad(loss, params)
    group = None if policy.mesh is None else policy.mesh.dp_group
    grads = {k: mesh_lib.all_reduce_mean(g, group) for k, g in zip(FIELDS, grads)}
    return mesh_lib.all_reduce_mean(loss.detach(), group), grads


def ppo_update(policy: Policy, batch: PPOBatch, lr: float = 3e-4,
               **loss_kw) -> Tuple[Policy, torch.Tensor]:
    """One PPO gradient step: (new policy, loss)."""
    loss, grads = ppo_grads(policy, batch, **loss_kw)
    return sgd_update(policy, grads, lr=lr), loss


def act(env, policy: Policy, state, noise: torch.Tensor, draws=None):
    """The rollout half of `train_step`: observe, sample actions clipped to
    [-1, 1] with the standard normal `noise` (B, act), one env step, one-
    step GAE bootstrapped by the value. Returns (new state, PPOBatch,
    reward (B, parts))."""
    with torch.no_grad():
        obs_flat = flatten_obs(env._observe(state))
        mean, log_std, value = policy_apply(policy, obs_flat)
        actions = torch.clamp(mean + noise.to(mean.dtype) * torch.exp(log_std), -1.0, 1.0)
        logp_old = gaussian_logp(mean, log_std, actions)
        new_state, _, reward, done, _ = env.step(state, actions, draws=draws)
        r = reward.sum(-1)
        adv, ret = gae(r[None], value[None], done.to(r.dtype)[None], value)
    return new_state, PPOBatch(obs_flat, actions, logp_old, adv[0], ret[0], value), reward


def train_step(env, policy: Policy, state, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, draws=None):
    """One training step of the JAX package's dry run: `act` (its noise
    drawn from `generator` for the global batch and sliced to this rank's
    block, or given), then one `ppo_update`. Returns (new policy, new
    state, the mean reward over the global batch, the loss)."""
    if noise is None:
        mesh = policy.mesh
        local = state.t.shape[0]
        dp = 1 if mesh is None else mesh.dp
        noise = torch.randn((local * dp, env.action_size), generator=generator,
                            device=state.t.device)
        if mesh is not None:
            noise = mesh_lib.shard_env_batch(mesh, noise)
    new_state, batch, reward = act(env, policy, state, noise, draws)
    new_policy, loss = ppo_update(policy, batch)
    group = None if policy.mesh is None else policy.mesh.dp_group
    return new_policy, new_state, mesh_lib.all_reduce_mean(reward.mean(), group), loss
