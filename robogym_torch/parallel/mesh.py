"""A (dp, tp) layout of the ranks of `torch.distributed`.

Counterpart of `robogym_tpu/parallel/mesh.py`. The axes are the JAX
package's: `dp`, the env batch split over ranks (each rank steps its own
block of envs), and `tp`, the policy's hidden layer split over ranks
(`train/ppo.py`). Rank r sits at dp index r // tp and tp index r % tp, as
the JAX mesh reshapes its devices to (n // tp, tp).

A world of one rank needs no process group: that is one card's case.
Several ranks need `torch.distributed.init_process_group` first (gloo on
the CPU, NCCL on the cards), with the address, world size and rank given
by the caller. Collectives ride the groups `make_mesh` builds; a group of
one rank is never built, and its collectives are skipped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from robogym_torch.envs import core


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, tp) layout of the first `size` ranks:
    `shape` {"dp": n // tp, "tp": tp} (under `axis_names`), its dp and tp
    indices, the process groups of its dp column and tp row (None where
    the axis has one rank) and its device. A rank past `size` is not a
    member (`member` False, indices -1)."""

    shape: dict
    axis_names: Tuple[str, str]
    rank: int
    dp_index: int
    tp_index: int
    dp_group: Optional[object]
    tp_group: Optional[object]
    device: torch.device

    @property
    def member(self) -> bool:
        return self.dp_index >= 0

    @property
    def dp(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def tp(self) -> int:
        return self.shape[self.axis_names[1]]


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              axis_names: Tuple[str, str] = ("dp", "tp"), device=None) -> Mesh:
    """A (dp, tp) layout over the first `n_devices` ranks (all of them by
    default). Every rank of the world calls it, members or not, since the
    groups are built collectively. `device`: this rank's device (by
    default its card, `cuda:<rank mod cards>`)."""
    world, rank = _world()
    n = n_devices or world
    if n > world or n % tp:
        raise ValueError(f"make_mesh: {n} ranks of {world} in rows of tp={tp}")
    dp = n // tp
    groups = {}
    for axis, lines in (("tp", [[i * tp + j for j in range(tp)] for i in range(dp)]),
                        ("dp", [[i * tp + j for i in range(dp)] for j in range(tp)])):
        for ranks in lines:
            if len(ranks) > 1:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    if device is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    member = rank < n
    return Mesh(shape={axis_names[0]: dp, axis_names[1]: tp}, axis_names=tuple(axis_names),
                rank=rank, dp_index=rank // tp if member else -1,
                tp_index=rank % tp if member else -1, dp_group=groups.get("dp"),
                tp_group=groups.get("tp"), device=torch.device(device))


def shard_env_batch(mesh: Mesh, tree, axis: str = "dp"):
    """This rank's contiguous block of a batched tree (an env state, a
    dict of draws) on its device, as `P("dp")` lays the batch axis out:
    each tensor with an env axis cut to rows [i n, (i + 1) n) of the
    global batch, n = batch / dp, i this rank's dp index; 0-dim tensors
    whole."""
    parts, i = mesh.shape[axis], mesh.dp_index if axis == mesh.axis_names[0] else mesh.tp_index

    def block(x):
        x = x.to(mesh.device)
        if x.dim() == 0:
            return x
        if x.shape[0] % parts:
            raise ValueError(f"shard_env_batch: a batch of {x.shape[0]} over {parts} ranks")
        n = x.shape[0] // parts
        return x[i * n:(i + 1) * n]

    return core.tree_map(block, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` on this rank's device, as rank 0 holds it
    (broadcast from rank 0 over the world; a world of one keeps it)."""
    world, _ = _world()

    def bcast(x):
        x = x.to(mesh.device).clone()
        if world > 1:
            dist.broadcast(x, src=0)
        return x

    return core.tree_map(bcast, tree)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (None: this rank's own);
    not differentiable."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)
