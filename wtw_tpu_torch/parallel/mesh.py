"""Env-sharded data parallelism over `torch.distributed` (port of
`wtw_tpu/parallel/mesh.py`).

- The envs are split into equal contiguous shards, one per rank of a
  process group; each rank steps its own shard, so physics needs no
  traffic between ranks.
- The learner is replicated: every rank holds the same parameters and
  optimizer state, and gradients, the KL and the statistics are averaged
  over the group (a sum divided by the group size: the shards are equal),
  so every rank takes the same Adam step and the replicas stay bitwise
  equal.
- State that belongs to all envs (the command curriculum, CaT's running
  maxes, the gravity offset, the soft-p progress, the step counter and the
  env generator) is kept whole on every rank and updated from reduced
  values, so it too stays equal.
- Draws: a grouped env draws every per-env tensor at the group's global
  width from a generator seeded alike on every rank and keeps its own
  rows (`draw_rows`), so a sharded run draws exactly what the unsharded
  one draws.
- Bits (`sharding_invariant` learners): the envs are cut into
  `INVARIANT_BLOCKS` equal blocks of the global width (`invariant_blocks`),
  every product runs on one block's rows, and every sum over envs (the
  gradients, the advantage and normalizer moments, the KL) is a balanced
  tree over the blocks in env order, a rank's subtree first and then the
  ranks' partials in rank order (`tree_sum`, `group_tree_sum`). A sharded
  run on 1, 2, 4 or 8 ranks then computes the bits of the unsharded one:
  the env step is already per env, and a product's rows do not depend on
  other rows of the same shape (a product over 2048 rows and one over 4096
  round differently on the card).

The backend is the caller's choice and is never switched: "nccl" for one
card per rank, "gloo" for ranks that share a card or run on the CPU. gloo
reduces host tensors, so a CUDA tensor is copied to the host for the
reduction and back (`_reduce`). `torch.distributed` is imported inside
the functions that use it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------
def init_group(backend: str, init_method: str, world_size: int, rank: int):
    """`torch.distributed.init_process_group` with everything explicit; ->
    the default group. `backend` is "nccl" or "gloo"."""
    import torch.distributed as dist
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return dist.group.WORLD


def group_size(group) -> int:
    return 1 if group is None else group.size()


def group_rank(group) -> int:
    return 0 if group is None else group.rank()


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """All-reduce of a copy of `x` (`op` "sum" or "max"); gloo reduces
    on the host, so a CUDA tensor goes there and back."""
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    buf = x.detach().to("cpu", copy=True) if host else x.detach().clone()
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(x.device) if host else buf


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """psum: the sum over the group (x itself when ungrouped)."""
    return x if group is None else _reduce(x, "sum", group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """pmean: the group sum divided by the group size."""
    return x if group is None else _reduce(x, "sum", group) / group.size()


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """pmax: the elementwise maximum over the group."""
    return x if group is None else _reduce(x, "max", group)


def all_mean_grads_(params: Sequence[torch.Tensor], group):
    """Average every `.grad` of `params` over the group in place, through
    one flat buffer (one all-reduce)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = all_mean(flat, group)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


INVARIANT_BLOCKS = 8


def invariant_blocks(n_local: int, group) -> List[slice]:
    """This rank's rows cut into its share of the gcd(8, global envs)
    blocks of equal width; the blocks must split evenly over the ranks."""
    W = group_size(group)
    k = math.gcd(INVARIANT_BLOCKS, n_local * W)
    if k % W:
        raise ValueError(f"sharding_invariant: {n_local * W} envs make {k} "
                         f"blocks, which do not split over {W} ranks")
    per = k // W
    c = n_local // per
    return [slice(i * c, (i + 1) * c) for i in range(per)]


def tree_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The balanced pairwise sum of `parts` in their order."""
    parts = list(parts)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def group_tree_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` gathered in rank order and summed as a balanced tree:
    the same bits on every rank (x itself when ungrouped)."""
    if group is None:
        return x
    return tree_sum(_gather(x, group))


def _gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """All-gather of `x` over the group, in rank order (on the host and
    back under gloo for a CUDA tensor)."""
    import torch.distributed as dist
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    buf = x.detach().cpu() if host else x.detach()
    parts = [torch.empty_like(buf) for _ in range(group.size())]
    dist.all_gather(parts, buf.contiguous(), group=group)
    return [p.to(x.device) for p in parts] if host else parts


def invariant_sum(parts: Sequence[torch.Tensor], group) -> torch.Tensor:
    """Per-block partial sums of this rank -> the global sum, with the
    bits of the unsharded run's (its blocks' tree)."""
    return group_tree_sum(tree_sum(parts), group)


def invariant_grads(per_block: Sequence[Sequence[Optional[torch.Tensor]]],
                    group) -> List[Optional[torch.Tensor]]:
    """Per-block gradient lists (one entry per parameter, None where
    unused) -> their global sums (`invariant_sum` through one flat
    buffer)."""
    n = len(per_block[0])
    used = [i for i in range(n) if per_block[0][i] is not None]
    flat = [torch.cat([g[i].reshape(-1) for i in used]) for g in per_block]
    tot = invariant_sum(flat, group)
    out, off = [None] * n, 0
    for i in used:
        k = per_block[0][i].numel()
        out[i] = tot[off:off + k].view_as(per_block[0][i])
        off += k
    return out


def draw_rows(draw: Callable, shape, group) -> torch.Tensor:
    """`draw(shape)` of a per-env tensor (rows = envs) made at the group's
    global width, this rank's rows kept; `draw(shape)` when ungrouped."""
    if group is None:
        return draw(tuple(shape))
    n, W, r = shape[0], group.size(), group.rank()
    return draw((n * W,) + tuple(shape[1:]))[r * n:(r + 1) * n]


def shard_rows(x, group):
    """This rank's rows of a tensor with the global env count as its
    leading axis."""
    if group is None:
        return x
    n = x.shape[0] // group.size()
    r = group.rank()
    return x[r * n:(r + 1) * n].clone()


def _clone_gen(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def _shard_fields(obj, group):
    """Every tensor field of a dataclass (nested dataclasses too) cut to
    this rank's rows."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _shard_fields(v, group)
        elif isinstance(v, torch.Tensor):
            out[f.name] = shard_rows(v, group)
        else:
            out[f.name] = v
    return dataclasses.replace(obj, **out)


def shard_world(world, obs_dict, group):
    """A Stack-A `WorldState` built at the global env count and its
    observation dict -> this rank's shard: every per-env tensor cut to the
    rank's rows; the curriculum weights, the gravity offset, the step
    counter and the generator kept whole."""
    world = dataclasses.replace(
        world, env=_shard_fields(world.env, group),
        obs_history=shard_rows(world.obs_history, group),
        gen=_clone_gen(world.gen))
    return world, {k: shard_rows(v, group) for k, v in obs_dict.items()}


def shard_parkour_world(world, obs, group):
    """A `ParkourWorld` built at the global env count and its (normalized)
    observation -> this rank's shard: the per-env state and the history
    cut to the rank's rows; CaT's running maxes, the soft-p progress, the
    step counter and the generator kept whole."""
    world = dataclasses.replace(
        world, env=_shard_fields(world.env, group),
        hist_obs=shard_rows(world.hist_obs, group),
        gen=_clone_gen(world.gen))
    return world, shard_rows(obs, group)


def replicate(obj, group, src: int = 0):
    """Broadcast `obj` from rank `src` in place: a tensor, a module's
    parameters and buffers, or a list of them. -> obj."""
    if group is None:
        return obj
    import torch.distributed as dist
    if isinstance(obj, torch.nn.Module):
        replicate(list(obj.parameters()) + list(obj.buffers()), group, src)
    elif isinstance(obj, list):
        for x in obj:
            replicate(x, group, src)
    elif isinstance(obj, torch.Tensor):
        host = obj.is_cuda and dist.get_backend(group) == "gloo"
        buf = obj.detach().cpu() if host else obj.data
        dist.broadcast(buf, src=src, group=group)
        if host:
            with torch.no_grad():
                obj.copy_(buf)
    return obj


# ---------------------------------------------------------------------------
# the distributed train functions
# ---------------------------------------------------------------------------
def _learner_tensors(learner) -> list:
    """The tensors that make a learner's replicas equal: its network (the
    actor-critic, the CaT agent or the RMA model) and the CaT learners'
    normalizers."""
    out = []
    for name in ("ac", "agent", "model"):
        m = getattr(learner, name, None)
        if isinstance(m, torch.nn.Module):
            out.append(m)
    for name in ("obs_rms", "value_rms"):
        s = getattr(learner, name, None)
        if s is not None:
            out += [s.mean, s.var, s.count]
    return out


class DistributedTrainFn:
    """One data-parallel train iteration: `fn(world, obs) -> (world, obs,
    stats)` on this rank's shard. `fn.learner` is the replicated learner;
    its parameters were broadcast from rank 0 when the function was made."""

    def __init__(self, learner, group):
        self.learner, self.group = learner, group
        replicate(_learner_tensors(learner), group)

    def __call__(self, world, obs, **kw):
        return self.learner.train_iteration(world, obs, **kw)


def _check_env(env, group):
    if getattr(env, "group", None) is not group:
        raise ValueError("the env must be built with the same group "
                         "(LeggedEnv / ParkourEnv(..., group=group))")


def make_distributed_train_fn(env, args, ac_args, group, seed: int = 0,
                              learner_cls=None) -> DistributedTrainFn:
    """The data-parallel `ppo_cse` iteration (`learner_cls` may name
    `ppo_rma.RMA` with its own args in `ac_args`): envs sharded over the
    group's ranks, the learner replicated, gradients, the KL and the
    statistics averaged over the group."""
    from ..learn.ppo_cse import PPO
    _check_env(env, group)
    cls = learner_cls or PPO
    return DistributedTrainFn(cls(env, args, ac_args, seed=seed,
                                  group=group), group)


def make_distributed_cat_train_fn(env, args, group, seed: int = 0,
                                  learner_cls=None) -> DistributedTrainFn:
    """The data-parallel CaT iteration (`cat_ppo.CatPPO`, or `learner_cls`:
    `cat_ppo_plus.CatPPOPlus` or `cat_ppornn.CatPPORNN`): envs and their
    observations sharded, the learner and both normalizers replicated,
    gradients averaged; the env's CaT batch max is a group max."""
    from ..learn.cat_ppo import CatPPO
    _check_env(env, group)
    cls = learner_cls or CatPPO
    return DistributedTrainFn(cls(env, args, seed=seed, group=group), group)
