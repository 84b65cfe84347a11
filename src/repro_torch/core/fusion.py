"""Tensor fusion: coalesce many tensors into few capped 1-D buckets (paper
R5), one collective or codec call per bucket instead of one per tensor.

Counterpart: ``repro/core/fusion.py:27-134`` (``Bucket``, ``FusionPlan``,
``make_plan``, ``pack``, ``unpack``, ``fused_apply``,
``collective_stats``).  The plan here is the reference's
plan, leaf for leaf: the JAX model keeps one stacked ``[L, ...]`` leaf per
parameter kind and ``jax.tree.flatten`` orders dict keys by sort, while
the port keeps nested lists of per-layer dicts in insertion order.  So
``make_plan`` groups the port's leaves by their key path without the list
indices (the reference's leaf), orders those groups by sorted key path
(the reference's flatten order), and gives each group the stacked shape.
Its entry concatenates the group's per-layer tensors in layer order, which
is the row-major ravel of the stacked leaf.  Entries, offsets, padding and
bucket boundaries are then the reference's, so the 1024-element rows that
share one 1-bit scale hold the same parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
import torch.utils._pytree as pytree

from .sharding import is_spec

__all__ = ["Bucket", "FusionPlan", "collective_stats", "fused_apply",
           "make_plan", "pack", "pack_bucket", "unpack", "unpack_bucket"]


@dataclasses.dataclass(frozen=True)
class _Entry:
    index: int                 # position among the reference's leaves
    shape: tuple[int, ...]     # the stacked leaf's shape
    size: int
    offset: int                # offset inside its bucket


@dataclasses.dataclass(frozen=True)
class Bucket:
    dtype: Any
    entries: tuple[_Entry, ...]
    total: int                 # elements (unpadded)
    padded: int = 0            # elements incl. shard-divisibility padding

    @property
    def nbytes(self) -> int:
        return max(self.total, self.padded) * self.dtype.itemsize

    @property
    def size(self) -> int:
        return max(self.total, self.padded)


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    treespec: Any              # the port tree's structure
    buckets: tuple[Bucket, ...]
    n_leaves: int              # the reference's (stacked) leaves
    # per reference leaf: the port's leaves (flatten positions) in layer
    # order, and the shape of one of them
    members: tuple[tuple[int, ...], ...]
    member_shapes: tuple[tuple[int, ...], ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def _paths(tree, path=()):
    """(key path, leaf) in the port's flatten order; list levels add their
    index to the path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def make_plan(tree, cap_bytes: int = 32 * 1024 * 1024,
              pad_to: int = 1) -> FusionPlan:
    """Greedy first-fit bucketing in the reference's flatten order, per
    dtype, over a port tree of ``ParamSpec``s or tensors."""
    leaves, treespec = pytree.tree_flatten(tree, is_leaf=is_spec)
    groups: dict[tuple, list] = {}
    for i, (path, leaf) in enumerate(_paths(tree)):
        key = tuple(p for p in path if isinstance(p, str))
        index = tuple(p for p in path if isinstance(p, int))
        groups.setdefault(key, []).append((index, i, leaf))
    assert sum(map(len, groups.values())) == len(leaves)

    open_buckets: dict[Any, list] = {}     # dtype -> [entries, total]
    done: list[Bucket] = []
    members, member_shapes = [], []

    def _close(dt):
        entries, total = open_buckets.pop(dt)
        padded = ((total + pad_to - 1) // pad_to) * pad_to
        done.append(Bucket(dt, tuple(entries), total, padded))

    for j, key in enumerate(sorted(groups)):
        group = sorted(groups[key], key=lambda g: g[0])   # layer order
        lead = tuple(max(ix[d] for ix, _, _ in group) + 1
                     for d in range(len(group[0][0])))
        leaf = group[0][2]
        shape, dt = tuple(leaf.shape), leaf.dtype
        if math.prod(lead) != len(group) or any(
                tuple(g[2].shape) != shape or g[2].dtype != dt
                for g in group):
            raise ValueError(f"{'/'.join(key)}: per-layer leaves do not "
                             f"stack to one [{lead}, {shape}] leaf")
        members.append(tuple(i for _, i, _ in group))
        member_shapes.append(shape)
        size = len(group) * math.prod(shape)
        if dt in open_buckets and \
                (open_buckets[dt][1] + size) * dt.itemsize > cap_bytes:
            _close(dt)
        if dt not in open_buckets:
            open_buckets[dt] = [[], 0]
        entries, total = open_buckets[dt]
        entries.append(_Entry(j, lead + shape, size, total))
        open_buckets[dt][1] = total + size
    for dt in list(open_buckets):
        _close(dt)
    return FusionPlan(treespec=treespec, buckets=tuple(done),
                      n_leaves=len(groups), members=tuple(members),
                      member_shapes=tuple(member_shapes))


def pack_bucket(leaves: Sequence[torch.Tensor], plan: FusionPlan,
                i: int) -> torch.Tensor:
    """Bucket ``i`` as one 1-D tensor from the port's leaves (flatten
    order): its entries' per-layer tensors raveled in layer order, then
    the zero padding."""
    b = plan.buckets[i]
    parts = [leaves[m].reshape(-1).to(b.dtype)
             for e in b.entries for m in plan.members[e.index]]
    if b.padded > b.total:
        parts.append(torch.zeros(b.padded - b.total, dtype=b.dtype,
                                 device=parts[0].device))
    return torch.cat(parts) if len(parts) > 1 else parts[0].clone()


def pack(tree, plan: FusionPlan) -> list[torch.Tensor]:
    """Port tree -> list of fused 1-D buffers (one per bucket)."""
    leaves = pytree.tree_leaves(tree)
    if len(leaves) != sum(map(len, plan.members)):
        raise ValueError(f"tree has {len(leaves)} leaves; the plan "
                         f"{sum(map(len, plan.members))}")
    return [pack_bucket(leaves, plan, i) for i in range(plan.n_buckets)]


def unpack(buffers: Sequence[torch.Tensor], plan: FusionPlan):
    """List of fused buffers -> port tree of views into them, in the
    original shapes."""
    if len(buffers) != plan.n_buckets:
        raise ValueError(f"{len(buffers)} buffers for {plan.n_buckets} "
                         f"buckets")
    leaves: list = [None] * sum(map(len, plan.members))
    for i, buf in enumerate(buffers):
        for j, t in enumerate(unpack_bucket(buf, plan, i)):
            if t is not None:
                leaves[j] = t
    return pytree.tree_unflatten(leaves, plan.treespec)


def unpack_bucket(buf: torch.Tensor, plan: FusionPlan, i: int) -> list:
    """Bucket ``i``'s buffer -> the port's leaves in flatten order: views
    into it, in their shapes, for the leaves it holds; None for the
    others."""
    leaves: list = [None] * sum(map(len, plan.members))
    for e in plan.buckets[i].entries:
        shape = plan.member_shapes[e.index]
        n = math.prod(shape)
        for k, m in enumerate(plan.members[e.index]):
            start = e.offset + k * n
            leaves[m] = buf[start:start + n].view(shape)
    return leaves


def fused_apply(tree, fn: Callable[[torch.Tensor], torch.Tensor],
                cap_bytes: int = 32 * 1024 * 1024):
    """Apply ``fn`` (e.g. a collective) per fused bucket instead of per
    leaf; the result's leaves are views into ``fn``'s outputs."""
    plan = make_plan(tree, cap_bytes)
    return unpack([fn(b) for b in pack(tree, plan)], plan)


def collective_stats(tree, cap_bytes: int) -> dict:
    """Napkin-math readout: collectives saved by fusion (for logs/tests);
    ``tensors`` counts the reference's (stacked) leaves."""
    plan = make_plan(tree, cap_bytes)
    return {
        "tensors": plan.n_leaves,
        "buckets": plan.n_buckets,
        "bytes": int(sum(b.nbytes for b in plan.buckets)),
        "launches_saved": plan.n_leaves - plan.n_buckets,
    }
