"""SPMD checkpointing: each process writes its own segments (DESIGN.md §10).

Counterpart: ``repro/checkpoint/spmd.py`` (``is_multiprocess``,
``collect_segments``, ``write_spmd_shard``).  In SPMD mode every process
of a ``torch.distributed`` world holds the whole train state (lockstep
compute, ``frontend/spmd.py``), and persistence is what is distributed:
a leaf whose leading dim divides by the world size is split by rows,
process ``r`` writing block ``r``; any other leaf is written whole by
process 0.  The reference gets that layout from a one-device-per-process
persistence mesh (``persistence_mesh``, ``persistence_sharding``,
``global_view``) and ``addressable_shards``; the port computes it as a
pure function of the leaf's shape, the world size and the rank
(``segments``), which gives the same blocks.  The leaves are the JAX
layout's (``bridge``): a per-layer list is a leaf's leading dim.

``write_spmd_shard`` streams this process's segments into its shard file
through the format layer (``format.save_shard`` with ``slices``), and only
the returned manifest *entry* (offsets, shapes, checksums: metadata)
crosses the messaging layer; ``DistributedGraph.stats()
["ckpt_leaf_wire_bytes"]`` stays 0.  The segments' host copies are taken
synchronously, before the caller's next step updates the state in place:
the port's in-place update is its form of the reference's donation.  A
process copies only its own rows off the device.

Restore needs nothing new: segments carry the global slice they hold, and
``format.assemble_leaf`` re-joins them on any process count (N -> M, M = 1
included).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..bridge import _name, _slots
from . import format as fmt

__all__ = ["collect_segments", "is_multiprocess", "segments",
           "world_rank", "write_spmd_shard"]


def is_multiprocess() -> bool:
    """True when this process is part of a ``torch.distributed`` world of
    more than one process: the gate for the SPMD save path."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def world_rank() -> tuple[int, int]:
    """``(world size, rank)`` of this process (``(1, 0)`` outside a
    ``torch.distributed`` world)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def segments(shape, world: int, rank: int) -> list:
    """The blocks of a leaf of ``shape`` that process ``rank`` of
    ``world`` persists: the reference's ``persistence_sharding`` (split
    the leading dim over the processes when it divides evenly, replicate
    otherwise) and ``addressable_segments`` (one block per distinct
    shard, written by the holder of replica 0, process 0's for a
    replicated leaf).

    Returns:
        A list of ``[[start, stop], ...]`` (one pair per dim of the
        global leaf), or None for the whole leaf; empty when ``rank``
        writes none of it.  A scalar is a whole leaf of process 0.
    """
    shape = tuple(int(d) for d in shape)
    if len(shape) >= 1 and shape[0] >= world and shape[0] % world == 0:
        n = shape[0] // world
        pairs = [[rank * n, (rank + 1) * n]] + [[0, d] for d in shape[1:]]
        full = all(a == 0 and b == d for (a, b), d in zip(pairs, shape))
        return [None if full else pairs]
    return [None] if rank == 0 else []


def _rows(lead: tuple, items: list, shape: tuple, r0: int, r1: int):
    """Rows ``[r0, r1)`` of the leading dim of one JAX-layout leaf as an
    owned numpy copy: the stacked items those rows hold (a per-layer
    list's leading dim), or a slice of the one tensor, copied off the
    device alone."""
    if lead:
        first = torch.as_tensor(items[0][1])
        out = torch.empty((r1 - r0,) + lead[1:] + tuple(first.shape),
                          dtype=first.dtype)
        for idx, leaf in items:
            if r0 <= idx[0] < r1:
                out[(idx[0] - r0,) + idx[1:]].copy_(
                    torch.as_tensor(leaf).detach())
        return out.numpy()
    t = torch.as_tensor(items[0][1]).detach()
    if t.dim() and (r0, r1) != (0, t.shape[0]):
        t = t[r0:r1]
    return t.to("cpu", copy=True).contiguous().numpy()


def collect_segments(tree: Any, world: Optional[int] = None,
                     rank: Optional[int] = None) -> tuple:
    """This process's segments of ``tree`` (a port tree in the JAX
    layout), ready for ``format.save_shard``.

    Synchronous on purpose: the host copies are taken now, before the
    caller's next step updates the state in place.

    Args:
        tree: the train state, e.g. ``(params, opt)``.
        world, rank: the world size and this process's rank (defaults:
            ``world_rank()``).
    Returns:
        ``(indices, slices, arrays)``: parallel lists; ``slices[i]`` is
        None for a whole leaf or ``(slice_pairs, global_shape)``.
    Raises:
        ValueError: a leaf's dtype has no numpy counterpart (bfloat16).
    """
    if world is None or rank is None:
        world, rank = world_rank()
    indices, slices, arrays = [], [], []
    for i, (path, lead, items) in enumerate(_slots(tree)):
        first = torch.as_tensor(items[0][1])
        try:
            torch.empty(0, dtype=first.dtype).numpy()
        except TypeError as e:
            raise ValueError(f"leaf {_name(path)}: dtype {first.dtype} has "
                             f"no numpy counterpart ({e})") from e
        shape = tuple(lead) + tuple(first.shape)
        for pairs in segments(shape, world, rank):
            r0, r1 = (0, shape[0] if shape else 0) if pairs is None \
                else pairs[0]
            indices.append(i)
            slices.append(None if pairs is None else (pairs, list(shape)))
            arrays.append(_rows(tuple(lead), items, shape, r0, r1))
    return indices, slices, arrays


def write_spmd_shard(directory: str, shard_id: int, tree: Any,
                     world: Optional[int] = None,
                     rank: Optional[int] = None) -> Optional[dict]:
    """Persist this process's segments of ``tree`` as one shard file
    (``shard_id`` = the process's rank) and return its manifest entry:
    the only thing that goes to the driver.

    Args:
        directory: the temporary step directory (one filesystem).
        shard_id: this process's rank (shard ids are ranks in SPMD mode).
        tree: the train state.
        world, rank: as ``collect_segments``.
    Returns:
        The ``format.save_shard`` entry, or None when this process writes
        no block of any leaf.
    """
    indices, slices, arrays = collect_segments(tree, world, rank)
    if not indices:
        return None
    return fmt.save_shard(directory, shard_id, indices, arrays,
                          slices=slices)
