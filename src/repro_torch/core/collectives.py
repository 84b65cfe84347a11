"""Collectives over a mesh's dp process group.

Counterpart: ``repro/core/collectives.py`` (``fused_psum``,
``fused_pmean``, ``naive_psum``, ``reduce_scatter``, ``all_gather``,
``ring_all_reduce``, ``halo_exchange``, ``softmax_combine``,
``pipeline_shift``).  Where the reference names a mesh axis inside
``shard_map``, these take the port's ``launch.mesh.Mesh`` and run on its
dp process group (gloo): every rank of the mesh calls the same
collectives in the same order with its own local tensors, and gets what
the reference's body gets on its device.

gloo is the wire, the device keeps the compute: a CUDA tensor is copied
into a pinned host buffer (reused per size), exchanged, and copied back.
gloo takes CUDA tensors for few of its operations, and staging all of
them keeps one code path, which the CPU tests run, and makes the copies
visible: ``stats()`` counts the payload bytes handed to the wire, the
point-to-point hops, the seconds in gloo and the seconds of the staging
copies, per process.  The reduce-scatter is a ring of point-to-point
hops (``n - 1`` of them, each moving one ``1/n`` chunk), so that its
wire bytes are a reduce-scatter's and not an all-reduce's.
"""
from __future__ import annotations

import time

import torch
import torch.utils._pytree as pytree

from . import fusion

__all__ = ["all_gather", "all_reduce", "fused_pmean", "fused_psum",
           "halo_exchange", "naive_psum", "pipeline_shift", "pmean",
           "ppermute", "reduce_scatter", "reset_stats", "ring_all_reduce",
           "softmax_combine", "stats"]

_STATS = {"calls": 0, "bytes": 0, "hops": 0, "wire_s": 0.0,
          "staging_s": 0.0, "staged_bytes": 0}
_PINNED: dict = {}


def reset_stats() -> None:
    """Zero this process's wire counters."""
    for k in _STATS:
        _STATS[k] = type(_STATS[k])()


def stats() -> dict:
    """This process's wire counters since ``reset_stats``: ``calls``
    (collectives), ``bytes`` (payload handed to the wire), ``hops``
    (point-to-point sends), ``wire_s`` (seconds in gloo), ``staging_s``
    and ``staged_bytes`` (the device <-> pinned host copies)."""
    return dict(_STATS)


def _size(mesh) -> int:
    return 1 if mesh is None else mesh.dp_size


def _host(t: torch.Tensor, slot: str) -> torch.Tensor:
    """A host tensor holding ``t``'s values that the wire may overwrite:
    a clone on the CPU, a reused pinned buffer for a CUDA tensor."""
    if t.device.type == "cpu":
        return t.detach().clone().contiguous()
    key = (slot, t.numel(), t.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(t.numel(), dtype=t.dtype,
                                         pin_memory=True)
    torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    buf.copy_(t.detach().reshape(-1))
    _STATS["staging_s"] += time.perf_counter() - t0
    _STATS["staged_bytes"] += t.numel() * t.element_size()
    return buf.view(t.shape)


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``h`` on ``like``'s device (a new tensor on the card)."""
    if like.device.type == "cpu":
        return h
    t0 = time.perf_counter()
    out = h.to(like.device)
    _STATS["staging_s"] += time.perf_counter() - t0
    _STATS["staged_bytes"] += h.numel() * h.element_size()
    return out


def _wire(fn, nbytes: int, hops: int = 0):
    t0 = time.perf_counter()
    out = fn()
    _STATS["wire_s"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += nbytes
    _STATS["hops"] += hops
    return out


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The ``op`` (``sum`` or ``max``) of every rank's ``x``, a new tensor
    on ``x``'s device (``x`` itself at a dp size of 1)."""
    if _size(mesh) == 1:
        return x
    import torch.distributed as dist
    h = _host(x, "all_reduce")
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _wire(lambda: dist.all_reduce(h, op=red, group=mesh.group),
          h.numel() * h.element_size())
    return _back(h, x)


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of every rank's ``x``: the sum over the wire, then one
    division by the dp size (the reference's ``lax.pmean``)."""
    n = _size(mesh)
    return x if n == 1 else all_reduce(x, mesh).div_(n)


def all_gather(x: torch.Tensor, mesh, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in dp-rank order: concatenated along ``axis``
    (``tiled``) or stacked on a new leading dim."""
    n = _size(mesh)
    if n == 1:
        return x if tiled else x[None]
    import torch.distributed as dist
    h = _host(x, "all_gather")
    outs = [torch.empty_like(h) for _ in range(n)]
    _wire(lambda: dist.all_gather(outs, h, group=mesh.group),
          h.numel() * h.element_size())
    full = torch.cat(outs, dim=axis) if tiled else torch.stack(outs)
    return _back(full, x)


def ppermute(x: torch.Tensor, mesh, perm) -> torch.Tensor:
    """The reference's ``lax.ppermute``: for each ``(src, dst)`` pair of
    dp ranks, ``src``'s ``x`` goes to ``dst``; a rank no pair sends to
    gets zeros."""
    n = _size(mesh)
    if n == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    import torch.distributed as dist
    me = mesh.rank
    h = _host(x, "ppermute")
    recv = torch.zeros_like(h)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]

    def hop():
        reqs = [dist.isend(h, dst=mesh.ranks[d], group=mesh.group)
                for d in dsts]
        for s in srcs:
            dist.recv(recv, src=mesh.ranks[s], group=mesh.group)
        for r in reqs:
            r.wait()
    _wire(hop, len(dsts) * h.numel() * h.element_size(), hops=len(dsts))
    return _back(recv, x) if srcs else torch.zeros_like(x)


def _ring(n: int, step: int = 1):
    return [(i, (i + step) % n) for i in range(n)]


def reduce_scatter(x: torch.Tensor, mesh, *, axis: int = 0) -> torch.Tensor:
    """The sum over ranks of ``x``'s ``dp rank``-th chunk along ``axis``
    (the reference's tiled ``psum_scatter``), by ``n - 1`` ring hops: at
    hop ``s`` rank ``r`` passes its partial sum of chunk ``(r - s - 1) %
    n`` to rank ``r + 1``, which adds its own.

    Raises:
        ValueError: ``x.shape[axis]`` does not divide by the dp size.
    """
    n = _size(mesh)
    if n == 1:
        return x
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter of dim {x.shape[axis]} over "
                         f"{n} ranks")
    chunks = torch.chunk(x.movedim(axis, 0), n)
    r = mesh.rank
    acc = chunks[(r - 1) % n].contiguous()
    for s in range(n - 1):
        got = ppermute(acc, mesh, _ring(n))
        acc = got + chunks[(r - s - 2) % n]
    return acc.movedim(0, axis).contiguous()


def naive_psum(tree, mesh):
    """Horovod baseline: one all-reduce per tensor, no fusion (Fig. 1)."""
    return pytree.tree_map(lambda g: all_reduce(g, mesh), tree)


def fused_psum(tree, mesh, cap_bytes: int = 32 * 1024 * 1024):
    """All-reduce a tree in dtype-homogeneous fused buckets (paper R5)."""
    return fusion.fused_apply(tree, lambda b: all_reduce(b, mesh), cap_bytes)


def fused_pmean(tree, mesh, cap_bytes: int = 32 * 1024 * 1024):
    return fusion.fused_apply(tree, lambda b: pmean(b, mesh), cap_bytes)


def ring_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce: the ring reduce-scatter's
    ``n - 1`` point-to-point hops (``stats()["hops"]``), then an
    all-gather of the reduced chunks.  An indivisible payload takes the
    plain all-reduce, as in the reference."""
    n = _size(mesh)
    if n == 1:
        return x
    if x.numel() % n:
        return all_reduce(x, mesh)
    part = reduce_scatter(x.reshape(n, -1), mesh)
    return all_gather(part, mesh).reshape(x.shape)


def halo_exchange(x: torch.Tensor, mesh, halo: int, *,
                  dim: int = 0) -> torch.Tensor:
    """Overlapped tiling: the tile extended by ``halo`` ghost slices from
    each neighbour; the edge tiles get zeros (non-periodic boundary)."""
    n, idx = _size(mesh), (mesh.rank if mesh is not None else 0)
    lo = x.narrow(dim, 0, halo).contiguous()
    hi = x.narrow(dim, x.shape[dim] - halo, halo).contiguous()
    from_left = ppermute(hi, mesh, _ring(n, +1))      # rank i-1's hi
    from_right = ppermute(lo, mesh, _ring(n, -1))     # rank i+1's lo
    if idx == 0:
        from_left = torch.zeros_like(lo)
    if idx == n - 1:
        from_right = torch.zeros_like(lo)
    return torch.cat([from_left, x, from_right], dim=dim)


def softmax_combine(partials, mesh) -> torch.Tensor:
    """Exact merge of per-rank softmax partials ``(m, l, o)`` (running
    max, denominator, weighted values) across a sharded KV axis: a max
    and two sums over the wire, O(d) per token."""
    m, l, o = partials
    m_glob = all_reduce(m, mesh, "max")
    scale = torch.exp(m - m_glob)
    l_glob = all_reduce(l * scale, mesh)
    o_glob = all_reduce(o * scale, mesh)
    return o_glob / torch.clamp(l_glob, min=1e-30)


def pipeline_shift(x: torch.Tensor, mesh, *,
                   reverse: bool = False) -> torch.Tensor:
    """Hand activations (or gradients, ``reverse``) to the neighbouring
    stage of the ring."""
    return ppermute(x, mesh, _ring(_size(mesh), -1 if reverse else 1))

