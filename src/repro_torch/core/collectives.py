"""Collectives over a mesh's dp, model or stage process group.

Counterpart: ``repro/core/collectives.py`` (``fused_psum``,
``fused_pmean``, ``naive_psum``, ``reduce_scatter``, ``all_gather``,
``ring_all_reduce``, ``halo_exchange``, ``softmax_combine``,
``pipeline_shift``).  Where the reference names a mesh axis inside
``shard_map``, these take the port's ``launch.mesh.Mesh`` and the axis
they run over: ``"dp"`` (the default: the ``pod`` and ``data`` axes, the
mesh's dp process group), ``"model"`` (its model group, the row of
ranks that share one dp rank), ``"stage"`` (the stage group of a GPipe
mesh) or ``"mesh"`` (every rank of the mesh, data-major: where the
reference names ``("data", "model")``); on a mesh with pods also
``"data"`` (a pod's ``data`` axis) and ``"pod"`` (a pod's ranks: its
``("data", "model")``).  ``axis_of`` maps the reference's axis names
onto these.  ``broadcast_object`` sends a picklable value
from the group's first rank to the others (the gateway's command
stream).  Every
rank of the group calls the same collectives in the same order with its
own local tensors (gloo), and gets what the reference's body gets on its
device.

The model axis also has the two autograd pairs that XLA's partitioner
inserts around a tensor-parallel product in the reference:
``copy_to_model`` (identity forward, all-reduce backward: into a
column-parallel product, whose input gradient each rank holds a part of)
and ``reduce_from_model`` (all-reduce forward, identity backward: out of
a row-parallel product, whose output each rank holds a part of).
Under sequence parallelism the residual between blocks holds this rank's
rows of the sequence, and the pairs become ``all_gather_seq`` (all-gather
along ``seq`` forward, reduce-scatter backward: into a column-parallel
product) and ``reduce_scatter_seq`` (reduce-scatter along ``seq``
forward, all-gather backward: out of a row-parallel product), the
collectives XLA inserts around the reference's ``act_constrain``.
``pipeline_shift`` is an autograd function too: its backward is the
reverse shift, the transpose JAX derives for ``ppermute``.  Two more
pairs serve the layers whose blocks are not a Megatron split (the moe
and zamba families): ``gather_from_model`` (all-gather forward, this
rank's slice backward: a tensor that every rank then uses whole and
alike, as the router's logits before the softmax) and ``sum_over_model``
(all-reduce forward and backward: a sum that each rank then uses for its
own part, as the gated norm's sum of squares over a split ``d_in``);
``all_gather_seq`` also gathers any other dim (the mamba projection's
columns: each rank then reads its own of them).

gloo is the wire, the device keeps the compute: a CUDA tensor is copied
into a pinned host buffer (reused per size), exchanged, and copied back.
gloo takes CUDA tensors for few of its operations, and staging all of
them keeps one code path, which the CPU tests run, and makes the copies
visible: ``stats()`` counts the payload bytes handed to the wire, the
point-to-point hops, the seconds in gloo and the seconds of the staging
copies, per process.  The reduce-scatter is a ring of point-to-point
hops (``n - 1`` of them, each moving one ``1/n`` chunk), so that its
wire bytes are a reduce-scatter's and not an all-reduce's.  ``stats()``
also keeps the counters of each axis apart (``stats()["axes"]``).
"""
from __future__ import annotations

import time

import torch
import torch.utils._pytree as pytree

from . import fusion

__all__ = ["AXES", "all_gather", "all_gather_seq", "all_reduce", "axis_of",
           "broadcast_object", "copy_to_model", "fused_pmean", "fused_psum",
           "gather_from_model", "halo_exchange", "naive_psum",
           "pipeline_shift", "pmean", "ppermute", "reduce_from_model",
           "reduce_scatter", "reduce_scatter_seq", "reset_stats",
           "ring_all_reduce", "softmax_combine", "stats",
           "sum_over_model"]

#: the axes a collective runs over
AXES = ("dp", "model", "stage", "mesh", "data", "pod")

_KEYS = {"calls": 0, "bytes": 0, "hops": 0, "wire_s": 0.0,
         "staging_s": 0.0, "staged_bytes": 0}
_STATS = {a: dict(_KEYS) for a in AXES}
_PINNED: dict = {}


def reset_stats() -> None:
    """Zero this process's wire counters."""
    for a in AXES:
        _STATS[a] = dict(_KEYS)


def stats() -> dict:
    """This process's wire counters since ``reset_stats``, summed over
    the axes: ``calls`` (collectives), ``bytes`` (payload handed to the
    wire), ``hops`` (point-to-point sends), ``wire_s`` (seconds in gloo),
    ``staging_s`` and ``staged_bytes`` (the device <-> pinned host
    copies); and ``axes``: the same counters of each axis."""
    out = {k: sum(_STATS[a][k] for a in AXES) for k in _KEYS}
    out["axes"] = {a: dict(_STATS[a]) for a in AXES}
    return out


def _check(axis: str) -> None:
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r} (have {AXES})")


def axis_of(mesh, name) -> str:
    """The collectives axis of the reference's mesh axis ``name`` (a
    name or a tuple of names; the ones absent from ``mesh`` are
    dropped, and a tuple's axes of size 1 add nothing): ``"dp"`` for the
    ``pod`` and ``data`` axes, ``"model"``, ``"stage"``, ``"mesh"`` for
    every axis > 1 of a dp and model mesh (``("data", "model")``), and on
    a mesh with pods ``"data"`` and ``"pod"`` for ``data`` and
    ``("data", "model")`` within a pod.

    Raises:
        NotImplementedError: ``name`` spans groups that the mesh does not
            have (``pod`` without ``data``, or with ``model``).
    """
    names = (name,) if isinstance(name, str) else tuple(name)
    names = tuple(a for a in names if a in mesh.shape)
    if names in (("model",), ("stage",)):
        return names[0]
    sized = {a for a in names if mesh.shape[a] > 1}
    big = {a for a, n in mesh.shape.items() if n > 1}
    if sized == {"model"}:
        return "model"
    if sized <= {"pod", "data"} and big & {"pod", "data"} <= sized:
        return "dp"
    if "stage" not in big and sized == big:
        return "mesh"
    if "pod" in big and sized == {"data"}:
        return "data"
    if "pod" in big and sized == {"data", "model"}:
        return "pod"
    raise NotImplementedError(f"mesh axes {names} as one process group of "
                              f"the mesh {mesh.shape}")


def _size(mesh, axis: str = "dp") -> int:
    _check(axis)
    if mesh is None:
        return 1
    return {"dp": mesh.dp_size, "model": mesh.model_size,
            "stage": mesh.stage_size, "mesh": mesh.world_size,
            "data": len(mesh.data_ranks), "pod": len(mesh.pod_ranks)}[axis]


def _group(mesh, axis: str):
    return {"dp": mesh.group, "model": mesh.model_group,
            "stage": mesh.stage_group, "mesh": mesh.world_group,
            "data": mesh.data_group, "pod": mesh.pod_group}[axis]


def _index(mesh, axis: str) -> int:
    """This rank's place in the ``axis`` group."""
    if mesh is None:
        return 0
    return {"dp": mesh.rank, "model": mesh.model_rank,
            "stage": mesh.stage_rank, "mesh": mesh.world_rank,
            "data": mesh.coords.get("data", 0),
            "pod": mesh.coords.get("data", 0) * mesh.model_size
            + mesh.model_rank}[axis]


def _world_ranks(mesh, axis: str) -> tuple:
    return {"dp": mesh.ranks, "model": mesh.model_ranks,
            "stage": mesh.stage_ranks, "mesh": mesh.world_ranks,
            "data": mesh.data_ranks, "pod": mesh.pod_ranks}[axis]


def _host(t: torch.Tensor, slot: str, axis: str) -> torch.Tensor:
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
    _STATS[axis]["staging_s"] += time.perf_counter() - t0
    _STATS[axis]["staged_bytes"] += t.numel() * t.element_size()
    return buf.view(t.shape)


def _back(h: torch.Tensor, like: torch.Tensor, axis: str) -> torch.Tensor:
    """``h`` on ``like``'s device (a new tensor on the card)."""
    if like.device.type == "cpu":
        return h
    t0 = time.perf_counter()
    out = h.to(like.device)
    _STATS[axis]["staging_s"] += time.perf_counter() - t0
    _STATS[axis]["staged_bytes"] += h.numel() * h.element_size()
    return out


def _wire(fn, nbytes: int, axis: str, hops: int = 0):
    t0 = time.perf_counter()
    out = fn()
    st = _STATS[axis]
    st["wire_s"] += time.perf_counter() - t0
    st["calls"] += 1
    st["bytes"] += nbytes
    st["hops"] += hops
    return out


def all_reduce(x: torch.Tensor, mesh, op: str = "sum", *,
               mesh_axis: str = "dp") -> torch.Tensor:
    """The ``op`` (``sum`` or ``max``) of every ``mesh_axis`` rank's
    ``x``, a new tensor on ``x``'s device (``x`` itself when the axis is
    1)."""
    if _size(mesh, mesh_axis) == 1:
        return x
    import torch.distributed as dist
    h = _host(x, "all_reduce", mesh_axis)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _wire(lambda: dist.all_reduce(h, op=red,
                                  group=_group(mesh, mesh_axis)),
          h.numel() * h.element_size(), mesh_axis)
    return _back(h, x, mesh_axis)


def pmean(x: torch.Tensor, mesh, *, mesh_axis: str = "dp") -> torch.Tensor:
    """The mean of every rank's ``x``: the sum over the wire, then one
    division by the axis size (the reference's ``lax.pmean``)."""
    n = _size(mesh, mesh_axis)
    return x if n == 1 else all_reduce(x, mesh,
                                       mesh_axis=mesh_axis).div_(n)


def all_gather(x: torch.Tensor, mesh, *, axis: int = 0, tiled: bool = True,
               mesh_axis: str = "dp") -> torch.Tensor:
    """Every ``mesh_axis`` rank's ``x`` in rank order: concatenated along
    ``axis`` (``tiled``) or stacked on a new leading dim."""
    n = _size(mesh, mesh_axis)
    if n == 1:
        return x if tiled else x[None]
    import torch.distributed as dist
    h = _host(x.contiguous(), "all_gather", mesh_axis)
    outs = [torch.empty_like(h) for _ in range(n)]
    _wire(lambda: dist.all_gather(outs, h, group=_group(mesh, mesh_axis)),
          h.numel() * h.element_size(), mesh_axis)
    full = torch.cat(outs, dim=axis) if tiled else torch.stack(outs)
    return _back(full, x, mesh_axis)


def broadcast_object(obj, mesh, *, mesh_axis: str = "mesh"):
    """The first ``mesh_axis`` rank's picklable ``obj`` on every rank of
    the group (the others pass anything, None by convention): its length,
    then its pickled bytes, from the host."""
    if _size(mesh, mesh_axis) == 1:
        return obj
    import pickle

    import torch.distributed as dist
    group, src = _group(mesh, mesh_axis), _world_ranks(mesh, mesh_axis)[0]
    first = _index(mesh, mesh_axis) == 0
    blob = pickle.dumps(obj) if first else b""
    n = torch.tensor([len(blob)], dtype=torch.int64)
    _wire(lambda: dist.broadcast(n, src=src, group=group), 8, mesh_axis)
    buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8) if first \
        else torch.empty(int(n), dtype=torch.uint8)
    _wire(lambda: dist.broadcast(buf, src=src, group=group), int(n),
          mesh_axis)
    return obj if first else pickle.loads(buf.numpy().tobytes())


def ppermute(x: torch.Tensor, mesh, perm, *,
             mesh_axis: str = "dp") -> torch.Tensor:
    """The reference's ``lax.ppermute``: for each ``(src, dst)`` pair of
    ``mesh_axis`` ranks, ``src``'s ``x`` goes to ``dst``; a rank no pair
    sends to gets zeros."""
    axis = mesh_axis
    n = _size(mesh, axis)
    if n == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    import torch.distributed as dist
    me, ranks, group = _index(mesh, axis), _world_ranks(mesh, axis), \
        _group(mesh, axis)
    h = _host(x, "ppermute", axis)
    recv = torch.zeros_like(h)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]

    def hop():
        reqs = [dist.isend(h, dst=ranks[d], group=group) for d in dsts]
        for s in srcs:
            dist.recv(recv, src=ranks[s], group=group)
        for r in reqs:
            r.wait()
    _wire(hop, len(dsts) * h.numel() * h.element_size(), axis,
          hops=len(dsts))
    return _back(recv, x, axis) if srcs else torch.zeros_like(x)


def _ring(n: int, step: int = 1):
    return [(i, (i + step) % n) for i in range(n)]


def reduce_scatter(x: torch.Tensor, mesh, *, axis: int = 0,
                   mesh_axis: str = "dp") -> torch.Tensor:
    """The sum over ranks of ``x``'s ``rank``-th chunk along ``axis``
    (the reference's tiled ``psum_scatter``), by ``n - 1`` ring hops: at
    hop ``s`` rank ``r`` passes its partial sum of chunk ``(r - s - 1) %
    n`` to rank ``r + 1``, which adds its own.

    Raises:
        ValueError: ``x.shape[axis]`` does not divide by the axis size.
    """
    n = _size(mesh, mesh_axis)
    if n == 1:
        return x
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter of dim {x.shape[axis]} over "
                         f"{n} ranks")
    chunks = torch.chunk(x.movedim(axis, 0), n)
    r = _index(mesh, mesh_axis)
    acc = chunks[(r - 1) % n].contiguous()
    for s in range(n - 1):
        got = ppermute(acc, mesh, _ring(n), mesh_axis=mesh_axis)
        acc = got + chunks[(r - s - 2) % n]
    return acc.movedim(0, axis).contiguous()


def naive_psum(tree, mesh, *, mesh_axis: str = "dp"):
    """Horovod baseline: one all-reduce per tensor, no fusion (Fig. 1)."""
    return pytree.tree_map(
        lambda g: all_reduce(g, mesh, mesh_axis=mesh_axis), tree)


def fused_psum(tree, mesh, cap_bytes: int = 32 * 1024 * 1024, *,
               mesh_axis: str = "dp"):
    """All-reduce a tree in dtype-homogeneous fused buckets (paper R5)."""
    return fusion.fused_apply(
        tree, lambda b: all_reduce(b, mesh, mesh_axis=mesh_axis), cap_bytes)


def fused_pmean(tree, mesh, cap_bytes: int = 32 * 1024 * 1024, *,
                mesh_axis: str = "dp"):
    return fusion.fused_apply(
        tree, lambda b: pmean(b, mesh, mesh_axis=mesh_axis), cap_bytes)


def ring_all_reduce(x: torch.Tensor, mesh, *,
                    mesh_axis: str = "dp") -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce: the ring reduce-scatter's
    ``n - 1`` point-to-point hops (``stats()["hops"]``), then an
    all-gather of the reduced chunks.  An indivisible payload takes the
    plain all-reduce, as in the reference."""
    n = _size(mesh, mesh_axis)
    if n == 1:
        return x
    if x.numel() % n:
        return all_reduce(x, mesh, mesh_axis=mesh_axis)
    part = reduce_scatter(x.reshape(n, -1), mesh, mesh_axis=mesh_axis)
    return all_gather(part, mesh, mesh_axis=mesh_axis).reshape(x.shape)


def halo_exchange(x: torch.Tensor, mesh, halo: int, *, dim: int = 0,
                  mesh_axis: str = "dp") -> torch.Tensor:
    """Overlapped tiling: the tile extended by ``halo`` ghost slices from
    each neighbour; the edge tiles get zeros (non-periodic boundary)."""
    n, idx = _size(mesh, mesh_axis), _index(mesh, mesh_axis)
    lo = x.narrow(dim, 0, halo).contiguous()
    hi = x.narrow(dim, x.shape[dim] - halo, halo).contiguous()
    from_left = ppermute(hi, mesh, _ring(n, +1),       # rank i-1's hi
                         mesh_axis=mesh_axis)
    from_right = ppermute(lo, mesh, _ring(n, -1),      # rank i+1's lo
                          mesh_axis=mesh_axis)
    if idx == 0:
        from_left = torch.zeros_like(lo)
    if idx == n - 1:
        from_right = torch.zeros_like(lo)
    return torch.cat([from_left, x, from_right], dim=dim)


def softmax_combine(partials, mesh, *, mesh_axis: str = "dp"
                    ) -> torch.Tensor:
    """Exact merge of per-rank softmax partials ``(m, l, o)`` (running
    max, denominator, weighted values) across a sharded KV axis: a max
    and two sums over the wire, O(d) per token."""
    m, l, o = partials
    m_glob = all_reduce(m, mesh, "max", mesh_axis=mesh_axis)
    scale = torch.exp(m - m_glob)
    l_glob = all_reduce(l * scale, mesh, mesh_axis=mesh_axis)
    o_glob = all_reduce(o * scale, mesh, mesh_axis=mesh_axis)
    return o_glob / torch.clamp(l_glob, min=1e-30)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, step, axis):
        ctx.mesh, ctx.step, ctx.axis = mesh, step, axis
        return ppermute(x, mesh, _ring(_size(mesh, axis), step),
                        mesh_axis=axis)

    @staticmethod
    def backward(ctx, g):
        return ppermute(g.contiguous(), ctx.mesh,
                        _ring(_size(ctx.mesh, ctx.axis), -ctx.step),
                        mesh_axis=ctx.axis), None, None, None


def pipeline_shift(x: torch.Tensor, mesh, *, reverse: bool = False,
                   mesh_axis: str = "dp") -> torch.Tensor:
    """Hand activations (or gradients, ``reverse``) to the neighbouring
    stage of the ring: rank ``i``'s ``x`` goes to rank ``i + 1`` (``i -
    1``).  Differentiable: the gradient goes the other way round the
    ring."""
    return _Shift.apply(x.contiguous(), mesh, -1 if reverse else 1,
                        mesh_axis)


# ---------------------------------------------------------------------------
# Autograd pairs of the model axis
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, mesh_axis="model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous(), mesh, mesh_axis="model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity forward, sum over the model group backward: the input of
    a column-parallel product, each rank's gradient of which is the part
    its own columns give."""
    if _size(mesh, "model") == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the model group forward, identity backward: the output of
    a row-parallel product, each rank's value of which is the part its
    own rows give."""
    if _size(mesh, "model") == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x.contiguous(), mesh, axis=dim, mesh_axis="model")

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.mesh, axis=ctx.dim,
                              mesh_axis="model"), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return reduce_scatter(x.contiguous(), mesh, axis=dim,
                              mesh_axis="model")

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, axis=ctx.dim,
                          mesh_axis="model"), None, None


def all_gather_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """Every model rank's rows of the sequence (dim ``dim``), in rank
    order, forward; the sum over the model group of the gradient's rows
    of this rank (a reduce-scatter), backward: the input of a
    column-parallel product under sequence parallelism.  Along any other
    dim the same pair joins blocks that each rank then reads its own part
    of (the mamba layer's projection columns, ``dim=-1``)."""
    if _size(mesh, "model") == 1:
        return x
    return _AllGatherSeq.apply(x, mesh, dim)


def reduce_scatter_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The sum over the model group of this rank's rows of the sequence
    (dim ``dim``: a reduce-scatter), forward; the gradient of every
    rank's rows (an all-gather), backward: the output of a row-parallel
    product under sequence parallelism."""
    if _size(mesh, "model") == 1:
        return x
    return _ReduceScatterSeq.apply(x, mesh, dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(x.contiguous(), mesh, axis=dim, mesh_axis="model")

    @staticmethod
    def backward(ctx, g):
        i = _index(ctx.mesh, "model")
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x.contiguous(), mesh, mesh_axis="model")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, mesh_axis="model"), None


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Every model rank's block along ``dim``, in rank order, forward;
    this rank's block of the gradient, backward (no sum): a tensor that
    every rank uses whole and alike from then on, so that each rank's
    gradient of it is already the whole one."""
    if _size(mesh, "model") == 1:
        return x
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def sum_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the model group, forward and backward: a sum of
    per-rank parts that each rank then uses for its own part of the
    output, so that the gradient of the sum is spread over the ranks."""
    if _size(mesh, "model") == 1:
        return x
    return _SumOverModel.apply(x, mesh)
