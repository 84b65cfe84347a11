"""The data-parallel gradient exchange and solver update (paper R3).

Counterpart: ``repro/core/overlap.py`` (``exchange_horovod``,
``exchange_phylanx``, ``dense_update``, ``zero1_scatter_mask``,
``zero1_init_state``, ``zero1_state_shard_specs``, ``zero1_update``).
The reference runs these inside ``shard_map`` over its dp mesh axes; here
every rank process of a ``launch.mesh.Mesh`` runs them on its own
gradients and exchanges over the mesh's dp group (``core/collectives``):

  * ``horovod`` - the paper's Fig.-1 baseline: one all-reduce mean per
    gradient tensor;
  * ``phylanx`` - gradients coalesced into capped fusion buckets (R5),
    one all-reduce mean per bucket;
  * ``zero1``   - beyond-paper: each gradient reduce-scattered along its
    leading dim, so each rank keeps solver state for 1/N of every leaf
    whose leading dim divides; updated shards are all-gathered back.

ZeRO-1 works on the reference's leaves: a per-layer list of the port's
tree is one leaf stacked along a leading layer dim (``fusion.make_plan``
groups them), and splitting that leaf's leading dim over N ranks gives
rank ``r`` the ``r``-th contiguous ``1/N`` of its row-major ravel.  So a
rank's m and v for a scattered leaf are one flat float32 chunk, and for
any other leaf the whole flattened leaf.  This module is the one place
that maps between that per-rank state and the reference's global layout
(``zero1_gather_state``, ``zero1_shard_state``): checkpoints, the bridge
and ``TrainStep.opt_structs`` see only the global one.

On a mesh with a model axis every exchange here runs over the dp group
of this rank's column on its own model blocks: the ZeRO-1 ranges are
those of the blocks' ravels (``leaves`` of the local specs), the scatter
decision is the reference's on the global leaves (a leaf split over the
model axis on its dim 0 is never scattered), and the gradient norm sums
the model-split leaves' squares over the model group as well
(``zero1_update``'s ``leaf_split``).  ``TrainStep.gather_opt`` and
``shard_opt`` add the model axis to the two layout helpers.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from . import collectives, fusion
from .sharding import ParamSpec, is_spec, spec_for
from ..optim import optimizers as optim

__all__ = ["dense_update", "exchange_horovod", "exchange_phylanx",
           "stacked_specs", "zero1_gather_state", "zero1_init_state",
           "zero1_local_state", "zero1_scatter_mask", "zero1_shard_state",
           "zero1_state_shard_specs", "zero1_update"]


def _size(mesh) -> int:
    return 1 if mesh is None else mesh.dp_size


def exchange_horovod(grads, mesh):
    """Per-tensor all-reduce mean (Fig. 1 baseline)."""
    return pytree.tree_map(lambda g: collectives.pmean(g, mesh), grads)


def exchange_phylanx(grads, mesh, bucket_bytes: int, fuse_mask=None):
    """Fused-bucket all-reduce mean.  ``fuse_mask``: a bool tree shaped
    like ``grads``, True for tensors that may share a bucket (not sharded
    on the model axis); the others go through a per-tensor all-reduce."""
    leaves, spec = pytree.tree_flatten(grads)
    mask = [True] * len(leaves) if fuse_mask is None \
        else pytree.tree_leaves(fuse_mask)
    if all(mask):       # the reference's buckets over the whole tree
        return collectives.fused_pmean(grads, mesh, bucket_bytes)
    # the fusable leaves in flatten order, keyed so that they sort so
    fusable = {f"{i:08d}": g for i, (g, m) in enumerate(zip(leaves, mask))
               if m}
    fused = collectives.fused_pmean(fusable, mesh, bucket_bytes) \
        if fusable else {}
    out = [fused[f"{i:08d}"] if m else collectives.pmean(g, mesh)
           for i, (g, m) in enumerate(zip(leaves, mask))]
    return pytree.tree_unflatten(out, spec)


def dense_update(grads, opt_state, params, oc, mesh, *, strategy: str,
                 bucket_bytes: int):
    if strategy == "horovod":
        grads = exchange_horovod(grads, mesh)
    else:
        grads = exchange_phylanx(grads, mesh, bucket_bytes)
    return optim.update(grads, opt_state, params, oc)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One reference leaf of a port tree: its stacked spec and the port
    leaves (flatten positions) it stacks, in layer order."""
    spec: ParamSpec
    members: tuple
    member_shape: tuple


def stacked_specs(param_specs) -> list:
    """The reference's leaves of a port spec tree, in its flatten order:
    ``_Leaf(spec, members, member_shape)``, the spec stacked along one leading
    ``layers`` dim per list level (dims that no rule shards)."""
    plan = fusion.make_plan(param_specs, cap_bytes=1 << 62)
    entries = {e.index: e for b in plan.buckets for e in b.entries}
    flat = pytree.tree_leaves(param_specs, is_leaf=is_spec)
    out = []
    for j, members in enumerate(plan.members):
        one = flat[members[0]]
        lead = len(entries[j].shape) - len(one.shape)
        out.append(_Leaf(ParamSpec(entries[j].shape,
                                   ("layers",) * lead + tuple(one.dims),
                                   one.dtype, one.init, one.scale),
                         tuple(members), tuple(one.shape)))
    return out


def zero1_scatter_mask(param_specs, mesh, rules, ndp: int,
                       min_size: int = 1 << 14):
    """Per-leaf bool tree: True -> solver state sharded over dp on dim0
    (dim0 divides ``ndp``, the leaf has ``min_size`` elements or more,
    dim0 is not on the model axis, and ``ndp > 1``)."""
    def decide(s: ParamSpec) -> bool:
        if not s.shape or s.shape[0] % max(ndp, 1) or s.size < min_size:
            return False
        pspec = spec_for(mesh, rules, s.shape, s.dims)
        return bool((len(pspec) == 0 or pspec[0] is None) and ndp > 1)
    return pytree.tree_map(decide, param_specs, is_leaf=is_spec)


def zero1_init_state(param_specs, scatter_mask, ndp: int):
    """The GLOBAL zero state (the reference's layout): count, and m and
    v shaped like the parameters in float32, on the CPU."""
    def zeros():
        return pytree.tree_map(lambda s: torch.zeros(s.shape),
                               param_specs, is_leaf=is_spec)
    return {"count": torch.zeros((), dtype=torch.int32), "m": zeros(),
            "v": zeros()}


def zero1_state_shard_specs(leaves: list, scatter_mask: list, mesh) -> list:
    """The per-rank counterpart of the reference's shard_map in_specs:
    for each reference leaf, the ``[start, stop)`` of its flat ravel that
    this rank's m and v hold (the whole leaf when not scattered)."""
    n, r = _size(mesh), (mesh.rank if mesh is not None else 0)
    out = []
    for leaf, sc in zip(leaves, scatter_mask):
        size = leaf.spec.size
        out.append((r * size // n, (r + 1) * size // n) if sc
                   else (0, size))
    return out


def zero1_local_state(leaves: list, scatter_mask: list, mesh, device):
    """This rank's zero state: ``count``, and per reference leaf a flat
    float32 m and v of its ``zero1_state_shard_specs`` range."""
    ranges = zero1_state_shard_specs(leaves, scatter_mask, mesh)

    def zeros():
        return [torch.zeros(b - a, dtype=torch.float32, device=device)
                for a, b in ranges]
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "m": zeros(), "v": zeros()}


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors]) \
        if len(tensors) > 1 else tensors[0].reshape(-1).float()


def zero1_gather_state(opt, leaves: list, scatter_mask: list, mesh,
                       like_params):
    """The reference's global zero1 state from every rank's shards (a
    collective: every rank of the mesh calls it), as a port tree shaped
    like ``like_params`` of float32 CPU tensors."""
    def whole(chunks):
        out = [None] * sum(len(l.members) for l in leaves)
        for leaf, sc, c in zip(leaves, scatter_mask, chunks):
            full = collectives.all_gather(c, mesh) if sc else c
            full = full.detach().to("cpu", torch.float32)
            per = full.numel() // len(leaf.members)
            for k, m in enumerate(leaf.members):
                out[m] = full[k * per:(k + 1) * per].reshape(
                    leaf.member_shape).clone()
        return pytree.tree_unflatten(out, pytree.tree_structure(like_params))
    return {"count": opt["count"].detach().cpu(), "m": whole(opt["m"]),
            "v": whole(opt["v"])}


def zero1_shard_state(opt_global, leaves: list, scatter_mask: list, mesh,
                      device):
    """This rank's zero1 state cut from the reference's global layout (a
    port tree ``{"count", "m", "v"}``), on ``device``."""
    ranges = zero1_state_shard_specs(leaves, scatter_mask, mesh)

    def cut(tree):
        flat = pytree.tree_leaves(tree)
        return [_flat([flat[m] for m in leaf.members])[a:b].to(
                    device, copy=True) for leaf, (a, b) in zip(leaves, ranges)]
    return {"count": opt_global["count"].to(device, torch.int32),
            "m": cut(opt_global["m"]), "v": cut(opt_global["v"])}


@torch.no_grad()
def zero1_update(grads, opt_state, params, oc, mesh, leaves: list,
                 scatter_mask: list, *, leaf_split=None):
    """ZeRO-1 step on this rank: each reference leaf's float32 gradient
    reduce-scattered (``/ ndp``) where scattered, all-reduced (mean)
    where not; the exact global norm ``sqrt(psum(sq_scattered) +
    sq_dense)`` (the leaves of ``leaf_split``, split over the model axis,
    summed over the model group too); the solver
    (``optim.zero1_shard_update``) on this rank's shard; then an
    all-gather of the updated shard into the parameters (in place).
    Returns ``(params, state, {"grad_norm"})``."""
    n = _size(mesh)
    count = opt_state["count"] + 1
    g_flat = pytree.tree_leaves(grads)
    p_flat = pytree.tree_leaves(params)
    dev = p_flat[0].device
    if leaf_split is None:
        leaf_split = [False] * len(leaves)

    reduced = []
    # squares by (scattered over dp, split over the model axis)
    sq = {(a, b): torch.zeros((), dtype=torch.float32, device=dev)
          for a in (True, False) for b in (True, False)}
    for leaf, sc, ms in zip(leaves, scatter_mask, leaf_split):
        g = _flat([g_flat[m] for m in leaf.members])
        if sc:
            g_r = collectives.reduce_scatter(g, mesh).div_(n)
        else:
            g_r = collectives.pmean(g, mesh)
        sq[sc, bool(ms)] = sq[sc, bool(ms)] + g_r.square().sum()
        reduced.append(g_r)
        del g
    if any(leaf_split):
        whole = {b: collectives.all_reduce(sq[True, b], mesh) + sq[False, b]
                 for b in (True, False)}
        gn = torch.sqrt(whole[False] + collectives.all_reduce(
            whole[True], mesh, mesh_axis="model"))
    else:
        gn = torch.sqrt(collectives.all_reduce(sq[True, False], mesh)
                        + sq[False, False])
    clip = optim._clip_scale(gn, oc.grad_clip)

    ranges = zero1_state_shard_specs(leaves, scatter_mask, mesh)
    for leaf, sc, g_r, m, v, (a, b) in zip(
            leaves, scatter_mask, reduced, opt_state["m"], opt_state["v"],
            ranges):
        members = [p_flat[i] for i in leaf.members]
        p_sh = _flat(members)[a:b]
        p2 = optim.zero1_shard_update(g_r, p_sh, m, v, count, oc, clip)
        if sc:
            p2 = collectives.all_gather(p2, mesh)
        per = p2.numel() // len(members)
        for k, p in enumerate(members):
            p.copy_(p2[k * per:(k + 1) * per].view(p.shape))
    return params, {"count": count, "m": opt_state["m"],
                    "v": opt_state["v"]}, {"grad_norm": gn}
