"""Gradient compression for the data-parallel wire: 1-bit signs with
per-row L1 scales and error feedback.

Counterpart: ``repro/optim/compression.py:19-108`` (``ROW``,
``pack_bits``/``unpack_bits``, ``pack_signs``/``unpack_signs``,
``quantize_bucket``, ``dequantize_bucket``, ``make_plan``,
``init_error_state``, ``exchange_onebit``).  ``exchange_onebit`` is the
``onebit`` strategy's exchange over a mesh's dp group: per bucket one K3a
launch for this rank's payload and one K3b launch for each origin's.

On a model axis > 1 the buckets are the reference's: ``make_plan`` over
the GLOBAL float32 leaves, as ``repro/core/steps.py:206-263`` packs them
inside a ``shard_map`` whose dp axes are manual and whose ``model`` axis
is automatic.  A rank holds its blocks of the split leaves, so for each
bucket it gathers over its model group the split leaves that the bucket
holds (float32, ``sharding.gather_leaf``, counted on the ``model`` axis
of ``collectives.stats()``), packs the global bucket, runs K3a on it
with its residual, all-gathers the words and scales over its dp group
and decodes every origin with K3b in origin order; from the mean it cuts
its own blocks of the bucket's leaves.  One bucket is gathered at a
time (the largest, an embedding, is 1.56 GB in float32 for qwen3-4b).
Every model rank of a dp coordinate computes the same bucket and
residual, bit for bit: the reference's ``ef``, split over dp and
replicated over ``model`` (``:294-298``); each rank updates its global
residual in place, where the data axes alone return a new one.  The dp wire per bucket and
rank stays ``size / 8 + size / 256`` bytes.

PyTorch's uint32 arithmetic is thin, so sign words are int32 tensors
whose bytes equal the reference's little-endian uint32 words: bit j of
word w is element ``32 w + j``.  ``pack_bits``/``unpack_bits`` live
beside the 1-bit kernels (``kernels/onebit.py``), whose plain versions use
them; ``quantize_bucket`` and ``dequantize_bucket`` run those kernels,
which take their plain versions on CPU tensors.
"""
from __future__ import annotations

import math

import torch
import torch.utils._pytree as pytree

from ..core import collectives, fusion
from ..core.sharding import gather_leaf, is_spec, shard_leaf
from ..kernels.onebit import (onebit_dequantize, onebit_quantize, pack_bits,
                              unpack_bits)

__all__ = ["ROW", "bucket_blocks", "dequantize_bucket", "exchange_onebit",
           "global_bucket", "init_error_state", "make_plan", "pack_bits",
           "pack_signs", "quantize_bucket", "unpack_bits", "unpack_signs"]

ROW = 1024  # bucket rows are reshaped to [R, ROW] for per-row scales


def pack_signs(signs):
    """bool [n] (any n) -> int32 [ceil(n/32)] bitmap, zero-padded; the 1-D
    face of :func:`pack_bits`.  Inverse: ``unpack_signs(packed, n)``."""
    n = signs.shape[0]
    flat = torch.nn.functional.pad(signs.to(torch.bool), (0, (-n) % 32))
    return pack_bits(flat.reshape(1, -1))[0]


def unpack_signs(packed, n: int):
    """int32 [ceil(n/32)] -> bool [n]; inverse of :func:`pack_signs`."""
    return unpack_bits(packed.reshape(1, -1))[0, :n]


def quantize_bucket(buf, err):
    """1-D float32 bucket (len % ROW*32 == 0) and its ``[R, ROW]``
    residual -> (packed int32 [R, ROW/32], scale [R, 1], new_err [R,
    ROW])."""
    return onebit_quantize(buf.reshape(-1, ROW), err)


def dequantize_bucket(packed, scale, n: int):
    """(packed, scale) of :func:`quantize_bucket` -> the first ``n``
    elements of the ``+-scale`` bucket."""
    return onebit_dequantize(packed, scale).reshape(-1)[:n]


def make_plan(grads_specs, dp_degree: int) -> fusion.FusionPlan:
    """Fusion plan whose buckets are divisible by both the dp degree and
    the [R, 1024] quantization view (32 MB buckets)."""
    pad = math.lcm(max(dp_degree, 1), ROW * 32)
    return fusion.make_plan(grads_specs, cap_bytes=32 << 20, pad_to=pad)


def init_error_state(plan: fusion.FusionPlan, device="cpu"):
    """Zero residual ``[R, ROW]`` float32 per bucket, on ``device``."""
    return [torch.zeros((b.size // ROW, ROW), dtype=torch.float32,
                        device=device) for b in plan.buckets]


def global_bucket(leaves: list, plan, i: int, specs: list, mesh,
                  rules) -> torch.Tensor:
    """Bucket ``i`` of ``plan`` (the reference's global buckets) packed
    in float32 from this rank's gradient ``leaves`` (its blocks on a model
    axis): the bucket's split leaves are gathered over the model group
    first (a collective: every model rank calls it), one leaf at a time,
    and let go once packed.  ``specs`` are the global leaves'
    ``ParamSpec``s, flat."""
    src = list(leaves)
    for e in plan.buckets[i].entries:
        for m in plan.members[e.index]:
            src[m] = gather_leaf(leaves[m].float(), specs[m], mesh, rules)
    return fusion.pack_bucket(src, plan, i).float()


def bucket_blocks(out: list, buf: torch.Tensor, plan, i: int, specs: list,
                  mesh, rules) -> None:
    """This rank's blocks of the leaves of global bucket ``i`` (``buf``,
    1-D), copied out into ``out`` by flat leaf index (the inverse of
    ``global_bucket``)."""
    got = fusion.unpack_bucket(buf, plan, i)
    for e in plan.buckets[i].entries:
        for m in plan.members[e.index]:
            out[m] = shard_leaf(got[m], specs[m], mesh, rules).clone()


def exchange_onebit(grads, err_state, mesh, plan, *, on_bucket=None,
                    specs=None, rules=None):
    """The 1-bit exchange with error feedback over a mesh's dp group.

    Per bucket of ``plan``: this rank's float32 gradient bucket and its
    residual go through K3a (``quantize_bucket``); the packed sign words
    and the scales of every rank are all-gathered; every origin's payload
    is decoded by K3b (``onebit_dequantize``, one launch an origin); and
    the decoded rows are averaged in float32 in origin order (summed,
    then divided by the dp size), the reference's ``jnp.mean(deq,
    axis=0)``.  Wire per bucket and rank: ``size / 8`` bytes of signs and
    ``size / 256`` bytes of scales, against ``4 * size`` uncompressed.

    Args:
        grads: this rank's gradient tree (the port's layout).
        err_state: this rank's residual, one ``[R, ROW]`` float32 tensor a
            bucket (rows ``[r R, (r + 1) R)`` of the reference's global
            ``[ndp R, ROW]``).
        mesh: the ``launch.mesh.Mesh``.
        plan: ``make_plan(f32 specs, ndp)`` (the global specs).
        specs, rules: on a model axis > 1, the global ``ParamSpec`` tree
            and the tiling rules of this rank's blocks: the split leaves
            a bucket holds are gathered over the model group before it
            is packed, and this rank's blocks cut from its mean.
        on_bucket: called as ``on_bucket(i, packed, scales, mean, own)``
            with bucket ``i``'s gathered ``[ndp, R, ROW / 32]`` words,
            ``[ndp, R, 1]`` scales, the 1-D mean and ``own``: this rank's
            1-D float32 bucket, the residual it read and the residual it
            returns (a test and measurement seam).
    Returns:
        ``(mean gradient tree, new residuals)``; the tree's leaves are
        views into the mean buckets (this rank's blocks of them, copied
        out, on a model axis).
    """
    leaves = pytree.tree_leaves(grads)
    split = specs is not None and mesh.model_size > 1
    sp = pytree.tree_leaves(specs, is_leaf=is_spec) if split else None
    outs, new_err = [], []
    mine = [None] * len(leaves)
    for i, err in enumerate(err_state):
        buf = global_bucket(leaves, plan, i, sp, mesh, rules) if split \
            else fusion.pack_bucket(leaves, plan, i).float()
        packed, scale, err2 = quantize_bucket(buf, err)
        if on_bucket is None:
            buf = None            # past here only the seam reads it
        all_packed = collectives.all_gather(packed, mesh, tiled=False)
        all_scale = collectives.all_gather(scale, mesh, tiled=False)
        ndp = all_packed.shape[0]
        acc = onebit_dequantize(all_packed[0], all_scale[0])
        for o in range(1, ndp):               # fixed origin order
            acc.add_(onebit_dequantize(all_packed[o], all_scale[o]))
        mean = acc.div_(ndp).reshape(-1)
        if on_bucket is not None:
            on_bucket(i, all_packed, all_scale, mean, (buf, err, err2))
        del buf
        if not split:
            new_err.append(err2)
            outs.append(mean)
            continue
        # a global bucket's residual on every rank: updated in place, as
        # two of them do not fit four ranks' state on one card
        new_err.append(err.copy_(err2))
        del err2
        bucket_blocks(mine, mean, plan, i, sp, mesh, rules)
        del mean
    if split:
        return pytree.tree_unflatten(mine, plan.treespec), new_err
    return fusion.unpack(outs, plan), new_err
