"""Software resilience: the content checksum of a tree of arrays.

Counterpart: ``repro/core/resilience.py:33`` (``tree_checksum``), the
one part the multi-locality runtime needs: ``DistributedGraph.replicate``
votes on its replicas' results by this checksum.  The rest of the module
(``finite_check``, replay and replicate of a step, ``ResilientRunner``)
is ROADMAP item 14.

The digest is the reference's: blake2b (16 bytes) over each leaf's dtype
string, shape string and raw bytes, leaves in JAX's order (dict keys
sorted), so equal float32 trees hash equal in both packages.  Tensors
hash as their host numpy view; a bfloat16 tensor as its raw 16-bit
words under the dtype string ``bfloat16``, as JAX's numpy view of one.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..distrib.agas import tree_leaves

__all__ = ["tree_checksum"]


def _host(leaf) -> tuple[str, tuple, bytes]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy() \
                .tobytes()
        leaf = t.numpy()
    a = np.asarray(leaf)
    return str(a.dtype), a.shape, a.tobytes()


def tree_checksum(tree) -> str:
    """Deterministic content hash of a tree of arrays (bitwise)."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in tree_leaves(tree):
        dtype, shape, data = _host(leaf)
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(data)
    return h.hexdigest()
