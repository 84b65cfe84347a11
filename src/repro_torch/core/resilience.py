"""Software resilience: replay / replicate+consensus / checksums (paper R9).

Counterpart: ``repro/core/resilience.py`` (``tree_checksum``,
``finite_check``, ``ResilienceError``, ``ResilientRunner``,
``StragglerPolicy``).  HPX's model for silent data corruption: after a
suspect computation, *replay* it and keep the result once it validates,
or run *replicates* and pick by checksum majority, a consensus function,
or the validate function.  Tests inject faults through ``fault_hook``.
``DistributedGraph.replicate`` votes on its replicas by ``tree_checksum``.

Inside a mesh of rank processes every verdict is agreed over the whole
world, the dp group and then the model group (``ResilientRunner(mesh=
...)``): a replay happens on every rank
when any rank's result fails to validate, and a replicate keeps the
first replica that is good on every rank, so that no rank replays alone
and the collectives of the next attempt stay in step.

The digest is the reference's: blake2b (16 bytes) over each leaf's dtype
string, shape string and raw bytes, leaves in JAX's order (dict keys
sorted), so equal float32 trees hash equal in both packages.  Tensors
hash as their host numpy view; a bfloat16 tensor as its raw 16-bit
words under the dtype string ``bfloat16``, as JAX's numpy view of one.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..distrib.agas import tree_leaves

__all__ = ["ResilienceError", "ResilientRunner", "StragglerPolicy",
           "finite_check", "tree_checksum"]


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


def finite_check(tree) -> bool:
    """Validity predicate: every floating leaf is finite."""
    ok = True
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            ok = ok and bool(torch.isfinite(leaf).all())
        elif isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f":
            ok = ok and bool(np.isfinite(leaf).all())
    return ok


class ResilienceError(RuntimeError):
    pass


def _agree(flags: list, mesh) -> list:
    """``flags`` (bools) and-ed over every rank of ``mesh``: its dp
    group, then its model group."""
    if mesh is None or mesh.dp_size * mesh.model_size == 1:
        return list(flags)
    from . import collectives
    t = -torch.tensor([1.0 if f else 0.0 for f in flags])
    for axis in collectives.AXES:
        t = collectives.all_reduce(t, mesh, "max", mesh_axis=axis)
    return [bool(x) for x in -t > 0.5]


@dataclasses.dataclass
class ResilientRunner:
    """Wrap a (pure) step function with HPX-style resilience semantics.

    validate: result -> bool         (reject corrupt results, default finite)
    consensus: [results] -> result   (pick among replicates; default checksum
                                      majority, ties broken by validate)
    fault_hook: result -> result     (test seam to inject corruption)
    mesh: the rank's ``launch.mesh.Mesh``; verdicts are agreed over it
    """

    fn: Callable
    validate: Callable[[Any], bool] = finite_check
    consensus: Optional[Callable[[Sequence[Any]], Any]] = None
    fault_hook: Optional[Callable[[Any], Any]] = None
    mesh: Any = None
    stats: dict = dataclasses.field(
        default_factory=lambda: {"replays": 0, "replicas": 0, "rejected": 0})

    def _run_once(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.fault_hook is not None:
            out = self.fault_hook(out)
        return out

    def replay(self, *args, max_retries: int = 3, **kwargs):
        """HPX task replay: rerun until the result validates (on every
        rank of the mesh)."""
        for _ in range(max_retries + 1):
            out = self._run_once(*args, **kwargs)
            if _agree([self.validate(out)], self.mesh)[0]:
                return out
            self.stats["replays"] += 1
            self.stats["rejected"] += 1
        raise ResilienceError(
            f"replay failed after {max_retries + 1} attempts")

    def replicate(self, *args, n: int = 3, **kwargs):
        """HPX task replication with checksum/consensus/validate
        selection: the first replica of the checksum majority when there
        is one (two or more equal), else the first that validates."""
        results = [self._run_once(*args, **kwargs) for _ in range(n)]
        self.stats["replicas"] += n
        if self.consensus is not None:
            return self.consensus(results)
        sums = [tree_checksum(r) for r in results]
        counts: dict[str, int] = {}
        for s in sums:
            counts[s] = counts.get(s, 0) + 1
        best, votes = max(counts.items(), key=lambda kv: kv[1])
        good = [s == best for s in sums] if votes > 1 \
            else [self.validate(r) for r in results]
        for r, ok in zip(results, _agree(good, self.mesh)):
            if ok:
                return r
        raise ResilienceError("no replicate passed validation")


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Synchronous updates + asynchronous collectives (the paper's
    position, R7) plus bounded local accumulation as an explicit escape
    hatch: ``accumulate_local_steps > 1`` skips the gradient collective
    for k-1 steps and reduces the accumulated gradient on step k."""
    accumulate_local_steps: int = 1
    backup_worker_fraction: float = 0.0

    def sync_this_step(self, step: int) -> bool:
        return (step + 1) % self.accumulate_local_steps == 0
