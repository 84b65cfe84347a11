"""Checkpoint I/O: shard writes and the manifest commit as futurized tasks.

Counterpart: ``repro/checkpoint/checkpoint.py`` (``CheckpointManager``
for one locality: ``save``, ``_commit``, ``_raise_if_failed``, ``wait``,
``close``, ``_gc``, ``all_steps``, ``latest_step``, ``restore``,
``_read_shards`` and ``meta``).  The byte-level format is ``format.py``,
the reference's own, so a checkpoint written by either package restores
in the other.  Every save is one shard on this locality: a
``_prepare_tmp`` gate, one ``save_shard`` write and the manifest commit,
each a ``Lane.CHECKPOINT`` node of the futurized runtime, chained behind
the caller's ``deps`` (step retirement) and the previous save.  A save
that cannot complete never commits its manifest, so the previous
checkpoint stays latest.

The leaves are those of the JAX layout, in ``jax.tree.flatten``'s order
(``bridge.host_leaves``): each list level of a port tree (its per-layer
lists) becomes a leading dim of the leaves below it, dict keys are
visited sorted and tuples in order.  So ``(params, opt)`` flattens to the
reference's ``n_leaves`` leaves, leaf ``i`` of one package is leaf ``i``
of the other, and the shard files are byte for byte the same.  Each leaf
keeps its own dtype (the optimizer's int32 ``count``; a bfloat16 leaf,
which numpy cannot hold, raises ``ValueError``).  The manifest's
``treedef`` is the port's own string, the leaves' paths in that order:
the reference writes ``str(treedef)`` of a JAX tree there, and neither
package's restore parses it (both check ``n_leaves`` only).

The save's host copies are owned copies taken on the caller before
``save`` returns: the port's optimizer updates the parameters and its
state in place, so a write that read the live tensors would race the next
step.  On CUDA the synchronous device-to-host copy is that copy.

Multi-locality placement (``dgraph=``, ROADMAP item 12) and the SPMD
addressable-shard save (``checkpoint/spmd.py``, item 13) are not ported:
``dgraph`` raises ``NotImplementedError``.  Reading a sliced (SPMD)
checkpoint works: ``format.assemble_leaf`` re-joins its segments.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Optional

from ..bridge import host_leaves, leaf_names, place_leaves
from ..core.futures import FuturizedGraph, Lane, PhyFuture
from . import format as fmt
from .format import CheckpointCorruptError

__all__ = ["CheckpointCorruptError", "CheckpointManager"]


def _prepare_tmp(tmp: str, *_deps):
    """Dependency gate + clean slate: collapses the (step retirement,
    previous save) edges into one node and wipes a stale temp dir left by
    an aborted earlier attempt of the same step, so its files can never
    leak into this save's commit."""
    p = Path(tmp)
    if p.exists():
        shutil.rmtree(p)
    p.mkdir(parents=True)
    return None


class CheckpointManager:
    """Schedules checkpoint saves and restores over the futurized runtime.

    When ``graph`` is given (``Session.train`` passes its runtime), the
    save nodes ride that graph and ``close()`` only drains pending writes;
    otherwise a private graph is made and shut down on ``close()``.  A
    context manager either way.

    Args:
        directory: checkpoint root; one ``step_XXXXXXXX`` dir per save.
        keep: committed checkpoints retained (older ones are removed).
        async_save: write as graph nodes (False writes on the caller).
        graph: the ``FuturizedGraph`` the save nodes ride.
        dgraph: the multi-locality graph of the reference; not ported.
    Raises:
        NotImplementedError: ``dgraph`` is given (ROADMAP item 12).
    """

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True,
                 graph: Optional[FuturizedGraph] = None,
                 dgraph: Optional[Any] = None):
        if dgraph is not None:
            raise NotImplementedError(
                "CheckpointManager(dgraph=...): shards placed on worker "
                "localities need the multi-locality runtime, ROADMAP "
                "item 12")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._own_graph = graph is None
        self._graph = graph if graph is not None else FuturizedGraph(
            max_workers=2, name="checkpoint")
        self._pending: Optional[PhyFuture] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, meta: Optional[dict] = None,
             deps: tuple = ()):
        """Snapshot a port tree (``bridge.host_leaves``' layout).

        The host copies are taken now, on the caller; the write is a
        ``Lane.CHECKPOINT`` node gated on ``deps`` (e.g. the step's
        retirement) and on the previous save, and the manifest is
        committed after it.  Fails fast: a previous async save that
        finished with an error raises here.

        Args:
            step: step number the snapshot belongs to.
            tree: the tree to snapshot.
            meta: free-form metadata stored in the manifest.
            deps: futures the shard write must wait for.
        Returns:
            The manifest-commit ``PhyFuture`` (resolving to the committed
            directory) when async; the committed ``Path`` when sync.
        Raises:
            ValueError: a leaf numpy cannot hold (bfloat16), named.
        """
        self._raise_if_failed()
        names, host = host_leaves(tree)
        treedef_str = f"repro_torch.bridge.host_leaves: {names}"
        shards = fmt.assign_shards(len(host), [0])     # the driver's
        tmp = self.dir / f".tmp_step_{step:08d}"
        final = self.dir / f"step_{step:08d}"

        if not self.async_save:
            for d in deps:
                d.result()
            _prepare_tmp(str(tmp))
            entries = [fmt.save_shard(str(tmp), sid, idx,
                                      [host[i] for i in idx])
                       for sid, _rank, idx in shards]
            return self._commit(step, treedef_str, len(host), meta,
                                str(tmp), str(final), *entries)

        order = deps if self._pending is None else (*deps, self._pending)
        gate = self._graph.defer(_prepare_tmp, str(tmp), *order,
                                 lane=Lane.CHECKPOINT,
                                 name=f"ckpt:gate:{step}")
        entry_futs = [
            self._graph.defer(fmt.save_shard, str(tmp), sid, list(idx),
                              [host[i] for i in idx], gate,
                              lane=Lane.CHECKPOINT,
                              name=f"ckpt:shard{sid}:{step}")
            for sid, _rank, idx in shards]
        self._pending = self._graph.defer(
            self._commit, step, treedef_str, len(host), meta,
            str(tmp), str(final), *entry_futs,
            lane=Lane.CHECKPOINT, name=f"ckpt:manifest:{step}")
        return self._pending

    def _commit(self, step, treedef_str, n_leaves, meta, tmp, final,
                *entries) -> Path:
        manifest = fmt.build_manifest(step=step, treedef=treedef_str,
                                      n_leaves=n_leaves,
                                      shards=list(entries), meta=meta)
        out = fmt.commit_manifest(Path(tmp), Path(final), manifest)
        self._gc()
        return out

    def _raise_if_failed(self):
        """Surface a finished-failed pending save."""
        if self._pending is None or not self._pending.done():
            return
        failed, self._pending = self._pending, None
        exc = failed.exception()
        if exc is not None:
            raise exc

    def wait(self):
        """Barrier: block until every pending save has committed (raises
        the error of one that failed)."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        """Shutdown barrier: drain pending saves; stop the workers if the
        graph is this manager's own."""
        try:
            self.wait()
        finally:
            if self._own_graph:
                self._graph.shutdown(wait=True)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc):
        self.close()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
        latest = steps[-1] if steps else None
        # temp dirs of aborted or superseded saves are garbage once a
        # same-or-later step has committed
        for p in self.dir.glob(".tmp_step_*"):
            try:
                s = int(p.name.rsplit("_", 1)[1])
            except ValueError:
                continue
            if latest is not None and s <= latest:
                shutil.rmtree(p, ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: Optional[int] = None,
                strict_checksums: bool = True):
        """Load a tree with the structure of ``like``: leaf ``i`` of the
        manifest becomes the ``like`` leaves it stacks (``bridge.
        place_leaves``), each in the checkpoint's dtype on the device of
        the ``like`` leaf it replaces.  A sliced (SPMD) checkpoint's
        segments are re-joined per leaf (``format.assemble_leaf``).

        Args:
            like: tree giving the structure (and leaf count) expected.
            step: step to load; latest when None.
            strict_checksums: verify per-leaf + per-shard checksums.
        Returns:
            ``(step, tree)``.
        Raises:
            FileNotFoundError: no checkpoint under the directory.
            ValueError: leaf count (or a leaf's shape) does not match
                ``like``.
            CheckpointCorruptError: a shard is missing, truncated, or
                fails checksum verification (the message names it).
        """
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = fmt.load_manifest(d)
        n_like = len(leaf_names(like))
        if manifest["n_leaves"] != n_like:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, "
                f"expected {n_like}")
        parts: dict[int, list] = {}
        for segs in self._read_shards(d, manifest["shards"],
                                      strict_checksums):
            for seg in segs:
                parts.setdefault(seg["index"], []).append(seg)
        missing = [i for i in range(n_like) if i not in parts]
        if missing:
            raise CheckpointCorruptError(
                f"{d}: leaves {missing} missing from every shard")
        arrays = [fmt.assemble_leaf(i, parts[i]) for i in range(n_like)]
        return step, place_leaves(like, arrays)

    def _read_shards(self, d: Path, entries: list, verify: bool) -> list:
        return [fmt.read_shard_segments(str(d), e, verify=verify)
                for e in entries]

    @property
    def meta(self) -> dict:
        step = self.latest_step()
        if step is None:
            return {}
        return fmt.load_manifest(self.dir / f"step_{step:08d}").get(
            "meta", {})
