"""Checkpoint I/O: locality-owned shards as futurized tasks.

Counterpart: ``repro/checkpoint/checkpoint.py`` (``_prepare_tmp``,
``_prepare_tmp_spmd``, and ``CheckpointManager``: ``ranks``,
``_defer_on``, ``save``, ``_save_spmd``, ``_commit``,
``_raise_if_failed``, ``aborted_saves``, ``wait``, ``close``, ``_gc``,
``all_steps``, ``latest_step``, ``restore``, ``_read_shards`` and
``meta``).  The byte-level format is
``format.py``, the reference's own, so a checkpoint written by either
package restores in the other.  A save splits the snapshot into one
shard per locality (``format.assign_shards`` over ``ranks()``: the
driver, and with a ``dgraph`` every alive worker); each shard is written
by the locality that owns it, as a ``Lane.CHECKPOINT`` task placed there
(``DistributedGraph.defer(locality=...)``), behind a ``_prepare_tmp``
gate chained on the caller's ``deps`` (step retirement) and the previous
save; the driver commits the manifest once every shard entry resolved.
A save that cannot complete never commits its manifest, so the previous
checkpoint stays latest.  A shard task whose owner dies re-spawns on a
survivor or the driver (it is idempotent), and the manifest records the
actual writer.  A restore reads the shards on the localities it has
now, spread round-robin, which need not be the writers: a checkpoint
written by N localities restores into M.

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
step.  On CUDA the synchronous device-to-host copy is that copy.  Only
those numpy copies cross the wire to a shard's owner, and the bytes are
counted (``DistributedGraph.ckpt_leaf_wire_bytes``).

SPMD mode (a ``torch.distributed`` world of more than one process,
``spmd.is_multiprocess``; DESIGN.md §10): this process, the driver (rank
0), writes only its own segments (``spmd.collect_segments``: a leaf whose
leading dim divides by the world size is split by rows, any other leaf is
process 0's), and every other process writes its own from inside its
shadow train loop (``frontend/spmd.py``) and posts back just the manifest
ENTRY, which resolves a ``DistributedGraph.spmd_entry_futures`` promise
here.  No leaf bytes cross the messaging layer either way
(``ckpt_leaf_wire_bytes`` stays 0); the driver still assembles and
atomically commits the manifest.  A writer lost mid-save is
unrecoverable (nobody else holds its bytes), so that save aborts, never
commits, and is counted in ``aborted_saves``; the previous checkpoint
stays latest.  Restores read every shard on the caller
(``format.assemble_leaf`` re-joins the segments, whatever the process
count that wrote them).

A mesh run's world (``Plan(data=...)``) is not SPMD mode: its ranks'
states differ (zero1 and onebit shard theirs), so rank 0 saves the state
gathered into the reference's global layout alone, and each rank restores
the whole checkpoint and cuts its own shard.  Its manager passes
``spmd=False``.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Optional

from ..bridge import host_leaves, leaf_names, place_leaves
from ..core.futures import FuturizedGraph, Lane, PhyFuture
from ..distrib.runtime import LocalityLostError
from . import format as fmt
from . import spmd
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


def _prepare_tmp_spmd(tmp: str, *_deps):
    """The SPMD save gate: the same edge collapse, but NO wipe - the other
    processes' shadow loops may already have streamed their shard files
    into the temp dir before the driver's gate runs (they pace
    themselves, not the driver).  Stale files of an aborted earlier
    attempt are pruned at commit instead: ``format.commit_manifest``
    deletes everything the manifest does not reference."""
    Path(tmp).mkdir(parents=True, exist_ok=True)
    return None


class CheckpointManager:
    """Schedules checkpoint saves and restores over the futurized runtime.

    When ``graph`` is given (``Session.train`` passes its runtime), the
    save nodes ride that graph and ``close()`` only drains pending writes;
    otherwise a private graph is made and shut down on ``close()``.  A
    context manager either way.

    Args:
        directory: checkpoint root; one ``step_XXXXXXXX`` dir per save,
            shared by every locality (one filesystem).
        keep: committed checkpoints retained (older ones are removed).
        async_save: write as graph nodes (False writes every shard on the
            caller).
        graph: the ``FuturizedGraph`` the save nodes ride.
        dgraph: a ``distrib.DistributedGraph``: shard writes are placed
            on their owning localities and restores spread their shard
            reads over the current localities.  Its local graph must be
            ``graph`` (futures cannot span graphs).
        spmd: take the SPMD save path; None (the default) takes it in a
            ``torch.distributed`` world of more than one process
            (``spmd.is_multiprocess``), False never.
        spmd_world: the SPMD save's process count, where it is not the
            ``torch.distributed`` world's (SPMD mode with mesh axes: one
            process a locality, each locality a world of its mesh's
            ranks); this manager writes process 0's segments.
    Raises:
        ValueError: ``graph`` and ``dgraph.graph`` differ.
    """

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True,
                 graph: Optional[FuturizedGraph] = None,
                 dgraph: Optional[Any] = None,
                 spmd: Optional[bool] = None,
                 spmd_world: Optional[int] = None):
        self._spmd = spmd
        self._spmd_world = spmd_world
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._dgraph = dgraph
        if dgraph is not None:
            if graph is not None and graph is not dgraph.graph:
                raise ValueError(
                    "graph and dgraph.graph must be the same "
                    "FuturizedGraph - distributed shard futures cannot "
                    "span graphs")
            self._own_graph = False
            self._graph = dgraph.graph
        else:
            self._own_graph = graph is None
            self._graph = graph if graph is not None else FuturizedGraph(
                max_workers=2, name="checkpoint")
        self._pending: Optional[PhyFuture] = None
        self._pending_step: Optional[int] = None
        self.aborted_saves = 0          # SPMD saves lost with a writer

    def _is_spmd(self) -> bool:
        return spmd.is_multiprocess() if self._spmd is None else self._spmd

    # -- placement ------------------------------------------------------------
    def ranks(self) -> list[int]:
        """Locality ranks owning a shard of the next save: the driver and
        every alive worker (``[0]`` without a distributed graph)."""
        if self._dgraph is None:
            return [0]
        return [0] + self._dgraph.group.alive_workers()

    def _defer_on(self, rank: int, fn, *args, name: str, **kwargs):
        """One CHECKPOINT-lane task on ``rank`` (on this graph without a
        distributed graph); on the driver if ``rank`` died between
        ``ranks()`` and this call."""
        if self._dgraph is None:
            return self._graph.defer(fn, *args, lane=Lane.CHECKPOINT,
                                     name=name, **kwargs)
        try:
            return self._dgraph.defer(fn, *args, lane=Lane.CHECKPOINT,
                                      name=name, locality=rank,
                                      idempotent=True, **kwargs)
        except ValueError:            # rank died since ranks(): retarget
            return self._dgraph.defer(fn, *args, lane=Lane.CHECKPOINT,
                                      name=name, locality=0,
                                      idempotent=True, **kwargs)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, meta: Optional[dict] = None,
             deps: tuple = ()):
        """Snapshot a port tree (``bridge.host_leaves``' layout) as
        locality-owned shards.

        The host copies are taken now, on the caller; the tree is split
        into one shard per locality of ``ranks()``, each written by its
        owner as a ``Lane.CHECKPOINT`` task gated on ``deps`` (e.g. the
        step's retirement) and on the previous save, and the manifest is
        committed after every shard resolved.  Fails fast: a previous
        async save that finished with an error raises here, except an
        SPMD save aborted because its writer died (``LocalityLostError``),
        which is expected under host loss: it never committed, the
        previous checkpoint stays latest, so it is counted
        (``aborted_saves``) and warned about.

        In SPMD mode (``spmd.is_multiprocess()``) each process writes its
        own segments: see the module docstring.  ``async_save=False`` is
        unsupported there (a synchronous save cannot await the other
        processes' entries).

        Args:
            step: step number the snapshot belongs to.
            tree: the tree to snapshot.
            meta: free-form metadata stored in the manifest.
            deps: futures the shard writes must wait for.
        Returns:
            The manifest-commit ``PhyFuture`` (resolving to the committed
            directory) when async; the committed ``Path`` when sync.
        Raises:
            ValueError: a leaf numpy cannot hold (bfloat16), named.
            RuntimeError: an SPMD save with ``async_save=False``, on a
                process other than the driver, or without a ``dgraph``.
        """
        self._raise_if_failed()
        if self._is_spmd():
            return self._save_spmd(step, tree, meta=meta, deps=deps)
        names, host = host_leaves(tree)
        treedef_str = f"repro_torch.bridge.host_leaves: {names}"
        shards = fmt.assign_shards(len(host), self.ranks())
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
        entry_futs = []
        for sid, rank, idx in shards:
            if rank != 0:
                # the owner gets its leaf bytes in the spawn payload
                self._dgraph.account_ckpt_leaf_bytes(
                    sum(host[i].nbytes for i in idx))
            entry_futs.append(
                self._defer_on(rank, fmt.save_shard, str(tmp), sid,
                               list(idx), [host[i] for i in idx], gate,
                               name=f"ckpt:shard{sid}:{step}"))
        self._pending = self._graph.defer(
            self._commit, step, treedef_str, len(host), meta,
            str(tmp), str(final), *entry_futs,
            lane=Lane.CHECKPOINT, name=f"ckpt:manifest:{step}")
        self._pending_step = step
        return self._pending

    # -- SPMD save (each process its own segments; DESIGN.md §10) ------------
    def _save_spmd(self, step: int, tree: Any, *, meta, deps) -> PhyFuture:
        if not self.async_save:
            raise RuntimeError(
                "async_save=False is unsupported in SPMD mode: a "
                "synchronous save cannot await the other processes' "
                "shard entries")
        world, rank = (self._spmd_world, 0) if self._spmd_world \
            else spmd.world_rank()
        if rank != 0:
            raise RuntimeError(
                "CheckpointManager.save drives SPMD saves from process 0 "
                "(the driver); other processes write their shards via "
                "checkpoint.spmd.write_spmd_shard (frontend.spmd shadow "
                "loop)")
        if self._dgraph is None:
            raise RuntimeError(
                "SPMD save needs a DistributedGraph to receive the other "
                "processes' shard entries (Session passes it; pass "
                "dgraph= for standalone use)")
        names = leaf_names(tree)
        # this process's segments, copied now: the next step updates the
        # state in place
        indices, slices, arrays = spmd.collect_segments(tree, world, rank)
        tmp = self.dir / f".tmp_step_{step:08d}"
        final = self.dir / f"step_{step:08d}"
        order = deps if self._pending is None else (*deps, self._pending)
        gate = self._graph.defer(_prepare_tmp_spmd, str(tmp), *order,
                                 lane=Lane.CHECKPOINT,
                                 name=f"ckpt:gate:{step}")
        # the driver's own shard: a local node - nothing ships anywhere
        mine = self._graph.defer(fmt.save_shard, str(tmp), rank,
                                 indices, arrays, gate, slices=slices,
                                 lane=Lane.CHECKPOINT,
                                 name=f"ckpt:shard{rank}:{step}")
        others = self._dgraph.spmd_entry_futures(
            step, [r for r in range(world) if r != rank])
        self._pending = self._graph.defer(
            self._commit, step, f"repro_torch.bridge.host_leaves: {names}",
            len(names), meta, str(tmp), str(final), mine, *others,
            lane=Lane.CHECKPOINT, name=f"ckpt:manifest:{step}")
        self._pending_step = step
        return self._pending

    def _commit(self, step, treedef_str, n_leaves, meta, tmp, final,
                *entries) -> Path:
        # a process that writes no block of any leaf contributes no shard
        entries = [e for e in entries if e is not None]
        manifest = fmt.build_manifest(step=step, treedef=treedef_str,
                                      n_leaves=n_leaves,
                                      shards=list(entries), meta=meta)
        out = fmt.commit_manifest(Path(tmp), Path(final), manifest)
        self._gc()
        return out

    def _raise_if_failed(self):
        """Surface a finished-failed pending save.  A LocalityLostError in
        SPMD mode means a writer died holding bytes nobody else has: the
        save aborted atomically (no manifest), which is survivable - warn
        and count it instead of killing the run."""
        if self._pending is None or not self._pending.done():
            return
        failed, self._pending = self._pending, None
        step, self._pending_step = self._pending_step, None
        exc = failed.exception()
        if exc is None:
            return
        if isinstance(exc, LocalityLostError) and self._is_spmd():
            self.aborted_saves += 1
            if step is not None:
                # reclaim the aborted attempt's temp dir now: _gc only
                # prunes temp dirs a LATER commit supersedes, and with a
                # writer gone for good there may never be one
                shutil.rmtree(self.dir / f".tmp_step_{step:08d}",
                              ignore_errors=True)
            print(f"[ckpt] WARNING: SPMD save aborted, previous "
                  f"checkpoint stays latest: {exc}", flush=True)
            return
        raise exc

    def wait(self):
        """Barrier: block until every pending save has committed (or, in
        SPMD mode, aborted with its lost writer - see ``save``); raises
        the error of one that failed."""
        if self._pending is not None:
            try:
                self._pending.result()
                self._pending = None
                self._pending_step = None
            except LocalityLostError:
                self._raise_if_failed()

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
        the ``like`` leaf it replaces.  The shards are read by the CURRENT
        localities (spread round-robin over the driver and the alive
        workers), which need not be the writers.  A sliced (SPMD)
        checkpoint's segments are re-joined per leaf
        (``format.assemble_leaf``).

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
        ranks = self.ranks()
        # SPMD mode reads locally: every process runs its own shadow loop
        # (each restores its own copy), and shipping segment bytes back
        # over the wire is what the mode exists to avoid
        if len(ranks) == 1 or self._is_spmd():
            return [fmt.read_shard_segments(str(d), e, verify=verify)
                    for e in entries]
        futs = [self._defer_on(ranks[i % len(ranks)],
                               fmt.read_shard_segments,
                               str(d), e, verify=verify,
                               name=f"ckpt:load:{e['file']}")
                for i, e in enumerate(entries)]
        return [f.result() for f in futs]

    @property
    def meta(self) -> dict:
        step = self.latest_step()
        if step is None:
            return {}
        return fmt.load_manifest(self.dir / f"step_{step:08d}").get(
            "meta", {})
