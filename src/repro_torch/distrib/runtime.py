"""Multi-locality scheduling: ``Locality`` workers + ``DistributedGraph``.

Counterpart: ``repro/distrib/runtime.py`` (``RemoteTaskError``,
``LocalityLostError``, ``Locality``, ``worker_main``, ``LocalityGroup``,
``DistributedGraph``, ``_LocalCall``, ``_checksum_vote``).  The
reference uses JAX only to walk argument trees and to stand up
``jax.distributed`` for SPMD mode; the port walks trees itself
(``agas.tree_leaves``/``tree_map``) and has no SPMD mode.  Elastic
membership (``join_locality``, ``DistributedGraph.add_locality`` and
``rebalance``, work stealing) and the SPMD handlers are ROADMAP item 13
and raise ``NotImplementedError``; the runtime sanitizer's hooks are left
out with them.

A *locality* is one Python process with its own ``FuturizedGraph``; the
driver (rank 0) holds a ``DistributedGraph`` whose ``defer`` mirrors the
local one but may place the task on any locality (DESIGN.md §9):

  * **Placement = lane + data affinity.**  Explicit ``locality=`` wins;
    otherwise tasks whose arguments hold remote futures / ``RemoteRef``s
    go to the majority owner, and everything else round-robins over the
    worker localities per lane.
  * **Futures span the wire.**  ``defer`` returns an ordinary
    ``PhyFuture`` (a promise node of the driver's graph); a dispatch node
    waits for the task's local dependency edges, then ships ``(fn,
    resolved args)`` in a ``spawn`` active message.  The worker defers it
    onto its own graph and streams the result back in a ``task_done``
    post.  Errors come back as the original exception and poison exactly
    the transitive dependents; cancellation crosses the wire.
  * **Failure model: re-create, not migrate.**  When a worker dies, its
    in-flight idempotent tasks are re-spawned on a surviving locality (or
    run on the driver when none is left); tasks holding refs owned by the
    dead locality are poisoned with ``LocalityLostError`` instead.

Task functions must be picklable (module-level functions or bound methods
of picklable objects); closures fail with a clear error at dispatch.  No
CUDA tensor crosses the wire: workers build host values (numpy), and each
locality does its own device work on the device of the plan it is given.
Worker processes are spawned (``multiprocessing`` "spawn"), never forked,
so no child inherits a CUDA context.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import multiprocessing as mp
import os
import pickle
import threading
import time
from concurrent.futures import CancelledError
from typing import Any, Callable, Optional

from ..core.futures import FuturizedGraph, Lane, PhyFuture
from .agas import ObjectDirectory, RemoteRef, tree_leaves, tree_map
from .collectives import RingAllReduce
from .messaging import Endpoint, PeerLostError

__all__ = ["DistributedGraph", "Locality", "LocalityGroup",
           "LocalityLostError", "RemoteTaskError", "join_locality",
           "worker_main"]

_ELASTIC = "elastic membership and work stealing: ROADMAP item 13"
_SPMD = "SPMD mode: ROADMAP item 13"


class RemoteTaskError(RuntimeError):
    """A remote task failed and its exception could not be shipped back
    verbatim (unpicklable); carries the remote repr instead."""


class LocalityLostError(RuntimeError):
    """A task (or data it needed) was lost with its locality and could
    not be re-created elsewhere."""


def _is_ref(x) -> bool:
    return isinstance(x, RemoteRef)


def _deref_tree(argskw, directory: ObjectDirectory):
    """Replace every ``RemoteRef`` leaf with its value (local hit on the
    owner, one AGAS fetch otherwise)."""
    return tree_map(lambda x: directory.fetch(x) if _is_ref(x) else x,
                    argskw, is_leaf=_is_ref)


def _raise_spmd(src, spec):
    raise NotImplementedError(f"spmd_train: {_SPMD}")


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------
class Locality:
    """One worker process of the multi-locality runtime.

    Owns an ``Endpoint`` (active messages), a ``FuturizedGraph`` (local
    lanes + workers), an ``ObjectDirectory`` (this locality's slice of the
    address space) and the gradient ring.  ``serve`` registers the task
    handlers and blocks until a ``shutdown`` message (or loss of the
    driver).

    Args:
        rank: this locality's rank (>= 1 for spawned workers).
        world: total locality count, driver included.
        max_workers: local graph worker threads.
    """

    def __init__(self, rank: int, world: int, *, max_workers: int = 2):
        self.rank = rank
        self.world = world
        self.endpoint = Endpoint(rank)
        self.graph = FuturizedGraph(max_workers=max_workers,
                                    name=f"locality{rank}")
        self.directory = ObjectDirectory(rank, self.endpoint)
        self._tasks: dict[str, PhyFuture] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        ep = self.endpoint
        ep.register("spawn", self._on_spawn)
        ep.register("cancel", self._on_cancel)
        ep.register("peers", self._on_peers)
        ep.register("shutdown", lambda src, p: self._stop.set())
        ep.register("ping", lambda src, p: p)
        ep.register("stats", self._on_stats)
        ep.register("spmd_train", _raise_spmd)
        # the ring registers its own "grad_ring" handler: it must exist
        # BEFORE any peer can send (posts to an unregistered action are
        # dropped, never delivered late), so it is born with the locality
        self.grad_ring = RingAllReduce(ep, world)
        ep.register("ddp_train", self._on_ddp_train)
        ep.register("ddp_abort",
                    lambda src, reason: self.grad_ring.abort(reason))
        ep.on_peer_lost = self._on_peer_lost

    # -- handlers ------------------------------------------------------------
    def _on_spawn(self, src: int, p: dict):
        with self._lock:
            if p["tid"] in self._tasks:
                return              # a duplicate spawn of one task: drop it
        node = self.graph.defer(self._run, p["fn"], p["args"], p["kwargs"],
                                lane=Lane(p["lane"]), name=p["name"])
        with self._lock:
            self._tasks[p["tid"]] = node
        node.add_done_callback(
            lambda n, tid=p["tid"], pin=p["pin"], src=src:
            self._report(src, tid, pin, n))

    def _run(self, fn, args, kwargs):
        a, kw = _deref_tree((args, kwargs), self.directory)
        return fn(*a, **kw)

    def _report(self, src: int, tid: str, pin: bool, node: PhyFuture):
        with self._lock:
            self._tasks.pop(tid, None)
        exc = node.exception()
        if exc is None:
            value = node.result()
            if pin:
                value = self.directory.put(value, summary=node.name)
            msg = {"tid": tid, "status": "ok", "value": value}
        elif isinstance(exc, CancelledError):
            msg = {"tid": tid, "status": "cancelled"}
        else:
            msg = {"tid": tid, "status": "error", "exc": exc}
        # post() pickles the message before any bytes hit the socket, so a
        # pickling failure is recoverable: retry with a shippable error
        try:
            self.endpoint.post(src, "task_done", msg)
            return
        except PeerLostError:
            return                  # driver is gone; nobody to tell
        except Exception as e:  # noqa: BLE001 - unshippable value/exc
            msg = {"tid": tid, "status": "error",
                   "exc": RemoteTaskError(
                       f"{node.name}: result not shippable ({e}); "
                       f"pin large/custom values with pin=True")}
        try:
            self.endpoint.post(src, "task_done", msg)
        except PeerLostError:
            pass

    def _on_cancel(self, src: int, tid: str):
        with self._lock:
            node = self._tasks.get(tid)
        if node is not None:
            node.cancel()

    def _on_peers(self, src: int, p: dict):
        book = p["book"] if "book" in p else p
        self.endpoint.address_book.update(
            {int(r): tuple(a) for r, a in book.items()})

    def _on_stats(self, src: int, p) -> dict:
        out = self.graph.stats().to_json()
        out["directory_objects"] = len(self.directory)
        out["directory_audit"] = self.directory.audit()
        out["bytes_sent"] = self.endpoint.bytes_sent
        out["bytes_recv"] = self.endpoint.bytes_recv
        out["unhandled_posts"] = dict(self.endpoint.unhandled_posts)
        return out

    def _on_peer_lost(self, rank: int):
        self.grad_ring.peer_lost(rank)   # abort a blocked all-reduce
        if rank == 0:               # driver died: nothing left to serve
            self._stop.set()

    def _on_ddp_train(self, src: int, spec: dict):
        """Run the fabric-DDP train loop (``frontend.ddp``) on its own
        thread: this locality computes the gradients of its shard block,
        all-reduces them over the ring and applies the identical
        optimizer step.  Completion, with the locality's
        ``grad_wire_bytes``, is reported in a ``ddp_done`` post."""
        def run():
            try:
                from ..frontend.ddp import ddp_shadow_train
                out = ddp_shadow_train(spec, endpoint=self.endpoint,
                                       ring=self.grad_ring)
                msg = dict(out, rank=self.rank, ok=True)
            except BaseException as e:  # noqa: BLE001 - shipped back
                msg = {"rank": self.rank, "ok": False,
                       "grad_wire_bytes": int(self.grad_ring.wire_bytes),
                       "error": f"{type(e).__name__}: {e}"}
            try:
                self.endpoint.post(src, "ddp_done", msg)
            except PeerLostError:
                pass
        threading.Thread(target=run, daemon=True,
                         name=f"ddp-{self.rank}").start()

    # -- lifecycle -----------------------------------------------------------
    def serve(self, driver_addr: tuple[str, int]):
        """Connect to the driver, announce ourselves, and serve active
        messages until shut down (blocking)."""
        self.endpoint.address_book[0] = tuple(driver_addr)
        self.endpoint.connect(0, tuple(driver_addr))
        self.endpoint.request(0, "hello",
                              {"rank": self.rank,
                               "addr": list(self.endpoint.address)})
        self._stop.wait()
        self.graph.shutdown(wait=True, cancel_pending=True)
        self.endpoint.close()


def worker_main(rank: int, world: int, driver_addr,
                env: Optional[dict] = None):
    """Spawned-process entry point: become locality ``rank`` and serve.

    ``env`` entries are exported before any device work, and
    ``PHYRAX_LOCALITY_RANK`` always is, so locality-owned work records its
    executing rank.
    """
    for k, v in (env or {}).items():
        os.environ[k] = v
    os.environ["PHYRAX_LOCALITY_RANK"] = str(rank)
    Locality(rank, world).serve(tuple(driver_addr))


def join_locality(driver_addr: tuple[str, int], *,
                  max_workers: int = 2) -> int:
    """Dial-in elastic join (the ``--join host:port`` entry point).

    Raises:
        NotImplementedError: always (ROADMAP item 13).
    """
    raise NotImplementedError(f"join_locality: {_ELASTIC}")


# ---------------------------------------------------------------------------
# Driver side
# ---------------------------------------------------------------------------
class LocalityGroup:
    """Driver-side handle on the spawned worker localities.

    Spawns ``n_workers`` processes (ranks 1..n) with the ``spawn`` start
    method, waits for each to report in, then broadcasts the address book
    so workers can reach each other (AGAS fetches, the gradient ring).
    ``kill`` is the failure-drill seam.

    Args:
        n_workers: worker process count (world size is ``n_workers + 1``).
        worker_env: extra environment for the children.
        start_timeout: seconds to wait for all workers to report in.
    Raises:
        TimeoutError: a worker did not report in (every child is reaped
            first).
    """

    def __init__(self, n_workers: int, *,
                 worker_env: Optional[dict] = None,
                 start_timeout: float = 120.0):
        self.endpoint = Endpoint(0)
        self.world = n_workers + 1
        self._addrs: dict[int, tuple[str, int]] = {}
        self._alive: set[int] = set()
        self._cond = threading.Condition()
        self.endpoint.register("hello", self._on_hello)
        ctx = mp.get_context("spawn")
        self.procs: dict[int, Any] = {}
        for rank in range(1, self.world):
            p = ctx.Process(
                target=worker_main, daemon=True,
                args=(rank, self.world, tuple(self.endpoint.address),
                      worker_env))
            p.start()
            self.procs[rank] = p
        # a child that dies before its hello (an import error, a device
        # it cannot open) fails the start at once, not at the timeout
        deadline = time.monotonic() + start_timeout
        with self._cond:
            while len(self._addrs) < n_workers:
                dead = [r for r, p in self.procs.items()
                        if r not in self._addrs and p.exitcode is not None]
                left = deadline - time.monotonic()
                if dead or left <= 0:
                    break
                self._cond.wait(min(left, 0.5))
            missing = sorted(set(self.procs) - set(self._addrs))
        if missing:
            self.shutdown()
            raise TimeoutError(
                f"localities {missing} did not report in within "
                f"{start_timeout}s (exit codes "
                f"{[self.procs[r].exitcode for r in missing]})")
        book = {r: list(a) for r, a in self._addrs.items()}
        book[0] = list(self.endpoint.address)
        self.endpoint.address_book.update(
            {r: tuple(a) for r, a in self._addrs.items()})
        for rank in sorted(self._addrs):
            self.endpoint.post(rank, "peers",
                               {"book": book, "world": self.world})

    def _on_hello(self, src: int, p: dict) -> dict:
        rank, addr = int(p["rank"]), tuple(p["addr"])
        with self._cond:
            self._addrs[rank] = addr
            self._alive.add(rank)
            self._cond.notify_all()
        self.endpoint.address_book[rank] = addr
        return {"world": self.world}

    # -- liveness ------------------------------------------------------------
    def alive_workers(self) -> list[int]:
        """Worker ranks believed alive (updated on connection loss)."""
        with self._cond:
            return sorted(self._alive)

    def note_lost(self, rank: int):
        with self._cond:
            self._alive.discard(rank)

    def kill(self, rank: int):
        """SIGKILL a worker - the locality-loss drill.  The death is
        observed through its connection, same as a real crash."""
        proc = self.procs.get(rank)
        if proc is not None and proc.is_alive():
            proc.kill()
        self.note_lost(rank)

    def shutdown(self, join_timeout: float = 10.0):
        """Ask every live worker to exit, then reap the processes and
        close the endpoint.  Idempotent."""
        for rank in self.alive_workers():
            try:
                self.endpoint.post(rank, "shutdown")
            except PeerLostError:
                pass
        for rank, proc in self.procs.items():
            proc.join(timeout=join_timeout)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        self.endpoint.close()


@dataclasses.dataclass
class _TaskRecord:
    tid: str
    name: str
    lane: Lane
    fn: Callable
    pin: bool
    idempotent: bool
    target: int
    promise: PhyFuture
    payload: Optional[tuple] = None     # (args, kwargs) resolved at dispatch
    sent: bool = False
    # serializes target/sent mutation between the dispatching thread and
    # a concurrent peer-loss respawn (no double-spawn on two localities)
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)


class DistributedGraph:
    """The driver's view of the multi-locality futurized graph.

    Wraps a local ``FuturizedGraph`` (usually the session runtime) and a
    ``LocalityGroup``; ``defer`` mirrors ``FuturizedGraph.defer`` but may
    place the task on any locality, returning a promise-backed
    ``PhyFuture`` that resolves when the remote result streams back.

    Args:
        localities: total process count, driver included; 1 means no
            workers are spawned and every task runs locally.
        graph: the local graph promises live on (owned by the caller);
            one is created - and shut down with this object - if None.
        worker_env: forwarded to ``LocalityGroup``.
        name: display name for an internally-created graph.
        elastic: must be False (elastic membership is ROADMAP item 13).
    Raises:
        NotImplementedError: ``elastic=True``.
    """

    def __init__(self, localities: int = 1, *,
                 graph: Optional[FuturizedGraph] = None,
                 worker_env: Optional[dict] = None,
                 name: str = "distrib", elastic: bool = False):
        if elastic:
            raise NotImplementedError(f"DistributedGraph(elastic=True): "
                                      f"{_ELASTIC}")
        self.localities = localities
        self._own_graph = graph is None
        self._graph = graph if graph is not None else FuturizedGraph(
            max_workers=4, name=name)
        self.group = LocalityGroup(max(0, localities - 1),
                                   worker_env=worker_env)
        self.endpoint = self.group.endpoint
        self.directory = ObjectDirectory(0, self.endpoint)
        self.endpoint.register("task_done", self._on_task_done)
        self.endpoint.register("ddp_done", self._on_ddp_done)
        self.endpoint.on_peer_lost = self._on_peer_lost
        self._outstanding: dict[str, _TaskRecord] = {}
        self._by_future: dict[int, _TaskRecord] = {}   # id(promise) -> rec
        self._lock = threading.Condition()
        self._tid = itertools.count()
        self._rr = {lane: itertools.count() for lane in Lane}
        self.dispatched = collections.Counter()        # per-locality sends
        self.respawned = 0
        # gradient payload bytes the DRIVER sent over the ring (its own
        # encodes + relays)
        self.grad_wire_bytes = 0
        # the driver is ring rank 0; born here for the same
        # register-before-anyone-sends reason as on the Locality side
        self.grad_ring = RingAllReduce(self.endpoint, localities,
                                       account=self.account_grad_wire_bytes)
        self._ddp_done: dict[int, dict] = {}
        self._closed = False

    @property
    def graph(self) -> FuturizedGraph:
        """The local ``FuturizedGraph`` distributed promises live on."""
        return self._graph

    # -- placement -----------------------------------------------------------
    def _pick(self, lane: Lane, argskw, locality: Optional[int]) -> int:
        alive = self.group.alive_workers()
        if locality is not None:
            if locality != 0 and locality not in alive:
                raise ValueError(f"locality {locality} is not alive "
                                 f"(workers: {alive})")
            return locality
        homes: collections.Counter = collections.Counter()
        for leaf in tree_leaves(argskw, is_leaf=lambda x: isinstance(
                x, (PhyFuture, RemoteRef))):
            if isinstance(leaf, PhyFuture) and leaf.home is not None:
                if leaf.home == 0 or leaf.home in alive:
                    homes[leaf.home] += 1
            elif isinstance(leaf, RemoteRef):
                if leaf.owner == 0 or leaf.owner in alive:
                    homes[leaf.owner] += 1
        if homes:
            return homes.most_common(1)[0][0]
        if not alive:
            return 0
        return alive[next(self._rr[lane]) % len(alive)]

    # -- task construction ----------------------------------------------------
    def defer(self, fn: Callable, *args, lane: Lane = Lane.COMPUTE,
              name: str = "", locality: Optional[int] = None,
              pin: bool = False, idempotent: bool = True,
              **kwargs) -> PhyFuture:
        """Place ``fn(*args, **kwargs)`` on a locality and return its
        future.

        Args:
            fn: a *picklable* callable (module-level function or bound
                method of a picklable object) for remote placement.
            *args, **kwargs: arguments; local ``PhyFuture`` leaves become
                dependency edges resolved before dispatch, ``RemoteRef``
                leaves are dereferenced at the executing locality.
            lane: priority lane at the executing locality (and the
                round-robin stream the task joins here).
            name: display name; the future is ``name@L<rank>``.
            locality: pin placement to a rank (0 = the driver).
            pin: keep the result in the executing locality's directory
                and resolve the future with a ``RemoteRef`` instead of
                shipping the value back.
            idempotent: safe to re-run on another locality if the
                original dies; False poisons the future on loss instead.
        Returns:
            A ``PhyFuture`` (with ``home`` set to the chosen rank) that
            resolves with the result (or the ``RemoteRef`` when pinned).
        Raises:
            ValueError: ``locality`` names a dead worker.
        """
        if self._closed:
            raise RuntimeError("distributed graph is shut down")
        name = name or getattr(fn, "__name__", "task")
        target = self._pick(lane, (args, kwargs), locality)
        if target == 0:
            node = self._graph.defer(
                _LocalCall(fn, self.directory, pin=pin, summary=name),
                *args, lane=lane, name=f"{name}@L0", **kwargs)
            node.home = 0
            return node
        tid = f"t{next(self._tid)}"
        promise = self._graph.promise(name=f"{name}@L{target}", lane=lane,
                                      producer=f"L{target}")
        promise.home = target
        rec = _TaskRecord(tid=tid, name=name, lane=lane, fn=fn, pin=pin,
                          idempotent=idempotent, target=target,
                          promise=promise)
        with self._lock:
            self._outstanding[tid] = rec
            self._by_future[id(promise)] = rec
        # the dispatch node carries the task's local dependency edges;
        # once they resolve it ships (fn, resolved args) to the target
        try:
            send = self._graph.defer(self._dispatch, tid, (args, kwargs),
                                     lane=lane, name=f"send:{name}")
        except BaseException as e:   # e.g. cross-graph dependency: settle
            self._finish(rec, exc=e)  # the promise or barrier hangs on it
            raise
        # a dispatch node that terminates WITHOUT sending (poisoned by an
        # upstream edge, or cancelled) must settle the promise too
        send.add_done_callback(lambda n: self._on_dispatch_done(rec, n))
        return promise

    def _on_dispatch_done(self, rec: _TaskRecord, node: PhyFuture):
        with rec.lock:
            if rec.sent:
                return                   # task_done will settle it
        with self._lock:
            if rec.tid not in self._outstanding:
                return
        exc = node.exception()
        if exc is not None:
            self._finish(rec, exc=exc,
                         cancelled=isinstance(exc, CancelledError))
        elif rec.promise.done():         # cancelled before dispatch ran
            self._finish(rec, exc=CancelledError(rec.name), cancelled=True)

    def fetch(self, ref: RemoteRef, **kw) -> Any:
        """Deref a ``RemoteRef`` from the driver (see
        ``ObjectDirectory.fetch``)."""
        return self.directory.fetch(ref, **kw)

    def cancel(self, fut: PhyFuture) -> bool:
        """Cancel a distributed future: locally at once (dependents are
        poisoned through the normal edges) and, if already dispatched,
        best-effort at the executing locality so queued work is shed.

        Returns:
            The local ``PhyFuture.cancel`` result (False once resolved).
        """
        with self._lock:
            rec = self._by_future.get(id(fut))
        out = fut.cancel()
        if rec is not None and rec.sent:
            try:
                self.endpoint.post(rec.target, "cancel", rec.tid)
            except PeerLostError:
                pass
        return out

    # -- resilience across localities ----------------------------------------
    def replicate(self, fn: Callable, *args, n: int = 2,
                  lane: Lane = Lane.COMPUTE, name: str = "",
                  **kwargs) -> PhyFuture:
        """HPX task replication across localities: run ``fn`` on ``n``
        *distinct* localities and vote by checksum
        (``core.resilience.tree_checksum``).

        Returns:
            A future of the majority result.
        Raises:
            ValueError: fewer than ``n`` distinct localities exist.
        """
        name = name or getattr(fn, "__name__", "task")
        domain = self.group.alive_workers() + [0]
        if len(domain) < n:
            raise ValueError(f"replicate(n={n}) needs {n} localities, "
                             f"have {len(domain)}")
        futs = [self.defer(fn, *args, lane=lane, locality=domain[i],
                           name=f"{name}!r{i}", **kwargs) for i in range(n)]
        return self._graph.defer(_checksum_vote, *futs, lane=lane,
                                 name=f"{name}!vote")

    # -- dispatch internals ---------------------------------------------------
    def _dispatch(self, tid: str, argskw):
        with self._lock:
            rec = self._outstanding.get(tid)
        if rec is None or rec.promise.done():
            return                           # cancelled before dispatch
        rec.payload = argskw                 # futures already substituted
        try:
            self._send_spawn(rec)
        except BaseException as e:  # noqa: BLE001 - a stranded promise
            self._finish(rec, exc=e)         # would hang barrier/shutdown
            raise

    def _send_spawn(self, rec: _TaskRecord):
        assert rec.payload is not None  # _dispatch resolved it before sending
        args, kwargs = rec.payload
        with rec.lock:   # one spawner at a time: dispatch vs peer-loss
            while True:
                if rec.target != 0 \
                        and rec.target not in self.group.alive_workers():
                    rec.target = self._fallback(rec.lane)
                if rec.target == 0:
                    self._run_local(rec)
                    return
                try:
                    self.endpoint.post(rec.target, "spawn", {
                        "tid": rec.tid, "name": rec.name,
                        "lane": int(rec.lane), "pin": rec.pin,
                        "fn": rec.fn, "args": args, "kwargs": kwargs})
                except PeerLostError:
                    self.group.note_lost(rec.target)
                    continue
                except (pickle.PicklingError, AttributeError, TypeError) as e:
                    self._finish(rec, exc=RemoteTaskError(
                        f"{rec.name}: not picklable for remote spawn ({e}); "
                        f"use a module-level function and picklable args"))
                    return
                rec.sent = True
                rec.promise.home = rec.target
                with self._lock:
                    self.dispatched[rec.target] += 1
                return

    def _fallback(self, lane: Lane) -> int:
        alive = self.group.alive_workers()
        if not alive:
            return 0
        return alive[next(self._rr[lane]) % len(alive)]

    def _run_local(self, rec: _TaskRecord):
        assert rec.payload is not None  # _dispatch resolved it before sending
        node = self._graph.defer(
            _LocalCall(rec.fn, self.directory, pin=rec.pin,
                       summary=rec.name),
            *rec.payload[0], lane=rec.lane,
            name=f"{rec.name}@L0", **rec.payload[1])
        rec.promise.home = 0
        with self._lock:
            self.dispatched[0] += 1
        node.add_done_callback(lambda n: self._transfer(rec, n))

    def _transfer(self, rec: _TaskRecord, node: PhyFuture):
        exc = node.exception()
        if exc is None:
            self._finish(rec, value=node.result())   # _LocalCall pinned
        else:
            self._finish(rec, exc=exc,
                         cancelled=isinstance(exc, CancelledError))

    def _finish(self, rec: _TaskRecord, *, value=None,
                exc: Optional[BaseException] = None,
                cancelled: bool = False):
        with self._lock:
            present = self._outstanding.pop(rec.tid, None) is not None
            self._by_future.pop(id(rec.promise), None)
            self._lock.notify_all()
        if not present:
            return   # settled concurrently (completion vs peer loss)
        if exc is None:
            rec.promise.set_result(value)
        else:
            rec.promise.set_exception(exc, cancelled=cancelled)

    # -- elastic membership (ROADMAP item 13) ----------------------------------
    def add_locality(self, timeout: float = 120.0) -> int:
        """Spawn one extra worker locality into the running graph.

        Raises:
            NotImplementedError: always (ROADMAP item 13).
        """
        raise NotImplementedError(f"add_locality: {_ELASTIC}")

    def rebalance(self, newcomers: list[int]) -> int:
        """AGAS rebalance onto newcomer localities.

        Raises:
            NotImplementedError: always (ROADMAP item 13).
        """
        raise NotImplementedError(f"rebalance: {_ELASTIC}")

    def spmd_train(self, spec: dict):
        """The SPMD shadow train loop on every worker.

        Raises:
            NotImplementedError: always (ROADMAP item 13).
        """
        raise NotImplementedError(f"spmd_train: {_SPMD}")

    # -- fabric DDP (ring all-reduce; DESIGN.md §11) --------------------------
    def account_grad_wire_bytes(self, n: int):
        """Record ``n`` gradient payload bytes the driver's ring sent
        (own encodes + relays); wired as the driver ring's ``account``
        callback."""
        with self._lock:
            self.grad_wire_bytes += int(n)

    def ddp_train(self, spec: dict):
        """Start the fabric-DDP train loop (``frontend.ddp``) on every
        alive worker locality; the driver runs its own shard block
        in-process in ``Session.train``.

        Args:
            spec: picklable dict - ``plan``, ``steps``, ``ckpt_dir``,
                ``resume``, ``stream``, ``gen`` (the driver ring's
                generation, so all rings key segments identically).
        """
        with self._lock:
            self._ddp_done.clear()     # completions are per-run
            self.grad_wire_bytes = 0   # accounting too (re-entrant trains)
        for rank in self.group.alive_workers():
            try:
                self.endpoint.post(rank, "ddp_train", spec)
            except PeerLostError:      # died since alive_workers(): the
                pass                   # peer-loss hook aborts the ring

    def ddp_abort(self, reason: str):
        """Poison the whole ring: locally and (best-effort) on every
        alive worker.  Survivor localities with no direct connection to
        a dead rank would otherwise block until timeout."""
        self.grad_ring.abort(reason)
        for rank in self.group.alive_workers():
            try:
                self.endpoint.post(rank, "ddp_abort", reason)
            except PeerLostError:
                pass

    def _on_ddp_done(self, src: int, msg: dict):
        with self._lock:
            self._ddp_done[int(msg["rank"])] = msg
            self._lock.notify_all()

    def wait_ddp_done(self, timeout: float = 600.0) -> dict:
        """Block until every *alive* worker's DDP loop reported
        completion (a killed worker is excused - the run already
        aborted).

        Returns:
            ``{rank: done message}`` as received, each carrying ``ok``
            and ``grad_wire_bytes``.
        Raises:
            TimeoutError: an alive worker's DDP loop did not finish.
        """
        def ready():
            alive = set(self.group.alive_workers())
            return all(r in self._ddp_done for r in alive)

        with self._lock:
            ok = self._lock.wait_for(ready, timeout=timeout)
            done = dict(self._ddp_done)
        if not ok:
            raise TimeoutError("DDP train loops still running after "
                               f"{timeout}s")
        return done

    # -- wire handlers --------------------------------------------------------
    def _on_task_done(self, src: int, msg: dict):
        with self._lock:
            rec = self._outstanding.get(msg["tid"])
        if rec is None:
            return                           # cancelled/re-spawned: stale
        status = msg["status"]
        if status == "ok":
            self._finish(rec, value=msg["value"])
        elif status == "cancelled":
            self._finish(rec, exc=CancelledError(rec.name), cancelled=True)
        else:
            self._finish(rec, exc=msg["exc"])

    def _on_peer_lost(self, rank: int):
        self.group.note_lost(rank)
        if self.grad_ring.active:
            # a DDP exchange is in flight: poison it everywhere - a
            # survivor with no direct connection to the dead rank never
            # observes the loss itself
            self.ddp_abort(f"locality {rank} died mid-all-reduce")
        with self._lock:
            stranded = [r for r in self._outstanding.values()
                        if r.target == rank]
        for rec in stranded:
            with rec.lock:
                # re-check under the record lock: a concurrent dispatch
                # may have already moved it to a live locality
                if rec.promise.done() or rec.target != rank:
                    continue
                if not rec.sent:
                    # never reached the dead locality: just retarget
                    rec.target = self._fallback(rec.lane)
                    continue
                rec.sent = False
                rec.target = self._fallback(rec.lane)
            lost_refs = any(
                isinstance(leaf, RemoteRef) and leaf.owner == rank
                for leaf in tree_leaves(rec.payload, is_leaf=_is_ref))
            if not rec.idempotent or lost_refs:
                self._finish(rec, exc=LocalityLostError(
                    f"{rec.name}: locality {rank} died "
                    + ("holding its input data"
                       if lost_refs else "and the task is not idempotent")))
                continue
            with self._lock:
                self.respawned += 1
            try:
                self._send_spawn(rec)
            except BaseException as e:  # noqa: BLE001 - see _dispatch
                self._finish(rec, exc=e)

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        """Driver-side counters: per-locality dispatch counts, re-spawns,
        outstanding tasks, and wire bytes."""
        with self._lock:
            return {"dispatched": dict(self.dispatched),
                    "respawned": self.respawned,
                    "outstanding": len(self._outstanding),
                    "alive_workers": self.group.alive_workers(),
                    "bytes_sent": self.endpoint.bytes_sent,
                    "bytes_recv": self.endpoint.bytes_recv,
                    "grad_wire_bytes": self.grad_wire_bytes,
                    "unhandled_posts": dict(
                        self.endpoint.unhandled_posts)}

    def remote_stats(self, rank: int, timeout: float = 30.0) -> dict:
        """A worker locality's own ``RuntimeStats`` JSON (plus directory
        size and wire bytes), fetched over the wire."""
        return self.endpoint.request(rank, "stats", timeout=timeout)

    # -- lifecycle ------------------------------------------------------------
    def barrier(self, timeout: float = 120.0):
        """Block until every distributed task has streamed back.

        Raises:
            TimeoutError: outstanding tasks remain after ``timeout``.
        """
        with self._lock:
            ok = self._lock.wait_for(lambda: not self._outstanding,
                                     timeout=timeout)
        if not ok:
            raise TimeoutError(
                f"{len(self._outstanding)} distributed tasks outstanding")

    def shutdown(self, wait: bool = True, timeout: float = 120.0):
        """Drain distributed work (or poison it), stop the workers, and
        shut the local graph down if this object created it."""
        if self._closed:
            return
        self._closed = True
        if wait:
            try:
                self.barrier(timeout=timeout)
            except TimeoutError:
                pass
        with self._lock:
            stranded = list(self._outstanding.values())
        for rec in stranded:
            self._finish(rec, exc=LocalityLostError(
                f"{rec.name}: distributed graph shut down"))
        self.group.shutdown()
        if self._own_graph:
            self._graph.shutdown(wait=True)


class _LocalCall:
    """Driver-local execution of a (possibly ref-holding) task payload;
    picklable-agnostic because it never crosses the wire.  Honors the
    same ``pin`` contract as remote execution: the value stays in the
    driver's directory and the caller sees a ``RemoteRef``."""

    def __init__(self, fn: Callable, directory: ObjectDirectory, *,
                 pin: bool = False, summary: str = ""):
        self.fn = fn
        self.directory = directory
        self.pin = pin
        self.summary = summary
        self.__name__ = getattr(fn, "__name__", "task")

    def __call__(self, *args, **kwargs):
        a, kw = _deref_tree((args, kwargs), self.directory)
        value = self.fn(*a, **kw)
        if self.pin:
            value = self.directory.put(value, summary=self.summary
                                       or self.__name__)
        return value


def _checksum_vote(*results):
    """Majority vote by content checksum over replica results (HPX
    replicate); no majority means corruption we cannot arbitrate."""
    # core.resilience walks trees with agas: imported here, not at the top
    from ..core.resilience import tree_checksum
    sums = [tree_checksum(r) for r in results]
    counts = collections.Counter(sums)
    best, votes = counts.most_common(1)[0]
    if votes <= len(results) // 2 and len(results) > 1:
        raise RemoteTaskError(
            f"replicate: no checksum majority across {len(results)} "
            f"localities ({counts})")
    return results[sums.index(best)]
