"""Multi-locality scheduling: ``Locality`` workers + ``DistributedGraph``.

Counterpart: ``repro/distrib/runtime.py`` (``RemoteTaskError``,
``LocalityLostError``, ``Locality``, ``worker_main``, ``LocalityGroup``,
``DistributedGraph``, ``_LocalCall``, ``_checksum_vote``, and the
elastic membership of DESIGN.md §13: ``join_locality``,
``DistributedGraph.add_locality`` and ``rebalance``, victim-lease work
stealing, and SPMD mode's ``spmd_train`` / ``ckpt_entries`` /
``spmd_done`` protocol, DESIGN.md §10).  The reference uses JAX to walk
argument trees and to stand up ``jax.distributed`` for SPMD mode; the
port walks trees itself (``agas.tree_leaves``/``tree_map``), and a worker
of an SPMD session joins a ``torch.distributed`` gloo world instead
(``launch.mesh.maybe_init_distributed``), which runs no collective: it
only makes the world's size and this process's rank known to the
checkpoint layer.  The runtime sanitizer's hooks are the reference's: a
task spawned twice on one locality, completed by a locality that no
longer owns it, or a steal under a stale membership generation (PHY106).

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
  * **Elastic membership.**  An elastic driver takes new localities
    mid-run (``add_locality`` spawns one, ``join_locality`` dials in),
    gossips each join and loss under a membership generation, migrates a
    block of pinned objects to every newcomer (``rebalance``) and lets an
    idle locality steal steerable tasks: a driver-local one before it
    runs, or one leased by cancel from a loaded worker.

Task functions must be picklable (module-level functions or bound methods
of picklable objects); closures fail with a clear error at dispatch.  No
CUDA tensor crosses the wire: workers build host values (numpy), and each
locality does its own device work on the device of the plan it is given.
Worker processes start from a ``multiprocessing`` "forkserver" that has
imported torch and nothing else: a child is forked from a process that
never touched a device, so none inherits a CUDA context, and none pays a
fresh interpreter's ``import torch`` (most of a session's bring-up on an
H100 host: ``tools/cold_start_probe.py``).  Each child then takes the
driver's environment as it stands at its start, as a spawned child
would.
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

from ..analysis import sanitize as _san
from ..core.futures import FuturizedGraph, Lane, PhyFuture
from .agas import ObjectDirectory, RemoteRef, tree_leaves, tree_map
from .collectives import RingAllReduce
from .messaging import Endpoint, PeerLostError, raw_request

__all__ = ["DistributedGraph", "Locality", "LocalityGroup",
           "LocalityLostError", "RemoteTaskError", "join_locality",
           "worker_main"]


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
        elastic: run the idle-thief steal loop (DESIGN.md §13): the
            locality posts ``steal_request`` to the driver whenever its
            local graph drains.
    """

    def __init__(self, rank: int, world: int, *, max_workers: int = 2,
                 elastic: bool = False):
        self.rank = rank
        self.world = world
        self.elastic = elastic
        # membership generation (gossiped by the driver, monotone): every
        # steal carries it, so a steal planned under a stale peer table is
        # fenced instead of double-executing
        self.membership_gen = 0
        self.endpoint = Endpoint(rank)
        self.graph = FuturizedGraph(max_workers=max_workers,
                                    name=f"locality{rank}")
        self.directory = ObjectDirectory(rank, self.endpoint)
        self._tasks: dict[str, PhyFuture] = {}
        # tids a steal_lease may claim (the spawn said so: round-robin
        # placement, not pinned and not data-affinity)
        self._stealable: set[str] = set()
        # tids leased away mid-steal: their cancelled completion must not
        # be reported (the driver re-spawns them from its own payload)
        self._stolen: set[str] = set()
        self._steal_interval = 0.05
        self._lock = threading.Lock()
        self._stop = threading.Event()
        ep = self.endpoint
        ep.register("spawn", self._on_spawn)
        ep.register("cancel", self._on_cancel)
        ep.register("peers", self._on_peers)
        ep.register("peer_joined", self._on_peer_joined)
        ep.register("steal_lease", self._on_steal_lease)
        ep.register("agas_rebalance", self._on_rebalance)
        ep.register("shutdown", lambda src, p: self._stop.set())
        ep.register("ping", lambda src, p: p)
        ep.register("stats", self._on_stats)
        ep.register("spmd_train", self._on_spmd_train)
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
            self.membership_gen = max(self.membership_gen,
                                      int(p.get("gen", 0)))
            dup = p["tid"] in self._tasks
        if dup:
            # the handoff protocol never lands one tid here twice: a
            # second spawn means a lease raced a re-spawn past the
            # driver's fencing (PHY106) - drop it
            if _san.active():
                _san.get().record(
                    "PHY106",
                    f"locality {self.rank}: task {p['tid']} "
                    f"({p['name']}) spawned here twice - steal-lease "
                    f"violation",
                    once_key=f"spawn:{self.rank}:{p['tid']}")
            return
        node = self.graph.defer(self._run, p["fn"], p["args"], p["kwargs"],
                                lane=Lane(p["lane"]), name=p["name"])
        with self._lock:
            self._tasks[p["tid"]] = node
            if p.get("steal"):
                self._stealable.add(p["tid"])
        node.add_done_callback(
            lambda n, tid=p["tid"], pin=p["pin"], src=src:
            self._report(src, tid, pin, n))

    def _run(self, fn, args, kwargs):
        a, kw = _deref_tree((args, kwargs), self.directory)
        return fn(*a, **kw)

    def _report(self, src: int, tid: str, pin: bool, node: PhyFuture):
        with self._lock:
            stolen = tid in self._stolen
            self._stolen.discard(tid)
            self._tasks.pop(tid, None)
            self._stealable.discard(tid)
        if stolen:
            return   # leased away before it ran; the driver re-spawns it
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
        # a bare {rank: addr} book, or {"book": ..., "gen": ..., "world": ...}
        book = p["book"] if "book" in p else p
        self.endpoint.address_book.update(
            {int(r): tuple(a) for r, a in book.items()})
        if "gen" in p:
            with self._lock:
                self.membership_gen = max(self.membership_gen,
                                          int(p["gen"]))
                self.world = max(self.world, int(p.get("world", 0)))

    def _on_peer_joined(self, src: int, p: dict):
        """Membership gossip, generation-keyed: a stale or reordered join
        or leave message can only move this locality's view forward,
        never back."""
        gen = int(p["gen"])
        with self._lock:
            if gen <= self.membership_gen:
                return
            self.membership_gen = gen
        if p.get("event", "join") == "left":
            self.endpoint.address_book.pop(int(p["rank"]), None)
        else:
            self.endpoint.address_book[int(p["rank"])] = tuple(p["addr"])
            with self._lock:
                self.world = max(self.world, int(p["rank"]) + 1)

    def _on_steal_lease(self, src: int, p: dict) -> int:
        """Driver-brokered steal, victim side: claim (cancel) one spawned
        task that has not started - that cancel IS the lease - and
        release it to the driver in a ``steal_handoff``, which re-spawns
        it on the thief from its own payload.  A task whose cancel fails
        is running or done: the lease moves a task that never started, or
        nothing.  Only tasks the spawn marked stealable are candidates."""
        with self._lock:
            candidates = [(tid, node) for tid, node in self._tasks.items()
                          if tid in self._stealable]
        for tid, node in candidates:
            with self._lock:
                self._stolen.add(tid)    # before cancel: its completion
            if not node.cancel():        # callback checks this set
                with self._lock:
                    self._stolen.discard(tid)
                continue
            with self._lock:
                self._tasks.pop(tid, None)
            try:
                self.endpoint.post(0, "steal_handoff",
                                   {"tid": tid, "thief": int(p["thief"]),
                                    "victim": self.rank,
                                    "gen": int(p.get("gen", -1))})
            except PeerLostError:
                pass          # driver gone: shutdown is imminent anyway
            return 1
        return 0

    def _on_rebalance(self, src: int, p: dict) -> int:
        """Driver-driven AGAS rebalance: refresh the peer table (the
        newcomers must be dialable before values ship to them) and migrate
        this locality's block (``ObjectDirectory.rebalance``)."""
        self.endpoint.address_book.update(
            {int(r): tuple(a) for r, a in p.get("book", {}).items()})
        return self.directory.rebalance([int(r) for r in p["newcomers"]])

    def _steal_loop(self):
        """Idle-thief loop (elastic mode): when the local graph drains,
        ask the driver for work.  The ack carries the membership
        generation; a ``parked`` reply (the driver had nothing either)
        backs off - the driver diverts the next steerable dispatch here
        without being asked again."""
        backoff_until = 0.0
        while not self._stop.is_set():
            self._stop.wait(self._steal_interval)
            if self._stop.is_set():
                return
            if time.monotonic() < backoff_until:
                continue
            ld = self.graph.load()
            if ld["ready"] or ld["running"]:
                continue
            try:
                out = self.endpoint.request(
                    0, "steal_request",
                    {"thief": self.rank, "gen": self.membership_gen},
                    timeout=30.0)
            except (PeerLostError, TimeoutError, RuntimeError):
                backoff_until = time.monotonic() + 1.0
                continue
            with self._lock:
                self.membership_gen = max(self.membership_gen,
                                          int(out.get("gen", 0)))
            if not out.get("handed"):
                backoff_until = time.monotonic() + 0.5

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

    def _on_spmd_train(self, src: int, spec: dict):
        """Run the SPMD shadow train loop (``frontend.spmd``) on its own
        thread: this locality mirrors the driver's device computation in
        lockstep and writes its own checkpoint segments, posting back only
        the manifest entries.  Completion (or the failure) is reported in
        a ``spmd_done`` post, which also carries the kernel launches of
        the loop and the sanitizer's diagnostics on this locality (the
        port's own additions: the driver checks both).  A spec with a
        ``loop`` (a module-level function, shipped by reference) runs that
        instead: a mesh session's rank train loop (``frontend/mesh.py``)
        rides this protocol."""
        def run():
            try:
                from ..frontend.spmd import shadow_train
                loop = spec.get("loop") or shadow_train
                out = loop(spec, endpoint=self.endpoint)
                msg = dict(out, rank=self.rank, ok=True)
            except BaseException as e:  # noqa: BLE001 - shipped back
                msg = {"rank": self.rank, "ok": False,
                       "error": f"{type(e).__name__}: {e}"}
            msg["diagnostics"] = [str(d) for d in _san.get().diagnostics()]
            try:
                self.endpoint.post(src, "spmd_done", msg)
            except PeerLostError:
                pass
        threading.Thread(target=run, daemon=True,
                         name=f"spmd-shadow-{self.rank}").start()

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
        out = self.endpoint.request(0, "hello",
                                    {"rank": self.rank,
                                     "addr": list(self.endpoint.address)})
        with self._lock:                 # adopt the driver's view
            self.membership_gen = max(self.membership_gen,
                                      int(out.get("gen", 0)))
            self.world = max(self.world, int(out.get("world", 0)))
        if self.elastic:
            threading.Thread(target=self._steal_loop, daemon=True,
                             name=f"steal{self.rank}").start()
        self._stop.wait()
        self.graph.shutdown(wait=True, cancel_pending=True)
        self.endpoint.close()


def _locality_env(rank: int):
    """Export the locality's rank, so locality-owned work records its
    executing rank (a checkpoint shard's entry names its writer), and
    create the checkpoint directory the session forwards, so an
    unwritable mount fails the locality at once, not at its first
    shard write."""
    os.environ["PHYRAX_LOCALITY_RANK"] = str(rank)
    ckpt_dir = os.environ.get("PHYRAX_CKPT_DIR")
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)


def worker_main(rank: int, world: int, driver_addr,
                env: Optional[dict] = None):
    """Spawned-process entry point: become locality ``rank`` and serve.

    ``env`` becomes the whole environment before any device work: the
    driver's at this process's start (the forkserver's own is older),
    with what the session adds (the checkpoint directory as
    ``PHYRAX_CKPT_DIR``, an elastic driver ``PHYRAX_ELASTIC``, an SPMD
    session its gloo coordinator as ``PHYRAX_DIST_COORDINATOR``);
    ``_locality_env`` then exports the
    rank, and ``launch.mesh.maybe_init_distributed`` joins the
    ``torch.distributed`` world (a no-op unless a coordinator is set)
    before this process serves: the driver's own join, on a thread,
    completes only when every rank has joined.  Where the session names
    each process's world (``PHYRAX_DIST_PLACES``, read by
    ``launch.mesh.place_of``: a mesh world per locality), this process
    joins the world its place names, and a process without a place (a
    task locality) joins none.  The world is torn down after the
    driver's shutdown.
    """
    if env is not None:
        os.environ.clear()
        os.environ.update(env)
    _locality_env(rank)
    from ..launch.mesh import maybe_init_distributed, place_of
    place = place_of(rank)
    if place is not None:        # a rank of one locality's mesh world
        spmd = maybe_init_distributed(coordinator=place["coordinator"],
                                      num_processes=place["size"],
                                      process_id=place["rank"])
    elif os.environ.get("PHYRAX_DIST_PLACES"):
        spmd = False             # a task locality: in no world
    else:
        spmd = maybe_init_distributed(process_id=rank, num_processes=world)
    elastic = os.environ.get("PHYRAX_ELASTIC", "") not in ("", "0")
    try:
        Locality(rank, world, elastic=elastic).serve(tuple(driver_addr))
    finally:
        if spmd:
            import torch.distributed as dist
            dist.destroy_process_group()


def join_locality(driver_addr: tuple[str, int], *,
                  max_workers: int = 2) -> int:
    """Dial-in elastic join (the ``--join host:port`` entry point).

    Two-phase registration (DESIGN.md §13): a ``join`` request over a raw
    one-shot socket returns the assigned rank, the current peer table,
    the driver's config spec (environment to adopt) and the membership
    generation; then this process becomes that ``Locality`` and serves -
    its ``hello`` triggers gossip and AGAS rebalance on the driver.
    Blocks until the driver shuts the run down.

    Returns:
        The rank this process served as.
    Raises:
        RuntimeError: the driver does not accept joins (not elastic).
        ConnectionError: no driver is listening at ``driver_addr``.
    """
    driver_addr = (driver_addr[0], int(driver_addr[1]))
    grant = raw_request(driver_addr, "join", {})
    spec = grant.get("spec") or {}
    for k, v in (spec.get("env") or {}).items():
        os.environ.setdefault(k, str(v))
    rank = int(grant["rank"])
    _locality_env(rank)
    loc = Locality(rank, int(grant["world"]), max_workers=max_workers,
                   elastic=True)
    loc.membership_gen = int(grant.get("gen", 0))
    loc.endpoint.address_book.update(
        {int(r): tuple(a) for r, a in grant["book"].items()})
    loc.serve(driver_addr)
    return rank


# ---------------------------------------------------------------------------
# Driver side
# ---------------------------------------------------------------------------
def _start_context():
    """The ``multiprocessing`` context worker processes start from: the
    forkserver, with torch imported there once (see the module
    docstring)."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    return ctx


class LocalityGroup:
    """Driver-side handle on the spawned worker localities.

    Starts ``n_workers`` processes (ranks 1..n) from the forkserver
    (``_start_context``), waits for each to report in, then broadcasts the address book
    so workers can reach each other (AGAS fetches, the gradient ring).
    ``kill`` is the failure-drill seam; ``add_worker`` and ``next_rank``
    are the elastic join's.

    Args:
        n_workers: worker process count (world size is ``n_workers + 1``).
        worker_env: extra environment for the children.
        start_timeout: seconds to wait for all workers to report in.
        port: driver listen port (0 = ephemeral); fixed by elastic runs
            so that ``--join`` has a known address to dial.
    Raises:
        TimeoutError: a worker did not report in (every child is reaped
            first).
    """

    def __init__(self, n_workers: int, *,
                 worker_env: Optional[dict] = None,
                 start_timeout: float = 120.0, port: int = 0):
        self.endpoint = Endpoint(0, port=port)
        self.world = n_workers + 1
        # membership generation: bumped on every join and loss, gossiped
        # with the peer table, and carried by every steal (fencing)
        self.gen = 0
        self._worker_env = worker_env
        self._start_timeout = start_timeout
        self._addrs: dict[int, tuple[str, int]] = {}
        self._alive: set[int] = set()
        self._reserved: set[int] = set()   # ranks granted, not yet hello'd
        self._started = False
        # called (rank, addr) on every post-startup hello - the elastic
        # join seam; DistributedGraph wires gossip + rebalance here
        self.on_join: Optional[Callable[[int, tuple[str, int]], None]] = None
        self._cond = threading.Condition()
        self.endpoint.register("hello", self._on_hello)
        self.procs: dict[int, Any] = {}
        for rank in range(1, self.world):
            self._spawn(rank)
        missing = self._wait_reported(list(self.procs), start_timeout)
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
                               {"book": book, "gen": self.gen,
                                "world": self.world})
        self._started = True

    def _spawn(self, rank: int):
        env = dict(os.environ, **(self._worker_env or {}))
        p = _start_context().Process(
            target=worker_main, daemon=True,
            args=(rank, self.world, tuple(self.endpoint.address), env))
        p.start()
        self.procs[rank] = p

    def _wait_reported(self, ranks: list, timeout: float) -> list:
        """Wait until every rank of ``ranks`` said hello; a child that
        dies first (an import error, a device it cannot open) ends the
        wait at once, not at the timeout.  Returns the ranks missing."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                missing = [r for r in ranks if r not in self._addrs]
                dead = [r for r in missing
                        if self.procs[r].exitcode is not None]
                left = deadline - time.monotonic()
                if not missing or dead or left <= 0:
                    return sorted(missing)
                self._cond.wait(min(left, 0.5))

    def _on_hello(self, src: int, p: dict) -> dict:
        rank, addr = int(p["rank"]), tuple(p["addr"])
        with self._cond:
            self._addrs[rank] = addr
            self._alive.add(rank)
            self._reserved.discard(rank)
            self.world = max(self.world, rank + 1)
            started = self._started
            self._cond.notify_all()
        self.endpoint.address_book[rank] = addr
        if started and self.on_join is not None:
            # a post-startup hello is an elastic join: gossip and
            # rebalance BEFORE the ack, so the joiner's serve loop starts
            # against a settled peer table
            self.on_join(rank, addr)
        return {"world": self.world, "gen": self.gen}

    def addresses(self) -> dict[int, tuple[str, int]]:
        """The current peer table: ``rank -> (host, port)`` for every
        alive locality, driver included."""
        with self._cond:
            out = {r: self._addrs[r] for r in self._alive
                   if r in self._addrs}
        out[0] = tuple(self.endpoint.address)
        return out

    def next_rank(self) -> int:
        """Reserve and return the next unused rank (an elastic join's
        grant); the reservation clears when that rank's hello arrives."""
        with self._cond:
            used = set(self.procs) | set(self._addrs) | self._reserved
            rank = max(used, default=0) + 1
            self._reserved.add(rank)
            self.world = max(self.world, rank + 1)
            return rank

    def add_worker(self, timeout: Optional[float] = None) -> int:
        """Spawn one extra worker process into the running group and wait
        for it to report in (its hello fires ``on_join``).

        Returns:
            The new worker's rank.
        Raises:
            TimeoutError: it did not report in.
        """
        rank = self.next_rank()
        self._spawn(rank)
        if self._wait_reported([rank], timeout if timeout is not None
                               else self._start_timeout):
            self.procs[rank].kill()
            with self._cond:
                self._reserved.discard(rank)
            raise TimeoutError(
                f"locality {rank} did not report in (exit code "
                f"{self.procs[rank].exitcode})")
        return rank

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
        observed through its connection, same as a real crash.  A dial-in
        joiner has no process handle here; it gets a shutdown post
        instead (its process belongs to whoever ran ``--join``)."""
        proc = self.procs.get(rank)
        if proc is not None and proc.is_alive():
            proc.kill()
        elif proc is None:
            try:
                self.endpoint.post(rank, "shutdown")
            except PeerLostError:
                pass
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
    # elastic scheduling: a steerable record (no explicit locality, no
    # data affinity) may be diverted to a parked idle thief at dispatch;
    # local_node holds the driver-local execution node, so a steal can
    # claim (cancel) it before it runs
    steerable: bool = False
    stolen: bool = False
    local_node: Optional[PhyFuture] = None
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
        elastic: accept dial-in joins, spawn workers with the steal loop
            armed, and route driver-local tasks through stealable records
            (DESIGN.md §13).
        elastic_port: fixed driver listen port for ``--join`` dialers
            (0 = ephemeral; only used with ``elastic``).
        join_spec: shipped as it is to dial-in joiners in the join grant;
            its ``{"env": {...}}`` entries are exported by the joiner
            before it serves (the checkpoint directory).
    """

    def __init__(self, localities: int = 1, *,
                 graph: Optional[FuturizedGraph] = None,
                 worker_env: Optional[dict] = None,
                 name: str = "distrib", elastic: bool = False,
                 elastic_port: int = 0, join_spec: Optional[dict] = None):
        self.localities = localities
        self.elastic = elastic
        if elastic:
            worker_env = dict(worker_env or {}, PHYRAX_ELASTIC="1")
        self._own_graph = graph is None
        self._graph = graph if graph is not None else FuturizedGraph(
            max_workers=4, name=name)
        self.group = LocalityGroup(max(0, localities - 1),
                                   worker_env=worker_env,
                                   port=elastic_port if elastic else 0)
        self.group.on_join = self._on_member_joined
        self.endpoint = self.group.endpoint
        self.directory = ObjectDirectory(0, self.endpoint)
        self.endpoint.register("task_done", self._on_task_done)
        self.endpoint.register("ddp_done", self._on_ddp_done)
        self.endpoint.register("ckpt_entries", self._on_ckpt_entries)
        self.endpoint.register("spmd_done", self._on_spmd_done)
        self.endpoint.register("join", self._on_join_request)
        self.endpoint.register("steal_request", self._on_steal_request)
        self.endpoint.register("steal_handoff", self._on_steal_handoff)
        self.endpoint.on_peer_lost = self._on_peer_lost
        self._outstanding: dict[str, _TaskRecord] = {}
        self._by_future: dict[int, _TaskRecord] = {}   # id(promise) -> rec
        self._lock = threading.Condition()
        self._tid = itertools.count()
        self._rr = {lane: itertools.count() for lane in Lane}
        self.dispatched = collections.Counter()        # per-locality sends
        self.respawned = 0
        # elastic counters (the train report and the drills)
        self.stolen_tasks = 0
        self.migrated_objects = 0
        self.joined = 0
        self._join_spec = dict(join_spec or {})
        self._hungry: collections.deque = collections.deque()
        self._join_done: set[int] = set()
        # checkpoint leaf bytes shipped to their owners in save payloads
        self.ckpt_leaf_wire_bytes = 0
        # gradient payload bytes the DRIVER sent over the ring (its own
        # encodes + relays)
        self.grad_wire_bytes = 0
        # the driver is ring rank 0; born here for the same
        # register-before-anyone-sends reason as on the Locality side
        self.grad_ring = RingAllReduce(self.endpoint, localities,
                                       account=self.account_grad_wire_bytes)
        self._ddp_done: dict[int, dict] = {}
        # (step, rank) -> entry promise (save registered first) or the
        # buffered entry value (the worker's post arrived first)
        self._spmd_entries: dict[tuple[int, int], Any] = {}
        self._spmd_done: dict[int, dict] = {}
        self._spmd_ranks: Optional[set] = None   # spmd_train's ranks=
        self._closed = False

    @property
    def graph(self) -> FuturizedGraph:
        """The local ``FuturizedGraph`` distributed promises live on."""
        return self._graph

    # -- placement -----------------------------------------------------------
    def alive_localities(self) -> list[int]:
        """Live locality ranks, the driver (rank 0, always alive) first.
        The serving gateway homes its replicas over this list and polls it
        each round for a replica whose home died."""
        return [0] + self.group.alive_workers()

    def _pick(self, lane: Lane, argskw,
              locality: Optional[int]) -> tuple[int, bool]:
        """Choose a target rank; the second element says whether the
        choice was *steerable* (round-robin, not pinned and not
        affinity-driven): only steerable tasks may be diverted to a parked
        idle thief or claimed by a steal."""
        alive = self.group.alive_workers()
        if locality is not None:
            if locality != 0 and locality not in alive:
                raise ValueError(f"locality {locality} is not alive "
                                 f"(workers: {alive})")
            return locality, False
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
            return homes.most_common(1)[0][0], False
        if not alive:
            return 0, True
        return alive[next(self._rr[lane]) % len(alive)], True

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
        target, steerable = self._pick(lane, (args, kwargs), locality)
        if target == 0 and not self.elastic:
            # non-elastic fast path: a driver-local task skips the record;
            # elastic mode keeps one, so an idle joiner can claim the task
            # before it runs
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
                          promise=promise, steerable=steerable)
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
                if rec.steerable:
                    thief = self._pop_hungry()
                    if thief is not None:
                        # a parked idle locality (its steal_request found
                        # nothing) takes the next steerable dispatch - work
                        # stealing's push half
                        rec.target = thief
                        rec.stolen = True
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
                        "gen": self.group.gen,
                        "steal": bool(rec.steerable),
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
                    if rec.stolen:
                        self.stolen_tasks += 1
                        rec.stolen = False
                return

    def _pop_hungry(self) -> Optional[int]:
        with self._lock:
            if not self._hungry:
                return None
        alive = set(self.group.alive_workers())
        with self._lock:
            while self._hungry:
                r = self._hungry.popleft()
                if r in alive:
                    return r
        return None

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
        rec.local_node = node
        rec.promise.home = 0
        with self._lock:
            self.dispatched[0] += 1
        node.add_done_callback(lambda n: self._transfer(rec, n))

    def _transfer(self, rec: _TaskRecord, node: PhyFuture):
        with rec.lock:
            if rec.local_node is not node:
                return   # claimed by a steal mid-flight: it re-spawns
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
            return   # settled concurrently (steal claim vs completion)
        if exc is None:
            rec.promise.set_result(value)
        else:
            rec.promise.set_exception(exc, cancelled=cancelled)

    # -- elastic membership + work stealing (DESIGN.md §13) -------------------
    def _on_join_request(self, src: int, p) -> dict:
        """Dial-in registration, phase one: grant the joiner a rank and
        ship the peer table, the config spec and the membership
        generation.  The joiner then becomes that ``Locality`` and says
        hello like a spawned worker: gossip and rebalance run there."""
        if not self.elastic:
            raise RuntimeError(
                "this driver does not accept elastic joins; start it "
                "with Plan(elastic=True) / --elastic")
        rank = self.group.next_rank()
        book = {r: list(a) for r, a in self.group.addresses().items()}
        return {"rank": rank, "world": self.group.world,
                "gen": self.group.gen, "book": book,
                "spec": dict(self._join_spec)}

    def _on_member_joined(self, rank: int, addr: tuple[str, int]):
        """A locality reported in after startup (an ``add_locality``
        spawn or a ``--join`` dial-in).  Runs on the hello handler BEFORE
        the hello's ack: bump the membership generation, gossip the join
        and the refreshed peer table, and rebalance pinned objects toward
        the newcomer - so when its serve loop starts, every peer can reach
        it and it already owns a block of the address space."""
        ep = self.endpoint
        ep.address_book[rank] = tuple(addr)
        with self._lock:
            self.group.gen += 1
            gen = self.group.gen
            self.joined += 1
        book = {r: list(a) for r, a in self.group.addresses().items()}
        payload = {"book": book, "gen": gen, "world": self.group.world}
        for r in self.group.alive_workers():
            try:
                ep.post(r, "peers", payload)
                if r != rank:
                    ep.post(r, "peer_joined",
                            {"rank": rank, "addr": list(addr), "gen": gen})
            except PeerLostError:
                continue
        self.rebalance([rank])
        with self._lock:
            self._join_done.add(rank)
            self._lock.notify_all()

    def add_locality(self, timeout: float = 120.0) -> int:
        """Spawn one extra worker locality into the *running* graph (the
        driver-side twin of a ``--join`` dial-in) and block until its
        membership gossip and AGAS rebalance completed.

        Returns:
            The new locality's rank.
        Raises:
            TimeoutError: the worker did not report in, or its join never
                settled.
        """
        if self._closed:
            raise RuntimeError("distributed graph is shut down")
        rank = self.group.add_worker(timeout=timeout)
        with self._lock:
            ok = self._lock.wait_for(lambda: rank in self._join_done,
                                     timeout=timeout)
        if not ok:
            raise TimeoutError(
                f"locality {rank} reported in but its membership gossip "
                f"did not complete within {timeout}s")
        return rank

    def rebalance(self, newcomers: list[int]) -> int:
        """AGAS rebalance pass: every pre-existing locality, the driver
        included, migrates a contiguous block of its pinned objects onto
        the ``newcomers``, leaving forwarding stubs so that stale
        ``RemoteRef``s keep resolving one hop away.

        Returns:
            Objects migrated across the cluster (also summed into
            ``stats()["migrated_objects"]``).
        """
        newcomers = [int(r) for r in newcomers]
        book = {r: list(a) for r, a in self.group.addresses().items()}
        moved = self.directory.rebalance(newcomers)
        for rank in self.group.alive_workers():
            if rank in newcomers:
                continue
            try:
                moved += int(self.endpoint.request(
                    rank, "agas_rebalance",
                    {"newcomers": newcomers, "book": book}, timeout=60.0))
            except (PeerLostError, TimeoutError):
                continue
        with self._lock:
            self.migrated_objects += moved
        return moved

    def _queue_depths(self) -> dict[int, int]:
        """Outstanding-task depth per locality (the load table a steal's
        ack carries); the driver's count covers unclaimed records."""
        depths: collections.Counter = collections.Counter()
        with self._lock:
            for rec in self._outstanding.values():
                if rec.sent:
                    depths[rec.target] += 1
                elif rec.local_node is not None:
                    depths[0] += 1
        return {int(r): int(n) for r, n in depths.items()}

    def _pick_victim(self, thief: int) -> Optional[int]:
        # steerable work only: pinned and affinity tasks are not
        # claimable, so they must not make a locality look like a victim
        with self._lock:
            depths = collections.Counter(
                rec.target for rec in self._outstanding.values()
                if rec.sent and rec.steerable)
        # a depth-1 victim's only task is likely already running: a lease
        # there would find nothing claimable
        loaded = [r for r in self.group.alive_workers()
                  if r != thief and depths.get(r, 0) >= 2]
        if not loaded:
            return None
        return max(loaded, key=lambda r: depths[r])

    def _steal_local(self, thief: int) -> Optional[_TaskRecord]:
        """Claim one driver-local steerable record whose execution node
        has not started: detaching ``local_node`` then cancelling it IS
        the lease - a node already running refuses the cancel and the
        claim rolls back, so the task runs exactly once either way."""
        with self._lock:
            recs = [r for r in self._outstanding.values()
                    if r.steerable and r.local_node is not None]
        for rec in recs:
            with rec.lock:
                node = rec.local_node
                if node is None or rec.promise.done():
                    continue
                try:
                    # only ship what pickles: this payload never crossed a
                    # wire on the local path
                    pickle.dumps((rec.fn, rec.payload),
                                 protocol=pickle.HIGHEST_PROTOCOL)
                except Exception:  # noqa: BLE001 - unshippable: skip it
                    continue
                rec.local_node = None
            if node.cancel():
                with rec.lock:
                    rec.sent = False
                    rec.target = thief
                    rec.stolen = True
                return rec
            with rec.lock:       # running or done: roll the claim back
                if rec.local_node is None:
                    rec.local_node = node
            if node.done():
                # completion raced the claim and its _transfer saw the
                # node detached: settle now (idempotent)
                self._transfer(rec, node)
        return None

    def _on_steal_request(self, src: int, p: dict) -> dict:
        """A thief's entry into the steal protocol: hand over a ready
        driver-local task, else lease one from the most-loaded worker,
        else park the thief - the next steerable dispatch is diverted to
        it.  The ack carries the queue depths and the membership
        generation; a request under a stale generation is fenced (the
        thief re-syncs from the ack and asks again)."""
        thief = int(p.get("thief", src))
        with self._lock:
            gen = self.group.gen
        depths = self._queue_depths()
        if int(p.get("gen", -1)) != gen:
            if _san.active():
                _san.get().record(
                    "PHY106",
                    f"steal_request from locality {thief} under stale "
                    f"membership generation {p.get('gen')} "
                    f"(current {gen})",
                    once_key=f"reqgen:{thief}:{p.get('gen')}")
            return {"handed": 0, "stale": True, "gen": gen,
                    "depths": depths}
        rec = self._steal_local(thief)
        if rec is not None:
            try:
                self._send_spawn(rec)
            except BaseException as e:  # noqa: BLE001 - never strand it
                self._finish(rec, exc=e)
                return {"handed": 0, "gen": gen, "depths": depths}
            return {"handed": 1, "gen": gen, "depths": depths}
        victim = self._pick_victim(thief)
        if victim is not None:
            try:
                self.endpoint.post(victim, "steal_lease",
                                   {"thief": thief, "gen": gen})
                return {"handed": 0, "leased": victim, "gen": gen,
                        "depths": depths}
            except PeerLostError:
                pass
        with self._lock:
            if thief not in self._hungry:
                self._hungry.append(thief)
        return {"handed": 0, "parked": True, "gen": gen, "depths": depths}

    def _on_steal_handoff(self, src: int, p: dict):
        """A victim released a leased task: re-own and re-spawn it - on
        the thief when the lease is current, on any live locality
        otherwise (the victim already cancelled its copy, so the task MUST
        re-spawn exactly once from the driver's payload).  The record lock
        serializes this with a concurrent peer-loss re-spawn; a lease for
        a record that already moved or finished is refused - the
        authoritative copy is elsewhere."""
        tid, thief = p["tid"], int(p["thief"])
        gen = int(p.get("gen", -1))
        with self._lock:
            rec = self._outstanding.get(tid)
            cur = self.group.gen
        if rec is None:
            return          # settled while the handoff was in flight
        with rec.lock:
            if rec.promise.done():
                return
            if not rec.sent or rec.target != src:
                # the record moved while the lease was in flight (a
                # peer-loss re-spawn won the race): refusing keeps
                # execution at exactly one locality
                if _san.active():
                    _san.get().record(
                        "PHY106",
                        f"steal handoff for {tid} from locality {src} "
                        f"refused: the record "
                        + ("was never dispatched" if not rec.sent else
                           f"is owned by locality {rec.target}")
                        + " (lease raced a re-spawn)",
                        once_key=f"handoff:{tid}")
                return
            rec.sent = False
            alive = set(self.group.alive_workers())
            if gen == cur and thief in alive:
                rec.target = thief
                rec.stolen = True
            else:
                # a stale lease generation (membership changed mid-steal)
                # or a dead thief: fence the steal but never strand the
                # task - the victim's copy is already cancelled
                if _san.active():
                    _san.get().record(
                        "PHY106",
                        f"steal of {tid} fenced: "
                        + (f"lease generation {gen} != membership "
                           f"generation {cur}" if gen != cur
                           else f"thief locality {thief} is dead"),
                        once_key=f"fence:{tid}")
                rec.target = self._fallback(rec.lane)
        try:
            self._send_spawn(rec)
        except BaseException as e:  # noqa: BLE001 - never strand it
            self._finish(rec, exc=e)

    # -- locality-owned checkpoints (DESIGN.md §10) ---------------------------
    def account_ckpt_leaf_bytes(self, n: int):
        """Record ``n`` checkpoint leaf bytes about to ship to their owner
        in a shard write's payload."""
        with self._lock:
            self.ckpt_leaf_wire_bytes += int(n)

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

    # -- SPMD mode (DESIGN.md §10) ---------------------------------------------
    def spmd_train(self, spec: dict, ranks=None):
        """Start the SPMD shadow train loop (``frontend.spmd``) on every
        alive worker locality: each mirrors the driver's device
        computation in lockstep and writes its own checkpoint segments
        (``checkpoint.spmd.write_spmd_shard``).

        Args:
            spec: picklable dict - ``plan``, ``steps``, ``ckpt_every``,
                ``ckpt_dir``, ``resume``, ``stream`` and ``num_threads``
                (the driver's CPU thread count, so that CPU float32 sums
                run in the same order in every process).
            ranks: the workers to start it on (None: every alive one);
                ``wait_spmd_done`` then waits for these alone.
        """
        with self._lock:
            self._spmd_done.clear()    # completions are per-run
            self._spmd_ranks = None if ranks is None else set(ranks)
        for rank in self.group.alive_workers():
            if ranks is not None and rank not in ranks:
                continue
            try:
                self.endpoint.post(rank, "spmd_train", spec)
            except PeerLostError:      # died since alive_workers(): its
                pass                   # entry promises poison via peer loss

    def spmd_entry_futures(self, step: int, ranks) -> list[PhyFuture]:
        """One promise per other process of the world for its shard
        manifest entry of ``step`` - the metadata-only return channel of
        an SPMD save.  A promise for an already-dead locality (or one whose
        locality dies before posting) is poisoned with
        ``LocalityLostError``: its bytes exist nowhere else, so the save
        must abort, never commit.

        Args:
            step: the save's step number.
            ranks: the non-driver process ranks expected to write.
        Returns:
            List of ``PhyFuture`` resolving to the entries (or None for
            a rank that had nothing to write).
        """
        out = []
        for r in ranks:
            key = (int(step), int(r))
            p = self._graph.promise(name=f"ckpt:entry{r}:{step}",
                                    lane=Lane.CHECKPOINT,
                                    producer=f"L{r}")
            settle = None
            with self._lock:
                done = self._spmd_done.get(int(r))
                if key in self._spmd_entries and not isinstance(
                        self._spmd_entries[key], PhyFuture):
                    settle = ("value", self._spmd_entries.pop(key))
                elif r != 0 and r not in self.group.alive_workers():
                    settle = ("lost", f"locality {r} is not alive")
                elif done is not None and not done.get("ok"):
                    # the shadow ALREADY failed on a live worker: this
                    # entry will never be posted
                    settle = ("lost", f"SPMD shadow on locality {r} "
                                      f"failed: {done.get('error')}")
                else:
                    self._spmd_entries[key] = p
            if settle is None:
                pass
            elif settle[0] == "value":
                p.set_result(settle[1])
            else:
                p.set_exception(LocalityLostError(
                    f"ckpt entry for step {step}: {settle[1]}; its "
                    f"segments exist nowhere else - SPMD save aborted"))
            out.append(p)
        return out

    def _on_ckpt_entries(self, src: int, msg: dict):
        key = (int(msg["step"]), int(msg["rank"]))
        with self._lock:
            cur = self._spmd_entries.get(key)
            if isinstance(cur, PhyFuture):
                del self._spmd_entries[key]
            else:                    # worker ahead of the driver: buffer
                self._spmd_entries[key] = msg["entry"]
                cur = None
        if cur is not None:
            cur.set_result(msg["entry"])

    def _on_spmd_done(self, src: int, msg: dict):
        with self._lock:
            self._spmd_done[int(msg["rank"])] = msg
            self._lock.notify_all()
        if not msg.get("ok"):
            # the shadow died: entries it still owes will never arrive
            self._poison_spmd_entries(
                int(msg["rank"]),
                f"SPMD shadow on locality {msg['rank']} failed: "
                f"{msg.get('error')}")

    def _poison_spmd_entries(self, rank: int, reason: str):
        with self._lock:
            pend = [(k, v) for k, v in self._spmd_entries.items()
                    if k[1] == rank and isinstance(v, PhyFuture)]
            for k, _ in pend:
                del self._spmd_entries[k]
        for _, p in pend:
            p.set_exception(LocalityLostError(reason))

    def wait_spmd_done(self, timeout: float = 600.0) -> dict:
        """Block until every *alive* worker's shadow train loop reported
        completion (a killed worker is excused - its saves aborted), of
        the workers ``spmd_train`` started it on.

        Returns:
            ``{rank: done message}`` as received, each with ``ok`` and,
            from a shadow that ran, ``step``, ``final_loss``,
            ``launches`` and ``diagnostics`` (the port's additions).
        Raises:
            TimeoutError: an alive worker's shadow did not finish.
        """
        deadline = time.monotonic() + timeout

        def ready():
            alive = set(self.group.alive_workers())
            if self._spmd_ranks is not None:
                alive &= self._spmd_ranks
            return all(r in self._spmd_done for r in alive)

        with self._lock:
            ok = self._lock.wait_for(
                ready, timeout=max(0.0, deadline - time.monotonic()))
            done = dict(self._spmd_done)
        if not ok:
            raise TimeoutError("SPMD shadow train loops still running "
                               f"after {timeout}s")
        return done

    # -- wire handlers --------------------------------------------------------
    def _on_task_done(self, src: int, msg: dict):
        with self._lock:
            rec = self._outstanding.get(msg["tid"])
        if rec is None:
            return                           # cancelled/re-spawned: stale
        status = msg["status"]
        if status == "ok" and rec.sent and src != rec.target:
            # a completion from a locality that no longer owns the record
            # means the task ran somewhere the driver had moved it away
            # from - the exactly-once invariant broke (PHY106).  The
            # result is still good: settle with it (the owning copy's
            # duplicate spawn was dropped on arrival).
            if _san.active():
                _san.get().record(
                    "PHY106",
                    f"task {msg['tid']} ({rec.name}) completed on "
                    f"locality {src} but the record is owned by locality "
                    f"{rec.target} - steal-lease violation",
                    once_key=f"done:{msg['tid']}")
        if status == "ok":
            self._finish(rec, value=msg["value"])
        elif status == "cancelled":
            self._finish(rec, exc=CancelledError(rec.name), cancelled=True)
        else:
            self._finish(rec, exc=msg["exc"])

    def _on_peer_lost(self, rank: int):
        self.group.note_lost(rank)
        if self.elastic:
            # membership changed: bump the generation and gossip the
            # leave, so steals planned against the old peer table fence
            # instead of landing on (or crediting) a ghost
            with self._lock:
                self.group.gen += 1
                gen = self.group.gen
                self._hungry = collections.deque(
                    r for r in self._hungry if r != rank)
            for r in self.group.alive_workers():
                try:
                    self.endpoint.post(r, "peer_joined",
                                       {"rank": rank, "event": "left",
                                        "gen": gen})
                except PeerLostError:
                    continue
        if self.grad_ring.active:
            # a DDP exchange is in flight: poison it everywhere - a
            # survivor with no direct connection to the dead rank never
            # observes the loss itself
            self.ddp_abort(f"locality {rank} died mid-all-reduce")
        # SPMD shard entries die with their writer: poison, never re-spawn
        self._poison_spmd_entries(
            rank, f"locality {rank} died before shipping its shard "
                  f"entry; its segments exist nowhere else - SPMD save "
                  f"aborted")
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
        outstanding tasks, wire bytes and the elastic counters."""
        with self._lock:
            return {"dispatched": dict(self.dispatched),
                    "respawned": self.respawned,
                    "outstanding": len(self._outstanding),
                    "alive_workers": self.group.alive_workers(),
                    "bytes_sent": self.endpoint.bytes_sent,
                    "bytes_recv": self.endpoint.bytes_recv,
                    "ckpt_leaf_wire_bytes": self.ckpt_leaf_wire_bytes,
                    "grad_wire_bytes": self.grad_wire_bytes,
                    "stolen_tasks": self.stolen_tasks,
                    "migrated_objects": self.migrated_objects,
                    "joined_localities": self.joined,
                    "membership_gen": self.group.gen,
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
            entry_pend = [(k, v) for k, v in self._spmd_entries.items()
                          if isinstance(v, PhyFuture)]
            self._spmd_entries.clear()
        for rec in stranded:
            self._finish(rec, exc=LocalityLostError(
                f"{rec.name}: distributed graph shut down"))
        for k, p in entry_pend:        # an unresolved promise would hang
            p.set_exception(LocalityLostError(  # the graph's barrier
                f"ckpt entry for step {k[0]}: distributed graph shut "
                f"down"))
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
