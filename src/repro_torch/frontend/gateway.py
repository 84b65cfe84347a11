"""Serving gateway: async continuous batching over the futurized runtime.

Counterpart: ``repro/frontend/gateway.py`` (``RequestHandle``,
``RequestQueue``, ``ReplicaRouter``, ``_Replica``, ``Gateway``), with the
same statuses, node names, lanes, counters and run summary.
``Session.serve`` drains a fixed request list in synchronized waves; the
gateway instead takes requests as node chains arriving mid-flight:

  * ``RequestQueue`` accepts arrivals while the gateway is decoding; each
    ``submit`` returns a ``RequestHandle`` the caller can block on or
    cancel.  Deterministic traces (``at_round``-tagged submissions) drive
    the tests; live threads drive real streams.
  * Admission control: at most ``max_inflight`` requests hold resources
    (queued requests wait; a full queue rejects); a request whose deadline
    expires before it reaches a slot is cancelled cleanly.
  * A request prefills once, at admission, in its own ``prefill:r{i}``
    node (batch 1); its KV/conv/SSM decode state parks on the host in the
    paged ``core.paging.InferenceCache`` until a slot frees up.  Slot
    refill (``refill:e{k}``) loads pages instead of recomputing, so the
    page-hit counter equals the refill counter.
  * The continuous batch decodes with per-slot positions (a ``[slots]``
    int64 tensor on the device), so co-tenants at different offsets share
    one decode step.  Every decode round is a node (``decode:e{k}:t{j}``),
    its token fan-out a chained CHECKPOINT ``emit`` node, and each
    request's completion a ``finish:r{i}`` node resolving the
    ``request:r{i}`` promise.

Graph shape per request i (epoch k = one slot-membership period)::

    stack:r{i} --> prefill:r{i} --\\
    ... decode:e{k-1}:t{J} --------> refill:e{k} -> decode:e{k}:t0 -> ...
                                          decode:e{k}:t{j} -> emit:e{k}:t{j}
    emit chain (prev emit -> next emit) ... -> finish:r{i} => request:r{i}

With ``replicas=N`` the gateway drives N model replicas, each with its
own decode chain, slot accounting and named ``InferenceCache`` over one
shared ``PagePool``; a ``ReplicaRouter`` assigns every admitted request to
one replica (page affinity first, then least loaded, ties to the lowest
index).  Epoch-scoped nodes are namespaced (``refill:R1:e{k}``...).  When
a replica dies (``kill_replica`` or ``kill_replica_at_round``), its
requests migrate to the survivors, whose refill adopts the dead replica's
pages (a counted ``cross_replica_page_fetches``): prefill never reruns.
With a ``distributed`` runtime (``Session.serve_stream`` at
``localities > 1``) each replica has a *home* locality: its requests'
host-side ``stack`` prep runs there, placed by ``DistributedGraph``
(homes cycle over the live workers, then the driver), and a replica whose
home dies is retired and its requests migrate to the survivors, as in a
drill.  The model itself runs on the session's device in this process,
as the reference's runs on the driver's devices: only the prompt's numpy
array crosses the wire.

The port's decode step updates the cache it is given in place (it stands
in for JAX's buffer donation), so the refill and decode nodes of a replica
form one chain and no node keeps a cache it passed on.  Token streams are
bit-identical across co-tenancy and replica counts: prefill is batch 1 and
decode is row-independent (masked per-row cache writes, per-row masks and
greedy tokens), so a request's stream depends only on its prompt.

On a mesh (``Session.serve_stream`` of a mesh session) the gateway runs
on rank 0 with its control flow unchanged, as the reference's runs on one
controller (``repro/frontend/gateway.py:370-600``, which parks host
arrays and ``device_put``s the refilled carry to the decode step's
shardings).  Its device bodies (``DeviceBodies``: the batch-1 prefill,
the refill's fresh carry and row writes, the decode round, the page
drops) go through a ``lockstep`` (``frontend/mesh.Lockstep``) that first
sends each body's command to the other ranks, which run the same body on
their blocks (``frontend/mesh.rank_serve_stream``).  Each rank parks the
blocks of a request's state that the decode cache tiles onto it along
every dim but ``batch`` (a request's slot, so its dp rank, is chosen only
at refill), decodes its rows of the batch and gathers the greedy tokens
of every row over the dp group, so that rank 0 emits every row.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import CancelledError
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.futures import FuturizedGraph, Lane
from ..core.paging import InferenceCache, PagePool
from ..core.sharding import init_params, is_spec

__all__ = ["DeadlineExpired", "DeviceBodies", "Gateway", "ReplicaRouter",
           "RequestHandle", "RequestQueue", "RequestRejected"]


class RequestRejected(RuntimeError):
    """Admission control refused the request (queue at capacity)."""


class DeadlineExpired(TimeoutError):
    """The request's deadline passed before it reached a decode slot."""


def _stack_request(prompt):
    """Host prep of one request's prompt."""
    return np.asarray(prompt, np.int64)


class RequestHandle:
    """One request's client-side view: token stream, status, cancel.

    Statuses: ``queued`` -> ``rejected`` | ``admitted`` -> ``active`` ->
    ``done`` | ``cancelled`` | ``expired`` | ``failed``.  ``tokens`` is
    the prefill token plus one token per decode round the request was
    resident for; ``result()`` blocks for the terminal state.
    """

    def __init__(self, rid: str, prompt, *, at_round: int = 0,
                 deadline_ms: Optional[float] = None,
                 cancel_after: Optional[int] = None,
                 inject: Optional[str] = None):
        self.rid = rid
        self.prompt = prompt
        self.at_round = int(at_round)
        self.deadline_s = None if deadline_ms is None else deadline_ms / 1e3
        self.cancel_after = cancel_after
        self.inject = inject
        self.status = "queued"
        self.tokens: list[int] = []
        self.submit_t = time.perf_counter()
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None
        self._cancel_requested = False
        self._last_t: Optional[float] = None    # previous token's emit time
        self._emitted = 0                       # decode rounds built for it
        self._slot: Optional[int] = None
        self._promise = None                    # request:{rid} graph node
        self._stack = None
        self._prefill = None
        self._first: Optional[int] = None       # prefill token
        self._prefill_forced = False            # first token already appended
        self._replica: Optional[int] = None     # routed replica index

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> list[int]:
        """Block for the terminal state; the token stream on success,
        else the failure (``DeadlineExpired`` / ``CancelledError`` /
        ``RequestRejected`` / the poisoning exception)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight")
        if self._exc is not None:
            raise self._exc
        return list(self.tokens)

    def cancel(self):
        """Ask the gateway to drop this request (client disconnect); it
        takes effect at the next round boundary, wherever the request is
        in its lifecycle."""
        self._cancel_requested = True

    def __repr__(self):
        return (f"<RequestHandle {self.rid} {self.status} "
                f"tokens={len(self.tokens)}>")


class RequestQueue:
    """Thread-safe arrival stream feeding a ``Gateway``.

    ``submit`` may be called from any thread while the gateway runs; a
    trace-driven run pre-submits ``at_round``-tagged requests and calls
    ``close()``.  With ``max_queue`` set, submissions beyond the backlog
    cap are rejected (the handle terminates with ``RequestRejected``).
    """

    def __init__(self, max_queue: Optional[int] = None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._items: collections.deque[RequestHandle] = collections.deque()
        self._ids = itertools.count()
        self.max_queue = max_queue
        self.closed = False
        self.submitted = 0
        self.rejected = 0

    def submit(self, prompt, *, at_round: int = 0,
               deadline_ms: Optional[float] = None,
               cancel_after: Optional[int] = None,
               inject: Optional[str] = None) -> RequestHandle:
        """Enqueue one request; returns its handle (already terminal with
        ``RequestRejected`` when the backlog is full or the queue
        closed)."""
        with self._cv:
            rid = f"r{next(self._ids)}"
            h = RequestHandle(rid, prompt, at_round=at_round,
                              deadline_ms=deadline_ms,
                              cancel_after=cancel_after, inject=inject)
            if self.closed or (self.max_queue is not None
                               and len(self._items) >= self.max_queue):
                why = ("queue closed" if self.closed
                       else f"backlog at capacity {self.max_queue}")
                h.status = "rejected"
                h._exc = RequestRejected(f"{rid}: {why}")
                h._done.set()
                self.rejected += 1
                return h
            self.submitted += 1
            self._items.append(h)
            self._cv.notify_all()
            return h

    def close(self):
        """No further submissions; the gateway drains what is queued and
        returns once everything in flight is terminal."""
        with self._cv:
            self.closed = True
            self._cv.notify_all()

    # -- gateway side --------------------------------------------------------
    def take_ready(self, round_: int) -> list[RequestHandle]:
        """Pop every queued handle whose ``at_round`` has arrived, in
        submission order."""
        with self._lock:
            ready = [h for h in self._items if h.at_round <= round_]
            for h in ready:
                self._items.remove(h)
            return ready

    def next_round(self) -> Optional[int]:
        """The earliest ``at_round`` still queued (trace fast-forward)."""
        with self._lock:
            return min((h.at_round for h in self._items), default=None)

    def drained(self) -> bool:
        """Closed and empty, checked atomically: the gateway's only exit
        test.  A ``submit`` racing ``close()`` either lands in the backlog
        before the close or is rejected by ``submit``; a closed-then-empty
        check in two steps could miss the racing item and strand its
        handle in ``queued``."""
        with self._lock:
            return self.closed and not self._items

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        """Block for a submission or ``close()`` (``timeout=None`` waits
        indefinitely: the idle gateway parks here, and ``submit``/``close``
        notify the condition variable)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._items or self.closed, timeout)


class ReplicaRouter:
    """Pure routing state for the replica pool (no tensors, no threads).

    Rules:

      * **Affinity.**  A request already assigned to a live replica stays
        there: its prefill state is parked in that replica's pages.
        ``assign`` on a routed rid is therefore idempotent across
        retire/refill.
      * **Least loaded.**  A new request goes to the live replica with
        the fewest routed requests, ties to the lowest index.
      * **Death.**  ``kill`` marks a replica dead and returns its routed
        rids (in routing order) for re-assignment; a request is never
        assigned to two replicas at once and never stranded while any
        replica is alive (``assign`` raises only on an empty pool).
    """

    def __init__(self, replicas: int):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.replicas = replicas
        self.live: set[int] = set(range(replicas))
        self.assignment: dict[str, int] = {}

    def load(self, replica: int) -> int:
        """Requests currently routed to ``replica``."""
        return sum(1 for r in self.assignment.values() if r == replica)

    def assign(self, rid: str) -> int:
        """Route ``rid`` (idempotent while its replica is alive)."""
        cur = self.assignment.get(rid)
        if cur is not None and cur in self.live:
            return cur                       # page affinity: stay put
        if not self.live:
            raise RuntimeError("no live replicas to route to")
        r = min(self.live, key=lambda i: (self.load(i), i))
        self.assignment[rid] = r
        return r

    def release(self, rid: str):
        """Forget a terminal request's routing."""
        self.assignment.pop(rid, None)

    def kill(self, replica: int) -> list[str]:
        """Mark ``replica`` dead; its routed rids, in routing order,
        ready to be re-``assign``-ed to survivors."""
        self.live.discard(replica)
        return [rid for rid, r in self.assignment.items() if r == replica]

    def revive(self, replica: int):
        """Return a replica to the live pool."""
        if not 0 <= replica < self.replicas:
            raise ValueError(f"unknown replica {replica}")
        self.live.add(replica)


class _Replica:
    """State of one serve replica: its own named page cache (over the
    gateway's shared pool), admitted queue, slot residents and decode
    chain.  ``ns`` prefixes epoch-scoped node names so N decode chains
    coexist in one graph (empty for a single-replica gateway)."""

    def __init__(self, idx: int, home: int, slots: int, pool: PagePool,
                 namespaced: bool):
        self.idx = idx
        self.home = home                    # host locality rank (0=driver)
        self.alive = True
        self.ns = f"R{idx}:" if namespaced else ""
        self.icache = InferenceCache(pool,
                                     name=f"R{idx}" if namespaced else "")
        self.admitted: collections.deque = collections.deque()
        self.residents: list[Optional[RequestHandle]] = [None] * slots
        self.carry = None                   # decode chain carry future
        self.prev_emit = None               # emit chain tail
        self.emit_hist: collections.deque = collections.deque()
        self.epoch = -1
        self.j = 0
        self.round_work = (False, [])       # (changed, joiners) this round

    def has_residents(self) -> bool:
        return any(r is not None for r in self.residents)


def _write_rows(carry, state, specs, slot: int):
    """Copy batch row 0 of every leaf of ``state`` into batch row ``slot``
    of the same leaf of ``carry``, in place; each leaf's batch dim is its
    spec's ``"batch"`` dim."""
    if is_spec(specs):
        ax = specs.dims.index("batch")
        carry.select(ax, slot).copy_(state.select(ax, 0))
    elif isinstance(specs, dict):
        for k, sp in specs.items():
            _write_rows(carry[k], state[k], sp, slot)
    else:
        for c, s, sp in zip(carry, state, specs):
            _write_rows(c, s, sp, slot)


def _adopt(cache: InferenceCache, others, rid: str):
    """``rid``'s parked state from ``cache``, or else moved into it from the
    first of ``others`` that holds it (a request that migrated off a dead
    replica): (the state or None, whether it was moved)."""
    state = cache.get(rid)
    if state is not None:
        return state, False
    for other in others:
        if rid in other:
            other.transfer(rid, cache)
            return cache.get(rid), True
    return None, False


class DeviceBodies:
    """The gateway's device bodies on one rank's blocks: the batch-1
    prefill ``pre`` (whose cache is tiled as ``dec``'s along every dim
    but ``batch``), and the ``slots``-wide decode ``dec`` on this rank's
    ``rows`` of the batch (every row in one process).  The carry is
    ``(tok, cache)``: every slot's token ``[slots, 1]``, this rank's
    cache blocks."""

    def __init__(self, pre, dec, params, device, slots: int):
        self.pre, self.dec, self.params = pre, dec, params
        self.device = torch.device(device)
        self.slots = slots
        self.rows = dec.rows

    def prefill(self, prompt):
        """Batch-1 prefill of one prompt: (first token, decode state on
        the device)."""
        toks = torch.from_numpy(np.asarray(prompt, np.int64))[None, :]
        logits, cache1 = self.pre.fn(self.params,
                                     {"tokens": toks.to(self.device)})
        return int(self.pre.greedy(logits)[0]), cache1

    @staticmethod
    def park(state):
        """A prefill's decode state as host tensors, for the pages."""
        return pytree.tree_map(lambda t: t.cpu(), state)

    def fresh_carry(self):
        cache = init_params(self.dec.cache_specs, None, self.device)
        tok = torch.zeros((self.slots, 1), dtype=torch.int64,
                          device=self.device)
        return tok, cache

    def write_row(self, cache, state, slot: int):
        """A parked state into slot ``slot`` of the carry's cache, where
        that slot is one of this rank's rows."""
        if self.rows.start <= slot < self.rows.stop:
            _write_rows(cache, state, self.dec.cache_specs,
                        slot - self.rows.start)

    def decode(self, carry, pos):
        """One decode round of this rank's rows at per-slot positions
        ``pos`` (int64 ``[slots]``): (every slot's greedy token, the
        cache)."""
        tok, cache = carry
        r = self.rows
        pos = torch.from_numpy(pos[r]).to(self.device, non_blocking=True)
        logits, cache = self.dec.fn(self.params, cache, {"tokens": tok[r]},
                                    pos)
        return self.dec.gather_rows(self.dec.greedy(logits)[:, None]), cache


class Gateway:
    """The continuous-batching loop (one ``run()`` per instance).

    Owns the shared ``PagePool`` (one named ``InferenceCache`` per
    replica), the ``ReplicaRouter``, the request registry and the
    fault/tombstone accounting; emits every admission/cache counter and
    per-request latency histogram into ``runtime.stats()`` via
    ``record_serve`` (per-replica split included).  Built by
    ``Session.serve_stream``, which supplies the batch-1 prefill step and
    the ``slots``-wide decode step, both shared across replicas (same
    shapes, same parameters: that is what keeps N-replica streams
    bit-identical to one replica).  ``replicas``/``homes`` place each
    replica's host-side request prep (``stack`` nodes) on its home
    locality through ``distributed`` (a ``distrib.DistributedGraph``);
    homes default to cycling over the live worker ranks, then the driver.
    ``kill_replica_at_round`` is the deterministic replica-death drill;
    ``kill_replica()`` is the live one.  ``lockstep`` (rank 0 of a mesh)
    runs every device body after sending its command to the other ranks.

    Raises:
        ValueError: ``gen_len`` or ``replicas`` below 1, or ``homes`` not
            one locality per replica.
    """

    def __init__(self, runtime: FuturizedGraph, *, distributed=None,
                 prefill_step, decode_step, params, prompt_len: int,
                 gen_len: int, slots: int, device,
                 max_inflight: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 page_bytes: int = 1 << 16, lookahead: int = 2,
                 replicas: int = 1, homes: Optional[list[int]] = None,
                 kill_replica_at_round: Optional[tuple] = None,
                 lockstep=None):
        if gen_len < 1:
            raise ValueError("gen_len must be >= 1")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.runtime = runtime
        self.distributed = distributed
        self.pre = prefill_step
        self.dec = decode_step
        self.params = params
        self.device = torch.device(device)
        self.lockstep = lockstep
        self.bodies = DeviceBodies(prefill_step, decode_step, params,
                                   device, slots)
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.slots = slots
        self.max_inflight = max(1, max_inflight if max_inflight is not None
                                else 2 * slots * replicas)
        self.default_deadline_s = (None if deadline_ms is None
                                   else deadline_ms / 1e3)
        self.lookahead = max(1, lookahead)
        if homes is None:
            homes = self._default_homes(replicas)
        elif len(homes) != replicas:
            raise ValueError(f"homes={homes} must name one locality per "
                             f"replica ({replicas})")
        self.pool = PagePool(page_bytes)
        self.replicas = [_Replica(i, homes[i], slots, self.pool,
                                  namespaced=replicas > 1)
                         for i in range(replicas)]
        self.router = ReplicaRouter(replicas)
        self._lock = threading.Lock()
        self._handles: dict[str, RequestHandle] = {}
        self._tombstones: set[str] = set()
        self._killed: set[int] = set()      # kill_replica() drill marks
        self._kill_at = (tuple(kill_replica_at_round)
                         if kill_replica_at_round is not None else None)

    def _default_homes(self, replicas: int) -> list[int]:
        """Cycle replicas over the live worker localities, then the
        driver: with 2 replicas on 2 localities, killing the worker kills
        exactly replica 0 and the driver-homed replica survives.  A single
        replica (or a single-process run) stays on the driver."""
        if self.distributed is None or replicas == 1:
            return [0] * replicas
        workers = [r for r in self.distributed.alive_localities() if r != 0]
        ranks = workers + [0] if workers else [0]
        return [ranks[i % len(ranks)] for i in range(replicas)]

    # -- request lifecycle ---------------------------------------------------
    def _register(self, h: RequestHandle):
        # the request's graph-visible terminal: a producer-backed promise
        # the finish node resolves
        h._promise = self.runtime.promise(name=f"request:{h.rid}",
                                          lane=Lane.CHECKPOINT,
                                          producer="gateway")
        with self._lock:
            self._handles[h.rid] = h

    def _admit(self, h: RequestHandle) -> _Replica:
        """Route to a replica, then launch the request's prefill chain;
        its ``stack`` prep is pinned to the replica's home locality."""
        h._replica = self.router.assign(h.rid)
        rep = self.replicas[h._replica]
        if self.distributed is not None:
            pin = rep.home if len(self.replicas) > 1 else None
            try:
                h._stack = self.distributed.defer(
                    _stack_request, h.prompt, lane=Lane.PREFETCH,
                    name=f"stack:{h.rid}", locality=pin)
            except ValueError:
                # the home died between the liveness sweep and this defer:
                # place anywhere; the next sweep migrates the replica
                h._stack = self.distributed.defer(
                    _stack_request, h.prompt, lane=Lane.PREFETCH,
                    name=f"stack:{h.rid}")
        else:
            h._stack = self.runtime.defer(_stack_request, h.prompt,
                                          lane=Lane.PREFETCH,
                                          name=f"stack:{h.rid}")
        h._prefill = self.runtime.defer(self._prefill_fn(h), h._stack,
                                        name=f"prefill:{h.rid}")
        h.status = "admitted"
        self.runtime.record_serve(admitted=1, replica=h._replica)
        return rep


    def _on_device(self, cmd: tuple, body, *args):
        """Run a device body; on a mesh, after sending its command to the
        other ranks (``lockstep``)."""
        if self.lockstep is None:
            return body(*args)
        return self.lockstep.run(cmd, body, *args)

    def _prefill_once(self, prompt, rid: Optional[str] = None,
                      replica: Optional[int] = None):
        """Batch-1 prefill of one prompt: (first token, decode state on the
        device)."""
        return self._on_device(("prefill", rid, replica,
                                np.asarray(prompt)),
                               self.bodies.prefill, prompt)

    def _prefill_fn(self, h: RequestHandle):
        def prefill(arr):
            t0 = time.perf_counter()
            self.runtime.record_serve(phase="queue_wait",
                                      dt_s=t0 - h.submit_t)
            if h.inject == "poison-prefill":
                raise RuntimeError(f"injected prefill poison on {h.rid}")
            first, cache1 = self._prefill_once(arr, h.rid, h._replica)
            state = self.bodies.park(cache1)
            self.runtime.record_serve(phase="prefill",
                                      dt_s=time.perf_counter() - t0)
            with self._lock:
                if h.rid in self._tombstones:   # dropped while running:
                    return first                 # park nothing, leak nothing
                # park into the request's *current* replica: a migration
                # mid-prefill parks into the old cache and the new
                # replica's refill adopts the pages cross-replica
                self.replicas[h._replica].icache.put(h.rid, state)
                h._last_t = time.perf_counter()
            return first
        return prefill

    def _drop_pages(self, rid: str):
        """Free ``rid``'s pages wherever they are parked (a migrated
        request's pages may sit in its old replica's cache), on every
        rank."""
        self._on_device(("drop", rid), self._drop_local, rid)

    def _drop_local(self, rid: str):
        for rep in self.replicas:
            if rid in rep.icache:
                rep.icache.drop(rid)

    def _resolve(self, h: RequestHandle, status: str,
                 exc: Optional[BaseException], counter: str):
        with self._lock:
            if h._done.is_set():
                return
            h.status = status
            h._exc = exc
            if h._promise is not None:
                if exc is None:
                    h._promise.set_result(list(h.tokens))
                else:
                    h._promise.set_exception(
                        exc, cancelled=isinstance(exc, CancelledError))
            h._done.set()
        # pages are retained until the request is terminal (migration
        # replays decode from the parked state); reclaim is here, total
        self._drop_pages(h.rid)
        self.runtime.record_serve(**{counter: 1})

    def _kill_admitted(self, h: RequestHandle, exc: BaseException,
                       status: str, counter: str):
        """Reclaim an admitted-but-not-resident request: cancel its chain
        if possible, tombstone it against a racing ``put``, and free any
        pages it already parked."""
        if h._stack is not None:
            h._stack.cancel()
        if h._prefill is not None and not h._prefill.cancel():
            # running or already terminal: observe it, so that a poison is
            # not re-raised at close
            h._prefill.add_done_callback(lambda f: None)
        with self._lock:
            self._tombstones.add(h.rid)
        self._drop_pages(h.rid)
        self._resolve(h, status, exc, counter)

    def _expired(self, h: RequestHandle, now: float) -> bool:
        deadline = (h.deadline_s if h.deadline_s is not None
                    else self.default_deadline_s)
        return deadline is not None and now - h.submit_t >= deadline

    def _force_prefill(self, h: RequestHandle) -> bool:
        """Block for the request's prefill before giving it a slot; on
        failure (poison, upstream cancel) reclaim and report False.
        Idempotent on the token stream: a migrated request re-joining a
        surviving replica's slot does not re-append its first token."""
        try:
            h._first = h._prefill.result()
        except BaseException as e:  # noqa: BLE001 - resolved into the handle
            cancelled = isinstance(e, CancelledError)
            self._kill_admitted(h, e,
                                "cancelled" if cancelled else "failed",
                                "cancelled" if cancelled else "failed")
            return False
        if not h._prefill_forced:
            h._prefill_forced = True
            with self._lock:
                h.tokens.append(h._first)
        return True

    # -- device-side node bodies --------------------------------------------
    def _recompute(self, rid: str):
        """Paged-cache miss fallback: rerun the prefill.  Never taken when
        the page accounting holds: the tests assert its counter is 0."""
        first, cache1 = self.bodies.prefill(self._handles[rid].prompt)
        return cache1, first

    def _refill_fn(self, rep: _Replica, joins: tuple):
        def refill(carry, *firsts):
            cmd = ("refill", rep.idx, carry is None,
                   tuple((slot, rid, int(first))
                         for (slot, rid), first in zip(joins, firsts)))
            return self._on_device(cmd, self._refill, rep, joins, carry,
                                   firsts)
        return refill

    def _refill(self, rep: _Replica, joins: tuple, carry, firsts):
        tok, cache = carry if carry is not None \
            else self.bodies.fresh_carry()
        # a new token tensor: the emit node of the round that made
        # ``tok`` may not have read it yet
        tok = tok.clone()
        for (slot, rid), first in zip(joins, firsts):
            with self._lock:
                # the pages may be parked under another replica (this
                # request migrated off a dead one): adopt them - a fetch,
                # never a recompute
                state, fetched = _adopt(rep.icache, [
                    o.icache for o in self.replicas if o is not rep], rid)
            if fetched:
                self.runtime.record_serve(cross_replica_page_fetches=1,
                                          replica=rep.idx)
            if state is None:
                self.runtime.record_serve(prefill_recompute=1,
                                          replica=rep.idx)
                state, first = self._recompute(rid)
            else:
                self.runtime.record_serve(page_hits=1, replica=rep.idx)
            # in place: the carry is this chain's own (the decode step
            # that returned it has handed it on)
            self.bodies.write_row(cache, state, slot)
            tok[slot, 0] = first
            self.runtime.record_serve(refills=1, replica=rep.idx)
        return tok, cache

    def _decode_fn(self, rep: _Replica):
        def decode(carry, pos):
            return self._on_device(("decode", rep.idx, pos),
                                   self.bodies.decode, carry, pos)
        return decode

    def _emit_fn(self, rep: _Replica, live_rows: tuple):
        def emit(carry, *_prev_emit):
            tokv = carry[0][:, 0].tolist()  # waits for the decode round
            now = time.perf_counter()
            with self._lock:
                for slot, rid in live_rows:
                    h = self._handles[rid]
                    if h._replica != rep.idx:   # migrated off mid-round:
                        continue                 # the token is stale
                    h.tokens.append(int(tokv[slot]))
                    if h._last_t is not None:
                        self.runtime.record_serve(
                            phase="decode_token", dt_s=now - h._last_t)
                    h._last_t = now
            self.runtime.record_serve(
                real_tokens=len(live_rows),
                padded_slot_tokens=self.slots - len(live_rows),
                replica=rep.idx)
        return emit

    def _finish_fn(self, h: RequestHandle, cancelled: bool):
        def finish(_emit_val):
            self.runtime.record_serve(
                phase="total", dt_s=time.perf_counter() - h.submit_t)
            if cancelled:
                self._resolve(h, "cancelled", CancelledError(h.rid),
                              "cancelled")
            else:
                self._resolve(h, "done", None, "completed")
        return finish

    # -- replica liveness ----------------------------------------------------
    def kill_replica(self, idx: int):
        """Drill seam: mark replica ``idx`` dead; the next round's liveness
        sweep retires it and migrates its requests to the survivors.
        Thread-safe (a feeder thread may call it mid-run)."""
        if not 0 <= idx < len(self.replicas):
            raise ValueError(f"unknown replica {idx}")
        self._killed.add(idx)

    def _sweep_dead_replicas(self, round_: int):
        """Retire replicas whose home locality died (or that a drill
        killed) and migrate everything they held to the survivors."""
        if self._kill_at is not None and round_ >= self._kill_at[1]:
            self._killed.add(int(self._kill_at[0]))
            self._kill_at = None
        alive_ranks = (set(self.distributed.alive_localities())
                       if self.distributed is not None else None)
        for rep in self.replicas:
            if not rep.alive:
                continue
            home_lost = (alive_ranks is not None and rep.home != 0
                         and rep.home not in alive_ranks
                         and len(self.replicas) > 1)
            if rep.idx in self._killed or home_lost:
                self._retire_replica(rep)

    def _retire_replica(self, rep: _Replica):
        """Replica-death rebalance: land the dead replica's in-flight
        emits, rewind its residents' streams to the prefill token, and
        re-route everything it held - the survivors' refill adopts its
        pages by a cross-replica fetch and replays decode from the parked
        state, so the final streams are bit-identical and prefill never
        reruns."""
        rep.alive = False
        self.router.kill(rep.idx)
        # force the emit chain first so stale in-flight token appends
        # land before the stream rewind below (order matters)
        if rep.prev_emit is not None:
            try:
                rep.prev_emit.result()
            except BaseException:  # noqa: BLE001 - chain died with replica
                pass
        movers = list(rep.admitted) + [h for h in rep.residents
                                       if h is not None]
        rep.admitted.clear()
        rep.residents = [None] * self.slots
        rep.carry = None
        rep.prev_emit = None
        rep.emit_hist.clear()
        self.runtime.record_serve(replica_deaths=1)
        if not self.router.live:
            # last replica standing died: revive it homed on the driver so
            # queued work is never stranded
            rep.home = 0
            rep.alive = True
            self._killed.discard(rep.idx)
            self.router.revive(rep.idx)
            self.runtime.record_serve(replica_revivals=1)
        for h in movers:
            if h._done.is_set():
                self.router.release(h.rid)
                continue
            with self._lock:
                if h._first is not None:
                    # rewind to the prefill token: the adopting replica
                    # replays decode from the parked page state
                    h.tokens = [h._first]
                h._emitted = 0
                h._slot = None
                h._last_t = None
                h.status = "admitted"
            target = self.router.assign(h.rid)
            h._replica = target
            self.replicas[target].admitted.append(h)
            self.runtime.record_serve(replica_migrations=1, replica=target)

    def _cache_counters(self) -> dict:
        """Cache counters summed across replicas, and the shared pool's."""
        out: dict = {}
        for rep in self.replicas:
            for k, v in rep.icache.counters().items():
                if k.startswith("cache_"):
                    out[k] = out.get(k, 0) + v
        out.update(self.pool.counters())
        return out

    # -- the run loop --------------------------------------------------------
    def run(self, queue: RequestQueue) -> dict:
        """Drive the gateway until the queue closes and everything in
        flight is terminal.  Returns the run summary (handles in intake
        order plus the loop's counts); all counters and histograms land
        in ``runtime.stats()``."""
        runtime = self.runtime
        pending: collections.deque[RequestHandle] = collections.deque()
        intake: list[RequestHandle] = []
        finishes = []
        round_ = 0

        def inflight() -> int:
            return sum(len(rep.admitted)
                       + sum(r is not None for r in rep.residents)
                       for rep in self.replicas)

        try:
            while True:
                now = time.perf_counter()
                # 0. liveness: retire dead replicas, migrate their work
                self._sweep_dead_replicas(round_)
                # 1. ingest arrivals whose round has come
                for h in queue.take_ready(round_):
                    self._register(h)
                    intake.append(h)
                    pending.append(h)
                # 2. queued-side faults: user cancels, expired deadlines
                for h in list(pending):
                    if h._cancel_requested:
                        pending.remove(h)
                        self._resolve(h, "cancelled",
                                      CancelledError(h.rid), "cancelled")
                    elif self._expired(h, now):
                        pending.remove(h)
                        self._resolve(h, "expired",
                                      DeadlineExpired(h.rid), "expired")
                # 3. admission: route + launch prefill chains up to the cap
                while pending and inflight() < self.max_inflight:
                    h = pending.popleft()
                    rep = self._admit(h)
                    rep.admitted.append(h)
                # 4. admitted-side faults: cancel/expiry mid-prefill,
                #    poisoned chains detected as soon as they are terminal
                for rep in self.replicas:
                    for h in list(rep.admitted):
                        exc = None
                        if h._cancel_requested:
                            exc, status = CancelledError(h.rid), "cancelled"
                        elif self._expired(h, now):
                            exc, status = DeadlineExpired(h.rid), "expired"
                        elif (h._prefill.done()
                              and h._prefill.exception() is not None):
                            exc, status = h._prefill.exception(), "failed"
                        if exc is not None:
                            rep.admitted.remove(h)
                            self.router.release(h.rid)
                            self._kill_admitted(h, exc, status, status)
                # 5/6 per replica: retire finished residents, fill free
                #     slots from its admitted queue (prefill forced first:
                #     a slot is only ever given a request whose state is
                #     already parked in pages)
                for rep in self.replicas:
                    if not rep.alive:
                        rep.round_work = (False, [])
                        continue
                    changed = False
                    for s, h in enumerate(rep.residents):
                        if h is None:
                            continue
                        cancelled = (h._cancel_requested
                                     or (h.cancel_after is not None
                                         and h._emitted >= h.cancel_after))
                        if cancelled or h._emitted >= self.gen_len:
                            fin = runtime.defer(
                                self._finish_fn(h, cancelled), rep.prev_emit,
                                lane=Lane.CHECKPOINT,
                                name=f"finish:{h.rid}")
                            finishes.append(fin)
                            rep.residents[s] = None
                            self.router.release(h.rid)
                            changed = True
                    joiners = []
                    free = [s for s in range(self.slots)
                            if rep.residents[s] is None]
                    while free and rep.admitted:
                        h = rep.admitted.popleft()
                        if not self._force_prefill(h):
                            self.router.release(h.rid)
                            continue
                        s = free.pop(0)
                        h._slot, h.status = s, "active"
                        rep.residents[s] = h
                        joiners.append((s, h))
                        changed = True
                    rep.round_work = (changed, joiners)
                # 7. nothing resident anywhere: admit what the cap held
                #    back, fast-forward to the next arrival, block on the
                #    queue CV, or drain out
                if not any(rep.has_residents() for rep in self.replicas):
                    if pending:
                        round_ += 1
                        continue
                    nxt = queue.next_round()
                    if nxt is not None:
                        round_ = max(round_ + 1, nxt)
                        continue
                    if queue.drained():
                        break
                    queue.wait_nonempty()   # CV: submit()/close() wakes us
                    round_ += 1
                    continue
                # 8/9 per replica with residents: cut an epoch on
                #     membership change (load pages), then one decode
                #     round with per-slot positions and a chained emit
                for rep in self.replicas:
                    changed, joiners = rep.round_work
                    if not rep.has_residents():
                        continue
                    if changed or rep.carry is None:
                        rep.epoch += 1
                        rep.j = 0
                        joins = tuple((s, h.rid) for s, h in joiners)
                        rep.carry = runtime.defer(
                            self._refill_fn(rep, joins), rep.carry,
                            *[h._prefill for _, h in joiners],
                            name=f"refill:{rep.ns}e{rep.epoch}")
                    live_rows = tuple((h._slot, h.rid)
                                      for h in rep.residents if h is not None)
                    pos = np.full(self.slots, self.prompt_len, np.int64)
                    for s, rid in live_rows:
                        pos[s] = self.prompt_len \
                            + self._handles[rid]._emitted
                    rep.carry = runtime.defer(
                        self._decode_fn(rep), rep.carry, pos,
                        name=f"decode:{rep.ns}e{rep.epoch}:t{rep.j}")
                    emit_deps = (rep.carry,) if rep.prev_emit is None \
                        else (rep.carry, rep.prev_emit)
                    rep.prev_emit = runtime.defer(
                        self._emit_fn(rep, live_rows), *emit_deps,
                        lane=Lane.CHECKPOINT,
                        name=f"emit:{rep.ns}e{rep.epoch}:t{rep.j}")
                    rep.emit_hist.append(rep.prev_emit)
                    if len(rep.emit_hist) > self.lookahead:  # bound the
                        rep.emit_hist.popleft().result()     # lead so
                    for _, rid in live_rows:                 # faults land
                        self._handles[rid]._emitted += 1
                    rep.j += 1
                round_ += 1
            # drain: force every replica's emit tail and every finish node
            for rep in self.replicas:
                if rep.prev_emit is not None:
                    rep.prev_emit.result()
            for fin in finishes:
                fin.result()
        finally:
            # never leave an unresolved promise behind (barrier/shutdown
            # would hang on it): anything non-terminal is failed out
            for h in intake:
                if not h._done.is_set():
                    self._resolve(h, "failed",
                                  RuntimeError(f"gateway torn down with "
                                               f"{h.rid} in flight"),
                                  "failed")
        self.runtime.record_serve(rejected=queue.rejected,
                                  **self._cache_counters())
        counts = collections.Counter(h.status for h in intake)
        return {"handles": intake,
                "streams": {h.rid: list(h.tokens) for h in intake},
                "completed": counts.get("done", 0),
                "cancelled": counts.get("cancelled", 0),
                "expired": counts.get("expired", 0),
                "failed": counts.get("failed", 0),
                "rejected": queue.rejected,
                "rounds": round_,
                "epochs": sum(rep.epoch + 1 for rep in self.replicas),
                "replicas": len(self.replicas),
                "replica_assignments": {h.rid: h._replica for h in intake
                                        if h._replica is not None},
                "cache": self._cache_counters()}
