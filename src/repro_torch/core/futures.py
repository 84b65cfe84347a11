"""Host-side futurized execution (the paper's futurization, where dynamism
lives).

Counterpart: ``repro/core/futures.py``, the same runtime on PyTorch.  JAX
served it only for pytree walks, now ``torch.utils._pytree``, and for
blocking on device values, now a device synchronize for CUDA tensors (a
no-op for CPU tensors).  The phylint hooks are the reference's: the weak
node registry and ``snapshot()`` the static linter reads, and the
sanitizer's deadlock watchdog (``PHYRAX_SANITIZE=1``), which walks the
wait-for graph under the graph's own lock.  Unarmed, a wait costs one
environment lookup more than a plain condition wait.

Phylanx turns user code into a *futurized execution tree* scheduled by HPX:
every operation becomes a task whose execution is constrained only by the
resolution of its inputs.  The *device* runs kernels in launch order on
its stream, but the host side of a training/serving loop retains real
asynchrony: CUDA launches return before the kernels finish,
transfers/saves can proceed concurrently, and several steps can be kept
in flight.  This module is that runtime:

  * ``FuturizedGraph.defer`` builds a DAG of host tasks.  Dependencies are
    discovered by *pytree traversal* of the arguments - any ``PhyFuture``
    found anywhere inside nested containers becomes an edge.  A task runs
    when its inputs resolve (constraint-based synchronization); the
    submitting thread never blocks and never calls ``.result()`` on behalf
    of a task.
  * ``when_all`` / ``when_any`` combinators compose futures; ``tree_join``
    turns a pytree-of-futures into a future-of-pytree (the paper's "tree of
    futures").
  * Errors and cancellations propagate along dependency edges to all
    transitive dependents, so a failed prefetch poisons exactly the steps
    that consumed it and nothing else.
  * Ready tasks are drained by priority *lane*: compute dispatch beats
    prefetch beats checkpoint I/O, so background saves never delay the
    step-critical path.
  * ``promise`` creates an *externally resolved* node (HPX's promise):
    an outside producer (the distributed layer, ``distrib/``) fulfils
    it when its result arrives, and the usual edge propagation takes over
    from there.
  * ``stats()`` reports tasks run / failed / cancelled, max in-flight, and
    worker idle time - the observability hook the benchmarks read.

``Pipeline`` (keep N device steps in flight) rides on CUDA's own
asynchronous launches and is how a loop bounds its lead over the device.
Tensors pass through ``defer`` untouched: kernels on the current stream
already run in launch order.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import enum
import heapq
import itertools
import threading
import time
import weakref
from concurrent.futures import CancelledError
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
import torch.utils._pytree as pytree

# stdlib-only module: safe to import here without a package cycle
from ..analysis import sanitize as _san

__all__ = [
    "CancelledError", "FuturizedGraph", "HIST_EDGES_S", "InFlight", "Lane",
    "PhyFuture", "Pipeline", "REQUEST_PHASES", "RuntimeStats", "TaskState",
    "block_until_ready", "hist_labels",
]


class Lane(enum.IntEnum):
    """Priority lanes, highest first.  Ready tasks drain in lane order:
    step-critical work is never queued behind background I/O.  Note the
    loop *blocks* on prefetch results, so only work the loop waits on
    sooner belongs in COMPUTE; metric forcing and step retirement are
    observability/checkpoint-path work and ride CHECKPOINT."""
    COMPUTE = 0      # host work on the step-critical path
    PREFETCH = 1     # next-batch build + host->device transfer
    CHECKPOINT = 2   # checkpoint I/O, metric forcing, retirement


class TaskState(enum.Enum):
    PENDING = "pending"        # waiting on dependency edges
    READY = "ready"            # all inputs resolved; queued for a worker
    RUNNING = "running"
    DONE = "done"
    ERROR = "error"
    CANCELLED = "cancelled"


_TERMINAL = (TaskState.DONE, TaskState.ERROR, TaskState.CANCELLED)


# wall-time histogram bucket edges (seconds): tasks land in the first
# bucket whose edge exceeds their duration; the last bucket is open-ended
HIST_EDGES_S = (1e-4, 1e-3, 1e-2, 1e-1, 1.0)

# per-request latency phases the serving gateway histograms (same bucket
# edges as the lane histograms): time queued before prefill started, the
# prefill itself, each decoded token, and submit->finish end to end
REQUEST_PHASES = ("queue_wait", "prefill", "decode_token", "total")


def _fmt_s(s: float) -> str:
    if s < 1e-3:
        return f"{s * 1e6:g}us"
    if s < 1.0:
        return f"{s * 1e3:g}ms"
    return f"{s:g}s"


def hist_labels() -> list[str]:
    """Human-readable bucket names for ``HIST_EDGES_S``: ``"<100us"`` ...
    ``">=1s"`` - one label per histogram cell, last bucket open-ended."""
    return ([f"<{_fmt_s(e)}" for e in HIST_EDGES_S]
            + [f">={_fmt_s(HIST_EDGES_S[-1])}"])


@dataclasses.dataclass
class RuntimeStats:
    """Counters for one ``FuturizedGraph``; read via ``graph.stats()``.

    ``to_json()`` schema::

        {
          "submitted" | "completed" | "failed" | "cancelled": int,
          "max_in_flight": int,          # peak concurrently-RUNNING tasks
          "idle_s" | "busy_s": float,    # summed worker wall time
          "per_lane": {lane: int},       # completions per Lane name
          "lane_time_hist": {
            "edges_s": [1e-4, 1e-3, 1e-2, 1e-1, 1.0],   # bucket edges (s)
            "labels": ["<100us", "<1ms", "<10ms", "<100ms", "<1s", ">=1s"],
            "counts": {lane: [int] * 6},  # counts[i] tasks in labels[i]
          },
          "serve": {counter: int},       # gateway admission/cache counters
          "serve_replicas": {            # the same counters split by the
            "0": {counter: int}, ...},   # serve replica that incurred them
          "request_latency_hist": {      # per-request phases, same buckets
            "edges_s": [...], "labels": [...],
            "counts": {phase: [int] * 6},   # phase in REQUEST_PHASES
          },
        }

    ``serve``, ``serve_replicas`` and ``request_latency_hist`` are fed by
    the serving gateway (``frontend/gateway.py``) through
    ``FuturizedGraph.record_serve``; all serialize as empty/all-zeros for
    graphs that never serve.  ``serve_replicas`` keys are string replica
    indices (JSON-stable) and appear only for counters recorded with
    ``replica=``.

    A task of duration ``d`` lands in the first bucket whose edge exceeds
    ``d``; the last bucket is open-ended.  For scheduler-run tasks the
    ``counts`` row sums equal the lane's ``per_lane`` completion count.
    Nodes with no local duration are the exceptions: ``promise`` nodes
    (e.g. cross-process results) count in ``per_lane`` but not in the
    histogram, and ``immediate`` values count in ``submitted``/
    ``completed`` only."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    cancelled: int = 0
    max_in_flight: int = 0
    idle_s: float = 0.0        # total worker time spent waiting for work
    busy_s: float = 0.0        # total worker time spent running tasks
    per_lane: dict = dataclasses.field(
        default_factory=lambda: {lane.name: 0 for lane in Lane})
    # per-task wall time, histogrammed by lane over HIST_EDGES_S buckets
    lane_hist: dict = dataclasses.field(
        default_factory=lambda: {lane.name: [0] * (len(HIST_EDGES_S) + 1)
                                 for lane in Lane})
    # serving-gateway counters (admitted/rejected/expired/..., paged-cache
    # hits, padded-slot tokens); open-keyed so the gateway can grow them
    serve: dict = dataclasses.field(default_factory=dict)
    # the same counters split per serve replica ({"0": {...}, "1": {...}})
    serve_replicas: dict = dataclasses.field(default_factory=dict)
    # per-request latency, histogrammed by phase over HIST_EDGES_S buckets
    request_hist: dict = dataclasses.field(
        default_factory=lambda: {p: [0] * (len(HIST_EDGES_S) + 1)
                                 for p in REQUEST_PHASES})

    def record_task(self, lane: "Lane", dt_s: float):
        self.lane_hist[lane.name][bisect.bisect_right(HIST_EDGES_S,
                                                      dt_s)] += 1

    def record_request_phase(self, phase: str, dt_s: float):
        """One request-latency sample: ``phase`` must be in
        ``REQUEST_PHASES``; ``dt_s`` buckets exactly like ``record_task``."""
        self.request_hist[phase][bisect.bisect_right(HIST_EDGES_S,
                                                     dt_s)] += 1

    def hist_lines(self) -> list[str]:
        """Human-readable per-lane wall-time histograms (non-empty lanes)."""
        labels = hist_labels()
        lines = []
        for lane, counts in self.lane_hist.items():
            if not sum(counts):
                continue
            cells = " ".join(f"{lb}:{c}" for lb, c in zip(labels, counts)
                             if c)
            lines.append(f"{lane:10s} {cells}")
        return lines

    def to_json(self) -> dict:
        """Serialize to the documented schema (see the class docstring);
        the histogram buckets carry their edges *and* labels so downstream
        reports never have to hard-code them."""
        out = dataclasses.asdict(self)
        hist = out.pop("lane_hist")
        out["lane_time_hist"] = {"edges_s": list(HIST_EDGES_S),
                                 "labels": hist_labels(),
                                 "counts": hist}
        req = out.pop("request_hist")
        out["request_latency_hist"] = {"edges_s": list(HIST_EDGES_S),
                                       "labels": hist_labels(),
                                       "counts": req}
        return out


def _is_future(x) -> bool:
    return isinstance(x, PhyFuture)


class PhyFuture:
    """A node of the futurized execution tree.

    Created by ``FuturizedGraph.defer`` / ``promise`` (and the
    combinators), never directly.  ``result()`` blocks the *caller*; the
    runtime itself only ever runs a node once every input has resolved.

    ``home`` is the locality rank a node's work was placed on by the
    distributed layer (``distrib/``); ``None`` for purely local
    nodes.
    """

    __slots__ = ("_graph", "name", "lane", "home", "_fn", "_args",
                 "_kwargs", "_state", "_value", "_exc", "_ndeps",
                 "_dependents", "_callbacks", "_seq", "_promise",
                 "_kind", "_producer", "_observed", "_deps", "_fanout",
                 "__weakref__")

    def __init__(self, graph: "FuturizedGraph", fn: Optional[Callable],
                 args, kwargs, *, lane: Lane, name: str, seq: int,
                 kind: str = "task"):
        self._graph = graph
        self.name = name
        self.lane = lane
        self.home: Optional[int] = None
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self._state = TaskState.PENDING
        self._value = None
        self._exc: Optional[BaseException] = None
        self._ndeps = 0
        self._dependents: list[PhyFuture] = []
        self._callbacks: list[Callable[["PhyFuture"], None]] = []
        self._seq = seq
        self._promise = False
        self._kind = kind         # task | promise | immediate | join
        self._producer = ""       # promise nodes: who committed to resolve it
        self._observed = False    # result()/exception()/done-callback seen
        self._fanout = 0          # dependents ever attached (never reset:
                                  # _dependents is consumed at retirement)
        self._deps: tuple = ()    # dependency seqs at submission (analysis)

    # -- inspection ---------------------------------------------------------
    @property
    def state(self) -> TaskState:
        return self._state

    def done(self) -> bool:
        return self._state in _TERMINAL

    def exception(self) -> Optional[BaseException]:
        """The task's exception, if it errored (blocks until terminal)."""
        self._observed = True
        self._graph._wait_terminal(self)
        return self._exc

    # -- consumption --------------------------------------------------------
    def result(self, timeout: Optional[float] = None):
        """Block the caller until resolved; raise the task's exception (or
        ``CancelledError``) if it did not complete."""
        self._observed = True
        self._graph._wait_terminal(self, timeout)
        if self._state is TaskState.DONE:
            return self._value
        if self._state is TaskState.CANCELLED:
            raise self._exc or CancelledError(self.name)
        raise self._exc

    def cancel(self) -> bool:
        """Cancel if not yet running; cancellation propagates to all
        transitive dependents.  Returns False once running/terminal."""
        return self._graph._cancel(self)

    def add_done_callback(self, cb: Callable[["PhyFuture"], None]):
        """Run ``cb(self)`` once terminal (immediately if already)."""
        fire = False
        self._observed = True
        with self._graph._lock:
            if self.done():
                fire = True
            else:
                self._callbacks.append(cb)
        if fire:
            cb(self)

    # -- external resolution (promise nodes only) ---------------------------
    def set_result(self, value) -> bool:
        """Resolve a ``FuturizedGraph.promise`` node with ``value``.

        Returns:
            True if this call resolved the node; False if it was already
            terminal (e.g. cancelled locally while the work was remote -
            late results are discarded, not an error).
        Raises:
            RuntimeError: on a non-promise node, whose value is owned by
                the scheduler.
        """
        if not self._promise:
            raise RuntimeError(f"{self.name!r} is not a promise node")
        with self._graph._lock:
            if self.done():
                return False
            self._graph._complete_locked(self, value=value)
            return True

    def set_exception(self, exc: BaseException, *,
                      cancelled: bool = False) -> bool:
        """Poison a ``FuturizedGraph.promise`` node (and, via the normal
        edge propagation, its transitive dependents) with ``exc``.

        Args:
            exc: the exception ``result()`` will raise.
            cancelled: record the node as CANCELLED rather than ERROR.
        Returns:
            True if this call poisoned the node; False if already terminal.
        Raises:
            RuntimeError: on a non-promise node.
        """
        if not self._promise:
            raise RuntimeError(f"{self.name!r} is not a promise node")
        with self._graph._lock:
            if self.done():
                return False
            self._graph._fail_locked(self, exc, cancelled=cancelled)
            return True

    def __repr__(self):
        return f"<PhyFuture {self.name!r} {self._state.value} lane={self.lane.name}>"


@dataclasses.dataclass
class InFlight:
    step: int
    outputs: Any


class FuturizedGraph:
    """Futurized execution tree: nodes run when their dependencies resolve,
    drained by worker threads in priority-lane order."""

    def __init__(self, max_workers: int = 4, name: str = "phyrax"):
        self.name = name
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)   # terminal transitions
        self._work = threading.Condition(self._lock)   # ready-queue pushes
        self._heap: list[tuple[int, int, PhyFuture]] = []
        self._seq = itertools.count()
        self._unfinished = 0          # nodes not yet terminal
        self._in_flight = 0           # nodes currently RUNNING
        self._stats = RuntimeStats()
        self._trace_hooks: list[Callable[[PhyFuture, tuple], None]] = []
        self._closed = False
        # analysis support: weak registry of every node (snapshot()), the
        # node each worker thread is running, and the per-thread blocked
        # waits the sanitizer's deadlock watchdog walks
        self._node_refs: list[weakref.ref] = []
        self._refs_hwm = 256
        self._running: dict[int, PhyFuture] = {}
        self._waits: dict[int, tuple[Optional[PhyFuture], float]] = {}
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-futures-{i}")
            for i in range(max(1, max_workers))]
        for t in self._workers:
            t.start()

    # -- task construction --------------------------------------------------
    def defer(self, fn: Callable, *args, lane: Lane = Lane.COMPUTE,
              name: str = "", **kwargs) -> PhyFuture:
        """Add a node running ``fn`` once every ``PhyFuture`` found (by
        pytree traversal) in ``args``/``kwargs`` has resolved.  Non-future
        leaves - including tensors, whose kernels are already asynchronous
        - pass through untouched.

        Args:
            fn: host callable; runs on a worker thread with every future
                in its arguments replaced by that future's value.
            *args, **kwargs: arguments, searched for ``PhyFuture`` leaves
                by pytree traversal - each becomes a dependency edge.
            lane: priority lane the node drains in once READY.
            name: display name (defaults to ``fn.__name__``).
        Returns:
            The node's ``PhyFuture``.  If a dependency has already
            errored/cancelled, the node is created pre-poisoned.
        Raises:
            ValueError: a dependency belongs to a different graph.
            RuntimeError: the graph has been shut down.
        """
        deps = [x for x in pytree.tree_leaves((args, kwargs),
                                              is_leaf=_is_future)
                if _is_future(x)]
        for d in deps:   # validate before touching any graph state
            if d._graph is not self:
                raise ValueError("dependency belongs to a different graph")
        with self._lock:
            if self._closed:
                raise RuntimeError(f"graph {self.name!r} is shut down")
            node = PhyFuture(self, fn, args, kwargs, lane=lane,
                             name=name or getattr(fn, "__name__", "task"),
                             seq=next(self._seq))
            node._deps = tuple(d._seq for d in deps)
            self._register_locked(node)
            self._stats.submitted += 1
            self._unfinished += 1
            poisoned: Optional[PhyFuture] = None
            for d in deps:
                d._fanout += 1
                if d._state is TaskState.DONE:
                    continue
                if d._state in _TERMINAL:      # errored / cancelled upstream
                    poisoned = d
                    break
                d._dependents.append(node)
                node._ndeps += 1
            if poisoned is not None:
                self._fail_locked(node, poisoned._exc
                                  or CancelledError(poisoned.name),
                                  cancelled=poisoned._state
                                  is TaskState.CANCELLED)
            elif node._ndeps == 0:
                self._enqueue_locked(node)
        self._notify_trace(node, tuple(deps))
        return node

    def immediate(self, value: Any, name: str = "immediate") -> PhyFuture:
        """An already-resolved future - wraps a value the caller computed
        synchronously so downstream nodes can depend on it by edge."""
        with self._lock:
            node = PhyFuture(self, None, (), {}, lane=Lane.COMPUTE,
                             name=name, seq=next(self._seq),
                             kind="immediate")
            node._state = TaskState.DONE
            node._value = value
            self._register_locked(node)
            self._stats.submitted += 1
            self._stats.completed += 1
        self._notify_trace(node, ())
        return node

    def promise(self, *, name: str = "promise",
                lane: Lane = Lane.COMPUTE, producer: str = "") -> PhyFuture:
        """An *externally resolved* node: HPX's promise.

        The returned future never runs on a worker; whoever holds it calls
        ``set_result`` / ``set_exception`` when the out-of-graph work (a
        result frame from another locality, an external callback) lands.
        Dependents hang edges off it exactly as off a deferred node, and
        ``barrier``/``shutdown`` wait for it, so an unresolved promise
        must always be fulfilled or poisoned by its creator.

        Args:
            name: display name.
            lane: lane recorded for stats/affinity (never scheduled).
            producer: who committed to resolving this promise (e.g.
                ``"L2"`` for a locality).  A promise with no producer is
                an orphan to the static linter (PHY002) and, if a wait
                stalls on one, to the runtime sanitizer (PHY101) - name
                the resolver whenever one exists.
        Returns:
            A PENDING ``PhyFuture`` resolvable from outside the graph.
        Raises:
            RuntimeError: the graph has been shut down.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError(f"graph {self.name!r} is shut down")
            node = PhyFuture(self, None, (), {}, lane=lane, name=name,
                             seq=next(self._seq), kind="promise")
            node._promise = True
            node._producer = producer
            self._register_locked(node)
            self._stats.submitted += 1
            self._unfinished += 1
        self._notify_trace(node, ())
        return node

    # -- tracing hooks ------------------------------------------------------
    def add_trace_hook(self, cb: Callable[[PhyFuture, tuple], None]
                       ) -> Callable[[], None]:
        """Register ``cb(node, deps)``, fired for every node added to the
        graph (after submission, outside the scheduler lock) - the hook the
        frontend tracer uses to record the futurized tree as it is built.
        Returns a zero-arg function that unregisters the hook."""
        with self._lock:
            self._trace_hooks.append(cb)

        def remove():
            with self._lock:
                try:
                    self._trace_hooks.remove(cb)
                except ValueError:
                    pass
        return remove

    def _notify_trace(self, node: PhyFuture, deps: tuple):
        if not self._trace_hooks:
            return
        with self._lock:
            hooks = list(self._trace_hooks)
        for cb in hooks:
            try:
                cb(node, deps)
            except Exception:   # noqa: BLE001 - tracing must not kill callers
                pass

    # -- combinators --------------------------------------------------------
    def when_all(self, futures: Sequence[PhyFuture], *,
                 lane: Lane = Lane.COMPUTE, name: str = "when_all"
                 ) -> PhyFuture:
        """Future of the list of results, in input order.

        Args:
            futures: the inputs; an empty sequence resolves immediately
                with ``[]``.
            lane, name: as for ``defer``.
        Returns:
            A future of ``[f.result() for f in futures]``; any input's
            error or cancellation propagates to it (and onward).
        """
        futures = list(futures)
        return self.defer(lambda *vs: list(vs), *futures, lane=lane,
                          name=name)

    def when_any(self, futures: Sequence[PhyFuture], *, name: str = "when_any"
                 ) -> PhyFuture:
        """Resolves with ``(index, value)`` of the first future to complete
        successfully; errors only if *every* input fails or is cancelled.

        Args:
            futures: non-empty sequence of candidate futures.
        Returns:
            A future of ``(index, value)`` for the first success.
        Raises:
            ValueError: ``futures`` is empty.
        """
        futures = list(futures)
        if not futures:
            raise ValueError("when_any of no futures")
        with self._lock:
            node = PhyFuture(self, None, (), {}, lane=Lane.COMPUTE,
                             name=name, seq=next(self._seq), kind="join")
            node._deps = tuple(f._seq for f in futures)
            self._register_locked(node)
            self._stats.submitted += 1
            self._unfinished += 1
        self._notify_trace(node, tuple(futures))
        remaining = [len(futures)]

        def on_done(i: int, f: PhyFuture):
            with self._lock:
                if node.done():
                    return
                if f._state is TaskState.DONE:
                    self._complete_locked(node, value=(i, f._value))
                else:
                    remaining[0] -= 1
                    if remaining[0] == 0:   # every input failed/cancelled
                        self._fail_locked(
                            node, f._exc or CancelledError(f.name),
                            cancelled=f._state is TaskState.CANCELLED)

        for i, f in enumerate(futures):
            f.add_done_callback(lambda f, i=i: on_done(i, f))
        return node

    def tree_join(self, tree: Any, *, lane: Lane = Lane.COMPUTE,
                  name: str = "tree_join") -> PhyFuture:
        """Pytree-of-futures -> future-of-pytree (the tree of futures).

        Args:
            tree: any pytree; ``PhyFuture`` leaves become edges, other
                leaves pass through untouched.
            lane, name: as for ``defer``.
        Returns:
            A future of ``tree`` with every future leaf replaced by its
            value, resolved once the last leaf resolves; leaf errors and
            cancellations propagate.
        """
        leaves, treedef = pytree.tree_flatten(tree, is_leaf=_is_future)
        futs = [(i, x) for i, x in enumerate(leaves) if _is_future(x)]

        def rebuild(*vals):
            out = list(leaves)
            for (i, _), v in zip(futs, vals):
                out[i] = v
            return pytree.tree_unflatten(out, treedef)

        return self.defer(rebuild, *[f for _, f in futs], lane=lane,
                          name=name)

    def gather(self, futures: Iterable[PhyFuture]) -> list:
        """Block the caller for all results (edge of the futurized world)."""
        return [f.result() for f in futures]

    # -- analysis support ---------------------------------------------------
    def _register_locked(self, node: PhyFuture):
        refs = self._node_refs
        refs.append(weakref.ref(node))
        if len(refs) >= self._refs_hwm:   # amortized O(1) compaction
            self._node_refs = [r for r in refs if r() is not None]
            self._refs_hwm = max(256, 2 * len(self._node_refs))

    def snapshot(self) -> list[dict]:
        """A consistent structural snapshot of every live node, for the
        static linter (``repro_torch.analysis.lint.LintGraph.from_graph``).

        Returns:
            One dict per node still alive (non-terminal nodes are always
            strongly held by the scheduler; terminal ones only as long as
            someone holds their future), in submission order::

                {"seq": int, "name": str, "lane": "COMPUTE"|...,
                 "kind": "task"|"promise"|"immediate"|"join",
                 "state": "PENDING"|..., "producer": str,
                 "observed": bool, "fanout": int, "deps": (seq, ...)}

        ``fanout`` counts dependents ever attached - a collected
        dependent drops its edge from the snapshot, but not this count,
        so consumed nodes never read as dead (PHY004).
        """
        with self._lock:
            nodes = [n for n in (r() for r in self._node_refs)
                     if n is not None]
            return [{"seq": n._seq, "name": n.name, "lane": n.lane.name,
                     "kind": n._kind, "state": n._state.name,
                     "producer": n._producer, "observed": n._observed,
                     "fanout": n._fanout, "deps": n._deps} for n in nodes]

    # -- lifecycle ----------------------------------------------------------
    def barrier(self, timeout: Optional[float] = None):
        """Block until every submitted node is terminal."""
        with self._lock:
            if _san.active():
                self._sanitized_wait_locked(
                    lambda: self._unfinished == 0, None, timeout)
                return
            if not self._cond.wait_for(lambda: self._unfinished == 0,
                                       timeout):
                raise TimeoutError(
                    f"{self._unfinished} tasks still pending")

    def stats(self) -> RuntimeStats:
        with self._lock:
            return dataclasses.replace(
                self._stats, per_lane=dict(self._stats.per_lane),
                lane_hist={k: list(v)
                           for k, v in self._stats.lane_hist.items()},
                serve=dict(self._stats.serve),
                serve_replicas={k: dict(v) for k, v
                                in self._stats.serve_replicas.items()},
                request_hist={k: list(v)
                              for k, v in self._stats.request_hist.items()})

    def record_serve(self, *, phase: Optional[str] = None, dt_s: float = 0.0,
                     replica: Optional[int] = None, **counters: int):
        """Serving-gateway telemetry sink: bump ``stats().serve`` counters
        by the given keyword amounts and, when ``phase`` is set (one of
        ``REQUEST_PHASES``), add one ``dt_s`` sample to that per-request
        latency histogram.  With ``replica`` set the counters are also
        recorded under ``stats().serve_replicas[str(replica)]`` - the
        per-replica split the multi-replica gateway reports.  Thread-safe;
        callable from node bodies."""
        with self._lock:
            if phase is not None:
                self._stats.record_request_phase(phase, dt_s)
            per = (None if replica is None
                   else self._stats.serve_replicas.setdefault(
                       str(replica), {}))
            for k, v in counters.items():
                self._stats.serve[k] = self._stats.serve.get(k, 0) + int(v)
                if per is not None:
                    per[k] = per.get(k, 0) + int(v)

    def load(self) -> dict[str, int]:
        """Instantaneous queue pressure: ``{"ready": n, "running": n,
        "unfinished": n}``.  An elastic locality polls this to decide it
        is idle enough to post a ``steal_request`` (DESIGN.md §13)."""
        with self._lock:
            ready = sum(1 for _, _, n in self._heap
                        if n._state is TaskState.READY)
            return {"ready": ready, "running": self._in_flight,
                    "unfinished": self._unfinished}

    def shutdown(self, wait: bool = True, cancel_pending: bool = False):
        """Drain (or cancel) outstanding work, then stop the workers.
        With ``wait=True`` every pending node - including low-priority
        checkpoint I/O - completes before return: the shutdown barrier."""
        with self._lock:
            if cancel_pending:
                for _, _, node in list(self._heap):
                    self._cancel_locked(node)
        if wait:
            self.barrier()
        with self._lock:
            self._closed = True
            self._work.notify_all()
        for t in self._workers:
            t.join(timeout=5.0)

    # -- scheduler internals ------------------------------------------------
    def _enqueue_locked(self, node: PhyFuture):
        node._state = TaskState.READY
        heapq.heappush(self._heap, (int(node.lane), node._seq, node))
        self._work.notify()

    def _worker(self):
        while True:
            with self._lock:
                t0 = time.perf_counter()
                while not self._heap and not self._closed:
                    self._work.wait()
                self._stats.idle_s += time.perf_counter() - t0
                if not self._heap:          # closed and drained
                    return
                _, _, node = heapq.heappop(self._heap)
                if node._state is not TaskState.READY:  # lazily cancelled
                    continue
                node._state = TaskState.RUNNING
                self._running[threading.get_ident()] = node
                self._in_flight += 1
                self._stats.max_in_flight = max(self._stats.max_in_flight,
                                                self._in_flight)
                args, kwargs, fn = node._args, node._kwargs, node._fn

            def resolve(x):
                return x._value if _is_future(x) else x

            t1 = time.perf_counter()
            try:
                a, kw = pytree.tree_map(resolve, (args, kwargs),
                                        is_leaf=_is_future)
                value = fn(*a, **kw)
            except BaseException as e:  # noqa: BLE001 - propagated to deps
                dt = time.perf_counter() - t1
                with self._lock:
                    self._running.pop(threading.get_ident(), None)
                    self._stats.busy_s += dt
                    self._stats.record_task(node.lane, dt)
                    self._in_flight -= 1
                    self._fail_locked(node, e)
            else:
                dt = time.perf_counter() - t1
                with self._lock:
                    self._running.pop(threading.get_ident(), None)
                    self._stats.busy_s += dt
                    self._stats.record_task(node.lane, dt)
                    self._in_flight -= 1
                    self._complete_locked(node, value=value)
            # drop the task's arguments and value here: an idle worker's
            # frame would hold them (a checkpoint's host copies) until its
            # next task
            args = kwargs = fn = a = kw = value = None

    def _complete_locked(self, node: PhyFuture, *, value: Any):
        node._state = TaskState.DONE
        node._value = value
        node._fn = node._args = node._kwargs = None
        self._stats.completed += 1
        self._stats.per_lane[node.lane.name] += 1
        self._unfinished -= 1
        for d in node._dependents:
            if d._state is not TaskState.PENDING:
                continue
            d._ndeps -= 1
            if d._ndeps == 0:
                self._enqueue_locked(d)
        self._finish_locked(node)

    def _fail_locked(self, node: PhyFuture, exc: BaseException,
                     cancelled: bool = False):
        """Mark ``node`` failed/cancelled and poison all transitive
        dependents - constraint-based sync also for the error path."""
        work = [node]
        while work:
            n = work.pop()
            if n._state in _TERMINAL:
                continue
            n._state = (TaskState.CANCELLED if cancelled
                        else TaskState.ERROR)
            n._exc = exc
            n._fn = n._args = n._kwargs = None
            if cancelled:
                self._stats.cancelled += 1
            else:
                self._stats.failed += 1
            self._unfinished -= 1
            work.extend(n._dependents)
            self._finish_locked(n)

    def _finish_locked(self, node: PhyFuture):
        cbs, node._callbacks = node._callbacks, []
        deps = node._dependents
        node._dependents = []
        del deps
        self._cond.notify_all()
        for cb in cbs:
            try:
                cb(node)
            except Exception:   # noqa: BLE001 - callbacks must not kill workers
                pass

    def _cancel(self, node: PhyFuture) -> bool:
        with self._lock:
            return self._cancel_locked(node)

    def _cancel_locked(self, node: PhyFuture) -> bool:
        if node._state not in (TaskState.PENDING, TaskState.READY):
            return False
        self._fail_locked(node, CancelledError(node.name), cancelled=True)
        return True

    def _wait_terminal(self, node: PhyFuture,
                       timeout: Optional[float] = None):
        with self._lock:
            if _san.active():
                self._sanitized_wait_locked(node.done, node, timeout)
                return
            if not self._cond.wait_for(node.done, timeout):
                raise TimeoutError(f"task {node.name!r} still "
                                   f"{node._state.value}")

    # -- sanitizer: deadlock watchdog (DESIGN.md §12) ------------------------
    def _sanitized_wait_locked(self, pred: Callable[[], bool],
                               node: Optional[PhyFuture],
                               timeout: Optional[float]):
        """Chunked condition wait that registers itself in the wait-for
        graph and periodically runs the deadlock scan; raises
        ``sanitize.DeadlockError`` on a provable non-progress state
        instead of hanging.  ``node`` is None for ``barrier()`` (waiting
        on *every* unfinished node)."""
        cfg = _san.config()
        ident = threading.get_ident()
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        self._waits[ident] = (node, t0)
        try:
            while not pred():
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    what = (f"task {node.name!r} still {node._state.value}"
                            if node is not None else
                            f"{self._unfinished} tasks still pending")
                    raise TimeoutError(what)
                step = cfg.chunk if deadline is None else min(
                    cfg.chunk, deadline - now)
                if self._cond.wait_for(pred, step):
                    return
                waited = time.monotonic() - t0
                if waited >= cfg.deadlock_after:
                    self._watchdog_locked(node, waited, cfg)
        finally:
            self._waits.pop(ident, None)

    def _watchdog_locked(self, node: Optional[PhyFuture], waited: float,
                         cfg) -> None:
        """One deadlock scan over the wait-for graph; raises on proof.

        Vertices are ``("T", thread_ident)`` and ``("N", node_seq)``.
        Edges: a blocked thread -> the node(s) it waits on; a PENDING
        node -> its unresolved deps; a RUNNING node -> its worker thread
        *if that thread is itself blocked*; a READY node -> every blocked
        worker, but only when ALL workers are blocked (otherwise a free
        worker will drain it - progress).  A cycle reachable from the
        calling thread can never resolve -> raise.  Separately, if the
        wait has outlived ``orphan_after`` and every reachable frontier
        leaf is an unproduced promise, nothing inside the process can
        make progress either -> raise (PHY101 both ways)."""
        alive = {n._seq: n for n in (r() for r in self._node_refs)
                 if n is not None and not n.done()}
        edges: dict = {}
        by_seq_running = {id(rn): tid for tid, rn in self._running.items()}
        worker_idents = {t.ident for t in self._workers}
        blocked_workers = [i for i in worker_idents if i in self._waits]
        all_workers_blocked = (len(blocked_workers) == len(self._workers))
        for tid, (wnode, _) in self._waits.items():
            if wnode is None:   # barrier: waits on every unfinished node
                edges[("T", tid)] = tuple(("N", s) for s in alive)
            elif not wnode.done():
                edges[("T", tid)] = (("N", wnode._seq),)
        for seq, n in alive.items():
            if n._state is TaskState.PENDING and not n._promise:
                edges[("N", seq)] = tuple(
                    ("N", s) for s in n._deps
                    if s in alive)
            elif n._state is TaskState.READY and all_workers_blocked:
                edges[("N", seq)] = tuple(
                    ("T", i) for i in blocked_workers)
            elif n._state is TaskState.RUNNING:
                tid = by_seq_running.get(id(n))
                if tid is not None and tid in self._waits:
                    edges[("N", seq)] = (("T", tid),)
        root = ("T", threading.get_ident())
        cycle = _san.find_cycle(edges, (root,))
        if cycle is not None:
            names = [self._vertex_name(v, alive) for v in cycle]
            idents = tuple(v[1] for v in cycle if v[0] == "T")
            detail = (" -> ".join(names) + " -> (cycle)\n"
                      + _san.thread_stacks(idents))
            _san.get().record(
                "PHY101", f"deadlock: wait-for cycle in graph "
                f"{self.name!r} after {waited:.1f}s", detail=detail,
                once_key=f"cycle:{self.name}:{names[0]}")
            raise _san.DeadlockError(
                f"PHY101 deadlock in graph {self.name!r}: "
                + " -> ".join(names) + " -> (cycle)\n" + detail)
        if waited < cfg.orphan_after:
            return
        # reachability: is every frontier leaf an unproduced promise?
        seen = {root}
        frontier: list[PhyFuture] = []
        progress = False
        stack = [root]
        while stack:
            v = stack.pop()
            nbrs = edges.get(v, ())
            if not nbrs and v[0] == "N":
                n = alive.get(v[1])
                if n is None:
                    continue
                if n._promise:
                    frontier.append(n)
                else:           # READY with a free worker / RUNNING free
                    progress = True
            for w in nbrs:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        if progress or not frontier:
            return
        if any(n._producer for n in frontier):
            # a declared producer means out-of-process work may still
            # land; only an all-unproduced frontier is provably stuck
            return
        names = ", ".join(f"{n.name!r} (no producer)" for n in frontier)
        detail = _san.thread_stacks(tuple(
            t for t in self._waits))
        _san.get().record(
            "PHY101", f"stalled wait in graph {self.name!r}: every "
            f"progress path ends in an unresolved promise ({names}) "
            f"after {waited:.1f}s", detail=detail,
            once_key=f"stall:{self.name}")
        raise _san.DeadlockError(
            f"PHY101 stalled wait in graph {self.name!r}: every progress "
            f"path ends in an unresolved promise ({names}); waited "
            f"{waited:.1f}s\n{detail}")

    @staticmethod
    def _vertex_name(v: tuple, alive: dict) -> str:
        if v[0] == "T":
            for t in threading.enumerate():
                if t.ident == v[1]:
                    return f"thread[{t.name}]"
            return f"thread[{v[1]}]"
        n = alive.get(v[1])
        return (f"{n.name}({n._state.value})" if n is not None
                else f"node[{v[1]}]")



def block_until_ready(tree):
    """Wait until the device has computed every tensor in ``tree``: a
    device synchronize per CUDA device found, nothing for CPU tensors.
    Returns ``tree``."""
    devices = {x.device for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


class Pipeline:
    """Keep up to ``depth`` device steps in flight (constraint-based sync:
    block only when the pipeline is full, never earlier).  This is the
    device-side complement of ``FuturizedGraph``: CUDA launches are already
    asynchronous, so the only host obligation is to bound how far the host
    may run ahead (buffer reuse + host memory)."""

    def __init__(self, depth: int = 2):
        self.depth = depth
        self._q: collections.deque[InFlight] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, step: int, outputs: Any) -> InFlight | None:
        """Register async outputs of a step; returns the retired step whose
        results are now forced (or None while the pipeline fills)."""
        self._q.append(InFlight(step, outputs))
        if len(self._q) > self.depth:
            oldest = self._q.popleft()
            block_until_ready(oldest.outputs)
            return oldest
        return None

    def drain(self) -> list[InFlight]:
        out = list(self._q)
        self._q.clear()
        for item in out:
            block_until_ready(item.outputs)
        return out
