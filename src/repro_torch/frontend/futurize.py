"""``@futurize``: plain Python traced into the futurized execution tree.

Phylanx translates user Python into PhySL, where every function application
becomes a future whose execution is constrained only by its inputs
(DESIGN.md §2, §8).  This module is the analogue at the *host*
level: decorate a function with ``@futurize`` and, inside a ``tracing()``
block, each call becomes a ``FuturizedGraph`` node -

  * dependency edges are discovered from the arguments (any ``PhyFuture``
    anywhere inside nested containers, by pytree traversal - ``defer``'s
    contract);
  * control flow stays in Python: the user's loops and conditionals run
    eagerly and only the *calls* become nodes, so the traced tree is exactly
    the dynamic call structure;
  * outside a ``tracing()`` block - including on runtime worker threads,
    where a futurized function called by another futurized function lands -
    the call executes inline and returns a plain value (untraced fallback).

``Trace`` records the tree as it is built (via the graph's trace hook) and
exposes a deterministic ``signature()`` for tests and tooling: node names
are counted per trace (``load:0``, ``load:1``, ...), so the same program
traces to the same shape on every run.

Counterpart: ``repro/frontend/futurize.py``, unchanged in semantics.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Optional

from ..core.futures import FuturizedGraph, Lane, PhyFuture

__all__ = ["Trace", "TraceNode", "current_trace", "futurize", "tracing"]

_tls = threading.local()


def current_trace() -> Optional["Trace"]:
    """The innermost active ``tracing()`` context on this thread, if any."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@dataclasses.dataclass(frozen=True)
class TraceNode:
    index: int
    name: str
    lane: str
    deps: tuple            # indices of in-trace dependency nodes, sorted
    # structural metadata for the static linter: node kind (task |
    # promise | immediate | join) and, for promises, the declared
    # producer - absent from signature() on purpose
    kind: str = "task"
    producer: str = ""


class Trace:
    """The recorded shape of a futurized tree: one ``TraceNode`` per graph
    node added while the trace was installed, in submission order."""

    def __init__(self, graph: FuturizedGraph):
        self.graph = graph
        self.nodes: list[TraceNode] = []
        self._lock = threading.Lock()
        self._index: dict[int, int] = {}       # id(PhyFuture) -> node index
        self._names = collections.Counter()

    def next_name(self, base: str) -> str:
        with self._lock:
            k = self._names[base]
            self._names[base] += 1
        return f"{base}:{k}"

    def record(self, node: PhyFuture, deps: tuple):
        """Graph trace-hook target; safe to call from any thread."""
        with self._lock:
            idx = len(self.nodes)
            self._index[id(node)] = idx
            dep_ids = tuple(sorted(self._index[id(d)] for d in deps
                                   if id(d) in self._index))
            self.nodes.append(TraceNode(
                index=idx, name=node.name, lane=node.lane.name,
                deps=dep_ids, kind=getattr(node, "_kind", "task"),
                producer=getattr(node, "_producer", "")))

    def names(self) -> list[str]:
        return [n.name for n in self.nodes]

    def signature(self) -> list[tuple]:
        """Deterministic tree shape: ``[(name, lane, dep_indices), ...]`` in
        submission order - equal across runs of the same program."""
        return [(n.name, n.lane, n.deps) for n in self.nodes]


def futurize(fn: Optional[Callable] = None, *, lane: Lane = Lane.COMPUTE,
             name: Optional[str] = None):
    """Mark ``fn`` as a node of the futurized tree.

    Inside ``tracing()`` each call defers onto the active graph and returns
    a ``PhyFuture`` (composable with ``when_all`` / ``tree_join`` and any
    other deferred work); outside, the call runs inline.

    Args:
        fn: the function to wrap (or None when used as ``@futurize(...)``
            with keyword arguments).
        lane: priority lane its nodes ride.
        name: per-trace node name base (default ``fn.__name__``); calls
            become ``name:0``, ``name:1``, ... within a trace.
    Returns:
        The wrapped function (original accessible as ``__futurized__``).
    """
    if fn is None:
        return functools.partial(futurize, lane=lane, name=name)
    base = name or fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tr = current_trace()
        if tr is None:
            return fn(*args, **kwargs)
        return tr.graph.defer(fn, *args, lane=lane,
                              name=tr.next_name(base), **kwargs)

    wrapper.__futurized__ = fn
    return wrapper


@contextlib.contextmanager
def tracing(graph: Optional[FuturizedGraph] = None, *, max_workers: int = 4,
            name: str = "traced"):
    """Activate futurized tracing: within the block, ``@futurize`` calls on
    this thread become nodes of ``graph`` (one is created - and shut down on
    exit - if not supplied).  Yields the ``Trace``."""
    own = graph is None
    g = graph if graph is not None else FuturizedGraph(
        max_workers=max_workers, name=name)
    tr = Trace(g)
    remove = g.add_trace_hook(tr.record)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(tr)
    try:
        yield tr
    finally:
        stack.pop()
        remove()
        if own:
            g.shutdown(wait=True)
