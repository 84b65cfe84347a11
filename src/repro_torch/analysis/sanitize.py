"""Runtime concurrency sanitizer for the futurized runtime (PHYRAX_SANITIZE=1).

Counterpart: ``repro/analysis/sanitize.py``, copied (pure Python): the
rule catalogue, the ``PHYRAX_SANITIZE`` activation, ``enabled()``,
``find_cycle`` and ``thread_stacks`` are the reference's; only the
logger is the port's own (``repro_torch.sanitize``).

This module is the *collection point* for dynamic diagnostics; the hooks
that feed it live in `core/futures.py` (wait-for-graph deadlock watchdog),
`distrib/messaging.py` (active-message protocol checks), `distrib/agas.py`
(pin/deref accounting, forwarding-stub chases), `distrib/runtime.py`
(steal-lease / membership-generation fencing) and
`distrib/collectives.py` (generation-key monotonicity).  It deliberately imports nothing from the rest of the
package so that `core.futures` can import it at module load without a
cycle.

Rule ids (dynamic layer — the static layer PHY001-PHY006 lives in
`analysis/lint.py`):

===========  ==============================================================
PHY101       deadlock: cycle in the wait-for graph, or a wait whose every
             progress path ends in an unproduced promise
PHY102       post to an unregistered active-message action
PHY103       non-monotone ring generation key (configure(gen=) regressed)
PHY104       reply/ack dropped because the peer is already dead
PHY105       unbalanced AGAS accounting (fetch-after-free, fetch or free of
             a never-registered gid)
PHY106       steal-lease violation: a task observed executing on two
             localities, or a steal under a stale membership generation
PHY107       deref chased a forwarding stub whose target is dead (freed
             value or lost locality after an elastic rebalance)
===========  ==============================================================

Activation: set ``PHYRAX_SANITIZE=1`` in the environment (inherited by
spawned localities), or use :func:`enabled` as a context manager in tests.
When inactive the hooks cost one dict lookup per wait and nothing else.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field

log = logging.getLogger("repro_torch.sanitize")

#: Dynamic rule catalogue (see DESIGN.md §12 for the full failure model).
DYNAMIC_RULES: dict[str, str] = {
    "PHY101": "wait-for-graph deadlock (cycle or unproduced-promise stall)",
    "PHY102": "post to unregistered active-message action",
    "PHY103": "non-monotone ring generation key",
    "PHY104": "reply to dead peer dropped",
    "PHY105": "unbalanced AGAS pin/deref accounting",
    "PHY106": "steal-lease violation (double execution or stale "
              "membership generation)",
    "PHY107": "deref through a dead forwarding stub",
}


class DeadlockError(RuntimeError):
    """Raised by sanitized waits instead of hanging forever.

    Carries the wait-for cycle (or stalled frontier) and a dump of every
    live thread's stack at detection time.
    """


@dataclass(frozen=True)
class Diagnostic:
    """One sanitizer finding: a stable rule id plus a human-readable message."""

    rule: str
    message: str
    detail: str = ""

    def __str__(self) -> str:
        head = f"{self.rule}: {self.message}"
        return f"{head}\n{self.detail}" if self.detail else head


@dataclass
class _Config:
    # seconds a single wait may stall before the watchdog scans for cycles
    deadlock_after: float = 2.0
    # seconds before a wait whose only frontier is unproduced promises raises
    orphan_after: float = 60.0
    # chunk size for sanitized condition waits (watchdog poll period)
    chunk: float = 0.25


@dataclass
class Sanitizer:
    """Thread-safe diagnostic sink shared by all sanitized components."""

    config: _Config = field(default_factory=_Config)
    _diags: list[Diagnostic] = field(default_factory=list)
    _once: set[str] = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record(self, rule: str, message: str, *, detail: str = "", once_key: str | None = None) -> Diagnostic | None:
        """Record one diagnostic; with ``once_key`` repeats are coalesced."""
        with self._lock:
            if once_key is not None:
                key = f"{rule}:{once_key}"
                if key in self._once:
                    return None
                self._once.add(key)
            diag = Diagnostic(rule, message, detail)
            self._diags.append(diag)
        log.warning("%s", diag)
        return diag

    def diagnostics(self, rule: str | None = None) -> list[Diagnostic]:
        with self._lock:
            return [d for d in self._diags if rule is None or d.rule == rule]

    def clear(self) -> None:
        with self._lock:
            self._diags.clear()
            self._once.clear()


_SANITIZER = Sanitizer()
_FORCED: int | None = None  # tri-state programmatic override (tests)


def get() -> Sanitizer:
    """The process-global sanitizer instance."""
    return _SANITIZER


def active() -> bool:
    """Whether sanitized code paths should collect diagnostics.

    Re-reads the environment on every call (cheap) so localities spawned
    with ``PHYRAX_SANITIZE=1`` arm themselves without import-order games.
    """
    if _FORCED is not None:
        return bool(_FORCED)
    return os.environ.get("PHYRAX_SANITIZE", "") not in ("", "0")


@contextlib.contextmanager
def enabled(*, deadlock_after: float | None = None, orphan_after: float | None = None, chunk: float | None = None):
    """Context manager: force the sanitizer on (tests) with tuned timeouts."""
    global _FORCED
    cfg = _SANITIZER.config
    prev = (_FORCED, cfg.deadlock_after, cfg.orphan_after, cfg.chunk)
    _FORCED = 1
    if deadlock_after is not None:
        cfg.deadlock_after = deadlock_after
    if orphan_after is not None:
        cfg.orphan_after = orphan_after
    if chunk is not None:
        cfg.chunk = chunk
    try:
        yield _SANITIZER
    finally:
        _FORCED, cfg.deadlock_after, cfg.orphan_after, cfg.chunk = prev


def config() -> _Config:
    cfg = _SANITIZER.config
    if _FORCED is None:  # env-driven runs may tune timeouts via env too
        try:
            cfg.deadlock_after = float(os.environ.get("PHYRAX_SANITIZE_DEADLOCK_S", cfg.deadlock_after))
            cfg.orphan_after = float(os.environ.get("PHYRAX_SANITIZE_ORPHAN_S", cfg.orphan_after))
        except ValueError:
            pass
    return cfg


def find_cycle(edges: dict[object, tuple[object, ...]], roots: tuple[object, ...]) -> list[object] | None:
    """Find one cycle reachable from ``roots`` in a digraph, or None.

    Iterative DFS with the classic white/grey/black coloring; returns the
    cycle as a list of vertices (first == repeated vertex is *not*
    appended).  Used by the deadlock watchdog over the bipartite
    thread/node wait-for graph.
    """
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[object, int] = {}
    parent: dict[object, object] = {}
    for root in roots:
        if color.get(root, WHITE) != WHITE:
            continue
        stack: list[tuple[object, int]] = [(root, 0)]
        color[root] = GREY
        while stack:
            v, i = stack[-1]
            nbrs = edges.get(v, ())
            if i < len(nbrs):
                stack[-1] = (v, i + 1)
                w = nbrs[i]
                c = color.get(w, WHITE)
                if c == GREY:
                    # unwind the grey chain from v back to w
                    cycle = [v]
                    node = v
                    while node != w:
                        node = parent[node]
                        cycle.append(node)
                    cycle.reverse()
                    return cycle
                if c == WHITE:
                    color[w] = GREY
                    parent[w] = v
                    stack.append((w, 0))
            else:
                color[v] = BLACK
                stack.pop()
    return None


def thread_stacks(idents: tuple[int, ...] | None = None) -> str:
    """Format current stacks of (a subset of) live threads for dumps."""
    import sys
    import traceback

    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out: list[str] = []
    for ident, frame in frames.items():
        if idents is not None and ident not in idents:
            continue
        out.append(f"--- thread {names.get(ident, '?')} (ident={ident}) ---")
        out.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(out)


def now() -> float:
    return time.monotonic()
