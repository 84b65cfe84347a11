"""phylint — static passes over the futurized execution tree.

Counterpart: ``repro/analysis/lint.py``, copied (pure Python): the IR,
its three importers and the PHY001-PHY006 passes are the reference's,
rule ids included.  Its graphs come from the port's ``FuturizedGraph``
(``snapshot()``) and ``frontend.futurize.Trace``; PHY005's donation
contract is the port's in-place update of ``(params, opt)`` and of the
decode cache (``core/steps.py``), which forbids the same late reads.

The linter runs over a :class:`LintGraph`, a small immutable-ish IR that
can be built three ways:

* :meth:`LintGraph.from_trace` — from a ``@futurize``/:func:`repro_torch.frontend.futurize.tracing`
  :class:`~repro_torch.frontend.futurize.Trace` (no execution needed beyond what
  produced the trace);
* :meth:`LintGraph.from_graph` — from a live :class:`~repro_torch.core.futures.FuturizedGraph`
  via its ``snapshot()`` (post-mortem or mid-run inspection);
* directly via :meth:`LintGraph.add` — used by the dryrun trace builders in
  :mod:`repro_torch.analysis.trace_builders` and by tests that seed defects.

Rule catalogue (static layer; the dynamic PHY1xx layer lives in
``analysis/sanitize.py``, full failure model in DESIGN.md §12):

===========  ==============================================================
PHY001       dependency cycle in the execution tree
PHY002       orphaned promise: created but no producer ever registered
PHY003       lane-priority inversion: a node depends on strictly
             lower-priority work (COMPUTE waiting on CHECKPOINT).  The
             PREFETCH -> COMPUTE feed edge is the sanctioned hand-off
             pattern and is exempt unless ``strict_lanes=True``.
PHY004       dead node: a sink whose result is never forced (and was not
             explicitly cancelled) — scheduled work nobody observes
PHY005       donation-after-use: a buffer donated to a jitted step is
             referenced by a later node (the DDPStep donation contract)
PHY006       fan-in hotspot: one node joins >= ``fanin_threshold`` deps
             directly (a serialization point the scheduler cannot hide)
===========  ==============================================================

Every finding carries the stable rule id, the node names involved and a
source hint, so CI output is grep-able and tests can assert exact ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable, Sequence

if TYPE_CHECKING:  # pragma: no cover - import only for annotations
    from ..core.futures import FuturizedGraph
    from ..frontend.futurize import Trace

#: Static rule catalogue (id -> one-line summary).
STATIC_RULES: dict[str, str] = {
    "PHY001": "dependency cycle in the execution tree",
    "PHY002": "orphaned promise (no producer registered)",
    "PHY003": "lane-priority inversion",
    "PHY004": "dead node (result never forced)",
    "PHY005": "donated buffer referenced after donation",
    "PHY006": "fan-in hotspot",
}

#: Lane priorities, mirroring core.futures.Lane (lower value = higher
#: priority). Kept as a plain dict so the IR stays importable standalone.
_LANE_PRIO = {"COMPUTE": 0, "PREFETCH": 1, "CHECKPOINT": 2}

#: Default PHY006 threshold: a direct fan-in this wide is a join the
#: scheduler cannot overlap away (ckpt manifests joining every shard stay
#: far below this for any shipped topology).
DEFAULT_FANIN_THRESHOLD = 64


@dataclass(frozen=True)
class Finding:
    """One linter finding with a stable rule id."""

    rule: str
    message: str
    nodes: tuple[str, ...] = ()
    src: str = ""

    def __str__(self) -> str:
        where = f" [{', '.join(self.nodes)}]" if self.nodes else ""
        hint = f" ({self.src})" if self.src else ""
        return f"{self.rule} {self.message}{where}{hint}"


@dataclass
class LintNode:
    """IR node: one future in the execution tree.

    ``kind`` is one of ``task`` (deferred callable), ``promise``
    (externally resolved), ``immediate`` (already-done constant) or
    ``device`` (virtual node modelling a jitted device step for the
    donation contract — produced only by the step-contract builders).
    """

    index: int
    name: str
    lane: str = "COMPUTE"
    kind: str = "task"
    deps: tuple[int, ...] = ()
    forced: bool = False
    cancelled: bool = False
    producer: str = ""
    uses: tuple[str, ...] = ()
    donates: tuple[str, ...] = ()
    src: str = ""


class LintGraph:
    """The linter's IR: an ordered list of nodes with integer-index deps."""

    def __init__(self, label: str = "") -> None:
        self.label = label
        self.nodes: list[LintNode] = []
        self._by_name: dict[str, int] = {}
        # PHY004 only fires when the builder declared which results are
        # forced; raw traces carry no such information.
        self.has_forced_info = False

    # -- construction -------------------------------------------------

    def add(
        self,
        name: str,
        *,
        lane: str = "COMPUTE",
        kind: str = "task",
        deps: Sequence[int | str] = (),
        forced: bool = False,
        cancelled: bool = False,
        producer: str = "",
        uses: Sequence[str] = (),
        donates: Sequence[str] = (),
        src: str = "",
    ) -> int:
        """Append a node; ``deps`` may mix indices and (last-bound) names."""
        idx = len(self.nodes)
        dep_idx = tuple(self._resolve(d) for d in deps)
        self.nodes.append(
            LintNode(
                index=idx,
                name=name,
                lane=lane,
                kind=kind,
                deps=dep_idx,
                forced=forced,
                cancelled=cancelled,
                producer=producer,
                uses=tuple(uses),
                donates=tuple(donates),
                src=src,
            )
        )
        self._by_name[name] = idx
        if forced:
            self.has_forced_info = True
        return idx

    def _resolve(self, dep: int | str) -> int:
        if isinstance(dep, str):
            if dep not in self._by_name:
                raise KeyError(f"unknown dep name {dep!r} in lint graph {self.label!r}")
            return self._by_name[dep]
        if not 0 <= dep < len(self.nodes):
            raise IndexError(f"dep index {dep} out of range in lint graph {self.label!r}")
        return int(dep)

    def mark_forced(self, *refs: int | str) -> None:
        """Declare that these nodes' results are observed by the program."""
        for ref in refs:
            self.nodes[self._resolve(ref)].forced = True
        self.has_forced_info = True

    # -- importers ----------------------------------------------------

    @classmethod
    def from_trace(cls, trace: "Trace", *, forced: Iterable[int | str] | None = None, label: str = "") -> "LintGraph":
        """Build the IR from a recorded ``@futurize`` trace.

        ``forced`` optionally declares which node results the program
        observes; without it the PHY004 dead-node pass is skipped (a raw
        trace cannot know what the caller later forces).
        """
        g = cls(label or "trace")
        for tn in trace.nodes:
            g.add(
                tn.name,
                lane=tn.lane,
                kind=getattr(tn, "kind", "task"),
                deps=tuple(tn.deps),
                producer=getattr(tn, "producer", ""),
                src=f"trace[{tn.index}]",
            )
        if forced is not None:
            g.mark_forced(*forced)
        return g

    @classmethod
    def from_graph(cls, graph: "FuturizedGraph", *, label: str = "") -> "LintGraph":
        """Build the IR from a live graph via ``FuturizedGraph.snapshot()``.

        The snapshot knows true per-node state, so forced/cancelled flags
        are exact: ``forced`` means someone called ``result()`` /
        ``exception()``, attached a done-callback, or deferred a
        dependent onto the value (``fanout`` - the dependent itself may
        already be collected from the snapshot); resolved promises count
        as produced even without a declared producer.
        """
        g = cls(label or "graph")
        seq_to_idx: dict[int, int] = {}
        for snap in graph.snapshot():
            deps = tuple(seq_to_idx[s] for s in snap["deps"] if s in seq_to_idx)
            producer = snap["producer"]
            if snap["kind"] == "promise" and not producer and snap["state"] not in ("PENDING",):
                producer = "<resolved>"
            idx = g.add(
                snap["name"],
                lane=snap["lane"],
                kind=snap["kind"],
                deps=deps,
                forced=snap["observed"] or snap.get("fanout", 0) > 0,
                cancelled=snap["state"] == "CANCELLED",
                producer=producer,
                src=f"seq={snap['seq']} state={snap['state']}",
            )
            seq_to_idx[snap["seq"]] = idx
        g.has_forced_info = True
        return g

    # -- misc ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.nodes)

    def names(self) -> list[str]:
        return [n.name for n in self.nodes]


# ----------------------------------------------------------------------
# passes
# ----------------------------------------------------------------------


def _pass_cycles(g: LintGraph) -> list[Finding]:
    """PHY001 via Tarjan SCC: every SCC of size > 1 (or a self-loop) is a cycle."""
    n = len(g.nodes)
    index = [0] * n
    low = [0] * n
    on_stack = [False] * n
    visited = [False] * n
    stack: list[int] = []
    counter = [1]
    findings: list[Finding] = []

    def strongconnect(v0: int) -> None:
        work = [(v0, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                visited[v] = True
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            deps = g.nodes[v].deps
            for i in range(pi, len(deps)):
                w = deps[i]
                if not visited[w]:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1 or v in g.nodes[v].deps:
                    names = tuple(g.nodes[i].name for i in sorted(scc))
                    findings.append(
                        Finding(
                            "PHY001",
                            f"dependency cycle of {len(scc)} node(s): forcing any of them deadlocks",
                            nodes=names,
                            src=g.nodes[scc[0]].src,
                        )
                    )
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])

    for v in range(n):
        if not visited[v]:
            strongconnect(v)
    return findings


def _pass_orphan_promises(g: LintGraph) -> list[Finding]:
    """PHY002: a promise nobody ever committed to resolving."""
    out = []
    for node in g.nodes:
        if node.kind == "promise" and not node.producer and not node.cancelled:
            out.append(
                Finding(
                    "PHY002",
                    f"promise {node.name!r} has no registered producer; any wait on it hangs",
                    nodes=(node.name,),
                    src=node.src,
                )
            )
    return out


def _pass_lane_inversion(g: LintGraph, *, strict_lanes: bool) -> list[Finding]:
    """PHY003: higher-priority node blocked behind lower-priority work."""
    out = []
    for node in g.nodes:
        np_ = _LANE_PRIO.get(node.lane, 0)
        for d in node.deps:
            dep = g.nodes[d]
            dp = _LANE_PRIO.get(dep.lane, 0)
            if np_ >= dp:
                continue
            if not strict_lanes and dep.lane == "PREFETCH" and node.lane == "COMPUTE":
                continue  # sanctioned feed edge: compute consuming prefetched input
            out.append(
                Finding(
                    "PHY003",
                    f"{node.lane} node {node.name!r} depends on {dep.lane} node "
                    f"{dep.name!r}: the high-priority lane inherits the low one's latency",
                    nodes=(node.name, dep.name),
                    src=node.src,
                )
            )
    return out


def _pass_dead_nodes(g: LintGraph) -> list[Finding]:
    """PHY004: sinks nobody forces — scheduled work with no observer."""
    if not g.has_forced_info:
        return []
    has_dependent = [False] * len(g.nodes)
    for node in g.nodes:
        for d in node.deps:
            has_dependent[d] = True
    out = []
    for node in g.nodes:
        if has_dependent[node.index] or node.forced or node.cancelled:
            continue
        if node.kind in ("immediate", "promise", "device"):
            continue  # covered by PHY002 / not host work
        out.append(
            Finding(
                "PHY004",
                f"node {node.name!r} is never forced and has no dependents; "
                "its work (and any error it raises) is silently dropped",
                nodes=(node.name,),
                src=node.src,
            )
        )
    return out


def _pass_donation(g: LintGraph) -> list[Finding]:
    """PHY005: buffer referenced at/after the submission point that donates it.

    Submission order approximates execution order for the step sequence;
    a node submitted after the donating step that still names the donated
    buffer is reading memory XLA has already been told it may reuse.
    """
    donated_at: dict[str, int] = {}
    out = []
    for node in g.nodes:
        for buf in node.uses:
            d = donated_at.get(buf)
            if d is not None:
                out.append(
                    Finding(
                        "PHY005",
                        f"node {node.name!r} reads buffer {buf!r} already donated by "
                        f"{g.nodes[d].name!r} (donate_argnums contract)",
                        nodes=(g.nodes[d].name, node.name),
                        src=node.src,
                    )
                )
        for buf in node.donates:
            d = donated_at.get(buf)
            if d is not None:
                out.append(
                    Finding(
                        "PHY005",
                        f"node {node.name!r} re-donates buffer {buf!r} already donated by "
                        f"{g.nodes[d].name!r}",
                        nodes=(g.nodes[d].name, node.name),
                        src=node.src,
                    )
                )
            else:
                donated_at[buf] = node.index
    return out


def _pass_fanin(g: LintGraph, *, threshold: int) -> list[Finding]:
    """PHY006: direct joins wide enough to serialize the scheduler."""
    out = []
    for node in g.nodes:
        if len(node.deps) >= threshold:
            out.append(
                Finding(
                    "PHY006",
                    f"node {node.name!r} joins {len(node.deps)} dependencies directly "
                    f"(threshold {threshold}); consider a tree reduction",
                    nodes=(node.name,),
                    src=node.src,
                )
            )
    return out


def lint(
    obj: "LintGraph | Trace | FuturizedGraph",
    *,
    strict_lanes: bool = False,
    fanin_threshold: int = DEFAULT_FANIN_THRESHOLD,
) -> list[Finding]:
    """Run every static pass; returns findings ordered by rule id.

    ``obj`` may be a :class:`LintGraph`, a frontend ``Trace`` or a live
    ``FuturizedGraph`` (snapshotted without executing anything further).
    """
    g = _coerce(obj)
    findings: list[Finding] = []
    findings += _pass_cycles(g)
    findings += _pass_orphan_promises(g)
    findings += _pass_lane_inversion(g, strict_lanes=strict_lanes)
    findings += _pass_dead_nodes(g)
    findings += _pass_donation(g)
    findings += _pass_fanin(g, threshold=fanin_threshold)
    findings.sort(key=lambda f: (f.rule, f.nodes))
    return findings


def _coerce(obj: "LintGraph | Trace | FuturizedGraph") -> LintGraph:
    if isinstance(obj, LintGraph):
        return obj
    # duck-typed: a Trace has .nodes of TraceNode, a graph has .snapshot()
    if hasattr(obj, "snapshot"):
        return LintGraph.from_graph(obj)  # type: ignore[arg-type]
    if hasattr(obj, "nodes"):
        return LintGraph.from_trace(obj)  # type: ignore[arg-type]
    raise TypeError(f"cannot lint object of type {type(obj).__name__}")
