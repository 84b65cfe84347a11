"""Dryrun trace builders: the shape of a Plan's execution tree, statically.

Counterpart: ``repro/analysis/trace_builders.py`` (``train_trace``,
``serve_trace``, ``gateway_trace``, ``step_contract``, ``plan_traces``,
``waves_for``), copied: the port's ``Session.train``, ``serve`` and
``serve_stream`` build the reference's trees node for node, so the
mirrors are the same, and ``gateway_trace`` replays the port's own
``ReplicaRouter``.  ``step_contract`` reads the port's
``TrainStep.donated_buffers`` / ``DDPStep.donated_buffers``: the port
updates ``(params, opt)`` in place where JAX donates them, which forbids
the same late reads (PHY005).

``python -m repro_torch.analysis.phylint`` needs the futurized tree of
every shipped config *without* initializing parameters or touching
devices.  These builders construct
:class:`~repro_torch.analysis.lint.LintGraph`s that mirror — node for
node, name for name, edge for edge — the trees ``Session.train`` and
``Session.serve`` build at runtime (single-locality driver view).  A
parity test (`tests/test_torch_analysis.py`) traces a real session and
asserts the builder output matches, so the mirrors cannot drift silently.

Multi-locality sessions add promise/dispatch node pairs whose placement
depends on live membership; lint those from a real trace
(``LintGraph.from_trace``) or a live graph (``LintGraph.from_graph``)
instead of a static mirror.

``step_contract`` is different in kind: it models the *device-step
donation contract* (TrainStep updates ``(params, opt)`` in place where
the reference donates them via ``donate_argnums=(0, 1)``, DDPStep's apply
where it donates ``(1, 2)`` — DESIGN.md §11) as virtual ``device``
nodes with ``uses``/``donates`` annotations, which is what the PHY005
donation-after-use pass checks.  The host tree never sees these
buffers; the contract graph is where that hazard lives.
"""

from __future__ import annotations

import math

from .lint import LintGraph

#: Host-side prefetch lookahead (data/pipeline.py Prefetcher default).
PREFETCH_DEPTH = 2


def train_trace(
    plan,
    *,
    steps: int = 6,
    ckpt_every: int = 2,
    log_every: int = 2,
    ckpt: bool = True,
    depth: int = PREFETCH_DEPTH,
    start: int = 0,
) -> LintGraph:
    """The driver-side host tree of ``Session.train`` for this plan.

    Mirrors the standard, SPMD-shadow and fabric-DDP variants of the loop
    (DDP logs inline, so it has no ``log:`` nodes).  Raises for
    multi-locality standard training, whose placement-dependent
    promise/dispatch pairs cannot be mirrored statically.
    """
    ddp = bool(getattr(plan, "ddp", False))
    spmd = bool(getattr(plan, "spmd", False))
    if getattr(plan, "localities", 1) > 1 and not (ddp or spmd):
        raise ValueError(
            "train_trace mirrors the single-locality driver tree; lint a "
            "multi-locality run via LintGraph.from_trace / from_graph"
        )
    g = LintGraph(label=f"train[{getattr(plan, 'arch', '?')}]")
    scheduled: set[int] = set()

    def schedule(it: int) -> None:
        # Prefetcher.schedule: batches [it, it+depth) in flight; the final
        # iteration schedules one lookahead batch nobody consumes, which
        # prefetch.close() cancels — cancelled, not dead (PHY004 exempt).
        for s in range(it, it + depth):
            if s not in scheduled:
                scheduled.add(s)
                g.add(
                    f"prefetch:{s}",
                    lane="PREFETCH",
                    forced=s < steps,
                    cancelled=s >= steps,
                    src="data/pipeline.py Prefetcher",
                )

    pending: str | None = None  # previous save's manifest node name

    def save(step: int, retired: str | None) -> None:
        # CheckpointManager.save: gate -> shard -> manifest, chained on the
        # previous save by dependency edge (checkpoint/checkpoint.py).  The
        # chain edge is conservative: the runtime adds it only when the
        # previous save is still in flight (a finished one is consumed by
        # _raise_if_failed), so parity checks must normalize it away.
        nonlocal pending
        deps = [d for d in (retired, pending) if d is not None]
        g.add(f"ckpt:gate:{step}", lane="CHECKPOINT", deps=deps, src="checkpoint save")
        g.add(f"ckpt:shard0:{step}", lane="CHECKPOINT", deps=[f"ckpt:gate:{step}"], src="checkpoint save")
        pending = f"ckpt:manifest:{step}"
        g.add(pending, lane="CHECKPOINT", deps=[f"ckpt:shard0:{step}"], src="checkpoint save")

    for it in range(start, steps):
        schedule(it)
        if not ddp and (it + 1) % log_every == 0:
            g.add(f"log:{it}", lane="CHECKPOINT", forced=True, src="Session.train _force_and_log")
        if ckpt and (it + 1) % ckpt_every == 0:
            g.add(f"retire:{it}", lane="CHECKPOINT", src="Session.train step retirement")
            save(it + 1, f"retire:{it}")
    if ckpt and steps > start and steps % ckpt_every != 0:
        save(steps, None)  # final snapshot; gated only on the previous save
    if pending is not None:
        g.mark_forced(pending)  # ckpt.close() drains the last manifest
    g.has_forced_info = True
    return g


def serve_trace(
    plan,
    *,
    requests: int = 8,
    gen_len: int = 16,
    slots: int = 4,
) -> LintGraph:
    """The driver-side tree of ``Session.serve``: one PREFETCH wave-prep
    node per wave, a ``prefill`` joining the wave batch (plus the previous
    wave's decode tail as a dispatch-order edge), and ``gen_len`` chained
    ``decode`` nodes; only the final tail is forced."""
    if getattr(plan, "localities", 1) > 1:
        raise ValueError(
            "serve_trace mirrors the single-locality driver tree; lint a "
            "multi-locality run via LintGraph.from_trace / from_graph"
        )
    g = LintGraph(label=f"serve[{getattr(plan, 'arch', '?')}]")
    if requests <= 0:
        g.has_forced_info = True
        return g
    waiting = requests
    take = min(slots, waiting)
    waiting -= take
    batch = g.add("wave:0", lane="PREFETCH", src="Session.serve defer_wave")
    tail: int | None = None
    done, n_real, w = 0, take, 0
    while True:
        nxt: tuple[int, int] | None = None
        if waiting > 0 and done + n_real < requests:
            take = min(slots, waiting)
            waiting -= take
            nxt = (g.add(f"wave:{w + 1}", lane="PREFETCH", src="Session.serve defer_wave"), take)
        deps = [batch] if tail is None else [batch, tail]
        carry = g.add(f"prefill:w{w}", deps=deps, src="Session.serve")
        for t in range(gen_len):
            carry = g.add(f"decode:w{w}:t{t}", deps=[carry], src="Session.serve")
        tail = carry
        done += n_real
        if nxt is None:
            break
        batch, n_real = nxt
        w += 1
    g.mark_forced(tail)  # tail.result(): the whole chain retires through it
    return g


class _TraceReplica:
    """Static mirror of ``gateway._Replica``: one replica's slot/chain
    state inside ``gateway_trace`` (node ids instead of futures)."""

    def __init__(self, idx: int, slots: int, namespaced: bool):
        self.idx = idx
        self.ns = f"R{idx}:" if namespaced else ""
        self.admitted: list[int] = []
        self.residents: list[int | None] = [None] * slots
        self.carry: int | None = None
        self.prev_emit: int | None = None
        self.epoch = -1
        self.j = 0
        self.round_work: tuple[bool, list[int]] = (False, [])

    def has_residents(self) -> bool:
        return any(r is not None for r in self.residents)


def gateway_trace(
    plan,
    *,
    requests: int = 6,
    gen_len: int = 4,
    slots: int = 2,
    max_inflight: int | None = None,
    arrivals: list[int] | None = None,
    replicas: int | None = None,
) -> LintGraph:
    """The driver-side tree of ``Session.serve_stream`` (the gateway,
    DESIGN.md §14/§15) for a fault-free arrival script.

    Mirrors ``frontend/gateway.py``'s round loop exactly: per request a
    producer-backed ``request:r{i}`` promise, a PREFETCH ``stack:r{i}``
    and a ``prefill:r{i}``; per slot-membership epoch a ``refill:e{k}``
    joining the previous decode tail with the joiners' prefills; per
    round a ``decode:e{k}:t{j}`` with a chained CHECKPOINT
    ``emit:e{k}:t{j}``; and a forced ``finish:r{i}`` hanging off the emit
    that carried the request's last token.  With ``replicas > 1`` the
    *live* ``ReplicaRouter`` (purely structural: affinity, then least
    loaded, ties low) is replayed to route requests across N namespaced
    decode chains (``refill:R1:e{k}``...) - same class, same decisions,
    so the static tree matches the live one node for node.

    Args:
        arrivals: per-request arrival round (submission order); defaults
            to everyone at round 0.  Deadlines/faults are runtime-only -
            lint those via ``LintGraph.from_trace``.
        replicas: replica count (defaults to ``plan.replicas``).
    """
    if getattr(plan, "localities", 1) > 1:
        raise ValueError(
            "gateway_trace mirrors the single-locality driver tree; lint a "
            "multi-locality run via LintGraph.from_trace / from_graph"
        )
    # lazy: analysis must import without frontend (core.futures imports
    # the sanitizer, and frontend.gateway imports core.futures)
    from ..frontend.gateway import ReplicaRouter

    n_rep = replicas if replicas is not None else getattr(plan, "replicas", 1)
    g = LintGraph(label=f"gateway[{getattr(plan, 'arch', '?')}]"
                        + (f":x{n_rep}" if n_rep > 1 else ""))
    g.has_forced_info = True
    arrivals = list(arrivals) if arrivals is not None else [0] * requests
    if not arrivals:
        return g
    cap = max(1, max_inflight if max_inflight is not None
              else 2 * slots * n_rep)
    router = ReplicaRouter(n_rep)
    reps = [_TraceReplica(i, slots, namespaced=n_rep > 1)
            for i in range(n_rep)]
    queued = list(enumerate(arrivals))      # (rid index, at_round), FIFO
    pending: list[int] = []
    emitted = {i: 0 for i, _ in queued}
    prefill_of: dict[int, int] = {}
    round_ = 0

    def inflight() -> int:
        return sum(len(rep.admitted)
                   + sum(r is not None for r in rep.residents)
                   for rep in reps)

    while True:
        for i, at in [q for q in queued if q[1] <= round_]:
            queued.remove((i, at))
            g.add(f"request:r{i}", lane="CHECKPOINT", kind="promise",
                  producer="gateway", src="Gateway._register")
            pending.append(i)
        while pending and inflight() < cap:
            i = pending.pop(0)
            ridx = router.assign(f"r{i}")
            s = g.add(f"stack:r{i}", lane="PREFETCH", src="Gateway._admit")
            prefill_of[i] = g.add(f"prefill:r{i}", deps=[s],
                                  src="Gateway._admit")
            reps[ridx].admitted.append(i)
        for rep in reps:
            changed = False
            for s, i in enumerate(rep.residents):
                if i is not None and emitted[i] >= gen_len:
                    g.add(f"finish:r{i}", lane="CHECKPOINT",
                          deps=[rep.prev_emit], forced=True,
                          src="Gateway run drain")
                    rep.residents[s] = None
                    router.release(f"r{i}")
                    changed = True
            joiners: list[int] = []
            free = [s for s in range(slots) if rep.residents[s] is None]
            while free and rep.admitted:
                i = rep.admitted.pop(0)
                rep.residents[free.pop(0)] = i
                joiners.append(i)
                changed = True
            rep.round_work = (changed, joiners)
        if not any(rep.has_residents() for rep in reps):
            nxt = min((at for _, at in queued), default=None)
            if nxt is not None:
                round_ = max(round_ + 1, nxt)
                continue
            break
        for rep in reps:
            changed, joiners = rep.round_work
            if not rep.has_residents():
                continue
            if changed or rep.carry is None:
                rep.epoch += 1
                rep.j = 0
                # the live trace records dependency edges index-sorted
                deps = sorted(([] if rep.carry is None else [rep.carry])
                              + [prefill_of[i] for i in joiners])
                rep.carry = g.add(f"refill:{rep.ns}e{rep.epoch}",
                                  deps=deps, src="Gateway._refill_fn")
            rep.carry = g.add(f"decode:{rep.ns}e{rep.epoch}:t{rep.j}",
                              deps=[rep.carry], src="Gateway._decode_fn")
            emit_deps = (([] if rep.prev_emit is None else [rep.prev_emit])
                         + [rep.carry])
            rep.prev_emit = g.add(f"emit:{rep.ns}e{rep.epoch}:t{rep.j}",
                                  lane="CHECKPOINT", deps=emit_deps,
                                  src="Gateway._emit_fn")
            for i in rep.residents:
                if i is not None:
                    emitted[i] += 1
            rep.j += 1
        round_ += 1
    for rep in reps:
        if rep.prev_emit is not None:
            g.mark_forced(rep.prev_emit)   # run() drains every emit tail
    return g


def step_contract(plan, *, steps: int = 4, ckpt_every: int = 2) -> LintGraph:
    """The device-step donation contract as a lintable buffer-version graph.

    Buffers are versioned ``params@k`` / ``opt@k``: step ``k`` reads and
    donates version ``k`` and produces version ``k+1`` (in place, in the
    port); the synchronous host capture a checkpoint save performs (the
    owned numpy copies before the next step) reads version ``k+1``
    *before* step ``k+1`` donates it.  A capture modelled after the
    donating step is exactly the PHY005 hazard the DDPStep contract
    forbids.
    """
    from ..core import steps as steps_lib

    ddp = bool(getattr(plan, "ddp", False))
    donated = steps_lib.DDPStep.donated_buffers if ddp else steps_lib.TrainStep.donated_buffers
    g = LintGraph(label=f"step-contract[{getattr(plan, 'arch', '?')}]" + (":ddp" if ddp else ""))
    for it in range(steps):
        bufs = tuple(f"{b}@{it}" for b in donated)
        if ddp:
            # grad_fn reads params, the ring exchanges buckets, apply
            # donates (params, opt) — core/steps.py make_ddp_step
            g.add(f"grad:{it}", kind="device", uses=(f"params@{it}", f"batch@{it}"), src="DDPStep.grad_fn")
            g.add(f"ring:{it}", kind="device", uses=(f"buckets@{it}",), src="RingAllReduce")
            g.add(
                f"apply:{it}",
                kind="device",
                uses=bufs + (f"buckets@{it}",),
                donates=bufs,
                src="DDPStep.apply_fn updates (params, opt) in place",
            )
        else:
            g.add(
                f"step:{it}",
                kind="device",
                uses=bufs + (f"batch@{it}",),
                donates=bufs,
                src="TrainStep.fn updates (params, opt) in place",
            )
        if ckpt_every and (it + 1) % ckpt_every == 0:
            # synchronous host capture of the freshly produced versions
            g.add(
                f"capture:{it + 1}",
                kind="device",
                uses=tuple(f"{b}@{it + 1}" for b in donated),
                src="CheckpointManager.save host capture",
            )
    return g


def plan_traces(plan, *, steps: int = 6, requests: int = 8, gen_len: int = 4, slots: int = 4) -> dict[str, LintGraph]:
    """Every statically derivable tree for a plan, keyed by workload."""
    out = {
        "train": train_trace(plan, steps=steps),
        "step-contract": step_contract(plan, steps=steps),
    }
    if not getattr(plan, "ddp", False) and not getattr(plan, "spmd", False):
        out["serve"] = serve_trace(plan, requests=requests, gen_len=gen_len, slots=slots)
        out["gateway"] = gateway_trace(plan, requests=requests, gen_len=gen_len, slots=slots)
        out["gateway-replicas"] = gateway_trace(
            plan, requests=requests, gen_len=gen_len, slots=slots,
            replicas=max(2, getattr(plan, "replicas", 1)))
    return out


def waves_for(requests: int, slots: int) -> int:
    """Number of serve waves for a request count (helper for tests)."""
    return math.ceil(requests / slots) if requests > 0 else 0
