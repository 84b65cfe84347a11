"""The port's phylint (``repro_torch.analysis``, DESIGN.md §12) against the
reference's ``tests/test_analysis.py``: the same 23 checks within the port
(the static rule catalogue over seeded defects, the dryrun builders against
real traced sessions, the deadlock watchdog and the runtime sanitizer's
protocol checks in the multi-locality runtime), plus parity across the two
packages: each seeded defect gives both linters the same rule ids, and
``plan_traces`` builds the same trees (names, kinds, lanes, edges, forced
and cancelled flags) for every architecture and variant."""
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import lint as jax_lint
from repro.analysis import plan_traces as jax_plan_traces
from repro.analysis import sanitize as jax_sanitize
from repro.frontend import Plan as JaxPlan
from repro_torch.analysis import (DeadlockError, LintGraph, plan_traces,
                                  sanitize, serve_trace, step_contract,
                                  train_trace)
from repro_torch.analysis import gateway_trace
from repro_torch.analysis import lint as lint_mod
from repro_torch.configs import ARCH_IDS
from repro_torch.core.futures import FuturizedGraph
from repro_torch.frontend import Plan, tracing
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
ARRIVALS = (0, 0, 1, 3, 3)
VARIANTS = {"standard": {}, "ddp": {"ddp": True, "localities": 2},
            "spmd": {"spmd": True, "localities": 2}}


@pytest.fixture(autouse=True)
def _clean_sanitizer():
    sanitize.get().clear()
    yield
    sanitize.get().clear()


def _plan(**kw):
    return Plan(arch=kw.pop("arch", ARCH), device="cpu", **kw)


def _rules(graph, **kw):
    return [f.rule for f in lint_mod.lint(graph, **kw)]


# -- static rules over seeded defects, in both packages ----------------------

def _cycle(m):
    g = m.LintGraph(label="cyc")
    a = g.add("a")
    b = g.add("b", deps=[a])
    g.nodes[a].deps = (b,)                      # plant the back edge
    g.mark_forced(b)
    return g, {}


def _orphan(m):
    g = m.LintGraph(label="orph")
    p = g.add("entry", kind="promise")           # no producer registered
    g.mark_forced(g.add("consumer", deps=[p]))
    return g, {}


def _produced(m):
    g = m.LintGraph(label="ok")
    p = g.add("entry", kind="promise", producer="L1")
    g.mark_forced(g.add("consumer", deps=[p]))
    return g, {}


def _inversion(m):
    g = m.LintGraph(label="inv")
    s = g.add("ckpt:shard", lane="CHECKPOINT")
    g.mark_forced(g.add("step", lane="COMPUTE", deps=[s]))
    return g, {}


def _feed(strict):
    def build(m):
        g = m.LintGraph(label="feed")
        pf = g.add("prefetch:0", lane="PREFETCH")
        g.mark_forced(g.add("step:0", lane="COMPUTE", deps=[pf]))
        return g, {"strict_lanes": strict}
    return build


def _dead(m):
    g = m.LintGraph(label="dead")
    g.add("unused")
    g.add("kept", forced=True)
    return g, {}


def _no_forced_info(m):
    g = m.LintGraph(label="noinfo")
    g.add("unused")
    return g, {}


def _cancelled_sink(m):
    g = m.LintGraph(label="cancelled")
    g.add("prefetch:6", lane="PREFETCH", cancelled=True)
    g.mark_forced(g.add("kept"))
    return g, {}


def _donation(m):
    g = m.LintGraph(label="don")
    g.add("step:0", kind="device", uses=("params@0", "batch@0"),
          donates=("params@0",))
    g.add("capture:late", kind="device", uses=("params@0",))
    return g, {}


def _fanin(threshold):
    def build(m):
        g = m.LintGraph(label="fan")
        deps = [g.add(f"shard{i}") for i in range(70)]
        g.mark_forced(g.add("manifest", deps=deps))
        return g, {} if threshold is None else {"fanin_threshold": threshold}
    return build


SEEDED = {
    "cycle": (_cycle, ["PHY001"]),
    "orphan-promise": (_orphan, ["PHY002"]),
    "produced-promise": (_produced, []),
    "lane-inversion": (_inversion, ["PHY003"]),
    "feed-edge": (_feed(False), []),
    "feed-edge-strict": (_feed(True), ["PHY003"]),
    "dead-node": (_dead, ["PHY004"]),
    "no-forced-info": (_no_forced_info, []),
    "cancelled-sink": (_cancelled_sink, []),
    "donation-after-use": (_donation, ["PHY005"]),
    "fanin": (_fanin(None), ["PHY006"]),
    "fanin-raised": (_fanin(128), []),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_defect_gives_the_references_rule_ids(name):
    build, want = SEEDED[name]
    g, kw = build(lint_mod)
    found = lint_mod.lint(g, **kw)
    jg, jkw = build(jax_lint)
    jfound = jax_lint.lint(jg, **jkw)
    assert [f.rule for f in found] == [f.rule for f in jfound] == want
    assert [f.nodes for f in found] == [f.nodes for f in jfound]


def test_rule_catalogue_ids_are_stable():
    assert sorted(lint_mod.STATIC_RULES) == [
        "PHY001", "PHY002", "PHY003", "PHY004", "PHY005", "PHY006"]
    assert sorted(sanitize.DYNAMIC_RULES) == [
        "PHY101", "PHY102", "PHY103", "PHY104", "PHY105",
        "PHY106", "PHY107"]
    assert lint_mod.STATIC_RULES == jax_lint.STATIC_RULES
    assert sanitize.DYNAMIC_RULES == jax_sanitize.DYNAMIC_RULES


def test_seeded_cycle_is_exactly_phy001():
    g, _ = _cycle(lint_mod)
    found = lint_mod.lint(g)
    assert [f.rule for f in found] == ["PHY001"]
    assert set(found[0].nodes) == {"a", "b"}


def test_seeded_orphan_promise_is_exactly_phy002():
    assert _rules(_orphan(lint_mod)[0]) == ["PHY002"]
    assert _rules(_produced(lint_mod)[0]) == []


def test_seeded_lane_inversion_is_exactly_phy003():
    assert _rules(_inversion(lint_mod)[0]) == ["PHY003"]


def test_prefetch_feed_edge_exempt_unless_strict():
    g, _ = _feed(False)(lint_mod)
    assert _rules(g) == []
    assert _rules(g, strict_lanes=True) == ["PHY003"]


def test_dead_node_is_phy004_only_with_forced_info():
    assert _rules(_dead(lint_mod)[0]) == ["PHY004"]
    assert _rules(_no_forced_info(lint_mod)[0]) == []
    assert _rules(_cancelled_sink(lint_mod)[0]) == []


def test_seeded_donation_after_use_is_exactly_phy005():
    found = lint_mod.lint(_donation(lint_mod)[0])
    assert [f.rule for f in found] == ["PHY005"]
    assert "params@0" in found[0].message


def test_fanin_hotspot_is_phy006():
    g, _ = _fanin(None)(lint_mod)
    assert _rules(g) == ["PHY006"]
    assert _rules(g, fanin_threshold=128) == []


# -- shipped configs lint clean, and their trees are the reference's ---------

def test_every_shipped_config_dryrun_lints_clean():
    graphs = 0
    for aid in ARCH_IDS:
        for extra in VARIANTS.values():
            for name, g in plan_traces(_plan(arch=aid, **extra)).items():
                graphs += 1
                assert _rules(g) == [], (aid, extra, name)
    assert graphs >= 3 * len(ARCH_IDS)


def _shape(g):
    return [(n.name, n.kind, n.lane, tuple(g.nodes[d].name for d in n.deps),
             n.forced, n.cancelled, n.producer, n.uses, n.donates)
            for n in g.nodes]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_traces_are_the_references(arch, variant):
    """Node for node: names, kinds, lanes, edges, forced and cancelled
    flags, producers and the donation contract's buffers."""
    extra = VARIANTS[variant]
    mine = plan_traces(_plan(arch=arch, **extra))
    ref = jax_plan_traces(JaxPlan(arch=arch, tiny=True, **extra))
    assert sorted(mine) == sorted(ref)
    for name in mine:
        assert mine[name].label == ref[name].label
        assert _shape(mine[name]) == _shape(ref[name]), name


def test_phylint_cli_strict_is_clean_and_lists_the_references_rules():
    cli = [sys.executable, "-m", "repro_torch.analysis.phylint"]
    env = {"PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(cli + ["--all-configs", "--strict"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"over {len(ARCH_IDS)} config(s): clean" in out.stdout
    rules = subprocess.run(cli + ["--list-rules"], env=env,
                           capture_output=True, text=True, timeout=120)
    listed = [line.split()[0] for line in rules.stdout.splitlines()]
    assert listed == sorted({**jax_lint.STATIC_RULES,
                             **jax_sanitize.DYNAMIC_RULES})
    bad = subprocess.run(cli + ["--arch", "no-such-arch"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "unknown arch" in bad.stderr


def test_multi_locality_standard_train_trace_refuses():
    with pytest.raises(ValueError, match="from_trace"):
        train_trace(_plan(localities=2))


def test_step_contract_declares_real_donation_sets():
    from repro_torch.core import steps as steps_lib
    assert steps_lib.TrainStep.donated_buffers == ("params", "opt")
    assert steps_lib.DDPStep.donated_buffers == ("params", "opt")
    assert steps_lib.ServeStep.donated_buffers == ("cache",)
    for ddp in (False, True):
        g = step_contract(_plan(ddp=ddp, localities=2 if ddp else 1))
        assert _rules(g) == []


# -- builder parity with real traced sessions -------------------------------

def _shape_set(nodes, name_of):
    """{(name, lane, dep-names)} with the timing-dependent ckpt chain edge
    (gate -> previous manifest, present only when the previous save is
    still in flight) normalized away."""
    out = set()
    for n in nodes:
        deps = tuple(name_of(d) for d in n.deps)
        if n.name.startswith("ckpt:gate:"):
            deps = tuple(d for d in deps if not d.startswith("ckpt:manifest:"))
        out.add((n.name, n.lane, deps))
    return out


def test_builders_mirror_traced_session_and_live_graph_lints_clean(tmp_path):
    plan = _plan(batch=4, seq=16)
    with plan.compile() as session:
        with tracing(graph=session.runtime) as tr:
            session.train(steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
                          log_every=2, verbose=False)
        real = _shape_set(tr.nodes, lambda d: tr.nodes[d].name)
        built_g = train_trace(plan, steps=6, ckpt_every=2, log_every=2)
        built = _shape_set(built_g.nodes, lambda d: built_g.nodes[d].name)
        assert real == built

        # the trace-derived graph and the live runtime graph lint clean
        assert _rules(LintGraph.from_trace(tr)) == []
        assert [f.rule for f in session.lint()] == []

        out = session.serve(requests=4, slots=2, prompt_len=16, gen_len=4,
                            verbose=False)
    sig = out["trace"]
    real_serve = {(n, lane, tuple(sig[d][0] for d in deps))
                  for n, lane, deps in sig}
    g = serve_trace(plan, requests=4, gen_len=4, slots=2)
    built_serve = {(n.name, n.lane, tuple(g.nodes[d].name for d in n.deps))
                   for n in g.nodes}
    assert real_serve == built_serve


def test_ddp_builder_mirrors_traced_session(tmp_path):
    """The DDP loop logs inline, as the reference's does: its tree is
    ``train_trace``'s DDP mirror, without ``log:`` nodes."""
    plan = _plan(batch=4, seq=16, ddp=True, ddp_shards=2)
    with plan.compile() as session:
        with tracing(graph=session.runtime) as tr:
            out = session.train(steps=6, ckpt_dir=str(tmp_path),
                                ckpt_every=2, log_every=2, verbose=False)
        assert [f.rule for f in session.lint()] == []
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    real = _shape_set(tr.nodes, lambda d: tr.nodes[d].name)
    built_g = train_trace(plan, steps=6, ckpt_every=2, log_every=2)
    assert real == _shape_set(built_g.nodes,
                              lambda d: built_g.nodes[d].name)


@pytest.mark.parametrize("replicas", [1, 2])
def test_gateway_builder_mirrors_the_live_gateway(replicas):
    """The static mirror replays the port's own ReplicaRouter, so its tree
    is the live ``serve_stream``'s node for node."""
    with _plan().compile() as session:
        out = session.serve_stream(
            trace=[{"at_round": r} for r in ARRIVALS], replicas=replicas,
            prompt_len=16, gen_len=4, slots=2, verbose=False)
        assert [f.rule for f in session.lint()] == []
    sig = out["trace"]
    live = {(name, lane, tuple(sig[d][0] for d in deps))
            for name, lane, deps in sig}
    g = gateway_trace(_plan(), requests=len(ARRIVALS), gen_len=4, slots=2,
                      arrivals=list(ARRIVALS), replicas=replicas)
    assert live == {(n.name, n.lane, tuple(g.nodes[d].name for d in n.deps))
                    for n in g.nodes}


# -- dynamic sanitizer --------------------------------------------------------

def test_sanitizer_env_activation(monkeypatch):
    monkeypatch.delenv("PHYRAX_SANITIZE", raising=False)
    assert not sanitize.active()
    monkeypatch.setenv("PHYRAX_SANITIZE", "1")
    assert sanitize.active()
    monkeypatch.setenv("PHYRAX_SANITIZE", "0")
    assert not sanitize.active()


def test_watchdog_raises_on_pool_exhaustion_deadlock():
    g = FuturizedGraph(max_workers=1, name="dl")
    try:
        with sanitize.enabled(deadlock_after=0.3, chunk=0.05):
            def outer():
                return g.defer(lambda: 42, name="inner").result(timeout=30)
            f = g.defer(outer, name="outer")
            with pytest.raises(DeadlockError, match="PHY101"):
                f.result(timeout=15)
        diags = sanitize.get().diagnostics("PHY101")
        assert diags and "inner" in diags[0].detail   # the dumped cycle
    finally:
        g.shutdown(wait=False)


def test_watchdog_raises_on_unproduced_promise_stall():
    g = FuturizedGraph(max_workers=2, name="stall")
    try:
        with sanitize.enabled(deadlock_after=0.2, orphan_after=0.5,
                              chunk=0.05):
            p = g.promise(name="never")          # nobody committed to it
            f = g.defer(lambda x: x, p, name="consumer")
            with pytest.raises(DeadlockError, match="promise"):
                f.result(timeout=15)
        p.set_result(None)                       # unwedge for shutdown
    finally:
        g.shutdown(wait=True)


def test_watchdog_trusts_producer_backed_promises():
    g = FuturizedGraph(max_workers=2, name="prod")
    try:
        with sanitize.enabled(deadlock_after=0.2, orphan_after=0.5,
                              chunk=0.05):
            p = g.promise(name="ext", producer="L1")
            f = g.defer(lambda x: x + 1, p, name="consumer")
            threading.Timer(1.0, lambda: p.set_result(41)).start()
            assert f.result(timeout=15) == 42    # waited past orphan_after
        assert sanitize.get().diagnostics() == []
    finally:
        g.shutdown(wait=True)


def test_unarmed_waits_take_the_plain_path(monkeypatch):
    """Unarmed, a wait never enters the watchdog's chunked loop."""
    monkeypatch.delenv("PHYRAX_SANITIZE", raising=False)
    g = FuturizedGraph(max_workers=1, name="plain")
    calls = []
    monkeypatch.setattr(g, "_sanitized_wait_locked",
                        lambda *a: calls.append(a))
    try:
        assert g.defer(lambda: 7, name="seven").result(timeout=10) == 7
        g.barrier(timeout=10)
    finally:
        g.shutdown(wait=True)
    assert calls == []


def test_unregistered_post_counted_and_warned_once(caplog):
    from repro_torch.distrib.messaging import Endpoint
    a, b = Endpoint(0), Endpoint(1)
    try:
        a.connect(1, b.address)
        with sanitize.enabled():
            with caplog.at_level("WARNING", logger="repro_torch.distrib"):
                a.post(1, "no_such_action", {"x": 1})
                a.post(1, "no_such_action", {"x": 2})
                deadline = time.monotonic() + 10
                while (b.unhandled_posts["no_such_action"] < 2
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
        assert b.unhandled_posts["no_such_action"] == 2
        warned = [r for r in caplog.records if r.name == "repro_torch.distrib"
                  and "no_such_action" in r.getMessage()]
        assert len(warned) == 1                  # warn once per action name
        diags = sanitize.get().diagnostics("PHY102")
        assert len(diags) == 1                   # coalesced by (rank, action)
    finally:
        a.close()
        b.close()


def test_ack_to_a_dead_requester_is_phy104():
    """A reply whose requester is gone is dropped and flagged: the
    handler finishes after the requester's endpoint closed and nothing
    listens at its address any more."""
    from repro_torch.distrib.messaging import Endpoint
    from repro_torch.launch.mesh import free_port
    a, b = Endpoint(0), Endpoint(1)
    release = threading.Event()
    entered = threading.Event()

    def slow(src, p):
        entered.set()
        release.wait(10)
        return p

    b.register("slow", slow)
    try:
        a.connect(1, b.address)
        with sanitize.enabled():
            t = threading.Thread(target=lambda: _swallow(
                lambda: a.request(1, "slow", 1, timeout=10)))
            t.start()
            assert entered.wait(10)
            a.close()                             # the requester dies
            time.sleep(0.3)                       # ... and b sees it go;
            # its process is gone too: nothing listens at its address
            b.address_book[0] = ("127.0.0.1", free_port())
            release.set()
            deadline = time.monotonic() + 10
            while not sanitize.get().diagnostics("PHY104") \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            diags = sanitize.get().diagnostics("PHY104")
            t.join(10)
        assert len(diags) == 1 and "'slow'" in diags[0].message
    finally:
        release.set()
        b.close()


def _swallow(fn):
    try:
        fn()
    except Exception:  # noqa: BLE001 - the requester's own end
        pass


def test_agas_fetch_after_free_and_bad_free_are_phy105():
    from repro_torch.distrib.agas import ObjectDirectory, RemoteRef
    d = ObjectDirectory(rank=0)
    ref = d.put({"w": 1}, summary="weights")
    assert d.fetch(ref) == {"w": 1}
    d.free(ref)
    with sanitize.enabled():
        with pytest.raises(KeyError):
            d.fetch(ref)
        d.free(RemoteRef(gid=(0, 999)))          # never registered
        kinds = [x.message for x in sanitize.get().diagnostics("PHY105")]
    assert any("fetch after free" in m for m in kinds)
    assert any("never-registered" in m for m in kinds)
    assert d.audit() == {"live": 0, "puts": 1, "local_fetches": 1,
                         "frees": 1, "migrated": 0, "forwarded_fetches": 0}


def test_double_spawn_same_tid_is_phy106():
    """Seeded steal-lease violation: the same tid lands on one locality
    twice - the duplicate is dropped and flagged, never run twice."""
    from repro_torch.core.futures import Lane
    from repro_torch.distrib.messaging import Endpoint
    from repro_torch.distrib.runtime import Locality

    drv = Endpoint(0)
    drv.register("task_done", lambda src, msg: None)
    loc = Locality(7, world=2)
    try:
        loc.endpoint.connect(0, drv.address)
        payload = {"tid": "t0", "name": "dup", "lane": int(Lane.COMPUTE),
                   "pin": False, "gen": 0, "fn": sorted,
                   "args": ([3, 1, 2],), "kwargs": {}}
        with sanitize.enabled():
            loc._on_spawn(0, dict(payload))
            loc._on_spawn(0, dict(payload))      # the violation
            diags = sanitize.get().diagnostics("PHY106")
        assert len(diags) == 1 and "spawned here twice" in diags[0].message
    finally:
        loc.graph.shutdown(wait=True, cancel_pending=True)
        loc.endpoint.close()
        drv.close()


def test_stale_generation_steal_request_is_phy106():
    """Seeded membership-generation fence: a steal_request planned under a
    stale peer table is refused with ``stale`` (and the current
    generation to re-sync from), never handed a task."""
    from repro_torch.distrib.runtime import DistributedGraph

    g = DistributedGraph(localities=1, elastic=True)
    try:
        g.group.gen = 3
        with sanitize.enabled():
            out = g._on_steal_request(5, {"thief": 5, "gen": 1})
            diags = sanitize.get().diagnostics("PHY106")
        assert out["stale"] and out["handed"] == 0 and out["gen"] == 3
        assert len(diags) == 1 and "stale membership generation" \
            in diags[0].message
    finally:
        g.shutdown()


def test_dead_forwarding_stub_deref_is_phy107():
    """Seeded dead-stub chase: a forwarding stub whose migrated target is
    gone must raise AND be flagged."""
    from repro_torch.distrib.agas import ObjectDirectory, RemoteRef, _Forward

    d = ObjectDirectory(rank=0)
    ref = d.put({"w": 1}, summary="weights")
    d._store[ref.gid[1]] = _Forward(ref=RemoteRef(gid=(0, 999)))
    with sanitize.enabled():
        with pytest.raises(KeyError):
            d.fetch(ref)
        diags = sanitize.get().diagnostics("PHY107")
    assert len(diags) == 1 and "forwarding stub" in diags[0].message
    assert d.audit()["forwarded_fetches"] == 1


def test_ring_generation_regression_is_phy103():
    import torch

    from repro_torch.core.fusion import make_plan
    from repro_torch.distrib.collectives import RingAllReduce

    ring = RingAllReduce(None, world=1)
    plan = make_plan({"w": torch.zeros((4, 4))})
    with sanitize.enabled():
        ring.configure("fp32", plan, gen=5)
        ring.configure("fp32", plan, gen=3)      # stale generation resurfaces
        diags = sanitize.get().diagnostics("PHY103")
    assert len(diags) == 1 and "5 -> 3" in diags[0].message
