"""The futurized runtime's core cases, held for both the JAX package's
``repro.core.futures`` and the port's ``repro_torch.core.futures``:
dependency edges, combinators, lane priority, error poisoning and
cancellation, promises, stats and the shutdown barrier.  No wall-clock
thresholds: every ordering is forced by events."""
import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.futures as jax_futures
import repro_torch.core.futures as torch_futures
import torch_threads

torch_threads.apply()

# the frontend packages re-export the decorator under the module's name
jax_futurize = importlib.import_module("repro.frontend.futurize")
torch_futurize = importlib.import_module("repro_torch.frontend.futurize")

IMPLS = {"repro": (jax_futures, jax_futurize, jnp.ones),
         "repro_torch": (torch_futures, torch_futurize, torch.ones)}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


@pytest.fixture()
def fut(impl):
    return impl[0]


@pytest.fixture()
def graph(fut):
    g = fut.FuturizedGraph(max_workers=2, name="test")
    yield g
    g.shutdown(wait=False, cancel_pending=True)


# -- dependency edges -------------------------------------------------------

def test_chain_runs_in_edge_order(graph, fut):
    order = []

    def tag(name, value):
        order.append(name)
        return value

    a = graph.defer(tag, "a", 2, name="a")
    b = graph.defer(lambda x: tag("b", x * 3), a, name="b")
    c = graph.defer(lambda x, y: tag("c", x + y), a, b, name="c")
    assert c.result(timeout=10) == 8
    assert order == ["a", "b", "c"]
    assert a.state is fut.TaskState.DONE


def test_diamond_waits_for_its_gated_source(graph):
    gate = threading.Event()
    src = graph.defer(lambda: (gate.wait(10), 1)[1], name="src")
    left = graph.defer(lambda x: x + 10, src, name="left")
    right = graph.defer(lambda x: x + 100, src, name="right")
    join = graph.defer(lambda l, r: l + r, left, right, name="join")
    assert not join.done()
    gate.set()
    assert join.result(timeout=10) == 112


def test_kwarg_and_nested_container_futures_become_edges(graph):
    a = graph.defer(lambda: 5, name="a")
    b = graph.defer(lambda xs, y=None: xs["k"][0] + y, {"k": [a]}, y=a,
                    name="b")
    assert b.result(timeout=10) == 10


def test_cross_graph_dep_rejected(fut, graph):
    other = fut.FuturizedGraph(max_workers=1, name="other")
    try:
        foreign = other.defer(lambda: 2, name="foreign")
        with pytest.raises(ValueError, match="different graph"):
            graph.defer(lambda b: b, foreign, name="bad")
        graph.barrier(timeout=10)
    finally:
        other.shutdown(wait=True)


# -- combinators ------------------------------------------------------------

def test_when_all_when_any_tree_join(graph, impl):
    futs = [graph.defer(lambda i=i: i * i, name=f"s{i}") for i in range(5)]
    assert graph.when_all(futs).result(timeout=10) == [0, 1, 4, 9, 16]
    held = threading.Event()
    slow = graph.defer(held.wait, 10, name="slow")
    fast = graph.defer(lambda: "fast", name="fast")
    assert graph.when_any([slow, fast]).result(timeout=10) == (1, "fast")
    held.set()
    a = graph.defer(lambda: impl[2](3), name="a")
    out = graph.tree_join({"x": a, "y": [futs[2], "static"], "z": 1.5}
                          ).result(timeout=10)
    np.testing.assert_array_equal(np.asarray(out["x"]), np.ones(3))
    assert out["y"] == [4, "static"] and out["z"] == 1.5


def test_when_any_errors_only_if_all_fail(graph):
    f1 = graph.defer(lambda: 1 / 0, name="f1")
    f2 = graph.defer(lambda: None.x, name="f2")
    with pytest.raises((ZeroDivisionError, AttributeError)):
        graph.when_any([f1, f2]).result(timeout=10)


# -- lanes ------------------------------------------------------------------

def test_lanes_drain_compute_before_prefetch_before_checkpoint(fut):
    g = fut.FuturizedGraph(max_workers=1, name="lanes")
    try:
        hold, order = threading.Event(), []
        g.defer(hold.wait, 10, name="blocker")
        g.defer(lambda: order.append("ckpt"), lane=fut.Lane.CHECKPOINT,
                name="ckpt")
        g.defer(lambda: order.append("prefetch"), lane=fut.Lane.PREFETCH,
                name="pf")
        g.defer(lambda: order.append("compute"), lane=fut.Lane.COMPUTE,
                name="comp")
        hold.set()
        g.barrier(timeout=10)
        assert order == ["compute", "prefetch", "ckpt"]
        assert g.stats().per_lane == {"COMPUTE": 2, "PREFETCH": 1,
                                      "CHECKPOINT": 1}
    finally:
        g.shutdown(wait=True)


# -- error poisoning and cancellation ---------------------------------------

def test_error_poisons_transitive_dependents_only(graph, fut):
    def explode():
        raise ValueError("injected")

    a = graph.defer(explode, name="a")
    b = graph.defer(lambda x: x + 1, a, name="b")
    c = graph.defer(lambda x: x + 1, b, name="c")
    d = graph.defer(lambda x, y: x + y, a, c, name="d")
    good = graph.defer(lambda: 3, name="good")
    for f in (b, c, d):
        with pytest.raises(ValueError, match="injected"):
            f.result(timeout=10)
        assert f.state is fut.TaskState.ERROR
    assert good.result(timeout=10) == 3
    late = graph.defer(lambda x: x, a, name="late")   # already poisoned
    with pytest.raises(ValueError, match="injected"):
        late.result(timeout=10)
    assert graph.stats().failed == 5


def test_cancel_propagates_and_spares_upstream(graph, fut):
    gate = threading.Event()
    src = graph.defer(gate.wait, 10, name="src")
    pend = graph.defer(lambda x: x, src, name="pend")
    leaf = graph.defer(lambda x: x, pend, name="leaf")
    assert pend.cancel() is True
    assert leaf.state is fut.TaskState.CANCELLED
    with pytest.raises(fut.CancelledError):
        leaf.result(timeout=10)
    gate.set()
    assert src.result(timeout=10) is True
    assert src.cancel() is False                        # already terminal
    assert graph.stats().cancelled == 2


def test_promise_resolves_and_poisons_by_edge(graph):
    ok = graph.promise(name="remote", producer="L1")
    bad = graph.promise(name="remote-bad", producer="L1")
    use_ok = graph.defer(lambda x: x * 2, ok, name="use")
    use_bad = graph.defer(lambda x: x, bad, name="use-bad")
    assert ok.set_result(21) is True and ok.set_result(0) is False
    assert bad.set_exception(KeyError("lost")) is True
    assert use_ok.result(timeout=10) == 42
    with pytest.raises(KeyError):
        use_bad.result(timeout=10)
    plain = graph.defer(lambda: 1, name="plain")
    with pytest.raises(RuntimeError, match="not a promise"):
        plain.set_result(2)


def test_immediate_and_stats(graph):
    imm = graph.immediate({"v": 1})
    assert imm.done()
    assert graph.defer(lambda d: d["v"] + 1, imm, name="use"
                       ).result(timeout=10) == 2
    graph.record_serve(real_tokens=3, padded_slot_tokens=1)
    st = graph.stats()
    assert st.submitted >= 2 and st.completed >= 2
    assert 1 <= st.max_in_flight <= 2
    assert st.serve == {"real_tokens": 3, "padded_slot_tokens": 1}
    assert set(st.to_json()["lane_time_hist"]["counts"]) == {
        "COMPUTE", "PREFETCH", "CHECKPOINT"}


# -- barriers and shutdown --------------------------------------------------

def test_shutdown_waits_for_pending_checkpoint_nodes(fut):
    g = fut.FuturizedGraph(max_workers=2, name="shutdown")
    release, written = threading.Event(), []
    retired = g.defer(release.wait, 10, name="retire")
    g.defer(lambda _: written.append("saved"), retired,
            lane=fut.Lane.CHECKPOINT, name="save")
    assert written == []
    release.set()
    g.shutdown(wait=True)                   # the shutdown barrier drains it
    assert written == ["saved"]
    with pytest.raises(RuntimeError, match="shut down"):
        g.defer(lambda: 1)


def test_barrier_timeout_raises_while_work_is_held(graph):
    gate = threading.Event()
    graph.defer(gate.wait, 10, name="held")
    with pytest.raises(TimeoutError):
        graph.barrier(timeout=0.05)
    gate.set()
    graph.barrier(timeout=10)


def test_pipeline_keeps_depth_in_flight(fut, impl):
    p = fut.Pipeline(depth=2)
    retired = [r.step for i in range(5)
               if (r := p.push(i, impl[2](2) * i)) is not None]
    assert retired == [0, 1, 2] and len(p) == 2
    assert [r.step for r in p.drain()] == [3, 4] and len(p) == 0


# -- @futurize tracing --------------------------------------------------------

def _traced_program(fz):
    @fz.futurize
    def load(i):
        return i

    @fz.futurize(name="step")
    def step(a, b):
        return a + b

    with fz.tracing(max_workers=2) as tr:
        x = load(1)
        y = load(2)
        z = step(x, y)
        w = step(z, {"k": [x]}["k"][0])
        assert w.result(timeout=10) == 4
    assert load(5) == 5                     # untraced: runs inline
    return tr.signature()


def test_futurize_traces_the_same_tree_in_both():
    sig = _traced_program(torch_futurize)
    assert sig == _traced_program(jax_futurize)
    assert [s[0] for s in sig] == ["load:0", "load:1", "step:0", "step:1"]
    assert sig[3][2] == (0, 2)
