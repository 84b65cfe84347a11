"""The port's serving gateway (``repro_torch.frontend.gateway``,
``Session.serve_stream``) on the CPU at tiny sizes.

Within the port, the JAX package's gateway battery
(tests/test_serve_gateway.py) as invariants: streamed arrivals with zero
prefill recompute, cancel, expiry, poison, the fault battery, the live
queue, admission and close rejection, replicas and the replica-death
drills; a request's stream depends only on its prompt, so every
survivor's stream is bit-identical to an unperturbed run.  Against the
JAX package: the same arrival scripts build the same tree with the same
counters, and the two gateways stream the same tokens on the same bridged
parameters."""
import threading
import time
import types
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.frontend import Plan as JaxPlan
from repro.frontend.gateway import Gateway as JaxGateway
from repro.frontend.gateway import RequestQueue as JaxRequestQueue
from repro_torch.bridge import params_from_numpy
from repro_torch.core import steps
from repro_torch.core.sharding import init_params
from repro_torch.frontend import Plan
from repro_torch.frontend import gateway as gateway_mod
from repro_torch.frontend.gateway import (DeadlineExpired, Gateway,
                                          RequestQueue, RequestRejected)
from test_torch_serve import _jax_serve_params

ARCH = "qwen2.5-3b"
ARRIVALS = (0, 0, 1, 3, 3)           # staggered, requests > slots
KW = dict(prompt_len=16, gen_len=4, slots=2, verbose=False)


def _trace(arrivals=ARRIVALS, faults=None):
    """An arrival script; ``faults`` maps a request index to extra keys
    for it."""
    faults = faults or {}
    return [dict({"at_round": r}, **faults.get(i, {}))
            for i, r in enumerate(arrivals)]


def _stream(trace, arch=ARCH, **over):
    """One fresh-session gateway run over a deterministic script."""
    with Plan(arch=arch, device="cpu").compile() as session:
        return session.serve_stream(trace=trace, **dict(KW, **over))


_RUNS: dict = {}


def _baseline(arrivals=ARRIVALS, **over):
    """The unperturbed run of an arrival script, cached per config: rid
    numbering and prompts depend only on entry order and the plan's seed,
    so a fault run over the same script compares with it directly."""
    key = (tuple(arrivals), tuple(sorted(over.items())))
    if key not in _RUNS:
        out = _stream(_trace(arrivals), **over)
        assert out["completed"] == len(arrivals)
        _RUNS[key] = out
    return _RUNS[key]


def _assert_reclaimed(out):
    cache = out["cache"]
    assert cache["pages_live"] == 0 and cache["cache_entries"] == 0
    assert cache["page_allocs"] == cache["page_frees"]
    assert out["runtime_stats"]["serve"].get("prefill_recompute", 0) == 0


# -- streamed arrivals, zero prefill recompute -------------------------------

def test_streamed_arrivals_complete_with_zero_prefill_recompute():
    out = _baseline()
    n, gen = len(ARRIVALS), KW["gen_len"]
    assert out["completed"] == n
    assert out["cancelled"] == out["expired"] == out["failed"] == 0
    assert sorted(out["streams"]) == [f"r{i}" for i in range(n)]
    assert all(len(s) == gen + 1 for s in out["streams"].values())
    assert out["tokens"] == n * gen

    # every slot join loaded pages; prefill never reran; all reclaimed
    serve = out["runtime_stats"]["serve"]
    assert serve["refills"] == serve["page_hits"] == n
    cache = out["cache"]
    assert cache["cache_puts"] == cache["cache_hits"] == n
    _assert_reclaimed(out)
    assert out["epochs"] >= 2
    names = set(out["nodes"])
    for i in range(n):
        assert {f"stack:r{i}", f"prefill:r{i}", f"finish:r{i}",
                f"request:r{i}"} <= names
    assert "refill:e0" in names and "decode:e0:t0" in names

    hist = out["runtime_stats"]["request_latency_hist"]
    assert hist["edges_s"] and len(hist["labels"]) == len(hist["edges_s"]) + 1
    counts = hist["counts"]
    for phase in ("queue_wait", "prefill", "total"):
        assert sum(counts[phase]) == n
    assert sum(counts["decode_token"]) == n * gen

    # padded-slot accounting: real + padded covers every (round, slot)
    assert serve["real_tokens"] == n * gen
    assert serve["real_tokens"] + serve["padded_slot_tokens"] \
        == out["rounds"] * KW["slots"]
    assert out["padded_tokens"] == serve["padded_slot_tokens"]


def test_parked_state_is_the_batch_1_cache_in_whole_pages():
    """A request parks exactly its batch-1 decode state: the cache specs'
    bytes at the serve cache length, in whole pages."""
    out = _baseline()
    cfg = Plan(arch=ARCH, device="cpu").config()
    cache_len = KW["prompt_len"] + KW["gen_len"]
    specs = steps.make_decode_step(
        cfg, {"seq_len": cache_len, "global_batch": 1}).cache_specs
    nbytes = sum(s.size * s.dtype.itemsize for s in
                 torch.utils._pytree.tree_leaves(
                     specs, is_leaf=lambda x: hasattr(x, "dims")))
    pages = -(-nbytes // (1 << 16))
    assert out["cache"]["page_allocs"] == len(ARRIVALS) * pages


# -- fault injection ---------------------------------------------------------

def test_cancel_mid_decode_reclaims_slot_and_preserves_survivors():
    base = _baseline()["streams"]
    out = _stream(_trace(faults={1: {"cancel_after": 2}}))
    assert out["cancelled"] == 1 and out["completed"] == len(ARRIVALS) - 1
    h = next(h for h in out["handles"] if h.rid == "r1")
    assert h.status == "cancelled"
    with pytest.raises(CancelledError):
        h.result(timeout=5)
    assert h.tokens == base["r1"][:3]        # prefill + 2 decoded: a prefix
    for rid, stream in base.items():
        if rid != "r1":
            assert out["streams"][rid] == stream
    _assert_reclaimed(out)


def test_deadline_expiry_while_waiting_for_a_slot(monkeypatch):
    """slots=1: r0 holds the slot for 8 rounds; r1 is admitted (its
    prefill runs) but its deadline lapses before the slot frees.  The
    gateway's clock is a fake that jumps an hour when the third decode
    round is built, so no wall-clock threshold decides the outcome."""
    clock = {"t": 0.0}
    monkeypatch.setattr(gateway_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["t"]))
    kw = dict(gen_len=8, slots=1)
    base = _baseline((0,), **kw)["streams"]

    def jump(node, deps):
        if node.name == "decode:e0:t2":
            clock["t"] += 3600.0

    with Plan(arch=ARCH, device="cpu").compile() as session:
        session.runtime.add_trace_hook(jump)
        out = session.serve_stream(
            trace=[{"at_round": 0}, {"at_round": 0, "deadline_ms": 1000}],
            **dict(KW, **kw))
    assert out["completed"] == 1 and out["expired"] == 1
    assert out["runtime_stats"]["serve"]["admitted"] == 2
    h = next(h for h in out["handles"] if h.rid == "r1")
    assert h.status == "expired" and h.tokens == []
    with pytest.raises(DeadlineExpired):
        h.result(timeout=5)
    assert out["streams"]["r0"] == base["r0"]
    _assert_reclaimed(out)


def test_poisoned_prefill_is_contained_to_its_chain():
    base = _baseline()["streams"]
    out = _stream(_trace(faults={2: {"inject": "poison-prefill"}}))
    assert out["failed"] == 1 and out["completed"] == len(ARRIVALS) - 1
    h = next(h for h in out["handles"] if h.rid == "r2")
    assert h.status == "failed" and h.tokens == []
    with pytest.raises(RuntimeError, match="injected prefill poison"):
        h.result(timeout=5)
    for rid, stream in base.items():
        if rid != "r2":
            assert out["streams"][rid] == stream
    _assert_reclaimed(out)


FAULTS = {1: {"cancel_after": 1}, 2: {"inject": "poison-prefill"},
          4: {"deadline_ms": 0.0}}           # r4 expires before admission


def test_fault_battery_drains_cleanly():
    """All three faults in one run: every promise resolves, every page is
    reclaimed, the untouched requests stream as in the unperturbed run."""
    base = _baseline()["streams"]
    out = _stream(_trace(faults=FAULTS))
    assert out["completed"] == 2
    assert out["cancelled"] == out["expired"] == out["failed"] == 1
    assert {h.rid: h.status for h in out["handles"]} == {
        "r0": "done", "r1": "cancelled", "r2": "failed", "r3": "done",
        "r4": "expired"}
    assert all(h._promise.done() for h in out["handles"])
    for rid in ("r0", "r3"):
        assert out["streams"][rid] == base[rid]
    assert out["streams"]["r1"] == base["r1"][:2]
    _assert_reclaimed(out)


# -- the live side: threads, admission, rejection ----------------------------

def test_live_queue_submissions_from_another_thread():
    """A feeder thread submits three prompts while the gateway runs; each
    stream equals the same prompt's stream in a trace-driven run."""
    with Plan(arch=ARCH, device="cpu").compile() as session:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, session.cfg.vocab, 16).astype(np.int32)
                   for _ in range(3)]
        q = RequestQueue()

        def feeder():
            for p in prompts:
                q.submit(p)
                time.sleep(0.02)
            q.close()

        t = threading.Thread(target=feeder)
        t.start()
        out = session.serve_stream(queue=q, **KW)
        t.join(timeout=60)
        assert not t.is_alive()
        traced = session.serve_stream(trace=[{"prompt": p} for p in prompts],
                                      **KW)
    assert out["completed"] == 3
    assert all(h.result(timeout=5) == out["streams"][h.rid]
               for h in out["handles"])
    assert out["streams"] == traced["streams"]


def test_request_queue_backlog_and_close_reject():
    q = RequestQueue(max_queue=1)
    ok = q.submit([1, 2])
    full = q.submit([3, 4])
    assert ok.status == "queued" and full.status == "rejected"
    with pytest.raises(RequestRejected, match="capacity"):
        full.result(timeout=1)
    q.close()
    late = q.submit([5, 6])
    assert late.status == "rejected"
    with pytest.raises(RequestRejected, match="closed"):
        late.result(timeout=1)
    assert q.submitted == 1 and q.rejected == 2


def _race_submit_against_close():
    """submit() from four threads while close() lands: every handle is
    queued-before-close (drainable) or rejected, never stranded."""
    q = RequestQueue()
    handles: list = []
    lock = threading.Lock()
    start = threading.Barrier(5)

    def submitter():
        start.wait()
        for _ in range(20):
            h = q.submit([1, 2, 3])
            with lock:
                handles.append(h)

    threads = [threading.Thread(target=submitter) for _ in range(4)]
    for t in threads:
        t.start()
    start.wait()
    q.close()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    taken = q.take_ready(10 ** 9)
    assert q.drained()
    rejected = [h for h in handles if h.status == "rejected"]
    queued = [h for h in handles if h.status == "queued"]
    assert len(rejected) + len(queued) == len(handles)
    assert sorted(h.rid for h in queued) == sorted(h.rid for h in taken)
    assert q.submitted == len(queued) and q.rejected == len(rejected)
    for h in rejected:
        assert h.done()
        with pytest.raises(RequestRejected, match="closed|capacity"):
            h.result(timeout=1)


def test_submit_racing_close_is_atomic_at_the_queue():
    for _ in range(25):
        _race_submit_against_close()


def test_admission_cap_of_one_serves_every_request():
    """max_inflight=1: one request at a time holds resources, so each gets
    an epoch of its own; those the cap held back are admitted once the
    slots drain (the JAX package's loop fails them out at that point, with
    nothing resident and the queue drained), and every stream is
    unchanged."""
    base = _baseline()["streams"]
    out = _stream(_trace(), max_inflight=1)
    assert out["completed"] == len(ARRIVALS)
    assert out["streams"] == base
    assert out["epochs"] == len(ARRIVALS)
    _assert_reclaimed(out)


# -- replicas ------------------------------------------------------------------

def test_two_replica_streams_bit_identical_to_single_replica():
    base = _baseline()["streams"]
    out = _stream(_trace(), replicas=2)
    assert out["completed"] == len(ARRIVALS) and out["replicas"] == 2
    assert out["streams"] == base
    serve = out["runtime_stats"]["serve"]
    assert serve.get("cross_replica_page_fetches", 0) == 0
    assert serve["refills"] == serve["page_hits"] == len(ARRIVALS)
    per = out["runtime_stats"]["serve_replicas"]
    assert sorted(per) == ["0", "1"]
    assert all(per[k]["refills"] > 0 for k in per)
    assert sum(per[k]["refills"] for k in per) == serve["refills"]
    assigned = out["replica_assignments"]
    assert sorted(assigned) == [f"r{i}" for i in range(len(ARRIVALS))]
    assert set(assigned.values()) == {0, 1}
    cache = out["cache"]
    assert cache["cache_transfers_in"] == cache["cache_transfers_out"] == 0
    _assert_reclaimed(out)
    names = set(out["nodes"])
    assert "refill:R0:e0" in names and "refill:R1:e0" in names
    assert not any(n.startswith(("refill:e", "decode:e")) for n in names)


def test_kill_replica_drill_completes_on_survivor():
    """Replica 0 dies at round 2: the survivor adopts its pages (counted
    cross-replica fetches, never a recompute) and every stream is
    bit-identical to the single-replica run."""
    base = _baseline()["streams"]
    out = _stream(_trace(), replicas=2, kill_replica_at_round=(0, 2))
    assert out["completed"] == len(ARRIVALS)
    assert out["cancelled"] == out["expired"] == out["failed"] == 0
    assert out["streams"] == base
    serve = out["runtime_stats"]["serve"]
    assert serve["replica_deaths"] == 1
    assert serve["replica_migrations"] >= 1
    assert serve["cross_replica_page_fetches"] >= 1
    assert set(out["replica_assignments"].values()) == {1}
    cache = out["cache"]
    assert cache["cache_transfers_in"] == cache["cache_transfers_out"] \
        == serve["cross_replica_page_fetches"]
    _assert_reclaimed(out)


def test_kill_last_replica_revives_it():
    base = _baseline()["streams"]
    out = _stream(_trace(), replicas=1, kill_replica_at_round=(0, 2))
    assert out["completed"] == len(ARRIVALS)
    assert out["streams"] == base
    serve = out["runtime_stats"]["serve"]
    assert serve["replica_deaths"] == 1 and serve["replica_revivals"] == 1
    _assert_reclaimed(out)


def test_live_kill_replica_seam_and_its_bounds():
    """``kill_replica()`` before the run retires replica 0 at the first
    round's sweep; an unknown index raises."""
    base = _baseline()["streams"]
    with Plan(arch=ARCH, device="cpu").compile() as session:
        pre1 = session._serve_steps_for(16, 4, 1)[0]
        dec = session._serve_steps_for(16, 4, 2)[1]
        params = init_params(
            pre1.specs, torch.Generator().manual_seed(0), "cpu")
        gw = Gateway(session.runtime, prefill_step=pre1, decode_step=dec,
                     params=params, prompt_len=16, gen_len=4, slots=2,
                     device="cpu", replicas=2)
        with pytest.raises(ValueError, match="unknown replica"):
            gw.kill_replica(2)
        gw.kill_replica(0)
        q = RequestQueue()
        rng = np.random.default_rng(0)
        for r in ARRIVALS:
            q.submit(rng.integers(0, session.cfg.vocab, 16).astype(np.int32),
                     at_round=r)
        q.close()
        out = gw.run(q)
    assert out["streams"] == base
    assert set(out["replica_assignments"].values()) == {1}
    assert session.stats().serve["replica_deaths"] == 1


# -- against the JAX package ----------------------------------------------------

# the pool's high-water marks depend on when a prefill node's put lands
# against a finish node's drop on the runtime's worker threads, in either
# package; every other counter is fixed by the arrival script
_TIMED_KEYS = ("pages_grown", "pages_reused", "pages_peak")
SCRIPTS = {"plain": ({}, {}),
           "faults": (FAULTS, {}),
           "kill_drill": ({}, dict(replicas=2, kill_replica_at_round=(0, 2)))}
_PARITY: dict = {}


def _parity_runs(arch):
    """Each script of ``SCRIPTS`` through the port's and the JAX
    package's ``serve_stream``, in one session each (cached per arch)."""
    if arch not in _PARITY:
        runs = {}
        with Plan(arch=arch, device="cpu").compile() as mine, \
                JaxPlan(arch=arch).compile() as ref:
            for name, (faults, over) in SCRIPTS.items():
                kw = dict(KW, trace=_trace(faults=faults), **over)
                runs[name] = (mine.serve_stream(**kw), ref.serve_stream(**kw))
        _PARITY[arch] = runs
    return _PARITY[arch]


def _untimed(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if k not in _TIMED_KEYS}


@pytest.mark.parametrize("script", list(SCRIPTS))
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_serve_stream_matches_jax_tree_and_counters(arch, script):
    got, want = _parity_runs(arch)[script]
    assert got["trace"] == want["trace"]
    assert got["nodes"] == want["nodes"]
    # the sessions' serve counters accumulate over the scripts, in the
    # same order on both sides
    assert _untimed(got["runtime_stats"]["serve"]) \
        == _untimed(want["runtime_stats"]["serve"])
    assert _untimed(got["cache"]) == _untimed(want["cache"])
    assert set(got["cache"]) == set(want["cache"])
    for key in ("completed", "cancelled", "expired", "failed", "rejected",
                "rounds", "epochs", "replicas", "replica_assignments",
                "tokens", "padded_tokens", "requests"):
        assert got[key] == want[key], key
    assert got["cache"]["pages_live"] == 0


def _margin(session, params, prompt, slot_stream, step):
    """The port's top-1 minus top-2 logit of a request at ``step`` (0 is
    the prefill's token), replayed alone in slot 0."""
    pre1 = session._serve_steps_for(16, 4, 1)[0]
    dec = session._serve_steps_for(16, 4, 2)[1]
    lg, cache1 = pre1.fn(params, {"tokens": torch.tensor(prompt)[None]})
    carry = init_params(dec.cache_specs, None, "cpu")
    gateway_mod._write_rows(carry, cache1, dec.cache_specs, 0)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    for t in range(step):
        tok[0, 0] = slot_stream[t]
        pos = torch.tensor([16 + t, 16])
        lg, carry = dec.fn(params, carry, {"tokens": tok}, pos)
        lg = lg[:1]
    top = lg[0].float().topk(2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b",
                                  "granite-moe-1b-a400m"])
def test_gateway_streams_equal_jax_gateway_on_bridged_params(arch):
    """A JAX ``Gateway`` and the port's, built on the same bridged bf16
    serve parameters, stream the same tokens for the same script."""
    jcfg = jax_get_config(arch, tiny=True)
    _, jparams, tree = _jax_serve_params(jcfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, 16).astype(np.int32)
               for _ in ARRIVALS]

    def run(gw, queue):
        for p, r in zip(prompts, ARRIVALS):
            queue.submit(p, at_round=r)
        queue.close()
        return gw.run(queue)

    with JaxPlan(arch=arch).compile() as ref:
        pre1 = ref._serve_steps_for(16, 4, 1)[0]
        dec = ref._serve_steps_for(16, 4, 2)[1]
        want = run(JaxGateway(ref.runtime, prefill_step=pre1, decode_step=dec,
                              params=jparams, prompt_len=16, gen_len=4,
                              slots=2), JaxRequestQueue())
    with Plan(arch=arch, device="cpu").compile() as mine:
        params = params_from_numpy(tree, steps._serve_cfg(mine.cfg), "cpu")
        pre1 = mine._serve_steps_for(16, 4, 1)[0]
        dec = mine._serve_steps_for(16, 4, 2)[1]
        got = run(Gateway(mine.runtime, prefill_step=pre1, decode_step=dec,
                          params=params, prompt_len=16, gen_len=4, slots=2,
                          device="cpu"), RequestQueue())
        assert got["completed"] == want["completed"] == len(ARRIVALS)
        for i, rid in enumerate(sorted(want["streams"])):
            a, b = got["streams"][rid], want["streams"][rid]
            if a != b:
                t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
                pytest.fail(f"{arch} {rid}: token {t} is {a[t]} in the port, "
                            f"{b[t]} in the JAX package; the port's logit "
                            f"margin there is "
                            f"{_margin(mine, params, prompts[i], a, t):.3g}")
    assert got["cache"]["pages_live"] == 0
