"""The port's paged inference cache (``repro_torch.core.paging``): the
JAX package's page-accounting properties (tests/test_property.py: the
event soup, no stale state, the router soup, named caches over one pool)
held against the port's ``PagePool``, ``InferenceCache`` and
``ReplicaRouter``, and the bit-identical round trip of a mixed bf16/f32
state tree through ``put``, ``get`` and ``transfer``."""
import random

import numpy as np
import pytest
import torch
import torch_threads

torch_threads.apply()

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # pragma: no cover - CI has it
    from _property_fallback import given, settings, strategies as st

from repro_torch.core.paging import InferenceCache, PageError, PagePool
from repro_torch.frontend.gateway import ReplicaRouter

PROFILE = dict(max_examples=25, deadline=None)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_bit_identical(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.device.type == "cpu"
    assert torch.equal(_bits(got), _bits(want))


@settings(**PROFILE)
@given(seed=st.integers(0, 10 ** 6), n_events=st.integers(1, 60),
       page_bytes=st.sampled_from([8, 64, 256]))
def test_page_pool_event_soup_invariants(seed, n_events, page_bytes):
    """Seeded alloc/free/retire soup: after every event no page is owned
    by two live owners, the pool's books agree with a shadow ledger, freed
    pages are reused before the pool grows and come back scrubbed, and a
    foreign or double free raises."""
    rng = random.Random(seed)
    pool = PagePool(page_bytes)
    held: dict = {}                          # owner -> [page ids]

    def do_alloc():
        owner = f"r{rng.randrange(8)}"
        got = pool.alloc(owner, rng.randint(0, 3))
        for pid in got:                      # mark them, so reuse must scrub
            pool.write(pid, owner, np.full(page_bytes, 0xAB, np.uint8))
        held.setdefault(owner, []).extend(got)

    def do_free():
        owners = [o for o, ps in held.items() if ps]
        if not owners:
            return
        owner = rng.choice(owners)
        k = rng.randint(1, len(held[owner]))
        pool.free([held[owner].pop() for _ in range(k)], owner)

    def do_retire():                         # retire = free everything held
        owners = [o for o, ps in held.items() if ps]
        if not owners:
            return
        owner = rng.choice(owners)
        pool.free(held.pop(owner), owner)

    for _ in range(n_events):
        rng.choice([do_alloc, do_alloc, do_free, do_retire])()
        mine = {p: o for o, ps in held.items() for p in ps}
        assert pool.owners() == mine         # single ownership, no leaks
        assert pool.live == len(mine)
        assert pool.size >= pool.live
        assert pool.allocs == pool.grown + pool.reused
        assert pool.allocs - pool.frees == pool.live

    for owner in list(held):
        pool.free(held.pop(owner), owner)
    size_before, grown_before = pool.size, pool.grown
    got = pool.alloc("reuser", min(3, size_before))
    assert pool.grown == grown_before and pool.size == size_before
    for pid in got:                          # reused pages are scrubbed
        assert not pool.read(pid, "reuser").any()
    if got:
        with pytest.raises(PageError):
            pool.free(got, "somebody-else")
        pool.free(got, "reuser")
        with pytest.raises(PageError):
            pool.free(got, "reuser")


@settings(**PROFILE)
@given(seed=st.integers(0, 10 ** 6), page_bytes=st.sampled_from([16, 128]),
       n_cycles=st.integers(1, 8))
def test_inference_cache_put_get_drop_no_stale_state(seed, page_bytes,
                                                     n_cycles):
    """put -> get -> drop cycles that recycle pages: every ``get`` gives
    back its own request's tree bit for bit (a fill pattern per request),
    and a dropped rid stays gone."""
    rng = np.random.default_rng(seed)
    icache = InferenceCache(page_bytes=page_bytes)
    for cycle in range(n_cycles):
        live = {}
        for r in range(rng.integers(1, 4)):
            rid = f"c{cycle}r{r}"
            state = {
                "conv": torch.from_numpy(rng.integers(
                    0, 255, (int(rng.integers(1, 5)), 3), dtype=np.uint8)),
                "ssm": [torch.full((int(rng.integers(1, 7)),),
                                   cycle * 16 + r, dtype=torch.float32),
                        torch.arange(int(rng.integers(1, 9)),
                                     dtype=torch.int32) + cycle]}
            icache.put(rid, state)
            live[rid] = state
        for rid, state in live.items():
            back = icache.get(rid)
            _assert_bit_identical(back["conv"], state["conv"])
            _assert_bit_identical(back["ssm"][0], state["ssm"][0])
            _assert_bit_identical(back["ssm"][1], state["ssm"][1])
        for rid in live:
            assert icache.drop(rid)
            assert icache.get(rid) is None   # gone means gone
    assert len(icache) == 0
    c = icache.counters()
    assert c["pages_live"] == 0
    assert c["cache_hits"] == c["cache_puts"]
    if n_cycles > 1 and c["page_allocs"]:
        assert c["pages_reused"] > 0


@settings(**PROFILE)
@given(seed=st.integers(0, 10 ** 6), replicas=st.integers(1, 4))
def test_replica_router_event_soup_never_double_assigns_or_strands(
        seed, replicas):
    """assign / re-assign / release / kill / revive soup: every routed
    request sits on one live replica, least loaded with ties to the lowest
    index, affinity holds while its replica lives, ``kill`` hands back
    exactly its rids, and nothing is stranded while a replica lives."""
    rng = np.random.default_rng(seed)
    router = ReplicaRouter(replicas)
    routed: dict[str, int] = {}
    next_rid = [0]

    def check():
        assert router.assignment == routed
        for rid, r in routed.items():
            assert r in router.live, f"{rid} routed to dead replica {r}"
        for r in range(replicas):
            assert router.load(r) == sum(1 for v in routed.values()
                                         if v == r)

    def assign_new():
        rid = f"r{next_rid[0]}"
        next_rid[0] += 1
        r = router.assign(rid)
        loads = {i: sum(1 for v in routed.values() if v == i)
                 for i in router.live}
        best = min(loads.values())
        assert r == min(i for i, n in loads.items() if n == best)
        routed[rid] = r

    def reassign_existing():
        if routed:
            rid = rng.choice(sorted(routed))
            assert router.assign(rid) == routed[rid]

    def release_one():
        if routed:
            rid = rng.choice(sorted(routed))
            router.release(rid)
            del routed[rid]

    def kill_one():
        victim = int(rng.integers(0, replicas))
        victims = router.kill(victim)
        assert sorted(victims) == sorted(
            rid for rid, r in routed.items() if r == victim)
        if not router.live:                  # the gateway's revive edge
            router.revive(victim)
            return
        for rid in victims:
            routed[rid] = router.assign(rid)
            assert routed[rid] in router.live and routed[rid] != victim

    def revive_one():
        router.revive(int(rng.integers(0, replicas)))

    ops = [assign_new, assign_new, reassign_existing, release_one,
           kill_one, revive_one]
    for _ in range(60):
        ops[int(rng.integers(0, len(ops)))]()
        check()
    assert router.live
    for rid in sorted(routed):
        assert router.assign(rid) in router.live
    with pytest.raises(ValueError):
        router.revive(replicas)


@settings(**PROFILE)
@given(seed=st.integers(0, 10 ** 6), page_bytes=st.sampled_from([32, 256]))
def test_named_caches_share_pool_but_never_cross_ownership(seed,
                                                           page_bytes):
    """Two named caches over one pool tag pages ``R{i}:req:{rid}``: the
    other replica can neither free nor read them; ``transfer`` moves the
    state bit for bit, flips ownership and leaks nothing."""
    rng = np.random.default_rng(seed)
    pool = PagePool(page_bytes)
    r0 = InferenceCache(pool, name="R0")
    r1 = InferenceCache(pool, name="R1")
    state = {"kv": torch.from_numpy(rng.standard_normal(
                (int(rng.integers(2, 6)), 4)).astype(np.float32)),
             "pos": torch.arange(int(rng.integers(1, 9)), dtype=torch.int32)}
    r0.put("rq", state)
    pages = [pid for pid, owner in pool.owners().items()
             if owner == "R0:req:rq"]
    assert pages and pool.live == len(pages)
    with pytest.raises(PageError):
        pool.free(pages, "R1:req:rq")
    with pytest.raises(PageError):
        pool.read(pages[0], "R1:req:rq")
    assert r1.get("rq") is None

    assert r0.transfer("rq", r1)
    assert "rq" not in r0 and "rq" in r1
    back = r1.get("rq")
    _assert_bit_identical(back["kv"], state["kv"])
    _assert_bit_identical(back["pos"], state["pos"])
    assert all(owner == "R1:req:rq" for owner in pool.owners().values())
    assert r0.counters()["cache_transfers_out"] == 1
    assert r1.counters()["cache_transfers_in"] == 1
    assert not r0.transfer("ghost", r1)      # a recorded miss, no error
    r1.drop("rq")
    assert pool.live == 0 and pool.allocs == pool.frees


def test_mixed_bf16_f32_state_round_trips_bit_identically():
    """A decode-state tree as the models make it (bf16 KV and conv, f32
    SSM state, a 0-dim leaf, odd sizes that straddle pages) parks and
    comes back bit for bit, also through ``transfer`` to a sibling cache;
    the page count is the bytes over the page size, rounded up."""
    g = torch.Generator().manual_seed(0)
    state = {
        "kv": [{"k": torch.randn(1, 7, 2, 16, generator=g).bfloat16(),
                "v": torch.randn(1, 7, 2, 16, generator=g).bfloat16()}
               for _ in range(3)],
        "mamba": [{"ssm": torch.randn(1, 5, 4, 3, generator=g),
                   "conv": torch.randn(1, 3, 11, generator=g).bfloat16()}],
        "scalar": torch.tensor(-0.0),
        "mask": torch.tensor([True, False, True]),
    }
    # bf16 values that numpy cannot hold, and an f32 NaN payload
    state["kv"][0]["k"].view(-1)[:3] = torch.tensor(
        [float("inf"), -1e-40, 3.0e38]).bfloat16()
    state["mamba"][0]["ssm"].view(-1)[0] = float("nan")
    pool = PagePool(100)
    a, b = InferenceCache(pool, name="R0"), InferenceCache(pool, name="R1")
    want = torch.utils._pytree.tree_leaves(state)
    nbytes = sum(t.numel() * t.element_size() for t in want)
    assert a.put("r0", state) == -(-nbytes // 100)
    for got, w in zip(torch.utils._pytree.tree_leaves(a.get("r0")), want):
        _assert_bit_identical(got, w)
    assert a.transfer("r0", b)
    back = b.get("r0")
    assert torch.utils._pytree.tree_structure(back) == \
        torch.utils._pytree.tree_structure(state)
    for got, w in zip(torch.utils._pytree.tree_leaves(back), want):
        _assert_bit_identical(got, w)
    with pytest.raises(PageError, match="already cached"):
        b.put("r0", state)
    assert b.drop("r0") and not b.drop("r0")
    assert pool.live == 0 and pool.allocs == pool.frees
