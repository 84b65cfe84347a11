"""The port's active messages, AGAS directory, promises and
``tree_checksum`` (``repro_torch/distrib/messaging.py``, ``agas.py``,
``core/resilience.py``) against the JAX package's, in one process.

Counterparts of ``tests/test_distrib.py``'s messaging, AGAS and promise
tests; the wire itself is checked across the two packages: a port
endpoint and a reference endpoint exchange requests and posts, since
both speak the same frames.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.resilience import tree_checksum as jax_tree_checksum
from repro.distrib.messaging import Endpoint as JaxEndpoint
from repro_torch.core.futures import FuturizedGraph
from repro_torch.core.resilience import tree_checksum
from repro_torch.distrib import (DistributedGraph, ObjectDirectory,
                                 PeerLostError, RemoteRef, join_locality,
                                 raw_request)
from repro_torch.distrib import messaging
from repro_torch.distrib.agas import tree_leaves, tree_map
from repro_torch.distrib.messaging import Endpoint
import torch_threads

torch_threads.apply()

WAIT = 10.0      # seconds any wait in this file may take


def _until(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.fixture
def pair():
    a, b = Endpoint(0), Endpoint(1)
    yield a, b
    a.close()
    b.close()


# -- messaging ----------------------------------------------------------------

def test_request_ack_post_and_handler_errors(pair):
    a, b = pair
    seen = []
    b.register("echo", lambda src, p: {"from": src, "got": p})
    b.register("note", lambda src, p: seen.append(p))
    b.register("fail", lambda src, p: 1 / 0)
    a.connect(1, b.address)
    out = a.request(1, "echo", {"arr": np.arange(5)}, timeout=WAIT)
    assert out["from"] == 0 and (out["got"]["arr"] == np.arange(5)).all()
    a.post(1, "note", "fire-and-forget")
    assert _until(lambda: seen == ["fire-and-forget"])
    with pytest.raises(ZeroDivisionError):   # remote exc re-raises here
        a.request(1, "fail", timeout=WAIT)
    assert a.bytes_sent > 0 and b.bytes_recv > 0


def test_unregistered_actions_error_a_request_and_count_a_post(pair):
    a, b = pair
    a.connect(1, b.address)
    with pytest.raises(RuntimeError, match="no handler for 'nope'"):
        a.request(1, "nope", timeout=WAIT)
    a.post(1, "dropped")
    assert _until(lambda: b.unhandled_posts["dropped"] == 1)


def test_dial_on_demand_from_the_address_book_and_peer_loss(pair):
    """A request pending on a peer that dies fails with PeerLostError at
    once, and ``on_peer_lost`` fires exactly once."""
    a, b = pair
    lost = []
    a.on_peer_lost = lost.append
    b.register("ping", lambda src, p: p)
    b.register("stall", lambda src, p: time.sleep(5.0))
    a.address_book[1] = b.address            # no connect(): _send dials
    assert a.request(1, "ping", 7, timeout=WAIT) == 7
    assert a.peers() == [1] and _until(lambda: b.peers() == [0])
    threading.Timer(0.2, b.close).start()
    t0 = time.monotonic()
    with pytest.raises(PeerLostError, match="locality 1 disconnected"):
        a.request(1, "stall", timeout=WAIT)
    assert time.monotonic() - t0 < 4.0
    assert _until(lambda: lost == [1]) and a.peers() == []


def test_request_times_out_on_a_silent_handler(pair):
    a, b = pair
    b.register("stall", lambda src, p: time.sleep(1.0))
    a.connect(1, b.address)
    with pytest.raises(TimeoutError, match="no ack"):
        a.request(1, "stall", timeout=0.2)


def test_a_dialed_connection_outlives_the_dial_timeout(pair, monkeypatch):
    """The dial's timeout bounds the connect alone: a dialed connection
    that stays quiet for longer (a worker waiting out the driver's long
    step between two ring frames) is not taken for a lost peer.  Before
    the fix the dialer's reader timed out, dropped the connection and
    fired peer-lost: the 2-locality fp32 DDP worker died in step 2 of a
    run on the card with a broken pipe and no traceback."""
    monkeypatch.setattr(messaging, "DIAL_TIMEOUT_S", 0.2)
    a, b = pair
    lost = []
    a.on_peer_lost = lost.append
    b.register("echo", lambda src, p: p)
    a.register("echo", lambda src, p: p)
    a.connect(1, b.address)                   # a dials: its socket
    assert _until(lambda: b.peers() == [0])
    time.sleep(1.0)                           # quiet for 5 dial timeouts
    assert lost == [] and a.peers() == [1]
    assert a.request(1, "echo", 3, timeout=WAIT) == 3
    assert b.request(0, "echo", 4, timeout=WAIT) == 4


def test_raw_request_one_shot_socket(pair):
    _, b = pair
    b.register("join", lambda src, p: {"src": src, "p": p})
    assert raw_request(b.address, "join", {"x": 1}, timeout=WAIT) == {
        "src": -1, "p": {"x": 1}}


def test_the_wire_speaks_to_the_reference_endpoint():
    """Frames, envelopes and payload pickles are the reference's: a port
    endpoint and a JAX-package endpoint request from and post to each
    other."""
    port, ref = Endpoint(0), JaxEndpoint(1)
    seen = []
    try:
        ref.register("echo", lambda src, p: ("ref", src, p))
        port.register("note", lambda src, p: seen.append((src, p)))
        port.connect(1, ref.address)
        assert port.request(1, "echo", [1, 2], timeout=WAIT) == (
            "ref", 0, [1, 2])
        assert _until(lambda: ref.peers() == [0])
        ref.post(0, "note", {"a": np.float32(2.5)})
        assert _until(lambda: seen == [(1, {"a": np.float32(2.5)})])
    finally:
        port.close()
        ref.close()


# -- AGAS -------------------------------------------------------------------

def test_agas_directory_local_put_fetch_free():
    d = ObjectDirectory(rank=0)
    ref = d.put({"w": np.ones((3,))}, summary="weights")
    assert isinstance(ref, RemoteRef) and ref.owner == 0 and ref.nbytes == 24
    assert (d.fetch(ref)["w"] == 1).all()
    d.free(ref)
    d.free(ref)                               # idempotent
    with pytest.raises(KeyError):
        d.fetch(ref)
    assert d.audit() == {"live": 0, "puts": 1, "local_fetches": 1,
                         "frees": 1, "migrated": 0, "forwarded_fetches": 0}


def test_agas_remote_fetch_and_free_over_the_wire(pair):
    a, b = pair
    da, db = ObjectDirectory(0, a), ObjectDirectory(1, b)
    a.connect(1, b.address)
    ref = db.put([np.arange(4, dtype=np.int32), {"t": np.zeros(2)}])
    assert ref.nbytes == 16 + 16
    got = da.fetch(ref, timeout=WAIT)
    assert (got[0] == np.arange(4)).all() and (got[1]["t"] == 0).all()
    da.free(ref)                              # a post to the owner
    assert _until(lambda: len(db) == 0)
    with pytest.raises(KeyError, match="not in directory of locality 1"):
        da.fetch(ref, timeout=WAIT)


def test_join_refused_by_a_static_driver_and_rebalance_without_a_wire():
    """A driver not started elastic refuses a dial-in join with the
    reference's error; a directory with no endpoint migrates nothing."""
    assert ObjectDirectory(0).rebalance([1]) == 0
    dg = DistributedGraph(localities=1, name="static")
    try:
        with pytest.raises(RuntimeError, match="does not accept elastic"):
            join_locality(tuple(dg.endpoint.address))
        assert dg.stats()["joined_localities"] == 0
    finally:
        dg.shutdown()


# -- promise nodes (the cross-wire resolution primitive) ---------------------

def test_promise_resolves_dependents_and_rejects_double_set():
    g = FuturizedGraph(max_workers=2, name="promise")
    try:
        p = g.promise(name="remote-result")
        dep = g.defer(lambda x: x + 1, p)
        assert not p.done()
        assert p.set_result(41) is True
        assert dep.result(timeout=WAIT) == 42
        assert p.set_result(0) is False         # late result: discarded
        q = g.promise(name="remote-error")
        dq = g.defer(lambda x: x, q)
        assert q.set_exception(ValueError("wire")) is True
        with pytest.raises(ValueError, match="wire"):
            dq.result(timeout=WAIT)
        with pytest.raises(RuntimeError, match="not a promise"):
            dep.set_result(1)                   # scheduler-owned node
    finally:
        g.shutdown(wait=True)


def test_a_driver_only_graph_runs_tasks_locally_and_pins():
    dg = DistributedGraph(localities=1, name="solo")
    try:
        fut = dg.defer(np.arange, 3, name="here")
        assert (fut.result(timeout=WAIT) == np.arange(3)).all()
        assert fut.home == 0
        ref = dg.defer(np.ones, 2, pin=True).result(timeout=WAIT)
        assert isinstance(ref, RemoteRef) and ref.owner == 0
        assert (dg.fetch(ref) == 1).all()
        assert dg.stats()["alive_workers"] == []
    finally:
        dg.shutdown()


# -- tree walks and checksums ------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "b": np.arange(5, dtype=np.int32),
            "nested": {"s": np.float32(1.5), "none": None,
                       "t": [np.arange(3.0), (np.float32(-2.0),)]}}


def test_tree_leaves_in_jax_order_and_tree_map_keeps_structure():
    t = _tree()
    mine = tree_leaves(t)
    ref = jax.tree.leaves(t)
    assert len(mine) == len(ref)
    for x, y in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    doubled = tree_map(lambda x: x * 2, t)
    assert doubled["nested"]["none"] is None
    assert isinstance(doubled["nested"]["t"][1], tuple)
    np.testing.assert_array_equal(doubled["w"], t["w"] * 2)


def test_tree_checksum_equals_the_reference_on_float32_trees():
    t = _tree(1)
    assert tree_checksum(t) == jax_tree_checksum(t)
    # tensors hash as their host numpy view: the same digest
    as_tensors = tree_map(lambda x: torch.from_numpy(np.asarray(x)), t)
    assert tree_checksum(as_tensors) == jax_tree_checksum(t)
    # and a bfloat16 leaf as JAX's numpy view of one
    x = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)
    assert tree_checksum({"h": torch.from_numpy(x).bfloat16()}) == \
        jax_tree_checksum({"h": jnp.asarray(x, jnp.bfloat16)})
    # one flipped bit changes it
    t2 = _tree(1)
    t2["w"].view(np.uint32)[0, 0] ^= 1
    assert tree_checksum(t2) != tree_checksum(t)
