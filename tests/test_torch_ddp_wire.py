"""Fabric DDP over the port's active-message ring
(``repro_torch/distrib/collectives.py`` ``RingAllReduce`` at world > 1,
``frontend/ddp.py``) against the JAX package's.

In one process, over in-process endpoints: the ring sums bitwise alike on
both ranks with exact wire accounting; the onebit ring's wire payloads
are the reference ring's, byte for byte, step after step (the residual
carried); abort, peer loss and a silent peer end the exchange.  Marked
``multiproc``, with spawned worker localities: a 2-locality fp32 DDP run
is bit-identical in loss to the port's 1-locality run, a 2-locality run
resumed from the reference's checkpoint continues the reference's losses,
and a 3-locality run killed mid-all-reduce aborts without hanging.
"""
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distrib.collectives import RingAllReduce as JaxRing
from repro.distrib.messaging import Endpoint as JaxEndpoint
from repro.frontend import Plan as JaxPlan
from repro.optim import compression as jax_compression
from repro_torch.distrib import (Endpoint, Fp32Codec, LocalityLostError,
                                 OneBitCodec, RingAllReduce)
from repro_torch.frontend import Plan
from repro_torch.optim import compression
import torch_threads

torch_threads.apply()

ARCH = "qwen3-4b"
WAIT = 30.0      # seconds any exchange in this file may take
N = 4096 * 9     # with the (3, 1000) leaf: one bucket of two ROW * 32 blocks


def _plans():
    """The same two-leaf fusion plan in both packages."""
    ref = jax_compression.make_plan(
        {"a": jax.ShapeDtypeStruct((N,), jnp.float32),
         "b": jax.ShapeDtypeStruct((3, 1000), jnp.float32)}, 1)
    mine = compression.make_plan({"a": torch.zeros(N),
                                  "b": torch.zeros(3, 1000)}, 1)
    assert [b.size for b in mine.buckets] == [b.size for b in ref.buckets]
    return ref, mine


def _bufs(plan, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(b.size).astype(np.float32)
            for b in plan.buckets]


def _two_rings(make_ep, make_ring, account=None):
    a, b = make_ep(0), make_ep(1)
    a.address_book[1] = b.address
    b.address_book[0] = a.address
    return a, b, make_ring(a, 2, account=account), make_ring(b, 2)


def _exchange(ra, rb, step, bufs, metas=(None, None)):
    """Both ranks' ``allreduce`` at once; returns ``{rank: (sums,
    metas)}``."""
    out = {}

    def run(ring):
        out[ring.rank] = ring.allreduce(step, bufs[ring.rank],
                                        meta=metas[ring.rank], timeout=WAIT)
    t = threading.Thread(target=run, args=(rb,))
    t.start()
    run(ra)
    t.join(timeout=WAIT)
    assert not t.is_alive()
    return out


def _capture(ring, seen):
    """Record every segment the ring receives, by (step, origin, bucket)."""
    handler = ring._on_seg

    def spy(src, msg):
        seen[(msg["step"], msg["origin"], msg["bucket"])] = msg["data"]
        return handler(src, msg)
    ring.endpoint.register("grad_ring", spy)


def test_ring_two_endpoints_bitwise_and_exact_accounting():
    """Both ranks compute the same sum bit for bit (origin-rank combine
    order), metas travel with bucket 0, and each rank's wire_bytes is
    exactly one codec encode."""
    counted = []
    a, b, ra, rb = _two_rings(Endpoint, RingAllReduce,
                              account=counted.append)
    try:
        _, plan = _plans()
        ra.configure("fp32", plan, gen=7)
        rb.configure("fp32", plan, gen=7)
        host = {r: _bufs(plan, 3 + r) for r in (0, 1)}
        bufs = {r: [torch.from_numpy(x) for x in host[r]] for r in (0, 1)}
        out = _exchange(ra, rb, 5, bufs, metas=({"rank": 0}, {"rank": 1}))
        for i in range(len(plan.buckets)):
            expect = torch.from_numpy(host[0][i]) + torch.from_numpy(
                host[1][i])                        # rank order 0, 1
            assert torch.equal(out[0][0][i], expect)
            assert torch.equal(out[1][0][i], expect)
        assert out[0][1] == out[1][1] == {0: {"rank": 0}, 1: {"rank": 1}}
        per = Fp32Codec().wire_bytes(plan)
        assert ra.wire_bytes == rb.wire_bytes == per   # no relays at W=2
        assert sum(counted) == per
    finally:
        ra.deactivate(), rb.deactivate()
        a.close(), b.close()


def test_onebit_ring_payloads_are_the_reference_rings_byte_for_byte():
    """The port's 2-rank onebit ring and the reference's, fed the same
    buckets for three steps (each step's residual carried from the last):
    every segment on the wire is byte-identical, both ranks of each ring
    sum identically, and the two rings' sums agree bit for bit."""
    ref_plan, plan = _plans()
    ea, eb, ra, rb = _two_rings(Endpoint, RingAllReduce)
    ja, jb, qa, qb = _two_rings(JaxEndpoint, JaxRing)
    mine_seen, ref_seen = {}, {}
    try:
        for ring in (ra, rb):
            ring.configure("onebit", plan, gen=1)
            _capture(ring, mine_seen)
        for ring in (qa, qb):
            ring.configure("onebit", ref_plan, gen=1)
            _capture(ring, ref_seen)
        for step in range(3):
            host = {r: _bufs(plan, 10 * step + r) for r in (0, 1)}
            mine = _exchange(ra, rb, step, {
                r: [torch.from_numpy(x) for x in host[r]] for r in (0, 1)})
            ref = _exchange(qa, qb, step, host)
            for i in range(len(plan.buckets)):
                assert torch.equal(mine[0][0][i], mine[1][0][i])
                np.testing.assert_array_equal(mine[0][0][i].numpy(),
                                              ref[0][0][i])
        assert len(mine_seen) == 3 * 2 * len(plan.buckets)
        assert mine_seen == ref_seen
        per = OneBitCodec().wire_bytes(plan)
        assert ra.wire_bytes == rb.wire_bytes == 3 * per
        assert 16 * per <= Fp32Codec().wire_bytes(plan)
    finally:
        for ring in (ra, rb, qa, qb):
            ring.deactivate()
        for ep in (ea, eb, ja, jb):
            ep.close()


def test_ring_abort_and_peer_lost_raise_locality_lost():
    a, b, ra, rb = _two_rings(Endpoint, RingAllReduce)
    try:
        _, plan = _plans()
        bufs = [torch.zeros(bk.size) for bk in plan.buckets]
        ra.configure("fp32", plan, gen=1)
        ra.abort("drill")
        with pytest.raises(LocalityLostError, match="drill"):
            ra.allreduce(0, bufs, timeout=5)
        # peer_lost poisons ONLY an active ring
        ra.deactivate()
        ra.peer_lost(1)
        ra.configure("fp32", plan, gen=2)    # clears the poison
        ra.peer_lost(1)
        with pytest.raises(LocalityLostError, match="locality 1 died"):
            ra.allreduce(0, bufs, timeout=5)
        # a blocked exchange ends when its peer's endpoint goes away
        ra.configure("fp32", plan, gen=3)
        a.on_peer_lost = ra.peer_lost
        threading.Timer(0.3, b.close).start()
        t0 = time.monotonic()
        with pytest.raises(LocalityLostError, match="locality 1 died"):
            ra.allreduce(0, bufs, timeout=WAIT)
        assert time.monotonic() - t0 < 10
    finally:
        ra.deactivate(), rb.deactivate()
        a.close(), b.close()


def test_ring_times_out_on_silent_peer():
    a, b, ra, rb = _two_rings(Endpoint, RingAllReduce)
    try:
        _, plan = _plans()
        ra.configure("fp32", plan, gen=1)
        rb.configure("fp32", plan, gen=1)    # registered but never sends
        bufs = [torch.zeros(bk.size) for bk in plan.buckets]
        with pytest.raises(TimeoutError, match="segment"):
            ra.allreduce(0, bufs, timeout=0.4)
    finally:
        ra.deactivate(), rb.deactivate()
        a.close(), b.close()


def test_stale_generation_segments_are_dropped():
    a, b, ra, rb = _two_rings(Endpoint, RingAllReduce)
    try:
        _, plan = _plans()
        ra.configure("fp32", plan, gen=1)
        rb.configure("fp32", plan, gen=2)    # rb's run is newer
        bufs = [torch.ones(bk.size) for bk in plan.buckets]
        with pytest.raises(TimeoutError):     # ra's gen-1 segments to rb
            ra.allreduce(0, bufs, timeout=0.4)  # were dropped there
        assert rb._inbox == {}
    finally:
        ra.deactivate(), rb.deactivate()
        a.close(), b.close()


# -- multi-process drills -----------------------------------------------------

def _plan(**kw):
    kw.setdefault("arch", ARCH)
    kw.setdefault("batch", 4)
    kw.setdefault("seq", 16)
    kw.setdefault("ddp", True)
    return Plan(device="cpu", **kw)


@pytest.mark.multiproc
def test_ddp_fp32_two_localities_bit_identical_to_single():
    """With the fp32 codec a 2-locality DDP run over real processes is
    bit-identical in loss to the port's 1-locality run over the same 2
    shards, and the driver's grad_wire_bytes is exactly steps * (W-1) *
    codec_bytes, as the worker's."""
    steps = 4
    kw = dict(steps=steps, log_every=1, verbose=False)
    with _plan(ddp_shards=2).compile() as single:
        ref = single.train(**kw)
    with _plan(localities=2, ddp_shards=2).compile() as multi:
        out = multi.train(**kw)
    assert out["losses"] == ref["losses"]
    assert out["final_loss"] == ref["final_loss"]
    assert out["codec_bytes"] == ref["codec_bytes"]
    assert ref["grad_wire_bytes"] == 0            # world 1: nothing sent
    assert out["grad_wire_bytes"] == steps * 1 * out["codec_bytes"]
    worker = out["localities"][1]
    assert worker["grad_wire_bytes"] == out["grad_wire_bytes"]
    assert worker["final_loss"] == out["final_loss"]


@pytest.mark.multiproc
def test_ddp_two_localities_resumes_the_reference_checkpoint(tmp_path):
    """The JAX package's 1-locality DDP run saves at step 2; the port
    resumes a copy at 2 localities (the worker restores the same file)
    and its fp32 losses for steps 3-4 are the reference's within 1e-4."""
    argv = dict(steps=4, log_every=1, verbose=False)
    kw = dict(arch=ARCH, batch=4, seq=16, ddp=True, ddp_shards=2)
    with JaxPlan(**kw).compile() as s:
        ref = s.train(ckpt_dir=str(tmp_path / "jax"), ckpt_every=2, **argv)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    shutil.rmtree(tmp_path / "port" / "step_00000004")
    with _plan(localities=2, ddp_shards=2).compile() as s:
        out = s.train(ckpt_dir=str(tmp_path / "port"), resume=True,
                      ckpt_every=2, **argv)
    assert len(out["losses"]) == 2
    np.testing.assert_allclose(out["losses"], ref["losses"][2:], rtol=1e-4)
    assert out["localities"][1]["final_loss"] == out["final_loss"]


@pytest.mark.multiproc
def test_ddp_kill_mid_allreduce_aborts_cleanly():
    """SIGKILL a worker mid-run: the survivors abort the step with
    LocalityLostError (no hang) and the session still closes."""
    t0 = time.time()
    with _plan(batch=6, localities=3, ddp_shards=3).compile() as s:
        with pytest.raises(LocalityLostError):
            s.train(steps=30, kill_locality_at_step=3, log_every=10,
                    verbose=False)
    assert time.time() - t0 < 120          # abort, never hang
