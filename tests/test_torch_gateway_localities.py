"""The port's serving gateway at two localities (``Gateway(distributed=,
homes=)``, ``Session.serve_stream`` at ``localities > 1``): the
counterparts of the multi-process drills of ``tests/test_serve_gateway.py``.

Each replica's request prep (its ``stack`` nodes) runs on its home
locality, a worker process; the model runs in this process.  A request's
stream depends only on its prompt, so the two-locality streams, with one
replica or two, and the streams that survive a SIGKILLed locality, are
bit-identical to the one-locality run's; on bridged parameters they also
equal the JAX package's gateway's.
"""
import threading
import time

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.frontend import Plan as JaxPlan
from repro.frontend.gateway import Gateway as JaxGateway
from repro.frontend.gateway import RequestQueue as JaxRequestQueue
from repro_torch.bridge import params_from_numpy
from repro_torch.core import steps
from repro_torch.frontend import Plan
from repro_torch.frontend.gateway import Gateway, RequestQueue
from torch_parity import _jax_serve_params
import torch_threads

torch_threads.apply()

pytestmark = pytest.mark.multiproc

ARCH = "qwen2.5-3b"
ARRIVALS = (0, 0, 1, 3, 3)           # staggered, requests > slots
KW = dict(prompt_len=16, gen_len=4, slots=2, verbose=False)


def _plan(**kw):
    return Plan(arch=ARCH, device="cpu", **kw)


def _trace():
    return [{"at_round": r} for r in ARRIVALS]


_ONE: dict = {}


def _one_locality(key, **kw):
    """The 1-locality, 1-replica run of a script (cached per key)."""
    if key not in _ONE:
        with _plan().compile() as session:
            _ONE[key] = session.serve_stream(**dict(KW, **kw))
    return _ONE[key]


def _assert_clean(out, n):
    assert out["completed"] == n
    assert out["cache"]["pages_live"] == 0
    assert out["runtime_stats"]["serve"].get("prefill_recompute", 0) == 0


@pytest.mark.parametrize("replicas", [1, 2])
def test_two_locality_streams_match_one_locality(replicas):
    """At two localities the ``stack`` nodes run on the worker (replica 0
    is homed there), the streams equal the 1-locality run's bit for bit,
    and steady state never crosses replica page boundaries."""
    with _plan(localities=2, replicas=replicas).compile() as multi:
        out = multi.serve_stream(trace=_trace(), **KW)
        gw_homes = [rep.home for rep in multi._gateway.replicas]
    _assert_clean(out, len(ARRIVALS))
    assert out["replicas"] == replicas
    assert gw_homes == ([1, 0] if replicas == 2 else [0])
    assert out["runtime_stats"]["distributed"]["dispatched"].get(1, 0) > 0
    serve = out["runtime_stats"]["serve"]
    assert serve.get("cross_replica_page_fetches", 0) == 0
    assert out["streams"] == _one_locality("trace", trace=_trace())["streams"]


@pytest.mark.parametrize("replicas", [1, 2])
def test_two_locality_gateway_equals_jax_gateway_on_bridged_params(replicas):
    """The port's gateway at two localities (``replicas`` homed by
    ``_default_homes``) and the JAX package's at one, built on the same
    bridged bf16 serve parameters, stream the same tokens."""
    jcfg = jax_get_config(ARCH, tiny=True)
    _, jparams, tree = _jax_serve_params(jcfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, 16).astype(np.int32)
               for _ in ARRIVALS]

    def run(gw, queue):
        for p, r in zip(prompts, ARRIVALS):
            queue.submit(p, at_round=r)
        queue.close()
        return gw.run(queue)

    with JaxPlan(arch=ARCH).compile() as ref:
        pre1 = ref._serve_steps_for(16, 4, 1)[0]
        dec = ref._serve_steps_for(16, 4, 2)[1]
        want = run(JaxGateway(ref.runtime, prefill_step=pre1, decode_step=dec,
                              params=jparams, prompt_len=16, gen_len=4,
                              slots=2), JaxRequestQueue())
    with _plan(localities=2).compile() as mine:
        params = params_from_numpy(tree, steps._serve_cfg(mine.cfg), "cpu")
        pre1 = mine._serve_steps_for(16, 4, 1)[0]
        dec = mine._serve_steps_for(16, 4, 2)[1]
        got = run(Gateway(mine.runtime, distributed=mine.distributed,
                          prefill_step=pre1, decode_step=dec, params=params,
                          prompt_len=16, gen_len=4, slots=2, device="cpu",
                          replicas=replicas), RequestQueue())
        dispatched = mine.distributed.stats()["dispatched"]
    assert got["completed"] == want["completed"] == len(ARRIVALS)
    assert got["streams"] == want["streams"]
    assert dispatched.get(1, 0) > 0


def _kill_mid_stream(replicas, seed):
    """Stream 6 prompts from a feeder thread at two localities, SIGKILL
    the worker before the fourth arrives; returns (the run, the
    prompts)."""
    with _plan(localities=2, replicas=replicas).compile() as session:
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, session.cfg.vocab, 16).astype(np.int32)
                   for _ in range(6)]
        q = RequestQueue()
        killed = {}

        def feeder():
            for i, p in enumerate(prompts):
                if i == 3:
                    killed["rank"] = session.kill_locality()
                q.submit(p)
                time.sleep(0.05)
            q.close()

        t = threading.Thread(target=feeder)
        t.start()
        out = session.serve_stream(queue=q, **KW)
        t.join(timeout=60)
        assert not t.is_alive()
        alive = session.distributed.stats()["alive_workers"]
    assert killed["rank"] == 1 and alive == []
    return out, prompts


def test_kill_locality_mid_stream_completes_survivors():
    """SIGKILL the worker while the gateway streams: its in-flight
    ``stack`` tasks re-spawn, later requests still complete, and every
    stream equals the 1-locality run's."""
    out, prompts = _kill_mid_stream(1, 23)
    _assert_clean(out, len(prompts))
    base = _one_locality("kill-23", trace=[{"prompt": p} for p in prompts])
    assert out["streams"] == base["streams"]


def test_kill_locality_retires_its_replica_and_survivor_absorbs():
    """SIGKILL the locality that homes replica 0: the liveness sweep
    retires that replica, the driver-homed survivor adopts its pages, and
    every request completes bit-identically with no prefill recomputed."""
    out, prompts = _kill_mid_stream(2, 31)
    _assert_clean(out, len(prompts))
    assert out["runtime_stats"]["serve"]["replica_deaths"] == 1
    base = _one_locality("kill-31", trace=[{"prompt": p} for p in prompts])
    assert out["streams"] == base["streams"]
