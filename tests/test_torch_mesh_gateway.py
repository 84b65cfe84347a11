"""The serving gateway over rank processes (``Session.serve_stream`` on a
mesh session) against the JAX package's gateway on the same mesh,
weights and arrival scripts.

Rank 0 runs the gateway, the other rank follows its command stream
(``frontend/mesh.rank_serve_stream``).  At ``model=2`` (each rank its
heads and vocab columns; greedy tokens over the model group) and at
``data=2`` (each rank its rows of the decode batch; the batch-1 prefill
replicated): every stream, every status, the tree and the gateway's
counters equal the reference's for

* ``faults``: the reference battery's arrivals with a cancel, a poisoned
  prefill and a deadline that lapses before admission;
* ``plain`` and ``drill`` (two replicas, replica 0 killed at round 2),
  whose streams are bit-identical to each other within the port;
* ``burst``: six requests admitted in one round, whose prefills the
  runtime runs on several threads at once: the command order holds.

Every page is reclaimed on every rank, and a rank parks only its blocks
of a request's state (half of it at ``model=2``).
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.core import steps
from repro_torch.core.sharding import is_spec
from repro_torch.frontend import Plan
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARRIVALS = (0, 0, 1, 3, 3)
KW = dict(prompt_len=16, gen_len=4, slots=2)
MESHES = {"model2": dict(model=2), "data2": dict(data=2)}


def _trace(arrivals=ARRIVALS, faults=None):
    faults = faults or {}
    return [dict({"at_round": r}, **faults.get(i, {}))
            for i, r in enumerate(arrivals)]


SCRIPTS = {
    "faults": (dict(trace=_trace(faults={1: {"cancel_after": 2},
                                         2: {"inject": "poison-prefill"},
                                         4: {"deadline_ms": 0.0}}))),
    "plain": dict(trace=_trace()),
    "drill": dict(trace=_trace(), replicas=2, kill_replica_at_round=[0, 2]),
    "burst": dict(trace=_trace((0,) * 6)),
}
# the pool's high-water marks depend on thread timing, in either package
_TIMED = ("pages_grown", "pages_reused", "pages_peak")

_REF = textwrap.dedent("""
    import json, os, sys
    import jax, numpy as np
    from repro.core.sharding import init_params
    from repro.frontend import Plan
    spec = json.loads(sys.stdin.read())
    with Plan().compile() as s:
        pre = s._serve_steps_for(8, 8, 1)[0]
        params = init_params(pre.specs, jax.random.PRNGKey(s.plan.seed))
    flat = {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    path = os.path.join(spec["tmp"], "params.npz")
    np.savez(path, **flat)
    print("PARAMS " + path, flush=True)
    out = {}
    for name, mesh in spec["meshes"].items():
        with Plan(**mesh).compile() as s:
            for script, kw in spec["scripts"].items():
                kw = dict(kw, **spec["kw"])
                if "kill_replica_at_round" in kw:
                    kw["kill_replica_at_round"] = tuple(
                        kw["kill_replica_at_round"])
                got = s.serve_stream(verbose=False, **kw)
                out[f"{name}/{script}"] = {
                    "streams": got["streams"],
                    "status": {h.rid: h.status for h in got["handles"]},
                    "serve": got["runtime_stats"]["serve"],
                    "cache": got["cache"], "nodes": got["nodes"],
                    "trace": got["trace"],
                    **{k: got[k] for k in ("completed", "cancelled",
                                           "expired", "failed", "rounds",
                                           "epochs", "tokens",
                                           "padded_tokens")}}
    print(json.dumps(out))
""")


def _tree(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return out


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """The reference's gateway runs and the port's, the port's sessions
    running while the reference serves."""
    tmp = tmp_path_factory.mktemp("mesh_gateway")
    spec = {"meshes": MESHES, "scripts": SCRIPTS, "kw": KW,
            "tmp": str(tmp)}
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", _REF], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    proc.stdin.write(json.dumps(spec))
    proc.stdin.close()
    try:
        line = proc.stdout.readline()
        if not line.startswith("PARAMS "):
            proc.wait(timeout=60)
            err.seek(0)
            pytest.fail(f"reference failed: {err.read()[-3000:]}")
        params = _tree(line[len("PARAMS "):].strip())
        torch_threads.apply(torch_threads.RANK)
        port = {}
        for name, mesh in MESHES.items():
            with Plan(device="cpu", **mesh).compile() as s:
                s._serve_params = params
                for script, kw in SCRIPTS.items():
                    kw = dict(kw, **KW)
                    if "kill_replica_at_round" in kw:
                        kw["kill_replica_at_round"] = tuple(
                            kw["kill_replica_at_round"])
                    port[f"{name}/{script}"] = s.serve_stream(
                        verbose=False, **kw)
        rest = proc.stdout.read()
        assert proc.wait(timeout=600) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        err.seek(0)
        log = err.read()
        err.close()
    assert rest.strip(), log[-3000:]
    return json.loads(rest.strip().splitlines()[-1]), port


def _untimed(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if k not in _TIMED}


CASES = [f"{m}/{s}" for m in MESHES for s in SCRIPTS]


@pytest.mark.parametrize("case", CASES)
def test_mesh_gateway_streams_equal_the_references(streamed, case):
    ref, port = streamed
    got, want = port[case], ref[case]
    assert got["streams"] == want["streams"]
    assert {h.rid: h.status for h in got["handles"]} == want["status"]
    assert got["nodes"] == want["nodes"]
    assert [list(map(_listify, t)) for t in got["trace"]] == \
        [list(map(_listify, t)) for t in want["trace"]]
    for key in ("completed", "cancelled", "expired", "failed", "rounds",
                "epochs", "tokens", "padded_tokens"):
        assert got[key] == want[key], key
    # the session's serve counters accumulate over the scripts, in the
    # same order on both sides
    assert _untimed(got["runtime_stats"]["serve"]) == \
        _untimed(want["serve"])
    assert _untimed(got["cache"]) == _untimed(want["cache"])


def _listify(x):
    return list(x) if isinstance(x, (list, tuple)) else x


@pytest.mark.parametrize("case", CASES)
def test_mesh_gateway_reclaims_every_page_on_every_rank(streamed, case):
    _, port = streamed
    got = port[case]
    serve = got["runtime_stats"]["serve"]
    assert serve.get("prefill_recompute", 0) == 0
    assert serve["page_hits"] == serve["refills"]
    assert got["cache"]["pages_live"] == 0
    for loc in got["localities"].values():
        c = loc["cache"]
        assert c["pages_live"] == 0 and c["cache_entries"] == 0
        assert c["page_allocs"] == c["page_frees"]
        # the follower ran every body rank 0 sent, then the closing one
        assert loc["commands"] == got["commands"] + 1


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicas_and_the_kill_drill_keep_the_streams(streamed, mesh):
    _, port = streamed
    plain, drill = port[f"{mesh}/plain"], port[f"{mesh}/drill"]
    assert drill["streams"] == plain["streams"]
    assert drill["runtime_stats"]["serve"]["replica_deaths"] >= 1
    assert plain["completed"] == drill["completed"] == len(ARRIVALS)


def test_a_rank_parks_only_its_blocks(streamed):
    """At ``model=2`` a rank parks its kv heads of the batch-1 cache (half
    of it); at ``data=2`` every rank parks the whole row, since a
    request's slot, so its dp rank, is chosen only at refill."""
    _, port = streamed
    cfg = Plan(device="cpu").config()
    whole = sum(s.size * s.dtype.itemsize for s in pytree.tree_leaves(
        steps.make_prefill_step(cfg, {"seq_len": 20, "global_batch": 1})
        .cache_specs, is_leaf=is_spec))
    for mesh, share in (("model2", whole // 2), ("data2", whole)):
        got = port[f"{mesh}/plain"]
        assert got["request_bytes"] == share
        assert all(loc["request_bytes"] == share
                   for loc in got["localities"].values())


def test_burst_admits_several_requests_in_one_round(streamed):
    _, port = streamed
    got = port["model2/burst"]
    assert got["completed"] == 6
    assert got["runtime_stats"]["serve"]["admitted"] >= 6
    assert len({tuple(s) for s in got["streams"].values()}) > 1
