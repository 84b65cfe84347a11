"""A mesh beside fabric localities and elastic membership
(``Plan(localities=2, data=2, model=2)``, ``Plan(elastic=True,
data=2)``) against the one-locality mesh and the JAX package's same
plan.

The mesh's four rank processes form one gloo world; the session's other
locality is a task locality beside it, in no world: it builds each
step's batch (rank 0 feeds it to every rank), stacks each serve wave,
homes a gateway replica and owns checkpoint shards.  One JAX subprocess
with 4 host devices writes the reference's train and serve parameters
(``PRNGKey(0)``) and runs its same plan at 2 localities while the port's
sessions run on those parameters (``Session._train_params`` and
``_serve_params``):

* ``examples/train_lm_ddp.py``'s drill (a save at step 2, an injected
  failure at step 3, a resume on the same session): the losses are the
  one-locality mesh run's bit for bit and the reference's within
  ``RTOL``; the task locality built batches (``dispatched[1] > 0``), and
  the step-2 manifest's ownership, its shards' leaves and
  ``ckpt_leaf_wire_bytes`` are the reference's;
* ``Session.serve``'s tokens and ``serve_stream``'s streams (two
  replicas, one homed on locality 1, whose ``stack`` ran there) are the
  one-locality mesh's and the reference's;
* the task locality killed mid-run: the run finishes with the same
  losses (its batches re-spawn on the driver);
* ``Plan(elastic=True, data=2)`` with a locality joining after step 1
  and a driver stall after step 3 (the steal window): the static run's
  losses bit for bit, stolen tasks, and a world of the mesh's two ranks
  only (the joiner is in none).
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.frontend import Plan
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARCH, BATCH, SEQ, STEPS, EVERY, FAIL = "qwen3-4b", 8, 16, 4, 2, 3
MESH = dict(data=2, model=2)
SERVE = dict(requests=3, prompt_len=8, gen_len=3, slots=2)
STREAM = dict(requests=4, prompt_len=8, gen_len=3, slots=2, replicas=2)
RTOL = 1e-5
# the elastic runs' steps and the driver's stall two steps after the join
ELASTIC_STEPS, STALL_S = 6, 0.25

_REF = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.core.sharding import init_params
    from repro.frontend import Plan
    from repro.models.model import build_model

    def flat(tree, name, spec):
        out = {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
               for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        path = os.path.join(spec["tmp"], name + ".npz")
        np.savez(path, **out)
        return path

    def main():
        spec = json.loads(sys.stdin.read())
        key = jax.random.PRNGKey(0)
        train = flat(init_params(build_model(get_config(
            spec["arch"], tiny=True)).specs(), key), "train", spec)
        kw = spec["serve"]
        with Plan(arch=spec["arch"]).compile() as s:
            pre = s._serve_steps_for(kw["prompt_len"], kw["gen_len"], 1)[0]
            serve = flat(init_params(pre.specs, key), "serve", spec)
        print("PARAMS " + json.dumps([train, serve]), flush=True)
        logged = []

        class Log:
            def on_log(self, it, loss):
                logged.append(loss)
        plan = Plan(arch=spec["arch"], batch=spec["batch"], seq=spec["seq"],
                    localities=2, **spec["mesh"])
        out = {}
        with plan.compile() as s:
            d = os.path.join(spec["tmp"], "ref-ck")
            train_kw = dict(steps=spec["steps"], ckpt_dir=d,
                            ckpt_every=spec["every"], log_every=1,
                            hooks=Log(), verbose=False)
            try:
                s.train(fail_at_step=spec["fail"], **train_kw)
            except RuntimeError:
                pass
            res = s.train(resume=True, **train_kw)
            out["losses"] = logged
            out["distributed"] = res["runtime_stats"]["distributed"]
            pre, dec = s._serve_steps_for(kw["prompt_len"], kw["gen_len"],
                                          kw["slots"])
            waves = []

            def wrap(fn, first):
                def call(*a):
                    logits, cache = fn(*a)
                    tok = np.asarray(jnp.argmax(logits, -1))
                    if first:
                        waves.append([tok])
                    else:
                        waves[-1].append(tok)
                    return logits, cache
                return call
            pre.fn, dec.fn = wrap(pre.fn, True), wrap(dec.fn, False)
            s.serve(verbose=False, **kw)
            out["tokens"] = [np.stack(w, 1).tolist() for w in waves]
            st = s.serve_stream(verbose=False, **spec["stream"])
            out["streams"] = st["streams"]
        with open(os.path.join(d, "step_%08d" % spec["every"],
                               "manifest.json")) as f:
            out["manifest"] = json.load(f)
        print(json.dumps(out))

    if __name__ == "__main__":
        main()
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


class _Log:
    """The logged losses; with ``join_after``, a locality added after that
    step and, two steps later, a driver stall of ``STALL_S`` (the newcomer
    drains its queue and goes hungry: the deterministic steal window, as
    ``tests/test_torch_elastic.py`` opens it)."""

    def __init__(self, session=None, join_after=None):
        self.losses, self.session, self.join_after = [], session, join_after
        self.world = None

    def on_log(self, it, loss):
        self.losses.append(loss)

    def on_step(self, it, metrics):
        if self.join_after is None:
            return
        if it == self.join_after - 1:
            self.session.add_locality()
            self.world = dist.get_world_size()
        if it == self.join_after + 1:
            time.sleep(STALL_S)


def _plan(**kw) -> Plan:
    return Plan(arch=ARCH, batch=BATCH, seq=SEQ, device="cpu", **kw)


def _session(plan, params, tmp, name) -> dict:
    """The drill, ``serve`` and ``serve_stream`` on one session; at 2
    localities also the kill drill."""
    out: dict = {}
    ck = str(tmp / f"{name}-ck")
    with plan.compile() as s:
        s._train_params, s._serve_params = params
        log = _Log()
        kw = dict(steps=STEPS, ckpt_dir=ck, ckpt_every=EVERY, log_every=1,
                  hooks=log, verbose=False)
        with pytest.raises(RuntimeError, match="injected node failure"):
            s.train(fail_at_step=FAIL, **kw)
        res = s.train(resume=True, **kw)
        out["losses"] = log.losses
        out["distributed"] = res["runtime_stats"].get("distributed")
        served = s.serve(verbose=False, **SERVE)
        out["tokens"] = [g.tolist() for g in served["generated"]]
        out["serve_nodes"] = served["nodes"]
        st = s.serve_stream(verbose=False, **STREAM)
        out["streams"] = st["streams"]
        out["stream_nodes"] = st["nodes"]
        out["assign"] = st["replica_assignments"]
        if plan.localities > 1:
            log = _Log()
            s.train(steps=STEPS, log_every=1, hooks=log, verbose=False,
                    kill_locality_at_step=1)
            out["killed"] = log.losses
    with open(os.path.join(ck, f"step_{EVERY:08d}", "manifest.json")) as f:
        out["manifest"] = json.load(f)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_localities")
    spec = {"arch": ARCH, "batch": BATCH, "seq": SEQ, "mesh": MESH,
            "steps": STEPS, "every": EVERY, "fail": FAIL, "serve": SERVE,
            "stream": STREAM, "tmp": str(tmp)}
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(_REF)
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, f.name], env=env,
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
        params = tuple(_tree(p) for p in json.loads(line[len("PARAMS "):]))
        port = {"two": _session(_plan(localities=2, **MESH), params, tmp,
                                "two"),
                "one": _session(_plan(**MESH), params, tmp, "one")}
        for name, plan in (("static", _plan(data=2)),
                           ("elastic", _plan(data=2, elastic=True))):
            with plan.compile() as s:
                log = _Log(s, join_after=1 if plan.elastic else None)
                res = s.train(steps=ELASTIC_STEPS, log_every=1, hooks=log,
                              verbose=False)
            port[name] = {"losses": log.losses, "world": log.world,
                          "distributed": res["runtime_stats"].get(
                              "distributed")}
        rest = proc.stdout.read()
        assert proc.wait(timeout=600) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        err.seek(0)
        log = err.read()
        err.close()
    assert rest.strip(), log[-3000:]
    return {"ref": json.loads(rest.strip().splitlines()[-1]), "port": port}


def test_drill_losses_are_one_localitys_and_the_references(runs):
    two, one, ref = runs["port"]["two"], runs["port"]["one"], \
        runs["ref"]
    # steps 1-3 of the failed run, then steps 3-4 of the resumed one
    assert len(two["losses"]) == FAIL + STEPS - EVERY
    assert two["losses"] == one["losses"]
    assert two["losses"][FAIL - 1] == two["losses"][FAIL]
    np.testing.assert_allclose(two["losses"], ref["losses"], rtol=RTOL)


def test_the_task_locality_built_the_batches(runs):
    d = runs["port"]["two"]["distributed"]
    assert d["dispatched"].get(1, 0) > 0
    assert runs["port"]["one"]["distributed"] is None


def _layout(manifest) -> dict:
    return {"ownership": manifest["ownership"],
            "n_leaves": manifest["n_leaves"],
            "shards": [(s["shard"], s["locality"],
                        [leaf["index"] for leaf in s["leaves"]])
                       for s in manifest["shards"]]}


def test_checkpoint_owners_and_wire_are_the_references(runs):
    two, ref = runs["port"]["two"], runs["ref"]
    assert _layout(two["manifest"]) == _layout(ref["manifest"])
    assert two["manifest"]["ownership"] == {"0": [0], "1": [1]}
    assert two["distributed"]["ckpt_leaf_wire_bytes"] == \
        ref["distributed"]["ckpt_leaf_wire_bytes"] > 0


def test_serve_tokens_and_streams_are_one_localitys_and_the_references(
        runs):
    two, one, ref = runs["port"]["two"], runs["port"]["one"], runs["ref"]
    assert two["tokens"] == one["tokens"] == ref["tokens"]
    assert two["streams"] == one["streams"] == ref["streams"]
    # each serve wave stacked on the task locality; a replica homed there
    assert any(n.startswith("stack:") and n.endswith("@L1")
               for n in two["serve_nodes"])
    assert any(n.startswith("stack") and n.endswith("@L1")
               for n in two["stream_nodes"])
    assert sorted(set(two["assign"].values())) == [0, 1]


def test_killed_task_locality_leaves_the_losses(runs):
    one = runs["port"]["one"]
    straight = one["losses"][:FAIL] + one["losses"][FAIL + 1:]
    assert runs["port"]["two"]["killed"] == straight


def test_elastic_join_on_a_mesh_steals_and_keeps_the_losses(runs):
    static, elastic = runs["port"]["static"], runs["port"]["elastic"]
    assert elastic["losses"] == static["losses"]
    d = elastic["distributed"]
    assert d["joined_localities"] == 1 and d["stolen_tasks"] > 0
    assert d["dispatched"].get(1, 0) > 0
    assert elastic["world"] == 2       # the mesh's ranks; no joiner
