"""SPMD mode with mesh axes (``Plan(spmd=True, localities=2, data=2)``
and ``Plan(spmd=True, localities=2, model=2)``) against the JAX
package's SPMD layout and the one-locality mesh.

Each locality is a gloo world of its mesh's two ranks and computes the
same steps in lockstep, as the reference's identical local meshes do;
persistence is what spans localities: at a save each locality gathers
its mesh's blocks into the global state over its own groups and writes
the ``p``-th slice of every leaf that splits over the 2 localities, so
no leaf byte crosses the messaging layer.  Per plan:

* a save at step 2 and an injected failure at step 3: ownership
  ``{"0": [0], "1": [1]}``, leaves really sliced, the two shards' byte
  loads within 0.4 of each other, ``ckpt_leaf_wire_bytes`` 0, a clean
  ``Session.lint()`` and no ``torch.distributed`` world left after
  ``close``;
* every segment's slice, global shape and checksum are the reference's
  SPMD save of the same tree (``repro.checkpoint.spmd``'s persistence
  layout on a 2-device mesh, ``format.leaf_checksum``, in a subprocess
  with two host devices, on the checkpoint as the reference re-joins
  it);
* the checkpoint restored at one process is the one-locality mesh run's
  step-2 checkpoint, leaf for leaf, and a resume on that mesh (2 -> 1
  localities) takes step 3 as the straight run did, bit for bit;
* ``Session.serve`` and ``serve_stream`` serve on the driver's mesh, as
  the reference does, their ``stack`` prep on the other locality: the
  one-locality mesh's tokens and streams.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.bridge import host_leaves
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.frontend import Plan
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARCH, BATCH, SEQ, STEPS, EVERY, FAIL = "qwen3-4b", 4, 16, 3, 2, 2
MESHES = {"data2": dict(data=2), "model2": dict(model=2)}
SERVE = dict(requests=3, prompt_len=8, gen_len=3, slots=2)
STREAM = dict(requests=3, prompt_len=8, gen_len=3, slots=2)

_REF = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.checkpoint import format as fmt, spmd
    from repro.checkpoint.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.core import steps as S
    from repro.launch.mesh import make_local_mesh
    spec = json.loads(sys.stdin.read())
    like = S.make_train_step(
        get_config(spec["arch"], tiny=True), make_local_mesh(), S.Strategy(),
        {"seq_len": spec["seq"], "global_batch": spec["batch"],
         "kind": "train"}).init(jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:2]), (spmd.CKPT_AXIS,))
    out = {}
    for name, d in spec["dirs"].items():
        _, tree = CheckpointManager(d, async_save=False).restore(
            like, step=spec["step"])
        segs = {0: [], 1: []}
        for i, leaf in enumerate(jax.tree.leaves(spmd.global_view(tree,
                                                                  mesh))):
            for s in leaf.addressable_shards:
                if s.replica_id != 0:
                    continue
                pairs = spmd._normalize_index(s.index, leaf.shape)
                segs[s.device.id].append(
                    [i, pairs and [list(p) for p in pairs],
                     pairs and list(leaf.shape),
                     fmt.leaf_checksum(np.asarray(s.data))])
        out[name] = segs
    print(json.dumps(out))
""")


def _plan(**kw) -> Plan:
    return Plan(arch=ARCH, batch=BATCH, seq=SEQ, device="cpu", **kw)


def _state(ck: Path) -> list:
    ts = steps.make_train_step(get_config(ARCH, tiny=True), steps.Strategy())
    step, back = CheckpointManager(ck, async_save=False, spmd=False).restore(
        (ts.params_like(), ts.global_like()), step=EVERY)
    assert step == EVERY
    return host_leaves(back)[1]


def _served(s) -> dict:
    """``serve``'s tokens and ``serve_stream``'s streams on session ``s``,
    with the ``stack`` nodes' homes."""
    served = s.serve(verbose=False, **SERVE)
    st = s.serve_stream(verbose=False, **STREAM)
    return {"tokens": [g.tolist() for g in served["generated"]],
            "streams": st["streams"],
            "stacks": [n for n in served["nodes"] + st["nodes"]
                       if n.startswith("stack:")]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_mesh")
    out = {}
    kw = dict(steps=STEPS, ckpt_every=EVERY, log_every=1, verbose=False)
    for name, mesh in MESHES.items():
        ck, one = tmp / f"{name}-spmd", tmp / f"{name}-one"
        with _plan(spmd=True, localities=2, **mesh).compile() as s:
            with pytest.raises(RuntimeError, match="injected node failure"):
                s.train(ckpt_dir=str(ck), fail_at_step=FAIL, **kw)
            lint = [f.rule for f in s.lint()]
            dstats = s.distributed.stats()
            served = _served(s)
        world_after = dist.is_initialized()
        with _plan(**mesh).compile() as s:
            straight = s.train(ckpt_dir=str(one), **kw)
            served_one = _served(s)
        resume = tmp / f"{name}-resume"
        resume.mkdir()
        (ck / f"step_{EVERY:08d}").rename(resume / f"step_{EVERY:08d}")
        with _plan(**mesh).compile() as s:
            resumed = s.train(ckpt_dir=str(resume), resume=True, **kw)
        manifest = json.loads((resume / f"step_{EVERY:08d}" /
                               "manifest.json").read_text())
        out[name] = {"lint": lint, "dstats": dstats, "served": served,
                     "served_one": served_one,
                     "world_after": world_after, "straight": straight,
                     "resumed": resumed, "manifest": manifest,
                     "dir": resume, "one": one}
    env = torch_threads.jax_env(2, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-c", _REF], env=env, text=True,
        capture_output=True, timeout=300, input=json.dumps({
            "arch": ARCH, "batch": BATCH, "seq": SEQ, "step": EVERY,
            "dirs": {n: str(r["dir"]) for n, r in out.items()}}))
    assert p.returncode == 0, p.stderr[-3000:]
    ref = json.loads(p.stdout.strip().splitlines()[-1])
    for name in out:
        out[name]["ref"] = ref[name]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_locality_writes_its_own_sliced_segments(runs, mesh):
    r = runs[mesh]
    m = r["manifest"]
    assert m["ownership"] == {"0": [0], "1": [1]}
    assert any("slice" in leaf for sh in m["shards"] for leaf in sh["leaves"])
    nbytes = [sh["nbytes"] for sh in m["shards"]]
    assert min(nbytes) > 0.4 * max(nbytes)
    assert r["dstats"]["ckpt_leaf_wire_bytes"] == 0
    assert r["lint"] == []
    assert r["world_after"] is False


@pytest.mark.parametrize("mesh", list(MESHES))
def test_segments_are_the_references_spmd_save_of_the_tree(runs, mesh):
    r = runs[mesh]
    for sh in r["manifest"]["shards"]:
        got = [[leaf["index"], leaf.get("slice"),
                leaf.get("global_shape"), leaf["checksum"]]
               for leaf in sh["leaves"]]
        assert got == r["ref"][str(sh["shard"])], sh["shard"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_to_one_restore_is_bit_identical(runs, mesh):
    r = runs[mesh]
    for a, b in zip(_state(r["dir"]), _state(r["one"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    straight, resumed = r["straight"]["losses"], r["resumed"]["losses"]
    assert resumed == straight[EVERY:]
    assert r["resumed"]["final_loss"] == r["straight"]["final_loss"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_and_serve_stream_run_on_the_drivers_mesh(runs, mesh):
    """``Session.serve`` and ``serve_stream`` on the SPMD plan serve on the
    driver's mesh, as the reference does (the other locality's world
    stays idle), with the waves' and replicas' ``stack`` prep on the
    other locality: the tokens and streams of the one-locality mesh."""
    r = runs[mesh]
    got, want = r["served"], r["served_one"]
    assert got["tokens"] == want["tokens"]
    assert got["streams"] == want["streams"]
    assert any(n.endswith("@L1") for n in got["stacks"]), got["stacks"]
