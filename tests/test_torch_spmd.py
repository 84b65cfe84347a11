"""The port's SPMD mode (``Plan(spmd=True)``, DESIGN.md §10) against the
reference's ``tests/test_spmd.py`` and ``checkpoint/spmd.py``: each process
of a ``torch.distributed`` world (gloo) trains in lockstep and writes only
its own checkpoint segments.

* the segment layout: for every leaf of tiny qwen3-4b's and tiny
  granite-moe-1b-a400m's ``(params, opt)`` the port's blocks for ranks 0
  and 1 of a world of 2 are the reference's (``persistence_sharding`` and
  ``addressable_segments`` on a 2-device mesh, in a subprocess with two
  host devices);
* a 2-process SPMD save through ``Session.train``: segments only, the
  ownership ``{"0": [0], "1": [1]}``, zero leaf bytes on the wire, the
  losses of a 1-process run bit for bit, a clean ``Session.lint()`` and no
  sanitizer diagnostic in either process (armed); the checkpoint restores
  at one process in the port and in the reference's ``CheckpointManager``
  bit for bit;
* the host-loss drill through ``python -m repro_torch.launch.train``:
  ``--spmd --localities 2`` fails after a committed save, and a 2 -> 1
  ``--resume`` ends with the final loss of an uninterrupted run;
* the reference's refusals, a cold ``maybe_init_distributed`` without a
  coordinator, and a failed bring-up that leaves no world behind.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro_torch.analysis import sanitize
from repro_torch.bridge import host_leaves
from repro_torch.checkpoint import format as ckfmt
from repro_torch.checkpoint import spmd as ckspmd
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.core.futures import FuturizedGraph
from repro_torch.frontend import Plan
from repro_torch.launch import mesh
from test_torch_checkpoint import _jax_train_state
import torch_threads

torch_threads.apply()

pytestmark = pytest.mark.spmd

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-4b"
STEPS, EVERY = 4, 2
THREADS = torch_threads.WORKER  # both processes at one count: bit-identity


def _plan(**kw):
    return Plan(arch=ARCH, batch=4, seq=16, device="cpu", **kw)


def _state_shapes(arch):
    """The leaf shapes of tiny ``arch``'s ``(params, opt)`` in the JAX
    layout, from the port's own init."""
    step = steps.make_train_step(get_config(arch, tiny=True),
                                 steps.Strategy())
    tree = step.init(torch.Generator().manual_seed(0), "cpu")
    return tree, [list(a.shape) for a in host_leaves(tree)[1]]


# -- the layout against the reference's ------------------------------------

_REF_LAYOUT = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.checkpoint import spmd
    mesh = Mesh(np.array(jax.devices()[:2]), (spmd.CKPT_AXIS,))
    out = []
    for shape in json.loads(sys.stdin.read()):
        host = np.zeros(shape, np.float32)
        garr = jax.make_array_from_callback(
            tuple(shape), spmd.persistence_sharding(mesh, shape),
            lambda idx: host[idx])
        owners = [s.device.id for s in garr.addressable_shards
                  if s.replica_id == 0]
        per_rank = {0: [], 1: []}
        for dev, (pairs, _, _) in zip(owners, spmd.addressable_segments(garr)):
            per_rank[dev].append(None if pairs is None
                                 else [list(p) for p in pairs])
        out.append([per_rank[0], per_rank[1]])
    print(json.dumps(out))
""")

EDGE_SHAPES = [[], [1], [2], [3, 5], [4, 3], [6], [5, 2, 2], [2, 1, 7]]


@pytest.fixture(scope="module")
def reference_layout():
    """The reference's blocks by rank for every shape of both tiny states
    and the edge shapes, from one subprocess with two host devices."""
    shapes = {arch: _state_shapes(arch)[1]
              for arch in (ARCH, "granite-moe-1b-a400m")}
    shapes["edge"] = EDGE_SHAPES
    flat = [s for v in shapes.values() for s in v]
    env = torch_threads.jax_env(2, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _REF_LAYOUT],
                       input=json.dumps(flat), env=env, text=True,
                       capture_output=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    blocks = iter(json.loads(p.stdout.strip().splitlines()[-1]))
    return {k: [(s, next(blocks)) for s in v] for k, v in shapes.items()}


@pytest.mark.parametrize("which", [ARCH, "granite-moe-1b-a400m", "edge"])
def test_segments_are_the_reference_layout(reference_layout, which):
    """Each leaf's blocks for ranks 0 and 1 of a world of 2: a leading dim
    that divides by 2 splits by rows, anything else (granite's odd vocab,
    scalars) is rank 0's whole."""
    cases = reference_layout[which]
    assert cases
    split = 0
    for shape, (r0, r1) in cases:
        assert ckspmd.segments(shape, 2, 0) == r0, shape
        assert ckspmd.segments(shape, 2, 1) == r1, shape
        split += bool(r1)
    assert split, "no leaf splits: the layout was not exercised"


@pytest.mark.parametrize("arch", [ARCH, "granite-moe-1b-a400m"])
def test_collected_segments_partition_every_leaf(arch):
    """Ranks 0 and 1 together write every leaf exactly once, the bytes of
    ``host_leaves``; a split leaf's rows are copied off its stacked
    per-layer tensors alone."""
    tree, _ = _state_shapes(arch)
    _, want = host_leaves(tree)
    got = {}
    for rank in (0, 1):
        for i, sl, a in zip(*ckspmd.collect_segments(tree, 2, rank)):
            got.setdefault(i, []).append(
                {"index": i, "array": a,
                 "slice": None if sl is None else sl[0],
                 "global_shape": None if sl is None else sl[1]})
    assert sorted(got) == list(range(len(want)))
    for i, segs in got.items():
        back = ckfmt.assemble_leaf(i, segs)
        assert back.dtype == want[i].dtype
        np.testing.assert_array_equal(back, want[i])


# -- a 2-process SPMD run through Session.train -----------------------------

@pytest.fixture(scope="module")
def spmd_run(tmp_path_factory):
    """One 2-process SPMD run (sanitizer armed, inherited by the worker),
    saving every ``EVERY`` steps, and a 1-process run of the same plan."""
    ck = tmp_path_factory.mktemp("spmd") / "ck"
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    os.environ["PHYRAX_SANITIZE"] = "1"
    sanitize.get().clear()
    refusals = {}
    try:
        with _plan(spmd=True, localities=2).compile() as s:
            assert dist.is_initialized() and dist.get_world_size() == 2
            for kw in ({"resilience": "replay"},
                       {"kill_locality_at_step": 1}):
                with pytest.raises(ValueError) as e:
                    s.train(steps=1, verbose=False, **kw)
                refusals[next(iter(kw))] = str(e.value)
            out = s.train(steps=STEPS, ckpt_dir=str(ck), ckpt_every=EVERY,
                          log_every=1, verbose=False)
            lint = [f.rule for f in s.lint()]
        diags = [str(d) for d in sanitize.get().diagnostics()]
    finally:
        os.environ.pop("PHYRAX_SANITIZE", None)
        sanitize.get().clear()
        torch.set_num_threads(threads)
    world_after = dist.is_initialized()
    ck_ref = ck.parent / "ref"
    with _plan().compile() as s:
        ref = s.train(steps=STEPS, ckpt_dir=str(ck_ref), ckpt_every=STEPS,
                      log_every=1, verbose=False)
    return {"ck": ck, "ck_ref": ck_ref, "out": out, "lint": lint, "diags": diags,
            "refusals": refusals, "ref": ref, "world_after": world_after}


def test_spmd_losses_are_one_process_losses(spmd_run):
    out, ref = spmd_run["out"], spmd_run["ref"]
    assert out["losses"] == ref["losses"]
    worker = out["localities"][1]
    assert worker["step"] == STEPS
    assert worker["final_loss"] == ref["final_loss"]
    assert set(worker["launches"]) and not any(worker["launches"].values())


def test_spmd_save_writes_own_segments_with_zero_leaf_wire_bytes(spmd_run):
    """Both processes wrote, each its own shard; leaves really were split;
    every leaf's segments are ``segments``' layout; no leaf byte crossed
    the wire."""
    d = spmd_run["out"]["runtime_stats"]["distributed"]
    assert d["ckpt_leaf_wire_bytes"] == 0
    m = json.loads((spmd_run["ck"] / f"step_{STEPS:08d}" /
                    "manifest.json").read_text())
    assert m["ownership"] == {"0": [0], "1": [1]}
    by_leaf = {}
    for sh in m["shards"]:
        assert sh["locality"] == sh["shard"]
        for leaf in sh["leaves"]:
            by_leaf.setdefault(leaf["index"], {})[sh["shard"]] = leaf
    _, shapes = _state_shapes(ARCH)
    assert sorted(by_leaf) == list(range(len(shapes)))
    sliced = 0
    for i, shape in enumerate(shapes):
        for rank in (0, 1):
            want = ckspmd.segments(shape, 2, rank)
            leaf = by_leaf[i].get(rank)
            if not want:
                assert leaf is None, (i, rank)
                continue
            assert leaf.get("slice") == want[0], (i, rank)
            sliced += "slice" in leaf
    assert sliced
    nbytes = [sh["nbytes"] for sh in m["shards"]]
    assert min(nbytes) > 0.4 * max(nbytes)       # balanced byte load


def test_spmd_session_lints_clean_and_sanitizer_records_nothing(spmd_run):
    assert spmd_run["lint"] == []
    assert spmd_run["diags"] == []
    assert spmd_run["out"]["localities"][1]["diagnostics"] == []


def test_spmd_train_refuses_resilience_and_kill_and_leaves_no_world(
        spmd_run):
    assert "resilience" in spmd_run["refusals"]["resilience"]
    assert "fail_at_step" in spmd_run["refusals"]["kill_locality_at_step"]
    assert spmd_run["world_after"] is False


def _restore(ck):
    tree, _ = _state_shapes(ARCH)
    step, back = CheckpointManager(ck, async_save=False).restore(tree)
    assert step == STEPS
    return host_leaves(back)[1]


def test_spmd_checkpoint_restores_at_one_process_bit_identical(spmd_run):
    """Every leaf of the SPMD checkpoint, re-joined at one process, is the
    1-process run's checkpoint's, optimizer state included; the
    parameters are both runs' final ones."""
    got, want = _restore(spmd_run["ck"]), _restore(spmd_run["ck_ref"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    params = host_leaves(spmd_run["out"]["params"])[1]
    for a, b, c in zip(params, host_leaves(spmd_run["ref"]["params"])[1],
                       got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_spmd_checkpoint_restores_in_the_reference_manager(spmd_run):
    """The reference's ``CheckpointManager`` re-joins the port's segments
    into the port's own 1-process state, leaf for leaf."""
    (jlike, _) = _jax_train_state(ARCH, n_steps=0)
    step, jtree = JaxManager(spmd_run["ck"], async_save=False).restore(jlike)
    assert step == STEPS
    got = jax.tree.leaves(jtree)
    want = _restore(spmd_run["ck_ref"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


# -- the launcher's host-loss drill -------------------------------------------

def _train(extra, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(THREADS))
    env.pop("PHYRAX_SANITIZE", None)
    p = subprocess.run(
        [sys.executable, "-u", "-m", "repro_torch.launch.train", "--device",
         "cpu", "--arch", "qwen2.5-3b", "--batch", "4", "--seq", "16",
         "--log-every", "4"] + extra,
        env=env, text=True, capture_output=True, timeout=300)
    if check and p.returncode != 0:
        raise AssertionError(f"train {extra} failed ({p.returncode}):\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
    return p


def _final_loss(out: str) -> str:
    return re.findall(r"final loss ([0-9.]+)", out)[-1]


def test_spmd_host_loss_then_2_to_1_resume_is_bit_identical(tmp_path):
    """save -> lose the run after the committed step-4 save -> restore
    into one process: the final loss of an uninterrupted run."""
    ck = str(tmp_path / "ck")
    p = _train(["--localities", "2", "--spmd", "--steps", "8", "--ckpt", ck,
                "--ckpt-every", "4", "--fail-at-step", "6"], check=False)
    assert p.returncode != 0
    assert "injected node failure" in p.stdout + p.stderr
    assert sorted(d.name for d in Path(ck).glob("step_*")) == \
        ["step_00000004"]
    m = ckfmt.load_manifest(Path(ck) / "step_00000004")
    assert m["ownership"] == {"0": [0], "1": [1]}
    resumed = _train(["--steps", "8", "--resume", "--ckpt", ck])
    assert "resumed from step 4" in resumed.stdout
    ref = _train(["--steps", "8"])
    assert _final_loss(resumed.stdout) == _final_loss(ref.stdout)


# -- refusals, the world's bring-up and teardown ------------------------------

def test_spmd_plans_the_reference_refuses():
    with pytest.raises(ValueError, match="localities >= 2"):
        _plan(spmd=True).compile()
    with pytest.raises(ValueError, match="exclusive"):
        _plan(spmd=True, ddp=True, localities=2).compile()
    with pytest.raises(ValueError, match="elastic"):
        _plan(spmd=True, elastic=True, localities=2).compile()


def test_maybe_init_distributed_is_cold_without_a_coordinator(monkeypatch):
    for k in ("PHYRAX_DIST_COORDINATOR", "PHYRAX_DIST_NUM_PROCESSES",
              "PHYRAX_DIST_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_init_distributed() is False
    assert not dist.is_initialized()
    monkeypatch.setenv("PHYRAX_DIST_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="world size"):
        mesh.maybe_init_distributed()
    assert 0 < mesh.free_port() < 65536


def test_save_spmd_refuses_sync_other_ranks_and_no_dgraph(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(ckspmd, "is_multiprocess", lambda: True)
    tree = {"w": torch.ones(4, 2)}
    with pytest.raises(RuntimeError, match="async_save=False"):
        CheckpointManager(tmp_path, async_save=False).save(1, tree)
    g = FuturizedGraph(max_workers=1, name="spmd-refusal")
    try:
        monkeypatch.setattr(ckspmd, "world_rank", lambda: (2, 1))
        with pytest.raises(RuntimeError, match="process 0"):
            CheckpointManager(tmp_path, graph=g).save(1, tree)
        monkeypatch.setattr(ckspmd, "world_rank", lambda: (2, 0))
        with pytest.raises(RuntimeError, match="DistributedGraph"):
            CheckpointManager(tmp_path, graph=g).save(1, tree)
    finally:
        g.shutdown(wait=True)


def test_failed_bring_up_leaves_no_world_for_the_next_session(tmp_path):
    """A worker that dies before it joins (its checkpoint directory cannot
    be made) fails the session at once; the next SPMD session in this
    interpreter starts clean and trains."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(TimeoutError, match="did not report in"):
        _plan(spmd=True, localities=2,
              ckpt_dir=str(blocker / "ck")).compile()
    assert not dist.is_initialized()
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        with _plan(spmd=True, localities=2).compile() as s:
            out = s.train(steps=1, log_every=1, verbose=False)
    finally:
        torch.set_num_threads(threads)
    assert out["localities"][1]["step"] == 1
    assert not dist.is_initialized()
