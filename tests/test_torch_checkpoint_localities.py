"""The port's locality-owned checkpoints (``CheckpointManager(dgraph=)``,
``Session.train`` at ``localities > 1``) over real worker processes: the
counterparts of the checkpoint tests of ``tests/test_distrib.py`` (shards
written by their owners, the leaf bytes on the wire, a corrupt shard's
error across the wire, a save whose owner is killed, the 2 -> 1 and 2 -> 3
resharded resumes), the launcher's drill, and owner-written checkpoints
across the two packages: the same tree saved at two localities by each
gives the same ownership, manifests and shard bytes, and each restores in
the other.

Everything a worker runs is a module-level function of the port, so it
crosses the wire by reference.
"""
import json
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro.distrib import DistributedGraph as JaxDistributedGraph
from repro_torch.bridge import host_leaves
from repro_torch.checkpoint import format as ckfmt
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.format import CheckpointCorruptError
from repro_torch.core.futures import FuturizedGraph
from repro_torch.distrib import DistributedGraph
from repro_torch.frontend import Plan
from repro_torch.launch import train as train_cli
from test_torch_checkpoint import _jax_train_state
import torch_threads

torch_threads.apply()

pytestmark = pytest.mark.multiproc

ARCH = "qwen3-4b"


@pytest.fixture(scope="module")
def cluster():
    """The driver and two worker localities, reused across tests."""
    dg = DistributedGraph(localities=3, name="ckpt-cluster")
    yield dg
    dg.shutdown()


def _tree(k):
    g = torch.Generator().manual_seed(k)
    return {"w": torch.randn(6, 4, generator=g),
            "b": torch.arange(5, dtype=torch.int32),
            "nested": {"s": torch.tensor(1.5),
                       "t": torch.arange(3, dtype=torch.float64)}}


def _assert_tree_equal(t, back):
    for a, b in zip(pytree.tree_leaves(t), pytree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the manager over a cluster ----------------------------------------------

def test_distributed_save_shards_written_by_owners(cluster, tmp_path):
    """Each locality writes its own shard: the ownership map covers the
    driver AND both workers (a shard entry records the rank of the
    process that wrote it), and the restore spreads its reads over them."""
    cm = CheckpointManager(tmp_path, graph=cluster.graph, dgraph=cluster)
    assert cm.ranks() == [0, 1, 2]
    t = _tree(1)
    cm.save(4, t, meta={"who": "owners"})
    cm.wait()
    m = ckfmt.load_manifest(tmp_path / "step_00000004")
    assert m["ownership"] == {"0": [0], "1": [1], "2": [2]}   # 4 leaves
    assert m["n_shards"] == 3 and m["n_leaves"] == 4
    before = dict(cluster.stats()["dispatched"])
    step, back = cm.restore(t)
    after = cluster.stats()["dispatched"]
    assert step == 4
    _assert_tree_equal(t, back)
    assert all(after[r] == before[r] + 1 for r in (1, 2))   # one read each
    assert cm.meta["who"] == "owners"


def test_host_copy_save_accounts_ckpt_leaf_wire_bytes(cluster, tmp_path):
    """Each worker-owned shard ships its owner the leaf bytes in the
    spawn payload, and ``ckpt_leaf_wire_bytes`` counts exactly those."""
    cm = CheckpointManager(tmp_path, graph=cluster.graph, dgraph=cluster)
    before = cluster.stats()["ckpt_leaf_wire_bytes"]
    t = _tree(9)
    _, host = host_leaves(t)
    expected = sum(host[i].nbytes
                   for _sid, rank, idx in ckfmt.assign_shards(len(host),
                                                              [0, 1, 2])
                   for i in idx if rank != 0)
    assert expected > 0
    cm.save(2, t)
    cm.wait()
    assert cluster.stats()["ckpt_leaf_wire_bytes"] - before == expected


def test_corrupt_shard_error_crosses_the_wire(cluster, tmp_path):
    """A ``CheckpointCorruptError`` raised in a worker's shard read
    re-raises at the driver and names the bad shard."""
    cm = CheckpointManager(tmp_path, graph=cluster.graph, dgraph=cluster)
    t = _tree(2)
    cm.save(1, t)
    cm.wait()
    f = tmp_path / "step_00000001" / "shard_00001.bin"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError, match="shard_00001.bin"):
        cm.restore(t)
    step, _ = cm.restore(t, strict_checksums=False)
    assert step == 1


def test_save_completes_when_owner_locality_killed(tmp_path):
    """A shard's owning locality is SIGKILLed before its write
    dispatches: the idempotent task re-targets the driver and the
    manifest still commits, naming the driver as the writer."""
    g = FuturizedGraph(max_workers=2, name="ckpt-kill")
    dg = DistributedGraph(localities=2, graph=g, name="ckpt-kill")
    try:
        cm = CheckpointManager(tmp_path, graph=g, dgraph=dg)
        hold = g.promise(name="hold")
        t = _tree(3)
        cm.save(3, t, deps=(hold,))      # shard 1 owned by worker 1
        dg.group.kill(1)
        hold.set_result(None)
        cm.wait()
        m = ckfmt.load_manifest(tmp_path / "step_00000003")
        assert m["n_shards"] == 2
        assert set(m["ownership"]) == {"0"}    # fallback writer: driver
        step, back = cm.restore(t)
        assert step == 3
        _assert_tree_equal(t, back)
    finally:
        dg.shutdown()
        g.shutdown(wait=True)


# -- Session.train: resharded resumes -----------------------------------------

def _plan(**kw):
    return Plan(arch=ARCH, batch=4, seq=16, device="cpu", **kw)


def test_train_resharded_restore_2_to_1_and_2_to_3(tmp_path):
    """A 2-locality run writes locality-owned shards; resuming at 1 AND
    at 3 localities continues with the losses of an uninterrupted
    single-process run, bit for bit."""
    steps, kw = 6, dict(log_every=1, verbose=False)
    with _plan().compile() as ref_s:
        ref = ref_s.train(steps=steps, **kw)

    ck = str(tmp_path / "ck")
    with _plan(localities=2, ckpt_dir=ck).compile() as writer:
        wrote = writer.train(steps=4, ckpt_every=4, **kw)
        d = wrote["runtime_stats"]["distributed"]
    assert wrote["losses"] == ref["losses"][:4]
    assert d["ckpt_leaf_wire_bytes"] > 0
    m = ckfmt.load_manifest(f"{ck}/step_00000004")
    assert set(m["ownership"]) == {"0", "1"}     # both localities wrote

    ck2 = str(tmp_path / "ck2")                  # second copy: each resume
    shutil.copytree(ck, ck2)                     # writes new checkpoints

    with _plan().compile() as single:            # N=2 -> M=1
        out1 = single.train(steps=steps, ckpt_dir=ck, resume=True, **kw)
    with _plan(localities=3).compile() as multi:  # N=2 -> M=3
        out3 = multi.train(steps=steps, ckpt_dir=ck2, resume=True, **kw)
    assert out1["losses"] == out3["losses"] == ref["losses"][4:]
    m3 = ckfmt.load_manifest(f"{ck2}/step_{steps:08d}")
    assert set(m3["ownership"]) == {"0", "1", "2"}


def test_launch_train_checkpoint_drill_across_localities(tmp_path):
    """The launcher's drill: ``--localities 2 --ckpt`` fails after the
    step-4 save, ``--resume`` at one locality finishes with the straight
    run's losses."""
    base = ["--device", "cpu", "--steps", "8", "--batch", "4", "--seq", "16",
            "--log-every", "1"]
    straight = train_cli.run(train_cli.parser().parse_args(base))
    ck = ["--ckpt", str(tmp_path / "ck"), "--ckpt-every", "4"]
    with pytest.raises(RuntimeError, match="injected node failure"):
        train_cli.run(train_cli.parser().parse_args(
            base + ck + ["--localities", "2", "--fail-at-step", "6"]))
    m = ckfmt.load_manifest(tmp_path / "ck" / "step_00000004")
    assert set(m["ownership"]) == {"0", "1"}
    resumed = train_cli.run(train_cli.parser().parse_args(
        base + ck + ["--resume"]))
    assert resumed["losses"] == straight["losses"][4:]


# -- across the two packages ---------------------------------------------------

@pytest.fixture(scope="module")
def two_locality_checkpoints(tmp_path_factory):
    """The same (params, opt) saved at two localities by each package:
    ``(root, the JAX tree, the port tree)``; the checkpoints sit in
    ``root/jax`` and ``root/port``."""
    root = tmp_path_factory.mktemp("two-locality-ckpt")
    (jtree, tree) = _jax_train_state(ARCH)
    jdg = JaxDistributedGraph(localities=2, name="jax-ckpt")
    try:
        cm = JaxManager(root / "jax", graph=jdg.graph, dgraph=jdg)
        cm.save(2, jtree, meta={"arch": ARCH})
        cm.wait()
    finally:
        jdg.shutdown()
    dg = DistributedGraph(localities=2, name="port-ckpt")
    try:
        cm = CheckpointManager(root / "port", graph=dg.graph, dgraph=dg)
        cm.save(2, tree, meta={"arch": ARCH})
        cm.wait()
    finally:
        dg.shutdown()
    return root, jtree, tree


def test_same_tree_same_owners_manifests_and_shard_bytes(
        two_locality_checkpoints):
    """Both packages split the tree into the same two owner-written
    shards: byte-identical shard files, and manifests (ownership
    included) equal apart from ``treedef`` and ``saved_at``."""
    root, _, _ = two_locality_checkpoints
    dirs = [root / w / "step_00000002" for w in ("jax", "port")]
    files = [sorted(p.name for p in d.iterdir()) for d in dirs]
    assert files[0] == files[1] == ["manifest.json", "shard_00000.bin",
                                    "shard_00001.bin"]
    for name in files[0][1:]:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()
    jm, pm = (json.loads((d / "manifest.json").read_text()) for d in dirs)
    assert jm["ownership"] == pm["ownership"] == {"0": [0], "1": [1]}
    for m in (jm, pm):
        del m["treedef"], m["saved_at"]
    assert jm == pm


def test_port_two_locality_checkpoint_restores_in_the_jax_package(
        two_locality_checkpoints):
    root, jtree, tree = two_locality_checkpoints
    step, (jparams, jopt) = JaxManager(root / "port",
                                       async_save=False).restore(jtree)
    assert step == 2
    got = jax.tree.leaves((jparams, jopt))
    want = jax.tree.leaves(jtree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_two_locality_checkpoint_restores_in_the_port(
        two_locality_checkpoints, cluster):
    """The JAX package's owner-written checkpoint, read back by the
    port's three localities."""
    root, _, tree = two_locality_checkpoints
    cm = CheckpointManager(root / "jax", graph=cluster.graph, dgraph=cluster)
    step, back = cm.restore(tree)
    assert step == 2
    (names, want), (got_names, got) = host_leaves(tree), host_leaves(back)
    assert names == got_names
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
