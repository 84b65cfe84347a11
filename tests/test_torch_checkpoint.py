"""The port's checkpoints: the reference's battery of
tests/test_checkpoint.py within the port (every case that needs no SPMD
process or second locality), and checkpoints across the two packages:
a port checkpoint restores in the JAX CheckpointManager and the other way
round, the same tree gives byte-identical shard files, and a flipped byte
the same error in both."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint.format import CheckpointCorruptError as JaxCorrupt
from repro.configs import get_config as jax_get_config
from repro.core import steps as jax_steps
from repro.data.pipeline import LMStream as JaxLMStream
from repro.frontend import Plan as JaxPlan
from repro.launch.mesh import make_local_mesh
from repro.optim.optimizers import OptConfig as JaxOptConfig
from repro_torch.bridge import (host_leaves, params_from_numpy,
                                place_leaves, tree_to_numpy)
from repro_torch.checkpoint import format as ckfmt
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.format import CheckpointCorruptError
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.core.futures import FuturizedGraph
from repro_torch.data.pipeline import to_device
from repro_torch.frontend import Plan
from repro_torch.optim.optimizers import OptConfig

BATCH, SEQ = 4, 16
ARCHS = ["qwen3-4b", "zamba2-2.7b"]


def _tree(key=0):
    g = torch.Generator().manual_seed(key)
    return {"w": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "s": torch.tensor(3.5)}}


def _named(tree):
    flat, _ = pytree.tree_flatten_with_path(tree)
    return [pytree.keystr(p) for p, _ in flat], [t for _, t in flat]


def _assert_same(a, b):
    na, la = _named(a)
    nb, lb = _named(b)
    assert na == nb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _boom():
    raise RuntimeError("boom: injected dependency failure")


# -- the reference's battery, within the port ----------------------------------

def test_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    t = _tree()
    cm.save(10, t, meta={"note": "hi"})
    step, back = cm.restore(t)
    assert step == 10
    _assert_same(t, back)
    assert cm.meta["note"] == "hi"


def test_async_save_then_restore(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=True)
    t = _tree(1)
    fut = cm.save(3, t)
    cm.wait()
    assert fut.result() == tmp_path / "step_00000003"
    step, back = cm.restore(t)
    assert step == 3
    _assert_same(t, back)
    cm.close()


def test_save_takes_owned_copies_before_it_returns(tmp_path):
    """The port's optimizer updates in place: a write that read the live
    tensors after save() returned would race the next step."""
    g = FuturizedGraph(max_workers=2, name="ckpt-owned")
    try:
        cm = CheckpointManager(tmp_path, graph=g)
        t = _tree(2)
        want = pytree.tree_map(torch.clone, t)
        gate = g.promise(name="held")
        fut = cm.save(1, t, deps=(gate,))
        for x in pytree.tree_leaves(t):       # the next "step", in place
            x.add_(1)
        gate.set_result(None)
        fut.result(timeout=30)
        _, back = cm.restore(t)
        _assert_same(want, back)
    finally:
        g.shutdown(wait=True)


def test_checksum_corruption_detected_and_names_shard(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    t = _tree(2)
    path = cm.save(1, t)
    f = next(path.glob("shard_*.bin"))
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError, match="shard_00000.bin"):
        cm.restore(t)
    # non-strict mode loads anyway
    step, _ = cm.restore(t, strict_checksums=False)
    assert step == 1


def test_gc_keeps_last_k(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_save=False)
    t = _tree(3)
    for s in (1, 2, 3, 4):
        cm.save(s, t)
    assert cm.all_steps() == [3, 4] and cm.latest_step() == 4


def test_leaf_count_mismatch_raises(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    cm.save(1, _tree(4))
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"only": torch.zeros(3)})


def test_bf16_leaf_is_refused_by_name(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(ValueError, match="leaf x/half"):
        cm.save(1, {"x": {"half": torch.ones(2, dtype=torch.bfloat16)}})


def test_multi_locality_placement_names_its_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="item 12"):
        CheckpointManager(tmp_path, dgraph=object())


def test_host_leaves_stack_list_levels_in_jax_order():
    """A list level is a leading dim of the leaves below it, nested lists
    row-major, dict keys sorted, tuples in order; ``place_leaves`` puts
    the stacked arrays back into a tree shaped like ``like``; lists whose
    items differ in structure are refused."""
    g = torch.Generator().manual_seed(3)
    layer = lambda: {"w": torch.randn(2, 3, generator=g),  # noqa: E731
                     "b": torch.randn(3, generator=g)}
    tree = ({"z": torch.tensor(1, dtype=torch.int32),
             "stack": [[layer() for _ in range(2)] for _ in range(3)]},
            torch.zeros(4))
    names, arrays = host_leaves(tree)
    assert names == ["0/stack/b", "0/stack/w", "0/z", "1"]
    assert [a.shape for a in arrays] == [(3, 2, 3), (3, 2, 2, 3), (), (4,)]
    assert arrays[2].dtype == np.int32
    np.testing.assert_array_equal(arrays[1][2, 1],
                                  tree[0]["stack"][2][1]["w"].numpy())
    _assert_same(place_leaves(tree, arrays), tree)
    with pytest.raises(ValueError, match="differ in structure"):
        host_leaves([{"a": torch.ones(1)}, {"b": torch.ones(1)}])
    with pytest.raises(ValueError, match="differ in shape or dtype"):
        host_leaves([torch.ones(1), torch.ones(2)])


def test_assign_shards_contiguous_and_balanced():
    assert ckfmt.assign_shards(5, [0, 1, 2]) == [
        (0, 0, [0, 1]), (1, 1, [2, 3]), (2, 2, [4])]
    assert ckfmt.assign_shards(2, [0, 1, 2]) == [(0, 0, [0]), (1, 1, [1])]
    assert ckfmt.assign_shards(3, [0]) == [(0, 0, [0, 1, 2])]


def test_manifest_schema_and_ownership_single_process(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    path = cm.save(2, _tree())
    m = json.loads((path / "manifest.json").read_text())
    assert m["format"] == ckfmt.FORMAT_VERSION == "phyrax-ckpt/3"
    assert m["n_shards"] == 1 and m["ownership"] == {"0": [0]}
    assert m["n_leaves"] == 3
    covered = [leaf["index"] for s in m["shards"] for leaf in s["leaves"]]
    assert covered == [0, 1, 2]
    # jax.tree.flatten's order: dict keys sorted
    assert [leaf["dtype"] for leaf in m["shards"][0]["leaves"]] == [
        "int32", "float32", "float32"]
    for s in m["shards"]:
        assert s["checksum"] == ckfmt.shard_checksum(
            leaf["checksum"] for leaf in s["leaves"])


def _write_two_shard_checkpoint(tmp_path, t, step=7):
    """Simulate an N=2 save through the format layer alone."""
    names, host = host_leaves(t)
    shards = ckfmt.assign_shards(len(host), [0, 1])
    assert len(shards) == 2
    tmp = tmp_path / f".tmp_step_{step:08d}"
    entries = [ckfmt.save_shard(str(tmp), sid, idx, [host[i] for i in idx])
               for sid, _rank, idx in shards]
    manifest = ckfmt.build_manifest(step=step, treedef=str(names),
                                    n_leaves=len(host), shards=entries)
    return ckfmt.commit_manifest(tmp, tmp_path / f"step_{step:08d}",
                                 manifest)


def test_resharded_restore_two_writer_shards_single_reader(tmp_path):
    t = _tree(5)
    _write_two_shard_checkpoint(tmp_path, t)
    step, back = CheckpointManager(tmp_path, async_save=False).restore(t)
    assert step == 7
    _assert_same(t, back)


def test_corrupt_shard_error_names_the_bad_shard(tmp_path):
    t = _tree(6)
    path = _write_two_shard_checkpoint(tmp_path, t)
    f = path / "shard_00001.bin"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    cm = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(CheckpointCorruptError, match="shard_00001.bin"):
        cm.restore(t)
    m = ckfmt.load_manifest(path)
    good = ckfmt.read_shard(str(path), m["shards"][0])
    assert set(good) == set(range(len(m["shards"][0]["leaves"])))


def test_missing_shard_file_is_corruption(tmp_path):
    t = _tree(7)
    path = _write_two_shard_checkpoint(tmp_path, t)
    (path / "shard_00000.bin").unlink()
    cm = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(CheckpointCorruptError, match="shard_00000.bin"):
        cm.restore(t)


def test_aborted_tmp_files_never_leak_into_commit(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    stale = tmp_path / ".tmp_step_00000009"
    stale.mkdir()
    (stale / "shard_00042.bin").write_bytes(b"garbage from a dead run")
    path = cm.save(9, _tree(8))
    assert sorted(p.name for p in path.iterdir()) == [
        "manifest.json", "shard_00000.bin"]


def test_dead_writer_wip_file_pruned_at_commit(tmp_path):
    names, host = host_leaves(_tree(9))
    tmp = tmp_path / ".tmp_step_00000004"
    entry = ckfmt.save_shard(str(tmp), 0, range(len(host)), host)
    (tmp / "shard_00000.bin.wip-99999").write_bytes(b"dead writer")
    final = ckfmt.commit_manifest(
        tmp, tmp_path / "step_00000004",
        ckfmt.build_manifest(step=4, treedef=str(names),
                             n_leaves=len(host), shards=[entry]))
    assert sorted(p.name for p in final.iterdir()) == [
        "manifest.json", "shard_00000.bin"]


def test_sliced_two_host_checkpoint_restores_via_manager(tmp_path):
    """A checkpoint laid out as two SPMD hosts write it (each leaf split
    row-wise across two shard files) restores through the port's
    manager."""
    t = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
         "b": torch.arange(6, dtype=torch.int32)}
    names, leaves = host_leaves(t)
    tmp = tmp_path / ".tmp_step_00000009"
    entries = []
    for host in (0, 1):
        idx, sls, arrs = [], [], []
        for i, leaf in enumerate(leaves):
            n = leaf.shape[0] // 2
            lo, hi = host * n, (host + 1) * n
            idx.append(i)
            sls.append(([(lo, hi)] + [(0, d) for d in leaf.shape[1:]],
                        list(leaf.shape)))
            arrs.append(leaf[lo:hi])
        entries.append(ckfmt.save_shard(str(tmp), host, idx, arrs,
                                        slices=sls))
    ckfmt.commit_manifest(
        tmp, tmp_path / "step_00000009",
        ckfmt.build_manifest(step=9, treedef=str(names),
                             n_leaves=len(leaves), shards=entries))
    step, back = CheckpointManager(tmp_path, async_save=False).restore(t)
    assert step == 9
    _assert_same(t, back)


def test_truncated_shard_file_mid_leaf_names_shard_and_leaf(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    t = _tree(10)
    path = cm.save(3, t)
    f = next(path.glob("shard_*.bin"))
    m = json.loads((path / "manifest.json").read_text())
    last = m["shards"][0]["leaves"][-1]
    os.truncate(f, last["offset"] + last["nbytes"] // 2)
    with pytest.raises(CheckpointCorruptError,
                       match=rf"truncated at leaf {last['index']}"):
        cm.restore(t)


def test_corrupted_manifest_json_is_corruption_not_a_crash(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    path = cm.save(2, _tree(11))
    (path / "manifest.json").write_text('{"format": "phyrax-ckpt/3", ')
    with pytest.raises(CheckpointCorruptError, match="does not parse"):
        cm.restore(_tree(11))


def test_unknown_format_version_refused(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    path = cm.save(2, _tree(12))
    m = json.loads((path / "manifest.json").read_text())
    m["format"] = "phyrax-ckpt/99"
    (path / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(CheckpointCorruptError, match="phyrax-ckpt/99"):
        cm.restore(_tree(12))


def test_unreferenced_stale_shard_pruned_at_commit(tmp_path):
    names, host = host_leaves(_tree(13))
    tmp = tmp_path / ".tmp_step_00000006"
    entry = ckfmt.save_shard(str(tmp), 0, range(len(host)), host)
    (tmp / "shard_00007.bin").write_bytes(b"stale shard, bigger world")
    (tmp / "shard_00000.bin.wip-12345").write_bytes(b"dead writer")
    final = ckfmt.commit_manifest(
        tmp, tmp_path / "step_00000006",
        ckfmt.build_manifest(step=6, treedef=str(names),
                             n_leaves=len(host), shards=[entry]))
    assert sorted(p.name for p in final.iterdir()) == [
        "manifest.json", "shard_00000.bin"]


def test_failed_save_commits_nothing(tmp_path):
    g = FuturizedGraph(max_workers=2, name="ckpt-atomic")
    try:
        cm = CheckpointManager(tmp_path, graph=g)
        poison = g.defer(_boom, name="retire")
        fut = cm.save(5, _tree(), deps=(poison,))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
        assert not (tmp_path / "step_00000005").exists()
        assert cm.latest_step() is None
        # fail fast: the next save raises the failed one's error
        with pytest.raises(RuntimeError, match="boom"):
            cm.save(6, _tree())
    finally:
        g.shutdown(wait=True)


# -- across the two packages --------------------------------------------------

def _jax_train_state(arch, n_steps=2):
    """The JAX package's (params, opt) after ``n_steps`` adamw steps of
    tiny ``arch``, and the same state as a port tree."""
    jcfg = jax_get_config(arch, tiny=True)
    jstep = jax_steps.make_train_step(
        jcfg, make_local_mesh(), jax_steps.Strategy(),
        {"seq_len": SEQ, "global_batch": BATCH, "kind": "train"})
    jparams, jopt = jstep.init(jax.random.PRNGKey(0))
    stream = JaxLMStream(vocab=jcfg.vocab, batch=BATCH, seq=SEQ, seed=1)
    for it in range(n_steps):
        _, jparams, jopt = jstep.fn(jparams, jopt, jax.tree.map(
            jnp.asarray, stream.batch_at(it)))
    cfg = get_config(arch, tiny=True)
    to_port = lambda t: params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, t), cfg, "cpu")
    opt = {"count": torch.tensor(int(jopt["count"]), dtype=torch.int32),
           "m": to_port(jopt["m"]), "v": to_port(jopt["v"])}
    return (jparams, jopt), (to_port(jparams), opt)


def _port_train_state(arch, n_steps=2):
    cfg = get_config(arch, tiny=True)
    step = steps.make_train_step(cfg, steps.Strategy())
    params, opt = step.init(torch.Generator().manual_seed(0), "cpu")
    stream = JaxLMStream(vocab=cfg.vocab, batch=BATCH, seq=SEQ, seed=1)
    for it in range(n_steps):
        _, params, opt = step.fn(params, opt,
                                 to_device(stream.batch_at(it), "cpu"))
    return params, opt


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_jax_package(tmp_path, arch):
    """(params, opt) saved by the port restores in the JAX
    CheckpointManager, leaf for leaf equal to the port's tree in the JAX
    layout, int32 count included; the leaf count is the reference's."""
    params, opt = _port_train_state(arch)
    cm = CheckpointManager(tmp_path, async_save=False)
    cm.save(2, (params, opt), meta={"arch": arch})
    (jlike, _) = _jax_train_state(arch, n_steps=0)
    step, (jparams, jopt) = JaxManager(tmp_path, async_save=False).restore(
        jlike)
    assert step == 2
    assert int(jopt["count"]) == 2 and jopt["count"].dtype == jnp.int32
    want = tree_to_numpy({"params": params, "m": opt["m"], "v": opt["v"]})
    got = {"params": jparams, "m": jopt["m"], "v": jopt["v"]}
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) + 1 == ckfmt.load_manifest(
        tmp_path / "step_00000002")["n_leaves"]
    for path, leaf in flat:
        mine = want
        for k in path:
            mine = mine[k.key]
        assert leaf.dtype == jnp.float32, path
        np.testing.assert_array_equal(np.asarray(leaf), mine,
                                      err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_same_tree_same_shard_bytes_and_manifest(tmp_path, arch):
    """The same (params, opt) saved by each package: byte-identical shard
    files, and manifests equal apart from ``treedef`` and ``saved_at``."""
    (jparams, jopt), (params, opt) = _jax_train_state(arch)
    JaxManager(tmp_path / "jax", async_save=False).save(
        2, (jparams, jopt), meta={"arch": arch})
    CheckpointManager(tmp_path / "port", async_save=False).save(
        2, (params, opt), meta={"arch": arch})
    dirs = [tmp_path / w / "step_00000002" for w in ("jax", "port")]
    files = [sorted(p.name for p in d.iterdir()) for d in dirs]
    assert files[0] == files[1] == ["manifest.json", "shard_00000.bin"]
    assert (dirs[0] / "shard_00000.bin").read_bytes() == \
        (dirs[1] / "shard_00000.bin").read_bytes()
    jm, pm = (json.loads((d / "manifest.json").read_text()) for d in dirs)
    for m in (jm, pm):
        del m["treedef"], m["saved_at"]
    assert jm == pm


@pytest.mark.parametrize("arch", ARCHS)
def test_flipped_byte_gives_the_same_error_in_both(tmp_path, arch):
    (jparams, jopt), (params, opt) = _jax_train_state(arch)
    JaxManager(tmp_path / "jax", async_save=False).save(2, (jparams, jopt))
    CheckpointManager(tmp_path / "port", async_save=False).save(
        2, (params, opt))
    msgs = []
    for who, mgr, like, exc in (
            ("jax", JaxManager, (jparams, jopt), JaxCorrupt),
            ("port", CheckpointManager, (params, opt),
             CheckpointCorruptError)):
        f = tmp_path / who / "step_00000002" / "shard_00000.bin"
        raw = bytearray(f.read_bytes())
        raw[len(raw) // 2] ^= 0x01
        f.write_bytes(bytes(raw))
        with pytest.raises(exc) as e:
            mgr(tmp_path / who, async_save=False).restore(like)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "shard_00000.bin" in msgs[0]
    assert "leaf" in msgs[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_training_checkpoint_resumes_in_the_port(tmp_path, arch):
    """The JAX package's Session.train saves at step 4 of 8; the port's
    Session.train resumes from that checkpoint, and its losses at steps
    5-8 agree with the JAX run's (the train trajectory's 1e-4; zamba with
    momentum, whose step is proportional to the gradient)."""
    kind = "momentum" if arch == "zamba2-2.7b" else "adamw"
    rtol = 5e-4 if arch == "zamba2-2.7b" else 1e-4
    jstrat = jax_steps.Strategy(opt=JaxOptConfig(kind=kind))
    kw = dict(arch=arch, tiny=True, batch=BATCH, seq=SEQ)
    with JaxPlan(**kw, strategy=jstrat).compile() as jsession:
        jout = jsession.train(steps=8, ckpt_dir=str(tmp_path / "jax"),
                              ckpt_every=4, log_every=1, verbose=False)
    src = tmp_path / "jax" / "step_00000004"
    shutil.copytree(src, tmp_path / "port" / src.name)
    strat = steps.Strategy(opt=OptConfig(kind=kind))
    with Plan(**kw, strategy=strat, device="cpu").compile() as session:
        out = session.train(steps=8, ckpt_dir=str(tmp_path / "port"),
                            ckpt_every=4, log_every=1, resume=True,
                            verbose=False)
    assert out["step"] == 8 and len(out["losses"]) == 4
    np.testing.assert_allclose(out["losses"], jout["losses"][4:], rtol=rtol)
