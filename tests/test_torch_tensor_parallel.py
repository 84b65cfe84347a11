"""The model axis (tensor parallelism of the dense family) against the
JAX package on the same mesh.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``'s
``tensor_parallel`` job) and one JAX subprocess with 4 host devices, both
module-scoped and run at once; both start tiny qwen3-4b from the
reference's init (``PRNGKey(0)``, carried by ``bridge``):

* the rank layout of ``make_local_mesh(data=2, model=2)`` is JAX's
  ``mesh.devices`` (row-major, ``model`` fastest);
* every parameter leaf's local shape, and every KV-cache leaf's under
  ``decode_rules`` (heads split, or the sequence at ``model=4`` where the
  2 kv heads do not divide), is the JAX ``shard_shape`` (tiny qwen3-4b
  and qwen2.5-3b, ``model`` 2 and 4; no world needed);
* the loss and every leaf's gradient, gathered, at ``model`` 2 and 4
  (where the kv heads stay replicated and each rank picks its own)
  within 1e-5 of the reference's largest |gradient|, the one-process
  tolerance of ``tests/test_torch_train.py``;
* 4 phylanx, horovod and zero1 steps at ``data=2, model=2`` and
  ``data=1, model=4``: losses and gradient norms within 1e-5 relative of
  the reference's ``make_train_step`` on the same mesh, and every leaf
  that no rule splits bit-identical on every rank after every step;
* the vocab-parallel cross entropy, its gradient and the global argmax
  (a tie across two shards goes to the lower index) against their plain
  versions;
* a ``data=2, model=2`` zero1 checkpoint is the reference's global
  layout: restored at ``model=1`` in the port and in the JAX package,
  leaf for leaf bit-identical to what the mesh held; and a ``model=1``
  checkpoint restored on the mesh gives each rank its own blocks and
  gathers back bit for bit, as the JAX package restores it on its mesh.
"""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.models.model import build_model as build_jax_model
from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.core.sharding import local_specs
from repro_torch.launch.mesh import Mesh
from torch_mesh_world import run_world, seeded
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARCH, LR, BATCH, SEQ, STEPS = "qwen3-4b", 1e-3, 8, 16, 4
NAMES = ("phylanx", "horovod", "zero1")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
CASES = [f"{n}@{m}" for m in MESHES for n in NAMES]
RTOL, GRAD_TOL = 1e-5, 1e-5
SHAPE_ARCHS = ("qwen3-4b", "qwen2.5-3b")
CACHE = {"seq_len": 24, "global_batch": 2}

_REF = textwrap.dedent("""
    import json, os, sys, time
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.core import steps as S
    from repro.core.sharding import (default_rules, init_params,
                                     param_shardings, set_act_hook)
    from repro.data.pipeline import LMStream
    from repro.launch.mesh import make_local_mesh
    from repro.models.model import build_model
    from repro.optim.optimizers import OptConfig
    spec = json.loads(sys.stdin.read())
    out = {}
    m = make_local_mesh(data=2, model=2)
    out["devices"] = np.vectorize(lambda d: d.id)(m.devices).tolist()
    meshes = {"2x2": m, "1x4": make_local_mesh(model=4)}
    # local shapes of every parameter and cache leaf
    out["shapes"] = {}
    for arch in spec["shape_archs"]:
        cfg = get_config(arch, tiny=True)
        for M in (2, 4):
            mesh = make_local_mesh(model=M)
            specs = build_model(cfg).specs()
            sh = param_shardings(specs, mesh, default_rules())
            leaves = jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "dims"))
            params = [list(s.shard_shape(p.shape)) for s, p in
                      zip(jax.tree.leaves(sh), leaves)]
            dec = S.make_decode_step(cfg, mesh, S.Strategy(),
                                     dict(spec["cache"], kind="decode"))
            cl = jax.tree.leaves(dec.cache_specs,
                                 is_leaf=lambda x: hasattr(x, "dims"))
            cache = [list(s.shard_shape(p.shape)) for s, p in
                     zip(jax.tree.leaves(dec.cache_shardings), cl)]
            out["shapes"][f"{arch}@{M}"] = {"params": params, "cache": cache}
    cfg = get_config(spec["arch"], tiny=True)
    model = build_model(cfg)
    specs = model.specs()
    batch = {k: jnp.asarray(np.asarray(v, np.int32))
             for k, v in spec["batch"].items()}
    out["grads"] = {}
    for M in (2, 4):
        mesh = make_local_mesh(model=M)
        rules = default_rules()
        sh = param_shardings(specs, mesh, rules)
        params = jax.device_put(init_params(specs, jax.random.PRNGKey(0)), sh)
        set_act_hook(mesh, rules)
        loss, g = jax.jit(jax.value_and_grad(model.loss),
                          in_shardings=(sh, None))(params, batch)
        set_act_hook(None, None)
        path = os.path.join(spec["tmp"], f"grads{M}.npz")
        np.savez(path, *[np.asarray(x) for x in jax.tree.leaves(g)])
        out["grads"][M] = {"loss": float(loss), "path": path}
    shape = {"seq_len": spec["seq"], "global_batch": spec["batch_size"],
             "kind": "train"}
    for key in spec["cases"]:
        name, mk = key.split("@")
        step = S.make_train_step(cfg, meshes[mk], S.Strategy(
            name=name, opt=OptConfig(lr=spec["lr"])), shape)
        params, opt = step.init(jax.random.PRNGKey(0))
        stream = LMStream(vocab=cfg.vocab, batch=spec["batch_size"],
                          seq=spec["seq"], seed=0)
        ls, gs = [], []
        for it in range(spec["steps"]):
            b = {k: jax.device_put(v, step.batch_shardings[k])
                 for k, v in stream.batch_at(it).items()}
            mt, params, opt = step.fn(params, opt, b)
            ls.append(float(mt["loss"]))
            gs.append(float(mt["grad_norm"]))
        out[key] = {"loss": ls, "grad_norm": gs}
    # the checkpoints: the mesh's (model=1 layout) and a model=1 one
    # restored on the 2x2 mesh
    deadline = time.time() + 400
    while not os.path.exists(spec["ready"]) and time.time() < deadline:
        time.sleep(0.2)
    def digest(a):
        import hashlib
        a = np.ascontiguousarray(np.asarray(a))
        return hashlib.blake2b(a.tobytes(), digest_size=8).hexdigest()
    step = S.make_train_step(cfg, meshes["2x2"], S.Strategy(name="zero1"),
                             shape)
    params, opt = step.init(jax.random.PRNGKey(0))
    like = (params, {"count": opt["count"], "m": params, "v": params})
    _, got = CheckpointManager(spec["dir_a"]).restore(like)
    out["restore_a"] = [digest(x) for x in jax.tree.leaves(got)]
    _, got = CheckpointManager(spec["dir_b"]).restore(
        (params, opt), shardings=(step.param_shardings, step.opt_shardings))
    out["restore_b"] = [digest(x) for x in jax.tree.leaves(got)]
    print(json.dumps(out))
""")


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    return hashlib.blake2b(a.tobytes(), digest_size=8).hexdigest()


def _reference(spec) -> dict:
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _REF], input=json.dumps(spec),
                       env=env, text=True, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _model1_checkpoint(directory, params) -> tuple:
    """A model=1 zero1 checkpoint of the reference's params and seeded
    moments (the reference's global layout), and its leaves' digests."""
    cfg = get_config(ARCH, tiny=True)
    p = bridge.params_from_numpy(params, cfg, "cpu")
    i = iter(range(100, 10_000))

    def seeded_like(t):
        return torch.from_numpy(seeded(tuple(t.shape), next(i)))
    opt = {"count": torch.tensor(2, dtype=torch.int32),
           "m": pytree.tree_map(seeded_like, p),
           "v": pytree.tree_map(lambda t: seeded_like(t).abs(), p)}
    with CheckpointManager(directory, async_save=False) as cm:
        cm.save(1, (p, opt))
    names, arrays = bridge.host_leaves((p, opt))
    return names, [_digest(a) for a in arrays], p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jcfg = jax_get_config(ARCH, tiny=True)
    params = jax.tree.map(np.asarray, jax_init_params(
        build_jax_model(jcfg).specs(), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, jcfg.vocab, (BATCH, SEQ))
             for k in ("tokens", "labels")}
    dir_a, dir_b, ready = tmp / "a", tmp / "b", tmp / "ready"
    names_b, digests_b, params_b = _model1_checkpoint(dir_b, params)
    spec = {"arch": ARCH, "lr": LR, "batch_size": BATCH, "seq": SEQ,
            "steps": STEPS, "cases": CASES, "tmp": str(tmp),
            "batch": {k: v.tolist() for k, v in batch.items()},
            "shape_archs": SHAPE_ARCHS, "cache": CACHE,
            "dir_a": str(dir_a), "dir_b": str(dir_b), "ready": str(ready)}
    ref: dict = {}
    t = threading.Thread(target=lambda: ref.update(_reference(spec)))
    t.start()
    try:
        cases = [{"key": k, "name": k.split("@")[0],
                  "mesh": MESHES[k.split("@")[1]], "lr": LR, "batch": BATCH,
                  "seq": SEQ, "steps": STEPS} for k in CASES]
        ranks = run_world("tensor_parallel", 4, {
            "arch": ARCH, "params": params, "batch": batch, "cases": cases,
            "dir_a": str(dir_a), "dir_b": str(dir_b)})
    finally:
        ready.write_text("1")
        t.join()
    return {"ref": ref, "ranks": ranks, "params": params, "dir_a": dir_a,
            "names_b": names_b, "digests_b": digests_b,
            "params_b": bridge.tree_to_numpy(params_b)}


def test_rank_layout_is_jax_mesh_devices(runs):
    """World rank ``dp * M + c`` sits where JAX puts device ``dp * M + c``
    in ``make_local_mesh(data=2, model=2)``: its dp group is its column,
    its model group its row."""
    devices = runs["ref"]["devices"]
    for r, out in enumerate(runs["ranks"]):
        lay = out["layout"]
        d, c = lay["coords"]["data"], lay["coords"]["model"]
        assert devices[d][c] == r
        assert list(lay["model_ranks"]) == devices[d]
        assert list(lay["ranks"]) == [row[c] for row in devices]


def _shapes(specs) -> list:
    tree = pytree.tree_map(lambda s: torch.empty(s.shape), specs,
                           is_leaf=lambda x: hasattr(x, "dims"))
    return [list(a.shape) for a in bridge.host_leaves(tree)[1]]


@pytest.mark.parametrize("arch", SHAPE_ARCHS)
@pytest.mark.parametrize("model", [2, 4])
def test_local_shapes_are_the_reference_tiling(runs, arch, model):
    """Every parameter leaf's block and every cache leaf's block under
    ``decode_rules`` has the JAX ``shard_shape``; at ``model=4`` the 2 kv
    heads stay whole and the cache's sequence is split instead."""
    want = runs["ref"]["shapes"][f"{arch}@{model}"]
    cfg = get_config(arch, tiny=True)
    mesh = Mesh(shape={"data": 1, "model": model},
                coords={"data": 0, "model": model - 1})
    step = steps.make_train_step(cfg, steps.Strategy(), mesh=mesh)
    assert _shapes(local_specs(step.specs, mesh, step.rules)) == \
        want["params"]
    dec = steps.make_decode_step(cfg, CACHE, mesh=mesh)
    got = _shapes(dec.cache_specs)
    assert got == want["cache"]
    kv_split = cfg.n_kv_heads % model == 0
    assert got[0][2:4] == ([CACHE["seq_len"], cfg.n_kv_heads // model]
                           if kv_split else
                           [CACHE["seq_len"] // model, cfg.n_kv_heads])


@pytest.mark.parametrize("model", [2, 4])
def test_loss_and_every_gradient_match_jax(runs, model):
    ref = runs["ref"]["grads"][str(model)]
    got = runs["ranks"][0]["grads"][model]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    with np.load(ref["path"]) as z:
        want = [z[f"arr_{i}"] for i in range(len(z.files))]
    leaves = [np.asarray(x) for x in jax.tree.leaves(got["grads"])]
    assert [x.shape for x in leaves] == [x.shape for x in want]
    scale = max(np.abs(x).max() for x in want)
    for i, (g, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=f"leaf {i}")
    # every rank of the model group gathers the same gradients
    for r in range(1, model):
        other = runs["ranks"][r]["grads"][model]
        assert other["loss"] == got["loss"]
        for a, b in zip(jax.tree.leaves(other["grads"]),
                        jax.tree.leaves(got["grads"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_strategy_matches_reference_on_the_mesh(runs, case):
    want = runs["ref"][case]
    got = runs["ranks"][0]["cases"][case]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   err_msg=f"{case} {k}")
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["loss"] == got["loss"]
        assert r["cases"][case]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_are_bit_identical_on_every_rank(runs, case):
    """The leaves no rule splits (norms, qk-norms; at model=4 also the
    kv projections) hold the same bits on all 4 ranks after every step:
    a gradient summed twice, or not at all, over a model group shows
    here."""
    base = runs["ranks"][0]["cases"][case]["replicated"]
    assert len(base) == STEPS and len(base[0]) >= 2 * 2 + 1
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["replicated"] == base


def test_vocab_parallel_xent_and_argmax_match_their_plain_versions(runs):
    for r, out in enumerate(runs["ranks"]):
        v = out["vocab"]
        np.testing.assert_allclose(v["loss"], v["want"], rtol=1e-6)
        np.testing.assert_allclose(v["grad"], v["want_grad"], atol=1e-7)
        np.testing.assert_array_equal(v["tok"], v["want_tok"])
        assert v["tok"][0, 0] == 3           # the tie: the lower index
        assert v["gathered"]


def test_mesh_checkpoint_restores_at_model1_in_both_packages(runs):
    """The data=2, model=2 zero1 checkpoint holds the reference's global
    leaves: the port's model=1 restore and the JAX package's give the
    bits the mesh gathered, leaf for leaf."""
    saved = runs["ranks"][0]["ckpt"]["saved"]
    for r in runs["ranks"]:
        assert r["ckpt"]["saved"] == saved
        assert r["ckpt"]["host_gathers"]
    cfg = get_config(ARCH, tiny=True)
    step = steps.make_train_step(cfg, steps.Strategy(name="zero1"))
    with CheckpointManager(runs["dir_a"], async_save=False) as cm:
        at, back = cm.restore((step.params_like(), step.global_like()))
    assert at == 2
    names, arrays = bridge.host_leaves(back)
    assert names == list(saved)
    assert [_digest(a) for a in arrays] == list(saved.values())
    assert runs["ref"]["restore_a"] == list(saved.values())


def test_model1_checkpoint_restores_on_the_mesh(runs):
    """A model=1 checkpoint cut on the data=2, model=2 mesh: each rank
    holds its blocks (wq by heads, the embedding by vocab rows, w_down by
    d_ff rows), and the mesh gathers back the checkpoint's bits, as the
    JAX package restores it on its own mesh."""
    want = runs["params_b"]
    for out in runs["ranks"]:
        ck = out["ckpt"]
        assert list(ck["round_trip"].values()) == runs["digests_b"]
        c, blocks = ck["coords"]["model"], ck["blocks"]
        wq = want["stack"]["attn"]["wq"]
        h = wq.shape[2] // 2
        np.testing.assert_array_equal(blocks["stack"]["attn"]["wq"],
                                      wq[:, :, c * h:(c + 1) * h])
        tok = want["embed"]["tok"]
        v = tok.shape[0] // 2
        np.testing.assert_array_equal(blocks["embed"]["tok"],
                                      tok[c * v:(c + 1) * v])
        wd = want["stack"]["mlp"]["w_down"]
        f = wd.shape[1] // 2
        np.testing.assert_array_equal(blocks["stack"]["mlp"]["w_down"],
                                      wd[:, c * f:(c + 1) * f])
        np.testing.assert_array_equal(blocks["ln_f"]["w"],
                                      want["ln_f"]["w"])
    assert runs["ref"]["restore_b"] == runs["digests_b"]
