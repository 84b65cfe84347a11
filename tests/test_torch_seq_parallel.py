"""Sequence parallelism for the dense family, and ``TiledArray`` over
rank processes, against the JAX package on the same mesh.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``'s
``seq_parallel`` job) and two JAX subprocesses with 4 host devices (one
a mesh), all module-scoped and run at once; both start tiny qwen3-4b from the
reference's init (``PRNGKey(0)``, carried by ``bridge``):

* with ``Strategy(sequence_parallel=True)`` at ``data=2, model=2`` and
  ``data=1, model=4`` (where the 2 kv heads stay whole): the loss and
  every leaf's gradient of the global batch, gathered, within 1e-5 of the
  reference's largest |gradient| (the reference: ``jax.value_and_grad``
  of the loss under ``default_rules(sequence_parallel=True)``); and, at
  ``model=4``, against the port without sequence parallelism;
* 4 phylanx, horovod and zero1 steps on both meshes: losses and gradient
  norms within 1e-5 relative of the reference's ``make_train_step`` with
  sequence parallelism, and every leaf that no rule splits bit-identical
  on every rank after every step;
* a sequence that ``model`` does not divide takes the path without
  sequence parallelism (bit for bit), and a ``d_ff`` that does not
  divide runs its MLP whole on every rank, equal to the plain path;
* ``all_gather_seq`` and ``reduce_scatter_seq`` against their
  one-process plain versions, forward and backward;
* ``TiledArray`` on the ``data=2, model=2`` world: each rank's tile,
  ``spec``, ``tile_shape`` and its ``seq`` halo are the JAX
  ``TiledArray``'s on device ``rank``, under ``default_rules()`` and
  ``default_rules(sequence_parallel=True)``; ``retile`` and
  ``replicated`` give the tiles and the array bit for bit.

In-process: ``residual_seq``'s rule, the world-1 fabric DDP plan and
``Session.serve`` with sequence parallelism equal to the same plans
without it, and ``launch.train --model 2 --seq-parallel``.
"""
import dataclasses
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

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.models.model import build_model as build_jax_model
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.core.sharding import default_rules
from repro_torch.frontend import Plan
from repro_torch.launch import train as train_cli
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
ODD_SEQ, ODD_DFF, SHORT = 18, 250, 2
TILED_SHAPE = (4, 8, 6)

_REF = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.core import steps as S
    from repro.core.dist_array import TiledArray
    from repro.core.sharding import (default_rules, init_params,
                                     param_shardings, set_act_hook)
    from repro.data.pipeline import LMStream
    from repro.launch.mesh import make_local_mesh
    from repro.models.model import build_model
    from repro.optim.optimizers import OptConfig
    spec = json.loads(sys.stdin.read())
    out = {}
    meshes = {"2x2": make_local_mesh(data=2, model=2),
              "1x4": make_local_mesh(model=4)}
    meshes = {k: meshes[k] for k in spec["meshes"]}
    rules = default_rules(sequence_parallel=True)
    cfg = get_config(spec["arch"], tiny=True)
    model = build_model(cfg)
    specs = model.specs()
    batch = {k: jnp.asarray(np.asarray(v, np.int32))
             for k, v in spec["batch"].items()}
    out["grads"] = {}
    for key, mesh in meshes.items():
        sh = param_shardings(specs, mesh, rules)
        params = jax.device_put(init_params(specs, jax.random.PRNGKey(0)), sh)
        set_act_hook(mesh, rules)
        loss, g = jax.jit(jax.value_and_grad(model.loss),
                          in_shardings=(sh, None))(params, batch)
        set_act_hook(None, None)
        path = os.path.join(spec["tmp"], f"grads_{key}.npz")
        np.savez(path, *[np.asarray(x) for x in jax.tree.leaves(g)])
        out["grads"][key] = {"loss": float(loss), "path": path}
    shape = {"seq_len": spec["seq"], "global_batch": spec["batch_size"],
             "kind": "train"}
    for key in spec["cases"]:
        name, mk = key.split("@")
        if mk not in meshes:
            continue
        step = S.make_train_step(cfg, meshes[mk], S.Strategy(
            name=name, sequence_parallel=True,
            opt=OptConfig(lr=spec["lr"])), shape)
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
    x = jnp.asarray(np.asarray(spec["tiled"], np.float32))
    out["tiled"] = {}
    for key, r in (("default", default_rules()), ("sp", rules)):
        if "2x2" not in meshes:
            break
        t = TiledArray.tile(x, ("batch", "seq", "embed"), meshes["2x2"], r)
        h = t.with_halo("seq", 1)
        out["tiled"][key] = {
            "spec": [list(p) if isinstance(p, tuple) else p for p in t.spec],
            "tile_shape": list(t.tile_shape()),
            "global_shape": list(t.global_shape),
            "data": {s.device.id: np.asarray(s.data).tolist()
                     for s in t.data.addressable_shards},
            "halo": {s.device.id: np.asarray(s.data).tolist()
                     for s in h.addressable_shards}}
    print(json.dumps(out))
""")


def _reference(spec) -> dict:
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _REF], input=json.dumps(spec),
                       env=env, text=True, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _jax_params(cfg):
    return jax.tree.map(np.asarray, jax_init_params(
        build_jax_model(cfg).specs(), jax.random.PRNGKey(0)))


def _case(key, name, mesh, sp, **kw) -> dict:
    return dict({"key": key, "name": name, "mesh": mesh, "sp": sp, "lr": LR,
                 "batch": BATCH, "seq": SEQ, "steps": STEPS}, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    jcfg = jax_get_config(ARCH, tiny=True)
    params = _jax_params(jcfg)
    odd = _jax_params(dataclasses.replace(jcfg, d_ff=ODD_DFF))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, jcfg.vocab, (BATCH, SEQ))
             for k in ("tokens", "labels")}
    tiled = seeded(TILED_SHAPE, 21)
    spec = {"arch": ARCH, "lr": LR, "batch_size": BATCH, "seq": SEQ,
            "steps": STEPS, "cases": CASES, "tmp": str(tmp),
            "batch": {k: v.tolist() for k, v in batch.items()},
            "tiled": tiled.tolist()}
    ref: dict = {"grads": {}}

    def reference(meshes):
        got = _reference(dict(spec, meshes=meshes))
        ref["grads"].update(got.pop("grads"))
        ref.update({k: v for k, v in got.items() if k != "tiled" or v})
    threads = [threading.Thread(target=reference, args=([m],))
               for m in MESHES]
    for t in threads:
        t.start()
    try:
        cases = [_case(k, k.split("@")[0], MESHES[k.split("@")[1]], True)
                 for k in CASES]
        for sp in (True, False):
            cases.append(_case(f"odd seq {sp}", "phylanx", (1, 4), sp,
                               seq=ODD_SEQ, steps=SHORT))
            cases.append(_case(f"odd d_ff {sp}", "phylanx", (1, 4), sp,
                               d_ff=ODD_DFF, params=odd, steps=SHORT))
        ranks = run_world("seq_parallel", 4, {
            "arch": ARCH, "params": params, "batch": batch, "cases": cases,
            "tiled": tiled})
    finally:
        for t in threads:
            t.join()
    return {"ref": ref, "ranks": ranks}


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_loss_and_every_gradient_match_jax(runs, mesh):
    """Every leaf, the norms and ``b_down``-free MLP included: a norm's
    gradient not summed over the model group (each rank saw only its
    rows) shows here, while the loss would still match."""
    ref = runs["ref"]["grads"][mesh]
    got = runs["ranks"][0]["grads"][mesh]
    assert got["seq"] == SEQ
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)
    with np.load(ref["path"]) as z:
        want = [z[f"arr_{i}"] for i in range(len(z.files))]
    leaves = _leaves(got["grads"])
    assert [x.shape for x in leaves] == [x.shape for x in want]
    scale = max(np.abs(x).max() for x in want)
    for i, (g, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=f"leaf {i}")
    for r in runs["ranks"][1:]:
        other = r["grads"][mesh]
        assert other["loss"] == got["loss"]
        for a, b in zip(_leaves(other["grads"]), leaves):
            np.testing.assert_array_equal(a, b)


def test_sequence_parallel_gradients_equal_the_plain_path(runs):
    got = runs["ranks"][0]["grads"]
    sp, plain = got["1x4"], got["1x4 plain"]
    assert plain["seq"] is None
    np.testing.assert_allclose(sp["loss"], plain["loss"], rtol=RTOL)
    want = _leaves(plain["grads"])
    scale = max(np.abs(x).max() for x in want)
    for g, w in zip(_leaves(sp["grads"]), want):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0)


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
    """Under sequence parallelism the norms' gradients are summed over
    the model group: one summed twice, or not at all, differs here."""
    base = runs["ranks"][0]["cases"][case]["replicated"]
    assert len(base) == STEPS and len(base[0]) >= 2 * 2 + 1
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["replicated"] == base


def test_indivisible_sequence_takes_the_plain_path(runs):
    """18 positions over 4 ranks: the residual stays whole (the
    reference's ``spec_for`` fallback), so the steps are the plain path's
    bit for bit."""
    got = runs["ranks"][0]["cases"]
    assert got["odd seq True"]["loss"] == got["odd seq False"]["loss"]
    assert got["odd seq True"]["grad_norm"] == \
        got["odd seq False"]["grad_norm"]


def test_indivisible_d_ff_runs_its_mlp_whole_under_sequence_parallelism(
        runs):
    """d_ff 250 over 4 ranks stays whole: every rank computes the MLP of
    the gathered sequence and keeps its rows; its leaves' gradients are
    then parts, summed over the model group."""
    got = runs["ranks"][0]["cases"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["odd d_ff True"][k],
                                   got["odd d_ff False"][k], rtol=RTOL)
    for r in runs["ranks"][1:]:
        assert r["cases"]["odd d_ff True"]["replicated"] == \
            got["odd d_ff True"]["replicated"]


@pytest.mark.parametrize("model", [2, 4])
def test_sequence_parallel_pairs_match_their_plain_versions(runs, model):
    ranks = runs["ranks"] if model == 4 else runs["ranks"][:2]
    for out in ranks:
        p = out["pairs"][model]
        for k in ("gather", "gather_grad", "scatter", "scatter_grad"):
            np.testing.assert_allclose(p[k], p[f"{k}_want"], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("rules", ["default", "sp"])
def test_tiled_array_tiles_as_jax_on_the_mesh(runs, rules):
    """World rank r is device r of ``make_local_mesh(data=2, model=2)``:
    its tile, spec and shapes are the JAX ``TiledArray``'s there, and so
    is its ``seq`` halo (exchanged over the model group under sequence
    parallelism, the tile itself where ``seq`` is whole)."""
    want = runs["ref"]["tiled"][rules]
    for r, out in enumerate(runs["ranks"]):
        got = out["tiled"][rules]
        assert got["spec"] == want["spec"]
        assert got["tile_shape"] == want["tile_shape"]
        assert got["global_shape"] == want["global_shape"] == \
            list(TILED_SHAPE)
        np.testing.assert_array_equal(got["data"],
                                      np.asarray(want["data"][str(r)]))
        np.testing.assert_array_equal(got["halo"],
                                      np.asarray(want["halo"][str(r)]))
    assert runs["ref"]["tiled"]["sp"]["tile_shape"] == [2, 4, 6]


def test_tiled_array_retiles_and_replicates_bit_for_bit(runs):
    for out in runs["ranks"]:
        assert out["tiled"]["retile"]
        assert out["tiled"]["replicated"]


# -- in-process -----------------------------------------------------------------
def test_residual_splits_only_where_sequence_and_vocab_divide():
    cfg = get_config(ARCH, tiny=True)
    mesh = Mesh(shape={"data": 1, "model": 4},
                coords={"data": 0, "model": 1})
    sp = default_rules(sequence_parallel=True)
    toks = lambda s: {"tokens": torch.zeros(2, s, dtype=torch.long)}  # noqa: E731
    assert steps.residual_seq(cfg, mesh, sp, toks(16)) == 16
    assert steps.residual_seq(cfg, mesh, sp, toks(ODD_SEQ)) is None
    assert steps.residual_seq(cfg, mesh, default_rules(), toks(16)) is None
    odd_vocab = dataclasses.replace(cfg, vocab=510)
    assert steps.residual_seq(odd_vocab, mesh, sp, toks(16)) is None
    assert steps.residual_seq(cfg, None, sp, toks(16)) is None


def test_fabric_ddp_with_sequence_parallelism_is_the_plain_plan():
    """World-1 fabric DDP at model=1: the reference installs the
    sequence-parallel rules on its gradient path, which split nothing."""
    torch_threads.apply()
    kw = dict(device="cpu", ddp=True, ddp_shards=2, batch=4, seq=16)
    got = {}
    for sp in (False, True):
        with Plan(**kw, strategy=steps.Strategy(
                sequence_parallel=sp)).compile() as s:
            got[sp] = s.train(steps=3, log_every=1, verbose=False)["losses"]
    assert got[True] == got[False]


def test_serve_ignores_sequence_parallelism():
    kw = dict(device="cpu")
    got = {}
    for sp in (False, True):
        with Plan(**kw, strategy=steps.Strategy(
                sequence_parallel=sp)).compile() as s:
            out = s.serve(requests=3, slots=2, prompt_len=8, gen_len=4)
            got[sp] = torch.cat(out["generated"])
    assert torch.equal(got[True], got[False])


def test_launch_train_model2_seq_parallel_runs():
    """``--model 2 --seq-parallel``: two rank processes, the residual
    split by sequence, the losses of one process."""
    torch_threads.apply(torch_threads.RANK)
    base = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
            "16", "--log-every", "1"]
    out = train_cli.run(train_cli.parser().parse_args(
        base + ["--model", "2", "--seq-parallel"]))
    one = train_cli.run(train_cli.parser().parse_args(base))
    np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-5)
