"""Serving and training over the model axis through the frontend
(``Plan(model=M)``), and what the model axis still refuses.

* ``Session.serve`` at ``model`` 2 and 4 (one gloo rank process each,
  ``frontend/mesh.rank_serve``) gives the tokens of the JAX package's
  ``Session.serve`` on the same mesh, on the reference's serve
  parameters (tiny qwen3-4b, float32 compute; at ``model=4`` the 2 kv
  heads do not divide, so the cache is tiled by sequence, 24 positions in
  4 blocks); tiny qwen2.5-3b (QKV biases) at ``model=4`` too.  One JAX
  subprocess with 4 host devices runs the reference's sessions while the
  port's run;
* ``launch.train --data 2 --model 2`` (four rank processes) takes the
  steps of the one-process run within 1e-5, and a ``data=2, model=2``
  session's checkpoint is the global layout that a one-process session
  resumes from;
* a fault on one rank of the model group replays the step on both;
* the model axis beside the other multi-process modes is accepted, each
  plan with its layout of rank processes, and what still refuses names
  its ROADMAP item.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import pipeline, steps
from repro_torch.core.dist_array import TiledArray
from repro_torch.core.sharding import default_rules
from repro_torch.data.pipeline import LMStream
from repro_torch.frontend import Plan
from repro_torch.frontend.plan import _unsupported, mesh_group
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_mesh
from torch_mesh_world import NanOnRank, with_fault_hook
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
SERVE = dict(requests=5, prompt_len=18, gen_len=6, slots=2)
CELLS = [("qwen3-4b", 2), ("qwen3-4b", 4), ("qwen2.5-3b", 4)]

_REF = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.core.sharding import init_params
    from repro.frontend import Plan
    spec = json.loads(sys.stdin.read())
    out = {}
    for arch, model in spec["cells"]:
        with Plan(arch=arch, model=model).compile() as s:
            kw = spec["serve"]
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
            params = init_params(pre.specs, jax.random.PRNGKey(s.plan.seed))
        flat = {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
                for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
        path = os.path.join(spec["tmp"], f"{arch}@{model}.npz")
        np.savez(path, **flat)
        out[f"{arch}@{model}"] = {
            "tokens": [np.stack(w, 1).tolist() for w in waves],
            "params": path}
    print(json.dumps(out))
""")


def _reference(spec) -> dict:
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _REF], input=json.dumps(spec),
                       env=env, text=True, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


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
def served(tmp_path_factory):
    """The reference's tokens and the port's, the port's sessions started
    once the reference has written its parameters."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    ref = _reference({"cells": CELLS, "serve": SERVE, "tmp": str(tmp)})
    torch_threads.apply(torch_threads.RANK)
    port = {}
    for arch, model in CELLS:
        with Plan(arch=arch, model=model, device="cpu").compile() as s:
            s._serve_params = _tree(ref[f"{arch}@{model}"]["params"])
            port[f"{arch}@{model}"] = s.serve(verbose=False, **SERVE)
    return ref, port


@pytest.mark.parametrize("cell", [f"{a}@{m}" for a, m in CELLS])
def test_session_serve_tokens_equal_the_references(served, cell):
    ref, port = served
    got = port[cell]
    want = ref[cell]["tokens"]
    assert [g.tolist() for g in got["generated"]] == want
    assert got["waves"] == 3 and got["tokens"] == 5 * SERVE["gen_len"]
    n_decode = sum(n.startswith("decode:") for n in got["nodes"])
    assert n_decode == 3 * SERVE["gen_len"]
    assert got["first_prefill_logits"].shape == (2, 512)
    # every worker rank decoded the same tokens and exchanged over its
    # model group, never over a dp group
    for r, loc in got["localities"].items():
        assert loc["tokens"] == got["tokens"]
        assert loc["wire"]["axes"]["dp"]["calls"] == 0
        assert loc["wire"]["axes"]["model"]["calls"] > 0


def test_serve_at_model4_tiles_the_cache_by_sequence():
    cfg = get_config("qwen3-4b", tiny=True)
    shape = {"seq_len": 24, "global_batch": 2}
    mesh = Mesh(shape={"data": 1, "model": 4},
                coords={"data": 0, "model": 1})
    dec = steps.make_decode_step(cfg, shape, mesh=mesh)
    assert dec.rules.axis_for("kv_seq") == "model"
    assert tuple(dec.cache_specs[0]["k"].shape) == (2, 6, 2, 32)
    mesh2 = Mesh(shape={"data": 1, "model": 2},
                 coords={"data": 0, "model": 1})
    dec2 = steps.make_decode_step(cfg, shape, mesh=mesh2)
    assert tuple(dec2.cache_specs[0]["k"].shape) == (2, 24, 1, 32)


def _losses(argv) -> list:
    args = train_cli.parser().parse_args(
        ["--device", "cpu", "--tiny", "--steps", "4", "--batch", "8",
         "--seq", "16", "--log-every", "1", *argv])
    return train_cli.run(args)["losses"]


def test_launch_train_at_data2_model2_takes_the_one_process_steps():
    torch_threads.apply(torch_threads.RANK)
    want = _losses([])
    got = _losses(["--data", "2", "--model", "2"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mesh_session_checkpoint_resumes_in_one_process(tmp_path):
    """Rank 0 of a ``data=2, model=2`` session saves the global
    parameters (rank 0 holds the first half of every split leaf, the
    whole of the others) and a one-process session resumes from them on
    the one-process run's trajectory."""
    torch_threads.apply(torch_threads.RANK)
    kw = dict(device="cpu", batch=8, seq=16)
    with Plan(data=2, model=2, **kw).compile() as s:
        out = s.train(steps=2, ckpt_dir=str(tmp_path), ckpt_every=2,
                      verbose=False)
    step = steps.make_train_step(get_config("qwen3-4b", tiny=True),
                                 steps.Strategy())
    with CheckpointManager(tmp_path, async_save=False) as cm:
        at, (params, _) = cm.restore((step.params_like(),
                                      step.global_like()))
    assert at == 2
    mine = out["params"]
    wq = params["stack"][0]["attn"]["wq"]
    assert torch.equal(mine["stack"][0]["attn"]["wq"].detach(),
                       wq[:, :wq.shape[1] // 2])
    tok = params["embed"]["tok"]
    assert torch.equal(mine["embed"]["tok"].detach(),
                       tok[:tok.shape[0] // 2])
    assert torch.equal(mine["ln_f"]["w"].detach(), params["ln_f"]["w"])
    with Plan(**kw).compile() as s:
        resumed = s.train(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                          resume=True, verbose=False)
    with Plan(**kw).compile() as s:
        straight = s.train(steps=4, verbose=False)
    np.testing.assert_allclose(out["losses"], straight["losses"][:2],
                               rtol=1e-5)
    np.testing.assert_allclose(resumed["losses"], straight["losses"][2:],
                               rtol=1e-5)


def test_replay_verdicts_are_agreed_over_the_model_group():
    """A NaN on the model group's rank 1 alone replays the step on both
    ranks (the verdict is agreed over the whole world), and the run ends
    as the straight one did."""
    torch_threads.apply(torch_threads.RANK)
    kw = dict(steps=2, log_every=1, verbose=False)
    with Plan(model=2, device="cpu", batch=4, seq=16).compile() as s:
        straight = s.train(**kw)
        with_fault_hook(s, NanOnRank(1))
        got = s.train(resilience="replay", **kw)
    assert got["losses"] == straight["losses"]
    assert got["resilience"]["replays"] == 1
    assert got["localities"][1]["resilience"]["replays"] == 1


@pytest.mark.parametrize("kw, match", [
    # every family, onebit and sequence parallelism run on a model axis,
    # and since item 14b's part 6 beside fabric DDP (a model group of
    # rank processes a locality), SPMD mode (a mesh world a locality) and
    # fabric localities or elastic membership (task localities beside
    # the mesh's one world): each plan is accepted, with its layout
    (dict(arch="granite-moe-1b-a400m", model=2, strategy="onebit",
          ddp=True), "fabric DDP with a model axis"),
    (dict(arch="zamba2-2.7b", model=2, spmd=True, localities=2,
          strategy=steps.Strategy(sequence_parallel=True)), "SPMD mode"),
    (dict(arch="xlstm-350m", model=2, localities=2,
          strategy=steps.Strategy(sequence_parallel=True)),
     "fabric localities"),
    (dict(arch="whisper-medium", model=2, elastic=True,
          strategy=steps.Strategy(sequence_parallel=True)),
     "elastic membership"),
    (dict(model=2, strategy="onebit", ddp=True),
     "fabric DDP with a model axis"),
    (dict(arch="granite-moe-1b-a400m", model=2, ddp=True,
          strategy=steps.Strategy(sequence_parallel=True)),
     "fabric DDP with a model axis"),
    (dict(model=2, spmd=True, localities=2), "SPMD mode"),
    (dict(model=2, localities=2), "fabric localities"),
    (dict(model=2, elastic=True), "elastic membership"),
    (dict(model=2, ddp=True), "fabric DDP with a model axis"),
    # a replicated serve_stream plan beside a task locality
    (dict(arch="xlstm-350m", model=2, replicas=2, strategy="onebit",
          localities=2), "fabric localities"),
], ids=["moe", "zamba", "xlstm", "encdec", "onebit", "seq-parallel",
        "spmd", "localities", "elastic", "ddp", "serve-stream-xlstm"])
def test_model_axis_refusals_name_item_14b(kw, match):
    """No refusal is left of item 14b's part 6: the plan passes the
    session's checks and lays out its rank processes as
    ``frontend.plan.mesh_group`` says (SPMD mode: a world of the model
    axis for each locality; fabric DDP: a model group for each locality;
    localities and elastic joiners: task localities beside one world).
    The plain qwen3-4b ids (``spmd``, ``localities``, ``elastic``,
    ``ddp``) also compile the plan and take one step, every rank and
    locality of the layout taking the driver's loss; the other families
    run in ``tests/test_torch_ddp_model_axis.py``,
    ``test_torch_mesh_localities.py`` and ``test_torch_spmd_mesh.py``."""
    plan = Plan(device="cpu", **kw)
    assert _unsupported(plan) is None
    worlds = plan.localities if match == "SPMD mode" else 1
    assert mesh_group(plan) == (worlds, 2)
    if set(kw) - {"localities", "elastic", "spmd", "ddp"} != {"model"}:
        return
    torch_threads.apply(torch_threads.RANK)
    with Plan(device="cpu", batch=4, seq=16, **kw).compile() as s:
        assert len(s.ranks.group.procs) == worlds
        assert (s.distributed is not None) == (plan.localities > 1
                                               or plan.elastic)
        out = s.train(steps=1, log_every=1, verbose=False)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    others = {**(out.get("ranks") or {}), **(out.get("localities") or {})}
    assert others and all(m["final_loss"] == out["final_loss"]
                          for m in others.values())


def test_step_builders_refuse_what_the_plan_refuses():
    """onebit and sequence parallelism build on a model axis for every
    family; fabric DDP's step refuses a dp axis > 1 and a stage axis
    beside a model axis raises (item 14b, part 7) before any world."""
    mesh = Mesh(shape={"data": 1, "model": 2},
                coords={"data": 0, "model": 0})
    for arch, strategy in (
            ("qwen3-4b", steps.Strategy(name="onebit")),
            ("xlstm-350m", steps.Strategy(sequence_parallel=True)),
            ("granite-moe-1b-a400m",
             steps.Strategy(sequence_parallel=True))):
        step = steps.make_train_step(get_config(arch, tiny=True), strategy,
                                     mesh=mesh)
        assert step.split_mask is not None
    with pytest.raises(ValueError, match="replaces the in-process dp axes"):
        steps.make_ddp_step(get_config("qwen3-4b", tiny=True),
                            steps.Strategy(name="onebit"),
                            mesh=Mesh(shape={"data": 2, "model": 2}))
    with pytest.raises(NotImplementedError, match="stage.*item 14b, part 7"):
        make_mesh((2, 2), ("stage", "model"))
    # sequence parallelism builds and runs (at model=1: the plain path)
    cfg = get_config("qwen3-4b", tiny=True)
    sp, plain = (steps.make_train_step(cfg, steps.Strategy(
        sequence_parallel=v)) for v in (True, False))
    assert sp.rules.axis_for("seq") == "model"
    batch = {k: torch.from_numpy(v) for k, v in LMStream(
        vocab=cfg.vocab, batch=2, seq=8).batch_at(0).items()}
    got = [step.fn(*step.init(torch.Generator().manual_seed(0), "cpu"),
                   batch)[0]["loss"] for step in (sp, plain)]
    assert torch.equal(got[0], got[1])
    args = train_cli.parser().parse_args(
        ["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8",
         "--log-every", "1", "--seq-parallel"])
    assert len(train_cli.run(args)["losses"]) == 1


def test_pipeline_and_dist_array_name_item_14b():
    """GPipe and ``TiledArray`` run on a mesh of one process (the
    reference's ``test_tiled_array_metadata_and_retile``); a stage axis
    beside other mesh axes is what stays refused (item 14b, part 7)."""
    assert pipeline.bubble_fraction(4, 12) == 3 / 15
    stage = make_mesh((1,), ("stage",))
    ws = torch.randn(1, 4, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 2, 4, generator=torch.Generator().manual_seed(1))
    fn = pipeline.make_pipeline_fn(lambda w, h: torch.tanh(h @ w), stage)
    assert torch.allclose(fn(ws, x), torch.tanh(x @ ws[0]))
    assert torch.equal(pipeline.gpipe_apply(
        lambda w, h: torch.tanh(h @ w), ws[0], x, stage), fn(ws, x))
    mesh = make_local_mesh()
    v = torch.arange(64.0).reshape(8, 8)
    t = TiledArray.tile(v, ("batch", "embed"), mesh, default_rules())
    assert t.global_shape == (8, 8) and t.tile_shape() == (8, 8)
    assert torch.equal(t.replicated().data, v)
    r2 = t.retile(default_rules(sequence_parallel=True))
    assert r2.global_shape == (8, 8) and torch.equal(r2.data, v)
    assert torch.equal(t.with_halo("batch", 1), v)
    with pytest.raises(NotImplementedError, match="stage.*item 14b"):
        make_mesh((2, 2), ("data", "stage"))
