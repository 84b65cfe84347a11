"""The model axis for the xlstm and encdec families: xlstm-350m's mLSTM
and sLSTM layers on a rank's heads, and whisper-medium's encoder,
decoder and cross-attention on a rank's heads, against the JAX package
on the same mesh.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``'s
``model_axis_xlstm_encdec`` job), the port's ``Plan(model=M)``
sessions and two JAX subprocesses with 4 host devices, all run at once;
every model starts from the reference's init (``PRNGKey(0)``, carried
by ``bridge``):

* every parameter leaf's local shape, and every decode-state leaf's
  (the mLSTM's ``C``, ``n``, ``m`` and the sLSTM's state by heads, the
  mLSTM's ``conv`` by its block of ``d_in``, whisper's self and cross
  caches by kv heads), is the JAX ``shard_shape`` at ``model`` 2 and 4:
  tiny xlstm (its sLSTM's 2 heads do not divide 4: the layer is whole on
  every rank while ``w_in``'s columns split), tiny whisper and whisper
  with a vocab of 509, which stays whole as full whisper's 51,865 does;
* the loss and every leaf's gradient, gathered, at ``data=2, model=2``
  and ``data=1, model=4`` (at ``data=2`` each dp shard's loss averaged,
  as the reference's train step takes it), from the reference's init
  with every leaf it fills with one value (the biases, the norms,
  ``b_i``, ``b_f``, ``skip``) drawn at random, so that a bias added once
  per rank shows: xlstm within 1e-4 of the largest |gradient|, whisper
  within 1e-3 of the largest (its stated
  conditioning, ROADMAP section 3); both routes of ``ssm._fused_cols``
  run here (the product's columns gathered at ``data=2``, where a dp
  shard's 64 rows are fewer than ``d``'s 128, the weight's at
  ``model=4``);
* 4 phylanx, horovod and zero1 steps against the reference's
  ``make_train_step`` on the same mesh, every leaf that no rule splits
  bit-identical on every rank after every step;
* ``Session.serve``'s tokens and first logits at ``model=2`` and at
  ``data=2, model=2``, xlstm's ``serve_stream`` streams, statuses and
  counters at ``model=2``, and whisper's ``serve_stream`` refused with
  the reference's message.
"""
import dataclasses
import json
import subprocess
import sys
import tempfile
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
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.core.sharding import is_spec, local_specs
from repro_torch.frontend import Plan
from repro_torch.launch.mesh import Mesh
from torch_mesh_world import run_world
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
XLSTM, WHISPER = "xlstm-350m", "whisper-medium"
# (arch, overrides) by key
CFGS = {"xlstm": (XLSTM, {}),
        "whisper": (WHISPER, {}),
        # a vocab that no model axis divides: the embedding and the
        # logits stay whole on every rank, as full whisper's 51,865 do
        "whisper-v509": (WHISPER, {"vocab": 509})}
SHAPE_CFGS = tuple(CFGS)
GRAD_CASES = ["xlstm@2x2", "xlstm@1x4", "whisper@2x2", "whisper@1x4",
              "whisper-v509@2x2"]
# of the largest |gradient| over all leaves: xlstm as the dense family;
# tiny whisper at its stated conditioning (ROADMAP section 3: the
# reference's init grows the encoder's gradient layer by layer)
GRAD_TOL = {XLSTM: 1e-4, WHISPER: 1e-3}
BATCH, SEQ, STEPS = 8, 16, 4
# (cfg, strategy, mesh, optimizer, lr): each strategy of each family on
# one of the meshes; zero1's solver is adamw in both packages, run at a
# small lr (its normalized step turns near-zero gradients' sign
# differences into whole +-lr steps)
TRAJ = [("xlstm", "phylanx", "2x2", "momentum", 1e-2),
        ("xlstm", "horovod", "1x4", "momentum", 1e-2),
        ("xlstm", "zero1", "2x2", "adamw", 1e-5),
        ("whisper", "phylanx", "1x4", "momentum", 1e-2),
        ("whisper", "horovod", "2x2", "momentum", 1e-2),
        ("whisper", "zero1", "1x4", "adamw", 1e-5)]
# the trajectories' losses and gradient norms, relative.  Tiny
# whisper's gradient norm after 4 momentum steps moves by 2.06e-3 within
# the reference itself from one device to model=4
# (tools/model_axis_families_check.py jax-traj; xlstm's by 8e-8), so
# whisper's norms are held to 5e-3
TRAJ_RTOL = {XLSTM: {"loss": 1e-5, "grad_norm": 1e-5},
             WHISPER: {"loss": 1e-5, "grad_norm": 5e-3}}
CASES = [f"{c}:{n}@{m}" for c, n, m, _, _ in TRAJ]
CACHE = {"seq_len": 24, "global_batch": 2}
MESHES = {"model2": dict(model=2), "data2-model2": dict(data=2, model=2)}
SERVE = dict(requests=3, prompt_len=12, gen_len=4, slots=2)
STREAM = dict(prompt_len=12, gen_len=4, slots=2)
ARRIVALS = (0, 0, 1, 3)
SERVE_CELLS = [f"{a}/{m}" for a in ("xlstm", "whisper") for m in MESHES]
STREAM_CELLS = ["xlstm/model2"]
REFUSE = dict(requests=2, slots=2, prompt_len=8, gen_len=2, verbose=False)

_REF = textwrap.dedent("""
    import dataclasses, json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.core import steps as S
    from repro.core.sharding import (default_rules, init_params,
                                     param_shardings, set_act_hook)
    from repro.data.pipeline import stream_for
    from repro.frontend import Plan
    from repro.launch.mesh import make_local_mesh
    from repro.models.model import build_model
    from repro.optim.optimizers import OptConfig
    spec = json.loads(sys.stdin.read())
    def cfg_of(key):
        arch, over = spec["cfgs"][key]
        return dataclasses.replace(get_config(arch, tiny=True), **over)
    def flat(tree):
        return {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    if spec["part"] == "serve":
        # the serve parameters first: the port's sessions wait for them
        paths = {}
        for arch in spec["serve_archs"]:
            with Plan(arch=arch).compile() as s:
                pre = s._serve_steps_for(8, 8, 1)[0]
                params = init_params(pre.specs, jax.random.PRNGKey(s.plan.seed))
            paths[arch] = os.path.join(spec["tmp"], arch + ".npz")
            np.savez(paths[arch], **flat(params))
        print("PARAMS " + json.dumps(paths), flush=True)
        out = {"serve": {}, "stream": {}}
        for cell in spec["serve_cells"]:
            key, name = cell.split("/")
            arch, mesh = spec["cfgs"][key][0], spec["meshes"][name]
            with Plan(arch=arch, **mesh).compile() as s:
                kw = spec["serve"]
                pre, dec = s._serve_steps_for(kw["prompt_len"], kw["gen_len"],
                                              kw["slots"])
                waves, first = [], []
                def wrap(fn, prefill):
                    def call(*a):
                        logits, cache = fn(*a)
                        tok = np.asarray(jnp.argmax(logits, -1))
                        if prefill:
                            waves.append([tok])
                            if not first:
                                first.append(np.asarray(logits, np.float32))
                        else:
                            waves[-1].append(tok)
                        return logits, cache
                    return call
                pre.fn, dec.fn = wrap(pre.fn, True), wrap(dec.fn, False)
                s.serve(verbose=False, **kw)
                out["serve"][cell] = {
                    "tokens": [np.stack(w, 1).tolist() for w in waves],
                    "first": first[0].tolist()}
                if cell in spec["stream_cells"]:
                    got = s.serve_stream(verbose=False, trace=spec["trace"],
                                         **spec["stream"])
                    out["stream"][cell] = {
                        "streams": got["streams"],
                        "status": {h.rid: h.status for h in got["handles"]},
                        "serve": got["runtime_stats"]["serve"],
                        **{k: got[k] for k in ("completed", "rounds", "epochs",
                                               "tokens", "padded_tokens")}}
                elif arch == spec["encdec"] and "refusal" not in out:
                    try:
                        s.serve_stream(**spec["refuse"])
                    except ValueError as e:
                        out["refusal"] = str(e)
        # local shapes of every parameter and decode-state leaf
        out["shapes"] = {}
        for key in spec["shape_cfgs"]:
            cfg = cfg_of(key)
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
                out["shapes"][f"{key}@{M}"] = {"params": params, "cache": cache}
    else:
        out["grads"] = {}
        for key in spec["grad_cases"]:
            c, m = key.split("@")
            cfg = cfg_of(c)
            model = build_model(cfg)
            specs = model.specs()
            # the train step's math: each dp shard's loss, averaged over
            # the dp axis
            ndp = 2 if m == "2x2" else 1
            mesh, rules = make_local_mesh(model=4 // ndp), default_rules()
            sh = param_shardings(specs, mesh, rules)
            with np.load(spec["grad_params"][c]) as z:
                params = jax.tree_util.tree_map_with_path(
                    lambda p, x: jnp.asarray(z["/".join(str(k.key) for k in p)]),
                    init_params(specs, jax.random.PRNGKey(0)))
            params = jax.device_put(params, sh)
            with np.load(spec["batch"][c]) as z:
                batch = {k: jnp.asarray(z[k]) for k in z.files}
            set_act_hook(mesh, rules)
            vg = jax.jit(jax.value_and_grad(model.loss), in_shardings=(sh, None))
            rows = spec["batch_size"] // ndp
            parts = [vg(params, {k: v[d * rows:(d + 1) * rows]
                                 for k, v in batch.items()}) for d in range(ndp)]
            set_act_hook(None, None)
            loss = sum(p[0] for p in parts) / ndp
            g = jax.tree.map(lambda *x: sum(x) / ndp, *[p[1] for p in parts])
            path = os.path.join(spec["tmp"], f"grads-{key}.npz")
            np.savez(path, *[np.asarray(x) for x in jax.tree.leaves(g)])
            out["grads"][key] = {"loss": float(loss), "path": path}
    # the trajectories of this part's cases
    meshes = {"2x2": make_local_mesh(data=2, model=2),
              "1x4": make_local_mesh(model=4)}
    shape = {"seq_len": spec["seq"], "global_batch": spec["batch_size"],
             "kind": "train"}
    for case in spec["cases"][spec["part"]]:
        cfg = cfg_of(case["cfg"])
        step = S.make_train_step(cfg, meshes[case["mesh"]], S.Strategy(
            name=case["name"], opt=OptConfig(kind=case["opt"],
                                             lr=case["lr"])), shape)
        params, opt = step.init(jax.random.PRNGKey(0))
        stream = stream_for(cfg, batch=spec["batch_size"], seq=spec["seq"],
                            seed=0)
        ls, gs = [], []
        for it in range(spec["steps"]):
            b = {k: jax.device_put(v, step.batch_shardings[k])
                 for k, v in stream.batch_at(it).items()}
            mt, params, opt = step.fn(params, opt, b)
            ls.append(float(mt["loss"]))
            gs.append(float(mt["grad_norm"]))
        out[case["key"]] = {"loss": ls, "grad_norm": gs}
    print(json.dumps(out))
""")


def _cfg(key: str):
    arch, over = CFGS[key]
    return dataclasses.replace(get_config(arch, tiny=True), **over)


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


def _jax_params(key: str) -> dict:
    arch, over = CFGS[key]
    cfg = dataclasses.replace(jax_get_config(arch, tiny=True), **over)
    return jax.tree.map(np.asarray, jax_init_params(
        jax_build_model(cfg).specs(), jax.random.PRNGKey(0)))


def _drawn(params: dict) -> dict:
    """``params`` with every leaf that holds one value (the zero or one
    init of a bias, a norm, ``b_i``, ``b_f``, ``skip``) drawn around it
    from a seeded normal, so that its gradient is exercised."""
    rng = np.random.default_rng(0)

    def one(a):
        if np.all(a == a.flat[0]):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree.map(one, params)


def _flat(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _batch(key: str) -> dict:
    """Seeded tokens and labels, and for whisper the encoder's frames."""
    cfg = _cfg(key)
    rng = np.random.default_rng(5)
    out = {n: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
           for n in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal(
            (BATCH, cfg.enc_frames, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _serve_port(paths: dict) -> dict:
    """The port's ``Session.serve`` of every cell (and ``serve_stream``
    of the stream cells, the refusal of whisper's), on the reference's
    serve parameters."""
    torch_threads.apply(torch_threads.RANK)
    trace = [{"at_round": r} for r in ARRIVALS]
    out: dict = {"serve": {}, "stream": {}}
    for cell in SERVE_CELLS:
        key, name = cell.split("/")
        arch = CFGS[key][0]
        with Plan(arch=arch, device="cpu", **MESHES[name]).compile() as s:
            s._serve_params = _tree(paths[arch])
            out["serve"][cell] = s.serve(verbose=False, **SERVE)
            if cell in STREAM_CELLS:
                out["stream"][cell] = s.serve_stream(
                    verbose=False, trace=trace, **STREAM)
            elif arch == WHISPER and "refusal" not in out:
                with pytest.raises(ValueError) as e:
                    s.serve_stream(**REFUSE)
                out["refusal"] = str(e.value)
    return out


def _reference(spec, part: str):
    """A JAX subprocess with 4 host devices running ``part`` of the
    reference's side (``serve``: the serve parameters, the serve cells,
    the local shapes; ``train``: the gradients), each with its share of
    the trajectories, and the file its stderr goes to."""
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", _REF], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    proc.stdin.write(json.dumps(dict(spec, part=part)))
    proc.stdin.close()
    return proc, err


def _result(proc, err) -> dict:
    """The last stdout line of a ``_reference`` process, as JSON."""
    try:
        rest = proc.stdout.read()
        code = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
        err.seek(0)
        log = err.read()
        err.close()
    assert code == 0 and rest.strip(), log[-3000:]
    return json.loads(rest.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two subprocesses, the port's world and the port's
    sessions, all at once (the sessions once the reference has written
    its serve parameters)."""
    tmp = tmp_path_factory.mktemp("model_axis_xlstm_encdec")
    params = {k: _jax_params(k) for k in CFGS}
    grad_params = {k: _drawn(v) for k, v in params.items()}
    grad_paths = {}
    for k, v in grad_params.items():
        grad_paths[k] = str(tmp / f"grad-params-{k}.npz")
        np.savez(grad_paths[k], **_flat(v))
    batch = {k: _batch(k) for k in CFGS}
    batch_paths = {}
    for k, b in batch.items():
        batch_paths[k] = str(tmp / f"batch-{k}.npz")
        np.savez(batch_paths[k], **b)
    cases = [{"key": f"{c}:{name}@{m}", "cfg": c, "name": name, "mesh": m,
              "opt": kind, "lr": lr, "batch": BATCH, "seq": SEQ,
              "steps": STEPS} for c, name, m, kind, lr in TRAJ]
    # the trajectories split over the two reference processes: xlstm's
    # beside the gradients, whisper's beside the serve cells
    serve_side = [c["cfg"] == "whisper" for c in cases]
    spec = {"cfgs": CFGS, "shape_cfgs": SHAPE_CFGS, "cache": CACHE,
            "grad_cases": GRAD_CASES, "tmp": str(tmp),
            "cases": {"serve": [c for c, x in zip(cases, serve_side) if x],
                      "train": [c for c, x in zip(cases, serve_side)
                                if not x]},
            "batch": batch_paths, "grad_params": grad_paths,
            "batch_size": BATCH, "seq": SEQ,
            "steps": STEPS, "serve_archs": [XLSTM, WHISPER],
            "encdec": WHISPER, "meshes": MESHES,
            "serve_cells": SERVE_CELLS, "stream_cells": STREAM_CELLS,
            "serve": SERVE, "stream": STREAM, "refuse": REFUSE,
            "trace": [{"at_round": r} for r in ARRIVALS]}
    serve_ref = _reference(spec, "serve")
    train_ref = _reference(spec, "train")
    world: dict = {}

    def run():
        try:
            world["ranks"] = run_world("model_axis_xlstm_encdec", 4, {
                "cfgs": CFGS, "params": params, "grad_params": grad_params,
                "batch": batch, "grad_cases": GRAD_CASES, "cases": cases})
        except BaseException as e:  # noqa: BLE001 - raised below
            world["error"] = e
    t = threading.Thread(target=run)
    t.start()
    try:
        line = serve_ref[0].stdout.readline()
        assert line.startswith("PARAMS "), "the reference's serve part failed"
        port = _serve_port(json.loads(line[len("PARAMS "):]))
        ref = _result(*serve_ref)
        ref.update(_result(*train_ref))
    finally:
        t.join()
        for proc, _ in (serve_ref, train_ref):
            if proc.poll() is None:
                proc.kill()
    if "error" in world:
        raise world["error"]
    return {"ref": ref, "ranks": world["ranks"], "port": port}


def _shapes(specs) -> list:
    tree = pytree.tree_map(lambda s: torch.empty(s.shape), specs,
                           is_leaf=is_spec)
    return [list(a.shape) for a in bridge.host_leaves(tree)[1]]


@pytest.mark.parametrize("key", SHAPE_CFGS)
@pytest.mark.parametrize("model", [2, 4])
def test_local_shapes_are_the_reference_tiling(runs, key, model):
    """Every parameter leaf's block and every decode-state leaf's block
    is the JAX ``shard_shape``."""
    want = runs["ref"]["shapes"][f"{key}@{model}"]
    cfg = _cfg(key)
    mesh = Mesh(shape={"data": 1, "model": model},
                coords={"data": 0, "model": model - 1})
    step = steps.make_train_step(cfg, steps.Strategy(), mesh=mesh)
    assert _shapes(local_specs(step.specs, mesh, step.rules)) == \
        want["params"]
    dec = steps.make_decode_step(cfg, CACHE, mesh=mesh)
    assert _shapes(dec.cache_specs) == want["cache"]


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_loss_and_every_gradient_match_jax(runs, case):
    ref = runs["ref"]["grads"][case]
    got = runs["ranks"][0]["grads"][case]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    with np.load(ref["path"]) as z:
        want = [z[f"arr_{i}"] for i in range(len(z.files))]
    leaves = _leaves(got["grads"])
    assert [x.shape for x in leaves] == [x.shape for x in want]
    tol = GRAD_TOL[CFGS[case.split("@")[0]][0]]
    scale = max(np.abs(x).max() for x in want)
    for i, (g, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=0,
                                   err_msg=f"leaf {i}")
    # every rank gathers the same gradients
    for other in runs["ranks"][1:]:
        o = other["grads"][case]
        assert o["loss"] == got["loss"]
        assert o["digests"] == got["digests"]


@pytest.mark.parametrize("case", CASES)
def test_strategy_matches_reference_on_the_mesh(runs, case):
    want = runs["ref"][case]
    got = runs["ranks"][0]["cases"][case]
    rtol = TRAJ_RTOL[CFGS[case.split(":")[0]][0]]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol[k],
                                   err_msg=f"{case} {k}")
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["loss"] == got["loss"]
        assert r["cases"][case]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_are_bit_identical_on_every_rank(runs, case):
    """The leaves no rule splits (the norms, ``pos_dec``, ``b_down``; at
    model=4 the sLSTM's ``r``) hold the same bits on all 4 ranks after
    every step: a gradient summed twice, or not at all, over a model
    group shows here."""
    base = runs["ranks"][0]["cases"][case]["replicated"]
    assert len(base) == STEPS and len(base[0]) >= 3
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["replicated"] == base


def test_whisper_odd_vocab_stays_whole():
    """An odd vocab (509 here, 51,865 at full size) does not divide the
    model axis: the embedding and unembedding stay whole on every rank
    while the heads, ``d_ff`` and ``b_up`` split and ``b_down`` does
    not."""
    for M in (2, 4):
        mesh = Mesh(shape={"data": 1, "model": M},
                    coords={"data": 0, "model": 0})
        for key, vocab in (("whisper-v509", 509), ("whisper", None)):
            step = steps.make_train_step(_cfg(key), steps.Strategy(),
                                         mesh=mesh)
            loc = local_specs(step.specs, mesh, step.rules)
            assert loc["embed"]["tok"].shape[0] == (vocab or 512 // M)
            assert loc["unembed"]["w"].shape[1] == (vocab or 512 // M)
            layer = loc["dec_stack"][0]
            assert layer["cross"]["wq"].shape[1] == 4 // M
            assert layer["mlp"]["b_up"].shape == (256 // M,)
            assert layer["mlp"]["b_down"].shape == (128,)
    full = get_config(WHISPER)
    assert full.vocab % 2 and full.n_heads % 4 == 0


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_session_serve_equals_the_references(runs, cell):
    got = runs["port"]["serve"][cell]
    want = runs["ref"]["serve"][cell]
    assert [g.tolist() for g in got["generated"]] == want["tokens"]
    first = np.asarray(want["first"], np.float32)
    mine = got["first_prefill_logits"].numpy()
    assert mine.shape == first.shape
    assert np.abs(mine - first).max() <= 1e-5 * np.abs(first).max()
    for loc in got["localities"].values():
        assert loc["tokens"] == got["tokens"]
        assert loc["wire"]["axes"]["model"]["calls"] > 0


@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_serve_stream_equals_the_references(runs, cell):
    got = runs["port"]["stream"][cell]
    want = runs["ref"]["stream"][cell]
    assert got["streams"] == want["streams"]
    assert {h.rid: h.status for h in got["handles"]} == want["status"]
    for key in ("completed", "rounds", "epochs", "tokens", "padded_tokens"):
        assert got[key] == want[key], key
    # the pool's high-water marks depend on thread timing, in either
    # package, and a rank's page counts on its share: it parks its heads'
    # blocks of a request's state where the reference parks the whole
    paged = ("pages_grown", "pages_reused", "pages_peak", "page_allocs",
             "page_frees")
    assert {k: v for k, v in got["runtime_stats"]["serve"].items()
            if k not in paged} == \
        {k: v for k, v in want["serve"].items() if k not in paged}
    assert got["cache"]["pages_live"] == 0
    for loc in got["localities"].values():
        assert loc["cache"]["pages_live"] == 0
        assert loc["request_bytes"] == got["request_bytes"]


def test_encdec_serve_stream_is_refused_as_the_reference_refuses(runs):
    got = runs["port"]["refusal"]
    assert got == runs["ref"]["refusal"]
    assert "serve_stream does not support encdec" in got
