"""Sequence parallelism beyond the dense family: granite-moe-1b-a400m,
zamba2-2.7b, xlstm-350m and whisper-medium with
``Strategy(sequence_parallel=True)``, against the JAX package under
``default_rules(sequence_parallel=True)`` on the same mesh.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``'s
``seq_parallel_families`` job) and two JAX subprocesses with 4 host
devices, all run at once; every model starts from the reference's init
(``PRNGKey(0)``, carried by ``bridge``):

* the loss and every leaf's gradient, gathered, at ``data=1, model=2``,
  from the reference's init with every leaf it fills with one value
  drawn at random (as the families' files draw them; whisper's ``wq``
  times 1/8, as ``chip_smoke.py`` holds the family),
  ``data=2, model=2`` (each dp shard's loss averaged, as the reference's
  train step takes it) and ``data=1, model=4`` (tiny xlstm's 2 sLSTM
  heads do not divide 4: that layer runs whole on the gathered sequence
  and is cut to the rank's rows) against ``jax.value_and_grad`` with
  the residual's ``seq`` on ``model``, at each family's tolerance of
  ``tests/test_torch_model_axis_families.py`` and
  ``tests/test_torch_model_axis_xlstm_encdec.py``;
* the same against the port's own model axis without sequence
  parallelism, and every rank gathering the same bits;
* a sequence that the model axis does not divide (15 tokens, and 15
  frames for whisper) takes the path without it, bit for bit;
* whisper with a vocab of 509, which no model axis divides: the decoder
  stays whole while the encoder splits by its frames;
* 3 phylanx, horovod and zero1 steps (one run a family) against the reference's
  ``make_train_step`` with sequence parallelism, every leaf that no rule
  splits bit-identical on every rank after every step.
"""
import dataclasses
import json
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.core.sharding import ModelAxis, act_hook, default_rules, \
    model_axis, residual_hook
from repro_torch.launch.mesh import Mesh
from torch_mesh_world import run_world
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
GRANITE, ZAMBA = "granite-moe-1b-a400m", "zamba2-2.7b"
XLSTM, WHISPER = "xlstm-350m", "whisper-medium"
CFGS = {"granite": (GRANITE, {}),
        # a routing group of 128 tokens: 8 x 15 tokens fill one group,
        # where the default 64 does not divide them
        "granite-g128": (GRANITE, {"moe_group": 128}),
        "zamba": (ZAMBA, {}), "xlstm": (XLSTM, {}),
        "whisper": (WHISPER, {}),
        "whisper-v509": (WHISPER, {"vocab": 509})}
FAMILIES = ("granite", "zamba", "xlstm", "whisper")
MESH_M = {"1x2": 2, "2x2": 2, "1x4": 4}
GRAD_CASES = [f"{c}@{m}" for c in FAMILIES for m in MESH_M] + \
    ["whisper-v509@2x2"]
# each family's tolerance of its model-axis file: granite each leaf
# within 1e-3 of its own largest |gradient|, zamba and whisper within
# 1e-3 of the largest over all leaves, xlstm within 1e-4 of it
GRAD_TOL = {GRANITE: ("leaf", 1e-3), ZAMBA: ("all", 1e-3),
            XLSTM: ("all", 1e-4), WHISPER: ("all", 1e-3)}
ODD = ("granite-g128", "zamba", "xlstm", "whisper")
PORT_CASES = GRAD_CASES + [f"{c}@1x2 plain" for c in FAMILIES] + \
    [f"{c}@1x2odd{s}" for c in ODD for s in ("", " plain")]
BATCH, SEQ, ODD_SEQ, STEPS = 8, 16, 15, 3
# one run a family: every strategy and every mesh among them (zero1's
# solver is adamw in both packages, run at a small lr)
TRAJ = [("granite", "phylanx", "2x2", "momentum", 1e-2),
        ("zamba", "zero1", "1x2", "adamw", 1e-5),
        ("xlstm", "horovod", "1x4", "momentum", 1e-2),
        ("whisper", "phylanx", "1x2", "momentum", 1e-2)]
# the trajectories' losses and gradient norms, relative: the families'
# files' (whisper's norm 5e-3: the reference's own drift is 2.1e-3)
TRAJ_RTOL = {GRANITE: {"loss": 5e-4, "grad_norm": 5e-4},
             ZAMBA: {"loss": 5e-4, "grad_norm": 5e-4},
             XLSTM: {"loss": 1e-5, "grad_norm": 1e-5},
             WHISPER: {"loss": 1e-5, "grad_norm": 5e-3}}
CASES = [f"{c}:{n}@{m}" for c, n, m, _, _ in TRAJ]
# whisper's gradient cases scale every attention's wq after the
# reference's init, as chip_smoke.py's float32 runs of the family do: that
# init gives its attention logits a std near 64, a softmax saturated to
# one key whose winner float32 rounding flips, so that one process of
# the port lies 1.3e-3 of the largest |gradient| from one device of the
# reference on these inputs, beyond the family's 1e-3, before any mesh
WHISPER_WQ_SCALE = 1 / 8

_REF = textwrap.dedent("""
    import dataclasses, json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.core import steps as S
    from repro.core.sharding import (default_rules, init_params,
                                     param_shardings, set_act_hook)
    from repro.data.pipeline import stream_for
    from repro.launch.mesh import make_local_mesh
    from repro.models.model import build_model
    from repro.optim.optimizers import OptConfig
    spec = json.loads(sys.stdin.read())
    def cfg_of(key):
        arch, over = spec["cfgs"][key]
        return dataclasses.replace(get_config(arch, tiny=True), **over)
    rules = default_rules(sequence_parallel=True)
    out = {"grads": {}}
    for key in spec["grads"]:
        c, M, ndp = key.split("/")
        M, ndp = int(M), int(ndp)
        cfg = cfg_of(c)
        model = build_model(cfg)
        specs = model.specs()
        mesh = make_local_mesh(model=M)
        sh = param_shardings(specs, mesh, rules)
        with np.load(spec["grad_params"][c]) as z:
            params = jax.tree.unflatten(
                jax.tree.structure(init_params(specs, jax.random.PRNGKey(0))),
                [jnp.asarray(z[f"arr_{i}"]) for i in range(len(z.files))])
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
        path = os.path.join(spec["tmp"], f"grads-{c}-{M}-{ndp}.npz")
        np.savez(path, *[np.asarray(x) for x in jax.tree.leaves(g)])
        out["grads"][key] = {"loss": float(loss), "path": path}
    meshes = {"2x2": make_local_mesh(data=2, model=2),
              "1x4": make_local_mesh(model=4),
              "1x2": make_local_mesh(model=2)}
    shape = {"seq_len": spec["seq"], "global_batch": spec["batch_size"],
             "kind": "train"}
    for case in spec["cases"]:
        cfg = cfg_of(case["cfg"])
        step = S.make_train_step(cfg, meshes[case["mesh"]], S.Strategy(
            name=case["name"], opt=OptConfig(kind=case["opt"], lr=case["lr"]),
            sequence_parallel=True), shape)
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


def _batch(key: str, seq: int) -> dict:
    cfg = _cfg(key)
    rng = np.random.default_rng(5)
    out = {n: rng.integers(0, cfg.vocab, (BATCH, seq)).astype(np.int32)
           for n in ("tokens", "labels")}
    if cfg.family == "encdec":
        frames = cfg.enc_frames if seq == SEQ else seq
        out["frames"] = rng.standard_normal(
            (BATCH, frames, cfg.d_model)).astype(np.float32)
    return out


def _drawn(params: dict) -> dict:
    """``params`` with every leaf that holds one value (the zero or one
    init of a bias, a norm, ``b_i``, ``b_f``, ``skip``) drawn around it
    from a seeded normal, so that its gradient is exercised (a part
    summed twice, or not at all, shows), as
    ``tests/test_torch_model_axis_xlstm_encdec.py`` draws them."""
    rng = np.random.default_rng(0)

    def one(a):
        if np.all(a == a.flat[0]):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree.map(one, params)


def _scale_wq(tree, factor: float):
    """``tree`` with every attention's ``wq`` (a dict holding ``wq`` and
    ``wo``) times ``factor``."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _scale_wq(v, factor) for k, v in tree.items()}
    if "wq" in tree and "wo" in tree:
        out["wq"] = (tree["wq"] * factor).astype(np.float32)
    return out


def _ref_key(case: str) -> str:
    """The reference's gradient case of a port case ``cfg@mesh``: the
    model size and the number of dp shards averaged (granite's aux loss
    is not linear in the batch; the other families' losses are token
    means of equal shards, which the whole batch gives)."""
    c, m = case.split("@")
    ndp = 2 if m == "2x2" and c.startswith("granite") else 1
    return f"{c}/{MESH_M[m]}/{ndp}"


def _reference(spec, cases, grads):
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", _REF], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    proc.stdin.write(json.dumps(dict(spec, cases=cases, grads=grads)))
    proc.stdin.close()
    return proc, err


def _result(proc, err) -> dict:
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
    """The reference's two subprocesses and the port's world, at once."""
    tmp = tmp_path_factory.mktemp("seq_parallel_families")
    params = {}
    for k, (arch, over) in CFGS.items():
        cfg = dataclasses.replace(jax_get_config(arch, tiny=True), **over)
        params[k] = jax.tree.map(np.asarray, jax_init_params(
            jax_build_model(cfg).specs(), jax.random.PRNGKey(0)))
    grad_params = {k: _drawn(v) for k, v in params.items()}
    for k in ("whisper", "whisper-v509"):
        grad_params[k] = _scale_wq(grad_params[k], WHISPER_WQ_SCALE)
    grad_paths = {}
    for k, v in grad_params.items():
        grad_paths[k] = str(tmp / f"grad-params-{k}.npz")
        np.savez(grad_paths[k], *jax.tree.leaves(v))
    batch = {k: _batch(k, SEQ) for k in CFGS}
    odd = {k: _batch(k, ODD_SEQ) for k in CFGS}
    paths = {}
    for k, b in batch.items():
        paths[k] = str(tmp / f"batch-{k}.npz")
        np.savez(paths[k], **b)
    cases = [{"key": f"{c}:{name}@{m}", "cfg": c, "name": name, "mesh": m,
              "opt": kind, "lr": lr, "batch": BATCH, "seq": SEQ,
              "steps": STEPS} for c, name, m, kind, lr in TRAJ]
    spec = {"cfgs": CFGS, "tmp": str(tmp), "batch": paths,
            "grad_params": grad_paths,
            "batch_size": BATCH, "seq": SEQ, "steps": STEPS}
    grads = sorted({_ref_key(c) for c in GRAD_CASES})
    # the two processes about even by time (a jit of the trajectories'
    # step or of a gradient about as long): the trajectories and three
    # gradients on one, the other gradients on the other
    procs = [_reference(spec, cases, grads[:3]),
             _reference(spec, [], grads[3:])]
    world: dict = {}
    try:
        world["ranks"] = run_world("seq_parallel_families", 4, {
            "cfgs": CFGS, "params": params, "grad_params": grad_params,
            "batch": batch, "odd": odd,
            "grad_cases": PORT_CASES, "cases": cases})
    finally:
        ref: dict = {"grads": {}}
        for p in procs:
            got = _result(*p)
            ref["grads"].update(got.pop("grads"))
            ref.update(got)
    return {"ref": ref, "ranks": world["ranks"]}


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got: list, want: list, arch: str) -> None:
    over, tol = GRAD_TOL[arch]
    scale = max(np.abs(x).max() for x in want)
    assert [x.shape for x in got] == [x.shape for x in want]
    for i, (g, w) in enumerate(zip(got, want)):
        own = np.abs(w).max() if over == "leaf" else scale
        np.testing.assert_allclose(g, w, atol=tol * own, rtol=0,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_loss_and_every_gradient_match_jax_with_sp(runs, case):
    ref = runs["ref"]["grads"][_ref_key(case)]
    got = runs["ranks"][0]["grads"][case]
    key = case.split("@")[0]
    if key != "whisper-v509":
        assert got["seq"] == SEQ           # the residual split by sequence
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    with np.load(ref["path"]) as z:
        want = [z[f"arr_{i}"] for i in range(len(z.files))]
    _close(_leaves(got["grads"]), want, CFGS[key][0])
    for other in runs["ranks"][1:]:
        if case in other["grads"]:
            assert other["grads"][case]["digests"] == got["digests"]
            assert other["grads"][case]["loss"] == got["loss"]


@pytest.mark.parametrize("family", FAMILIES)
def test_sp_equals_the_model_axis_without_it(runs, family):
    sp = runs["ranks"][0]["grads"][f"{family}@1x2"]
    plain = runs["ranks"][0]["grads"][f"{family}@1x2 plain"]
    assert sp["seq"] == SEQ and plain["seq"] is None
    np.testing.assert_allclose(sp["loss"], plain["loss"], rtol=1e-5)
    _close(_leaves(sp["grads"]), _leaves(plain["grads"]),
           CFGS[family][0])


@pytest.mark.parametrize("key", ODD)
def test_indivisible_sequence_takes_the_plain_path(runs, key):
    """15 tokens (and frames) do not divide the model axis of 2: the step
    with sequence parallelism is the step without it, bit for bit."""
    sp = runs["ranks"][0]["grads"][f"{key}@1x2odd"]
    plain = runs["ranks"][0]["grads"][f"{key}@1x2odd plain"]
    assert sp["seq"] is None
    assert sp["loss"] == plain["loss"]
    assert sp["digests"] == plain["digests"]


def test_odd_vocab_keeps_the_decoder_whole_while_the_encoder_splits(runs):
    """whisper with a vocab of 509: no split of the decoder's tokens
    (``residual_seq``), while the encoder's 16 frames split (its hook,
    ``residual_hook``); the gradients are held above."""
    assert runs["ranks"][0]["grads"]["whisper-v509@2x2"]["seq"] is None
    cfg = _cfg("whisper-v509")
    mesh = Mesh(shape={"data": 1, "model": 2},
                coords={"data": 0, "model": 1})
    rules = default_rules(sequence_parallel=True)
    b = {"tokens": torch.zeros(2, SEQ, dtype=torch.long)}
    assert steps.residual_seq(cfg, mesh, rules, b) is None
    assert steps.residual_seq(_cfg("whisper"), mesh, rules, b) == SEQ
    with act_hook(mesh, rules, seq_len=None):
        assert not model_axis().seq
        with residual_hook(cfg.enc_frames) as ax:
            assert ax.seq and ax.seq_block == slice(8, 16)
        with residual_hook(ODD_SEQ) as ax:
            assert not ax.seq
        assert not model_axis().seq
    step = steps.make_train_step(
        cfg, steps.Strategy(sequence_parallel=True), mesh=mesh)
    mask = step.model.partial_mask(step.specs, ModelAxis(mesh, rules))
    # the encoder's unsplit leaves saw a rank's frames: parts to sum; the
    # decoder's norms and embedding did not
    assert mask["ln_enc"]["w"] and mask["enc_stack"][0]["ln_attn"]["w"]
    assert not mask["ln_f"]["w"] and not mask["embed"]["tok"]
    assert not mask["dec_stack"][0]["ln_attn"]["w"]


@pytest.mark.parametrize("case", CASES)
def test_strategy_matches_reference_with_sp(runs, case):
    want = runs["ref"][case]
    got = runs["ranks"][0]["cases"][case]
    tol = TRAJ_RTOL[CFGS[case.split(":")[0]][0]]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=tol[k],
                                   err_msg=f"{case} {k}")
    for r in runs["ranks"][1:]:
        if case in r["cases"]:
            assert r["cases"][case]["loss"] == got["loss"]
            assert r["cases"][case]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("case", CASES)
def test_unsplit_leaves_bit_identical_with_sp(runs, case):
    """Every leaf that no rule splits (the norms, and each family's
    unsplit projections) holds the same bits on every rank after every
    step: a part summed twice, or not at all, shows here."""
    base = runs["ranks"][0]["cases"][case]["replicated"]
    assert len(base) == STEPS and len(base[0]) >= 3
    ranks = [r for r in runs["ranks"] if case in r["cases"]]
    assert len(ranks) == (2 if case.endswith("1x2") else 4)
    for r in ranks[1:]:
        assert r["cases"][case]["replicated"] == base
