"""The model axis beyond the dense family: granite-moe-1b-a400m with its
experts on ``model`` and zamba2-2.7b with ``inner`` and ``heads`` on
``model``, against the JAX package on the same mesh.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``'s
``model_axis_families`` job), the port's ``Plan(model=M)`` sessions and
one JAX subprocess with 4 host devices, all run at once; every model
starts from the reference's init (``PRNGKey(0)``, carried by
``bridge``):

* every parameter leaf's local shape, and every decode-state leaf's
  (the mamba ``ssm`` state by heads, its ``conv`` state by a contiguous
  block of the conv channels), is the JAX ``shard_shape`` at ``model`` 2
  and 4 (no world needed);
* the loss and every leaf's gradient, gathered, at ``data=2, model=2``
  and ``data=1, model=4`` (at ``data=2`` each dp shard's loss averaged,
  as the reference's train step takes it): granite (both dispatch
  engines; an odd vocab of 509 that stays whole, as full granite's
  49,155 does; at ``model=4`` its 2 kv heads stay whole, and 2 experts
  split by their ``d_ff`` instead) each leaf
  within 1e-3 of its own largest |gradient| (``GRAD_TOL``: the
  reference's own granite gradients move by 2.2e-4 of their largest
  from one device to ``model=4``), tiny zamba (and with
  ``ssm_groups=2``, and with 5 heads that no axis divides) within 1e-3
  of the largest, its stated conditioning;
* 4 phylanx, horovod and zero1 steps against the reference's
  ``make_train_step`` on the same mesh (``TRAJ``), every leaf that no
  rule splits bit-identical on every rank after every step;
* ``gather_from_model`` and ``sum_over_model`` forward and backward
  against their plain versions;
* ``Session.serve``'s tokens and first logits, and ``serve_stream``'s
  streams and counters, at ``model=2`` and at ``data=2, model=2``.
"""
import json
import os
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

ROOT = Path(__file__).resolve().parents[1]
GRANITE, ZAMBA = "granite-moe-1b-a400m", "zamba2-2.7b"
# (arch, overrides) by key
CFGS = {"granite": (GRANITE, {}),
        "granite-sort": (GRANITE, {"moe_dispatch": "sort"}),
        "granite-v509": (GRANITE, {"vocab": 509}),
        # 2 experts, which a model axis of 4 does not divide: each rank
        # holds every expert and its d_ff columns, and its own router
        "granite-e2": (GRANITE, {"n_experts": 2}),
        "zamba": (ZAMBA, {}),
        "zamba-g2": (ZAMBA, {"ssm_groups": 2}),
        # d_in 160: 5 heads, which no model axis of 2 or 4 divides, beside
        # 192 conv channels and d_in, which split, and 357 fused in_proj
        # columns, which do not: every rank computes the whole layer
        "zamba-h5": (ZAMBA, {"d_model": 80})}
SHAPE_CFGS = ("granite", "zamba", "zamba-g2", "zamba-h5")
GRAD_CASES = ["granite@2x2", "granite@1x4", "granite-sort@1x4",
              "granite-v509@2x2", "granite-e2@1x4", "zamba@2x2",
              "zamba@1x4", "zamba-g2@1x4", "zamba-h5@2x2"]
# granite: each leaf's gradient within 1e-3 of its own largest |gradient|
# (the reference's own granite gradients move by 2.2e-4 of their largest,
# and by up to 2.6e-4 of a leaf's own, from one device to model=4:
# tools/model_axis_families_check.py jax-self; so 1e-5 of the largest
# cannot hold against either); tiny zamba: within
# 1e-3 of the largest over all leaves, its stated conditioning (ROADMAP
# section 3; its A_log's gradient, 1/1000 of the largest, lies 1.4e-3 of
# its own from the reference's in one process)
GRAD_TOL = {GRANITE: ("leaf", 1e-3), ZAMBA: ("all", 1e-3)}
BATCH, SEQ, STEPS = 8, 16, 4
# (cfg, strategy, mesh, optimizer, lr): each strategy of each family on
# one of the meshes, with momentum where the strategy takes it (zero1's
# solver is adamw in both packages, run at a small lr).  adamw's
# normalized step turns near-zero gradients' sign differences into whole
# +-lr steps (tiny zamba's float32 conditioning, tests/test_torch_train.py;
# granite's embedding gradient, which moves by 2.2e-4 of the largest
# from one device to model=4 within the reference itself), and a routed
# token then picks other experts: at lr 1e-3 the reference's own
# trajectories part within four steps
TRAJ = [("granite", "phylanx", "2x2", "momentum", 1e-2),
        ("granite", "horovod", "1x4", "momentum", 1e-2),
        ("granite", "zero1", "2x2", "adamw", 1e-5),
        ("zamba", "phylanx", "1x4", "momentum", 1e-2),
        ("zamba", "horovod", "2x2", "momentum", 1e-2),
        ("zamba", "zero1", "1x4", "adamw", 1e-5)]
# the trajectories' losses and gradient norms, relative
TRAJ_RTOL = 5e-4
CASES = [f"{c}:{n}@{m}" for c, n, m, _, _ in TRAJ]
CACHE = {"seq_len": 24, "global_batch": 2}
MESHES = {"model2": dict(model=2), "data2-model2": dict(data=2, model=2)}
SERVE = dict(requests=3, prompt_len=12, gen_len=4, slots=2)
STREAM = dict(prompt_len=12, gen_len=4, slots=2)
ARRIVALS = (0, 0, 1, 3)
CELLS = [f"{a}/{m}" for a in ("granite", "zamba") for m in MESHES]

_REF = textwrap.dedent("""
    import dataclasses, json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.core import steps as S
    from repro.core.sharding import (default_rules, init_params,
                                     param_shardings, set_act_hook)
    from repro.data.pipeline import LMStream
    from repro.frontend import Plan
    from repro.launch.mesh import make_local_mesh
    from repro.models.model import build_model
    from repro.optim.optimizers import OptConfig
    import time
    spec = json.loads(sys.stdin.read())
    T0 = time.time()
    def lap(what):
        print(f"{what} {time.time() - T0:.1f}", file=sys.stderr, flush=True)
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
        for arch in spec["serve_archs"]:
            for name, mesh in spec["meshes"].items():
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
                    out["serve"][f"{arch}/{name}"] = {
                        "tokens": [np.stack(w, 1).tolist() for w in waves],
                        "first": first[0].tolist()}
                    got = s.serve_stream(verbose=False, trace=spec["trace"],
                                         **spec["stream"])
                    out["stream"][f"{arch}/{name}"] = {
                        "streams": got["streams"],
                        "status": {h.rid: h.status for h in got["handles"]},
                        "serve": got["runtime_stats"]["serve"],
                        "cache": got["cache"],
                        **{k: got[k] for k in ("completed", "rounds", "epochs",
                                               "tokens", "padded_tokens")}}
        lap("serve")
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
            # the train step's math: each dp shard's loss (a moe layer's aux
            # loss is not linear in the batch), averaged over the dp axis
            ndp = 2 if m == "2x2" else 1
            mesh, rules = make_local_mesh(model=4 // ndp), default_rules()
            sh = param_shardings(specs, mesh, rules)
            params = jax.device_put(init_params(specs, jax.random.PRNGKey(0)), sh)
            batch = {k: jnp.asarray(np.asarray(v, np.int32))
                     for k, v in spec["batch"][c].items()}
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
        lap("grads")
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
        stream = LMStream(vocab=cfg.vocab, batch=spec["batch_size"],
                          seq=spec["seq"], seed=0)
        ls, gs = [], []
        for it in range(spec["steps"]):
            b = {k: jax.device_put(v, step.batch_shardings[k])
                 for k, v in stream.batch_at(it).items()}
            mt, params, opt = step.fn(params, opt, b)
            ls.append(float(mt["loss"]))
            gs.append(float(mt["grad_norm"]))
        out[case["key"]] = {"loss": ls, "grad_norm": gs}
        lap(case["key"])
    print(json.dumps(out))
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


def _jax_params(key: str) -> dict:
    import dataclasses
    arch, over = CFGS[key]
    cfg = dataclasses.replace(jax_get_config(arch, tiny=True), **over)
    return jax.tree.map(np.asarray, jax_init_params(
        jax_build_model(cfg).specs(), jax.random.PRNGKey(0)))


def _serve_port(paths: dict) -> dict:
    """The port's ``Session.serve`` and ``serve_stream`` of every cell,
    on the reference's serve parameters."""
    torch.set_num_threads(1)
    trace = [{"at_round": r} for r in ARRIVALS]
    out: dict = {"serve": {}, "stream": {}}
    for key in ("granite", "zamba"):
        arch = CFGS[key][0]
        for name, mesh in MESHES.items():
            with Plan(arch=arch, device="cpu", **mesh).compile() as s:
                s._serve_params = _tree(paths[arch])
                out["serve"][f"{key}/{name}"] = s.serve(verbose=False,
                                                        **SERVE)
                out["stream"][f"{key}/{name}"] = s.serve_stream(
                    verbose=False, trace=trace, **STREAM)
    return out


def _reference(spec, part: str):
    """A JAX subprocess with 4 host devices running ``part`` of the
    reference's side (``serve``: the serve parameters, the serve cells,
    the local shapes; ``train``: the gradients and the trajectories), and
    the file its stderr goes to."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
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
    tmp = tmp_path_factory.mktemp("model_axis_families")
    params = {k: _jax_params(k) for k in CFGS}
    batch = {}
    for k, (arch, over) in CFGS.items():
        vocab = over.get("vocab", get_config(arch, tiny=True).vocab)
        rng = np.random.default_rng(5)
        batch[k] = {n: rng.integers(0, vocab, (BATCH, SEQ))
                    for n in ("tokens", "labels")}
    cases = [{"key": f"{c}:{name}@{m}", "cfg": c, "name": name, "mesh": m,
              "opt": kind, "lr": lr, "batch": BATCH, "seq": SEQ,
              "steps": STEPS} for c, name, m, kind, lr in TRAJ]
    # the trajectories split over the two reference processes, about
    # evenly by time: zamba's and granite's zero1 beside the serve cells
    serve_side = [c["cfg"] == "zamba" or c["name"] == "zero1"
                  for c in cases]
    spec = {"cfgs": CFGS, "shape_cfgs": SHAPE_CFGS, "cache": CACHE,
            "grad_cases": GRAD_CASES, "tmp": str(tmp),
            "cases": {"serve": [c for c, x in zip(cases, serve_side) if x],
                      "train": [c for c, x in zip(cases, serve_side)
                                if not x]},
            "batch": {k: {n: v.tolist() for n, v in b.items()}
                      for k, b in batch.items()},
            "batch_size": BATCH, "seq": SEQ, "steps": STEPS,
            "serve_archs": [GRANITE, ZAMBA], "meshes": MESHES,
            "serve": SERVE, "stream": STREAM,
            "trace": [{"at_round": r} for r in ARRIVALS]}
    serve_ref = _reference(spec, "serve")
    train_ref = _reference(spec, "train")
    world: dict = {}

    def run():
        try:
            world["ranks"] = run_world("model_axis_families", 4, {
                "cfgs": CFGS, "params": params, "batch": batch,
                "grad_cases": GRAD_CASES, "cases": cases})
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


def _cfg(key: str):
    import dataclasses
    arch, over = CFGS[key]
    return dataclasses.replace(get_config(arch, tiny=True), **over)


@pytest.mark.parametrize("key", SHAPE_CFGS)
@pytest.mark.parametrize("model", [2, 4])
def test_local_shapes_are_the_reference_tiling(runs, key, model):
    """Every parameter leaf's block and every decode-state leaf's block
    is the JAX ``shard_shape``: the experts (and the router's columns)
    split, the mamba leaves by their contiguous blocks of the fused
    columns and conv channels, the ``ssm`` state by heads."""
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
    over, tol = GRAD_TOL[CFGS[case.split("@")[0]][0]]
    scale = max(np.abs(x).max() for x in want)
    for i, (g, w) in enumerate(zip(leaves, want)):
        own = np.abs(w).max() if over == "leaf" else scale
        np.testing.assert_allclose(g, w, atol=tol * own, rtol=0,
                                   err_msg=f"leaf {i}")
    # every rank gathers the same gradients
    for other in runs["ranks"][1:]:
        o = other["grads"][case]
        assert o["loss"] == got["loss"]
        for a, b in zip(_leaves(o["grads"]), leaves):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_strategy_matches_reference_on_the_mesh(runs, case):
    want = runs["ref"][case]
    got = runs["ranks"][0]["cases"][case]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_RTOL,
                                   err_msg=f"{case} {k}")
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["loss"] == got["loss"]
        assert r["cases"][case]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_are_bit_identical_on_every_rank(runs, case):
    """The leaves no rule splits (norms; granite's embedding at an odd
    vocab; at model=4 its kv projections) hold the same bits on all 4
    ranks after every step: a gradient summed twice, or not at all, over
    a model group shows here."""
    base = runs["ranks"][0]["cases"][case]["replicated"]
    assert len(base) == STEPS and len(base[0]) >= 3
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["replicated"] == base


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_gather_and_sum_pairs_match_their_plain_versions(runs, mesh):
    """``gather_from_model``: the whole tensor forward, this rank's block
    of the gradient backward (no sum); ``sum_over_model``: the sum
    forward and backward."""
    for out in runs["ranks"]:
        p = out["pairs"][mesh]
        for k in ("gather", "gather_grad", "sum", "sum_grad"):
            np.testing.assert_allclose(p[k], p[f"{k}_want"], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_granite_odd_vocab_stays_whole():
    """An odd vocab (509 here, 49,155 at full size) does not divide the
    model axis: the embedding and unembedding stay whole on every rank
    while the experts split."""
    for M in (2, 4):
        mesh = Mesh(shape={"data": 1, "model": M},
                    coords={"data": 0, "model": 0})
        for key, vocab in (("granite-v509", 509), ("granite", None)):
            step = steps.make_train_step(_cfg(key), steps.Strategy(),
                                         mesh=mesh)
            loc = local_specs(step.specs, mesh, step.rules)
            tok = loc["embed"]["tok"].shape[0]
            assert tok == (vocab if vocab else 512 // M)
            assert loc["stack"][0]["moe"]["router"].shape[1] == 4 // M
    full = get_config(GRANITE)
    assert full.vocab % 2 and full.n_experts % 2 == 0


@pytest.mark.parametrize("cell", CELLS)
def test_session_serve_equals_the_references(runs, cell):
    got = runs["port"]["serve"][cell]
    arch = CFGS[cell.split("/")[0]][0]
    want = runs["ref"]["serve"][f"{arch}/{cell.split('/')[1]}"]
    assert [g.tolist() for g in got["generated"]] == want["tokens"]
    first = np.asarray(want["first"], np.float32)
    mine = got["first_prefill_logits"].numpy()
    assert mine.shape == first.shape
    assert np.abs(mine - first).max() <= 1e-5 * np.abs(first).max()
    for loc in got["localities"].values():
        assert loc["tokens"] == got["tokens"]
        assert loc["wire"]["axes"]["model"]["calls"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_serve_stream_equals_the_references(runs, cell):
    got = runs["port"]["stream"][cell]
    arch = CFGS[cell.split("/")[0]][0]
    want = runs["ref"]["stream"][f"{arch}/{cell.split('/')[1]}"]
    assert got["streams"] == want["streams"]
    assert {h.rid: h.status for h in got["handles"]} == want["status"]
    for key in ("completed", "rounds", "epochs", "tokens", "padded_tokens"):
        assert got[key] == want[key], key
    # the pool's high-water marks depend on thread timing, in either
    # package, and a rank's page counts on its share: it parks its blocks
    # of a request's state where the reference parks the whole of it
    paged = ("pages_grown", "pages_reused", "pages_peak", "page_allocs",
             "page_frees")
    assert {k: v for k, v in got["runtime_stats"]["serve"].items()
            if k not in paged} == \
        {k: v for k, v in want["serve"].items() if k not in paged}
    # every rank parked its blocks of a request's state and freed them
    assert got["cache"]["pages_live"] == 0
    for loc in got["localities"].values():
        assert loc["cache"]["pages_live"] == 0
        assert loc["request_bytes"] == got["request_bytes"]
