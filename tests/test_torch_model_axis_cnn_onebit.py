"""The model axis's last two pieces against the JAX package on the same
mesh: the HAR CNN with its channels on ``model``, and onebit at a model
axis > 1.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``'s
``cnn_onebit`` job) and one JAX subprocess with 4 host devices, run at
once; every model starts from the reference's init (``PRNGKey(0)``):

* the HAR CNN's loss and every gradient, gathered, at ``model=2``,
  (a batch of the HAR stream, the biases drawn),
  ``model=4`` and ``data=2, model=2`` (each dp rank's rows, averaged)
  against ``jax.jit(jax.value_and_grad(har_cnn_loss))`` on parameters
  placed by ``param_shardings(har_cnn_specs(), mesh, default_rules())``:
  each within 1e-5 of its leaf's largest |gradient|; each rank holds its
  block of every conv's channels, and the head's gradient holds the
  same bits on every rank;
* onebit's exchange at ``data=2, model=2`` fed the reference's global
  gradient trees (one a dp rank): every bucket's packed words, scales
  and mean byte for byte the reference's (``quantize_bucket`` on the
  global bucket, ``exchange_onebit`` in a ``shard_map`` over a data
  axis of 2 on the global trees: the model axis, automatic in the
  reference's step, does not enter the exchange's math; the installed
  jax 0.4's partial-auto ``shard_map`` refuses this one's out_specs),
  the residual the same bits on a dp
  coordinate's two model ranks, the dp wire the reference's ``size / 8
  + size / 256`` bytes a bucket;
* 3 onebit steps at ``data=2, model=2`` against the reference's
  ``make_train_step`` (the first step's loss and norm within 1e-5, then
  1e-3, as ``tests/test_torch_mesh.py`` holds data-only onebit), the
  residuals bit-identical on a dp coordinate's model ranks and the
  unsplit leaves on all four, and a save and restore of the global
  state after step 2 that resumes bit for bit;
* onebit at ``data=1, model=2``: the plain update, bit for bit
  phylanx's.
"""
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

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.models.cnn import har_cnn_specs as jax_har_cnn_specs
from repro.models.model import build_model as jax_build_model
from repro_torch.data.pipeline import HARStream
from torch_mesh_world import run_world
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARCH, BATCH, SEQ, STEPS, LR = "qwen3-4b", 8, 16, 3, 1e-3
CNN_BATCH = 16
CNN_MESHES = {"1x2": 2, "1x4": 4, "2x2": 2}
# each gradient leaf within CNN_TOL of its own largest |gradient|
CNN_TOL, RTOL, ONEBIT_RTOL = 1e-5, 1e-5, 1e-3
RUNS = [dict(key="onebit@2x2", name="onebit", mesh="2x2", resume_at=2),
        dict(key="onebit@1x2", name="onebit", mesh="1x2"),
        dict(key="phylanx@1x2", name="phylanx", mesh="1x2")]

_REF = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.core import fusion, steps as S
    from repro.core.compat import shard_map
    from repro.core.sharding import default_rules, init_params, param_shardings
    from repro.data.pipeline import stream_for
    from repro.launch.mesh import make_local_mesh, make_mesh
    from repro.models.cnn import har_cnn_loss, har_cnn_specs
    from repro.models.model import build_model
    from repro.optim import compression as C
    from repro.optim.optimizers import OptConfig
    spec = json.loads(sys.stdin.read())
    out = {"cnn": {}}
    with np.load(spec["cnn_batch"]) as z:
        batch = {"x": jnp.asarray(z["x"]), "y": jnp.asarray(z["y"])}
    specs = har_cnn_specs()
    with np.load(spec["cnn_params"]) as z:
        params = jax.tree.unflatten(
            jax.tree.structure(init_params(specs, jax.random.PRNGKey(0))),
            [jnp.asarray(z[f"arr_{i}"]) for i in range(len(z.files))])
    vg = jax.jit(jax.value_and_grad(har_cnn_loss))
    for M in (2, 4):
        sh = param_shardings(specs, make_local_mesh(model=M), default_rules())
        loss, g = vg(jax.device_put(params, sh), batch)
        path = os.path.join(spec["tmp"], f"cnn-{M}.npz")
        np.savez(path, *[np.asarray(x) for x in jax.tree.leaves(g)])
        out["cnn"][M] = {"loss": float(loss), "path": path}
    # onebit's exchange of each dp rank's global gradient tree
    cfg = get_config(spec["arch"], tiny=True)
    p0 = init_params(build_model(cfg).specs(), jax.random.PRNGKey(0))
    grads = []
    for r in range(2):
        rng = np.random.default_rng(100 + r)
        grads.append(jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
            a.shape).astype(np.float32)), p0))
    plan = C.make_plan(jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), p0), 2)
    zero = C.init_error_state(plan)
    arrays = {}
    for r in range(2):
        for i, b in enumerate(fusion.pack(grads[r], plan)):
            w, s, _ = C.quantize_bucket(b, zero[i])
            arrays[f"w{r}_{i}"] = np.asarray(w)
            arrays[f"s{r}_{i}"] = np.asarray(s)

    def body(g):
        mean, _ = C.exchange_onebit(jax.tree.map(lambda x: x[0], g),
                                    C.init_error_state(plan), ("data",), plan)
        return jax.tree.map(lambda x: x[None], mean)
    f = shard_map(body, mesh=make_mesh((2,), ("data",)), in_specs=P("data"),
                  out_specs=P("data"), check_vma=False)
    mean = f(jax.tree.map(lambda a, b: jnp.stack([a, b]), *grads))
    for i, b in enumerate(fusion.pack(jax.tree.map(lambda x: x[0], mean),
                                      plan)):
        arrays[f"mean_{i}"] = np.asarray(b)
    arrays["n"] = np.asarray(len(plan.buckets))
    out["onebit"] = os.path.join(spec["tmp"], "onebit.npz")
    np.savez(out["onebit"], **arrays)
    # onebit at data=2, model=2
    shape = {"seq_len": spec["seq"], "global_batch": spec["batch"],
             "kind": "train"}
    step = S.make_train_step(cfg, make_local_mesh(data=2, model=2),
                             S.Strategy(name="onebit",
                                        opt=OptConfig(lr=spec["lr"])), shape)
    params, opt = step.init(jax.random.PRNGKey(0))
    stream = stream_for(cfg, batch=spec["batch"], seq=spec["seq"], seed=0)
    ls, gs = [], []
    for it in range(spec["steps"]):
        b = {k: jax.device_put(v, step.batch_shardings[k])
             for k, v in stream.batch_at(it).items()}
        m, params, opt = step.fn(params, opt, b)
        ls.append(float(m["loss"]))
        gs.append(float(m["grad_norm"]))
    out["traj"] = {"loss": ls, "grad_norm": gs}
    print(json.dumps(out))
""")


def _reference(spec) -> dict:
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryFile(mode="w+") as err:
        p = subprocess.run([sys.executable, "-c", _REF],
                           input=json.dumps(spec), env=env, text=True,
                           stdout=subprocess.PIPE, stderr=err, timeout=600)
        err.seek(0)
        assert p.returncode == 0, err.read()[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's world, at once."""
    tmp = tmp_path_factory.mktemp("cnn_onebit")
    # the reference's init with the biases drawn (they start at zero), so
    # that a bias added once per rank, or not at all, shows; a batch of
    # the HAR stream, as tests/test_torch_cnn.py holds one process
    rng = np.random.default_rng(0)
    cnn_params = jax.tree.map(
        lambda a: np.asarray(a) if np.any(np.asarray(a)) else
        (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        jax_init_params(jax_har_cnn_specs(), jax.random.PRNGKey(0)))
    cnn_batch = HARStream(batch=CNN_BATCH, seed=3).batch_at(0)
    np.savez(tmp / "cnn_batch.npz", **cnn_batch)
    np.savez(tmp / "cnn_params.npz", *jax.tree.leaves(cnn_params))
    params = jax.tree.map(np.asarray, jax_init_params(
        jax_build_model(jax_get_config(ARCH, tiny=True)).specs(),
        jax.random.PRNGKey(0)))
    grads = []
    for r in range(2):
        g = np.random.default_rng(100 + r)
        grads.append(jax.tree.map(
            lambda a: g.standard_normal(a.shape).astype(np.float32), params))
    spec = {"arch": ARCH, "tmp": str(tmp), "batch": BATCH, "seq": SEQ,
            "steps": STEPS, "lr": LR,
            "cnn_batch": str(tmp / "cnn_batch.npz"),
            "cnn_params": str(tmp / "cnn_params.npz")}
    ref: dict = {}

    def reference():
        try:
            ref.update(_reference(spec))
        except BaseException as e:  # noqa: BLE001 - raised below
            ref["error"] = e
    t = threading.Thread(target=reference)
    t.start()
    try:
        runs_ = [dict(r, opt="adamw", lr=LR, batch=BATCH, seq=SEQ,
                      steps=STEPS) for r in RUNS]
        ranks = run_world("cnn_onebit", 4, {
            "cnn_params": cnn_params, "cnn_batch": cnn_batch, "arch": ARCH,
            "params": params, "onebit_grads": grads, "runs": runs_})
    finally:
        t.join()
    if "error" in ref:
        raise ref["error"]
    return {"ref": ref, "ranks": ranks}


def _npz(path) -> list:
    with np.load(path) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mesh", list(CNN_MESHES))
def test_cnn_loss_and_gradients_match_jax(runs, mesh):
    M = CNN_MESHES[mesh]
    ref = runs["ref"]["cnn"][str(M)]
    got = runs["ranks"][0]["cnn"][mesh]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    want = _npz(ref["path"])
    leaves = _leaves(got["grads"])
    assert [g.shape for g in leaves] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=CNN_TOL * np.abs(w).max(),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("mesh", list(CNN_MESHES))
def test_cnn_channels_split_and_head_bit_identical(runs, mesh):
    """Each rank holds ``64 / M`` of conv1's channels and joined them
    over the model group; the head's gradient (whole on every rank, no
    sum) holds the same bits on every rank of the mesh."""
    M = CNN_MESHES[mesh]
    ranks = [r["cnn"][mesh] for r in runs["ranks"] if mesh in r["cnn"]]
    assert len(ranks) == (2 if mesh == "1x2" else 4)
    for r in ranks:
        assert r["conv1_rows"] == 64 // M
        assert r["model_calls"] > 0
        assert r["head"] == ranks[0]["head"]
        assert r["loss"] == ranks[0]["loss"]


def test_onebit_exchange_is_the_references_byte_for_byte(runs):
    with np.load(runs["ref"]["onebit"]) as z:
        ref = {k: z[k] for k in z.files}
    ex = [r["exchange"] for r in runs["ranks"]]
    n = int(ref["n"])
    assert len(ex[0]["buckets"]) == n
    for i in range(n):
        packed, scales, mean, _ = ex[0]["buckets"][i]
        assert packed.shape[0] == 2               # every dp origin's
        for o in range(2):
            assert packed[o].tobytes() == ref[f"w{o}_{i}"].tobytes()
            assert scales[o].tobytes() == ref[f"s{o}_{i}"].tobytes()
        # the mean's leaves (past them, the padding's decoded rows, which
        # the reference's pack leaves at zero)
        t = ex[0]["totals"][i]
        assert mean[:t].tobytes() == ref[f"mean_{i}"][:t].tobytes()
        # words, scales and mean alike on all four ranks; the residual
        # alike on a dp coordinate's two model ranks (ranks 0, 1 and 2, 3)
        for r in range(4):
            assert ex[r]["digests"][i][:3] == ex[0]["digests"][i][:3]
        assert ex[0]["digests"][i][3] == ex[1]["digests"][i][3]
        assert ex[2]["digests"][i][3] == ex[3]["digests"][i][3]
        assert ex[0]["digests"][i][3] != ex[2]["digests"][i][3]
    # the blocks each rank cut from the mean, gathered: the mean's leaves
    for r in range(4):
        for a, b in zip(_leaves(ex[r]["mean"]), _leaves(ex[0]["mean"])):
            assert a.tobytes() == b.tobytes()


def test_onebit_wire_is_the_references_on_dp(runs):
    """The dp wire a rank is the reference's ``size / 8 + size / 256``
    bytes a bucket; the model axis's gathers of the split leaves are
    counted on their own axis."""
    for r in runs["ranks"]:
        ex = r["exchange"]
        sizes = ex["sizes"]
        assert ex["wire"]["dp"]["bytes"] == sum(s // 8 + s // 256
                                                for s in sizes)
        assert ex["wire"]["dp"]["calls"] == 2 * len(sizes)
        assert ex["wire"]["model"]["bytes"] > 0


def test_onebit_matches_reference_at_data2_model2(runs):
    want = runs["ref"]["traj"]
    got = runs["ranks"][0]["runs"]["onebit@2x2"]
    for k in ("loss", "grad_norm"):
        for it in range(STEPS):
            np.testing.assert_allclose(
                got[k][it], want[k][it],
                rtol=RTOL if it == 0 else ONEBIT_RTOL,
                err_msg=f"step {it} {k}")
    for r in runs["ranks"][1:]:
        assert r["runs"]["onebit@2x2"]["loss"] == got["loss"]


def test_onebit_residuals_and_unsplit_leaves_bit_identical(runs):
    """After every step the residual holds the same bits on a dp
    coordinate's two model ranks (the reference's ``ef``, replicated
    over ``model``), and every unsplit leaf on all four ranks."""
    r = [x["runs"]["onebit@2x2"] for x in runs["ranks"]]
    assert len(r[0]["ef"]) == STEPS and r[0]["ef"][0]
    assert r[0]["ef"] == r[1]["ef"] and r[2]["ef"] == r[3]["ef"]
    assert r[0]["ef"] != r[2]["ef"]
    for x in r[1:]:
        assert x["replicated"] == r[0]["replicated"]


def test_onebit_resumes_bit_identically(runs):
    """The state after step 2 gathered to the reference's global layout
    (``gather_params``, ``gather_opt``: ``ef`` over the dp group), cut
    again by a new step: step 3 gives the straight run's loss and
    parameters bit for bit on every rank."""
    for x in runs["ranks"]:
        r = x["runs"]["onebit@2x2"]
        assert r["resumed"]["loss"] == r["loss"][2:]
        assert r["resumed"]["params"] == r["params"][2:]


def test_onebit_at_data1_is_the_plain_update(runs):
    for x in runs["ranks"][:2]:
        a, b = x["runs"]["onebit@1x2"], x["runs"]["phylanx@1x2"]
        assert a["loss"] == b["loss"]
        assert a["grad_norm"] == b["grad_norm"]
        assert a["params"] == b["params"]
