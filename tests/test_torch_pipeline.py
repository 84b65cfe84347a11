"""GPipe over a stage axis of rank processes against the JAX package.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``'s
``pipeline`` job: ``make_mesh((4,), ("stage",))``) and one JAX
subprocess with 4 host devices, both module-scoped and run at once:

* the reference test's program (S=4 stages of ``tanh(x @ W)``, d=16,
  microbatches of 2) at M = 8, 1 and 2 (M < S): the outputs on every
  rank within 1e-5 and the gradients of ``mean(y ** 2)`` (each stage's
  slice, gathered; and the input's) within 1e-4 of the JAX
  ``make_pipeline_fn``'s, the reference test's tolerances, and of a
  sequential loop's; a rank's gradient of the global stack touches its
  own slice only, and a rank's own slice gives the global stack's
  results;
* a pipeline of tiny qwen3-4b decoder blocks (two ``tblock_apply``
  layers a stage, the reference's init) against the JAX
  ``make_pipeline_fn`` over ``repro.models.blocks.tblock_apply``: the
  outputs within 1e-5 and every stage leaf's gradient within 1e-4 of
  their largest magnitude (the residual grows to about 80 over the 8
  layers);
* ``pipeline_shift``'s backward is the reverse shift;
* the stage mesh's layout, and a stage axis beside other mesh axes
  refused, naming its ROADMAP item.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.models.model import build_model as build_jax_model
from repro_torch.core import pipeline
from repro_torch.launch.mesh import make_mesh
from torch_mesh_world import run_world, seeded
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
S, D, MB = 4, 16, 2
MICRO = (8, 1, 2)
ARCH, LAYERS_PER_STAGE, BLOCK_MICRO, BLOCK_SEQ = "qwen3-4b", 2, 4, 8
OUT_RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-4, 1e-6

_REF = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.core import pipeline
    from repro.launch.mesh import make_mesh
    from repro.models import blocks
    spec = json.loads(sys.stdin.read())
    mesh = make_mesh((len(spec["ws"]),), ("stage",))
    fn = jax.jit(pipeline.make_pipeline_fn(lambda w, x: jnp.tanh(x @ w),
                                           mesh))
    ws = jnp.asarray(np.asarray(spec["ws"], np.float32))
    out = {"gpipe": {}}
    for m, x in spec["micro"].items():
        x = jnp.asarray(np.asarray(x, np.float32))
        loss = lambda w, x: jnp.mean(fn(w, x) ** 2)
        gw, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(ws, x)
        out["gpipe"][m] = {"y": np.asarray(fn(ws, x)).tolist(),
                           "grad": np.asarray(gw).tolist(),
                           "x_grad": np.asarray(gx).tolist()}
    cfg = get_config(spec["arch"], tiny=True)

    def stage_fn(p, x):
        for i in range(spec["layers"]):
            x = blocks.tblock_apply(x, jax.tree.map(lambda a: a[i], p),
                                    cfg)[0]
        return x
    bfn = jax.jit(pipeline.make_pipeline_fn(stage_fn, mesh))
    stack = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                         spec["blocks"], is_leaf=lambda a: isinstance(a, list))
    bx = jnp.asarray(np.asarray(spec["block_x"], np.float32))
    g = jax.jit(jax.grad(lambda p: jnp.mean(bfn(p, bx) ** 2)))(stack)
    out["blocks"] = {"y": np.asarray(bfn(stack, bx)).tolist(),
                     "grads": jax.tree.map(lambda a: np.asarray(a).tolist(),
                                           g)}
    print(json.dumps(out))
""")


def _reference(spec) -> dict:
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _REF], input=json.dumps(spec),
                       env=env, text=True, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _block_stack() -> dict:
    """The reference's init of tiny qwen3-4b at S * LAYERS_PER_STAGE
    layers: its layer stack as ``[S, LAYERS_PER_STAGE, ...]`` leaves."""
    cfg = dataclasses.replace(jax_get_config(ARCH, tiny=True),
                              n_layers=S * LAYERS_PER_STAGE)
    params = jax_init_params(build_jax_model(cfg).specs(),
                             jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda a: np.asarray(a).reshape((S, LAYERS_PER_STAGE) + a.shape[1:]),
        params["stack"])


@pytest.fixture(scope="module")
def runs():
    ws = (seeded((S, D, D), 0) / np.sqrt(D)).astype(np.float32)
    micro = {m: seeded((m, MB, D), 10 + m) for m in MICRO}
    stack = _block_stack()
    bx = seeded((BLOCK_MICRO, 2, BLOCK_SEQ,
                 jax_get_config(ARCH, tiny=True).d_model), 3)
    spec = {"ws": ws.tolist(), "arch": ARCH, "layers": LAYERS_PER_STAGE,
            "micro": {str(m): x.tolist() for m, x in micro.items()},
            "blocks": jax.tree.map(lambda a: a.tolist(), stack),
            "block_x": bx.tolist()}
    ref: dict = {}
    t = threading.Thread(target=lambda: ref.update(_reference(spec)))
    t.start()
    try:
        ranks = run_world("pipeline", S, {
            "ws": ws, "micro": micro, "blocks": stack, "block_x": bx,
            "arch": ARCH})
    finally:
        t.join()
    return {"ref": ref, "ranks": ranks}


def test_stage_mesh_layout(runs):
    for r, out in enumerate(runs["ranks"]):
        lay = out["layout"]
        assert lay["coords"] == {"stage": r}
        assert list(lay["stage_ranks"]) == list(range(S))
        assert lay["shape"] == {"stage": S}


@pytest.mark.parametrize("m", MICRO)
def test_gpipe_matches_jax_make_pipeline_fn(runs, m):
    want = runs["ref"]["gpipe"][str(m)]
    for out in runs["ranks"]:
        got = out["gpipe"][m]
        np.testing.assert_allclose(got["y"], np.asarray(want["y"]),
                                   rtol=OUT_RTOL, atol=ATOL)
        np.testing.assert_allclose(got["grad"], np.asarray(want["grad"]),
                                   rtol=GRAD_RTOL, atol=ATOL)
        np.testing.assert_allclose(got["x_grad"],
                                   np.asarray(want["x_grad"]),
                                   rtol=GRAD_RTOL, atol=ATOL)


@pytest.mark.parametrize("m", MICRO)
def test_gpipe_matches_the_sequential_loop(runs, m):
    """The cotangent of the closing broadcast reaches the last stage
    once: summed over the stage group, every gradient would be S times
    the loop's while the outputs still agreed."""
    for out in runs["ranks"]:
        got = out["gpipe"][m]
        np.testing.assert_allclose(got["y"], got["seq_y"], rtol=OUT_RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["grad"], got["seq_grad"],
                                   rtol=GRAD_RTOL, atol=ATOL)
        np.testing.assert_allclose(got["x_grad"], got["seq_x_grad"],
                                   rtol=GRAD_RTOL, atol=ATOL)
        assert got["others_zero"]
    ys = [out["gpipe"][m]["y"] for out in runs["ranks"]]
    for y in ys[1:]:
        np.testing.assert_array_equal(y, ys[0])


def test_own_slice_is_the_global_stack(runs):
    for out in runs["ranks"]:
        own, whole = out["own_slice"], out["gpipe"][MICRO[0]]
        for k in ("y", "grad", "x_grad"):
            np.testing.assert_array_equal(own[k], whole[k])


def test_decoder_block_pipeline_matches_jax(runs):
    want = runs["ref"]["blocks"]
    got = runs["ranks"][0]["blocks"]
    y = np.asarray(want["y"])
    np.testing.assert_allclose(got["y"], y, rtol=0,
                               atol=OUT_RTOL * np.abs(y).max())
    w_leaves = [np.asarray(x) for x in jax.tree.leaves(
        want["grads"], is_leaf=lambda a: isinstance(a, list))]
    g_leaves = [np.asarray(x) for x in jax.tree.leaves(got["grads"])]
    assert [g.shape for g in g_leaves] == [w.shape for w in w_leaves]
    scale = max(np.abs(w).max() for w in w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=f"leaf {i}")
    for out in runs["ranks"][1:]:
        np.testing.assert_array_equal(out["blocks"]["y"], got["y"])


def test_pipeline_shift_backward_is_the_reverse_shift(runs):
    """Rank r's value goes to r + 1; the gradient rank r + 1 holds comes
    back to r."""
    for r, out in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(out["shift"]["y"],
                                      seeded((3, 5), 40 + (r - 1) % S))
        np.testing.assert_array_equal(out["shift"]["grad"],
                                      seeded((3, 5), 50 + (r + 1) % S))


def test_bubble_fraction():
    assert pipeline.bubble_fraction(4, 12) == 3 / 15
    assert pipeline.bubble_fraction(2, 4) == 1 / 5
    assert pipeline.bubble_fraction(1, 8) == 0


@pytest.mark.parametrize("shape, axes", [
    ((2, 2), ("data", "stage")),
    ((2, 2), ("stage", "model")),
])
def test_stage_axis_beside_other_axes_names_its_item(shape, axes):
    with pytest.raises(NotImplementedError, match="item 14b, part 7"):
        make_mesh(shape, axes)
