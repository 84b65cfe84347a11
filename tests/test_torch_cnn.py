"""The paper's HAR CNN in the port against the JAX package's
(``repro/models/cnn.py``): the forward, the loss and every gradient on
the same parameters and the same HARStream batch, in float32 at the
reference's width 64; the stream itself array for array."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sharding import init_params as jax_init_params
from repro.data.pipeline import HARStream as JaxHARStream
from repro.models import cnn as jcnn
from repro_torch.bridge import cnn_params_from_numpy
from repro_torch.core.sharding import init_params
from repro_torch.data.pipeline import HARStream, to_device
from repro_torch.models import cnn
import torch_threads

torch_threads.apply()

# float32 on both sides; the convolutions sum in other orders
ATOL = RTOL = 1e-5
GRAD_TOL = 1e-5          # of each leaf's largest |gradient|
BATCH = 32


def _jax_params(seed=0, width=64):
    jp = jax_init_params(jcnn.har_cnn_specs(width=width),
                         jax.random.PRNGKey(seed))
    # the biases start at zero: draw them, so that their use is exercised
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) if np.any(np.asarray(a)) else
        (0.1 * rng.standard_normal(a.shape)).astype(np.float32), jp)


@pytest.mark.parametrize("step", [0, 5])
def test_har_stream_equals_the_jax_packages(step):
    mine = HARStream(batch=BATCH, seed=2).batch_at(step)
    want = JaxHARStream(batch=BATCH, seed=2).batch_at(step)
    assert mine.keys() == want.keys()
    for k in mine:
        assert mine[k].dtype == want[k].dtype
        np.testing.assert_array_equal(mine[k], want[k])


def test_specs_equal_the_jax_packages():
    mine, ref = cnn.har_cnn_specs(), jcnn.har_cnn_specs()
    assert mine.keys() == ref.keys()
    for layer in ref:
        for k, s in ref[layer].items():
            m = mine[layer][k]
            assert (m.shape, m.dims, m.init, m.scale) == \
                (s.shape, s.dims, s.init, s.scale), (layer, k)
    p = init_params(mine, torch.Generator().manual_seed(0), "cpu")
    assert p["conv1"]["w"].shape == (3, 9, 64)


def test_forward_matches_jax():
    tree = _jax_params()
    x = HARStream(batch=BATCH).batch_at(1)["x"]
    want = jcnn.har_cnn_forward(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x))
    got = cnn.har_cnn_forward(cnn_params_from_numpy(tree, "cpu"),
                              torch.from_numpy(x))
    assert got.shape == (BATCH, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("width", [64, 16])
def test_loss_and_gradients_match_jax(width):
    tree = _jax_params(seed=1, width=width)
    batch = HARStream(batch=BATCH, seed=3).batch_at(0)
    jloss, jgrads = jax.value_and_grad(jcnn.har_cnn_loss)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    params = cnn_params_from_numpy(tree, "cpu")
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_(True)
    loss = cnn.har_cnn_loss(params, to_device(batch, "cpu"))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=ATOL, rtol=RTOL)
    for layer, leaves in jgrads.items():
        for k, want in leaves.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                params[layer][k].grad.numpy(), want, rtol=0,
                atol=GRAD_TOL * np.abs(want).max(), err_msg=f"{layer}/{k}")
