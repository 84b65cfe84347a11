"""The port's mixture of experts: the six cases of tests/test_moe.py on
the port, its routing and both dispatch engines against the JAX
package's functions on the same inputs, and tiny granite-moe-1b-a400m and
phi3.5-moe-42b-a6.6b against the JAX models in logits, aux loss, loss and
every gradient, under both dispatches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models.model import build_model as build_jax_model
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.sharding import init_params
from repro_torch.data.pipeline import LMStream, to_device
from repro_torch.models import moe
from repro_torch.models.model import build_model

# float32 on both sides; the products sum in other orders
ATOL = RTOL = 1e-5
MOE_ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]


def _params(d=32, ff=64, E=4, seed=0):
    return init_params(moe.moe_specs(d, ff, E),
                       torch.Generator().manual_seed(seed), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- the six cases of tests/test_moe.py ----------------------------------------

def test_sort_and_einsum_dispatch_agree_without_drops():
    d, ff, E, k = 32, 64, 4, 2
    p = _params(d, ff, E)
    x = torch.randn(2, 16, d, generator=torch.Generator().manual_seed(1)) * .5
    y1, a1 = moe.apply_moe(x, p, top_k=k, group_size=32, cap_factor=8.0,
                           dispatch="einsum")
    y2, a2 = moe.apply_moe(x, p, top_k=k, group_size=32, cap_factor=8.0,
                           dispatch="sort")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-5)


def test_dense_equivalence_with_full_capacity_topE():
    d, ff, E = 16, 32, 4
    p = _params(d, ff, E, seed=2)
    x = torch.randn(1, 8, d, generator=torch.Generator().manual_seed(3)) * .5
    y, _ = moe.apply_moe(x, p, top_k=E, group_size=8, cap_factor=E * 2.0,
                         dispatch="einsum")
    w = torch.softmax(x.reshape(-1, d) @ p["router"], -1)
    xin = x.reshape(-1, d)[None].expand(E, 8, d)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xin,
                                              p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xin, p["w_up"])
    yo = torch.einsum("ecf,efd->ecd", h, p["w_down"])
    want = torch.einsum("te,etd->td", w, yo).reshape(1, 8, d)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-3, atol=2e-4)


def test_capacity_drops_tokens_not_crash():
    d, ff, E = 16, 32, 4
    p = _params(d, ff, E, seed=4)
    x = torch.randn(1, 64, d, generator=torch.Generator().manual_seed(5))
    for dispatch in ("einsum", "sort"):
        y, aux = moe.apply_moe(x, p, top_k=2, group_size=64, cap_factor=0.1,
                               dispatch=dispatch)
        assert bool(torch.isfinite(y).all())
        assert float(y.abs().mean()) < float(x.abs().mean()) * 10
        assert np.isfinite(float(aux))


def test_capacity_rounding():
    assert moe.capacity(512, 8, 2, 1.25) == 160
    assert moe.capacity(512, 8, 2, 1.25) % 8 == 0
    assert moe.capacity(8, 64, 1, 1.0) >= 8  # floor


def test_router_weights_normalized():
    g = torch.Generator().manual_seed(6)
    w = torch.randn(16, 8, generator=g)
    x = torch.randn(32, 16, generator=g)
    gw, gi, aux = moe.router_probs(x, w, 2)
    np.testing.assert_allclose(gw.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert int(gi.max()) < 8 and int(gi.min()) >= 0
    assert bool((gi[:, 0] != gi[:, 1]).all())


def test_aux_loss_penalizes_imbalance():
    d, E = 8, 4
    x = torch.randn(256, d, generator=torch.Generator().manual_seed(8)).abs() \
        + 0.1
    w_bal = torch.zeros(d, E)
    for e in range(E):
        w_bal[e, e] = 10.0
    _, gi, aux_b = moe.router_probs(x, w_bal, 1)
    assert int(torch.bincount(gi[:, 0], minlength=E).min()) > 0
    w_collapse = torch.zeros(d, E)
    w_collapse[:, 0] = 10.0
    _, _, aux_c = moe.router_probs(x, w_collapse, 1)
    assert float(aux_c) > float(aux_b) * 1.5
    assert float(aux_c) > 0.9 * E


# -- against the JAX package's functions ---------------------------------------

@pytest.mark.parametrize("args", [(512, 8, 2, 1.25), (2048, 32, 8, 1.25),
                                  (512, 32, 8, 4.0), (4, 32, 8, 1.25),
                                  (8, 64, 1, 1.0), (1000, 16, 2, 0.3)])
def test_capacity_equals_jax(args):
    assert moe.capacity(*args) == jmoe.capacity(*args)


def test_router_probs_equal_jax_ties_included():
    """Weights and aux within ATOL, the same expert ids, ties (equal
    router columns) broken toward the lower id as ``jax.lax.top_k``
    does."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    w[:, 5] = w[:, 2]                      # experts 2 and 5 always tie
    w[:, 7] = w[:, 0]
    jw, ji, jaux = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w), 3)
    gw, gi, aux = moe.router_probs(_t(x), _t(w), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("cap_factor", [1.25, 0.5, 8.0])
def test_dispatch_equals_jax(dispatch, cap_factor):
    """Output and aux of each engine against the JAX engine on the same
    parameters and tokens: at the default capacity, with drops, and with
    none.  Two groups for the einsum engine (its capacity is per group,
    the sort engine's over every token)."""
    d, ff, E, k = 32, 48, 8, 2
    jp = jax_init_params(jmoe.moe_specs(d, ff, E), jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal((2, 32, d)).astype(
        np.float32)
    jy, jaux = jmoe.apply_moe(jnp.asarray(x), jp, top_k=k, group_size=32,
                              cap_factor=cap_factor, dispatch=dispatch)
    p = {n: _t(v) for n, v in jp.items()}
    y, aux = moe.apply_moe(_t(x), p, top_k=k, group_size=32,
                           cap_factor=cap_factor, dispatch=dispatch)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    again, _ = moe.apply_moe(_t(x), p, top_k=k, group_size=32,
                             cap_factor=cap_factor, dispatch=dispatch)
    assert torch.equal(y, again)


def test_drop_semantics_equal_jax():
    """At a capacity that drops most assignments, the same tokens come
    out zero in both packages, per engine."""
    d, ff, E, k = 16, 32, 4, 2
    jp = jax_init_params(jmoe.moe_specs(d, ff, E), jax.random.PRNGKey(5))
    x = np.random.default_rng(6).standard_normal((1, 64, d)).astype(
        np.float32)
    p = {n: _t(v) for n, v in jp.items()}
    for dispatch in ("einsum", "sort"):
        jy, _ = jmoe.apply_moe(jnp.asarray(x), jp, top_k=k, group_size=64,
                               cap_factor=0.1, dispatch=dispatch)
        y, _ = moe.apply_moe(_t(x), p, top_k=k, group_size=64,
                             cap_factor=0.1, dispatch=dispatch)
        jzero = np.all(np.asarray(jy) == 0, axis=-1)
        assert 0 < jzero.sum() < jzero.size
        np.testing.assert_array_equal((y == 0).all(-1).numpy(), jzero)


# -- the models ---------------------------------------------------------------

def _configs(arch, dispatch):
    return (dataclasses.replace(jax_get_config(arch, tiny=True),
                                moe_dispatch=dispatch),
            dataclasses.replace(get_config(arch, tiny=True),
                                moe_dispatch=dispatch))


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_logits_loss_and_gradients_match_jax(arch, dispatch):
    """The training forward's logits within 1e-4 (the logits tolerance of
    test_torch_serve.py: they sum two layers' float32 products in other
    orders), the aux loss within RTOL, the loss within 1e-5, and every
    gradient within 1e-4 of the largest |gradient| (the tolerance of the
    dense ids' test in test_torch_train.py)."""
    jcfg, cfg = _configs(arch, dispatch)
    jmodel = build_jax_model(jcfg)
    jparams = jax_init_params(jmodel.specs(), jax.random.PRNGKey(0))
    batch = LMStream(vocab=cfg.vocab, batch=4, seq=32, seed=3).batch_at(0)
    jb = jax.tree.map(jnp.asarray, batch)
    jlogits, jaux = jmodel.apply(jparams, jb)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, jb)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for t in pytree.tree_leaves(params):
        t.requires_grad_(True)
    model = build_model(cfg)
    tb = to_device(batch, "cpu")
    logits, aux = model.apply(params, tb)
    aux = aux.detach()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    assert float(aux) > 0
    loss = model.loss(params, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    grads = tree_to_numpy(pytree.tree_map(lambda p: p.grad, params))
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    scale = max(float(jnp.abs(g).max()) for _, g in flat)
    for path, want in flat:
        got = grads
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4 * scale,
                                   err_msg=str(path))


def test_moe_remat_gives_identical_loss_and_gradients():
    _, cfg = _configs("granite-moe-1b-a400m", "einsum")
    params = init_params(build_model(cfg).specs(),
                         torch.Generator().manual_seed(0), "cpu")
    batch = to_device(LMStream(vocab=cfg.vocab, batch=4, seq=32,
                               seed=3).batch_at(0), "cpu")
    out = []
    for remat in (False, True):
        ps = pytree.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                             params)
        loss = build_model(dataclasses.replace(cfg, remat=remat)).loss(
            ps, batch)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in pytree.tree_leaves(ps)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
