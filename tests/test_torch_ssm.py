"""The port's Mamba-2 mixer against the JAX package's: the causal conv,
the chunked prefill with its final state, and decode steps rolled from
that state, at float32 on the same numpy parameters and inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sharding import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro_torch.models import ssm

ATOL = 1e-4


class _Cfg:
    d_model = 64
    expand = 2
    ssm_head_dim = 16
    ssm_state = 8
    ssm_groups = 1
    ssm_d_conv = 4


def _params(cfg, seed=0):
    """JAX-initialized Mamba-2 parameters with the zero/one-initialized
    leaves drawn at random, so that they are exercised; numpy float32."""
    specs = jax_ssm.mamba2_specs(cfg.d_model, expand=cfg.expand,
                                 head_dim=cfg.ssm_head_dim,
                                 state=cfg.ssm_state, n_groups=cfg.ssm_groups,
                                 d_conv=cfg.ssm_d_conv)
    p = jax.tree.map(lambda a: np.array(a, np.float32),
                     jax_init_params(specs, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "A_log", "D", "dt_bias", "norm_w"):
        p[k] = p[k] + 0.3 * rng.standard_normal(p[k].shape).astype(np.float32)
    return p


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_jax(with_cache):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    cache = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_cache else None
    jy, jc = jax_ssm.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        cache=None if cache is None else jnp.asarray(cache))
    y, c = ssm.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        cache=None if cache is None else torch.from_numpy(cache))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    if with_cache:
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    else:
        assert c is None and jc is None


def test_chunked_prefill_and_rolled_steps_match_jax():
    cfg = _Cfg()
    p = _params(cfg)
    rng = np.random.default_rng(2)
    x = 0.5 * rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jy, jst = jax_ssm.mamba2_chunked(jnp.asarray(x), _j(p), cfg, chunk=16,
                                     return_state=True)
    y, st = ssm.mamba2_chunked(torch.from_numpy(x), _t(p), cfg, chunk=16,
                               return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].shape == (2, cfg.ssm_d_conv - 1, 2 * 64 + 2 * 8)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=ATOL, rtol=ATOL)
    for t in range(8):
        xt = 0.5 * rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jax_ssm.mamba2_step(jnp.asarray(xt), jst, _j(p), cfg)
        y, st = ssm.mamba2_step(torch.from_numpy(xt), st, _t(p), cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {t}")
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=ATOL, rtol=ATOL)


def test_steps_from_zero_state_equal_the_chunked_pass():
    cfg = _Cfg()
    p = _t(_params(cfg, seed=3))
    x = 0.5 * torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    y_par, st_par = ssm.mamba2_chunked(x, p, cfg, chunk=8, return_state=True)
    st = ssm.mamba2_init_state(2, cfg)
    ys = []
    for t in range(x.shape[1]):
        y, st = ssm.mamba2_step(x[:, t:t + 1], st, p, cfg)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_par, atol=2e-4, rtol=2e-3)
    for k in ("ssm", "conv"):
        torch.testing.assert_close(st[k], st_par[k], atol=2e-4, rtol=2e-3)


def test_mamba2_chunk_size_invariance():
    """Mirrors tests/test_ssm.py::test_mamba2_chunk_size_invariance."""
    cfg = _Cfg()
    p = _t(_params(cfg, seed=2))
    x = 0.5 * torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 96, cfg.d_model)).astype(np.float32))
    y1 = ssm.mamba2_chunked(x, p, cfg, chunk=8)
    for chunk in (32, 96, 1024):         # a chunk past L means L
        torch.testing.assert_close(ssm.mamba2_chunked(x, p, cfg, chunk=chunk),
                                   y1, atol=2e-5, rtol=2e-4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.mamba2_chunked(x, p, cfg, chunk=40)
