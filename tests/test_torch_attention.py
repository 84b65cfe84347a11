"""The port's decode attention, cache writes and QKV projection against
the JAX package's, on the same numpy inputs, f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro_torch.models import attention as ta
import torch_threads

torch_threads.apply()

ATOL = 1e-5
B, S, H, HKV, HD = 3, 24, 4, 2, 32


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", [11, [3, 17, 23]])
def test_decode_attend(pos, window):
    q, kc, vc = _arrays(0, (B, 1, H, HD), (B, S, HKV, HD), (B, S, HKV, HD))
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = pos if isinstance(pos, int) else torch.tensor(pos)
    want = ja.decode_attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jpos, window=window)
    got = ta.decode_attend(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), tpos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("mode", ["dus", "masked"])
@pytest.mark.parametrize("pos", [7, [0, 9, 23]])
def test_cache_update(mode, pos):
    kc, vc, kn, vn = _arrays(1, (B, S, HKV, HD), (B, S, HKV, HD),
                             (B, 1, HKV, HD), (B, 1, HKV, HD))
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = pos if isinstance(pos, int) else torch.tensor(pos)
    wk, wv = ja.cache_update(jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(kn), jnp.asarray(vn), jpos,
                             mode=mode)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    gk, gv = ta.cache_update(tk, tv, torch.from_numpy(kn),
                             torch.from_numpy(vn), tpos, mode=mode)
    assert gk is tk and gv is tv            # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_cache_update_rejects_unknown_mode():
    kc, kn = _arrays(2, (B, S, HKV, HD), (B, 1, HKV, HD))
    t = torch.from_numpy
    with pytest.raises(ValueError, match="mode"):
        ta.cache_update(t(kc), t(kc.copy()), t(kn), t(kn), 0, mode="scatter")


@pytest.mark.parametrize("qkv_bias, qk_norm", [(True, False), (False, True)])
def test_project_qkv(qkv_bias, qk_norm):
    d = 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    specs = ta.attn_specs(d, H, HKV, HD, qkv_bias=qkv_bias, qk_norm=qk_norm)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.2
         for k, s in specs.items()}
    pos = rng.integers(0, 100, (2, 9))
    want = ja.project_qkv(jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in p.items()},
                          positions=jnp.asarray(pos), rope_theta=1e6)
    got = ta.project_qkv(torch.from_numpy(x), {k: torch.from_numpy(v)
                                               for k, v in p.items()},
                         positions=torch.from_numpy(pos), rope_theta=1e6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=ATOL)
