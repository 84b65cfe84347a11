"""The port's flash attention (on CPU tensors: its plain version) against
the JAX package's Pallas kernel in interpret mode and its oracle, on the
same numpy inputs.  The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_kernel
from repro.models.attention import attend_full as jax_attend_full
from repro_torch.kernels import flash_attention, flash_attention_ref
from repro_torch.models.attention import attend, attend_full

TOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(B, H, Hkv, S, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, d)).astype(np.float32))


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("B,H,Hkv,S,d", [
    (1, 4, 2, 256, 64),       # shapes that divide 128, GQA 4:2
    (1, 32, 8, 128, 32),      # GQA 32:8 at small S
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_kernel_and_oracle(B, H, Hkv, S, d, dt, causal):
    q, k, v = _qkv(B, H, Hkv, S, d)
    jq, jk, jv = (jnp.asarray(a, JDT[dt]) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == TDT[dt] and got.shape == (B, H, S, d)
    _close(got, jax_kernel(jq, jk, jv, causal=causal, interpret=True), dt)
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=causal), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_dim_80_matches_oracle(dt):
    """zamba2-2.7b's shared block: MHA at head dim 80, ragged S."""
    q, k, v = _qkv(2, 4, 4, 100, 80, seed=4)
    jq, jk, jv = (jnp.asarray(a, JDT[dt]) for a in (q, k, v))
    got = flash_attention(*(torch.from_numpy(a).to(TDT[dt])
                            for a in (q, k, v)), causal=True)
    assert got.shape == (2, 4, 100, 80)
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=True), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_window_128(dt):
    q, k, v = _qkv(1, 2, 2, 512, 64, seed=1)
    jq, jk, jv = (jnp.asarray(a, JDT[dt]) for a in (q, k, v))
    got = flash_attention_ref(*(torch.from_numpy(a).to(TDT[dt])
                                for a in (q, k, v)), causal=True, window=128)
    _close(got, jax_kernel(jq, jk, jv, causal=True, window=128,
                           interpret=True), dt)
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=True,
                                            window=128), dt)


@pytest.mark.parametrize("S", [20, 200])
def test_ragged_seq_matches_attend_full(S):
    """JAX's attend falls back to attend_full when S does not divide the
    chunk; the port's kernel masks the ragged tile itself."""
    q, k, v = _qkv(2, 4, 2, S, 32, seed=2)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)        # noqa: E731
    j = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)      # noqa: E731
    want = jax_attend_full(j(q), j(k), j(v), causal=True)
    got = attend(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(attend_full(t(q), t(k), t(v)).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


def test_falsy_scale_means_default_scale():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 64, 32, seed=3))
    np.testing.assert_array_equal(
        flash_attention(q, k, v, scale=0.0).numpy(),
        flash_attention(q, k, v, scale=1 / np.sqrt(32)).numpy())


@pytest.mark.parametrize("change, err", [
    (dict(d=48), ValueError),                      # head dim not built
    (dict(dtype=torch.float16), TypeError),
    (dict(Hkv=3), ValueError),                     # H not a multiple of Hkv
    (dict(transpose=True), ValueError),            # not contiguous
    (dict(device="meta"), ValueError),
    (dict(window=0), ValueError),                  # every key masked
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err):
    d = change.get("d", 32)
    Hkv = change.get("Hkv", 2)
    dev = change.get("device", "cpu")
    dt = change.get("dtype", torch.float32)
    q = torch.zeros(1, 4, 64, d, dtype=dt, device=dev)
    k = torch.zeros(1, Hkv, 64, d, dtype=dt, device=dev)
    if change.get("transpose"):
        q = torch.zeros(1, 64, 4, d).transpose(1, 2)
    with pytest.raises(err):
        flash_attention(q, k, k.clone(), window=change.get("window"))


@pytest.mark.parametrize("B,H,Hkv,S,d,causal,window", [
    (1, 4, 2, 64, 32, True, None),         # GQA 4:2, causal
    (2, 4, 1, 48, 32, False, None),        # GQA 4:1, non-causal
    (1, 2, 2, 96, 64, True, 16),           # MHA, window
    (1, 8, 2, 40, 128, True, None),        # qwen3-4b's head dim, ragged S
])
def test_backward_of_plain_version_matches_jax_grad(B, H, Hkv, S, d, causal,
                                                    window):
    """On CPU tensors the wrapper is the plain version under autograd; its
    gradients match jax.vjp of the JAX oracle (the CUDA backward kernel is
    held against this plain gradient on the card by chip_smoke.py)."""
    q, k, v = _qkv(B, H, Hkv, S, d, seed=5)
    dout = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)
    want = jax.jit(lambda a, b, c, g: jax.vjp(
        lambda a, b, c: jax_ref.flash_attention_ref(
            a, b, c, causal=causal, window=window), a, b, c)[1](g))(
        *(jnp.asarray(a) for a in (q, k, v, dout)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_backward_kernel_is_for_cuda_tensors_only():
    from repro_torch.kernels import flash_attention_bwd
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 16, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 16), q)
