"""The port's layers against the JAX package's, same numpy inputs, f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 4, 2, 32)])
def test_rms_norm(shape):
    rng = _rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_rms_norm_keeps_bf16_scaling_order():
    rng = _rng(1)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    got = tl.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(theta, per_row):
    rng = _rng(2)
    B, S, H, hd = 2, 7, 3, 32
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    if per_row:
        pos = rng.integers(0, 500, (B, S))
    else:
        pos = np.arange(S)[None, :]
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(
        tl.rope_frequencies(hd, theta).numpy(),
        np.asarray(jl.rope_frequencies(hd, theta)), rtol=1e-6)


def test_apply_mlp_swiglu():
    rng = _rng(3)
    d, ff = 64, 160
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                      ("w_down", (ff, d)))}
    want = jl.apply_mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()})
    got = tl.apply_mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                             for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_embed_and_logits():
    rng = _rng(4)
    tok = rng.integers(0, 50, (2, 6))
    table = rng.standard_normal((50, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    want = jl.logits(jl.embed(jnp.asarray(tok), {"tok": jnp.asarray(table)}),
                     {"w": jnp.asarray(w)})
    got = tl.logits(tl.embed(torch.from_numpy(tok),
                             {"tok": torch.from_numpy(table)}),
                    {"w": torch.from_numpy(w)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("fn, args", [
    (tl.apply_mlp, (None, None, "gelu")), (tl.mlp_specs, (8, 16, "gelu"))])
def test_unported_layer_kinds_raise(fn, args):
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        fn(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_its_norm_kind(dtype):
    """layer_norm, and the ``"ln"`` kind of norm_specs/apply_norm that
    phi3.5-moe uses, against the JAX package's: f32 within ATOL; bf16
    (statistics in f32, normalization in bf16, as there) within one bf16
    rounding step of the output's scale."""
    rng = _rng(5)
    x = (rng.standard_normal((3, 7, 64)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = jl.apply_norm(jnp.asarray(x, jdt),
                         {"w": jnp.asarray(w), "b": jnp.asarray(b)}, "ln")
    got = tl.apply_norm(torch.from_numpy(x).to(tdt),
                        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        "ln")
    assert got.dtype == tdt
    tol = ATOL if dtype == "float32" else 2 ** -7 * float(
        np.abs(np.asarray(want, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=ATOL)
    np.testing.assert_allclose(
        tl.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b)).numpy(),
        np.asarray(jl.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))), atol=ATOL, rtol=ATOL)
    specs = tl.norm_specs(64, "ln")
    ref = jl.norm_specs(64, "ln")
    assert {k: (s.shape, s.init) for k, s in specs.items()} == \
        {k: (s.shape, s.init) for k, s in ref.items()}
