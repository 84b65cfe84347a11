"""The port's Mamba-2 chunk scan (on CPU tensors: its plain version)
against the JAX package's Pallas kernel in interpret mode and its oracle,
on the same numpy inputs.  The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.mamba2_scan import mamba2_chunk_scan as jax_kernel
from repro_torch.kernels import mamba2_chunk_scan, mamba2_chunk_scan_ref

# the tolerances of tests/test_kernels.py's kernel sweep
TOL = {"f32": 2e-4, "bf16": 6e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, H, L, P, N, seed=0):
    """As the kernel sweep builds them: xdt, Bm, Cm scaled by 0.5 and
    a = -|n| * 0.1 in float32."""
    rng = np.random.default_rng(seed)
    xdt = 0.5 * rng.standard_normal((B, H, L, P)).astype(np.float32)
    a = -0.1 * np.abs(rng.standard_normal((B, H, L))).astype(np.float32)
    Bm = 0.5 * rng.standard_normal((B, H, L, N)).astype(np.float32)
    Cm = 0.5 * rng.standard_normal((B, H, L, N)).astype(np.float32)
    return xdt, a, Bm, Cm


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


# the three shapes of tests/test_kernels.py's sweep
@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (1, 2, 256, 32, 16, 64),
    (2, 4, 128, 64, 64, 32),
    (1, 1, 512, 16, 8, 128),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_matches_pallas_kernel_and_oracle(B, H, L, P, N, chunk, dt):
    xdt, a, Bm, Cm = _inputs(B, H, L, P, N)
    jx, jB, jC = (jnp.asarray(v, JDT[dt]) for v in (xdt, Bm, Cm))
    tx, tB, tC = (torch.from_numpy(v).to(TDT[dt]) for v in (xdt, Bm, Cm))
    ta = torch.from_numpy(a)
    launches = mamba2_chunk_scan.launches
    y, st = mamba2_chunk_scan(tx, ta, tB, tC, chunk=chunk)
    assert mamba2_chunk_scan.launches == launches      # a CPU call
    assert y.dtype == TDT[dt] and y.shape == (B, H, L, P)
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    for jy, jst in (jax_kernel(jx, jnp.asarray(a), jB, jC, chunk=chunk,
                               interpret=True),
                    jax_ref.mamba2_scan_ref(jx, jnp.asarray(a), jB, jC)):
        _close(y, jy, dt)
        _close(st, jst, dt)


# the sweep's shapes (B, L, P, N, chunk) at H = 4 heads over G groups
@pytest.mark.parametrize("B,L,P,N,chunk", [
    (1, 256, 32, 16, 64),
    (2, 128, 64, 64, 32),
    (1, 512, 16, 8, 128),
])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_grouped_b_c_match_pallas_kernel_and_oracle(B, L, P, N, chunk, G,
                                                    dt):
    """Bm, Cm [B, G, L, N]: head h reads group h // (H / G).  The JAX
    kernel and oracle take B and C per head, so they get them repeated
    over each group's heads with np.repeat."""
    H = 4
    xdt, a, _, _ = _inputs(B, H, L, P, N, seed=1)
    rng = np.random.default_rng(2)
    Bm = 0.5 * rng.standard_normal((B, G, L, N)).astype(np.float32)
    Cm = 0.5 * rng.standard_normal((B, G, L, N)).astype(np.float32)
    jx = jnp.asarray(xdt, JDT[dt])
    jB, jC = (jnp.asarray(np.repeat(v, H // G, axis=1), JDT[dt])
              for v in (Bm, Cm))
    tx, tB, tC = (torch.from_numpy(v).to(TDT[dt]) for v in (xdt, Bm, Cm))
    launches = mamba2_chunk_scan.launches
    y, st = mamba2_chunk_scan(tx, torch.from_numpy(a), tB, tC, chunk=chunk)
    assert mamba2_chunk_scan.launches == launches      # a CPU call
    assert y.shape == (B, H, L, P) and st.shape == (B, H, P, N)
    for jy, jst in (jax_kernel(jx, jnp.asarray(a), jB, jC, chunk=chunk,
                               interpret=True),
                    jax_ref.mamba2_scan_ref(jx, jnp.asarray(a), jB, jC)):
        _close(y, jy, dt)
        _close(st, jst, dt)


def test_plain_version_repeats_groups_over_heads():
    """The plain version on [B, G, L, N] equals it on B and C repeated
    over each group's heads, bit for bit."""
    xdt, a, Bm, Cm = (torch.from_numpy(v) for v in _inputs(2, 6, 40, 16, 8))
    Bg, Cg = Bm[:, :3], Cm[:, :3]
    got = mamba2_chunk_scan_ref(xdt, a, Bg, Cg)
    want = mamba2_chunk_scan_ref(xdt, a, Bg.repeat_interleave(2, dim=1),
                                 Cg.repeat_interleave(2, dim=1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_version_is_the_sequential_recurrence():
    """One step by hand: h_1 = x_0 (x) B_0 decayed by exp(a_1), plus
    x_1 (x) B_1; y_1 = h_1 . C_1."""
    xdt, a, Bm, Cm = (torch.from_numpy(v) for v in _inputs(1, 1, 2, 16, 8))
    y, h = mamba2_chunk_scan_ref(xdt, a, Bm, Cm)
    h1 = torch.exp(a[0, 0, 1]) * torch.outer(xdt[0, 0, 0], Bm[0, 0, 0]) \
        + torch.outer(xdt[0, 0, 1], Bm[0, 0, 1])
    torch.testing.assert_close(h[0, 0], h1)
    torch.testing.assert_close(y[0, 0, 1], h1 @ Cm[0, 0, 1])


@pytest.mark.parametrize("change, err", [
    (dict(L=100, chunk=64), ValueError),           # ragged L
    (dict(a_dtype=torch.bfloat16), TypeError),     # a not float32
    (dict(dtype=torch.float16), TypeError),
    (dict(mixed=True), TypeError),                 # Bm of another dtype
    (dict(a_len=63), ValueError),                  # a does not match xdt
    (dict(C_N=8), ValueError),                     # Bm, Cm differ
    (dict(P=48), ValueError),                      # (P, N) not built
    (dict(N=32), ValueError),
    (dict(transpose=True), ValueError),            # not contiguous
    (dict(device="meta"), ValueError),
    (dict(G=3, C_G=3), ValueError),                # 2 heads, 3 groups
    (dict(C_G=1), ValueError),                     # Bm, Cm groups differ
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err):
    L, P, N = change.get("L", 64), change.get("P", 32), change.get("N", 16)
    dt = change.get("dtype", torch.float32)
    dev = change.get("device", "cpu")
    xdt = torch.zeros(1, 2, L, P, dtype=dt, device=dev)
    a = torch.zeros(1, 2, change.get("a_len", L),
                    dtype=change.get("a_dtype", torch.float32))
    G = change.get("G", 2)
    Bm = torch.zeros(1, G, L, N, dtype=torch.bfloat16 if change.get("mixed")
                     else dt)
    Cm = torch.zeros(1, change.get("C_G", G), L, change.get("C_N", N),
                     dtype=Bm.dtype)
    if change.get("transpose"):
        xdt = torch.zeros(1, L, 2, P).transpose(1, 2)
    launches = mamba2_chunk_scan.launches
    with pytest.raises(err):
        mamba2_chunk_scan(xdt, a, Bm, Cm, chunk=change.get("chunk", 128))
    assert mamba2_chunk_scan.launches == launches
