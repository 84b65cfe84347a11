"""The port's Mamba-2 chunk scan (on CPU tensors: its plain version)
against the JAX package's Pallas kernel in interpret mode and its oracle,
on the same numpy inputs, and its gradient against ``jax.vjp`` of the
oracle.  The CUDA kernels themselves, forward and backward, are held
against the plain versions on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.mamba2_scan import mamba2_chunk_scan as jax_kernel
from repro_torch.kernels import (mamba2_chunk_scan, mamba2_chunk_scan_bwd,
                                 mamba2_chunk_scan_bwd_ref,
                                 mamba2_chunk_scan_ref)

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


# (B, H, G, L, P, N, dstate): one group (zamba's), B and C per head, a
# grouped case with a state cotangent, and the two smaller (P, N) the
# kernel is built for
@pytest.mark.parametrize("B,H,G,L,P,N,with_dstate", [
    (1, 4, 1, 40, 64, 64, False),
    (2, 2, 2, 48, 32, 16, False),
    (1, 4, 2, 33, 32, 16, True),
    (2, 3, 3, 40, 16, 8, True),
    (1, 2, 1, 64, 16, 8, False),
])
def test_backward_matches_jax_vjp_of_the_oracle(B, H, G, L, P, N,
                                                with_dstate):
    """dxdt, da, dBm, dCm of the plain backward (autograd through the plain
    version) against ``jax.vjp`` of ``mamba2_scan_ref`` on B and C repeated
    over each group's heads, its dB and dC summed over each group; float32
    within 1e-5 of each gradient's largest magnitude (at least 1): both
    sum in float32, in other orders, and da sums P x N products a row.
    Autograd through ``mamba2_chunk_scan`` on CPU tensors gives the plain
    backward's bits."""
    xdt, a, _, _ = _inputs(B, H, L, P, N, seed=3)
    rng = np.random.default_rng(4)
    Bm = 0.5 * rng.standard_normal((B, G, L, N)).astype(np.float32)
    Cm = 0.5 * rng.standard_normal((B, G, L, N)).astype(np.float32)
    dy = rng.standard_normal((B, H, L, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    rep = H // G
    _, vjp = jax.vjp(jax_ref.mamba2_scan_ref, *(jnp.asarray(v) for v in (
        xdt, a, np.repeat(Bm, rep, axis=1), np.repeat(Cm, rep, axis=1))))
    jdx, jda, jdB, jdC = (np.asarray(g) for g in vjp(
        (jnp.asarray(dy), jnp.asarray(ds if with_dstate
                                      else np.zeros_like(ds)))))
    jdB = jdB.reshape(B, G, rep, L, N).sum(2)
    jdC = jdC.reshape(B, G, rep, L, N).sum(2)
    t = [torch.from_numpy(v) for v in (xdt, a, Bm, Cm)]
    tdy, tds = torch.from_numpy(dy), torch.from_numpy(ds)
    got = mamba2_chunk_scan_bwd_ref(*t, tdy, tds if with_dstate else None)
    for g, w in zip(got, (jdx, jda, jdB, jdC)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(w).max())))
    ins = [v.clone().requires_grad_(True) for v in t]
    launches = (mamba2_chunk_scan.launches, mamba2_chunk_scan_bwd.launches)
    y, st = mamba2_chunk_scan(*ins, chunk=L)
    again = torch.autograd.grad([y, st] if with_dstate else [y], ins,
                                [tdy, tds] if with_dstate else [tdy])
    assert (mamba2_chunk_scan.launches,
            mamba2_chunk_scan_bwd.launches) == launches   # CPU calls
    for g, w in zip(got, again):
        assert torch.equal(g, w)


def test_plain_backward_keeps_the_input_dtypes():
    """bf16 xdt, Bm, Cm give bf16 dxdt, dBm, dCm and float32 da, as the
    kernel writes them; within bf16 rounding of the float32 gradient."""
    xdt, a, Bm, Cm = (torch.from_numpy(v) for v in _inputs(1, 2, 24, 16, 8))
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 2, 24, 16)).astype(np.float32))
    want = mamba2_chunk_scan_bwd_ref(xdt, a, Bm, Cm, dy)
    bf = [v.to(torch.bfloat16) for v in (xdt, Bm, Cm, dy)]
    got = mamba2_chunk_scan_bwd_ref(bf[0], a, bf[1], bf[2], bf[3])
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                   atol=TOL["bf16"] * scale)


def test_backward_wrapper_launches_only_on_the_card():
    """The backward's wrapper raises on CPU tensors (autograd
    differentiates the plain version there) and on inputs the kernel does
    not take, without a launch."""
    xdt, a, Bm, Cm = (torch.from_numpy(v) for v in _inputs(1, 2, 64, 32, 16))
    launches = mamba2_chunk_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        mamba2_chunk_scan_bwd(xdt, a, Bm, Cm, torch.zeros_like(xdt))
    with pytest.raises(ValueError):
        mamba2_chunk_scan_bwd(xdt, a, Bm, Cm[:, :1].contiguous(),
                              torch.zeros_like(xdt))
    assert mamba2_chunk_scan_bwd.launches == launches
