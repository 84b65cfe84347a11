#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit and
without the final ``{"ok": true, ...}`` line:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every hand-written kernel from ``src/repro_torch/csrc``;
3. kernels: hold each kernel against its plain PyTorch version on the
   card, at the paths' shapes and at the edge cases, and time the kernel,
   the plain version and (where one exists) one PyTorch library call at
   those shapes: K1 flash attention at qwen3-4b's and zamba2-2.7b's
   prefill shapes, K1's backward at qwen3-4b's training shape (against
   autograd through the plain version), K2 the Mamba-2 chunk scan at
   zamba2-2.7b's, K3a/K3b the 1-bit codec at a 32 MB bucket and at the
   largest bucket of the training plan;
4. reference: the tiny dense and zamba configs served on the card agree
   with the same parameters served on the CPU, and tiny qwen3-4b trains
   8 steps (plain, and world-1 DDP with the onebit codec) on the card
   with the CPU's losses (the port's CPU path is tied to the JAX package
   by the tests);
5. serve: ``Plan(arch=..., tiny=False).compile().serve(...)`` for
   qwen3-4b and for zamba2-2.7b, each at full width and full depth with
   random weights from a seed;
6. train: ``Plan(arch="qwen3-4b", tiny=False, overrides={"n_layers":
   12}).compile().train(...)`` at full width, plain and as world-1 DDP
   with the onebit codec;
7. where the time goes: one prefill and one decode step of each served
   configuration, one plain and one DDP train step;
8. the ``kernels`` JSON line, then the ``ok`` line last.

Every kernel launch count is set to 0 just before each run of phases 5
and 6 and read just after; each run asserts the counts its layers give.

It imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.core.sharding import init_params  # noqa: E402
from repro_torch.data.pipeline import stream_for, to_device  # noqa: E402
from repro_torch.frontend import Plan  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_ref)
from repro_torch.kernels.mamba2_scan import (  # noqa: E402
    mamba2_chunk_scan, mamba2_chunk_scan_ref)
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.kernels.onebit import (  # noqa: E402
    onebit_dequantize, onebit_dequantize_ref, onebit_quantize,
    onebit_quantize_ref)

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12       # float32 outside the tensor cores
# kernel-test tolerances of tests/test_kernels.py
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# the training slice: full width, 12 of qwen3-4b's 36 layers (the f32
# parameters, adamw's m and v, the onebit residual and the fused buckets
# of all 36 would take about 106 GB)
TRAIN_LAYERS = 12
TRAIN = dict(arch="qwen3-4b", tiny=False, batch=8, seq=512,
             overrides={"n_layers": TRAIN_LAYERS})
TRAIN_STEPS = 6
TRAIN_DDP_SHARDS = 2
# the training slice's attention: (B, H, Hkv, S, d, dtype, causal,
# window) with B the whole batch (Session.train) or one DDP shard
_TRAIN_CFG = get_config(TRAIN["arch"])
TRAIN_ATTN = (TRAIN["batch"], _TRAIN_CFG.n_heads, _TRAIN_CFG.n_kv_heads,
              TRAIN["seq"], _TRAIN_CFG.head_dim, torch.bfloat16, True, None)
TRAIN_SHARD_ATTN = (TRAIN["batch"] // TRAIN_DDP_SHARDS, *TRAIN_ATTN[1:])
# (B, H, Hkv, S, d, dtype, causal, window): the serving slices' shapes
# first (qwen3-4b, then zamba2-2.7b's shared block), then Session.train's,
# then the edge cases
FA_CASES = [
    (4, 32, 8, 512, 128, torch.bfloat16, True, None),
    (4, 32, 32, 512, 80, torch.bfloat16, True, None),     # d=80 (zamba)
    TRAIN_ATTN,
    (2, 8, 2, 200, 128, torch.bfloat16, True, None),      # ragged S
    (1, 32, 32, 256, 96, torch.bfloat16, True, None),     # d=96 (phi3)
    (2, 4, 2, 256, 32, torch.float32, True, None),        # d=32 f32 (tiny)
    (2, 16, 4, 512, 128, torch.bfloat16, True, 128),      # window
    (1, 4, 4, 300, 64, torch.float32, False, None),       # non-causal d=64
]
FA_TIMED = 2            # the first FA_TIMED cases are timed
# K2 tolerances of tests/test_kernels.py's sweep, as atol and rtol
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
# (B, H, L, P, N, chunk, dtype): zamba2-2.7b's prefill shape (timed) in
# bf16 and f32, then the three shapes of tests/test_kernels.py's sweep
SCAN_CASES = [
    (4, 80, 512, 64, 64, 256, torch.bfloat16),
    (4, 80, 512, 64, 64, 256, torch.float32),
    (1, 2, 256, 32, 16, 64, torch.float32),
    (2, 4, 128, 64, 64, 32, torch.float32),
    (1, 1, 512, 16, 8, 128, torch.float32),
]
SCAN_TILE = 64          # rows per tile of csrc/mamba2_scan.cu
SERVE = dict(requests=8, slots=4, prompt_len=512, gen_len=32)
SERVE_ARCHS = ("qwen3-4b", "zamba2-2.7b")
# K1 backward: qwen3-4b's training shapes (a DDP shard, timed, then the
# whole batch of Session.train), then small float32 shapes: GQA and MHA,
# causal on and off, a window, ragged S, each head dim the backward is
# built for
FA_BWD_CASES = [
    TRAIN_SHARD_ATTN,
    TRAIN_ATTN,
    (2, 8, 2, 200, 64, torch.float32, True, None),        # GQA, ragged S
    (1, 4, 4, 256, 64, torch.float32, False, None),       # MHA, non-causal
    (2, 4, 2, 256, 32, torch.float32, True, 64),          # window, d=32
    (1, 8, 2, 130, 128, torch.float32, True, None),       # d=128 f32
    (2, 4, 4, 96, 32, torch.float32, False, None),        # tiny's head dim
]
# f32: within 1e-4 of the largest gradient magnitude (at least 1); bf16:
# the plain version rounds its products and probabilities to bf16, the
# kernel sums in f32, so bf16 is held to 3e-2 of the largest magnitude
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K3a/K3b: a 32 MB bucket ([8192, 1024] float32); the training plan's
# largest bucket is added at run time
ONEBIT_ROWS = 8192
# tiny card-against-CPU training: losses per step within these relative
# tolerances.  The card's K1 sums in another order than the CPU's plain
# version; adamw's normalized step carries that into the parameters.  With
# onebit a near-zero sign may flip between the two, a whole +-scale step
# on that element, hence the looser bound.
TRAIN_REF_STEPS = 8
TRAIN_REF_RTOL = {"plain": 1e-4, "onebit": 1e-3}


def phase(name: str):
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, k, v, causal, window):
    """Least time for the same work: every input read once and the output
    written once, against the operations of the (q, k) pairs this mask
    keeps, two products of 2*d operations each."""
    B, H, S, d = q.shape
    ops = 4 * d * B * H * causal_pairs(S, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return roofline(nbytes, ops)


def roofline(nbytes: int, ops: int,
             peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` moved and ``ops`` operations at
    ``peak`` (bf16 tensor cores by default) on the card, and which of the
    two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kv_caches(cache) -> list:
    """The attention layers' {"k", "v"} caches of a model's cache tree."""
    if isinstance(cache, dict):
        if "k" in cache:
            return [cache]
        return [c for v in cache.values() for c in _kv_caches(v)]
    if isinstance(cache, list):
        return [c for v in cache for c in _kv_caches(v)]
    return []


def scan_ops(B: int, H: int, L: int, P: int, N: int) -> int:
    """Operations of the SSD scan in the kernel's tiles of ``SCAN_TILE``
    rows: per tile C B^T, G x, C S^T and the state update."""
    t = min(SCAN_TILE, L)
    return 2 * B * H * L * (t * (N + P) + 2 * P * N)


def scan_bound(xdt, a, Bm, Cm, state_bytes: int) -> tuple[float, str]:
    """Least time for the scan: xdt, a, Bm, Cm read once, y and the state
    written once, against ``scan_ops``."""
    nbytes = sum(t.numel() * t.element_size() for t in (xdt, a, Bm, Cm))
    nbytes += xdt.numel() * xdt.element_size() + state_bytes
    return roofline(nbytes, scan_ops(*xdt.shape, Bm.shape[-1]))


def step_bound(cfg, params, cache, slots: int, new_tokens: int,
               keys_seen: int) -> tuple[float, str]:
    """Least time for one prefill (``new_tokens`` per row) or decode step
    (1): every weight but the embedding table (a gather of a few rows)
    and the whole cache moved once; 2 operations per weight use and new
    token in the layers' products (zamba's shared block is used once per
    group), the unembedding of one token a row, attention's 4*hd per
    (query, key) pair of ``keys_seen`` pairs a row and head in each
    attention layer (counted from the cache), and the SSD scan of each
    mamba layer (``scan_ops``)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves((params, cache)))
    emb = params["embed"]["tok"]
    nbytes -= emb.numel() * emb.element_size()
    n_attn = len(_kv_caches(cache))

    def mm(tree):
        return sum(t.numel() for t in pytree.tree_leaves(tree)
                   if t.dim() >= 2)
    weight_uses = mm(params["stack"])
    if cfg.family == "zamba":
        weight_uses += (n_attn - 1) * mm(params["stack"]["shared"])
    ops = (2 * slots * new_tokens * weight_uses
           + 2 * slots * params["unembed"]["w"].numel()
           + 4 * cfg.head_dim * slots * cfg.n_heads * keys_seen * n_attn)
    if cfg.family == "zamba":
        H = cfg.expand * cfg.d_model // cfg.ssm_head_dim
        ops += cfg.n_layers * scan_ops(slots, H, new_tokens,
                                       cfg.ssm_head_dim, cfg.ssm_state)
    return roofline(nbytes, ops)


def check_kernels(gen) -> list:
    """K1 against its plain version at ``FA_CASES``; times the first
    ``FA_TIMED`` cases and returns their readings."""
    out = []
    for B, H, Hkv, S, d, dt, causal, window in FA_CASES:
        q = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= TOL[dt] and bool(torch.isfinite(got).all())
        print(f"flash_attention B={B} H={H} Hkv={Hkv} S={S} d={d} "
              f"{str(dt)[6:]} causal={causal} window={window}: max abs err "
              f"{err:.3g} (tolerance {TOL[dt]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version: {err} > {TOL[dt]}")
        if len(out) < FA_TIMED:          # a serving slice's shape: time it
            ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal))
            plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                           causal=causal))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            bound_ms, bound_by = attention_bound(q, k, v, causal, window)
            out.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by})
            print(f"  at the slice's shape: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, scaled_dot_product_attention "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return out


def check_scan(gen) -> dict:
    """K2 against its plain version at ``SCAN_CASES``, inputs built as
    tests/test_kernels.py builds them (xdt, Bm, Cm scaled by 0.5, a =
    -|n| * 0.1); times the first case.  No single PyTorch call computes
    the SSD scan, so there is no library time."""
    out = {}
    for B, H, L, P, N, chunk, dt in SCAN_CASES:
        xdt = (0.5 * torch.randn(B, H, L, P, generator=gen,
                                 device="cuda")).to(dt)
        a = -0.1 * torch.randn(B, H, L, generator=gen, device="cuda").abs()
        Bm = (0.5 * torch.randn(B, H, L, N, generator=gen,
                                device="cuda")).to(dt)
        Cm = (0.5 * torch.randn(B, H, L, N, generator=gen,
                                device="cuda")).to(dt)
        y, st = mamba2_chunk_scan(xdt, a, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        y_ref, st_ref = mamba2_chunk_scan_ref(xdt, a, Bm, Cm)
        tol = SCAN_TOL[dt]
        errs, ok = [], True
        for got, want in ((y.float(), y_ref.float()), (st, st_ref)):
            diff = (got - want).abs()
            errs.append(diff.max().item())
            ok &= bool((diff <= tol + tol * want.abs()).all()) \
                and bool(torch.isfinite(got).all())
        print(f"mamba2_chunk_scan B={B} H={H} L={L} P={P} N={N} "
              f"chunk={chunk} {str(dt)[6:]}: max abs err y {errs[0]:.3g}, "
              f"state {errs[1]:.3g} (atol = rtol = {tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("mamba2_chunk_scan disagrees with its plain "
                                 "version")
        if not out:          # the serving slice's shape: time it
            ms = cuda_ms(lambda: mamba2_chunk_scan(xdt, a, Bm, Cm,
                                                   chunk=chunk))
            plain_ms = cuda_ms(lambda: mamba2_chunk_scan_ref(xdt, a, Bm, Cm),
                               iters=3, warm=1)
            bound_ms, bound_by = scan_bound(
                xdt, a, Bm, Cm, st.numel() * st.element_size())
            out = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            print(f"  at the slice's shape: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, no library call, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
    return out


def causal_pairs(S: int, causal: bool, window) -> int:
    """The (query, key) pairs a mask keeps in one [S, S] head."""
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= i - j < window
    return int(keep.sum())


def check_fa_bwd(gen) -> dict:
    """K1's backward kernel against autograd through the plain version on
    the card at ``FA_BWD_CASES``; times the first case: the kernel (from
    the forward's o and lse), the plain version's backward and
    ``scaled_dot_product_attention``'s backward."""
    out = {}
    for B, H, Hkv, S, d, dt, causal, window in FA_BWD_CASES:
        q = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        dout = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        got = torch.autograd.grad(
            flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        torch.cuda.synchronize()
        want_out = flash_attention_ref(q, k, v, causal=causal, window=window)
        want = torch.autograd.grad(want_out, (q, k, v), dout,
                                   retain_graph=True)
        errs, ok = [], True
        for g, w in zip(got, want):
            limit = FA_BWD_TOL[dt] * max(1.0, w.float().abs().max().item())
            e = (g.float() - w.float()).abs().max().item()
            errs.append(e)
            ok &= e <= limit and bool(torch.isfinite(g).all())
        print(f"flash_attention_bwd B={B} H={H} Hkv={Hkv} S={S} d={d} "
              f"{str(dt)[6:]} causal={causal} window={window}: max abs err "
              f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} "
              f"(tolerance {FA_BWD_TOL[dt]:g} x max(1, max |grad|)) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention_bwd disagrees with "
                                 "autograd through the plain version")
        if out:
            continue
        # the training slice's shape: time the backward alone, each call
        # re-running the recorded graph's backward
        kern_out = flash_attention(q, k, v, causal=causal, window=window)
        ms = cuda_ms(lambda: torch.autograd.grad(
            kern_out, (q, k, v), dout, retain_graph=True))
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            want_out, (q, k, v), dout, retain_graph=True), iters=5)
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                 enable_gqa=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (q, k, v), dout, retain_graph=True))
        esz = q.element_size()
        nbytes = (4 * q.numel() + 4 * k.numel()) * esz + 4 * B * H * S
        ops = 10 * d * B * H * causal_pairs(S, causal, window)
        bound_ms, bound_by = roofline(nbytes, ops)
        out = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        print(f"  at the training shape: kernel {ms:.4f} ms, plain backward "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention backward "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
    return out


def train_plan_buckets() -> list:
    """The bucket sizes (elements) of the full-width training plan's
    gradient fusion plan."""
    cfg = Plan(**TRAIN, device="cpu").config()
    return [b.size for b in steps.make_ddp_step(
        cfg, steps.Strategy()).grad_plan.buckets]


def check_onebit(gen, rows_list) -> dict:
    """K3a/K3b against their plain versions on the card at [R, 1024] for
    each R of ``rows_list``: sign words bit-identical except words holding
    a |q| within 1e-6 * scale of 0 (counted), scales within 1e-6
    relative, new_err within 1e-6 absolute, dequantize bit-identical.
    Times the first and the last R; no single PyTorch call computes either
    function, so there is no library time."""
    out = {}
    for n, R in enumerate(rows_list):
        g = torch.randn(R, 1024, generator=gen, device="cuda")
        err = 0.1 * torch.randn(R, 1024, generator=gen, device="cuda")
        packed, scale, new_err = onebit_quantize(g, err)
        torch.cuda.synchronize()
        p_ref, s_ref, e_ref = onebit_quantize_ref(g, err)
        near = ((g + err).abs() <= 1e-6 * s_ref).reshape(R, 32, 32).any(-1)
        differ = packed != p_ref
        bad_words = int((differ & ~near).sum())
        s_err = ((scale - s_ref).abs() / s_ref.abs()).max().item()
        e_err = (new_err - e_ref).abs().max().item()
        deq = onebit_dequantize(packed, scale)
        torch.cuda.synchronize()
        d_same = torch.equal(deq, onebit_dequantize_ref(packed, scale))
        ok = bad_words == 0 and s_err <= 1e-6 and e_err <= 1e-6 and d_same
        print(f"onebit [{R}, 1024] ({4 * R * 1024 / 2**20:.0f} MB): words "
              f"differing {int(differ.sum())} of {packed.numel()} (near-zero "
              f"words {int(near.sum())}, other {bad_words}), scale rel err "
              f"{s_err:.3g}, new_err abs err {e_err:.3g}, dequantize "
              f"{'identical' if d_same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("onebit kernels disagree with their plain "
                                 "versions")
        if n not in (0, len(rows_list) - 1):
            continue
        el = R * 1024
        iters = 20 if n == 0 else 5
        q_ms = cuda_ms(lambda: onebit_quantize(g, err), iters=iters)
        q_plain = cuda_ms(lambda: onebit_quantize_ref(g, err), iters=iters)
        d_ms = cuda_ms(lambda: onebit_dequantize(packed, scale), iters=iters)
        d_plain = cuda_ms(lambda: onebit_dequantize_ref(packed, scale),
                          iters=iters)
        # K3a: g, err read; new_err, words, scales written; add, |.|, sum,
        # compare and subtract an element.  K3b: words and scales read, the
        # output written; a shift, a mask and a select an element.
        qb, qby = roofline(12 * el + el // 8 + 4 * R, 5 * el, F32_FLOPS)
        db, dby = roofline(4 * el + el // 8 + 4 * R, 3 * el, F32_FLOPS)
        key = "" if n == 0 else "largest_bucket_"
        out[key + "quantize"] = {
            "max_abs_err": e_err, "ms": q_ms, "plain_ms": q_plain,
            "library_ms": None, "bound_ms": qb, "bound_by": qby}
        out[key + "dequantize"] = {
            "max_abs_err": 0.0, "ms": d_ms, "plain_ms": d_plain,
            "library_ms": None, "bound_ms": db, "bound_by": dby}
        print(f"  quantize: kernel {q_ms:.4f} ms, plain {q_plain:.4f} ms, "
              f"bound {qb:.4f} ms ({qby}); dequantize: kernel {d_ms:.4f} "
              f"ms, plain {d_plain:.4f} ms, bound {db:.4f} ms ({dby}); no "
              f"library call")
        del g, err, packed, scale, new_err, p_ref, s_ref, e_ref, deq
        torch.cuda.empty_cache()
    return out


def check_train_reference() -> None:
    """Tiny qwen3-4b trains ``TRAIN_REF_STEPS`` steps on the card and on
    the CPU from the same parameters and batches, through the loops'
    own steps: the plain train step of ``Session.train``, and its world-1
    DDP engine with the onebit codec and two shards.
    (The two devices' generators draw different parameters from one seed,
    so the card's are copied from the CPU's.)  The losses of every step
    agree within ``TRAIN_REF_RTOL``."""
    from repro_torch.distrib.collectives import RingAllReduce
    from repro_torch.frontend.ddp import DDPEngine
    for name in ("plain", "onebit"):
        runs = {}
        for dev in ("cpu", "cuda"):
            extra = (dict(ddp=True, grad_codec="onebit", ddp_shards=2)
                     if name == "onebit" else {})
            plan = Plan(arch="qwen3-4b", tiny=True, batch=8, seq=64,
                        device=dev, **extra)
            cfg = plan.config()
            stream = stream_for(cfg, batch=plan.batch, seq=plan.seq)
            if name == "onebit":
                engine = DDPEngine(plan, RingAllReduce(None, 1))
                init, fn = engine.step.init, engine.train_step
            else:
                step = steps.make_train_step(cfg, steps.Strategy())
                init = step.init

                def fn(it, batch, params, opt, step=step, dev=dev):
                    return step.fn(params, opt, to_device(batch, dev))
            params, _ = init(torch.Generator().manual_seed(0), "cpu")
            params = pytree.tree_map(
                lambda t: t.detach().to(dev).requires_grad_(True), params)
            opt = optimizers.init(params, optimizers.OptConfig())
            losses = []
            for it in range(TRAIN_REF_STEPS):
                m, params, opt = fn(it, stream.batch_at(it), params, opt)
                losses.append(float(m["loss"]))
            runs[dev] = losses
        worst = max(abs(a - b) / abs(a) for a, b in zip(runs["cpu"],
                                                        runs["cuda"]))
        tol = TRAIN_REF_RTOL[name]
        print(f"qwen3-4b tiny, {name} training, {TRAIN_REF_STEPS} steps: "
              f"losses cpu {runs['cpu'][0]:.5f} .. {runs['cpu'][-1]:.5f}, "
              f"card {runs['cuda'][0]:.5f} .. {runs['cuda'][-1]:.5f}, max "
              f"relative difference {worst:.3g} (tolerance {tol:g})")
        if not worst <= tol:
            raise AssertionError(f"{name} training: the card disagrees with "
                                 f"the CPU")


class RepeatStream:
    """Step 0's batch of the synthetic stream, at every step.  The stream's
    tokens are uniform over the vocabulary, so on fresh batches a randomly
    initialized model keeps its loss at about ln(vocab) + 0.5 for many
    more than ``TRAIN_STEPS`` steps; on one repeated batch the loss falls
    as soon as the gradients reach the parameters."""

    def __init__(self, stream):
        self.batch = stream.batch_at(0)

    def batch_at(self, step: int) -> dict:
        return self.batch


class StepClock:
    """A ``Session.train`` hook: synchronizes the card after every step
    and keeps the host clock, so consecutive readings are step times."""

    def __init__(self):
        self.t = [time.perf_counter()]

    def on_step(self, it, metrics):
        torch.cuda.synchronize()
        self.t.append(time.perf_counter())

    def step_ms(self) -> list:
        return [1e3 * (b - a) for a, b in zip(self.t, self.t[1:])]


def train_full(ddp: bool, n_buckets: int) -> dict:
    """``Session.train`` at full width (``TRAIN``), plain or as world-1
    DDP with the onebit codec, ``TRAIN_STEPS`` steps from random weights
    (seed 0), with every kernel launch count set to 0 just before and read
    just after, on one repeated batch (``RepeatStream``).  Checks finite
    losses with the last below the first and the launch counts the layers
    give: K1 forward twice a layer and step
    (remat recomputes it), K1 backward once, each per shard; K3a and K3b
    once a bucket and step under DDP.  Returns the counts."""
    name = "world-1 DDP, onebit codec" if ddp else "Session.train"
    phase(f"train qwen3-4b, full width, {TRAIN_LAYERS} of 36 layers, {name}, "
          f"random weights (seed 0)")
    extra = dict(ddp=True, grad_codec="onebit",
                 ddp_shards=TRAIN_DDP_SHARDS) if ddp else {}
    plan = Plan(**TRAIN, device="cuda", **extra)
    cfg = plan.config()
    clock = StepClock()
    with plan.compile() as session:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in KERNELS:
            fn.launches = 0
        stream = RepeatStream(stream_for(cfg, batch=plan.batch,
                                         seq=plan.seq, seed=plan.seed))
        out = session.train(stream, steps=TRAIN_STEPS, log_every=1,
                            hooks=clock)
        counts = {fn.__name__: fn.launches for fn in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    ms = clock.step_ms()
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]      # the first step warms up
    tok_s = plan.batch * plan.seq / (step_ms / 1e3)
    print(f"losses {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"step times (host wall, each ending in a synchronize) "
          f"{' '.join(f'{x:.1f}' for x in ms)} ms; median after the first "
          f"{step_ms:.1f} ms, {tok_s:.0f} tok/s, peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(", ".join(f"{k} launches {v}" for k, v in counts.items()))
    if ddp:
        print(f"grad_wire_bytes {out['grad_wire_bytes']}, codec_bytes "
              f"{out['codec_bytes']}")
    shards = TRAIN_DDP_SHARDS if ddp else 1
    L = cfg.n_layers
    want = {"flash_attention": TRAIN_STEPS * L * 2 * shards,
            "flash_attention_bwd": TRAIN_STEPS * L * shards,
            "mamba2_chunk_scan": 0,
            "onebit_quantize": TRAIN_STEPS * n_buckets if ddp else 0,
            "onebit_dequantize": TRAIN_STEPS * n_buckets if ddp else 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: want {TRAIN_STEPS} finite "
                             f"values, the last below the first")
    if ddp and out["grad_wire_bytes"] != 0:
        raise AssertionError("world-1 DDP put bytes on the wire")
    del out
    torch.cuda.empty_cache()
    return counts


def profile_one(name: str, fn, bound, repeats: int = 3) -> None:
    """Host wall (median of ``repeats`` calls, each ending in a device
    synchronize), the device time of the kernels one call launches, the
    kernels that take most of it (torch.profiler) and the bound."""
    bound_ms, bound_by = bound
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[len(walls) // 2]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels themselves: an operator's row repeats its kernels'
    # device time, so counting operators too would count it twice
    ev = [e for e in prof.key_averages()
          if e.device_type != torch.autograd.DeviceType.CPU
          and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    n = sum(e.count for e in ev)
    print(f"{name}: host wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"in {n} kernels"
          + (f", idle share {1 - busy / wall:.3f}" if busy else
             ", device time not measured")
          + f"; bound {bound_ms:.3f} ms ({bound_by})")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d}"
              f" {e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:4]
    print("  host operators by own host time: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in host))


def profile_train(ddp: bool) -> None:
    """Where one full-width train step (``TRAIN``) spends its time: the
    plain step, or the world-1 DDP step with the onebit codec.  Bound:
    parameters, gradients and adamw's m and v each read and written once
    in float32 (32 bytes a parameter; under DDP also K3a's 12.1 and K3b's
    4.1 bytes an element), against the products of the step at bf16 (2
    operations per weight use and token in the forward, the same again in
    remat's recompute, 4 in the backward, the unembedding included;
    attention's 4*hd per causal pair forward and recompute, 10*hd
    backward)."""
    from repro_torch.distrib.collectives import RingAllReduce
    from repro_torch.frontend.ddp import DDPEngine
    extra = dict(ddp=True, grad_codec="onebit",
                 ddp_shards=TRAIN_DDP_SHARDS) if ddp else {}
    plan = Plan(**TRAIN, device="cuda", **extra)
    cfg = plan.config()
    batch = stream_for(cfg, batch=plan.batch, seq=plan.seq,
                       seed=1).batch_at(0)
    if ddp:
        engine = DDPEngine(plan, RingAllReduce(None, 1))
        params, opt = engine.init()

        def run(params, opt):
            return engine.train_step(0, batch, params, opt)
    else:
        step = steps.make_train_step(cfg, steps.Strategy())
        params, opt = step.init(
            torch.Generator(device="cuda").manual_seed(1), "cuda")
        batch = to_device(batch, "cuda")

        def run(params, opt):
            return step.fn(params, opt, batch)
    leaves = pytree.tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    weight_uses = sum(t.numel() for t in pytree.tree_leaves(params["stack"])
                      if t.dim() >= 2) + params["unembed"]["w"].numel()
    tokens = plan.batch * plan.seq
    pairs = plan.batch * cfg.n_heads * causal_pairs(plan.seq, True, None)
    ops = (8 * tokens * weight_uses
           + cfg.n_layers * pairs * cfg.head_dim * (4 + 4 + 10))
    state = {"params": params, "opt": opt}

    def one():
        _, state["params"], state["opt"] = run(state["params"], state["opt"])
    name = "world-1 DDP onebit step" if ddp else "train step"
    profile_one(f"{name}, {plan.batch} x {plan.seq} tokens", one,
                roofline((48 if ddp else 32) * n, ops))
    del state, params, opt, leaves
    torch.cuda.empty_cache()


def check_reference(arch: str, prompt_len: int = 20, gen_len: int = 8,
                    slots: int = 2, tol: float = 1e-4, scaled: bool = False):
    """Greedy serve of a tiny config on the card against the same
    parameters on the CPU: identical tokens, logits within ``tol`` (with
    ``scaled``, within ``tol`` times the logits' largest magnitude)."""
    cfg = get_config(arch, tiny=True)
    shape = {"seq_len": prompt_len + gen_len, "global_batch": slots}
    pre = steps.make_prefill_step(cfg, shape)
    dec = steps.make_decode_step(cfg, shape)
    p_cpu = init_params(pre.specs, torch.Generator().manual_seed(0), "cpu")
    p_gpu = pytree.tree_map(lambda t: t.to("cuda"), p_cpu)
    toks = np.random.default_rng(0).integers(0, cfg.vocab,
                                             (slots, prompt_len))
    runs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, cache = pre.fn(params, {"tokens": torch.from_numpy(toks).to(dev)})
        lgs, tok = [lg], lg.argmax(-1)[:, None]
        toks_out = [tok]
        for t in range(gen_len):
            lg, cache = dec.fn(params, cache, {"tokens": tok}, prompt_len + t)
            tok = lg.argmax(-1)[:, None]
            lgs.append(lg)
            toks_out.append(tok)
        runs[dev] = (torch.stack(lgs).float().cpu(),
                     torch.cat(toks_out, 1).cpu())
    worst = (runs["cpu"][0] - runs["cuda"][0]).abs().max().item()
    same = torch.equal(runs["cpu"][1], runs["cuda"][1])
    scale = runs["cpu"][0].abs().max().item()
    limit = tol * max(1.0, scale) if scaled else tol
    print(f"{arch} tiny, prompt {prompt_len}, {gen_len} greedy steps: "
          f"tokens {'identical' if same else 'DIFFER'}, logits max abs err "
          f"{worst:.3g}, largest logit {scale:.3g} (tolerance {limit:.3g})")
    if not same or worst > limit:
        raise AssertionError(f"{arch}: the card disagrees with the CPU")


def profile_steps(cfg, slots: int, prompt_len: int, repeats: int = 3):
    """Where one prefill and one decode step spend their time at the serve
    shape: host wall time (median of ``repeats``, each ending in a device
    synchronize), the device time of the kernels it launched, the
    kernels that take the most of it (torch.profiler), and the step's
    bound (``step_bound``)."""
    shape = {"seq_len": prompt_len + 1, "global_batch": slots}
    pre = steps.make_prefill_step(cfg, shape)
    dec = steps.make_decode_step(cfg, shape)
    params = init_params(pre.specs,
                         torch.Generator(device="cuda").manual_seed(1), "cuda")
    toks = torch.randint(0, cfg.vocab, (slots, prompt_len), device="cuda")
    lg, cache = pre.fn(params, {"tokens": toks})
    tok = lg.argmax(-1)[:, None]
    runs = (("prefill", lambda: pre.fn(params, {"tokens": toks}),
             step_bound(cfg, params, cache, slots, prompt_len,
                        prompt_len * (prompt_len + 1) // 2)),
            ("decode step", lambda: dec.fn(params, cache, {"tokens": tok},
                                           prompt_len),
             step_bound(cfg, params, cache, slots, 1, prompt_len + 1)))
    for name, fn, bound in runs:
        profile_one(name, fn, bound)


KERNELS = (flash_attention, flash_attention_bwd, mamba2_chunk_scan,
           onebit_quantize, onebit_dequantize)


def serve_full(arch: str) -> dict:
    """``Session.serve`` of ``arch`` at full width and depth (random
    weights, seed 0), with every kernel launch count set to 0 just before
    and read just after; checks the counts against the layers the path
    runs (K1 once per attention layer and K2 once per mamba layer, each
    once per wave), the decode nodes, the token range and finite prefill
    logits.  Returns the counts."""
    phase(f"serve {arch}, full width and depth, random weights (seed 0)")
    plan = Plan(arch=arch, tiny=False, device="cuda")
    cfg = plan.config()
    with plan.compile() as session:
        torch.cuda.reset_peak_memory_stats()
        for fn in KERNELS:
            fn.launches = 0
        res = session.serve(**SERVE)
        counts = {fn.__name__: fn.launches for fn in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    waves = res["waves"]
    n_decode = sum(n.startswith("decode:") for n in res["nodes"])
    print(f"{res['tokens_per_s']:.1f} tok/s, {waves} waves, "
          f"{n_decode} decode nodes, peak memory {peak / 2**30:.2f} GiB, "
          + ", ".join(f"{k} launches {v}" for k, v in counts.items()))
    if cfg.family == "zamba":
        want = {"flash_attention": cfg.n_layers // cfg.shared_every,
                "mamba2_chunk_scan": cfg.n_layers}
    else:
        want = {"flash_attention": cfg.n_layers, "mamba2_chunk_scan": 0}
    want.update(flash_attention_bwd=0, onebit_quantize=0,
                onebit_dequantize=0)
    for name, per_wave in want.items():
        if counts[name] != waves * per_wave:
            raise AssertionError(f"{name} launched {counts[name]} times, "
                                 f"want waves x layers = {waves * per_wave}")
    if n_decode != waves * SERVE["gen_len"]:
        raise AssertionError(f"{n_decode} decode nodes")
    gen = torch.cat(res["generated"])
    if gen.shape != (waves * SERVE["slots"], SERVE["gen_len"] + 1) or \
            int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab:
        raise AssertionError(f"generated tokens out of range: {gen.shape}")
    lg = res["first_prefill_logits"]
    if lg.shape != (SERVE["slots"], cfg.vocab) or \
            not bool(torch.isfinite(lg).all()):
        raise AssertionError("prefill logits are not finite")
    print(f"tokens in [0, {cfg.vocab}), prefill logits finite")
    return counts


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs a GPU",
              file=sys.stderr)
        return 1
    # a float32 reference means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase("build")
    secs = build.build_all()
    print(f"kernels built in {secs:.1f}s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase("kernels against their plain versions")
    fa = check_kernels(torch.Generator(device="cuda").manual_seed(0))
    fa_bwd = check_fa_bwd(torch.Generator(device="cuda").manual_seed(0))
    scan = check_scan(torch.Generator(device="cuda").manual_seed(0))
    buckets = train_plan_buckets()
    print(f"training plan: {len(buckets)} gradient buckets, the largest "
          f"{max(buckets)} elements ({4 * max(buckets) / 2**20:.0f} MB)")
    onebit = check_onebit(torch.Generator(device="cuda").manual_seed(0),
                          [ONEBIT_ROWS, 300, max(buckets) // 1024])

    phase("reference: card against CPU on tiny configs")
    check_reference("qwen3-4b")
    check_reference("qwen2.5-3b")
    # the card's K2 sums the scan in 64-row tiles, the CPU's plain version
    # step by step: float32 sums in two orders, which the gated norms of
    # the mamba layers carry into the logits at about 1e-4, so zamba is
    # held to 1e-4 of the logits' scale
    check_reference("zamba2-2.7b", scaled=True)
    check_train_reference()

    launches = {arch: serve_full(arch) for arch in SERVE_ARCHS}
    launches["train"] = train_full(False, len(buckets))
    launches["ddp_onebit"] = train_full(True, len(buckets))

    for arch in SERVE_ARCHS:
        phase(f"where the time goes: {arch}, one prefill, one decode step "
              f"(not counted)")
        profile_steps(steps._serve_cfg(get_config(arch)), SERVE["slots"],
                      SERVE["prompt_len"])
    phase("where the time goes: one full-width train step, plain and world-1 "
          "DDP onebit (not counted)")
    profile_train(ddp=False)
    profile_train(ddp=True)

    phase("result")
    by_path = {fn.__name__: {path: c[fn.__name__]
                             for path, c in launches.items()}
               for fn in KERNELS}

    def entry(name, source, replaces, readings, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path[name].values()), **readings,
                "launches_by_path": by_path[name], **extra}
    fa_zamba = {f"zamba_{k}": v for k, v in fa[1].items()}
    largest = {k[len("largest_bucket_"):]: v for k, v in onebit.items()
               if k.startswith("largest_bucket_")}
    print(json.dumps({"kernels": [
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:86", fa[0], **fa_zamba),
        entry("flash_attention_bwd",
              "src/repro_torch/csrc/flash_attention.cu", None, fa_bwd,
              note="no Pallas counterpart: the JAX package differentiates "
                   "attend_chunked (src/repro/models/attention.py:130)"),
        entry("mamba2_chunk_scan", "src/repro_torch/csrc/mamba2_scan.cu",
              "src/repro/kernels/mamba2_scan.py:75", scan),
        entry("onebit_quantize", "src/repro_torch/csrc/onebit.cu",
              "src/repro/kernels/onebit.py:50", onebit["quantize"],
              largest_bucket=largest["quantize"]),
        entry("onebit_dequantize", "src/repro_torch/csrc/onebit.cu",
              "src/repro/kernels/onebit.py:80", onebit["dequantize"],
              largest_bucket=largest["dequantize"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
