#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit and
without the final ``{"ok": true, ...}`` line:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every hand-written kernel from ``src/repro_torch/csrc``;
3. kernels: hold each kernel against its plain PyTorch version on the
   card, at the serving paths' shapes and at the edge cases, and time the
   kernel, the plain version and (where one exists) one PyTorch library
   call at those shapes: K1 flash attention at qwen3-4b's and
   zamba2-2.7b's prefill shapes, K2 the Mamba-2 chunk scan at
   zamba2-2.7b's;
4. reference: the tiny dense and zamba configs served on the card agree
   with the same parameters served on the CPU (the port's CPU path is
   tied to the JAX package by the tests);
5. serve: ``Plan(arch=..., tiny=False).compile().serve(...)`` for
   qwen3-4b and for zamba2-2.7b, each at full width and full depth with
   random weights from a seed; every kernel launch count is set to 0 just
   before each run and read just after;
6. where the time goes: one prefill and one decode step of each;
7. the ``kernels`` JSON line, then the ``ok`` line last.

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
from repro_torch.frontend import Plan  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.mamba2_scan import (  # noqa: E402
    mamba2_chunk_scan, mamba2_chunk_scan_ref)

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# kernel-test tolerances of tests/test_kernels.py
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# (B, H, Hkv, S, d, dtype, causal, window): the serving slices' shapes
# first (qwen3-4b, then zamba2-2.7b's shared block), then the edge cases
FA_CASES = [
    (4, 32, 8, 512, 128, torch.bfloat16, True, None),
    (4, 32, 32, 512, 80, torch.bfloat16, True, None),     # d=80 (zamba)
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
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= i - j < window
    ops = 4 * d * B * H * int(keep.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return roofline(nbytes, ops)


def roofline(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` moved and ``ops`` bf16
    operations on the card, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, fn, (bound_ms, bound_by) in runs:
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
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d}"
                  f" {e.key[:90]}")


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
        flash_attention.launches = 0
        mamba2_chunk_scan.launches = 0
        res = session.serve(**SERVE)
        counts = {"flash_attention": flash_attention.launches,
                  "mamba2_chunk_scan": mamba2_chunk_scan.launches}
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
    scan = check_scan(torch.Generator(device="cuda").manual_seed(0))

    phase("reference: card against CPU on tiny configs")
    check_reference("qwen3-4b")
    check_reference("qwen2.5-3b")
    # the card's K2 sums the scan in 64-row tiles, the CPU's plain version
    # step by step: float32 sums in two orders, which the gated norms of
    # the mamba layers carry into the logits at about 1e-4, so zamba is
    # held to 1e-4 of the logits' scale
    check_reference("zamba2-2.7b", scaled=True)

    launches = {arch: serve_full(arch) for arch in SERVE_ARCHS}

    for arch in SERVE_ARCHS:
        phase(f"where the time goes: {arch}, one prefill, one decode step "
              f"(not counted)")
        profile_steps(steps._serve_cfg(get_config(arch)), SERVE["slots"],
                      SERVE["prompt_len"])

    phase("result")
    by_path = {name: {arch: launches[arch][name] for arch in SERVE_ARCHS}
               for name in ("flash_attention", "mamba2_chunk_scan")}
    fa_zamba = {f"zamba_{k}": v for k, v in fa[1].items()}
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:86",
         "launches": sum(by_path["flash_attention"].values()), **fa[0],
         "launches_by_path": by_path["flash_attention"], **fa_zamba},
        {"name": "mamba2_chunk_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba2_scan.cu",
         "replaces": "src/repro/kernels/mamba2_scan.py:75",
         "launches": sum(by_path["mamba2_chunk_scan"].values()), **scan,
         "launches_by_path": by_path["mamba2_chunk_scan"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
