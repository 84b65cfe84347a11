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
   prefill shapes, at Session.train's and at the serving gateway's
   batch-1 prefills, K1's backward at qwen3-4b's training shapes,
   zamba2-2.7b's shared block (d=80) and phi3-mini's heads (d=96)
   (against autograd through the plain version), each K1
   case also run twice to the same bits, bf16 on the tensor-core kernels
   and f32 on the CUDA-core ones; K2 the Mamba-2 chunk scan at
   zamba2-2.7b's (and at the gateway's batch 1), with B and C once per
   group (G=1, the model's) and per head (G=H), grouped and ragged, each
   case run twice to the same bits, bf16 on the tensor-core kernel and
   f32 on the CUDA-core one; K2's
   backward at zamba2-2.7b's training shape and at G=H, ragged, grouped,
   each (P, N) and with a final-state gradient, in both dtypes, through
   autograd and by its wrapper to the same bits; K3a/K3b the 1-bit codec
   at a 32 MB bucket and at the largest bucket of the training plan, and
   K3b also at small and wide rows; K1 also at granite-moe-1b-a400m's
   shapes (d=64: its prefill at batch 4 and the gateway's batch 1, its
   training batch 8, forward and backward).  Every time is taken twice
   (``timings``): on the device, and host-paced, as earlier versions of
   this script took it.  K1 refuses a bf16 view off a 16-byte boundary.
   One granite-moe-1b-a400m MoE layer at full width (2,048 tokens, bf16):
   each dispatch engine reruns to the same bits, and with no token dropped
   the two agree;
4. reference: the tiny dense and zamba configs served on the card agree
   with the same parameters served on the CPU (granite-moe-1b-a400m's
   too), and tiny qwen3-4b (plain,
   and world-1 DDP with the onebit codec) and tiny zamba2-2.7b train 8
   steps on the card with the CPU's losses (the port's CPU path is tied
   to the JAX package by the tests);
5. serve: ``Plan(arch=..., tiny=False).compile().serve(...)`` for
   qwen3-4b, zamba2-2.7b and granite-moe-1b-a400m, each at full width and
   full depth with random weights from a seed;
6. serve_stream: the serving gateway,
   ``Plan(arch=..., tiny=False).compile().serve_stream(...)``, for the
   same three at full width and depth: 8 requests arriving
   mid-flight, each prefilled once at batch 1 and parked in host pages
   until a slot frees; an independent greedy loop over the same steps
   reproduces two of the streams bit for bit, two replicas and the
   replica-death drill stream as one replica does, and (qwen3-4b) a live
   queue fed from another thread streams as the trace did;
7. train: ``Plan(arch="qwen3-4b", tiny=False, overrides={"n_layers":
   12}).compile().train(...)`` at full width, plain and as world-1 DDP
   with the onebit codec, and ``Plan(arch="zamba2-2.7b",
   tiny=False).compile().train(...)`` and ``Plan(arch=
   "granite-moe-1b-a400m", tiny=False).compile().train(...)`` at full
   width and depth;
8. checkpoint drill, granite-moe-1b-a400m at full size: 6 steps straight
   (saved at step 6), then 6 steps saving every 3 with an injected
   failure at step 4, then ``resume=True`` to step 6 from the step-3
   checkpoint; the resumed losses, parameters and optimizer state (every
   leaf's checksum) are bit-identical to the straight run's.  Prints the
   checkpoint's bytes, each save's host copy and write and the restore
   (wall time, GB/s) and the disk's size;
9. HAR CNN: the paper's Fig. 1 model, loss and gradients at minibatch
   8,000 on the card against the CPU, and its forward's device time;
10. where the time goes: one prefill (at the wave's batch and at batch 1)
   and one decode step of each served configuration, one plain and one
   DDP qwen3-4b train step, one zamba2-2.7b and one granite-moe-1b-a400m
   train step; the prefills
   and the train steps must show K1's tensor-core kernels by name and
   none of its f32 kernels,
   zamba2-2.7b's prefill and train step K2's tensor-core kernel and not
   its f32 one, the zamba2-2.7b train step K2's backward kernel, the DDP
   step K3b's row-stream kernel;
11. the gateway's and the checkpoint's readings as JSON lines, the
   ``kernels`` JSON line, then the ``ok`` line last.

Every kernel launch count is set to 0 just before each run of phases 5,
6 and 7 and of the drill's resumed run, and read just after; each run
asserts the counts its layers give.

It imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from repro_torch.checkpoint import checkpoint as ckpt_io  # noqa: E402
from repro_torch.checkpoint import format as ckfmt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.core.sharding import init_params, is_spec  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    HARStream, stream_for, to_device)
from repro_torch.core.paging import InferenceCache  # noqa: E402
from repro_torch.frontend import Plan  # noqa: E402
from repro_torch.frontend import gateway  # noqa: E402
from repro_torch.frontend.gateway import RequestQueue  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_ref)
from repro_torch.kernels.mamba2_scan import (  # noqa: E402
    TILE as SCAN_TILE, mamba2_chunk_scan, mamba2_chunk_scan_bwd,
    mamba2_chunk_scan_bwd_ref, mamba2_chunk_scan_ref)
from repro_torch.models import attention, cnn, moe, ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
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
# zamba2-2.7b's training slice: full width and full depth (54 layers; its
# float32 parameters, gradients and adamw state are 2.42 B x 16 B, 39 GB)
ZAMBA_TRAIN = dict(arch="zamba2-2.7b", tiny=False, batch=8, seq=512)
_ZAMBA_CFG = get_config(ZAMBA_TRAIN["arch"])
ZAMBA_HEADS = _ZAMBA_CFG.expand * _ZAMBA_CFG.d_model // _ZAMBA_CFG.ssm_head_dim
# the training slice's attention: (B, H, Hkv, S, d, dtype, causal,
# window) with B the whole batch (Session.train) or one DDP shard
_TRAIN_CFG = get_config(TRAIN["arch"])
TRAIN_ATTN = (TRAIN["batch"], _TRAIN_CFG.n_heads, _TRAIN_CFG.n_kv_heads,
              TRAIN["seq"], _TRAIN_CFG.head_dim, torch.bfloat16, True, None)
TRAIN_SHARD_ATTN = (TRAIN["batch"] // TRAIN_DDP_SHARDS, *TRAIN_ATTN[1:])
# zamba2-2.7b's training shapes: the shared block's attention (d=80), as
# FA_CASES give them, and the scan, as SCAN_CASES give them
ZAMBA_TRAIN_ATTN = (ZAMBA_TRAIN["batch"], _ZAMBA_CFG.n_heads,
                    _ZAMBA_CFG.n_kv_heads, ZAMBA_TRAIN["seq"],
                    _ZAMBA_CFG.head_dim, torch.bfloat16, True, None)
ZAMBA_TRAIN_SCAN = (ZAMBA_TRAIN["batch"], ZAMBA_HEADS, _ZAMBA_CFG.ssm_groups,
                    ZAMBA_TRAIN["seq"], _ZAMBA_CFG.ssm_head_dim,
                    _ZAMBA_CFG.ssm_state, _ZAMBA_CFG.ssm_chunk,
                    torch.bfloat16)
# granite-moe-1b-a400m trains at full width and full depth (24 layers,
# 1.385 B parameters: 22 GB of float32 state with adamw), serves in bf16,
# and runs the checkpoint drill: (params, opt) is 1.385 B x 12 B, 16.6 GB
MOE_TRAIN = dict(arch="granite-moe-1b-a400m", tiny=False, batch=8, seq=512)
_MOE_CFG = get_config(MOE_TRAIN["arch"])
MOE_TRAIN_ATTN = (MOE_TRAIN["batch"], _MOE_CFG.n_heads, _MOE_CFG.n_kv_heads,
                  MOE_TRAIN["seq"], _MOE_CFG.head_dim, torch.bfloat16, True,
                  None)
# the drill: saves every CKPT_EVERY steps, fails at step CKPT_FAIL_AT, and
# needs room for two committed checkpoints beside a temp one on the disk;
# where there is none, the drill's depth is cut (printed)
CKPT_EVERY, CKPT_FAIL_AT = 3, 4
CKPT_DISK_SHARE = 0.8
# one MoE layer at granite's full width: 2,048 tokens (4 x 512, the serve
# prefill's), bf16; with cap_factor E / k no assignment can drop
MOE_LAYER_TOKENS = 2048
# the HAR CNN of the paper's Fig. 1, at its minibatch; the card's float32
# against the CPU's: the loss within HAR_LOSS_RTOL, each gradient leaf
# within HAR_GRAD_TOL of its largest |gradient| (sums in other orders)
HAR_BATCH = 8000
HAR_LOSS_RTOL = 1e-5
HAR_GRAD_TOL = 1e-4
SERVE = dict(requests=8, slots=4, prompt_len=512, gen_len=32)
SERVE_ARCHS = ("qwen3-4b", "zamba2-2.7b", "granite-moe-1b-a400m")
# the serving gateway prefills every request alone: K1 at batch 1 for
# qwen3-4b and zamba2-2.7b's shared block, K2 at batch 1
SERVE_B1_ATTN = (1, _TRAIN_CFG.n_heads, _TRAIN_CFG.n_kv_heads,
                 SERVE["prompt_len"], _TRAIN_CFG.head_dim, torch.bfloat16,
                 True, None)
ZAMBA_SERVE_B1_ATTN = (1, _ZAMBA_CFG.n_heads, _ZAMBA_CFG.n_kv_heads,
                       SERVE["prompt_len"], _ZAMBA_CFG.head_dim,
                       torch.bfloat16, True, None)
MOE_SERVE_ATTN = (SERVE["slots"], *MOE_TRAIN_ATTN[1:])
MOE_SERVE_B1_ATTN = (1, *MOE_TRAIN_ATTN[1:])
SERVE_B1_SCAN = (1, ZAMBA_HEADS, _ZAMBA_CFG.ssm_groups, SERVE["prompt_len"],
                 _ZAMBA_CFG.ssm_head_dim, _ZAMBA_CFG.ssm_state,
                 _ZAMBA_CFG.ssm_chunk, torch.bfloat16)
# the gateway's runs (serve_stream): 8 requests arriving at these decode
# rounds into SERVE's 4 slots; the independent greedy loop replays two of
# them; the drill kills replica 0 at round 3; qwen3-4b's live queue takes
# the first four prompts
GATEWAY_ARRIVALS = (0, 0, 0, 1, 1, 4, 9, 20)
GATEWAY_ORACLE = ("r0", "r5")
GATEWAY_KILL = (0, 3)
GATEWAY_LIVE = 4
PAGE_BYTES = 1 << 16        # serve_stream's default page size
# (B, H, Hkv, S, d, dtype, causal, window): the serving slices' shapes
# first (qwen3-4b, then zamba2-2.7b's shared block), then Session.train's
# (qwen3-4b, then zamba2-2.7b), then the gateway's batch-1 prefills (the
# same two), then granite-moe-1b-a400m's (d=64: serve prefill, gateway
# batch 1, training), then the edge cases.  bf16 runs the
# tensor-core kernels, f32 the CUDA-core kernels, so each edge is held in
# both dtypes.
FA_CASES = [
    (4, 32, 8, 512, 128, torch.bfloat16, True, None),
    (4, 32, 32, 512, 80, torch.bfloat16, True, None),     # d=80 (zamba)
    TRAIN_ATTN,
    ZAMBA_TRAIN_ATTN,
    SERVE_B1_ATTN,
    ZAMBA_SERVE_B1_ATTN,
    MOE_SERVE_ATTN,
    MOE_SERVE_B1_ATTN,
    MOE_TRAIN_ATTN,
    (2, 8, 2, 200, 128, torch.bfloat16, True, None),      # ragged S
    (1, 32, 32, 256, 96, torch.bfloat16, True, None),     # d=96 (phi3)
    (2, 4, 2, 256, 32, torch.float32, True, None),        # d=32 f32 (tiny)
    (2, 16, 4, 512, 128, torch.bfloat16, True, 128),      # window
    (1, 4, 4, 300, 64, torch.float32, False, None),       # non-causal d=64
    (2, 4, 2, 256, 32, torch.bfloat16, True, None),       # d=32 bf16
    (2, 4, 2, 256, 64, torch.bfloat16, True, None),       # d=64 bf16, GQA
    (1, 4, 4, 300, 64, torch.bfloat16, False, None),      # non-causal bf16
    (2, 4, 4, 100, 80, torch.bfloat16, True, None),       # d=80, ragged S
    (1, 8, 8, 512, 80, torch.bfloat16, True, 128),        # d=80, window
]
FA_TIMED = 9            # the first FA_TIMED cases are timed
# K2 tolerances of tests/test_kernels.py's sweep, as atol and rtol
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
# (B, H, G, L, P, N, chunk, dtype), G the groups of Bm, Cm: zamba2-2.7b's
# prefill shape in bf16 with its one group (timed, the serve path's case)
# and with B, C per head (timed), its training shape (B=8, timed), the
# gateway's batch-1 prefill (timed), then
# f32 at the prefill shape and the three shapes of tests/test_kernels.py's
# sweep (B, C per head), grouped cases (H=4, G=2) in both dtypes, a ragged
# bf16 case, and bf16 at the other (P, N) the kernel is built for
SCAN_CASES = [
    (4, 80, 1, 512, 64, 64, 256, torch.bfloat16),
    (4, 80, 80, 512, 64, 64, 256, torch.bfloat16),
    ZAMBA_TRAIN_SCAN,
    SERVE_B1_SCAN,
    (4, 80, 80, 512, 64, 64, 256, torch.float32),
    (1, 2, 2, 256, 32, 16, 64, torch.float32),
    (2, 4, 4, 128, 64, 64, 32, torch.float32),
    (1, 1, 1, 512, 16, 8, 128, torch.float32),
    (2, 4, 2, 128, 64, 64, 32, torch.bfloat16),
    (2, 4, 2, 128, 64, 64, 32, torch.float32),
    (2, 4, 1, 200, 64, 64, 200, torch.bfloat16),          # ragged L
    (1, 2, 2, 256, 32, 16, 64, torch.bfloat16),
    (1, 1, 1, 512, 16, 8, 128, torch.bfloat16),
]
SCAN_TIMED = 4          # the first SCAN_TIMED cases are timed
# K1 backward: qwen3-4b's training shapes (a DDP shard, then the whole
# batch of Session.train), zamba2-2.7b's shared block in training (d=80),
# phi3-mini's heads (d=96) and granite-moe-1b-a400m's training shape
# (d=64), all five timed, then small shapes in
# float32 and their bf16 twins: GQA and MHA, causal on and off, a window,
# ragged S, each head dim the backward is built for
FA_BWD_CASES = [
    TRAIN_SHARD_ATTN,
    TRAIN_ATTN,
    ZAMBA_TRAIN_ATTN,
    (1, 32, 32, 512, 96, torch.bfloat16, True, None),     # phi3-mini heads
    MOE_TRAIN_ATTN,
    (2, 8, 2, 200, 64, torch.float32, True, None),        # GQA, ragged S
    (1, 4, 4, 256, 64, torch.float32, False, None),       # MHA, non-causal
    (2, 4, 2, 256, 32, torch.float32, True, 64),          # window, d=32
    (1, 8, 2, 130, 128, torch.float32, True, None),       # d=128 f32
    (2, 4, 4, 96, 32, torch.float32, False, None),        # tiny's head dim
    (2, 8, 2, 200, 64, torch.bfloat16, True, None),
    (1, 4, 4, 256, 64, torch.bfloat16, False, None),
    (2, 4, 2, 256, 32, torch.bfloat16, True, 64),
    (1, 8, 2, 130, 128, torch.bfloat16, True, None),
    (2, 4, 4, 96, 32, torch.bfloat16, False, None),
    (2, 4, 4, 100, 80, torch.float32, True, None),        # d=80, ragged S
    (2, 4, 4, 100, 80, torch.bfloat16, True, None),
    (2, 4, 2, 130, 96, torch.float32, True, None),        # d=96, GQA
    (2, 4, 2, 130, 96, torch.bfloat16, True, None),
]
FA_BWD_TIMED = 5        # the first FA_BWD_TIMED cases are timed
# f32: within 1e-4 of the largest gradient magnitude (at least 1); bf16:
# the plain version rounds its products and probabilities to bf16, the
# kernel sums in f32, so bf16 is held to 3e-2 of the largest magnitude
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2 backward, (B, H, G, L, P, N, dtype, dstate): zamba2-2.7b's training
# shape in bf16 with its one group (timed), then B and C per head (G=H), a
# ragged L with grouped heads, the two other (P, N) the kernels are built
# for, and a nonzero final-state gradient (the bf16 kernel's seed of R),
# each in f32 (ssd_scan_bwd) and bf16 (ssd_scan_bwd_mma)
SCAN_BWD_CASES = [
    (ZAMBA_TRAIN["batch"], ZAMBA_HEADS, 1, ZAMBA_TRAIN["seq"], 64, 64,
     torch.bfloat16, False),
    (2, 16, 16, 256, 64, 64, torch.float32, False),
    (2, 16, 16, 256, 64, 64, torch.bfloat16, False),
    (2, 4, 2, 200, 64, 64, torch.float32, False),         # ragged L
    (2, 4, 2, 200, 64, 64, torch.bfloat16, False),
    (1, 2, 2, 256, 32, 16, torch.float32, False),
    (1, 2, 2, 256, 32, 16, torch.bfloat16, False),
    (1, 1, 1, 512, 16, 8, torch.float32, False),
    (1, 1, 1, 512, 16, 8, torch.bfloat16, False),
    (2, 4, 1, 130, 64, 64, torch.float32, True),          # dstate
    (2, 4, 1, 130, 64, 64, torch.bfloat16, True),
]
# f32: within 1e-4 of the largest gradient magnitude (at least 1): both
# sum in f32, in other orders.  bf16: the inputs are the same bf16 values
# on both sides and both sum in f32, but the kernel's products take bf16
# operands it computes (G, D, the states, x (.) w, exp(cs) (.) dY) and the
# outputs are rounded to bf16 (2**-9 of a value): 1e-2 of the largest
# magnitude (tests/test_torch_mamba2_scan.py holds this rounding plan
# within it against the JAX oracle)
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
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
# every step's gradient norm (before clipping) within this relative
# tolerance: tiny zamba's float32 and float64 plain paths on the CPU part
# by up to 5.9e-5 in it in 8 momentum steps (tools/zamba_precision_check.py)
TRAIN_REF_GNORM_RTOL = 1e-3
# (arch, codec, optimizer) of the tiny card-against-CPU training runs.
# Tiny zamba (f32) runs K2's f32 forward and backward at (P, N) = (32, 16)
# and K1's at d=32, with momentum: its float32 gradients are
# ill-conditioned (tests/test_torch_train.py), and adamw's normalized step
# turns each near-zero one whose sign differs between two summation orders
# into a whole +-lr step, so two float32 adamw runs part within a few
# steps (0.54 % in loss by step 8 between an H100 and the CPU, 0.72 %
# between float32 and float64 on the CPU: tools/zamba_precision_check.py);
# momentum's step is proportional to the gradient
TRAIN_REF_RUNS = (("qwen3-4b", "plain", "adamw"),
                  ("qwen3-4b", "onebit", "adamw"),
                  ("zamba2-2.7b", "plain", "momentum"))
# zamba2-2.7b's gradients through the kernels against the plain versions
# on the card: one group (6 mamba layers and the shared block) at full
# width, float32, GRAD_CHECK_BATCH x seq 512.  The loss within
# GRAD_CHECK_LOSS_RTOL, each leaf's gradient within GRAD_CHECK_TOL of that
# leaf's largest |gradient| (tests/test_torch_train.py holds tiny zamba's
# leaves to the same share).  Deeper, the random-init stack parts any two
# float32 computations, the plain version's float32 from its float64 as
# well (PERF.md, tools/zamba_precision_check.py).
GRAD_CHECK_LAYERS = 6
GRAD_CHECK_BATCH = 2
GRAD_CHECK_LOSS_RTOL = 1e-5
GRAD_CHECK_TOL = 1e-3
# K1's kernels by the names the profiler gives them: bf16 must run the
# tensor-core kernels and never the f32 CUDA-core ones
K1_TC = {"forward": "attn_fwd_wgmma", "dkdv": "attn_bwd_dkdv_wgmma",
         "dq": "attn_bwd_dq_wgmma"}
K1_F32 = ("fa_fwd<", "fa_bwd_dkdv<", "fa_bwd_dq<")
# K2's kernels and K3b's by the names the profiler gives them: zamba's bf16
# prefill and training must run the tensor-core scans, forward and
# backward, and never the f32 ones
K2_TC, K2_F32 = "ssd_scan_mma", "ssd_scan<"
K2_BWD_TC, K2_BWD_F32 = "ssd_scan_bwd_mma", "ssd_scan_bwd<"
K3B = "onebit_dequant_rows"
# K3b's other row widths (R, C): several rows a block, a loop over a row
DEQUANT_SHAPES = ((7, 128), (3, 4096))


def phase(name: str):
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, iters: int = 20, warm: int = 3, spin: bool = True) -> float:
    """Time of one call of ``fn``: CUDA events around ``iters`` calls.
    With ``spin`` the calls are queued behind a device-side spin that
    outlasts their enqueueing, so that the card runs them back to back and
    the events time the card (a call of a few tens of microseconds on the
    card can take longer than that to launch from Python).  Without it
    the calls are launched with nothing queued ahead (the method of this
    script's earlier readings), and a call shorter than its launch is timed
    at the host's launch rate."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        # twice the host's enqueue time of the timed calls, in cycles at up
        # to 2 GHz, capped at about a second
        torch.cuda._sleep(int(min(2 * iters * host_s, 1.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(iters: int = 20, warm: int = 3, **fns) -> dict:
    """For each ``key=fn`` (``fn`` None where there is no such call): under
    ``key`` its device time (``cuda_ms``) and under ``key + "_host_paced"``
    its time launched with nothing queued ahead, the two readings of every
    time in the kernels line."""
    out = {}
    for key, fn in fns.items():
        for suffix, spin in (("", True), ("_host_paced", False)):
            out[key + suffix] = (None if fn is None
                                 else cuda_ms(fn, iters, warm, spin))
    return out


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


def weight_uses(cfg, tree) -> float:
    """Elements of the matrices in ``tree`` that one token multiplies:
    every matrix, but a mixture of experts' expert weights only top_k /
    n_experts of them (the router's for every token)."""
    total = sum(t.numel() for t in pytree.tree_leaves(tree) if t.dim() >= 2)
    if cfg.family == "moe":
        experts = sum(t.numel() for layer in tree
                      for k, t in layer["moe"].items() if k != "router")
        total -= experts * (cfg.n_experts - cfg.top_k) // cfg.n_experts
    return total


def step_bound(cfg, params, cache, slots: int, new_tokens: int,
               keys_seen: int) -> tuple[float, str]:
    """Least time for one prefill (``new_tokens`` per row) or decode step
    (1): every weight but the embedding table (a gather of a few rows)
    and the whole cache moved once; 2 operations per weight use and new
    token in the layers' products (zamba's shared block is used once per
    group, a moe token uses top_k of the experts: ``weight_uses``), the
    unembedding of one token a row, attention's 4*hd per
    (query, key) pair of ``keys_seen`` pairs a row and head in each
    attention layer (counted from the cache), and the SSD scan of each
    mamba layer (``scan_ops``)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves((params, cache)))
    emb = params["embed"]["tok"]
    nbytes -= emb.numel() * emb.element_size()
    n_attn = len(_kv_caches(cache))

    uses = weight_uses(cfg, params["stack"])
    if cfg.family == "zamba":
        uses += (n_attn - 1) * weight_uses(cfg, params["stack"]["shared"])
    ops = (2 * slots * new_tokens * uses
           + 2 * slots * params["unembed"]["w"].numel()
           + 4 * cfg.head_dim * slots * cfg.n_heads * keys_seen * n_attn)
    if cfg.family == "zamba":
        H = cfg.expand * cfg.d_model // cfg.ssm_head_dim
        ops += cfg.n_layers * scan_ops(slots, H, new_tokens,
                                       cfg.ssm_head_dim, cfg.ssm_state)
    return roofline(nbytes, ops)


def check_kernels(gen) -> list:
    """K1 against its plain version at ``FA_CASES``, and against itself:
    a second run on the same inputs gives the same bits.  Times the first
    ``FA_TIMED`` cases and returns their readings."""
    out = []
    for B, H, Hkv, S, d, dt, causal, window in FA_CASES:
        q = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        got = flash_attention(q, k, v, causal=causal, window=window)
        again = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, again)
        ok = err <= TOL[dt] and bool(torch.isfinite(got).all()) and same
        print(f"flash_attention B={B} H={H} Hkv={Hkv} S={S} d={d} "
              f"{str(dt)[6:]} causal={causal} window={window}: max abs err "
              f"{err:.3g} (tolerance {TOL[dt]:g}), rerun "
              f"{'bit-identical' if same else 'DIFFERS'} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version ({err} > {TOL[dt]}) or itself")
        if len(out) < FA_TIMED:          # a serving slice's shape: time it
            t = timings(
                ms=lambda: flash_attention(q, k, v, causal=causal),
                plain_ms=lambda: flash_attention_ref(q, k, v, causal=causal),
                library_ms=lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
            bound_ms, bound_by = attention_bound(q, k, v, causal, window)
            out.append({"max_abs_err": err, **t, "bound_ms": bound_ms,
                        "bound_by": bound_by})
            print(f"  timed: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
                  f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}); host-paced: kernel "
                  f"{t['ms_host_paced']:.4f} ms, plain "
                  f"{t['plain_ms_host_paced']:.4f} ms, library "
                  f"{t['library_ms_host_paced']:.4f} ms")
    return out


def check_misaligned() -> None:
    """A contiguous bf16 view 2 bytes into its storage: K1's bf16 kernels
    read in 16-byte words and would fault on it, so the wrapper refuses
    it."""
    q = torch.zeros(1 + 4 * 64 * 64, dtype=torch.bfloat16,
                    device="cuda")[1:].view(1, 4, 64, 64)
    try:
        flash_attention(q, q, q)
    except ValueError as e:
        print(f"flash_attention of a bf16 view off a 16-byte boundary: "
              f"refused ({e}) ok")
    else:
        raise AssertionError("flash_attention took a misaligned bf16 view")


def check_scan(gen) -> dict:
    """K2 against its plain version at ``SCAN_CASES``, inputs built as
    tests/test_kernels.py builds them (xdt, Bm, Cm scaled by 0.5, a =
    -|n| * 0.1), and against itself: a second run on the same inputs gives
    the same bits.  Times the first ``SCAN_TIMED`` cases; returns the
    first's readings with the second's under ``per_head_bc``, the third's
    under ``train_b8`` and the fourth's under ``serve_b1``.  No single
    PyTorch call computes the SSD scan, so there is no library time."""
    out = []
    for B, H, G, L, P, N, chunk, dt in SCAN_CASES:
        xdt = (0.5 * torch.randn(B, H, L, P, generator=gen,
                                 device="cuda")).to(dt)
        a = -0.1 * torch.randn(B, H, L, generator=gen, device="cuda").abs()
        Bm = (0.5 * torch.randn(B, G, L, N, generator=gen,
                                device="cuda")).to(dt)
        Cm = (0.5 * torch.randn(B, G, L, N, generator=gen,
                                device="cuda")).to(dt)
        y, st = mamba2_chunk_scan(xdt, a, Bm, Cm, chunk=chunk)
        y2, st2 = mamba2_chunk_scan(xdt, a, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        same = torch.equal(y, y2) and torch.equal(st, st2)
        y_ref, st_ref = mamba2_chunk_scan_ref(xdt, a, Bm, Cm)
        tol = SCAN_TOL[dt]
        errs, ok = [], same
        for got, want in ((y.float(), y_ref.float()), (st, st_ref)):
            diff = (got - want).abs()
            errs.append(diff.max().item())
            ok &= bool((diff <= tol + tol * want.abs()).all()) \
                and bool(torch.isfinite(got).all())
        print(f"mamba2_chunk_scan B={B} H={H} G={G} L={L} P={P} N={N} "
              f"chunk={chunk} {str(dt)[6:]}: max abs err y {errs[0]:.3g}, "
              f"state {errs[1]:.3g} (atol = rtol = {tol:g}), rerun "
              f"{'bit-identical' if same else 'DIFFERS'} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("mamba2_chunk_scan disagrees with its plain "
                                 "version or itself")
        if len(out) >= SCAN_TIMED:
            continue
        t = {**timings(ms=lambda: mamba2_chunk_scan(xdt, a, Bm, Cm,
                                                    chunk=chunk),
                       library_ms=None),
             **timings(iters=3, warm=1, plain_ms=lambda:
                       mamba2_chunk_scan_ref(xdt, a, Bm, Cm))}
        bound_ms, bound_by = scan_bound(
            xdt, a, Bm, Cm, st.numel() * st.element_size())
        out.append({"max_abs_err": max(errs), **t, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        print(f"  timed: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, no library call, bound {bound_ms:.4f} ms ({bound_by}); "
              f"host-paced: kernel {t['ms_host_paced']:.4f} ms")
    return {**out[0], "per_head_bc": out[1], "train_b8": out[2],
            "serve_b1": out[3]}


def scan_bwd_ops(B: int, H: int, L: int, P: int, N: int) -> int:
    """Operations of the SSD scan's backward in the kernel's tiles of
    ``SCAN_TILE`` rows: per tile C B^T, dY X^T, G^T dY, D^T C and D B over
    the tile's rows, and B R^T, X R, dY S0, the reverse state's and the
    forward state's updates over [P, N]."""
    t = min(SCAN_TILE, L)
    return 2 * B * H * L * (t * (3 * N + 2 * P) + 5 * P * N)


def check_scan_bwd(gen) -> dict:
    """K2's backward kernel against autograd through the plain version on
    the card at ``SCAN_BWD_CASES``, inputs built as ``check_scan`` builds
    them, y's gradient normal, the final state's normal where the case
    has one.  The kernel runs twice: through autograd (the path's route,
    ``mamba2_chunk_scan`` recorded by autograd) and by its wrapper; the
    two give the same bits.  Times the first case: the wrapper, and the
    plain version's backward of a recorded graph; no single PyTorch call
    computes the scan's backward, so there is no library time."""
    out = None
    for B, H, G, L, P, N, dt, with_ds in SCAN_BWD_CASES:
        xdt = (0.5 * torch.randn(B, H, L, P, generator=gen,
                                 device="cuda")).to(dt)
        a = -0.1 * torch.randn(B, H, L, generator=gen, device="cuda").abs()
        Bm = (0.5 * torch.randn(B, G, L, N, generator=gen,
                                device="cuda")).to(dt)
        Cm = (0.5 * torch.randn(B, G, L, N, generator=gen,
                                device="cuda")).to(dt)
        dy = torch.randn(B, H, L, P, generator=gen, device="cuda").to(dt)
        ds = (torch.randn(B, H, P, N, generator=gen, device="cuda")
              if with_ds else None)
        ins = [t.clone().requires_grad_(True) for t in (xdt, a, Bm, Cm)]
        y, st = mamba2_chunk_scan(*ins, chunk=min(256, L))
        got = torch.autograd.grad([y, st] if with_ds else [y], ins,
                                  [dy, ds] if with_ds else [dy])
        again = mamba2_chunk_scan_bwd(xdt, a, Bm, Cm, dy, ds)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, again))
        want = mamba2_chunk_scan_bwd_ref(xdt, a, Bm, Cm, dy, ds)
        errs, ok = [], same
        for g, w in zip(got, want):
            limit = SCAN_BWD_TOL[dt] * max(1.0, w.float().abs().max().item())
            e = (g.float() - w.float()).abs().max().item()
            errs.append(e)
            ok &= g.dtype == w.dtype and e <= limit \
                and bool(torch.isfinite(g).all())
        print(f"mamba2_chunk_scan_bwd B={B} H={H} G={G} L={L} P={P} N={N} "
              f"{str(dt)[6:]} dstate={'yes' if with_ds else 'no'}: max abs "
              f"err dxdt {errs[0]:.3g} da {errs[1]:.3g} dBm {errs[2]:.3g} "
              f"dCm {errs[3]:.3g} (tolerance {SCAN_BWD_TOL[dt]:g} x max(1, "
              f"max |grad|)), rerun {'bit-identical' if same else 'DIFFERS'}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("mamba2_chunk_scan_bwd disagrees with "
                                 "autograd through the plain version or "
                                 "with itself")
        if out is not None:
            continue
        ref_ins = [t.detach().requires_grad_(True) for t in (xdt, a, Bm, Cm)]
        ref_y, _ = mamba2_chunk_scan_ref(*ref_ins)
        t = {**timings(ms=lambda: mamba2_chunk_scan_bwd(xdt, a, Bm, Cm, dy),
                       library_ms=None),
             **timings(iters=3, warm=1, plain_ms=lambda: torch.autograd.grad(
                 ref_y, ref_ins, dy, retain_graph=True))}
        del ref_y, ref_ins
        nbytes = 2 * sum(u.numel() * u.element_size()
                         for u in (xdt, a, Bm, Cm)) \
            + dy.numel() * dy.element_size()
        ops = scan_bwd_ops(B, H, L, P, N)
        bound_ms, bound_by = roofline(nbytes, ops)
        out = {"max_abs_err": max(errs), **t, "bound_ms": bound_ms,
               "bound_by": bound_by}
        print(f"  timed: kernel {t['ms']:.4f} ms, plain backward "
              f"{t['plain_ms']:.4f} ms, no library call, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP); host-paced: kernel "
              f"{t['ms_host_paced']:.4f} ms")
        torch.cuda.empty_cache()
    return out


def check_dequant_shapes(gen) -> None:
    """K3b bit-identical to its plain version at ``DEQUANT_SHAPES``, on
    random words and scales."""
    for R, C in DEQUANT_SHAPES:
        packed = torch.randint(-2**31, 2**31 - 1, (R, C // 32),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        scale = torch.rand(R, 1, generator=gen, device="cuda")
        got = onebit_dequantize(packed, scale)
        torch.cuda.synchronize()
        same = torch.equal(got, onebit_dequantize_ref(packed, scale))
        print(f"onebit_dequantize [{R}, {C}]: "
              f"{'identical' if same else 'DIFFERS'} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("onebit_dequantize disagrees with its plain "
                                 "version")


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


def check_fa_bwd(gen) -> list:
    """K1's backward kernel against autograd through the plain version on
    the card at ``FA_BWD_CASES``, and against itself: a second backward of
    the same graph gives the same bits (no atomics).  Times the first
    ``FA_BWD_TIMED`` cases: the kernel (from the forward's o and lse), the
    plain version's backward and ``scaled_dot_product_attention``'s
    backward; returns their readings."""
    out = []
    for B, H, Hkv, S, d, dt, causal, window in FA_BWD_CASES:
        q = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        dout = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        kern_out = flash_attention(q, k, v, causal=causal, window=window)
        got = torch.autograd.grad(kern_out, (q, k, v), dout,
                                  retain_graph=True)
        again = torch.autograd.grad(kern_out, (q, k, v), dout,
                                    retain_graph=True)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want_out = flash_attention_ref(q, k, v, causal=causal, window=window)
        want = torch.autograd.grad(want_out, (q, k, v), dout,
                                   retain_graph=True)
        errs, ok = [], True
        for g, w in zip(got, want):
            limit = FA_BWD_TOL[dt] * max(1.0, w.float().abs().max().item())
            e = (g.float() - w.float()).abs().max().item()
            errs.append(e)
            ok &= e <= limit and bool(torch.isfinite(g).all())
        ok &= same
        print(f"flash_attention_bwd B={B} H={H} Hkv={Hkv} S={S} d={d} "
              f"{str(dt)[6:]} causal={causal} window={window}: max abs err "
              f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} "
              f"(tolerance {FA_BWD_TOL[dt]:g} x max(1, max |grad|)), rerun "
              f"{'bit-identical' if same else 'DIFFERS'} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention_bwd disagrees with "
                                 "autograd through the plain version or "
                                 "with itself")
        if len(out) >= FA_BWD_TIMED:
            continue
        # a training shape: time the backward alone, each call re-running
        # the recorded graph's backward
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                 enable_gqa=True)
        t = {**timings(ms=lambda: torch.autograd.grad(
                 kern_out, (q, k, v), dout, retain_graph=True),
                       library_ms=lambda: torch.autograd.grad(
                 lib_out, (q, k, v), dout, retain_graph=True)),
             **timings(iters=5, plain_ms=lambda: torch.autograd.grad(
                 want_out, (q, k, v), dout, retain_graph=True))}
        esz = q.element_size()
        nbytes = (4 * q.numel() + 4 * k.numel()) * esz + 4 * B * H * S
        ops = 10 * d * B * H * causal_pairs(S, causal, window)
        bound_ms, bound_by = roofline(nbytes, ops)
        out.append({"max_abs_err": max(errs), **t, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        print(f"  timed: kernel {t['ms']:.4f} ms, plain backward "
              f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"backward {t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); "
              f"host-paced: kernel {t['ms_host_paced']:.4f} ms, plain "
              f"{t['plain_ms_host_paced']:.4f} ms, library "
              f"{t['library_ms_host_paced']:.4f} ms")
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
        tq = timings(iters, ms=lambda: onebit_quantize(g, err),
                     plain_ms=lambda: onebit_quantize_ref(g, err),
                     library_ms=None)
        td = timings(iters, ms=lambda: onebit_dequantize(packed, scale),
                     plain_ms=lambda: onebit_dequantize_ref(packed, scale),
                     library_ms=None)
        # K3a: g, err read; new_err, words, scales written; add, |.|, sum,
        # compare and subtract an element.  K3b: words and scales read, the
        # output written; a shift, a mask and a select an element.
        qb, qby = roofline(12 * el + el // 8 + 4 * R, 5 * el, F32_FLOPS)
        db, dby = roofline(4 * el + el // 8 + 4 * R, 3 * el, F32_FLOPS)
        key = "" if n == 0 else "largest_bucket_"
        out[key + "quantize"] = {"max_abs_err": e_err, **tq,
                                 "bound_ms": qb, "bound_by": qby}
        out[key + "dequantize"] = {"max_abs_err": 0.0, **td,
                                   "bound_ms": db, "bound_by": dby}
        print(f"  quantize: kernel {tq['ms']:.4f} ms, plain "
              f"{tq['plain_ms']:.4f} ms, bound {qb:.4f} ms ({qby}); "
              f"dequantize: kernel {td['ms']:.4f} ms, plain "
              f"{td['plain_ms']:.4f} ms, bound {db:.4f} ms ({dby}); no "
              f"library call; host-paced: kernels {tq['ms_host_paced']:.4f}"
              f", {td['ms_host_paced']:.4f} ms")
        del g, err, packed, scale, new_err, p_ref, s_ref, e_ref, deq
        torch.cuda.empty_cache()
    return out


def check_train_reference() -> None:
    """Tiny configs train ``TRAIN_REF_STEPS`` steps on the card and on the
    CPU from the same parameters and batches, through the loops' own
    steps (``TRAIN_REF_RUNS``): the plain train step of ``Session.train``
    (qwen3-4b, and zamba2-2.7b through K2's backward), and qwen3-4b's
    world-1 DDP engine with the onebit codec and two shards.  (The two
    devices' generators draw different parameters from one seed, so the
    card's are copied from the CPU's.)  The losses of every step agree
    within ``TRAIN_REF_RTOL``, their gradient norms within
    ``TRAIN_REF_GNORM_RTOL``."""
    from repro_torch.distrib.collectives import RingAllReduce
    from repro_torch.frontend.ddp import DDPEngine
    for arch, name, kind in TRAIN_REF_RUNS:
        oc = optimizers.OptConfig(kind=kind)
        runs = {}
        for dev in ("cpu", "cuda"):
            extra = (dict(ddp=True, grad_codec="onebit", ddp_shards=2)
                     if name == "onebit" else {})
            plan = Plan(arch=arch, tiny=True, batch=8, seq=64,
                        device=dev, **extra)
            cfg = plan.config()
            stream = stream_for(cfg, batch=plan.batch, seq=plan.seq)
            if name == "onebit":
                engine = DDPEngine(plan, RingAllReduce(None, 1))
                init, fn = engine.step.init, engine.train_step
            else:
                step = steps.make_train_step(cfg, steps.Strategy(opt=oc))
                init = step.init

                def fn(it, batch, params, opt, step=step, dev=dev):
                    return step.fn(params, opt, to_device(batch, dev))
            params, _ = init(torch.Generator().manual_seed(0), "cpu")
            params = pytree.tree_map(
                lambda t: t.detach().to(dev).requires_grad_(True), params)
            opt = optimizers.init(params, oc)
            losses, gnorms = [], []
            for it in range(TRAIN_REF_STEPS):
                m, params, opt = fn(it, stream.batch_at(it), params, opt)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            runs[dev] = losses, gnorms

        def worst(i):
            return max(abs(a - b) / abs(a) for a, b in zip(runs["cpu"][i],
                                                            runs["cuda"][i]))
        tol = TRAIN_REF_RTOL[name]
        cpu = runs["cpu"][0]
        print(f"{arch} tiny, {name} training, {kind}, {TRAIN_REF_STEPS} "
              f"steps: losses cpu " + " ".join(f"{x:.5f}" for x in cpu)
              + f" (range {max(cpu) - min(cpu):.4g}), card "
              + " ".join(f"{x:.5f}" for x in runs["cuda"][0])
              + f", max relative difference {worst(0):.3g} (tolerance "
              f"{tol:g}); gradient norms {runs['cpu'][1][0]:.5g} .. "
              f"{runs['cpu'][1][-1]:.5g}, max relative difference "
              f"{worst(1):.3g} (tolerance {TRAIN_REF_GNORM_RTOL:g})")
        if not (worst(0) <= tol and worst(1) <= TRAIN_REF_GNORM_RTOL):
            raise AssertionError(f"{arch} {name} training: the card "
                                 f"disagrees with the CPU")


def zamba_grads(model, params, batch, plain: bool) -> tuple:
    """(loss, gradients in leaf order) of ``model`` with the scan and
    attention through the kernels or, ``plain``, autograd through their
    plain versions (the model's module globals swapped for the call)."""
    kernels = ssm.mamba2_chunk_scan, attention.flash_attention
    if plain:
        ssm.mamba2_chunk_scan = (lambda xdt, a, Bm, Cm, chunk=0:
                                 mamba2_chunk_scan_ref(xdt, a, Bm, Cm))
        attention.flash_attention = flash_attention_ref
    try:
        leaves = pytree.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = model.loss(params, batch)
        loss.backward()
        grads = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return loss.item(), grads
    finally:
        ssm.mamba2_chunk_scan, attention.flash_attention = kernels


def check_zamba_grads() -> None:
    """zamba2-2.7b's loss and every parameter gradient through K1 and K2
    (forward and backward kernels, f32) against autograd through their
    plain versions, on the card, at full width with ``GRAD_CHECK_LAYERS``
    layers and random weights from seed 0; the kernel route's launches
    are those nested remat gives (per mamba layer K2's forward 3 times,
    its backward once; per group K1's forward twice, its backward once)."""
    plan = Plan(arch=ZAMBA_TRAIN["arch"], tiny=False, batch=GRAD_CHECK_BATCH,
                seq=ZAMBA_TRAIN["seq"], device="cuda",
                overrides={"n_layers": GRAD_CHECK_LAYERS,
                           "compute_dtype": "f32"})
    cfg = plan.config()
    model = build_model(cfg)
    params = init_params(model.specs(),
                         torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = to_device(stream_for(cfg, batch=plan.batch,
                                 seq=plan.seq).batch_at(0), "cuda")
    _zero_counts()
    loss, got = zamba_grads(model, params, batch, plain=False)
    counts = _counts()
    groups = cfg.n_layers // cfg.shared_every
    want_counts = {"mamba2_chunk_scan": 3 * cfg.n_layers,
                   "mamba2_chunk_scan_bwd": cfg.n_layers,
                   "flash_attention": 2 * groups,
                   "flash_attention_bwd": groups}
    ref_loss, want = zamba_grads(model, params, batch, plain=True)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    shares = [(g - w).abs().max().item() / w.abs().max().item()
              for g, w in zip(got, want)]
    whole = (sum(float((g - w).double().square().sum())
                 for g, w in zip(got, want))
             / sum(float(w.double().square().sum()) for w in want)) ** 0.5
    print(f"{cfg.name} at full width, {cfg.n_layers} layers, float32, "
          f"{plan.batch} x {plan.seq}: loss kernels {loss:.7f}, plain "
          f"{ref_loss:.7f} (relative difference {loss_err:.3g}, tolerance "
          f"{GRAD_CHECK_LOSS_RTOL:g}); {len(want)} gradients, the largest "
          f"error of a leaf / its largest |gradient| {max(shares):.3g} "
          f"(tolerance {GRAD_CHECK_TOL:g}), whole gradient's relative error "
          f"{whole:.3g}; launches " + ", ".join(
              f"{k} {counts[k]}" for k in want_counts))
    if not (loss_err <= GRAD_CHECK_LOSS_RTOL and max(shares) <= GRAD_CHECK_TOL
            and all(torch.isfinite(g).all() for g in got)):
        raise AssertionError(f"{cfg.name}'s gradients through the kernels "
                             f"disagree with the plain versions'")
    if any(counts[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"{cfg.name}'s gradient check launched "
                             f"{counts}, expected {want_counts}")
    del params, got, want
    torch.cuda.empty_cache()


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


def train_full(train: dict, ddp: bool, n_buckets: int) -> dict:
    """``Session.train`` of ``train`` (``TRAIN`` or ``ZAMBA_TRAIN``) at
    full width, plain or as world-1 DDP with the onebit codec,
    ``TRAIN_STEPS`` steps from random weights (seed 0), with every kernel
    launch count set to 0 just before and read just after, on one
    repeated batch (``RepeatStream``).  Checks finite losses with the last
    below the first and the launch counts the layers give under remat: a
    dense layer's K1 forward twice a step (remat recomputes it) and its
    backward once, each per shard; K3a and K3b once a bucket and step
    under DDP; zamba's K2 forward three times a mamba layer and step (the
    forward, its group's recompute and its own, nested), K2's backward
    once, and the shared block's K1 forward twice a group and step, its
    backward once.  Returns the counts."""
    name = "world-1 DDP, onebit codec" if ddp else "Session.train"
    extra = dict(ddp=True, grad_codec="onebit",
                 ddp_shards=TRAIN_DDP_SHARDS) if ddp else {}
    plan = Plan(**train, device="cuda", **extra)
    cfg = plan.config()
    phase(f"train {cfg.name}, full width, {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers, {name}, random weights "
          f"(seed 0)")
    clock = StepClock()
    with plan.compile() as session:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        stream = RepeatStream(stream_for(cfg, batch=plan.batch,
                                         seq=plan.seq, seed=plan.seed))
        out = session.train(stream, steps=TRAIN_STEPS, log_every=1,
                            hooks=clock)
        counts = _counts()
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
    if cfg.family == "zamba":
        groups = L // cfg.shared_every
        want = {"flash_attention": TRAIN_STEPS * groups * 2,
                "flash_attention_bwd": TRAIN_STEPS * groups,
                "mamba2_chunk_scan": TRAIN_STEPS * L * 3,
                "mamba2_chunk_scan_bwd": TRAIN_STEPS * L}
    else:
        want = {"flash_attention": TRAIN_STEPS * L * 2 * shards,
                "flash_attention_bwd": TRAIN_STEPS * L * shards,
                "mamba2_chunk_scan": 0, "mamba2_chunk_scan_bwd": 0}
    want.update(onebit_quantize=TRAIN_STEPS * n_buckets if ddp else 0,
                onebit_dequantize=TRAIN_STEPS * n_buckets if ddp else 0)
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


def profile_one(name: str, fn, bound, repeats: int = 3) -> list:
    """Host wall (median of ``repeats`` calls, each ending in a device
    synchronize), the device time of the kernels one call launches, the
    kernels that take most of it (torch.profiler) and the bound.  Returns
    the names of every kernel the profiled call ran."""
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
    return [e.key for e in ev]


def check_ran(name: str, kernels: list, want: str, never: str = None):
    """The profiled call ran a kernel whose name holds ``want``, and none
    whose name holds ``never``."""
    ran = sum(want in k for k in kernels)
    bad = [k for k in kernels if never and never in k]
    print(f"{name}: {want} {'ran' if ran else 'MISSING'}"
          + (f"; {never} kernels {len(bad)}" if never else ""))
    if not ran or bad:
        raise AssertionError(f"{name}: want {want} and no {never}: {bad}")


def check_k1_route(name: str, kernels: list, want: tuple) -> None:
    """The profiled step ran each of K1's tensor-core kernels ``want``
    (keys of ``K1_TC``) by name, and none of the f32 CUDA-core kernels."""
    ran = {w: sum(K1_TC[w] in k for k in kernels) for w in want}
    f32 = [k for k in kernels if any(f in k for f in K1_F32)]
    print(f"{name}: K1 kernels by name "
          + ", ".join(f"{K1_TC[w]} {'ran' if n else 'MISSING'}"
                      for w, n in ran.items())
          + f"; f32 K1 kernels {len(f32)}")
    if not all(ran.values()) or f32:
        raise AssertionError(f"{name}: bf16 attention did not run on the "
                             f"tensor-core kernels: {ran}, f32 {f32}")


def train_ops(cfg, params, batch: int, seq: int) -> int:
    """The operations of one train step under remat: 2 per weight use and
    token in a forward, 4 in the backward.  Dense: each layer forward
    twice (remat's recompute), the unembedding counted as a layer (the
    formula of this script's earlier readings); attention 4*hd per causal
    pair a forward, 10*hd backward; a moe token's expert weights top_k /
    n_experts of them (``weight_uses``).  Zamba: each mamba layer forward
    three times (nested remat), the shared block twice a group, the
    unembedding once; the SSD scan ``scan_ops`` a forward,
    ``scan_bwd_ops`` backward."""
    def mm(tree):
        return weight_uses(cfg, tree)
    tokens = batch * seq
    attn = batch * cfg.n_heads * causal_pairs(seq, True, None) \
        * cfg.head_dim * (4 + 4 + 10)
    unembed = params["unembed"]["w"].numel()
    if cfg.family != "zamba":
        return 8 * tokens * (mm(params["stack"]) + unembed) \
            + cfg.n_layers * attn
    groups = cfg.n_layers // cfg.shared_every
    H = cfg.expand * cfg.d_model // cfg.ssm_head_dim
    scan = (3 * scan_ops(batch, H, seq, cfg.ssm_head_dim, cfg.ssm_state)
            + scan_bwd_ops(batch, H, seq, cfg.ssm_head_dim, cfg.ssm_state))
    return (tokens * (10 * mm(params["stack"]["mamba"])
                      + 8 * groups * mm(params["stack"]["shared"])
                      + 6 * unembed)
            + groups * attn + cfg.n_layers * scan)


def profile_train(train: dict, ddp: bool) -> list:
    """Where one full-width train step of ``train`` spends its time: the
    plain step, or the world-1 DDP step with the onebit codec.  Bound:
    parameters, gradients and adamw's m and v each read and written once
    in float32 (32 bytes a parameter; under DDP also K3a's 12.1 and K3b's
    4.1 bytes an element), against ``train_ops`` at bf16."""
    from repro_torch.distrib.collectives import RingAllReduce
    from repro_torch.frontend.ddp import DDPEngine
    extra = dict(ddp=True, grad_codec="onebit",
                 ddp_shards=TRAIN_DDP_SHARDS) if ddp else {}
    plan = Plan(**train, device="cuda", **extra)
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
    ops = train_ops(cfg, params, plan.batch, plan.seq)
    state = {"params": params, "opt": opt}

    def one():
        _, state["params"], state["opt"] = run(state["params"], state["opt"])
    name = "world-1 DDP onebit step" if ddp else "train step"
    kernels = profile_one(f"{cfg.name} {name}, {cfg.n_layers} layers, "
                          f"{plan.batch} x {plan.seq} tokens", one,
                          roofline((48 if ddp else 32) * n, ops))
    del state, params, opt, leaves
    torch.cuda.empty_cache()
    return kernels


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


def profile_steps(cfg, slots: int, prompt_len: int, repeats: int = 3,
                  decode: bool = True):
    """Where one prefill and (with ``decode``) one decode step spend their
    time at ``slots`` rows: host wall time (median of ``repeats``, each
    ending in a device synchronize), the device time of the kernels it
    launched, the kernels that take the most of it (torch.profiler), and
    the step's bound (``step_bound``).  Returns the prefill's kernel
    names."""
    shape = {"seq_len": prompt_len + 1, "global_batch": slots}
    pre = steps.make_prefill_step(cfg, shape)
    dec = steps.make_decode_step(cfg, shape)
    params = init_params(pre.specs,
                         torch.Generator(device="cuda").manual_seed(1), "cuda")
    toks = torch.randint(0, cfg.vocab, (slots, prompt_len), device="cuda")
    lg, cache = pre.fn(params, {"tokens": toks})
    tok = lg.argmax(-1)[:, None]
    runs = ((f"prefill, batch {slots}", lambda: pre.fn(params,
                                                      {"tokens": toks}),
             step_bound(cfg, params, cache, slots, prompt_len,
                        prompt_len * (prompt_len + 1) // 2)),
            ("decode step", lambda: dec.fn(params, cache, {"tokens": tok},
                                           prompt_len),
             step_bound(cfg, params, cache, slots, 1, prompt_len + 1)))
    kernels = [profile_one(name, fn, bound)
               for name, fn, bound in runs[:2 if decode else 1]]
    return kernels[0]


KERNELS = (flash_attention, flash_attention_bwd, mamba2_chunk_scan,
           mamba2_chunk_scan_bwd, onebit_quantize, onebit_dequantize)


def _zero_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


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
        _zero_counts()
        res = session.serve(**SERVE)
        counts = _counts()
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
    want.update(flash_attention_bwd=0, mamba2_chunk_scan_bwd=0,
                onebit_quantize=0, onebit_dequantize=0)
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


def gateway_oracle(gw, prompt, slot: int) -> list:
    """A plain greedy loop over the gateway's own steps: the batch-1
    prefill, its state written into row ``slot`` of a zero decode cache,
    then the ``slots``-wide decode step with the other rows' tokens zero
    and per-row positions.  Returns the token stream (the prefill token
    first)."""
    dev = gw.device
    toks = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)[None]
    lg, state = gw.pre.fn(gw.params, {"tokens": toks})
    specs = gw.dec.cache_specs
    carry = init_params(specs, None, dev)
    for c, st, sp in zip(pytree.tree_leaves(carry), pytree.tree_leaves(state),
                         pytree.tree_leaves(specs, is_leaf=is_spec)):
        ax = sp.dims.index("batch")
        c.select(ax, slot).copy_(st.select(ax, 0))
    stream = [int(lg.argmax(-1)[0])]
    tok = torch.zeros((gw.slots, 1), dtype=torch.int64, device=dev)
    for t in range(gw.gen_len):
        tok[slot, 0] = stream[-1]
        pos = torch.full((gw.slots,), gw.prompt_len, dtype=torch.int64,
                         device=dev)
        pos[slot] = gw.prompt_len + t
        lg, carry = gw.dec.fn(gw.params, carry, {"tokens": tok}, pos)
        stream.append(int(lg[slot].argmax()))
    return stream


def time_park_refill(gw, prompts) -> dict:
    """Host wall, each ending in a synchronize, of what the gateway does
    per request: the batch-1 prefill alone; a park (the prefill, its state
    to the host, into pages); a refill (out of pages, to the device, into
    one row of the decode cache).  Median and range over ``prompts``."""
    icache = InferenceCache(page_bytes=PAGE_BYTES)
    carry = init_params(gw.dec.cache_specs, None, gw.device)
    ms = {"prefill": [], "park": [], "refill": []}
    for i, p in enumerate(prompts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gw._prefill_once(p)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, state = gw._prefill_once(p)
        icache.put(f"t{i}", pytree.tree_map(lambda t: t.cpu(), state))
        t2 = time.perf_counter()
        gateway._write_rows(carry, icache.get(f"t{i}"), gw.dec.cache_specs,
                            i % gw.slots)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        icache.drop(f"t{i}")
        ms["prefill"].append(1e3 * (t1 - t0))
        ms["park"].append(1e3 * (t2 - t1))
        ms["refill"].append(1e3 * (t3 - t2))
    return {k: {"median": sorted(v)[len(v) // 2], "min": min(v),
                "max": max(v)} for k, v in ms.items()}


def serve_stream_full(arch: str) -> tuple:
    """``Session.serve_stream`` of ``arch`` at full width and depth (random
    weights, seed 0): 8 requests arriving at ``GATEWAY_ARRIVALS``, with
    every kernel launch count set to 0 just before and read just after.
    Checks completion, the paged-cache counters (every refill a page hit,
    no prefill recompute, every page reclaimed, the parked bytes those of
    the batch-1 cache), the token range, the launch counts (K1 once per
    attention layer and request, K2 once per mamba layer and request,
    nothing else), the streams of ``GATEWAY_ORACLE`` against
    ``gateway_oracle``, two replicas and the replica-death drill against
    one replica (same streams, same launches: prefill never reruns), and
    for qwen3-4b a live ``RequestQueue`` fed from another thread.  Returns
    (the single-replica run's counts, its readings)."""
    phase(f"serve_stream {arch}, full width and depth, random weights "
          f"(seed 0)")
    plan = Plan(arch=arch, tiny=False, device="cuda")
    cfg = plan.config()
    n = len(GATEWAY_ARRIVALS)
    trace = [{"at_round": r} for r in GATEWAY_ARRIVALS]
    kw = dict(prompt_len=SERVE["prompt_len"], gen_len=SERVE["gen_len"],
              slots=SERVE["slots"])
    if cfg.family == "zamba":
        per_request = {"flash_attention": cfg.n_layers // cfg.shared_every,
                       "mamba2_chunk_scan": cfg.n_layers}
    else:
        per_request = {"flash_attention": cfg.n_layers,
                       "mamba2_chunk_scan": 0}
    per_request.update(flash_attention_bwd=0, mamba2_chunk_scan_bwd=0,
                       onebit_quantize=0, onebit_dequantize=0)

    def check_counts(what, counts, requests):
        want = {k: v * requests for k, v in per_request.items()}
        if counts != want:
            raise AssertionError(f"{arch} {what}: launch counts {counts}, "
                                 f"want {want}")

    with plan.compile() as session:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        res = session.serve_stream(trace=trace, **kw)
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        gw = session._gateway
        serve, cache = res["runtime_stats"]["serve"], res["cache"]
        pre1 = session._serve_steps_for(SERVE["prompt_len"],
                                        SERVE["gen_len"], 1)[0]
        leaves = pytree.tree_leaves(pre1.cache_specs, is_leaf=is_spec)
        nbytes = sum(sp.size * sp.dtype.itemsize for sp in leaves)
        pages = -(-nbytes // PAGE_BYTES)
        print(f"{res['tokens_per_s']:.1f} tok/s, {res['rounds']} rounds, "
              f"{res['epochs']} epochs, {res['tokens']} tokens; per request "
              f"{len(leaves)} leaves, {nbytes} B, {pages} pages of "
              f"{PAGE_BYTES} B; pages_peak {cache['pages_peak']} = "
              f"{cache['pages_peak'] * PAGE_BYTES / 2**20:.1f} MiB parked on "
              f"the host at peak; peak device memory {peak / 2**30:.2f} GiB")
        print(", ".join(f"{k} launches {v}" for k, v in counts.items()))
        print("serve counters: " + ", ".join(
            f"{k} {serve[k]}" for k in ("admitted", "refills", "page_hits",
                                        "real_tokens", "padded_slot_tokens",
                                        "completed")))
        check_counts("serve_stream", counts, n)
        tokens = [t for s in res["streams"].values() for t in s]
        if not (res["completed"] == n
                and serve["refills"] == serve["page_hits"] == n
                and serve.get("prefill_recompute", 0) == 0
                and cache["pages_live"] == 0
                and cache["page_allocs"] == cache["page_frees"] == n * pages
                and res["epochs"] >= 2
                and all(len(s) == SERVE["gen_len"] + 1
                        for s in res["streams"].values())
                and 0 <= min(tokens) and max(tokens) < cfg.vocab):
            raise AssertionError(f"{arch} serve_stream: {res['completed']} "
                                 f"completed, serve {serve}, cache {cache}, "
                                 f"epochs {res['epochs']}")
        print(f"{n} completed, refills = page hits = {n}, no prefill "
              f"recompute, every page reclaimed, tokens in [0, {cfg.vocab})")

        handles = {h.rid: h for h in res["handles"]}
        for rid in GATEWAY_ORACLE:
            h = handles[rid]
            want = gateway_oracle(gw, h.prompt, h._slot)
            same = want == res["streams"][rid]
            print(f"oracle {rid} (slot {h._slot}): greedy loop over the "
                  f"same steps {'bit-identical' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"{arch} {rid}: gateway "
                                     f"{res['streams'][rid]}, plain greedy "
                                     f"loop {want}")
        readings = time_park_refill(gw, [h.prompt for h in res["handles"]])
        print("per request (host wall, median [min, max] of "
              f"{n}): " + "; ".join(
                  f"{k} {v['median']:.2f} ms [{v['min']:.2f}, "
                  f"{v['max']:.2f}]" for k, v in readings.items()))
        readings.update(tokens_per_s=res["tokens_per_s"],
                        rounds=res["rounds"], epochs=res["epochs"],
                        bytes_per_request=nbytes, pages_per_request=pages,
                        pages_peak=cache["pages_peak"],
                        peak_device_bytes=peak)
        del gw
        session._gateway = None

        for over in (dict(replicas=2),
                     dict(replicas=2, kill_replica_at_round=GATEWAY_KILL)):
            _zero_counts()
            out = session.serve_stream(trace=trace, **kw, **over)
            rc = _counts()
            session._gateway = None
            rserve = out["runtime_stats"]["serve"]
            drill = "kill_replica_at_round" in over
            name = (f"replicas=2, replica {GATEWAY_KILL[0]} killed at round "
                    f"{GATEWAY_KILL[1]}" if drill else "replicas=2")
            # the session's serve counters add up over its runs
            fetches = rserve.get("cross_replica_page_fetches", 0)
            recompute = rserve.get("prefill_recompute", 0)
            same = out["streams"] == res["streams"]
            print(f"{name}: {out['tokens_per_s']:.1f} tok/s, streams "
                  f"{'bit-identical to' if same else 'DIFFER from'} one "
                  f"replica's, cross-replica page fetches {fetches}, prefill "
                  f"recompute {recompute}; " + ", ".join(
                      f"{k} {v}" for k, v in rc.items() if v))
            check_counts(name, rc, n)
            if not same or out["completed"] != n or recompute \
                    or out["cache"]["pages_live"] or (drill and not fetches):
                raise AssertionError(f"{arch} {name}: streams or counters")

        if arch == "qwen3-4b":
            prompts = [h.prompt for h in res["handles"][:GATEWAY_LIVE]]
            q = RequestQueue()

            def feeder():
                for p in prompts:
                    q.submit(p)
                    time.sleep(0.05)
                q.close()
            _zero_counts()
            t = threading.Thread(target=feeder)
            t.start()
            live = session.serve_stream(queue=q, **kw)
            t.join(timeout=600)
            rc = _counts()
            session._gateway = None
            same = all(live["streams"][f"r{i}"] == res["streams"][f"r{i}"]
                       for i in range(GATEWAY_LIVE))
            print(f"live queue, {GATEWAY_LIVE} prompts from another thread: "
                  f"{live['completed']} completed, streams "
                  f"{'equal' if same else 'DIFFER from'} the trace run's")
            check_counts("live queue", rc, GATEWAY_LIVE)
            if t.is_alive() or not same \
                    or live["completed"] != GATEWAY_LIVE:
                raise AssertionError(f"{arch} live queue")
    torch.cuda.empty_cache()
    return counts, readings


def check_moe_layer() -> dict:
    """One granite-moe-1b-a400m MoE layer at full width on the card:
    ``MOE_LAYER_TOKENS`` tokens of unit scale, bf16 parameters from seed 0.
    At the default capacity factor each dispatch engine reruns to the same
    bits (no atomics: the sort engine writes each kept assignment into its
    own slot and sums a token's contributions in a fixed order); at a
    capacity factor of E / k no assignment drops, and the two engines
    agree within the bf16 kernel-test tolerance ``TOL`` times max(1, the
    output's largest magnitude).  Returns each engine's time (not a
    kernel: both are PyTorch calls, as the reference's are jnp)."""
    cfg = steps._serve_cfg(_MOE_CFG)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(moe.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts), gen,
                    "cuda")
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = torch.randn(1, MOE_LAYER_TOKENS, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    kw = dict(top_k=cfg.top_k, group_size=cfg.moe_group)
    out, ms = {}, {}
    for dispatch in ("einsum", "sort"):
        y, aux = moe.apply_moe(x, p, dispatch=dispatch, **kw)
        again, aux2 = moe.apply_moe(x, p, dispatch=dispatch, **kw)
        torch.cuda.synchronize()
        same = torch.equal(y, again) and torch.equal(aux, aux2)
        print(f"MoE layer, {dispatch} dispatch, d={cfg.d_model} "
              f"E={cfg.n_experts} k={cfg.top_k}, {MOE_LAYER_TOKENS} tokens, "
              f"bf16, cap_factor 1.25: rerun "
              f"{'bit-identical' if same else 'DIFFERS'}")
        if not same or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"MoE {dispatch} dispatch is not "
                                 f"reproducible on the card")
        out[dispatch], _ = moe.apply_moe(
            x, p, dispatch=dispatch,
            cap_factor=cfg.n_experts / cfg.top_k, **kw)
        ms[dispatch] = cuda_ms(lambda: moe.apply_moe(x, p, dispatch=dispatch,
                                                     **kw), iters=10)
    err = (out["einsum"].float() - out["sort"].float()).abs().max().item()
    limit = TOL[torch.bfloat16] * max(
        1.0, out["einsum"].float().abs().max().item())
    print(f"no drops (cap_factor {cfg.n_experts / cfg.top_k:g}): einsum "
          f"against sort max abs err {err:.3g} (tolerance {limit:.3g}); "
          f"device time einsum {ms['einsum']:.4f} ms, sort "
          f"{ms['sort']:.4f} ms a layer at cap_factor 1.25")
    if err > limit:
        raise AssertionError("the MoE dispatch engines disagree")
    return {"einsum_ms": ms["einsum"], "sort_ms": ms["sort"],
            "max_abs_err": err}


class CkptClock:
    """Times the checkpoint layer inside ``Session.train``: wraps
    ``CheckpointManager.save`` (its return ends the host copy; the
    returned future's completion ends the write) and ``restore``."""

    def __init__(self):
        self.saves, self.restores = [], []

    def __enter__(self):
        cls = ckpt_io.CheckpointManager
        self._orig = cls.save, cls.restore
        save, restore = self._orig
        clock = self

        def timed_save(mgr, step, tree, **kw):
            t0 = time.perf_counter()
            fut = save(mgr, step, tree, **kw)
            rec = {"step": step, "host_s": time.perf_counter() - t0}
            clock.saves.append(rec)
            fut.add_done_callback(lambda f, t1=time.perf_counter(): rec.update(
                write_s=time.perf_counter() - t1))
            return fut

        def timed_restore(mgr, like, **kw):
            t0 = time.perf_counter()
            out = restore(mgr, like, **kw)
            torch.cuda.synchronize()
            clock.restores.append(time.perf_counter() - t0)
            return out
        cls.save, cls.restore = timed_save, timed_restore
        return self

    def __exit__(self, *exc):
        ckpt_io.CheckpointManager.save, ckpt_io.CheckpointManager.restore = \
            self._orig


def _leaf_checksums(step_dir) -> tuple[list, int]:
    """Every leaf checksum of a committed checkpoint in leaf order, and
    its shard bytes."""
    m = ckfmt.load_manifest(step_dir)
    return ([leaf["checksum"] for sh in m["shards"] for leaf in sh["leaves"]],
            sum(sh["nbytes"] for sh in m["shards"]))


def checkpoint_drill(train: dict) -> tuple:
    """The crash-and-resume drill at full size, through ``Session.train``
    on one repeated batch, in a ``tempfile.mkdtemp()`` removed at the end:
    ``TRAIN_STEPS`` steps straight (saved once, at the last step); then
    saving every ``CKPT_EVERY`` steps with an injected failure at step
    ``CKPT_FAIL_AT`` (after the first save); then ``resume=True`` to
    ``TRAIN_STEPS``, with every kernel launch count set to 0 just before
    and read just after.  The resumed run's losses, final parameters and
    final checkpoint (every leaf's checksum: parameters and optimizer
    state) must equal the straight run's bit for bit.  If the disk cannot
    hold two checkpoints the depth is cut (printed).  Returns (the resumed
    run's counts, the readings)."""
    root = tempfile.mkdtemp()
    try:
        free = shutil.disk_usage(root).free
        cfg = Plan(**train, device="cpu").config()
        n_params = sum(sp.size for sp in pytree.tree_leaves(
            build_model(cfg).specs(), is_leaf=is_spec))
        est = 12 * n_params                  # f32 params, adamw's m and v
        layers = cfg.n_layers
        while 2 * est * layers / cfg.n_layers > CKPT_DISK_SHARE * free \
                and layers > 1:
            layers -= 1
        over = {} if layers == cfg.n_layers else {"n_layers": layers}
        plan = Plan(**train, device="cuda", overrides=over)
        phase(f"checkpoint drill: {cfg.name}, full width, {layers} of "
              f"{cfg.n_layers} layers, {TRAIN_STEPS} steps")
        usage = shutil.disk_usage(root)
        print(f"checkpoint directory {root}: disk {usage.total / 1e9:.1f} GB,"
              f" free {usage.free / 1e9:.1f} GB; a checkpoint of the full "
              f"model is about {est / 1e9:.1f} GB"
              + (f"; CUT to {layers} layers to fit two" if over else ""))
        stream = RepeatStream(stream_for(plan.config(), batch=plan.batch,
                                         seq=plan.seq, seed=plan.seed))
        kw = dict(steps=TRAIN_STEPS, log_every=1, verbose=False)
        with CkptClock() as clock:
            with plan.compile() as session:
                straight = session.train(stream, ckpt_dir=f"{root}/straight",
                                         ckpt_every=TRAIN_STEPS, **kw)
            want_sums, nbytes = _leaf_checksums(
                f"{root}/straight/step_{TRAIN_STEPS:08d}")
            want_params = straight.pop("params")
            shutil.rmtree(f"{root}/straight")
            drill = f"{root}/drill"
            with plan.compile() as session:
                try:
                    session.train(stream, ckpt_dir=drill,
                                  ckpt_every=CKPT_EVERY,
                                  fail_at_step=CKPT_FAIL_AT, **kw)
                except RuntimeError as e:
                    print(f"the drill's run raised: {e}")
                    if "injected node failure" not in str(e):
                        raise
                else:
                    raise AssertionError("fail_at_step did not raise")
            landed = ckpt_io.CheckpointManager(drill).all_steps()
            print(f"committed before the failure: steps {landed}")
            if landed != [CKPT_EVERY]:
                raise AssertionError(f"checkpoints {landed}")
            torch.cuda.synchronize()
            _zero_counts()
            with plan.compile() as session:
                resumed = session.train(stream, ckpt_dir=drill,
                                        ckpt_every=CKPT_EVERY, resume=True,
                                        **kw)
            counts = _counts()
        got_sums, _ = _leaf_checksums(f"{drill}/step_{TRAIN_STEPS:08d}")
        same_params = all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(resumed["params"]),
            pytree.tree_leaves(want_params)))
        tail = straight["losses"][CKPT_EVERY:]
        print(f"losses straight {' '.join(f'{x:.6f}' for x in straight['losses'])}"
              f"; resumed from step {CKPT_EVERY}: "
              f"{' '.join(f'{x:.6f}' for x in resumed['losses'])} "
              f"({'bit-identical' if resumed['losses'] == tail else 'DIFFER'})"
              f"; final parameters {'bit-identical' if same_params else 'DIFFER'}"
              f"; the step-{TRAIN_STEPS} checkpoints' {len(want_sums)} leaf "
              f"checksums {'equal' if got_sums == want_sums else 'DIFFER'}")
        print(", ".join(f"{k} launches {v}" for k, v in counts.items()))
        L = plan.config().n_layers
        want = {k: 0 for k in counts}
        want.update(flash_attention=(TRAIN_STEPS - CKPT_EVERY) * L * 2,
                    flash_attention_bwd=(TRAIN_STEPS - CKPT_EVERY) * L)
        if counts != want:
            raise AssertionError(f"launch counts {counts}, want {want}")
        if resumed["losses"] != tail or not same_params \
                or got_sums != want_sums:
            raise AssertionError("the resumed run is not bit-identical to "
                                 "the straight run")
        saves = [{"step": r["step"], "host_s": r["host_s"],
                  "write_s": r["write_s"],
                  "gb_per_s": nbytes / (r["host_s"] + r["write_s"]) / 1e9}
                 for r in clock.saves]
        for r in saves:
            print(f"save of step {r['step']}: {nbytes} B, host copy "
                  f"{r['host_s']:.2f} s, write (serialize, checksum, file) "
                  f"{r['write_s']:.2f} s, {r['gb_per_s']:.2f} GB/s")
        print(f"restore: {clock.restores[0]:.2f} s "
              f"(read, verify, to the card), "
              f"{nbytes / clock.restores[0] / 1e9:.2f} GB/s")
        readings = {"layers": L, "checkpoint_bytes": nbytes,
                    "leaves": len(want_sums), "saves": saves,
                    "restore_s": clock.restores[0],
                    "disk_total_bytes": usage.total,
                    "disk_free_bytes": usage.free}
        del want_params, resumed, straight
        torch.cuda.empty_cache()
        return counts, readings
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_har_cnn() -> dict:
    """The HAR CNN (``models/cnn.py``) at the paper's minibatch of
    ``HAR_BATCH`` windows (``HARStream``), float32: loss and gradients on
    the card against the same parameters on the CPU, and the forward's
    device time (Fig. 1's quantity) and that of loss and gradients."""
    params = init_params(cnn.har_cnn_specs(), torch.Generator().manual_seed(0),
                         "cpu")
    batch = HARStream(batch=HAR_BATCH).batch_at(0)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = pytree.tree_map(
            lambda t: t.detach().to(dev).requires_grad_(True), params)
        loss = cnn.har_cnn_loss(p, to_device(batch, dev))
        loss.backward()
        runs[dev] = (loss.item(), [t.grad.cpu() for t in
                                   pytree.tree_leaves(p)])
    (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
    loss_err = abs(lg - lc) / abs(lc)
    share = max((g - c).abs().max().item() / c.abs().max().item()
                for c, g in zip(gc, gg))
    p = pytree.tree_map(lambda t: t.to("cuda"), params)
    b = to_device(batch, "cuda")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: cnn.har_cnn_forward(p, b["x"]), iters=20)
    pg = pytree.tree_map(lambda t: t.clone().requires_grad_(True), p)
    leaves = pytree.tree_leaves(pg)
    grad_ms = cuda_ms(lambda: torch.autograd.grad(
        cnn.har_cnn_loss(pg, b), leaves), iters=10)
    print(f"HAR CNN, minibatch {HAR_BATCH} x 128 x 9, float32: loss card "
          f"{lg:.7f}, CPU {lc:.7f} (relative difference {loss_err:.3g}, "
          f"tolerance {HAR_LOSS_RTOL:g}); gradients, the largest error of a "
          f"leaf / its largest |gradient| {share:.3g} (tolerance "
          f"{HAR_GRAD_TOL:g}); device time: forward {fwd_ms:.4f} ms, loss "
          f"and gradients {grad_ms:.4f} ms")
    if not (loss_err <= HAR_LOSS_RTOL and share <= HAR_GRAD_TOL
            and all(torch.isfinite(g).all() for g in gg)):
        raise AssertionError("the HAR CNN on the card disagrees with the "
                             "CPU")
    return {"batch": HAR_BATCH, "forward_ms": fwd_ms,
            "loss_and_grad_ms": grad_ms, "loss_rel_err": loss_err,
            "grad_err_share": share}


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
    check_misaligned()
    scan = check_scan(torch.Generator(device="cuda").manual_seed(0))
    scan_bwd = check_scan_bwd(torch.Generator(device="cuda").manual_seed(0))
    buckets = train_plan_buckets()
    print(f"training plan: {len(buckets)} gradient buckets, the largest "
          f"{max(buckets)} elements ({4 * max(buckets) / 2**20:.0f} MB)")
    onebit = check_onebit(torch.Generator(device="cuda").manual_seed(0),
                          [ONEBIT_ROWS, 300, max(buckets) // 1024])
    check_dequant_shapes(torch.Generator(device="cuda").manual_seed(0))
    phase("one MoE layer of granite-moe-1b-a400m at full width")
    moe_layer = check_moe_layer()

    phase("reference: card against CPU on tiny configs")
    check_reference("qwen3-4b")
    check_reference("qwen2.5-3b")
    check_reference("granite-moe-1b-a400m")
    # the card's K2 sums the scan in 64-row tiles, the CPU's plain version
    # step by step: float32 sums in two orders, which the gated norms of
    # the mamba layers carry into the logits at about 1e-4, so zamba is
    # held to 1e-4 of the logits' scale
    check_reference("zamba2-2.7b", scaled=True)
    check_train_reference()
    phase("reference: zamba2-2.7b's gradients, kernels against their plain "
          "versions on the card")
    check_zamba_grads()

    launches = {arch: serve_full(arch) for arch in SERVE_ARCHS}
    stream_readings = {}
    for arch in SERVE_ARCHS:
        launches[f"serve_stream_{arch}"], stream_readings[arch] = \
            serve_stream_full(arch)
    launches["train"] = train_full(TRAIN, False, len(buckets))
    launches["ddp_onebit"] = train_full(TRAIN, True, len(buckets))
    launches["train_zamba"] = train_full(ZAMBA_TRAIN, False, 0)
    launches["train_moe"] = train_full(MOE_TRAIN, False, 0)
    launches["ckpt_resume"], ckpt_readings = checkpoint_drill(MOE_TRAIN)
    phase("HAR CNN (the paper's Fig. 1 model) at minibatch 8000")
    har = check_har_cnn()

    for arch in SERVE_ARCHS:
        phase(f"where the time goes: {arch}, one prefill at batch "
              f"{SERVE['slots']} and at batch 1, one decode step (not "
              f"counted)")
        scfg = steps._serve_cfg(get_config(arch))
        for slots in (SERVE["slots"], 1):
            kernels = profile_steps(scfg, slots, SERVE["prompt_len"],
                                    decode=slots > 1)
            name = f"{arch} prefill, batch {slots}"
            check_k1_route(name, kernels, ("forward",))
            if arch == "zamba2-2.7b":
                check_ran(name, kernels, K2_TC, K2_F32)
    phase("where the time goes: one full-width train step, qwen3-4b plain "
          "and world-1 DDP onebit, zamba2-2.7b and granite-moe-1b-a400m "
          "plain (not counted)")
    for train, ddp in ((TRAIN, False), (TRAIN, True), (ZAMBA_TRAIN, False),
                       (MOE_TRAIN, False)):
        name = (f"{train['arch']} "
                f"{'DDP train step' if ddp else 'train step'}")
        kernels = profile_train(train, ddp)
        check_k1_route(name, kernels, ("forward", "dkdv", "dq"))
        if ddp:
            check_ran(name, kernels, K3B)
        if train is ZAMBA_TRAIN:
            check_ran(name, kernels, K2_TC, K2_F32)
            check_ran(name, kernels, K2_BWD_TC, K2_BWD_F32)

    phase("result")
    print(json.dumps({"serve_stream": stream_readings}))
    print(json.dumps({"checkpoint": ckpt_readings, "har_cnn": har,
                      "moe_layer": moe_layer}))
    by_path = {fn.__name__: {path: c[fn.__name__]
                             for path, c in launches.items()}
               for fn in KERNELS}

    def entry(name, source, replaces, readings, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path[name].values()), **readings,
                "launches_by_path": by_path[name], **extra}
    fa_zamba = {f"zamba_{k}": v for k, v in fa[1].items()}
    fa_b8 = {f"train_b8_{k}": v for k, v in fa[2].items()}
    fa_zamba_b8 = {f"zamba_train_{k}": v for k, v in fa[3].items()}
    fa_b1 = {f"serve_b1_{k}": v for k, v in fa[4].items()}
    fa_zamba_b1 = {f"zamba_serve_b1_{k}": v for k, v in fa[5].items()}
    fa_moe = {f"moe_serve_{k}": v for k, v in fa[6].items()}
    fa_moe_b1 = {f"moe_serve_b1_{k}": v for k, v in fa[7].items()}
    fa_moe_b8 = {f"moe_train_b8_{k}": v for k, v in fa[8].items()}
    bwd_b8 = {f"train_b8_{k}": v for k, v in fa_bwd[1].items()}
    bwd_d80 = {f"zamba_train_{k}": v for k, v in fa_bwd[2].items()}
    bwd_d96 = {f"phi3_d96_{k}": v for k, v in fa_bwd[3].items()}
    bwd_moe = {f"moe_train_{k}": v for k, v in fa_bwd[4].items()}
    largest = {k[len("largest_bucket_"):]: v for k, v in onebit.items()
               if k.startswith("largest_bucket_")}
    print(json.dumps({"kernels": [
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:86", fa[0], **fa_zamba,
              **fa_b8, **fa_zamba_b8, **fa_b1, **fa_zamba_b1, **fa_moe,
              **fa_moe_b1, **fa_moe_b8),
        entry("flash_attention_bwd",
              "src/repro_torch/csrc/flash_attention.cu", None, fa_bwd[0],
              **bwd_b8, **bwd_d80, **bwd_d96, **bwd_moe,
              note="no Pallas counterpart: the JAX package differentiates "
                   "attend_chunked (src/repro/models/attention.py:130)"),
        entry("mamba2_chunk_scan", "src/repro_torch/csrc/mamba2_scan.cu",
              "src/repro/kernels/mamba2_scan.py:75", scan),
        entry("mamba2_chunk_scan_bwd", "src/repro_torch/csrc/mamba2_scan.cu",
              None, scan_bwd,
              note="no Pallas counterpart: the JAX package differentiates "
                   "the jnp mamba2_chunked (src/repro/models/ssm.py:90)"),
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
