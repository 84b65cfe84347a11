#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --plant-k1-fault   # only the check's own test
    python3 chip_smoke.py --ddp2-repeat N    # the 1-locality fp32 DDP run,
                                             # then the 2-locality one N
                                             # times, with host memory
    python3 chip_smoke.py --mesh-only        # the mesh-training phase only
    python3 chip_smoke.py --model-axis-only  # K1 and K2 at the model
                                             # axis's shapes, the qwen3-4b
                                             # serve phase and the
                                             # model-axis phases only

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
   training batch 8, forward and backward); K1 on a rank's heads at
   model=2, granite's (H=8, Hkv=4) and zamba2-2.7b's shared block's
   (H=Hkv=16, d=80) at batch 4, 8 and 1, forward, and at 8 backward; K2
   on a rank's 40 of zamba2-2.7b's 80 heads at batch 4, 8 and 1, and its
   backward at 8; K1 on whisper-medium's rank heads at model=2 (H=Hkv=8,
   d=64: the encoder at S=1500 and the decoder at S=512, at batch 4 and
   8 in bf16 and at batch 2 in float32, forward and backward but the
   serve batch's); K1 at whisper-medium's
   shapes (d=64, H=Hkv=16, batch 4: the encoder's non-causal
   self-attention at S=1500, forward and backward, and the decoder's
   causal prefill at S=512).  K1 is held by its largest error and by its
   mean relative error, against its plain version and against
   ``scaled_dot_product_attention``; at a non-causal ragged S the plain
   version with the last tile's padding keys unmasked must fail that
   check (``--plant-k1-fault`` plants that fault in a copy of the
   kernel's source and shows the check fails it).  Every time is taken
   twice
   (``timings``): on the device, and host-paced, as earlier versions of
   this script took it.  K1 refuses a bf16 view off a 16-byte boundary.
   One granite-moe-1b-a400m MoE layer at full width (2,048 tokens, bf16):
   each dispatch engine reruns to the same bits, and with no token dropped
   the two agree;
4. reference: the tiny dense and zamba configs served on the card agree
   with the same parameters served on the CPU (granite-moe-1b-a400m's,
   xlstm-350m's and whisper-medium's too, the last with seeded frames);
   xlstm-350m at full width in float32: the chunked prefill's last-token
   logits equal a decode-step rollout's from a zero state; tiny qwen3-4b
   (plain,
   and world-1 DDP with the onebit codec) and tiny zamba2-2.7b train 8
   steps on the card with the CPU's losses (the port's CPU path is tied
   to the JAX package by the tests);
5. serve: ``Plan(arch=..., tiny=False).compile().serve(...)`` for
   qwen3-4b, zamba2-2.7b, granite-moe-1b-a400m, xlstm-350m and
   whisper-medium, each at full width and full depth with random weights
   from a seed (whisper-medium on zero frames, as the reference serves
   it);
6. serve_stream: the serving gateway,
   ``Plan(arch=..., tiny=False).compile().serve_stream(...)``, for the
   same but whisper-medium (which it refuses with the reference's
   ``ValueError``, asserted) at full width and a cut of each model's
   depth (``STREAM_LAYERS``): 8 requests arriving
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
8. checkpoint drill, granite-moe-1b-a400m at full width, cut to 2 of its
   24 layers (``CKPT_DRILL_LAYERS``, for the time limit): 6 steps straight
   (saved at step 6), then 6 steps saving every 3 with an injected
   failure at step 4, then ``resume=True`` to step 6 from the step-3
   checkpoint; the resumed losses, parameters and optimizer state (every
   leaf's checksum) are bit-identical to the straight run's.  Prints the
   checkpoint's bytes, each save's host copy and write and the restore
   (wall time, GB/s) and the disk's size;
9. HAR CNN: the paper's Fig. 1 model, loss and gradients at minibatch
   8,000 on the card against the CPU, and its forward's device time;
10. train the xlstm and enc-dec families: ``Plan(arch="xlstm-350m",
   tiny=False)`` (cut to ``XLSTM_TRAIN_LAYERS`` of its 24 layers) and
   ``Plan(arch="whisper-medium", tiny=False)``
   ``.compile().train(...)`` at full width (whisper-medium at full depth)
   with adamw
   (whisper-medium: K1 forward 96 and backward 48 a step, its encoder's
   non-causal backward included, and the cross ``bk``/``bv`` leave the
   run unchanged; from the reference's random init its float32 gradient
   norm overflows and the loss stays put, asserted, with the gradient's
   float64 scale by layer; xlstm-350m: no kernel, falling losses); 4
   steps each, step 2 of each run profiled (where the time goes, K1 by name and count,
   no K1 or K2 name in xlstm-350m's), and whisper's plain
   cross-attention timed at its train shape, with its share of the step;
11. fabric DDP across two localities on the one card: qwen3-4b at full
   width, cut to 2 layers so that two processes fit, 2 shards, the
   driver and one spawned worker process summing gradients over the
   active-message ring: the 1-locality fp32 run, the 2-locality fp32 run
   (losses bit-identical to it) and the 2-locality onebit run (K3a and
   K3b counted in each locality, reported by the worker's loop), each
   locality's grad_wire_bytes exactly steps x codec bytes; the driver's
   onebit step is profiled; the host's memory, the worker's included, is
   printed after every step of the 2-locality fp32 run;
12. the rest of the multi-locality runtime on the one card: (a) the
   gateway at two localities, ``Plan(arch="qwen3-4b", tiny=False,
   localities=2, replicas=2)`` at the serve_stream phase's depth: replica
   0 homed on the worker (its
   requests' ``stack`` prep runs there), streams bit-identical to one
   locality's, K1's launches one locality's, then the worker SIGKILLed
   mid-stream (replica deaths 1, no prefill recomputed, the same
   streams), and ``Session.lint()`` of the session's live graph empty;
   (b) checkpoint shards written by their owners: granite-moe-1b-a400m
   at full width cut to the most layers, an even count, whose checkpoint
   is at most 3.2 GB, saved by two localities (ownership {0, 1}, the
   worker's leaf bytes exactly its shard's), resumed at one,
   bit-identical to a straight run; (b') SPMD mode on the same plan,
   ``Plan(spmd=True, localities=2)``: two processes in a gloo world train
   in lockstep on the one card with the sanitizer armed and write their
   own segments (each leaf's by the layout of ``checkpoint/spmd.py``, no
   leaf byte on the wire), the losses the straight run's, both processes'
   K1 launches the steps', ``Session.lint()`` empty and no sanitizer
   diagnostic; resumed at one locality, bit-identical to the straight
   run; (c) an elastic join mid-train:
   qwen3-4b at 2 layers, ``Plan(elastic=True)`` gaining a locality after
   step 2, losses bit-identical to the static run's, tasks stolen, every
   worker reaped; (d) data-parallel mesh training on the SPMD phase's plan,
   ``Plan(data=2)``: two rank processes in a gloo world on the one card
   run phylanx, horovod, zero1 and onebit 2 steps each from the same init
   (``Session.run_ranks``), phylanx and horovod within 1e-6 of world-1
   2-shard fp32 DDP's losses and gradient norms, zero1 within 1e-5, its
   m and v on the scattered leaves half of phylanx's, every rank's K1,
   K3a and K3b counts exact, onebit's bucket-0 mean the plain K3b's; the
   zero1 crash drill on the same session, resumed bit-identically, its
   checkpoint in the reference's global shapes; step replay at data=1
   bit-identical to the straight run; (e) the model axis, qwen3-4b at full
   width on ``Plan(model=2)``: two rank processes each holding half of
   every split leaf train 4 of its 36 layers 3 steps within 1e-3 (loss)
   and 1e-2 (gradient norm) of the one-process run, every unsplit leaf
   bit-identical on both ranks, K1 24 / 12 a rank; the same layers'
   prefill and 8 decode logits within 1e-2 mean relative error of one
   process's; ``Session.serve`` at all 36 layers (K1 72 a rank; tokens
   equal to the serve phase's counted); one phylanx step at ``data=2,
   model=2`` on four rank processes (2 layers, K1 4 / 2 a rank); in the
   two-rank session also (e) the same training with sequence parallelism
   (the residual split by sequence; the same bounds against the same
   oracle, the unsplit leaves, now with the norms' summed gradients,
   bit-identical, K1 24 / 12 a rank), (h) ``TiledArray`` of an 8 x 512 x
   2560 bf16 activation tiled by sequence: its halo, re-tiling and
   replication bit for bit against the whole array, and (g) GPipe over
   qwen3-4b decoder blocks at full width on a stage mesh of 2 (2 layers
   a stage, 4 microbatches of 4 x 512, bf16): the outputs and every
   stage leaf's gradient of a mean-square loss within 1e-3 of one
   process applying the 4 layers microbatch by microbatch, K1 8 / 8 a
   rank; in the four-rank session (f) the GPipe example's program on a
   stage mesh of 4 (d=256, ``tanh(x @ W)``, microbatches of 32): the
   bubble and ms a microbatch at 1-16 microbatches, 10 training steps,
   outputs and gathered gradients against a sequential loop; and
   serving over a mesh in the same two sessions: (i) ``Session.serve``'s
   wave loop at ``data=2`` (all 36 layers, one wave of 8, 4 rows a rank:
   K1 36 a rank, no model-axis call, the tokens counted against the serve
   phase's), (j) a single stream at ``data=2`` whose cache is tiled by
   sequence (272 of 544 positions a rank; the prefill and 8 decode
   logits at 4 layers within 1e-2 mean relative error of one process's,
   then one request at 12 layers, K1 12 a rank, the dp all-reduces a
   step), (l) the gateway at ``model=2`` (6 layers) and at ``data=2``
   (6 layers), both through ``rank_serve_stream``, each with K1 8 x layers a rank, every
   refill a page hit, every page reclaimed on both ranks, each rank's
   parked bytes (half at ``model=2``) and two streams held bit for bit
   against a plain greedy loop on the same ranks, (m) zamba2-2.7b's wave
   loop at ``data=2`` (6 layers, K1 1 and K2 6 a rank), and in the
   four-rank session (k) the wave loop at ``data=2, model=2`` (4 layers,
   K1 4 a rank, both wires busy, the tokens equal on every rank); then
   the model axis beyond the dense family, each family in a
   ``Plan(model=2)`` session of its own: (n) granite-moe-1b-a400m (16 of
   its 32 experts a rank, its odd vocab of 49,155 whole on both) trains 4
   of its 24 layers in float32 with phylanx (momentum) and with zero1
   (adamw at lr 1e-5), 2 steps each, held as (a) is to the one-process
   float32 runs (the gradient norm at the first step, within 3e-2:
   routing near-ties), and
   2 phylanx steps in bf16 (K1 2 x 4 and its backward 4 a step and rank;
   the unsplit leaves bit-identical on both ranks in every run), serves
   8 of its 24 layers (``Session.serve``, one wave of 4 x 4 tokens, K1 8
   a rank) and streams them (the session's gateway, 4 tokens a request,
   K1 8 a request a rank, held as (l) is); (o) zamba2-2.7b (40 of 80 heads a
   rank) trains one group (6 mamba layers and the shared block) in
   float32 at batch 1 with phylanx (momentum, 2 steps, held as (a) is; a
   step and rank: K2 18 and its backward 6, K1 2 and its backward 1) and
   one bf16 step at batch 8, its float32 prefill and 8 decode logits at
   that depth within 1e-2 mean relative error of one process's, serves
   18 of its 54 layers (one wave: K2 18, K1 3 a rank) and streams at one group
   of 6 layers (``rank_serve_stream``, K2 6 and K1 1 a request a rank,
   held as (l) is); (p) xlstm-350m (2 of 4 mLSTM and 2 of 4 sLSTM heads a rank)
   trains 8 of its 24 layers in float32 at batch 1 with phylanx
   (momentum, 2 steps, held as (a) is) and one bf16 step at batch 8 (no
   kernel; the unsplit leaves bit-identical), serves 8 of its 24 layers
   and streams at 8 (held as (l) is); (q) whisper-medium (8 of 16 heads a
   rank, its odd vocab of 51,865 whole) trains 9 of 24 encoder and 6 of
   24 decoder layers in float32 at batch 2 with every wq x 1/8 (the
   reference's init saturates the softmax; one process against itself
   is printed at both inits) with phylanx (2 steps, held as (a) is; K1
   30 and its backward 15 a step and rank) and one bf16 step at batch 8
   from the reference's init, and serves 12 + 12 of its 24 + 24 layers
   (one wave: K1 24 a rank); each of (n)-(q) also trains
   with sequence parallelism: its float32 run again (2 steps, held to
   the same oracle at the same tolerances, the unsplit leaves
   bit-identical) and one bf16 step, counted beside the bf16 run without
   it (model-axis collectives, bytes and peak a rank); granite's residual
   stays whole (its odd vocab) and its run is held bit for bit to the
   one without, whisper's encoder splits its 1,500 frames; and in (a)'s
   session the HAR CNN at model=2 (minibatch 8,000, float32: loss and
   gradients against one process on the card at HAR_LOSS_RTOL and
   HAR_GRAD_TOL, the head's gradient bit-identical on both ranks, the
   forward's time a rank and its channel joins' bytes), in (d)'s onebit
   at data=2, model=2 (qwen3-4b at 2 layers, 2 SGD steps: every global
   bucket's K3a against its plain version, the mean against the plain
   decode, a dp coordinate's model ranks bit-identical in bucket,
   residual and mean, K3a 18 and K3b 36 a rank, the reference's dp
   wire);
13. where the time goes: one prefill (at the wave's batch, and at batch 1
   but for whisper-medium) and one decode step of each served
   configuration (xlstm-350m's at ``PROFILE_LAYERS``), one plain and one
   DDP qwen3-4b train step, one zamba2-2.7b and one granite-moe-1b-a400m
   train step (at ``PROFILE_TRAIN_LAYERS``); the prefills
   and the train steps must show K1's tensor-core kernels by name and
   none of its f32 kernels (whisper-medium's prefill 48 forward launches,
   its encoder's and its decoder's; xlstm-350m's no K1 or K2 kernel),
   zamba2-2.7b's prefill and train step K2's tensor-core kernel and not
   its f32 one, the zamba2-2.7b train step K2's backward kernel, the DDP
   step K3b's row-stream kernel;
14. the gateway's, the checkpoint's, the 2-locality runs', the
   multi-locality phases', the mesh and model-axis phases' and the
   profiles' readings as
   JSON lines,
   each phase's wall time, the
   ``kernels`` JSON line, then the ``ok`` line last.

Every kernel launch count is set to 0 just before each run of phases 5,
6, 7, 10, 11 and 12 and of the drills' resumed runs, and read just after;
each run asserts the counts its layers give.  The worker localities of
phases 11 and 12 are processes spawned from this script, which import it
again (as ``__mp_main__``) but run nothing of ``main``.

It imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
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

from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_io  # noqa: E402
from repro_torch.checkpoint import format as ckfmt  # noqa: E402
from repro_torch.checkpoint import spmd as ckspmd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import collectives, overlap, pipeline  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.core.dist_array import TiledArray  # noqa: E402
from repro_torch.core.sharding import ModelAxis, act_hook  # noqa: E402
from repro_torch.core.sharding import default_rules, gather_tree  # noqa: E402
from repro_torch.core.sharding import init_params, is_spec  # noqa: E402
from repro_torch.distrib.collectives import get_codec  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    HARStream, stream_for, to_device)
from repro_torch.core.paging import InferenceCache  # noqa: E402
from repro_torch.frontend import Plan  # noqa: E402
from repro_torch.frontend import gateway  # noqa: E402
from repro_torch.frontend import mesh as mesh_serve  # noqa: E402
from repro_torch.frontend.gateway import RequestQueue  # noqa: E402
from repro_torch.kernels import KERNELS, build  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_ref)
from repro_torch.kernels.mamba2_scan import (  # noqa: E402
    TILE as SCAN_TILE, mamba2_chunk_scan, mamba2_chunk_scan_bwd,
    mamba2_chunk_scan_bwd_ref, mamba2_chunk_scan_ref)
from repro_torch.models import attention, blocks, cnn, moe, ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.kernels.onebit import (  # noqa: E402
    onebit_dequantize, onebit_dequantize_ref, onebit_quantize,
    onebit_quantize_ref)

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12       # float32 outside the tensor cores
# kernel-test tolerances of tests/test_kernels.py; K1's output is held to
# them as that test holds it (assert_allclose, atol = rtol = TOL): each
# |error| within TOL x (1 + |plain|), since at |o| >= 4 one bf16 step is
# 2**-5 = 0.03125, above TOL alone
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# K1 is also held free of the output's scale: the mean |error| over the
# mean |reference| (``mean_rel_err``), within FA_MEAN_REL_TOL of its plain
# version and, where no window applies, within FA_LIB_MEAN_REL_TOL of
# scaled_dot_product_attention.  An absolute bound alone means little
# where outputs are small: a softmax over whisper's 1,500 keys gives a
# mean |o| near 0.034, TOL's size.  bf16: the plain version rounds the
# scores and probabilities to bf16, the kernel and the library their
# probabilities, all three their outputs; the bf16 kernel read at most
# 4.19e-3 against the plain version and 5.73e-4 against the library on
# an H100 (FA_CASES), the fault ``K1_FAULT`` plants 1.49e-2 and 1.43e-2
FA_MEAN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
FA_LIB_MEAN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
# the training slice: full width, 12 of qwen3-4b's 36 layers (the f32
# parameters, adamw's m and v, the onebit residual and the fused buckets
# of all 36 would take about 106 GB)
TRAIN_LAYERS = 12
TRAIN = dict(arch="qwen3-4b", tiny=False, batch=8, seq=512,
             overrides={"n_layers": TRAIN_LAYERS})
# 4, cut from 6 to make room for (r)-(t)
TRAIN_STEPS = 4
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
# the xlstm and enc-dec families at full width and depth: float32 state
# with adamw 0.525 B x 16 B = 8.4 GB (xlstm-350m) and 0.879 B x 16 B = 14.1
# GB (whisper-medium), so neither needs a cut
# xlstm-350m trains cut to XLSTM_TRAIN_LAYERS of its 24 layers (one
# group of seven mLSTM layers and an sLSTM layer): its step is host-bound
# (144,055 kernels at 24 layers, 3.1 s a step on an H100) and its profile
# walks every event, 40.4 s of the script's 1,200 s at full depth
XLSTM_TRAIN_LAYERS = 8
XLSTM_TRAIN = dict(arch="xlstm-350m", tiny=False, batch=8, seq=512,
                   overrides={"n_layers": XLSTM_TRAIN_LAYERS})
WHISPER_TRAIN = dict(arch="whisper-medium", tiny=False, batch=8, seq=512)
# 3 steps (the others run TRAIN_STEPS; 4 before PR 29), to keep the
# script inside its time limit; step 2 of each run is profiled
FAMILY_TRAIN_STEPS = 3
FAMILY_PROFILE_AT = 2
# whisper-medium from the reference's random init: the init takes fan-in
# shape[-2] for the [d, H, hd] and [H, hd, d] attention weights (n_heads,
# head_dim), so the encoder's gradient grows several times a layer
# downwards and its float32 global norm overflows at full depth, in both
# packages (ROADMAP §3; whisper_grad_scale measures it).  Clip-by-norm
# then scales the gradient by 0 and the full-depth run's loss stays put,
# so the family also trains at WHISPER_CUT_ENC_LAYERS encoder layers (the
# decoder's 24 kept), the most whose float32 norm stays finite (main
# checks it and that one more layer overflows), where the loss must fall
WHISPER_CUT_ENC_LAYERS = 9
WHISPER_TRAIN_CUT = dict(WHISPER_TRAIN,
                         overrides={"n_enc_layers": WHISPER_CUT_ENC_LAYERS})
# fabric DDP across two localities, both on the one card: qwen3-4b at full
# width cut to DDP2_LAYERS (4 before the model-axis phase).  Each
# process holds 0.98 B parameters (the untied 0.78 B embedding and
# unembedding and 0.10 B a layer) in float32 with adamw (16 B a
# parameter, 15.7 GB) plus the gradient buckets, the codec's residual and
# the decoded sums (3.9 GB each): about 28 GB a process and 55 GB for the
# two, inside 80 GB; at 12 layers two would need about 110 GB
DDP2_LAYERS = 2
DDP2 = dict(arch="qwen3-4b", tiny=False, batch=8, seq=512, ddp=True,
            ddp_shards=2, overrides={"n_layers": DDP2_LAYERS})
# steps a run: the fp32 runs cut to 1 (from 2, then 3 and 4 before that,
# about 35 s a 2-locality step) to make room for the SPMD and mesh phases
# within 1,000 s; the 1- and 2-locality runs' parameters after the step,
# which the exchanged gradient sum made, are held bit-identical (as the
# second step's loss was); the onebit run's 3 keep a step beside the
# profiled one (its profiler stops after the step that follows it)
DDP2_FP32_STEPS, DDP2_ONEBIT_STEPS = 1, 3
DDP2_PROFILE_AT = 2         # the driver's step profiled in the onebit run
_MOE_CFG = get_config(MOE_TRAIN["arch"])
MOE_TRAIN_ATTN = (MOE_TRAIN["batch"], _MOE_CFG.n_heads, _MOE_CFG.n_kv_heads,
                  MOE_TRAIN["seq"], _MOE_CFG.head_dim, torch.bfloat16, True,
                  None)
# the drill: saves every CKPT_EVERY steps, fails at step CKPT_FAIL_AT, and
# needs room for two committed checkpoints beside a temp one on the disk;
# where there is none, the drill's depth is cut further (printed).  It
# runs CKPT_DRILL_LAYERS of granite's 24 layers (about 2.5 GB checkpoints,
# where 24 layers' 16.6 GB took 287.6 s of the script's time limit, 12
# layers' 8.9 GB 147.8-163.1 s at 0.23-0.26 GB/s, 8 layers' 6.3 GB
# 110.4-124.0 s, 6 layers' 5.1 GB 98.4 s and 4 layers' 3.8 GB 74.8 s): the
# multi-locality, SPMD, mesh and model-axis phases need the room
# (2 and 3, with TRAIN_STEPS 4: (r)-(t)'s room)
CKPT_EVERY, CKPT_FAIL_AT = 2, 3
CKPT_DISK_SHARE = 0.8
CKPT_DRILL_LAYERS = 2
# the multi-locality runtime's other paths on the one card: the gateway's
# two replicas homed on two localities (qwen3-4b at full size; the kill
# drill SIGKILLs the worker before the GATEWAY_LOC_KILL_AT-th of the
# trace's prompts arrives, fed from a thread every GATEWAY_LOC_FEED_S);
# checkpoint shards written by their owners: granite-moe-1b-a400m at full
# width cut to the most layers, an even count, whose checkpoint stays
# within CKPT_LOC_BYTES (qwen3-4b's untied embedding and unembedding alone
# are 9.3 GB of float32 state with adamw: 0.78 B x 12 B), saved by two
# localities at step CKPT_LOC_SAVE_AT and resumed at one to
# CKPT_LOC_STEPS; the same plan in SPMD mode, two processes each writing
# its own segments (an even layer count splits the stacked per-layer
# leaves between the two: at 3 layers they would all be rank 0's); and an
# elastic join mid-train, qwen3-4b cut to
# DDP2_LAYERS, a locality added at step ELASTIC_JOIN_AT and the driver
# stalled 250 ms at step ELASTIC_STALL_AT (the steal window)
GATEWAY_LOC_KILL_AT, GATEWAY_LOC_FEED_S = 3, 0.05
CKPT_LOC_BYTES = 3.2e9
# (cut from 3 and 6 to make room for (r)-(t))
CKPT_LOC_SAVE_AT, CKPT_LOC_STEPS = 2, 4
ELASTIC_JOIN_AT, ELASTIC_STALL_AT, ELASTIC_STEPS = 2, 4, 6
ELASTIC_STALL_S = 0.25
# data-parallel mesh training (ROADMAP item 14, its data half): the SPMD
# phase's plan, granite-moe-1b-a400m at full width cut to MESH_LAYERS of
# its 24 layers (8 x 512, seed 0: 2.49 GB of float32 state with adamw and
# 0.83 GB of float32 gradients a step on the wire), two rank processes on
# the one card, each strategy MESH_STEPS steps from the same init.
# phylanx and horovod must give world-1 2-shard fp32 DDP's losses and
# gradient norms within MESH_RTOL; zero1 sums its norm in another order
# (the scattered squares over ranks, then the dense ones) and is held to
# MESH_ZERO1_RTOL, the CPU tests' tolerance against the reference.  The
# zero1 drill: MESH_DRILL_STEPS saving every MESH_DRILL_EVERY and failing
# at MESH_DRILL_FAIL_AT, then resumed; its straight run is the strategies
# phase's zero1 run, which takes MESH_DRILL_STEPS steps
MESH_LAYERS, MESH_STEPS = 2, 2
MESH_TRAIN = dict(MOE_TRAIN, overrides={"n_layers": MESH_LAYERS})
MESH_STRATEGIES = ("phylanx", "horovod", "zero1", "onebit")
MESH_RTOL, MESH_ZERO1_RTOL = 1e-6, 1e-5
# (the drill cut from 4 steps failing at 3: (r)-(t)'s room)
MESH_DRILL_STEPS, MESH_DRILL_EVERY, MESH_DRILL_FAIL_AT = 3, 2, 2
MESH_PROBE_ITERS = 9
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
SERVE_ARCHS = ("qwen3-4b", "zamba2-2.7b", "granite-moe-1b-a400m",
               "xlstm-350m", "whisper-medium")
# serve_stream refuses the enc-dec family, as the reference does
STREAM_ARCHS = tuple(a for a in SERVE_ARCHS if a != "whisper-medium")
# whisper-medium's K1 shapes at the serve batch: the encoder's
# self-attention, non-causal over the stub frontend's 1,500 frames (11
# tiles of 128 and a ragged 92), and the decoder's causal prefill
_WHISPER_CFG = get_config("whisper-medium")
WHISPER_ENC_ATTN = (SERVE["slots"], _WHISPER_CFG.n_heads,
                    _WHISPER_CFG.n_kv_heads, _WHISPER_CFG.enc_frames,
                    _WHISPER_CFG.head_dim, torch.bfloat16, False, None)
WHISPER_DEC_ATTN = (SERVE["slots"], _WHISPER_CFG.n_heads,
                    _WHISPER_CFG.n_kv_heads, SERVE["prompt_len"],
                    _WHISPER_CFG.head_dim, torch.bfloat16, True, None)
# the same two at the train step's batch (8): the encoder non-causal over
# 1,500 frames, the decoder causal over WHISPER_TRAIN's 512 tokens
WHISPER_TRAIN_ENC_ATTN = (WHISPER_TRAIN["batch"], *WHISPER_ENC_ATTN[1:])
WHISPER_TRAIN_DEC_ATTN = (WHISPER_TRAIN["batch"], _WHISPER_CFG.n_heads,
                          _WHISPER_CFG.n_kv_heads, WHISPER_TRAIN["seq"],
                          _WHISPER_CFG.head_dim, torch.bfloat16, True, None)
# xlstm-350m at full width in float32 on the card: the chunked prefill of
# XLSTM_ROLLOUT tokens in chunks of XLSTM_CHUNK (so that the state carries
# across chunks) against a decode-step rollout of the same prompt from a
# zero state, last-token logits within the reference's chunked-against-
# stepwise tolerance (tests/test_ssm.py: rtol 3e-3, atol 3e-4)
XLSTM_ROLLOUT, XLSTM_CHUNK = 64, 16
XLSTM_RTOL, XLSTM_ATOL = 3e-3, 3e-4
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
# the gateway's runs (serve_stream) at full width, cut to a sixth of
# qwen3-4b's and granite's depth and to one group of zamba2-2.7b's and
# xlstm-350m's (whole groups: zamba2-2.7b's shared block every 6 layers,
# xlstm-350m's sLSTM every 8): a run's time is its host's per-layer work
# (the park and refill copy each layer's cache), 205 s of the script's
# 1,200 s at full depth, 72 s at a third; the 2-locality gateway runs
# qwen3-4b's cut too
STREAM_LAYERS = {"qwen3-4b": 6, "zamba2-2.7b": 6,
                 "granite-moe-1b-a400m": 4, "xlstm-350m": 8}
# the gateway's tokens a request (serve_stream_full), SERVE's 32 before PR
# 31: cut to 16 to make room for (r)-(t) (xlstm-350m's launch-bound
# decode rounds alone took 19.4-29.1 s of the script at 32)
STREAM_GEN = 16
# where the time goes: xlstm-350m's prefills and decode step profiled at
# PROFILE_LAYERS of its depth (37,000 kernels a prefill at 24 layers,
# whose events the profiler's report walks: 59.8 s at full depth)
PROFILE_LAYERS = {"xlstm-350m": 8,
                  # cut from all 36, 54 and 24 layers to make
                  # room for (r)-(t) (21.6, 10.4 and 11.4 s at full depth)
                  "qwen3-4b": 12, "zamba2-2.7b": 18,
                  "granite-moe-1b-a400m": 8}
# where the time goes: the train steps profiled at PROFILE_TRAIN_LAYERS
# (the profiler's report walks every event: 61-77 s for the four steps
# at 12, 12, 54 and 24 layers; 23.9 s at 4, 4, 18 and 8)
PROFILE_TRAIN_LAYERS = {"qwen3-4b": 4, "zamba2-2.7b": 6,  # qwen3-4b: 12 before
                        "granite-moe-1b-a400m": 4}
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
# batch 1, training), whisper-medium's (the encoder's non-causal S=1500,
# the decoder's prefill, both at the serve batch, then both at the train
# step's), then the edge cases.  bf16 runs the
# tensor-core kernels, f32 the CUDA-core kernels, so each edge is held in
# both dtypes.
# the model axis (ROADMAP item 14b, part 1): qwen3-4b at full width on
# model=2 rank processes sharing the one card, each holding half of every
# split leaf.  (a) training cut to TP_LAYERS of its 36 layers (8 x 512,
# adamw, phylanx, TP_STEPS steps: two ranks of 10 GB of float32 state
# each, beside the 19 GB one-process oracle run first), held to the
# oracle's losses within TP_LOSS_RTOL and gradient norms within
# TP_NORM_RTOL (bf16 compute; the row-parallel sums round in another
# order); (b) the same layers' prefill and TP_DECODE_STEPS decode steps,
# teacher-forced with the oracle's tokens, each step's last-position
# logits within TP_LOGIT_MEAN_REL_TOL (mean relative error) of the
# one-process steps'; (c) Session.serve at all 36 layers (SERVE); (d) one
# phylanx step at data=2, model=2, TP_D2_LAYERS layers, four rank
# processes.  K1 runs each rank's own heads: H/2 query and Hkv/2 kv heads
# (a) and (e) train TP_STEPS steps (cut from 3 to make room for the
# families' sequence parallelism, the HAR CNN and onebit)
TP_LAYERS, TP_STEPS, TP_DECODE_STEPS, TP_D2_LAYERS = 4, 2, 8, 2
# (c) generates TP_SERVE_GEN tokens a request (cut from SERVE's 32 in PR
# 31, to make room for (r)-(t): 38.0 s of the model axis's 105.1 on an
# NVIDIA H100 80GB HBM3 at 700 W, most of it decode steps of 0.5 s); its
# tokens are held against the first TP_SERVE_GEN + 1 of the one-process
# serve phase's
TP_SERVE_GEN = 8
TP_TRAIN = dict(TRAIN, overrides={"n_layers": TP_LAYERS})
TP_D2_TRAIN = dict(TRAIN, overrides={"n_layers": TP_D2_LAYERS})
TP_LOSS_RTOL, TP_NORM_RTOL, TP_LOGIT_MEAN_REL_TOL = 1e-3, 1e-2, 1e-2
TP_SERVE_ATTN = (SERVE["slots"], _TRAIN_CFG.n_heads // 2,
                 _TRAIN_CFG.n_kv_heads // 2, SERVE["prompt_len"],
                 _TRAIN_CFG.head_dim, torch.bfloat16, True, None)
TP_TRAIN_ATTN = (TRAIN["batch"], *TP_SERVE_ATTN[1:])
# the gateway's batch-1 prefill on a rank's heads at model=2
TP_B1_ATTN = (1, *TP_SERVE_ATTN[1:])
# serving over a mesh (ROADMAP item 14b, part 3), inside the model-axis
# phase's two worlds: in the two-rank one (i) the wave loop at data=2
# (qwen3-4b at all 36 layers, MESH_SERVE: one wave of 8, 4 rows a rank),
# (j) a single stream at data=2, its cache tiled by sequence over the dp
# group (the prefill and TP_DECODE_STEPS decode steps' logits at
# TP_LAYERS against one process's, then one request at all 36 layers),
# (l) the gateway at model=2 at MESH_GATEWAY_M2_LAYERS, then at data=2
# at MESH_GATEWAY_LAYERS, each with GATEWAY_ORACLE held against a
# plain greedy loop on the same ranks, (m) zamba2-2.7b's wave loop at
# data=2 at STREAM_LAYERS; in the four-rank one (k) the wave loop at
# data=2, model=2 at TP_LAYERS
MESH_SERVE = dict(requests=8, slots=8, prompt_len=512, gen_len=32)
# the gateway at model=2 cut to a sixth of qwen3-4b's depth (54.6 s of a
# 977.6 s run at all 36 on an H100 80GB HBM3 at 700 W, 17.0 s at 12;
# cut from 12 to make room for the families' sequence parallelism, the
# HAR CNN and onebit on the model axis), at data=2 to a sixth
MESH_GATEWAY_M2_LAYERS, MESH_GATEWAY_LAYERS = 6, 6
# (j)'s single request at a third of qwen3-4b's depth (16.2 s of the
# phase at all 36 on an H100 80GB HBM3 at 700 W, 484 ms a decode step:
# 108 gloo all-reduces), to make room for the model axis's xlstm and
# encdec phases
MESH_STREAM_LAYERS = 12
# the model axis, part 2 (ROADMAP item 14b): (e) sequence parallelism
# in the model=2 session, (h) TiledArray there, (g) GPipe over qwen3-4b
# decoder blocks at full width on a stage mesh of that session's 2 ranks
# (GPIPE_LAYERS a stage, GPIPE_MICRO microbatches of GPIPE_MB x 512:
# K1 at the serve row's forward shape and the DDP shard row's backward
# shape), and (f) the GPipe example's program (S=4, d=256, tanh(x @ W),
# microbatches of 32) on a stage mesh of the four-rank session's ranks
TILED = (TRAIN["batch"], TRAIN["seq"], _TRAIN_CFG.d_model)
GPIPE_STAGES, GPIPE_LAYERS, GPIPE_MICRO, GPIPE_MB = 2, 2, 4, 4
GPIPE_RTOL = 1e-3
GPIPE_EX = dict(stages=4, d=256, mb=32, micro=(1, 2, 4, 8, 16), steps=10,
                train_micro=8, lr=0.1, timed=5)
GPIPE_EX_OUT_RTOL, GPIPE_EX_GRAD_RTOL = 1e-5, 1e-4
# the model axis beyond the dense family (ROADMAP item 14b, part 4), in
# two Plan(model=2) sessions of their own at full width, random weights
# from seed 0: (n) granite-moe-1b-a400m, its 32 experts on model (16 a
# rank; its odd vocab of 49,155 whole on both), at FAM_TP_LAYERS of its
# 24 layers: phylanx and zero1 in float32 (8 x 512, FAM_TP_STEPS steps,
# FAM_OPT) against the one-process float32 runs, and phylanx in bf16
# (the serve and train paths' dtype, MOE_BF16_STEPS steps), then
# Session.serve and the session's gateway at MOE_TP_SERVE_LAYERS;
# (o) zamba2-2.7b, inner on model (40
# of 80 heads a rank), at one group (6 of 54 mamba layers and the shared
# block): phylanx in float32 (ZAMBA_TP_F32_BATCH x 512) against its
# oracle, in bf16 (8 x 512), the prefill and TP_DECODE_STEPS decode
# steps' logits in float32 against one process's, then Session.serve at
# all 54 and the gateway at ZAMBA_TP_GATEWAY_LAYERS.  The float32 runs
# hold the model axis's math: in bf16 a different order of sums moves
# these models at random init by more than TP_*'s tolerances (the
# embedding's gradient behind the first rms_norm, the routing's near
# ties, the mamba layers' gated norms): one process's bf16 lies 2 % from
# its float32 in zamba's logits at a cut width, the mesh's 5 % from it
# (tools/model_axis_families_check.py bf16, on the CPU).
# The serve runs are one wave of FAM_SERVE and the gateways
# FAM_GATEWAY_GEN tokens a request: a model-axis decode step is 3
# (granite) or 4 (a mamba layer) gloo collectives a layer
FAM_TP_LAYERS = 4
# the held float32 runs of (n)-(q): 2 steps each (the second's loss and
# norm follow the first's update; 3 before PR 29, to make room for (p)
# and (q)); (n)'s session serves and streams granite at a third of its
# depth (all 24 layers before PR 29: 1.7 s and 12.8 s of (n)'s 42.7 s)
# (n)'s serve and gateway cut from 8 to 4 layers ((r)-(t)'s room)
FAM_TP_STEPS, MOE_TP_SERVE_LAYERS = 2, 4
# the bf16 runs' steps: granite's, zamba2-2.7b's
MOE_BF16_STEPS, ZAMBA_BF16_STEPS = 2, 1
# sequence parallelism for the families (ROADMAP item 14b, part 4), in
# (n)-(q)'s sessions: each family's held float32 run again with
# Strategy(sequence_parallel=True) (FAM_TP_STEPS steps against the same
# oracle, at the same tolerances) and SP_BF16_STEPS bf16 steps, counted
# (collectives, bytes and peak a rank beside the bf16 run without it).
# granite's odd vocab of 49,155 does not divide 2, so its residual stays
# whole (steps.residual_seq) and its SP run is the path without,
# asserted bit for bit; whisper's decoder stays whole for the same
# reason while its encoder splits its 1,500 frames
SP_BF16_STEPS = 1
# the HAR CNN with its channels on model (ROADMAP item 14b, part 4), in
# (a)'s Plan(model=2) world, and onebit at data=2, model=2 (part 5) in
# (d)'s world: qwen3-4b at TP_D2_LAYERS, ONEBIT_TP_STEPS steps
ONEBIT_TP_STEPS = 2
ONEBIT_CHECK_ROWS = 1 << 15          # 128 MB of a bucket's float32 rows
# the float32 runs' optimizers, as the CPU tests take them
# (tests/test_torch_model_axis_families.py): momentum, and zero1's solver,
# which is adamw in both packages, at a small lr.  adamw's normalized step
# turns gradients that differ near zero into whole +-lr steps, after
# which tiny differences of sums part the runs by more than TP_*'s
# tolerances within three steps (on an H100 80GB HBM3 at 700 W: zamba
# 3 %, granite 23 % in the gradient norm at the third step)
FAM_OPT = {"phylanx": {"kind": "momentum"},
           "zero1": {"kind": "adamw", "lr": 1e-5}}
# granite's gradient norm, held at the first step only: on the card a
# rank's products (its 16 router columns, its experts, its 8 heads) sum
# in another order than one process's, so a token whose 8th and 9th
# experts nearly tie may route elsewhere (and the capacity drops shift
# behind it), and the embedding's gradient behind the first rms_norm,
# most of the norm, moves with it: 0.9 % at the first float32 step, 5-9 %
# at the next two with momentum (an H100 80GB HBM3 at 700 W; on the CPU
# the same full-width layer's runs agree to 1e-7 over three steps:
# tools/model_axis_families_check.py mesh-f32)
MOE_TP_NORM_RTOL, MOE_TP_NORM_STEPS = 3e-2, 1
MOE_TP_TRAIN = dict(MOE_TRAIN, overrides={"n_layers": FAM_TP_LAYERS})
MOE_TP_F32 = dict(MOE_TRAIN, overrides={"n_layers": FAM_TP_LAYERS,
                                        "compute_dtype": "f32"})
ZAMBA_TP_TRAIN = dict(ZAMBA_TRAIN, overrides={
    "n_layers": _ZAMBA_CFG.shared_every})
ZAMBA_TP_F32_BATCH = 1
ZAMBA_TP_F32 = dict(ZAMBA_TRAIN, batch=ZAMBA_TP_F32_BATCH, overrides={
    "n_layers": _ZAMBA_CFG.shared_every, "compute_dtype": "f32",
    "cache_dtype_str": "f32"})
# (o)'s gateway at one group (18 layers before the xlstm and encdec
# phases took the room: 10.9 s of (o)'s 51.9 s then); (o)'s and (p)'s
# Session.serve at three groups and one (cut from all 54 and 24, 8.0 and
# 3.1 s of (o) and (p) on an H100 80GB HBM3 at 700 W), to make room for
# sequence parallelism in their sessions
ZAMBA_TP_GATEWAY_LAYERS = 6
# (o)'s Session.serve at one group (18 before: (r)-(t)'s room)
ZAMBA_TP_SERVE_LAYERS, XLSTM_TP_SERVE_LAYERS = 6, 8
# (q)'s Session.serve at half of whisper-medium's encoder and decoder
# (cut from all 24 + 24, 6.1 s of (q)'s session), for the same room
# and at 6 + 6 (12 + 12 before: (r)-(t)'s room)
WHISPER_TP_SERVE_LAYERS = 6
FAM_SERVE = dict(requests=4, slots=4, prompt_len=512, gen_len=4)
FAM_GATEWAY_GEN = 4
# K1 on a rank's heads at model=2: granite (H=8, Hkv=4, d=64) and
# zamba2-2.7b's shared block (H=Hkv=16, d=80), at the serve batch, the
# train batch and the gateway's batch 1; K2 on a rank's 40 of 80 heads
MOE_TP_SERVE_ATTN = (SERVE["slots"], _MOE_CFG.n_heads // 2,
                     _MOE_CFG.n_kv_heads // 2, SERVE["prompt_len"],
                     _MOE_CFG.head_dim, torch.bfloat16, True, None)
MOE_TP_TRAIN_ATTN = (MOE_TRAIN["batch"], *MOE_TP_SERVE_ATTN[1:])
MOE_TP_B1_ATTN = (1, *MOE_TP_SERVE_ATTN[1:])
ZAMBA_TP_SERVE_ATTN = (SERVE["slots"], _ZAMBA_CFG.n_heads // 2,
                       _ZAMBA_CFG.n_kv_heads // 2, SERVE["prompt_len"],
                       _ZAMBA_CFG.head_dim, torch.bfloat16, True, None)
ZAMBA_TP_TRAIN_ATTN = (ZAMBA_TRAIN["batch"], *ZAMBA_TP_SERVE_ATTN[1:])
ZAMBA_TP_B1_ATTN = (1, *ZAMBA_TP_SERVE_ATTN[1:])
ZAMBA_TP_SCAN = (SERVE["slots"], ZAMBA_HEADS // 2, _ZAMBA_CFG.ssm_groups,
                 SERVE["prompt_len"], _ZAMBA_CFG.ssm_head_dim,
                 _ZAMBA_CFG.ssm_state, _ZAMBA_CFG.ssm_chunk, torch.bfloat16)
ZAMBA_TP_TRAIN_SCAN = (ZAMBA_TRAIN["batch"], *ZAMBA_TP_SCAN[1:])
ZAMBA_TP_B1_SCAN = (1, *ZAMBA_TP_SCAN[1:])
ZAMBA_TP_SCAN_BWD = (ZAMBA_TRAIN["batch"], ZAMBA_HEADS // 2,
                     _ZAMBA_CFG.ssm_groups, ZAMBA_TRAIN["seq"], 64, 64,
                     torch.bfloat16, False)
# the model axis's xlstm and encdec families (ROADMAP item 14b, part 4,
# its second half), in two Plan(model=2) sessions of their own at full
# width, random weights from seed 0: (p) xlstm-350m, its mLSTM's 4 heads
# and the sLSTM's 4 on model (2 a rank; d_in 2,048: 1,024 channels a
# rank), at XLSTM_TRAIN_LAYERS (seven mLSTM layers and the sLSTM):
# phylanx in float32 (XLSTM_TP_F32_BATCH x 512) against the one-process
# float32 run, in bf16 (8 x 512, XLSTM_BF16_STEPS steps), Session.serve
# at all 24 layers and the gateway at STREAM_LAYERS; (q) whisper-medium,
# its 16 heads on model (8 a rank; d_ff 4,096: 2,048 a rank; its odd
# vocab of 51,865 whole on both), at WHISPER_CUT_ENC_LAYERS encoder
# layers (where its float32 norm stays finite) and WHISPER_TP_DEC_LAYERS
# decoder layers: phylanx in float32 (WHISPER_TP_F32_BATCH x 512, 1,500
# frames) against one process's, in bf16 (8 x 512, WHISPER_BF16_STEPS),
# then Session.serve at all 24 + 24.  xlstm runs no kernel; whisper runs
# K1 and its backward on a rank's 8 heads (WHISPER_TP_*_ATTN)
XLSTM_TP_F32_BATCH, XLSTM_BF16_STEPS = 1, 1
XLSTM_TP_F32 = dict(XLSTM_TRAIN, batch=XLSTM_TP_F32_BATCH, overrides={
    "n_layers": XLSTM_TRAIN_LAYERS, "compute_dtype": "f32",
    "cache_dtype_str": "f32"})
WHISPER_TP_DEC_LAYERS, WHISPER_TP_F32_BATCH, WHISPER_BF16_STEPS = 6, 2, 1
# (q)'s float32 run, and its oracle, scale every attention's wq by
# WHISPER_WQ_SCALE after the reference's init.  That init (std
# 1/sqrt(H) for [d, H, hd]) gives whisper-medium's attention logits a std
# near 64, a softmax saturated to one key, whose winner float32 rounding
# flips: one process parts from its own two-micro-batch run by 1.6e-4 in
# the first loss and 17 % in the gradient norm (1.4e11) at 9 encoder
# layers, from its model=2 run by 4.7e-3 and 13 %.  With wq x 1/8 the
# norm is 65.2 and the three agree to 4.9e-6 (on an NVIDIA H100 80GB
# HBM3 at 700 W; ``whisper_self_order`` prints the first two pairs every
# run), so the model axis's math is held there.  The bf16 run and
# serving keep the reference's init.
WHISPER_WQ_SCALE = 0.125
WHISPER_TP_TRAIN = dict(WHISPER_TRAIN, overrides={
    "n_enc_layers": WHISPER_CUT_ENC_LAYERS,
    "n_layers": WHISPER_TP_DEC_LAYERS})
WHISPER_TP_F32 = dict(WHISPER_TRAIN, batch=WHISPER_TP_F32_BATCH, overrides={
    "n_enc_layers": WHISPER_CUT_ENC_LAYERS,
    "n_layers": WHISPER_TP_DEC_LAYERS, "compute_dtype": "f32",
    "cache_dtype_str": "f32"})
# K1 on whisper-medium's rank heads at model=2 (H=Hkv=8, d=64): the
# encoder non-causal over 1,500 frames and the decoder's causal prefill
# at the serve batch, the same two at the train batch, then both in
# float32 at the float32 run's batch (the CUDA-core kernel)
WHISPER_TP_ENC_ATTN = (SERVE["slots"], _WHISPER_CFG.n_heads // 2,
                       _WHISPER_CFG.n_kv_heads // 2, _WHISPER_CFG.enc_frames,
                       _WHISPER_CFG.head_dim, torch.bfloat16, False, None)
WHISPER_TP_DEC_ATTN = (SERVE["slots"], *WHISPER_TP_ENC_ATTN[1:3],
                       SERVE["prompt_len"], _WHISPER_CFG.head_dim,
                       torch.bfloat16, True, None)
WHISPER_TP_TRAIN_ENC_ATTN = (WHISPER_TRAIN["batch"], *WHISPER_TP_ENC_ATTN[1:])
WHISPER_TP_TRAIN_DEC_ATTN = (WHISPER_TRAIN["batch"], *WHISPER_TP_DEC_ATTN[1:])
WHISPER_TP_F32_ENC_ATTN = (WHISPER_TP_F32_BATCH, *WHISPER_TP_ENC_ATTN[1:5],
                           torch.float32, False, None)
WHISPER_TP_F32_DEC_ATTN = (WHISPER_TP_F32_BATCH, *WHISPER_TP_DEC_ATTN[1:5],
                           torch.float32, True, None)
# ROADMAP item 14b part 6, a mesh beside the other multi-process modes,
# on the mesh phase's plan (granite at MESH_LAYERS, 8 x 512, seed 0):
# (r) fabric DDP at model=2 over two localities, four processes (each
# locality a model group of two ranks, model coordinate 0 the ring's
# member), 2 shards, in float32 compute (the model axis's math is held in
# float32, as (n) holds granite's): fp32 S21_DDP_FP32_STEPS step in one
# session against world-1 2-shard fp32 DDP of the same plan at model=1,
# then onebit S21_DDP_ONEBIT_STEPS steps in a second (K3a on the global
# buckets through the fabric codec); (s) Plan(localities=2, elastic=True,
# data=2) with phylanx: the example's drill (a save at S21_EVERY, an
# injected failure at S21_FAIL_AT, a resume to S21_STEPS on the same
# session) with a locality joining after step S21_JOIN_AT + 1, then one
# serve wave and a 2-replica gateway, held to the mesh phase's session's;
# (t) Plan(spmd=True, localities=2, data=2) with phylanx, four processes:
# S21_SPMD_STEPS steps each locality writing its segments, then a
# one-process resume to S21_STEPS (two steps: the second's loss reads the
# restored optimizer state), held to (s)'s resumed steps
S21_DDP = dict(MESH_TRAIN, ddp=True, ddp_shards=2, overrides={
    "n_layers": MESH_LAYERS, "compute_dtype": "f32"})
S21_DDP_FP32_STEPS, S21_DDP_ONEBIT_STEPS = 1, 2
S21_STEPS, S21_EVERY, S21_FAIL_AT = 4, 2, 3
S21_JOIN_AT, S21_STALL_AT = 0, 1
S21_SERVE = dict(requests=4, slots=4, prompt_len=MESH_SERVE["prompt_len"],
                 gen_len=4)
S21_STREAM = dict(S21_SERVE, slots=2, replicas=2)
S21_SPMD_STEPS = 2
# the one-process resume of (t) at data=1 against (s)'s steps at data=2:
# one batch's sums against two halves' (the mesh phase's data=1 replay)
S21_RESUME_RTOL = 1e-4
# K1 at the paths' shapes: (r)'s shard of 4 rows on a rank's heads in
# float32, (s)/(t)'s 4 rows a dp rank on the whole heads in bf16
S21_DDP_ATTN = (MESH_TRAIN["batch"] // 2, _MOE_CFG.n_heads // 2,
                _MOE_CFG.n_kv_heads // 2, MESH_TRAIN["seq"],
                _MOE_CFG.head_dim, torch.float32, True, None)
S21_MESH_ATTN = (MESH_TRAIN["batch"] // 2, *MOE_TRAIN_ATTN[1:])
#: the mesh phase's readings that (s) and (t) are held to
MESH_ORACLE: dict = {}
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
    WHISPER_ENC_ATTN,
    WHISPER_DEC_ATTN,
    WHISPER_TRAIN_ENC_ATTN,
    WHISPER_TRAIN_DEC_ATTN,
    TP_SERVE_ATTN,
    TP_TRAIN_ATTN,
    TP_B1_ATTN,
    MOE_TP_SERVE_ATTN,
    MOE_TP_TRAIN_ATTN,
    MOE_TP_B1_ATTN,
    ZAMBA_TP_SERVE_ATTN,
    ZAMBA_TP_TRAIN_ATTN,
    ZAMBA_TP_B1_ATTN,
    WHISPER_TP_ENC_ATTN,
    WHISPER_TP_DEC_ATTN,
    WHISPER_TP_TRAIN_ENC_ATTN,
    WHISPER_TP_TRAIN_DEC_ATTN,
    WHISPER_TP_F32_ENC_ATTN,
    WHISPER_TP_F32_DEC_ATTN,
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
    S21_DDP_ATTN,
    S21_MESH_ATTN,
]
FA_TIMED = 28           # the first FA_TIMED cases are timed
# K2 tolerances of tests/test_kernels.py's sweep, as atol and rtol
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
# (B, H, G, L, P, N, chunk, dtype), G the groups of Bm, Cm: zamba2-2.7b's
# prefill shape in bf16 with its one group (timed, the serve path's case)
# and with B, C per head (timed), its training shape (B=8, timed), the
# gateway's batch-1 prefill (timed), the same three on a rank's 40 heads
# at model=2 (timed), then
# f32 at the prefill shape and the three shapes of tests/test_kernels.py's
# sweep (B, C per head), grouped cases (H=4, G=2) in both dtypes, a ragged
# bf16 case, and bf16 at the other (P, N) the kernel is built for
SCAN_CASES = [
    (4, 80, 1, 512, 64, 64, 256, torch.bfloat16),
    (4, 80, 80, 512, 64, 64, 256, torch.bfloat16),
    ZAMBA_TRAIN_SCAN,
    SERVE_B1_SCAN,
    ZAMBA_TP_SCAN,
    ZAMBA_TP_TRAIN_SCAN,
    ZAMBA_TP_B1_SCAN,
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
SCAN_TIMED = 7          # the first SCAN_TIMED cases are timed
# K1 backward: qwen3-4b's training shapes (a DDP shard, then the whole
# batch of Session.train), zamba2-2.7b's shared block in training (d=80),
# phi3-mini's heads (d=96), granite-moe-1b-a400m's training shape (d=64),
# whisper-medium's encoder (non-causal, S=1500) at the serve batch, and
# its train step's encoder and decoder (MHA, causal, S=512), all eight
# timed, then small shapes in
# float32 and their bf16 twins: GQA and MHA, causal on and off, a window,
# ragged S, each head dim the backward is built for
FA_BWD_CASES = [
    TRAIN_SHARD_ATTN,
    TRAIN_ATTN,
    ZAMBA_TRAIN_ATTN,
    (1, 32, 32, 512, 96, torch.bfloat16, True, None),     # phi3-mini heads
    MOE_TRAIN_ATTN,
    WHISPER_ENC_ATTN,
    WHISPER_TRAIN_ENC_ATTN,
    WHISPER_TRAIN_DEC_ATTN,
    TP_TRAIN_ATTN,
    MOE_TP_TRAIN_ATTN,
    ZAMBA_TP_TRAIN_ATTN,
    WHISPER_TP_TRAIN_ENC_ATTN,
    WHISPER_TP_TRAIN_DEC_ATTN,
    WHISPER_TP_F32_ENC_ATTN,
    WHISPER_TP_F32_DEC_ATTN,
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
    S21_DDP_ATTN,
    S21_MESH_ATTN,
]
FA_BWD_TIMED = 15       # the first FA_BWD_TIMED cases are timed
# f32: within 1e-4 of the largest gradient magnitude (at least 1); bf16:
# the plain version rounds its products and probabilities to bf16, the
# kernel sums in f32, so bf16 is held to 3e-2 of the largest magnitude
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# and each gradient's mean |error| within FA_BWD_MEAN_REL_TOL of its mean
# |reference| (``mean_rel_err``; bf16 read at most 4.52e-3 on an H100)
FA_BWD_MEAN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# K2 backward, (B, H, G, L, P, N, dtype, dstate): zamba2-2.7b's training
# shape in bf16 with its one group (timed), the same on a rank's 40 heads
# at model=2 (timed), then B and C per head (G=H), a
# ragged L with grouped heads, the two other (P, N) the kernels are built
# for, and a nonzero final-state gradient (the bf16 kernel's seed of R),
# each in f32 (ssd_scan_bwd) and bf16 (ssd_scan_bwd_mma)
SCAN_BWD_CASES = [
    (ZAMBA_TRAIN["batch"], ZAMBA_HEADS, 1, ZAMBA_TRAIN["seq"], 64, 64,
     torch.bfloat16, False),
    ZAMBA_TP_SCAN_BWD,
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
SCAN_BWD_TIMED = 2      # the first SCAN_BWD_TIMED cases are timed
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


PHASE_TIMES: list = []      # (phase name, start on the host clock)


def phase(name: str):
    PHASE_TIMES.append((name, time.perf_counter()))
    print(f"\n== {name}", flush=True)


def print_phase_times() -> None:
    """Each phase's wall time, in seconds, and the run's."""
    ends = [t for _, t in PHASE_TIMES[1:]] + [time.perf_counter()]
    print("phase times (s): " + "; ".join(
        f"{name} {end - t0:.1f}"
        for (name, t0), end in zip(PHASE_TIMES, ends)))
    print(f"run time {ends[-1] - PHASE_TIMES[0][1]:.1f} s")


#: about how long ``cuda_ms`` times a slow call for
TIMED_S = 0.5


def cuda_ms(fn, iters: int = 20, warm: int = 3, spin: bool = True) -> float:
    """Time of one call of ``fn``: CUDA events around ``iters`` calls.
    With ``spin`` the calls are queued behind a device-side spin that
    outlasts their enqueueing, so that the card runs them back to back and
    the events time the card (a call of a few tens of microseconds on the
    card can take longer than that to launch from Python).  Without it
    the calls are launched with nothing queued ahead (the method of this
    script's earlier readings), and a call shorter than its launch is timed
    at the host's launch rate.  A call slower than ``TIMED_S / iters``
    (the plain versions of K2 and its backward: 35-290 ms) is timed over
    fewer calls, at least 3, about ``TIMED_S`` of them (20 calls of each
    of them took about 40 s of the kernels phase)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    iters = min(iters, max(3, int(TIMED_S / one_s)))
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
    return roofline(nbytes, ops, peak_of(q.dtype))


def peak_of(dtype) -> float:
    """The card's peak rate for operations on ``dtype``: bf16 on the
    tensor cores (K1's bf16 kernels), float32 on the CUDA cores (its
    float32 kernels)."""
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


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


def mlstm_ops(cfg, slots: int, new_tokens: int) -> int:
    """Operations of the mLSTM recurrence beyond its projections, per
    layer: a token's (q, k) products and weighted v sums over the causal
    half of its chunk (4*P a pair and head), and the state's update and
    read (4*P*P a token and head)."""
    H = cfg.n_heads
    P = cfg.expand * cfg.d_model // H
    pairs = (min(cfg.ssm_chunk, new_tokens) + 1) // 2
    return slots * new_tokens * H * (4 * P * pairs + 4 * P * P)


def step_bound(cfg, params, cache, slots: int, new_tokens: int,
               keys_seen: int, encode: bool = False) -> tuple[float, str]:
    """Least time for one prefill (``new_tokens`` per row) or decode step
    (1): every weight but the embedding tables (a gather of a few rows:
    the token embedding, whisper-medium's decoder positions) and the whole
    cache moved once; 2 operations per weight use and new token in the
    layers' products (zamba's shared block is used once per group, a moe
    token uses top_k of the experts: ``weight_uses``), the unembedding of
    one token a row, attention's 4*hd per (query, key) pair of
    ``keys_seen`` pairs a row and head in each self-attention layer
    (counted from the cache), the SSD scan of each mamba layer
    (``scan_ops``) and the mLSTM recurrence of each mLSTM layer
    (``mlstm_ops``; the sLSTM's recurrent matrix is a weight use).  The
    enc-dec decoder attends ``enc_frames`` keys a token in each layer;
    with ``encode`` (its prefill) the encoder runs too: its layers and
    each decoder layer's cross K/V projections over ``enc_frames`` tokens
    a row, and its non-causal attention over enc_frames**2 pairs."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves((params, cache)))
    tables = [params["embed"]["tok"]] + (
        [params["pos_dec"]] if "pos_dec" in params else [])
    nbytes -= sum(t.numel() * t.element_size() for t in tables)
    n_attn = len(_kv_caches(cache))
    att = 4 * cfg.head_dim * slots * cfg.n_heads

    if cfg.family == "encdec":
        cross_kv = sum(p["cross"]["wk"].numel() + p["cross"]["wv"].numel()
                       for p in params["dec_stack"])
        uses = weight_uses(cfg, params["dec_stack"]) - cross_kv
        F_ = cfg.enc_frames
        ops = att * new_tokens * F_ * cfg.n_layers
        if encode:
            ops += (2 * slots * F_ * (weight_uses(cfg, params["enc_stack"])
                                      + cross_kv)
                    + att * F_ * F_ * cfg.n_enc_layers)
    else:
        uses = weight_uses(cfg, params["stack"])
        ops = 0
    if cfg.family == "zamba":
        uses += (n_attn - 1) * weight_uses(cfg, params["stack"]["shared"])
    ops += (2 * slots * new_tokens * uses
            + 2 * slots * params["unembed"]["w"].numel()
            + att * keys_seen * n_attn)
    if cfg.family == "zamba":
        H = cfg.expand * cfg.d_model // cfg.ssm_head_dim
        ops += cfg.n_layers * scan_ops(slots, H, new_tokens,
                                       cfg.ssm_head_dim, cfg.ssm_state)
    if cfg.family == "xlstm":
        n_mlstm = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
        ops += n_mlstm * mlstm_ops(cfg, slots, new_tokens)
    return roofline(nbytes, ops)


def mean_rel_err(got, want) -> float:
    """The mean |got - want| over the mean |want|."""
    g, w = got.float(), want.float()
    return ((g - w).abs().mean() / w.abs().mean()).item()


def padding_unmasked(q, k, v):
    """The plain version with the fault K1's ragged last kv tile would
    have if its padding went unmasked: k and v padded with zero rows to a
    whole number of the kernel's 64-row tiles, and every query sees them
    (non-causal)."""
    B, H, S, d = q.shape
    pad = -S % 64
    grow = lambda t: F.pad(t, (0, 0, 0, pad))  # noqa: E731
    return flash_attention_ref(grow(q), grow(k), grow(v),
                               causal=False)[:, :, :S]


def fa_agreement(got, q, k, v, causal, window) -> dict:
    """K1's output ``got`` against its plain version on the same inputs
    (and against scaled_dot_product_attention where no window applies):
    the max |error| and the plain |o| where it falls, the mean relative
    error of each, and whether each |error| is within ``TOL`` x (1 +
    |plain|) and the means within ``FA_MEAN_REL_TOL`` and
    ``FA_LIB_MEAN_REL_TOL``."""
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    lib = None if window is not None else F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err, at = diff.max().item(), want.flatten()[diff.argmax()].abs().item()
    close = bool((diff <= TOL[got.dtype]
                  * (1 + want.float().abs())).all())
    rel = mean_rel_err(got, want)
    lib_rel = None if lib is None else mean_rel_err(got, lib)
    ok = (close and rel <= FA_MEAN_REL_TOL[got.dtype]
          and (lib_rel is None or lib_rel <= FA_LIB_MEAN_REL_TOL[got.dtype])
          and bool(torch.isfinite(got).all()))
    return {"err": err, "err_at": at, "rel": rel, "lib_rel": lib_rel,
            "ok": ok, "want": want}


def check_kernels(gen, cases=None, timed: int = FA_TIMED) -> list:
    """K1 against its plain version and ``scaled_dot_product_attention``
    at ``FA_CASES`` (``fa_agreement``), and against itself: a second run
    on the same inputs gives the same bits.  At a non-causal ragged S, the
    plain version with the last tile's padding unmasked must fail the
    same check (the check sees that fault).  Every case is printed before
    any failure raises.  Times the first ``FA_TIMED`` cases and returns
    their readings."""
    out, failed = [], []
    for case in (FA_CASES if cases is None else cases):
        B, H, Hkv, S, d, dt, causal, window = case
        q = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
        got = flash_attention(q, k, v, causal=causal, window=window)
        again = flash_attention(q, k, v, causal=causal, window=window)
        a = fa_agreement(got, q, k, v, causal, window)
        same = torch.equal(got, again)
        ok = a["ok"] and same
        lib_txt = ("none: no window in the library" if a["lib_rel"] is None
                   else f"{a['lib_rel']:.3g} (tolerance "
                        f"{FA_LIB_MEAN_REL_TOL[dt]:g})")
        print(f"flash_attention B={B} H={H} Hkv={Hkv} S={S} d={d} "
              f"{str(dt)[6:]} causal={causal} window={window}: max abs err "
              f"{a['err']:.3g} at |o| {a['err_at']:.3g} (tolerance "
              f"{TOL[dt]:g} x (1 + |o|)), mean rel err "
              f"{a['rel']:.3g} (tolerance {FA_MEAN_REL_TOL[dt]:g}), against "
              f"scaled_dot_product_attention {lib_txt}, rerun "
              f"{'bit-identical' if same else 'DIFFERS'} "
              f"{'ok' if ok else 'FAIL'}")
        if not causal and S % 64:
            fault = mean_rel_err(padding_unmasked(q, k, v), a["want"])
            seen = fault > FA_MEAN_REL_TOL[dt]
            print(f"  the last tile's {-S % 64} padding keys unmasked (plain "
                  f"version): mean rel err {fault:.3g}, "
                  f"{'fails the check ok' if seen else 'PASSES: FAIL'}")
            ok &= seen
        if not ok:
            failed.append(case)
        if len(out) < timed:             # a serving slice's shape: time it
            t = timings(
                ms=lambda: flash_attention(q, k, v, causal=causal),
                plain_ms=lambda: flash_attention_ref(q, k, v, causal=causal),
                library_ms=lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True))
            bound_ms, bound_by = attention_bound(q, k, v, causal, window)
            out.append({"max_abs_err": a["err"], "mean_rel_err": a["rel"],
                        "library_mean_rel_err": a["lib_rel"], **t,
                        "bound_ms": bound_ms, "bound_by": bound_by})
            print(f"  timed: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
                  f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}); host-paced: kernel "
                  f"{t['ms_host_paced']:.4f} ms, plain "
                  f"{t['plain_ms_host_paced']:.4f} ms, library "
                  f"{t['library_ms_host_paced']:.4f} ms")
    if failed:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version or the library, or with itself, or "
                             f"the check misses a planted fault: {failed}")
    return out


# The fault ``check_plant_k1_fault`` plants in a copy of K1's source: the
# bf16 kernels treat the ragged last kv tile as whole, so its zero-filled
# padding keys go unmasked (``tile_partial`` loses its ``k0 + 64 > S``)
K1_FAULT = ("(has_window && qw0 + 63 - k0 >= window) || k0 + 64 > S;",
            "(has_window && qw0 + 63 - k0 >= window);")


def check_plant_k1_fault(gen) -> dict:
    """``python3 chip_smoke.py --plant-k1-fault``: K1 built from a copy of
    its source with ``K1_FAULT`` planted (in a temporary directory), run
    at whisper-medium's encoder shape beside the kernel as built from the
    repository on the same inputs; the check of ``check_kernels`` must
    pass the one and fail the other.  Returns both readings."""
    src = build.CSRC / "flash_attention.cu"
    text = src.read_text()
    if text.count(K1_FAULT[0]) != 1:
        raise AssertionError("the planted fault's line is not in "
                             "flash_attention.cu")
    B, H, Hkv, S, d, dt, causal, window = WHISPER_ENC_ATTN
    q = torch.randn(B, H, S, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Hkv, S, d, generator=gen, device="cuda").to(dt)
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        mutant = os.path.join(tmp, "flash_attention.cu")
        with open(mutant, "w") as f:
            f.write(text.replace(*K1_FAULT))
        lib_path = os.path.join(tmp, "libflash_attention_fault.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                        mutant], check=True, capture_output=True)
        built = build.load("flash_attention")
        for name, lib in (("repository", built),
                          ("planted fault", ctypes.CDLL(lib_path))):
            build._libs["flash_attention"] = lib
            try:
                got = flash_attention(q, k, v, causal=causal, window=window)
            finally:
                build._libs["flash_attention"] = built
            a = fa_agreement(got, q, k, v, causal, window)
            print(f"K1 from the {name}'s source at B={B} H={H} S={S} d={d} "
                  f"{str(dt)[6:]} causal={causal}: max abs err "
                  f"{a['err']:.3g} at |o| {a['err_at']:.3g} (tolerance "
                  f"{TOL[dt]:g} x (1 + |o|)), mean rel err "
                  f"{a['rel']:.3g} (tolerance {FA_MEAN_REL_TOL[dt]:g}), "
                  f"against scaled_dot_product_attention {a['lib_rel']:.3g} "
                  f"(tolerance {FA_LIB_MEAN_REL_TOL[dt]:g}): "
                  f"{'passes' if a['ok'] else 'fails'}")
            readings[name] = {k_: a[k_] for k_ in ("err", "rel", "lib_rel",
                                                     "ok")}
    if not readings["repository"]["ok"] or readings["planted fault"]["ok"]:
        raise AssertionError("the check does not tell K1 from the planted "
                             "fault")
    return readings


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


def check_scan(gen, cases=None, timed: int = SCAN_TIMED) -> list:
    """K2 against its plain version at ``SCAN_CASES``, inputs built as
    tests/test_kernels.py builds them (xdt, Bm, Cm scaled by 0.5, a =
    -|n| * 0.1), and against itself: a second run on the same inputs gives
    the same bits.  Times the first ``timed`` of ``cases`` (default
    ``SCAN_CASES``) and returns their readings.  No single
    PyTorch call computes the SSD scan, so there is no library time."""
    out = []
    for B, H, G, L, P, N, chunk, dt in cases or SCAN_CASES:
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
        if len(out) >= timed:
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
    return out


def scan_bwd_ops(B: int, H: int, L: int, P: int, N: int) -> int:
    """Operations of the SSD scan's backward in the kernel's tiles of
    ``SCAN_TILE`` rows: per tile C B^T, dY X^T, G^T dY, D^T C and D B over
    the tile's rows, and B R^T, X R, dY S0, the reverse state's and the
    forward state's updates over [P, N]."""
    t = min(SCAN_TILE, L)
    return 2 * B * H * L * (t * (3 * N + 2 * P) + 5 * P * N)


def check_scan_bwd(gen, cases=None, timed: int = SCAN_BWD_TIMED) -> list:
    """K2's backward kernel against autograd through the plain version on
    the card at ``SCAN_BWD_CASES``, inputs built as ``check_scan`` builds
    them, y's gradient normal, the final state's normal where the case
    has one.  The kernel runs twice: through autograd (the path's route,
    ``mamba2_chunk_scan`` recorded by autograd) and by its wrapper; the
    two give the same bits.  Times the first ``timed`` of ``cases``
    (default ``SCAN_BWD_CASES``): the wrapper, and the plain version's
    backward of a recorded graph; no single PyTorch call computes the
    scan's backward, so there is no library time.  Returns the timed
    cases' readings."""
    out = []
    for B, H, G, L, P, N, dt, with_ds in cases or SCAN_BWD_CASES:
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
        if len(out) >= timed:
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
        out.append({"max_abs_err": max(errs), **t, "bound_ms": bound_ms,
                    "bound_by": bound_by})
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


def check_fa_bwd(gen, cases=None, timed: int = FA_BWD_TIMED) -> list:
    """K1's backward kernel against autograd through the plain version on
    the card at ``FA_BWD_CASES``, and against itself: a second backward of
    the same graph gives the same bits (no atomics).  Times the first
    ``FA_BWD_TIMED`` cases: the kernel (from the forward's o and lse), the
    plain version's backward and ``scaled_dot_product_attention``'s
    backward; returns their readings.  Every case is printed before any
    failure raises."""
    out, failed = [], []
    for B, H, Hkv, S, d, dt, causal, window in (
            FA_BWD_CASES if cases is None else cases):
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
        errs, rels, ok = [], [], True
        for g, w in zip(got, want):
            limit = FA_BWD_TOL[dt] * max(1.0, w.float().abs().max().item())
            e = (g.float() - w.float()).abs().max().item()
            errs.append(e)
            rels.append(mean_rel_err(g, w))
            ok &= (e <= limit and rels[-1] <= FA_BWD_MEAN_REL_TOL[dt]
                   and bool(torch.isfinite(g).all()))
        ok &= same
        print(f"flash_attention_bwd B={B} H={H} Hkv={Hkv} S={S} d={d} "
              f"{str(dt)[6:]} causal={causal} window={window}: max abs err "
              f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} "
              f"(tolerance {FA_BWD_TOL[dt]:g} x max(1, max |grad|)), mean "
              f"rel err dq {rels[0]:.3g} dk {rels[1]:.3g} dv {rels[2]:.3g} "
              f"(tolerance {FA_BWD_MEAN_REL_TOL[dt]:g}), rerun "
              f"{'bit-identical' if same else 'DIFFERS'} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((B, H, Hkv, S, d, dt, causal, window))
        if len(out) >= timed:
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
        bound_ms, bound_by = roofline(nbytes, ops, peak_of(dt))
        out.append({"max_abs_err": max(errs), "mean_rel_err": max(rels),
                    **t, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"  timed: kernel {t['ms']:.4f} ms, plain backward "
              f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"backward {t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); "
              f"host-paced: kernel {t['ms_host_paced']:.4f} ms, plain "
              f"{t['plain_ms_host_paced']:.4f} ms, library "
              f"{t['library_ms_host_paced']:.4f} ms")
    if failed:
        raise AssertionError(f"flash_attention_bwd disagrees with autograd "
                             f"through the plain version or with itself: "
                             f"{failed}")
    return out


def train_plan_buckets() -> list:
    """The bucket sizes (elements) of the full-width training plan's
    gradient fusion plan."""
    cfg = Plan(**TRAIN, device="cpu").config()
    return [b.size for b in steps.make_ddp_step(
        cfg, steps.Strategy()).grad_plan.buckets]


def k3a_against_plain(g, err, packed, scale, new_err) -> dict:
    """K3a's outputs on ``g``, ``err`` ([R, C] float32 on the card)
    against ``onebit_quantize_ref``'s: the sign words that differ, those
    of them holding a |q| within 1e-6 * scale of 0 (``near``: either sign
    is right there) and the others (``bad``), the scales' largest
    relative error and new_err's largest absolute error.  ``ok`` is the
    kernels phase's tolerance: no other word, both errors within 1e-6."""
    R = g.shape[0]
    p_ref, s_ref, e_ref = onebit_quantize_ref(g, err)
    near = ((g + err).abs() <= 1e-6 * s_ref).reshape(R, -1, 32).any(-1)
    differ = packed != p_ref
    out = {"words": packed.numel(), "differ": int(differ.sum()),
           "near": int(near.sum()), "bad": int((differ & ~near).sum()),
           "scale_rel_err": ((scale - s_ref).abs() / s_ref.abs()).max()
           .item(),
           "err_abs_err": (new_err - e_ref).abs().max().item()}
    out["ok"] = (out["bad"] == 0 and out["scale_rel_err"] <= 1e-6
                 and out["err_abs_err"] <= 1e-6)
    return out


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
        q = k3a_against_plain(g, err, packed, scale, new_err)
        deq = onebit_dequantize(packed, scale)
        torch.cuda.synchronize()
        d_same = torch.equal(deq, onebit_dequantize_ref(packed, scale))
        ok = q["ok"] and d_same
        print(f"onebit [{R}, 1024] ({4 * R * 1024 / 2**20:.0f} MB): words "
              f"differing {q['differ']} of {q['words']} (near-zero "
              f"words {q['near']}, other {q['bad']}), scale rel err "
              f"{q['scale_rel_err']:.3g}, new_err abs err "
              f"{q['err_abs_err']:.3g}, dequantize "
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
        out[key + "quantize"] = {"max_abs_err": q["err_abs_err"], **tq,
                                 "bound_ms": qb, "bound_by": qby}
        out[key + "dequantize"] = {"max_abs_err": 0.0, **td,
                                   "bound_ms": db, "bound_by": dby}
        print(f"  quantize: kernel {tq['ms']:.4f} ms, plain "
              f"{tq['plain_ms']:.4f} ms, bound {qb:.4f} ms ({qby}); "
              f"dequantize: kernel {td['ms']:.4f} ms, plain "
              f"{td['plain_ms']:.4f} ms, bound {db:.4f} ms ({dby}); no "
              f"library call; host-paced: kernels {tq['ms_host_paced']:.4f}"
              f", {td['ms_host_paced']:.4f} ms")
        del g, err, packed, scale, new_err, deq
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
                init, fn = engine.tstep.init, engine.train_step
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


def fingerprint(t):
    """A leaf's float64 sum and sum of squares: two leaves with different
    fingerprints differ."""
    t = t.detach().double()
    return torch.stack([t.sum(), t.square().sum()])


class StepClock:
    """A ``Session.train`` hook: synchronizes the card after every step
    and keeps the host clock, so consecutive readings are step times, and
    each step's gradient norm."""

    def __init__(self):
        self.t = [time.perf_counter()]
        self.grad_norms: list = []

    def on_step(self, it, metrics):
        torch.cuda.synchronize()
        self.t.append(time.perf_counter())
        self.grad_norms.append(float(metrics["grad_norm"]))

    def step_ms(self) -> list:
        return [1e3 * (b - a) for a, b in zip(self.t, self.t[1:])]


def train_full(train: dict, ddp: bool, n_buckets: int,
               n_steps: int = TRAIN_STEPS, profile_at: int = None,
               frozen: bool = False) -> dict:
    """``Session.train`` of ``train`` (``TRAIN`` or ``ZAMBA_TRAIN``) at
    full width, plain or as world-1 DDP with the onebit codec,
    ``n_steps`` steps from random weights (seed 0), with every kernel
    launch count set to 0 just before and read just after, on one
    repeated batch (``RepeatStream``).  Checks finite losses and gradient
    norms with the last loss below the first, or, with ``frozen`` (the
    caller measured the float32 global norm overflow: whisper_grad_scale),
    every norm infinite and one loss, since clip-by-norm then scales the
    gradient by 0; and the launch counts the layers give under remat: a
    dense layer's K1 forward twice a step (remat recomputes it) and its
    backward once, each per shard; K3a and K3b once a bucket and step
    under DDP; zamba's K2 forward three times a mamba layer and step (the
    forward, its group's recompute and its own, nested), K2's backward
    once, and the shared block's K1 forward twice a group and step, its
    backward once; the enc-dec family's K1 forward twice a step in each
    encoder (non-causal) and decoder (causal) layer, its backward once;
    the xlstm family no kernel.  For the enc-dec family also checks that
    the leaves the loss never reads (``model.unread``: the cross
    ``bk``/``bv``) leave the adamw run bit-identical to their initial
    values and, unless ``frozen``, that the run changed a leaf it reads.
    With ``profile_at``, torch.profiler records that step of the run
    (``ProfileStep``), reported against the median host wall of the steps
    it did not profile (nor the first) and ``train_ops``; its kernels and
    readings go to ``STEP_PROFILES`` by config name.  Returns the
    counts."""
    name = "world-1 DDP, onebit codec" if ddp else "Session.train"
    extra = dict(ddp=True, grad_codec="onebit",
                 ddp_shards=TRAIN_DDP_SHARDS) if ddp else {}
    plan = Plan(**train, device="cuda", **extra)
    cfg = plan.config()
    enc = (f", {cfg.n_enc_layers} of {get_config(cfg.name).n_enc_layers} "
           f"encoder layers" if cfg.family == "encdec" else "")
    phase(f"train {cfg.name}, full width, {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers{enc}, {name}, random "
          f"weights (seed 0)")
    clock = StepClock() if profile_at is None else ProfileStep(profile_at)
    with plan.compile() as session:
        init0 = None
        if cfg.family == "encdec":
            # the run's own initial parameters, drawn as Session.train does
            init, _ = session.train_step.init(
                torch.Generator(device=session.device).manual_seed(plan.seed),
                session.device)
            unread = {id(t) for t in session.train_step.model.unread(init)}
            leaves = pytree.tree_leaves(init)
            unread_at = [i for i, t in enumerate(leaves) if id(t) in unread]
            # the unread leaves (48 x 1,024 values) whole, each read leaf
            # by its float64 sum and sum of squares: a copy of every leaf
            # would add 3.5 GB to the run's device peak or the host's
            init0 = [t.detach().clone() if i in unread_at else fingerprint(t)
                     for i, t in enumerate(leaves)]
            del init, leaves
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        stream = RepeatStream(stream_for(cfg, batch=plan.batch,
                                         seq=plan.seq, seed=plan.seed))
        out = session.train(stream, steps=n_steps, log_every=1,
                            hooks=clock)
        counts = _counts()
        if init0 is not None:
            moved = [not torch.equal(a, b if i in unread_at
                                     else fingerprint(b))
                     for i, (a, b) in enumerate(
                         zip(init0, pytree.tree_leaves(out["params"])))]
            unread_moved = sum(moved[i] for i in unread_at)
            read_moved = sum(moved) - unread_moved
            print(f"{len(unread_at)} unread leaves (cross bk/bv), "
                  f"{unread_moved} changed by adamw; {read_moved} of "
                  f"{len(moved) - len(unread_at)} read leaves changed")
            if not unread_at or unread_moved:
                raise AssertionError("adamw moved a leaf the loss never "
                                     "reads")
            if not frozen and not read_moved:
                raise AssertionError("the run changed no leaf the loss "
                                     "reads")
            del init0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    ms = clock.step_ms()
    # the first step warms up; a profiled one runs slower
    timed = [x for i, x in enumerate(ms) if i not in (0, profile_at)]
    step_ms = sorted(timed)[len(timed) // 2]
    tok_s = plan.batch * plan.seq / (step_ms / 1e3)
    print(f"losses {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"step times (host wall, each ending in a synchronize) "
          f"{' '.join(f'{x:.1f}' for x in ms)} ms; median after the first"
          f"{'' if profile_at is None else ', the profiled one apart'} "
          f"{step_ms:.1f} ms, {tok_s:.0f} tok/s, peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(", ".join(f"{k} launches {v}" for k, v in counts.items()))
    if ddp:
        print(f"grad_wire_bytes {out['grad_wire_bytes']}, codec_bytes "
              f"{out['codec_bytes']}")
    if profile_at is not None:
        n = sum(t.numel() for t in pytree.tree_leaves(out["params"]))
        title = (f"{cfg.name} train step, {cfg.n_layers} layers, "
                 f"{plan.batch} x {plan.seq} tokens (step {profile_at} of "
                 f"the run)")
        kernels = report_profile(
            title, clock.prof, step_ms,
            roofline(32 * n, train_ops(cfg, out["params"], plan.batch,
                                       plan.seq)))
        STEP_PROFILES[cfg.name] = {**PROFILES[title], "by_name": kernels,
                                   "launched": clock.launched}
    want = train_launches(cfg, n_steps, TRAIN_DDP_SHARDS if ddp else 1,
                          n_buckets if ddp else 0)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}: want {n_steps} finite "
                             f"values")
    norms = clock.grad_norms
    if frozen:
        print(f"gradient norms {norms}: the float32 global norm overflows, "
              f"adamw's clip scale is 0, the loss stays {losses[0]:.4f} "
              f"(the reference's init; ROADMAP §3)")
        if not (all(np.isinf(norms)) and len(set(losses)) == 1):
            raise AssertionError(f"{cfg.name}: want every gradient norm inf "
                                 f"and one loss, got {norms}, {losses}")
    elif not (all(np.isfinite(norms)) and losses[-1] < losses[0]):
        raise AssertionError(f"losses {losses}, gradient norms {norms}: "
                             f"want finite norms and the last loss below "
                             f"the first")
    if ddp and out["grad_wire_bytes"] != 0:
        raise AssertionError("world-1 DDP put bytes on the wire")
    del out
    torch.cuda.empty_cache()
    return counts


PROFILED = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


def train_launches(cfg, n_steps: int, shards: int, n_buckets: int,
                   decodes: int = 1) -> dict:
    """Each kernel's launches in ``n_steps`` train steps of ``cfg`` under
    remat, ``shards`` batch shards a locality: a dense (or moe) layer's K1
    forward twice a shard (remat recomputes it) and its backward once; an
    enc-dec encoder (non-causal) or decoder (causal) layer's the same;
    zamba's K2 forward three times a mamba layer (the forward, its group's
    recompute and its own, nested), K2's backward once, the shared block's
    K1 forward twice a group, its backward once; xlstm none.  With
    ``n_buckets`` (onebit DDP) K3a once a bucket and step, and K3b once a
    bucket, step and each of ``decodes`` origins (every locality's
    payload, its own too, is decoded where it is summed)."""
    L = cfg.n_layers
    if cfg.family == "zamba":
        groups = L // cfg.shared_every
        want = {"flash_attention": n_steps * groups * 2,
                "flash_attention_bwd": n_steps * groups,
                "mamba2_chunk_scan": n_steps * L * 3,
                "mamba2_chunk_scan_bwd": n_steps * L}
    else:
        attn = {"xlstm": 0, "encdec": cfg.n_enc_layers + L}.get(
            cfg.family, L)
        want = {"flash_attention": n_steps * attn * 2 * shards,
                "flash_attention_bwd": n_steps * attn * shards,
                "mamba2_chunk_scan": 0, "mamba2_chunk_scan_bwd": 0}
    want.update(onebit_quantize=n_steps * n_buckets,
                onebit_dequantize=n_steps * n_buckets * decodes)
    return want


def profile_one(name: str, fn, bound, repeats: int = 3) -> dict:
    """Host wall (median of ``repeats`` calls, each ending in a device
    synchronize), the device time of the kernels one call launches, the
    kernels that take most of it (torch.profiler) and the bound.  Returns
    every kernel the profiled call ran, by name, with its launch count;
    the wrappers' launch counts of that call go to ``PROFILES[name]``
    under ``launched``."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[len(walls) // 2]
    before = _counts()
    with torch.profiler.profile(activities=PROFILED) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = report_profile(name, prof, wall, bound)
    PROFILES[name]["launched"] = _launched_since(before)
    return kernels


def report_profile(name: str, prof, wall: float, bound) -> dict:
    """Print a profiled call's host wall ``wall`` (ms), the device time
    of the kernels it launched, their count, the idle share, ``bound``
    and the kernels and host operators that take most of the time.
    Returns every kernel the call ran, by name, with its launch count."""
    bound_ms, bound_by = bound
    # once: it walks every event, some 300,000 in xlstm-350m's steps
    avg = prof.key_averages()
    # the kernels themselves: an operator's row repeats its kernels'
    # device time, so counting operators too would count it twice
    ev = [e for e in avg
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
    host = sorted((e for e in avg
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:4]
    print("  host operators by own host time: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in host))
    PROFILES[name] = {"host_wall_ms": wall, "device_busy_ms": busy,
                      "kernels": n, "bound_ms": bound_ms,
                      "bound_by": bound_by}
    return {e.key: e.count for e in ev}


PROFILES: dict = {}     # profiled call -> its readings (report_profile)
# arch -> the one-replica serve_stream run's (streams, prompts): the
# two-locality gateway phase holds its streams to them
STREAMS: dict = {}
STEP_PROFILES: dict = {}  # config name -> its profiled train step's
#                           readings and kernels by name (train_full)


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


def _launched_since(before: dict) -> dict:
    """Each wrapper's launches since ``_counts()`` read ``before``."""
    return {k: v - before[k] for k, v in _counts().items()}


def _check_profiled_launches(name: str, kernels: dict, launched: dict,
                             want: dict) -> None:
    """The profiled call's wrappers launched K1 ``want`` times (by
    wrapper name), counted by the wrappers' own counts, which are exact;
    and the profiler, which recorded each of those launches under K1's
    tensor-core kernel's name (``K1_TC``), recorded no more of them than
    were launched.  The profiler may miss a record (CUPTI once recorded 47
    of whisper-medium prefill's 48 forwards on the H100), so its count is
    printed beside the wrappers' and held only from above; ``check_k1_
    route`` has held by name that these kernels ran and no f32 one did."""
    for wrapper, want_n in want.items():
        tc = K1_TC["dkdv" if wrapper == "flash_attention_bwd"
                   else "forward"]
        seen = sum(c for k, c in kernels.items() if tc in k)
        n = launched[wrapper]
        print(f"{name}: {wrapper} launched {n} times (want {want_n}); the "
              f"profiler recorded {tc} {seen} times"
              + (f" ({n - seen} records missing)" if seen < n else ""))
        if n != want_n or seen > n:
            raise AssertionError(f"{name}: {wrapper} launched {n} times, "
                                 f"want {want_n}; profiled {tc} {seen}")


def check_k1_launches(name: str, kernels: dict, launched: dict,
                      want: int) -> None:
    """The profiled call launched K1's forward ``want`` times (whisper-
    medium's prefill: its encoder's non-causal layers and its decoder's
    causal ones, one tensor-core kernel by name)."""
    _check_profiled_launches(name, kernels, launched,
                             {"flash_attention": want})


def check_k1_train_launches(name: str, kernels: dict, launched: dict,
                            fwd: int, bwd: int) -> None:
    """The profiled train step launched K1's forward ``fwd`` times and its
    backward (``dkdv``, once a backward) ``bwd`` times."""
    _check_profiled_launches(name, kernels, launched,
                             {"flash_attention": fwd,
                              "flash_attention_bwd": bwd})


def check_no_kernel(name: str, kernels: dict) -> None:
    """The profiled call ran none of K1's or K2's kernels (xlstm-350m:
    its path is plain PyTorch by design)."""
    names = (*K1_TC.values(), *K1_F32, K2_TC, K2_F32, K2_BWD_TC, K2_BWD_F32)
    ran = [k for k in kernels if any(n in k for n in names)]
    print(f"{name}: K1 and K2 kernels by name {len(ran)} "
          f"({len(kernels)} kernel names in all)")
    if ran:
        raise AssertionError(f"{name} ran {ran}")


def train_ops(cfg, params, batch: int, seq: int) -> int:
    """The operations of one train step under remat: 2 per weight use and
    token in a forward, 4 in the backward.  Dense: each layer forward
    twice (remat's recompute), the unembedding counted as a layer (the
    formula of this script's earlier readings); attention 4*hd per causal
    pair a forward, 10*hd backward; a moe token's expert weights top_k /
    n_experts of them (``weight_uses``).  Zamba: each mamba layer forward
    three times (nested remat), the shared block twice a group, the
    unembedding once; the SSD scan ``scan_ops`` a forward,
    ``scan_bwd_ops`` backward.  xlstm: each mLSTM layer forward twice
    (remat) and its recurrence (``mlstm_ops``) four times (two forwards,
    a backward of two), the sLSTM layers (no remat, as in the reference)
    and the unembedding once.  Enc-dec: each encoder layer forward twice
    over ``enc_frames`` tokens a row, with its non-causal attention; each
    decoder layer twice over the tokens, with its causal self-attention,
    its cross K/V projections over the frames and its cross-attention
    over seq x enc_frames pairs in plain tensor code (4*hd a pair a
    forward, 8*hd its backward); the unembedding once."""
    def mm(tree):
        return weight_uses(cfg, tree)
    tokens = batch * seq
    hd = cfg.head_dim

    def attn_ops(pairs, bwd):
        return batch * cfg.n_heads * pairs * hd * (4 + 4 + bwd)
    attn = attn_ops(causal_pairs(seq, True, None), 10)
    unembed = params["unembed"]["w"].numel()
    if cfg.family == "xlstm":
        groups = cfg.n_layers // cfg.slstm_every
        n_mlstm = groups * (cfg.slstm_every - 1)
        return (8 * tokens * mm(params["stack"]["m"])
                + 6 * tokens * (mm(params["stack"]["s"]) + unembed)
                + 4 * n_mlstm * mlstm_ops(cfg, batch, seq))
    if cfg.family == "encdec":
        F_ = cfg.enc_frames
        cross_kv = sum(p["cross"]["wk"].numel() + p["cross"]["wv"].numel()
                       for p in params["dec_stack"])
        return (8 * batch * F_ * (mm(params["enc_stack"]) + cross_kv)
                + 8 * tokens * (mm(params["dec_stack"]) - cross_kv)
                + 6 * tokens * unembed
                + cfg.n_enc_layers * attn_ops(causal_pairs(F_, False, None),
                                              10)
                + cfg.n_layers * (attn + attn_ops(seq * F_, 8)))
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


def cross_attention_step_ms(train: dict) -> dict:
    """whisper-medium's decoder cross-attention in one train step: the
    plain ``attention.attend_full`` (the model's path; the JAX package has
    no kernel for it) at the train shape, q [batch, seq, H, hd] against
    k, v [batch, enc_frames, H, hd] in bf16, device time of a forward and
    of a forward with its backward.  A decoder layer runs the forward
    twice (remat recomputes it) and the backward once a step."""
    cfg = Plan(**train, device="cuda").config()
    B, S, F_ = train["batch"], train["seq"], cfg.enc_frames
    H, hd = cfg.n_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(n):
        return torch.randn(B, n, H, hd, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
    q, k, v = rnd(S), rnd(F_), rnd(F_)
    do = torch.randn(B, S, H, hd, generator=gen, device="cuda",
                     dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            attention.attend_full(q, k, v, causal=False)

    def fwd_bwd():
        o = attention.attend_full(q, k, v, causal=False)
        torch.autograd.grad(o, (q, k, v), do)
    f_ms, fb_ms = cuda_ms(fwd, iters=5), cuda_ms(fwd_bwd, iters=5)
    step = cfg.n_layers * (f_ms + fb_ms)
    print(f"cross-attention (plain attend_full), B={B}, {S} queries x {F_} "
          f"keys, H={H}, d={hd}, bf16: forward {f_ms:.4f} ms, forward and "
          f"backward {fb_ms:.4f} ms; {cfg.n_layers} layers x (forward + "
          f"forward and backward) = {step:.3f} ms a step")
    del q, k, v, do
    torch.cuda.empty_cache()
    return {"forward_ms": f_ms, "forward_backward_ms": fb_ms,
            "step_ms": step}


def whisper_grad_scale(train: dict) -> dict:
    """One full-size whisper-medium gradient from the reference's random
    init (seed 0, the stream's step-0 batch): each encoder layer's
    gradient norm and the global one, summed in float64, and whether every
    gradient element is finite.  Shows where the float32 norm of
    ``train_full`` overflows: ``overflows`` is whether the norm's square
    exceeds float32's largest value."""
    plan = Plan(**train, device="cuda")
    cfg = plan.config()
    step = steps.make_train_step(cfg, steps.Strategy())
    params, opt = step.init(
        torch.Generator(device="cuda").manual_seed(plan.seed), "cuda")
    del opt
    batch = to_device(stream_for(cfg, batch=plan.batch, seq=plan.seq,
                                 seed=plan.seed).batch_at(0), "cuda")
    step.model.loss(params, batch).backward()

    def sq(tree):
        return sum(float(t.grad.double().square().sum())
                   for t in pytree.tree_leaves(tree) if t.grad is not None)
    layers = [sq(p) ** 0.5 for p in params["enc_stack"]]
    total = sq(params) ** 0.5
    finite = all(bool(torch.isfinite(t.grad).all())
                 for t in pytree.tree_leaves(params) if t.grad is not None)
    overflows = total ** 2 > torch.finfo(torch.float32).max
    print(f"{cfg.name}, {len(layers)} encoder layers, gradient from the "
          f"reference's init, summed in float64: global norm {total:.3g} "
          f"(its square {'exceeds' if overflows else 'is within'} float32's "
          f"3.4e38); encoder layers "
          + ", ".join(f"{i} {layers[i]:.3g}"
                      for i in sorted({*range(0, len(layers), 6),
                                       len(layers) - 1}))
          + f"; every element finite: {finite}")
    del params, batch
    torch.cuda.empty_cache()
    return {"global_norm_f64": total, "encoder_layer_norms_f64": layers,
            "finite": finite, "overflows": overflows}


class ProfileStep(StepClock):
    """A ``Session.train`` hook that keeps the step clock and profiles the
    driver's step ``at``: torch.profiler starts after step ``at - 1`` and
    stops after step ``at``, each after a device synchronize.  It records
    the device's activity only (kernels, copies and the CUDA runtime's
    calls, not every host operator): xlstm-350m's step launches some
    144,000 kernels, and recording its host operators too cost more than
    a minute of the script's time limit."""

    def __init__(self, at: int):
        super().__init__()
        self.at = at
        self.prof = None

    def on_step(self, it, metrics):
        super().on_step(it, metrics)
        if it == self.at - 1:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.before = _counts()
            self.prof.__enter__()
        elif it == self.at:
            self.prof.__exit__(None, None, None)
            self.launched = _launched_since(self.before)
            # stopping the profiler takes seconds after a large step: it
            # counts to the profiled step, not to the next one
            self.t[-1] = time.perf_counter()


def host_memory(workers: dict = None) -> str:
    """The driver's resident memory and the host's available memory,
    after the driver returns its freed heap pages to the system (glibc's
    ``malloc_trim``): the fp32 ring holds each locality's payloads and
    its peer's, 4.7 GB each, on the host.  With ``workers`` (rank ->
    process), each worker's resident memory, or its exit code."""
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)

    def gib(path, key):
        with open(path) as f:
            return next(int(line.split()[1]) for line in f
                        if line.startswith(key)) / 2**20
    out = (f"driver resident {gib('/proc/self/status', 'VmRSS:'):.1f} GiB, "
           f"host available {gib('/proc/meminfo', 'MemAvailable:'):.1f} GiB")
    for r, p in sorted((workers or {}).items()):
        if p.exitcode is not None:
            out += f", worker {r} exited (code {p.exitcode})"
            continue
        try:
            # statm: the process's size and resident set, in pages
            with open(f"/proc/{p.pid}/statm") as f:
                pages = int(f.read().split()[1])
            out += (f", worker {r} resident "
                    f"{pages * os.sysconf('SC_PAGE_SIZE') / 2**30:.1f} GiB")
        except (OSError, IndexError, ValueError) as e:
            out += f", worker {r} resident not readable ({e})"
    return out


def workers_peak(workers: dict) -> str:
    """The largest peak resident memory (``VmHWM``) of the live processes
    of ``workers`` (rank -> process), read before their session closes:
    they are the forkserver's children, not this process's."""
    kib = 0
    for p in workers.values():
        try:
            with open(f"/proc/{p.pid}/status") as f:
                kib = max(kib, next(int(line.split()[1]) for line in f
                                    if line.startswith("VmHWM:")))
        except (OSError, StopIteration, ValueError):
            pass
    return f"workers' peak resident {kib / 2**20:.1f} GiB"


class MemoryClock(StepClock):
    """A ``StepClock`` that prints the host's memory after every step:
    the driver's, and each worker's of ``session``."""

    def __init__(self, session):
        super().__init__()
        self.session = session

    def on_step(self, it, metrics):
        super().on_step(it, metrics)
        print(f"after step {it}: "
              + host_memory(self.session.distributed.group.procs),
              flush=True)


DDP2_RUNS = ((1, "fp32", DDP2_FP32_STEPS), (2, "fp32", DDP2_FP32_STEPS),
             (2, "onebit", DDP2_ONEBIT_STEPS))


def ddp_two_localities(runs=DDP2_RUNS) -> tuple[dict, dict]:
    """Fabric DDP across two localities on the one card (``DDP2``): the
    driver and a spawned worker process, each training one of the two
    shards at full width, gradients summed over the active-message ring.
    Runs ``runs`` ((localities, codec, steps) each): the 1-locality fp32
    run over the same two shards, the 2-locality fp32 run
    (``DDP2_FP32_STEPS`` steps each) and the 2-locality onebit run
    (``DDP2_ONEBIT_STEPS``), each on one repeated batch, every
    kernel count set to 0 just before each run and read just after, the
    worker's counts reported by its DDP loop.  At two localities the
    host's memory, the worker's included, is printed after every step.
    Checks: finite losses; the 2-locality fp32 losses, and the driver's
    parameters after the last step (``param_bit_sums``: they hold the
    gradient sum that crossed the ring), bit-identical to the 1-locality
    run's (when both ran); in every locality the launches
    its shard and the codec give (``train_launches``: with onebit K3a once
    a bucket and step, K3b once a bucket, step and origin); every
    locality's ``grad_wire_bytes`` = steps x (W - 1) x codec bytes.
    Profiles the driver's step ``DDP2_PROFILE_AT`` of the onebit run.
    Returns the launch counts by path and locality, and the readings."""
    kw = dict(DDP2, device="cuda")
    cfg = Plan(**kw).config()
    n_buckets = len(steps.make_ddp_step(cfg, steps.Strategy())
                    .grad_plan.buckets)
    stream = RepeatStream(stream_for(cfg, batch=DDP2["batch"],
                                     seq=DDP2["seq"], seed=0))
    launches, readings, losses, sums = {}, {}, {}, {}
    for loc, codec, n_steps in runs:
        name = f"ddp2_{loc}loc_{codec}"
        phase(f"fabric DDP, {cfg.name} at full width, {cfg.n_layers} of "
              f"{get_config(cfg.name).n_layers} layers, {loc} "
              f"{'localities' if loc > 1 else 'locality'} on the one card, "
              f"{DDP2['ddp_shards']} shards, {codec} codec")
        plan = Plan(**kw, localities=loc, grad_codec=codec)
        torch.cuda.empty_cache()
        print(host_memory())
        t0 = time.perf_counter()
        with plan.compile() as session:
            up_s = time.perf_counter() - t0
            hooks = (ProfileStep(DDP2_PROFILE_AT) if codec == "onebit"
                     else MemoryClock(session) if loc > 1 else StepClock())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            try:
                out = session.train(stream, steps=n_steps, log_every=1,
                                    hooks=hooks)
            except BaseException:
                if loc > 1:
                    procs = session.distributed.group.procs
                    print(f"worker exit codes "
                          f"{ {r: p.exitcode for r, p in procs.items()} }; "
                          f"{host_memory(procs)}")
                raise
            counts = _counts()
            wpeak = workers_peak(session.distributed.group.procs) \
                if loc > 1 else None
        peak = torch.cuda.max_memory_allocated()
        if loc > 1:
            print(f"{host_memory()}; {wpeak}")
        losses[name] = out["losses"]
        if codec == "fp32":
            sums[name] = param_bit_sums(out["params"])
        ms = hooks.step_ms()
        print(f"session up in {up_s:.1f} s; losses "
              f"{' '.join(f'{x:.6f}' for x in out['losses'])}")
        print(f"step times (host wall, each ending in a synchronize) "
              f"{' '.join(f'{x:.1f}' for x in ms)} ms; driver's peak "
              f"memory {peak / 2**30:.2f} GiB")
        codec_bytes, wire = out["codec_bytes"], out["grad_wire_bytes"]
        per_loc = {0: {"launches": counts, "grad_wire_bytes": wire}}
        for r, m in out.get("localities", {}).items():
            per_loc[r] = m
        want_wire = n_steps * (loc - 1) * codec_bytes
        for r, m in per_loc.items():
            want = train_launches(
                cfg, n_steps, DDP2["ddp_shards"] // loc,
                n_buckets if codec == "onebit" else 0, decodes=loc)
            print(f"locality {r}: grad_wire_bytes {m['grad_wire_bytes']} "
                  f"(want {want_wire}), "
                  + ", ".join(f"{k} launches {v}"
                              for k, v in m["launches"].items()))
            if m["launches"] != want:
                raise AssertionError(f"{name}: locality {r} launched "
                                     f"{m['launches']}, want {want}")
            if m["grad_wire_bytes"] != want_wire:
                raise AssertionError(f"{name}: locality {r} sent "
                                     f"{m['grad_wire_bytes']} B, want "
                                     f"{want_wire}")
            launches[f"{name}_L{r}"] = m["launches"]
        if len(out["losses"]) != n_steps \
                or not all(np.isfinite(out["losses"])):
            raise AssertionError(f"{name}: losses {out['losses']}")
        readings[name] = {"losses": out["losses"], "step_ms": ms,
                          "codec_bytes": codec_bytes,
                          "grad_wire_bytes": wire,
                          "driver_peak_bytes": peak, "session_up_s": up_s}
        if codec == "onebit":
            n = sum(t.numel() for t in pytree.tree_leaves(out["params"]))
            ops = train_ops(cfg, out["params"],
                            DDP2["batch"] // DDP2["ddp_shards"], DDP2["seq"])
            # the driver's step DDP2_PROFILE_AT, against the median host
            # wall of the steps not profiled (nor the first)
            wall = [x for i, x in enumerate(ms)
                    if i not in (0, DDP2_PROFILE_AT)]
            wall = sorted(wall)[len(wall) // 2]
            kernels = report_profile(
                f"{cfg.name} 2-locality DDP onebit step, driver's half "
                f"({DDP2['batch'] // DDP2['ddp_shards']} x {DDP2['seq']} "
                f"tokens), {cfg.n_layers} layers", hooks.prof, wall,
                roofline(48 * n, ops))
            check_k1_route("2-locality DDP step", kernels,
                           ("forward", "dkdv", "dq"))
            check_ran("2-locality DDP step", kernels, K3B)
        del out
        torch.cuda.empty_cache()
    if {"ddp2_2loc_fp32", "ddp2_1loc_fp32"} <= set(losses):
        same = losses["ddp2_2loc_fp32"] == losses["ddp2_1loc_fp32"]
        same_p = sums["ddp2_2loc_fp32"] == sums["ddp2_1loc_fp32"]
        print("2-locality fp32 losses "
              + ("bit-identical to" if same else "DIFFER from")
              + " the 1-locality run's; its parameters after the last "
              f"step ({len(sums['ddp2_1loc_fp32'])} leaves) "
              + ("bit-identical to" if same_p else "DIFFER from")
              + " the 1-locality run's")
        if not (same and same_p):
            raise AssertionError("2-locality fp32 DDP losses or parameters "
                                 "differ from the 1-locality run's")
    return launches, readings


def param_bit_sums(params) -> list:
    """Each leaf's bit patterns summed as integers on the card (int64,
    exact in any order): equal for bit-identical trees, and any one
    element that differs changes its leaf's sum."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    return torch.stack([torch.sum(t.detach().view(bits[t.dtype]),
                                  dtype=torch.int64)
                        for t in pytree.tree_leaves(params)]).tolist()


def _reaped(pids, timeout: float = 30.0) -> bool:
    """Every process of ``pids`` gone (exited and reaped) within
    ``timeout``."""
    deadline = time.monotonic() + timeout
    for pid in pids:
        while True:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            if time.monotonic() > deadline:
                return False
            time.sleep(0.05)
    return True


def gateway_two_localities() -> tuple[dict, dict]:
    """``Session.serve_stream`` of qwen3-4b at full width, at
    ``serve_stream_full``'s depth, at two localities with two replicas: replica 0 is homed on the worker
    locality, a spawned process that runs its requests' ``stack`` prep,
    replica 1 on the driver; the model runs here for both.  The trace of
    ``serve_stream_full`` (every kernel count set to 0 just before and
    read just after), then the reference's kill drill
    (``test_kill_locality_retires_its_replica_and_survivor_absorbs``): the
    same prompts fed from a thread, the worker SIGKILLed before the
    ``GATEWAY_LOC_KILL_AT``-th arrives.  Checks, for both: every request
    completes with the one-locality run's stream, bit for bit; no prefill
    recomputed, every page reclaimed; K1 once per layer and request, as at
    one locality; the trace's ``stack`` nodes dispatched to the worker
    (and its replica homes [1, 0]); the drill's replica deaths 1.  Returns
    the counts by run and the readings."""
    arch = "qwen3-4b"
    plan = Plan(arch=arch, tiny=False, localities=2, replicas=2,
                device="cuda", overrides={"n_layers": STREAM_LAYERS[arch]})
    cfg = plan.config()
    phase(f"serve_stream {arch} at two localities, two replicas (replica "
          f"0 homed on the worker), full width, {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers; then the worker SIGKILLed "
          f"mid-stream")
    n = len(GATEWAY_ARRIVALS)
    want = {k: v * n for k, v in prefill_launches(cfg).items()}
    base, prompts = STREAMS[arch]
    # serve_stream_full's shape, whose streams these are held to
    kw = dict(prompt_len=SERVE["prompt_len"], gen_len=STREAM_GEN,
              slots=SERVE["slots"])
    t0 = time.perf_counter()
    with plan.compile() as session:
        up_s = time.perf_counter() - t0
        _zero_counts()
        res = session.serve_stream(
            trace=[{"at_round": r} for r in GATEWAY_ARRIVALS], **kw)
        counts = _counts()
        homes = [rep.home for rep in session._gateway.replicas]
        session._gateway = None
        serve = dict(res["runtime_stats"]["serve"])
        stacks = res["runtime_stats"]["distributed"]["dispatched"].get(1, 0)
        same = res["streams"] == base
        print(f"session up in {up_s:.1f} s; replica homes {homes}; "
              f"{res['tokens_per_s']:.1f} tok/s, {res['rounds']} rounds; "
              f"{stacks} stack nodes on locality 1; streams "
              f"{'bit-identical to' if same else 'DIFFER from'} one "
              f"locality's; " + ", ".join(f"{k} launches {v}"
                                          for k, v in counts.items() if v))
        if not (same and homes == [1, 0] and stacks > 0 and counts == want
                and res["completed"] == n
                and not serve.get("prefill_recompute", 0)
                and not serve.get("cross_replica_page_fetches", 0)
                and res["cache"]["pages_live"] == 0):
            raise AssertionError(f"{arch} at two localities: homes {homes}, "
                                 f"stacks {stacks}, counts {counts} (want "
                                 f"{want}), serve {serve}")

        q = RequestQueue()
        killed = {}

        def feeder():
            for i, p in enumerate(prompts):
                if i == GATEWAY_LOC_KILL_AT:
                    killed["rank"] = session.kill_locality()
                    killed["t"] = time.perf_counter()
                q.submit(p)
                time.sleep(GATEWAY_LOC_FEED_S)
            q.close()
        _zero_counts()
        t = threading.Thread(target=feeder)
        t1 = time.perf_counter()
        t.start()
        out = session.serve_stream(queue=q, **kw)
        t.join(timeout=600)
        kill_counts = _counts()
        session._gateway = None
        kserve = out["runtime_stats"]["serve"]
        deaths = kserve.get("replica_deaths", 0) \
            - serve.get("replica_deaths", 0)
        recompute = kserve.get("prefill_recompute", 0)
        fetches = kserve.get("cross_replica_page_fetches", 0)
        same_kill = all(out["streams"].get(f"r{i}") == base[f"r{i}"]
                        for i in range(n))
        print(f"locality {killed.get('rank')} SIGKILLed "
              f"{killed.get('t', t1) - t1:.2f} s into the drill: "
              f"{out['completed']} of {n} completed, streams "
              f"{'bit-identical to' if same_kill else 'DIFFER from'} one "
              f"locality's, replica deaths {deaths}, cross-replica page "
              f"fetches {fetches}, prefill recompute {recompute}; "
              f"{out['tokens_per_s']:.1f} tok/s; "
              + ", ".join(f"{k} launches {v}"
                          for k, v in kill_counts.items() if v))
        if t.is_alive() or killed.get("rank") != 1 or not same_kill \
                or out["completed"] != n or deaths != 1 or recompute \
                or out["cache"]["pages_live"] or kill_counts != want:
            raise AssertionError(f"{arch} kill-locality drill: killed "
                                 f"{killed}, deaths {deaths}, serve "
                                 f"{kserve}, counts {kill_counts}")
        findings = [str(f) for f in session.lint()]
        print(f"phylint: Session.lint() of the session's live graph "
              f"{findings}")
        if findings:
            raise AssertionError(f"{arch} at two localities: phylint "
                                 f"findings {findings}")
    torch.cuda.empty_cache()
    readings = {"session_up_s": up_s, "replica_homes": homes,
                "stack_nodes_on_worker": stacks,
                "tokens_per_s": res["tokens_per_s"], "rounds": res["rounds"],
                "lint": findings,
                "kill_drill": {"tokens_per_s": out["tokens_per_s"],
                               "replica_deaths": deaths,
                               "cross_replica_page_fetches": fetches,
                               "prefill_recompute": recompute}}
    return {"gateway_2loc": counts, "gateway_2loc_kill": kill_counts}, \
        readings


def _owned_leaf_bytes(manifest: dict, rank: int) -> int:
    """The leaf bytes of the shards that locality ``rank`` wrote."""
    return sum(int(np.prod(leaf["shape"])) * np.dtype(leaf["dtype"]).itemsize
               for sh in manifest["shards"] if sh["locality"] == rank
               for leaf in sh["leaves"])


def checkpoint_two_localities() -> tuple[dict, dict, dict]:
    """Checkpoint shards written by their owners, through
    ``Session.train``: granite-moe-1b-a400m at full width cut to the most
    layers, an even count, whose checkpoint stays within
    ``CKPT_LOC_BYTES``, on one repeated batch, in a ``tempfile.mkdtemp()``
    removed at the end.  A straight one-locality run of ``CKPT_LOC_STEPS``
    steps (saved at the last, each step timed); a two-locality run of ``CKPT_LOC_SAVE_AT`` steps saved there,
    each locality writing its own shard (the worker's leaves cross the
    wire to it); then a one-locality ``resume=True`` to
    ``CKPT_LOC_STEPS``, every kernel count set to 0 just before and read
    just after.  Checks: the two-locality losses are the straight run's;
    its manifest's ownership is {"0", "1"} and ``ckpt_leaf_wire_bytes``
    is exactly the leaf bytes of locality 1's shard; the resumed losses,
    final parameters and every leaf checksum of the last checkpoint are
    the straight run's, bit for bit; the resumed run's launches are the
    steps' (``train_launches``).  Prints each save's host copy and write
    and the restore (wall time, GB/s).  Returns the resumed run's counts,
    the readings and the straight run as the oracle of
    ``spmd_two_localities`` (its plan, stream, losses, step times, final
    parameters and step-``CKPT_LOC_STEPS`` leaf checksums)."""
    cfg = Plan(**MOE_TRAIN, device="cpu").config()
    per_layer = []
    for layers in range(1, cfg.n_layers + 1):
        c = dataclasses.replace(cfg, n_layers=layers)
        per_layer.append(12 * sum(sp.size for sp in pytree.tree_leaves(
            build_model(c).specs(), is_leaf=is_spec)))
        if per_layer[-1] > CKPT_LOC_BYTES:
            break
    layers = max(2, sum(b <= CKPT_LOC_BYTES for b in per_layer) // 2 * 2)
    plan = Plan(**MOE_TRAIN, device="cuda", overrides={"n_layers": layers})
    phase(f"checkpoint shards written by their owners: {cfg.name}, full "
          f"width, {layers} of {cfg.n_layers} layers, saved at two "
          f"localities, resumed at one")
    print(f"CUT to {layers} of {cfg.n_layers} layers: a checkpoint of "
          f"about {per_layer[layers - 1] / 1e9:.2f} GB (at most "
          f"{CKPT_LOC_BYTES / 1e9:.1f} GB and an even layer count, for the "
          f"SPMD split; the crash drill measures the I/O at depth)")
    stream = RepeatStream(stream_for(plan.config(), batch=plan.batch,
                                     seq=plan.seq, seed=plan.seed))
    kw = dict(log_every=1, verbose=False)
    n, k = CKPT_LOC_STEPS, CKPT_LOC_SAVE_AT
    root = tempfile.mkdtemp()
    try:
        with CkptClock() as clock:
            steps_clock = StepClock()
            with plan.compile() as session:
                straight = session.train(stream, steps=n, ckpt_every=n,
                                         ckpt_dir=f"{root}/straight",
                                         hooks=steps_clock, **kw)
            want_sums, _ = _leaf_checksums(f"{root}/straight/step_{n:08d}")
            want_params = straight.pop("params")
            shutil.rmtree(f"{root}/straight")
            d = f"{root}/two"
            t0 = time.perf_counter()
            with dataclasses.replace(plan, localities=2).compile() as session:
                up_s = time.perf_counter() - t0
                wrote = session.train(stream, steps=k, ckpt_every=k,
                                      ckpt_dir=d, **kw)
            dstats = wrote["runtime_stats"]["distributed"]
            manifest = ckfmt.load_manifest(f"{d}/step_{k:08d}")
            owned = {r: _owned_leaf_bytes(manifest, r) for r in (0, 1)}
            nbytes = sum(sh["nbytes"] for sh in manifest["shards"])
            torch.cuda.synchronize()
            _zero_counts()
            with plan.compile() as session:
                resumed = session.train(stream, steps=n, ckpt_every=k,
                                        ckpt_dir=d, resume=True, **kw)
            counts = _counts()
        got_sums, _ = _leaf_checksums(f"{d}/step_{n:08d}")
        same_params = all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(resumed["params"]),
            pytree.tree_leaves(want_params)))
        ownership = sorted(manifest["ownership"])
        wire = dstats["ckpt_leaf_wire_bytes"]
        print(f"two localities up in {up_s:.1f} s; step-{k} checkpoint "
              f"{nbytes} B in {len(manifest['shards'])} shards, ownership "
              f"{manifest['ownership']}; leaf bytes by writer {owned}; "
              f"ckpt_leaf_wire_bytes {wire}")
        print(f"losses straight "
              f"{' '.join(f'{x:.6f}' for x in straight['losses'])}; two "
              f"localities {' '.join(f'{x:.6f}' for x in wrote['losses'])}; "
              f"resumed at one from step {k}: "
              f"{' '.join(f'{x:.6f}' for x in resumed['losses'])} "
              f"({'bit-identical' if resumed['losses'] == straight['losses'][k:] else 'DIFFER'})"
              f"; final parameters "
              f"{'bit-identical' if same_params else 'DIFFER'}; the step-{n} "
              f"checkpoints' {len(want_sums)} leaf checksums "
              f"{'equal' if got_sums == want_sums else 'DIFFER'}")
        print(", ".join(f"{k_} launches {v}" for k_, v in counts.items()))
        want = train_launches(plan.config(), n - k, 1, 0)
        if not (ownership == ["0", "1"] and wire == owned[1] > 0
                and wrote["losses"] == straight["losses"][:k]
                and resumed["losses"] == straight["losses"][k:]
                and same_params and got_sums == want_sums
                and counts == want):
            raise AssertionError(f"owner-written checkpoint: ownership "
                                 f"{ownership}, wire {wire} (locality 1's "
                                 f"{owned[1]}), counts {counts} (want "
                                 f"{want}), or a resumed value differs")
        saves = []
        for r, what in zip(clock.saves, ("straight, one locality",
                                         "two localities",
                                         "resumed, one locality")):
            gb_s = nbytes / (r["host_s"] + r["write_s"]) / 1e9
            saves.append({"run": what, "step": r["step"],
                          "host_s": r["host_s"], "write_s": r["write_s"],
                          "gb_per_s": gb_s})
            print(f"save of step {r['step']} ({what}): host copy "
                  f"{r['host_s']:.2f} s, write {r['write_s']:.2f} s, "
                  f"{gb_s:.2f} GB/s")
        print(f"restore at one locality: {clock.restores[0]:.2f} s, "
              f"{nbytes / clock.restores[0] / 1e9:.2f} GB/s")
        readings = {"layers": layers, "checkpoint_bytes": nbytes,
                    "leaf_bytes_by_writer": owned,
                    "ckpt_leaf_wire_bytes": wire, "session_up_s": up_s,
                    "saves": saves, "restore_s": clock.restores[0]}
        oracle = {"plan": plan, "stream": stream,
                  "losses": straight["losses"],
                  "step_ms": steps_clock.step_ms(), "params": want_params,
                  "sums": want_sums}
        del resumed, straight
        torch.cuda.empty_cache()
        return counts, readings, oracle
    finally:
        shutil.rmtree(root, ignore_errors=True)


def spmd_two_localities(oracle: dict) -> tuple[dict, dict]:
    """SPMD mode (``Plan(spmd=True, localities=2)``) through
    ``Session.train``, on the plan and batch of ``checkpoint_two_localities``
    and against its straight run (``oracle``): the driver and one spawned
    worker process join a ``torch.distributed`` gloo world, both train in
    lockstep on the one card, and each writes its own checkpoint segments
    at step ``CKPT_LOC_SAVE_AT``; then a one-locality ``resume=True`` to
    ``CKPT_LOC_STEPS``.  The SPMD run has the sanitizer armed
    (``PHYRAX_SANITIZE=1``, inherited by the worker, unset after it).
    Every kernel count is set to 0 just before each run and read just
    after; the worker's come in its ``spmd_done`` report.  Checks: the SPMD
    losses are the straight run's, bit for bit; the manifest's ownership is
    {"0", "1"}; ``ckpt_leaf_wire_bytes`` is 0; every leaf's segments are
    ``checkpoint.spmd.segments``' layout; both processes launched K1 as the
    steps give (``train_launches``); ``Session.lint()`` is ``[]`` and the
    sanitizer recorded nothing in either process; no ``torch.distributed``
    world is left after the session; the resumed losses, final parameters
    and every step-``CKPT_LOC_STEPS`` leaf checksum are the straight
    run's.  Prints the bytes each rank wrote, each save's host copy, write
    and GB/s, the restore, and the armed run's median step beside the
    straight run's.  Returns the counts by run and the readings."""
    plan, stream = oracle["plan"], oracle["stream"]
    cfg = plan.config()
    n, k = CKPT_LOC_STEPS, CKPT_LOC_SAVE_AT
    phase(f"SPMD mode: {cfg.name}, full width, {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers, two processes in "
          f"lockstep on the one card writing their own segments at step "
          f"{k} (sanitizer armed), resumed at one locality")
    kw = dict(log_every=1, verbose=False)
    want = train_launches(cfg, k, 1, 0)
    root = tempfile.mkdtemp()
    d = f"{root}/spmd"
    os.environ["PHYRAX_SANITIZE"] = "1"
    sanitize.get().clear()
    try:
        with CkptClock() as clock:
            t0 = time.perf_counter()
            spmd_plan = dataclasses.replace(plan, spmd=True, localities=2)
            with spmd_plan.compile() as session:
                up_s = time.perf_counter() - t0
                steps_clock = StepClock()
                torch.cuda.synchronize()
                _zero_counts()
                wrote = session.train(stream, steps=k, ckpt_every=k,
                                      ckpt_dir=d, hooks=steps_clock, **kw)
                counts = _counts()
                findings = [str(f) for f in session.lint()]
            diags = [str(x) for x in sanitize.get().diagnostics()]
            world_left = torch.distributed.is_initialized()
            os.environ.pop("PHYRAX_SANITIZE")
            torch.cuda.synchronize()
            _zero_counts()
            with plan.compile() as session:
                resumed = session.train(stream, steps=n, ckpt_every=k,
                                        ckpt_dir=d, resume=True, **kw)
            resumed_counts = _counts()
        worker = wrote["localities"][1]
        dstats = wrote["runtime_stats"]["distributed"]
        manifest = ckfmt.load_manifest(f"{d}/step_{k:08d}")
        owned = {r: _owned_leaf_bytes(manifest, r) for r in (0, 1)}
        nbytes = sum(sh["nbytes"] for sh in manifest["shards"])
        by_leaf: dict = {}
        for sh in manifest["shards"]:
            for leaf in sh["leaves"]:
                by_leaf.setdefault(leaf["index"], {})[sh["locality"]] = leaf
        bad_layout = []
        for i, leaves in sorted(by_leaf.items()):
            shape = next(iter(leaves.values())).get(
                "global_shape", next(iter(leaves.values()))["shape"])
            for r in (0, 1):
                seg = ckspmd.segments(shape, 2, r)
                got = leaves.get(r)
                if (got is None) != (not seg) or (
                        got is not None and got.get("slice") != seg[0]):
                    bad_layout.append((i, r))
        split = sum(len(v) == 2 for v in by_leaf.values())
        got_sums, _ = _leaf_checksums(f"{d}/step_{n:08d}")
        same_params = all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(resumed["params"]),
            pytree.tree_leaves(oracle["params"])))
        wire = dstats["ckpt_leaf_wire_bytes"]
        ownership = sorted(manifest["ownership"])
        armed = sorted(steps_clock.step_ms())
        plain = sorted(oracle["step_ms"][1:])
        med = {"armed_spmd": armed[len(armed) // 2],
               "straight": plain[len(plain) // 2]}
        print(f"session up in {up_s:.1f} s (a worker spawned, both in the "
              f"gloo world); step-{k} checkpoint {nbytes} B in "
              f"{len(manifest['shards'])} shards, ownership "
              f"{manifest['ownership']}; leaf bytes by writer {owned}; "
              f"{len(by_leaf)} leaves, {split} split by rows; "
              f"ckpt_leaf_wire_bytes {wire}")
        print(f"losses straight "
              f"{' '.join(f'{x:.6f}' for x in oracle['losses'])}; SPMD "
              f"{' '.join(f'{x:.6f}' for x in wrote['losses'])} (worker's "
              f"final {worker['final_loss']:.6f}); resumed at one from step "
              f"{k}: {' '.join(f'{x:.6f}' for x in resumed['losses'])} "
              f"({'bit-identical' if resumed['losses'] == oracle['losses'][k:] else 'DIFFER'})"
              f"; final parameters "
              f"{'bit-identical' if same_params else 'DIFFER'}; the step-{n} "
              f"checkpoints' {len(got_sums)} leaf checksums "
              f"{'equal' if got_sums == oracle['sums'] else 'DIFFER'}")
        print("driver: " + ", ".join(f"{k_} launches {v}"
                                      for k_, v in counts.items() if v)
              + "; worker: " + ", ".join(f"{k_} launches {v}" for k_, v in
                                         worker["launches"].items() if v)
              + "; resumed: " + ", ".join(f"{k_} launches {v}" for k_, v in
                                          resumed_counts.items() if v))
        print(f"phylint: Session.lint() {findings}; sanitizer diagnostics: "
              f"driver {diags}, worker {worker['diagnostics']}; "
              f"torch.distributed world left after close: {world_left}")
        print(f"median step (host wall, each ending in a synchronize): SPMD "
              f"with the sanitizer armed {med['armed_spmd']:.1f} ms (steps "
              f"{' '.join(f'{x:.1f}' for x in steps_clock.step_ms())}), "
              f"straight unarmed {med['straight']:.1f} ms")
        want_resumed = train_launches(cfg, n - k, 1, 0)
        if not (wrote["losses"] == oracle["losses"][:k]
                and worker["final_loss"] == oracle["losses"][k - 1]
                and ownership == ["0", "1"] and wire == 0
                and not bad_layout and split > 0
                and counts == want and worker["launches"] == want
                and findings == [] and diags == []
                and worker["diagnostics"] == [] and not world_left
                and resumed["losses"] == oracle["losses"][k:]
                and same_params and got_sums == oracle["sums"]
                and resumed_counts == want_resumed):
            raise AssertionError(
                f"SPMD: ownership {ownership}, wire {wire}, layout "
                f"mismatches {bad_layout}, counts {counts} / worker "
                f"{worker['launches']} (want {want}), resumed "
                f"{resumed_counts} (want {want_resumed}), lint {findings}, "
                f"diagnostics {diags} / {worker['diagnostics']}, world "
                f"left {world_left}, or a loss or resumed value differs")
        saves = []
        for r, what in zip(clock.saves, ("SPMD, two processes",
                                         "resumed, one locality")):
            size = nbytes if what.startswith("SPMD") else \
                _leaf_checksums(f"{d}/step_{n:08d}")[1]
            gb_s = size / (r["host_s"] + r["write_s"]) / 1e9
            saves.append({"run": what, "step": r["step"], "bytes": size,
                          "host_s": r["host_s"], "write_s": r["write_s"],
                          "gb_per_s": gb_s})
            print(f"save of step {r['step']} ({what}, {size} B): host copy "
                  f"{r['host_s']:.2f} s, write {r['write_s']:.2f} s, "
                  f"{gb_s:.2f} GB/s")
        print(f"restore at one locality: {clock.restores[0]:.2f} s, "
              f"{nbytes / clock.restores[0] / 1e9:.2f} GB/s")
        # when each rank's shard file of the SPMD save landed, and the
        # manifest: seconds after the driver's save call (file mtimes)
        landed = {name: os.stat(f"{d}/step_{k:08d}/{name}").st_mtime
                  - clock.saves[0]["wall"]
                  for name in (ckfmt.shard_filename(0),
                               ckfmt.shard_filename(1), "manifest.json")}
        print("SPMD save of step " + str(k) + ", seconds after the "
              "driver's save call: " + ", ".join(
                  f"{name} {t:.2f}" for name, t in landed.items()))
        saves[0]["landed_s"] = landed
        readings = {"layers": cfg.n_layers, "checkpoint_bytes": nbytes,
                    "leaf_bytes_by_writer": owned, "leaves_split": split,
                    "ckpt_leaf_wire_bytes": wire, "session_up_s": up_s,
                    "saves": saves, "restore_s": clock.restores[0],
                    "step_ms": steps_clock.step_ms(), "median_step_ms": med,
                    "lint": findings, "diagnostics": diags + worker[
                        "diagnostics"]}
        del resumed, wrote
        torch.cuda.empty_cache()
        return {"spmd_2loc_L0": counts, "spmd_2loc_L1": worker["launches"],
                "spmd_resume": resumed_counts}, readings
    finally:
        os.environ.pop("PHYRAX_SANITIZE", None)
        shutil.rmtree(root, ignore_errors=True)


class ElasticChurn(StepClock):
    """A ``Session.train`` hook: the step clock, a locality added to the
    running session after step ``join_at`` (``Session.add_locality``:
    spawn, gossip, rebalance) and a driver stall after step ``stall_at``
    (the steal window).  Neither counts to a step's time: each is timed
    on its own."""

    def __init__(self, session, join_at: int, stall_at: int):
        super().__init__()
        self.session = session
        self.join_at, self.stall_at = join_at, stall_at
        self.rank = None
        self.join_s = None
        self.paused: dict = {}      # step -> host seconds before it began

    def on_step(self, it, metrics):
        super().on_step(it, metrics)
        t0 = time.perf_counter()
        if it == self.join_at:
            self.rank = self.session.add_locality()
            self.join_s = time.perf_counter() - t0
        if it == self.stall_at:
            time.sleep(ELASTIC_STALL_S)
        self.paused[it + 1] = time.perf_counter() - t0

    def step_ms(self) -> list:
        return [x - 1e3 * self.paused.get(i, 0.0)
                for i, x in enumerate(super().step_ms())]


def elastic_join() -> tuple[dict, dict]:
    """The reference's ``test_join_mid_train_matches_reference_and_steals``
    on the card: qwen3-4b at full width, cut to ``DDP2_LAYERS`` as
    ``DDP2`` is, on one repeated batch, ``ELASTIC_STEPS`` steps; first the
    static one-locality run, then ``Plan(elastic=True)`` starting alone,
    a locality added after step ``ELASTIC_JOIN_AT`` and the driver
    stalled after step ``ELASTIC_STALL_AT`` (``ElasticChurn``), every
    kernel count set to 0 just before each run and read just after.
    Checks: the elastic losses are the static run's, bit for bit; one
    locality joined, tasks were stolen and builds dispatched to it; both
    runs' launches are the steps' (``train_launches``); every worker pid
    is reaped after the session closes.  Prints the session-up time, the
    join time and the step times.  Returns the counts and the
    readings."""
    plan = Plan(**dict(DDP2, ddp=False, ddp_shards=0), device="cuda")
    cfg = plan.config()
    phase(f"elastic join mid-train: {cfg.name}, full width, {cfg.n_layers} "
          f"of {get_config(cfg.name).n_layers} layers, a locality added "
          f"after step {ELASTIC_JOIN_AT}")
    stream = RepeatStream(stream_for(cfg, batch=plan.batch, seq=plan.seq,
                                     seed=plan.seed))
    kw = dict(steps=ELASTIC_STEPS, log_every=1, verbose=False)
    want = train_launches(cfg, ELASTIC_STEPS, 1, 0)
    with plan.compile() as session:
        clock = StepClock()
        _zero_counts()
        static = session.train(stream, hooks=clock, **kw)
        static_counts = _counts()
    static_ms = clock.step_ms()
    del static["params"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with dataclasses.replace(plan, elastic=True).compile() as session:
        up_s = time.perf_counter() - t0
        churn = ElasticChurn(session, ELASTIC_JOIN_AT, ELASTIC_STALL_AT)
        _zero_counts()
        out = session.train(stream, hooks=churn, **kw)
        counts = _counts()
        d = out["runtime_stats"]["distributed"]
        pids = [p.pid for p in session.distributed.group.procs.values()]
    reaped = _reaped(pids)
    ms = churn.step_ms()
    same = out["losses"] == static["losses"]
    print(f"static run: step times {' '.join(f'{x:.1f}' for x in static_ms)}"
          f" ms")
    print(f"elastic session up in {up_s:.2f} s; locality {churn.rank} "
          f"joined after step {ELASTIC_JOIN_AT} in {churn.join_s:.2f} s "
          f"(spawn, gossip, rebalance); step times (the join and the "
          f"{ELASTIC_STALL_S * 1e3:.0f} ms stall apart) "
          f"{' '.join(f'{x:.1f}' for x in ms)} ms")
    print(f"losses {' '.join(f'{x:.6f}' for x in out['losses'])} "
          f"({'bit-identical to' if same else 'DIFFER from'} the static "
          f"run's); joined {d['joined_localities']}, membership gen "
          f"{d['membership_gen']}, stolen {d['stolen_tasks']}, dispatched "
          f"{d['dispatched']}, migrated {d['migrated_objects']}; worker "
          f"pids {pids} {'reaped' if reaped else 'STILL ALIVE'}")
    print(", ".join(f"{k} launches {v}" for k, v in counts.items()))
    if not (same and d["joined_localities"] == 1 and d["stolen_tasks"] > 0
            and d["dispatched"].get(1, 0) > 0 and reaped and pids
            and counts == static_counts == want):
        raise AssertionError(f"elastic join: stats {d}, counts {counts} "
                             f"(static {static_counts}, want {want})")
    readings = {"session_up_s": up_s, "join_s": churn.join_s,
                "step_ms": ms, "static_step_ms": static_ms,
                "stolen_tasks": d["stolen_tasks"],
                "dispatched": d["dispatched"],
                "membership_gen": d["membership_gen"]}
    del out
    torch.cuda.empty_cache()
    return counts, readings


def wire_probe(mesh) -> dict:
    """gloo's loopback between the mesh's ranks, staged as the mesh
    steps stage it: the median seconds of a 4-byte all-reduce (the
    latency) and of a 32 MiB float32 all-reduce from the card (its
    payload over that time: the rate), ``MESH_PROBE_ITERS`` each after
    a warm-up; the values ``core/granularity.py`` states."""
    def median(fn):
        fn()
        ts = []
        for _ in range(MESH_PROBE_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]
    small = torch.ones(1, device="cuda")
    big = torch.ones(8 << 20, device="cuda")
    lat = median(lambda: collectives.all_reduce(small, mesh))
    t = median(lambda: collectives.all_reduce(big, mesh))
    return {"latency_s": lat, "rate_bytes_per_s": big.numel() * 4 / t,
            "big_s": t}


def mesh_warmup(spec: dict, endpoint=None, driver=None) -> dict:
    """A worker rank's cold start, taken while the driver runs the
    oracle: one step of the plan on this process alone (no mesh, so no
    collective), which loads the CUDA context, the libraries and the
    kernels' modules (the first step of a fresh rank process otherwise
    took about 10 s)."""
    plan = dataclasses.replace(spec["plan"], data=1)
    step = steps.make_train_step(plan.config(), steps.Strategy(), plan=plan)
    params, opt = step.init(
        torch.Generator(device="cuda").manual_seed(plan.seed), "cuda")
    step.fn(params, opt, to_device(spec["stream"].batch_at(0), "cuda"))
    torch.cuda.synchronize()
    return {}


def mesh_strategies_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """One rank's half of the mesh-strategies phase (module level: the
    worker rank runs it too, shipped by reference): on
    ``make_local_mesh(data=2)``, each of ``MESH_STRATEGIES`` for
    ``MESH_STEPS`` steps from the seed's init, every kernel count and the
    wire counters set to 0 just before the steps and read just after,
    each step ending in a synchronize (host wall); zero1 takes
    ``MESH_DRILL_STEPS`` steps (the drill's straight run).  At every
    onebit step, bucket 0's exchange (``TrainStep.on_bucket``, kept in the
    step and checked after its clock stops) is held
    against the plain versions, so that the trajectory, not one step, is
    checked on the card: this rank's payload and new residual against the
    plain K3a on its bucket and the residual it read
    (``k3a_against_plain``), that residual the one the previous step
    returned (zero at the first), this rank's payload at its own origin
    of the gathered ones, and the mean bit for bit the plain K3b's on the
    gathered payloads, summed in origin order.  Returns, per strategy,
    the losses, gradient norms, step times, launches, wire counters, the
    device's peak allocation, the m and v bytes of the leaves zero1
    scatters and the parameters' ``param_bit_sums`` after the last step
    (the ranks' replicas must agree bit for bit); for onebit, the worst
    of its per-step checks."""
    plan, stream = spec["plan"], spec["stream"]
    mesh = make_local_mesh(data=plan.data)
    cfg = plan.config()
    out = {"wire_probe": wire_probe(mesh)}
    for name in MESH_STRATEGIES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = steps.make_train_step(cfg, steps.Strategy(name=name),
                                     plan=plan, mesh=mesh)
        params, opt = step.init(
            torch.Generator(device="cuda").manual_seed(plan.seed), "cuda")
        mask = overlap.zero1_scatter_mask([lf.spec for lf in step.leaves],
                                          mesh, default_rules(), 2)
        if name == "zero1":
            mv = sum(4 * (m.numel() + v.numel()) for m, v, sc in zip(
                opt["m"], opt["v"], mask) if sc)
        else:
            flat_m = pytree.tree_leaves(opt["m"])
            mv = sum(8 * flat_m[i].numel() for lf, sc in zip(step.leaves,
                                                             mask)
                     if sc for i in lf.members)
        checks: dict = {}
        pending: dict = {}
        if name == "onebit":
            checks.update(steps=0, bad_words=0, near_words=0,
                          scale_rel_err=0.0, err_abs_err=0.0,
                          mean_max_abs_err=0.0, carried=True)

            def keep(i, packed, scales, mean, own):
                # held for check() after the step's clock stops; the
                # mean is cloned, the optimizer may clip it in place
                if i == 0:
                    pending.update(packed=packed, scales=scales,
                                   mean=mean.clone(), own=own)

            def check(packed, scales, mean, own):
                buf, err, new_err = own
                prev = checks.pop("prev_err", None)
                checks["carried"] &= (torch.equal(err, prev)
                                      if prev is not None
                                      else not bool(err.any()))
                r = mesh.rank
                q = k3a_against_plain(buf.reshape(err.shape), err,
                                      packed[r], scales[r], new_err)
                checks["bad_words"] = max(checks["bad_words"], q["bad"])
                checks["near_words"] += q["near"]
                for k in ("scale_rel_err", "err_abs_err"):
                    checks[k] = max(checks[k], q[k])
                acc = onebit_dequantize_ref(packed[0], scales[0])
                for o in range(1, packed.shape[0]):
                    acc = acc + onebit_dequantize_ref(packed[o], scales[o])
                plain = acc.div_(packed.shape[0]).reshape(-1)
                checks["mean_max_abs_err"] = max(
                    checks["mean_max_abs_err"],
                    float((plain - mean).abs().max()))
                checks["bucket0_elements"] = int(plain.numel())
                checks["steps"] += 1
                checks["prev_err"] = new_err
            step.on_bucket = keep
        torch.cuda.synchronize()
        _zero_counts()
        collectives.reset_stats()
        losses, gnorms, wall = [], [], []
        n_steps = MESH_DRILL_STEPS if name == "zero1" else MESH_STEPS
        for it in range(n_steps):
            batch = to_device(stream.batch_at(it), "cuda")
            t0 = time.perf_counter()
            m, params, opt = step.fn(params, opt, batch)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if pending:
                check(**pending)
                pending.clear()
        rec = {"losses": losses, "grad_norms": gnorms, "step_ms": wall,
               "launches": _counts(), "wire": collectives.stats(),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "scattered_mv_bytes": mv, "steps": n_steps,
               "buckets": len(step.plan.buckets) if step.plan else 0,
               "param_bit_sums": param_bit_sums(params)}
        if name == "onebit":
            checks.pop("prev_err", None)
            rec["onebit_checks"] = checks
        out[name] = rec
        del step, params, opt, m
    torch.cuda.empty_cache()
    return out


def mesh_training() -> tuple[dict, dict]:
    """Data-parallel mesh training on the one card (ROADMAP item 14, its
    data half), on the SPMD phase's plan: granite-moe-1b-a400m at full
    width cut to ``MESH_LAYERS`` layers, one repeated 8 x 512 batch, seed
    0.  One mesh session, ``Plan(data=2)``: two rank processes (this one
    and a spawned worker) in a gloo world.  (a) The oracle, world-1 fabric
    DDP with 2 fp32 shards, ``MESH_STEPS`` steps, which computes the
    data=2 meaning in one process, run here while the worker rank takes
    its cold start (``mesh_warmup``).  (b) ``Session.run_ranks``
    runs ``mesh_strategies_rank`` on both: phylanx and horovod must give
    the oracle's losses and gradient norms within ``MESH_RTOL``, zero1
    within ``MESH_ZERO1_RTOL``; zero1's m and v on the scattered leaves
    exactly half of phylanx's; onebit's K3a and K3b counts exact from the
    bucket plan (``train_launches``: buckets a step for K3a, twice that
    for K3b), K1's exact in each rank for every strategy; onebit's bucket-0
    exchange at every step the plain versions' (this rank's payload and
    residual to the kernels phase's tolerance, the mean bit for bit), the
    residual carried between steps, its first loss phylanx's; every
    strategy's parameters bit-identical across the two ranks.  (c) The
    drill of ``examples/train_lm_ddp.py`` on the same session with zero1:
    a run saving every ``MESH_DRILL_EVERY`` steps that fails at
    ``MESH_DRILL_FAIL_AT`` (it must raise), then ``resume=True`` to
    ``MESH_DRILL_STEPS``: the resumed steps bit-identical to (b)'s
    straight zero1 run, the checkpoint's leaves the reference's global
    shapes.  (d) ``resilience="replay"`` at data=1 for ``MESH_STEPS``
    steps: the straight run's losses bit for bit, and what the input
    copies cost.  No ``torch.distributed`` world is left and the worker
    is reaped.  Returns the counts by run and the readings."""
    plan = Plan(**MESH_TRAIN, device="cuda")
    cfg = plan.config()
    stream = RepeatStream(stream_for(cfg, batch=plan.batch, seq=plan.seq,
                                     seed=plan.seed))
    phase(f"mesh training: {cfg.name}, full width, {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers, two rank processes on "
          f"the one card: four strategies against world-1 2-shard fp32 "
          f"DDP, the zero1 crash drill, step replay")
    print(f"CUT to {cfg.n_layers} of {get_config(cfg.name).n_layers} "
          f"layers: the SPMD phase's plan (two processes of this state on "
          f"the one card, the phase within its time); the drill to "
          f"{MESH_DRILL_STEPS} steps failing at {MESH_DRILL_FAIL_AT + 1} "
          f"(the script's time)")
    kw = dict(log_every=1, verbose=False)
    counts: dict = {}
    mesh_plan = dataclasses.replace(plan, data=2, strategy="zero1")
    root = tempfile.mkdtemp()
    d = f"{root}/mesh"
    try:
        t0 = time.perf_counter()
        with mesh_plan.compile() as session:
            up_s = time.perf_counter() - t0
            pids = [pr.pid for pr in
                    session.ranks.group.procs.values()]
            # (a) the oracle, while the worker rank warms up
            session.ranks.spmd_train({"plan": mesh_plan,
                                            "stream": stream,
                                            "loop": mesh_warmup})
            clock = StepClock()
            oracle_plan = dataclasses.replace(plan, ddp=True, ddp_shards=2,
                                              grad_codec="fp32")
            with oracle_plan.compile() as oracle_session:
                oracle = oracle_session.train(stream, steps=MESH_STEPS,
                                              hooks=clock, **kw)
            want_l, want_g = oracle["losses"], clock.grad_norms
            del oracle
            torch.cuda.empty_cache()
            warm = session.ranks.wait_spmd_done(timeout=300.0)
            if not all(m.get("ok") for m in warm.values()):
                raise AssertionError(f"mesh warm-up failed: {warm}")
            # (b) the strategies, one world
            t1 = time.perf_counter()
            ranks = session.run_ranks(mesh_strategies_rank,
                                      {"plan": mesh_plan, "stream": stream})
            strategies_s = time.perf_counter() - t1
            # (c) the drill, against (b)'s zero1 run
            t1 = time.perf_counter()
            straight = {"losses": ranks[0]["zero1"]["losses"]}
            try:
                session.train(stream, steps=MESH_DRILL_STEPS,
                              ckpt_every=MESH_DRILL_EVERY, ckpt_dir=d,
                              fail_at_step=MESH_DRILL_FAIL_AT, **kw)
                raised = False
            except RuntimeError as e:
                raised = "injected node failure" in str(e)
            torch.cuda.synchronize()
            _zero_counts()
            with CkptClock() as cclock:
                resumed = session.train(stream, steps=MESH_DRILL_STEPS,
                                        ckpt_every=MESH_DRILL_EVERY,
                                        ckpt_dir=d, resume=True, **kw)
            counts["mesh_drill_resume_L0"] = _counts()
            counts["mesh_drill_resume_L1"] = resumed["localities"][1][
                "launches"]
            drill_s = time.perf_counter() - t1
            manifest = ckfmt.load_manifest(
                f"{d}/step_{MESH_DRILL_STEPS:08d}")
            step = steps.make_train_step(cfg, steps.Strategy(name="zero1"))
            meta = lambda s: torch.empty(s.shape, dtype=s.dtype,
                                         device="meta")
            like = (pytree.tree_map(meta, step.specs, is_leaf=is_spec),
                    pytree.tree_map(meta, step.opt_structs(),
                                    is_leaf=is_spec))
            want_shapes = [list(lead) + list(items[0][1].shape)
                           for _, lead, items in bridge._slots(like)]
            got_shapes = [None] * len(want_shapes)
            for sh in manifest["shards"]:
                for leaf in sh["leaves"]:
                    got_shapes[leaf["index"]] = leaf["shape"]
            del step, like
            # (s)'s oracle: the wave loop and the gateway on this mesh
            _zero_counts()
            served = session.serve(**S21_SERVE, verbose=False)
            streamed = session.serve_stream(**S21_STREAM, verbose=False)
            counts["mesh_serve_oracle_L0"] = _counts()
            MESH_ORACLE.update(
                tokens=[g.tolist() for g in served["generated"]],
                streams=streamed["streams"])
        world_left = torch.distributed.is_initialized()
        reaped = _reaped(pids)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # (d) replay at data=1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with plan.compile() as session:
        plain = session.train(stream, steps=MESH_STEPS, **kw)
        _zero_counts()
        replay = session.train(stream, steps=MESH_STEPS, resilience="replay",
                               **kw)
        counts["replay"] = _counts()
    replay_s = time.perf_counter() - t1
    del plain["params"], replay["params"], resumed["params"]

    res = {r: ranks[r] for r in (0, 1)}
    MESH_ORACLE.update(plan=plan, stream=stream,
                       losses=res[0]["phylanx"]["losses"],
                       grad_norms=res[0]["phylanx"]["grad_norms"],
                       oracle={"losses": want_l, "grad_norms": want_g})
    fails = []
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    identical = {}
    for name in MESH_STRATEGIES:
        for r in (0, 1):
            rec = res[r][name]
            counts[f"mesh_{name}_L{r}"] = rec["launches"]
            want = train_launches(cfg, rec["steps"], 1, rec["buckets"],
                                  decodes=2)
            if rec["launches"] != want:
                fails.append(f"{name} rank {r} launches {rec['launches']} "
                             f"(want {want})")
        rec = res[0][name]
        if res[1][name]["param_bit_sums"] != rec["param_bit_sums"]:
            fails.append(f"{name}: the ranks' parameters differ")
        if name == "onebit":
            for r in (0, 1):
                c = res[r][name]["onebit_checks"]
                if not (c["steps"] == rec["steps"] and c["bad_words"] == 0
                        and c["scale_rel_err"] <= 1e-6
                        and c["err_abs_err"] <= 1e-6 and c["carried"]
                        and c["mean_max_abs_err"] == 0.0):
                    fails.append(f"onebit exchange on rank {r}: {c}")
            # the first step's loss is the init's: phylanx's, bit for bit
            if rec["losses"][0] != res[0]["phylanx"]["losses"][0] \
                    or res[1][name]["losses"] != rec["losses"]:
                fails.append(f"onebit losses {rec['losses']} (rank 1 "
                             f"{res[1][name]['losses']}, phylanx's first "
                             f"{res[0]['phylanx']['losses'][0]})")
            continue
        tol = MESH_ZERO1_RTOL if name == "zero1" else MESH_RTOL
        got_l, got_g = rec["losses"][:MESH_STEPS], \
            rec["grad_norms"][:MESH_STEPS]
        le, ge = rel(got_l, want_l), rel(got_g, want_g)
        identical[name] = got_l == want_l and got_g == want_g
        if le > tol or ge > tol or res[1][name]["losses"] != rec["losses"]:
            fails.append(f"{name} losses {got_l} / gnorms "
                         f"{got_g} against the oracle "
                         f"{want_l} / {want_g} (rel {le:.3g}, {ge:.3g})")
    z, p = res[0]["zero1"]["scattered_mv_bytes"], \
        res[0]["phylanx"]["scattered_mv_bytes"]
    if 2 * z != p:
        fails.append(f"zero1's scattered m and v {z} B, phylanx's {p} B")
    drill_ok = (raised and resumed["losses"] == straight["losses"][
        MESH_DRILL_EVERY:] and got_shapes == want_shapes)
    if not drill_ok:
        fails.append(f"drill: raised {raised}, resumed "
                     f"{resumed['losses']} against {straight['losses']}, "
                     f"shapes {'equal' if got_shapes == want_shapes else 'DIFFER'}")
    want_drill = train_launches(cfg, MESH_DRILL_STEPS - MESH_DRILL_EVERY, 1,
                                0)
    for r in (0, 1):
        if counts[f"mesh_drill_resume_L{r}"] != want_drill:
            fails.append(f"drill rank {r} launches "
                         f"{counts[f'mesh_drill_resume_L{r}']}")
    if replay["losses"] != plain["losses"] or \
            counts["replay"] != train_launches(cfg, MESH_STEPS, 1, 0):
        fails.append(f"replay {replay['losses']} against {plain['losses']}"
                     f", launches {counts['replay']}")
    if world_left or not reaped:
        fails.append(f"world left {world_left}, worker reaped {reaped}")

    for name in MESH_STRATEGIES:
        for r in (0, 1):
            rec = res[r][name]
            w = rec["wire"]
            print(f"{name} rank {r}: losses "
                  f"{' '.join(f'{x:.6f}' for x in rec['losses'])}, gnorms "
                  f"{' '.join(f'{x:.6f}' for x in rec['grad_norms'])}; steps "
                  f"{' '.join(f'{x:.1f}' for x in rec['step_ms'])} ms; wire "
                  f"{w['bytes']} B in {w['calls']} collectives ({w['hops']} "
                  f"hops), {w['wire_s']:.3f} s in gloo, staging "
                  f"{w['staged_bytes']} B in {w['staging_s']:.3f} s; peak "
                  f"{rec['peak_bytes'] / 1e9:.3f} GB; m+v on zero1's "
                  f"scattered leaves {rec['scattered_mv_bytes']} B")
    print(f"oracle (world-1 DDP, 2 fp32 shards): losses "
          f"{' '.join(f'{x:.6f}' for x in want_l)}, gnorms "
          f"{' '.join(f'{x:.6f}' for x in want_g)}; bit-identical to it: "
          f"{identical}")
    for r in (0, 1):
        w = res[r]["wire_probe"]
        print(f"gloo loopback, rank {r}: 4-byte all-reduce "
              f"{w['latency_s'] * 1e6:.1f} us, 32 MiB all-reduce "
              f"{w['big_s'] * 1e3:.1f} ms ({w['rate_bytes_per_s'] / 1e9:.3f}"
              f" GB/s, staging included)")
    for r in (0, 1):
        c = res[r]["onebit"]["onebit_checks"]
        print(f"onebit rank {r}: {res[r]['onebit']['buckets']} buckets, "
              f"K3a {res[r]['onebit']['launches']['onebit_quantize']} and "
              f"K3b {res[r]['onebit']['launches']['onebit_dequantize']} "
              f"launches; bucket 0 ({c.get('bucket0_elements')} elements) "
              f"at each of {c['steps']} steps against the plain versions: "
              f"own payload words other than near-zero {c['bad_words']} "
              f"(near-zero {c['near_words']}), scale rel err "
              f"{c['scale_rel_err']:.3g}, new residual abs err "
              f"{c['err_abs_err']:.3g}, residual carried {c['carried']}, "
              f"mean max abs err {c['mean_max_abs_err']}")
    print("ranks' parameters bit-identical after the last step: "
          + str({n: res[0][n]["param_bit_sums"] == res[1][n][
              "param_bit_sums"] for n in MESH_STRATEGIES}))
    saves = [dict(r) for r in cclock.saves]
    print(f"session up in {up_s:.1f} s; strategies {strategies_s:.1f} s; "
          f"drill {drill_s:.1f} s (raised {raised}; resumed "
          f"{' '.join(f'{x:.6f}' for x in resumed['losses'])} against "
          f"straight {' '.join(f'{x:.6f}' for x in straight['losses'])}; "
          f"{len(got_shapes)} leaves in the reference's global shapes: "
          f"{got_shapes == want_shapes}; saves {saves}, restore "
          f"{cclock.restores}); replay {replay_s:.1f} s ({replay['losses']} "
          f"against {plain['losses']}, input copies "
          f"{replay['resilience']['copies']}); world left {world_left}, "
          f"worker reaped {reaped}")
    if fails:
        raise AssertionError("mesh training: " + "; ".join(fails))
    readings = {"layers": cfg.n_layers, "session_up_s": up_s,
                "strategies_s": strategies_s, "drill_s": drill_s,
                "replay_s": replay_s, "oracle": {"losses": want_l,
                                                 "grad_norms": want_g},
                "bit_identical_to_oracle": identical,
                "wire_probe": {r: res[r]["wire_probe"] for r in (0, 1)},
                "ranks": {r: {n: {k: v for k, v in res[r][n].items()
                                  if k != "launches"}
                              for n in MESH_STRATEGIES} for r in (0, 1)},
                "drill": {"straight": straight["losses"],
                          "resumed": resumed["losses"], "saves": saves,
                          "restores": cclock.restores},
                "replay": {"losses": replay["losses"],
                           "copies": replay["resilience"]["copies"]}}
    return counts, readings


class CodecProbe:
    """Fabric DDP's codec probe (``Session._codec_probe``, shipped to
    every locality and rank; module level, so it ships by reference): each
    bucket's K3a against its plain version on the same global bucket and
    residual (``k3a_against_plain``, the kernels phase's tolerance), each
    K3b decode bit for bit the plain version's (the mean is their sum in
    origin order, so it is then the plain decode's), and at the end the
    ``param_bit_sums`` of the leaves that stay whole on a model axis."""

    def __init__(self):
        self.buckets = self.bad = self.near = self.decodes = 0
        self.decode_diffs = 0
        self.scale_rel_err = self.err_abs_err = 0.0

    def encoded(self, i, buf, err, packed, scale, new_err):
        q = k3a_against_plain(buf.reshape(err.shape), err, packed, scale,
                              new_err)
        self.buckets += 1
        self.bad += q["bad"]
        self.near += q["near"]
        self.scale_rel_err = max(self.scale_rel_err, q["scale_rel_err"])
        self.err_abs_err = max(self.err_abs_err, q["err_abs_err"])

    def decoded(self, packed, scale, out):
        want = onebit_dequantize_ref(packed, scale).reshape(-1)[
            :out.numel()]
        self.decodes += 1
        self.decode_diffs += int(not torch.equal(out, want))

    def report(self, engine, params) -> dict:
        split = engine.tstep.split_mask
        mask = pytree.tree_leaves(split) if split is not None else None
        whole = [p for p, m in zip(pytree.tree_leaves(params),
                                   mask or [False] * 10 ** 6) if not m]
        return {"buckets": self.buckets, "bad": self.bad, "near": self.near,
                "scale_rel_err": self.scale_rel_err,
                "err_abs_err": self.err_abs_err, "decodes": self.decodes,
                "decode_diffs": self.decode_diffs,
                "whole_sums": param_bit_sums(whole)}


def _probe_ok(p: dict) -> bool:
    return (p["bad"] == 0 and p["scale_rel_err"] <= 1e-6
            and p["err_abs_err"] <= 1e-6 and p["decode_diffs"] == 0)


def ddp_model_axis() -> tuple[dict, dict]:
    """(r): fabric DDP beside a model axis on the one card (ROADMAP item
    14b part 6): ``Plan(ddp=True, model=2, localities=2)``, four
    processes, the mesh phase's plan in float32 compute (``S21_DDP``).
    Each locality is a model group of two rank processes (a gloo world a
    locality); model coordinate 0 gathers the group's split leaves into
    the reference's global buckets one at a time, runs the ring over
    them and hands each rank its blocks of the mean.  fp32,
    ``S21_DDP_FP32_STEPS`` step: the loss within ``TP_LOSS_RTOL`` and the
    norm within ``MOE_TP_NORM_RTOL`` of world-1 2-shard fp32 DDP of the
    same plan at model=1 (run here while the session's other processes
    take their cold start).  onebit,
    ``S21_DDP_ONEBIT_STEPS`` steps in a second session: every leader's
    K3a on every global bucket against its plain version, every K3b
    decode the plain version's bit for bit (``CodecProbe``).  Both:
    ``grad_wire_bytes`` = steps x 1 x ``codec_bytes`` on each leader,
    ``codec_bytes`` model=1's, the leaves that stay whole bit-identical
    on all four processes, each process's K1, K3a and K3b launches as the
    steps give them, every process reaped.  Prints each process's
    launches, the model groups' gather bytes and gloo seconds, the step's
    host wall and each process's peak.  Returns the counts and
    readings."""
    plan = Plan(**S21_DDP, device="cuda")
    cfg = plan.config()
    stream = RepeatStream(stream_for(cfg, batch=plan.batch, seq=plan.seq,
                                     seed=plan.seed))
    phase(f"(r) fabric DDP at model=2 over two localities: {cfg.name}, "
          f"full width, {cfg.n_layers} layers, float32, four processes on "
          f"the one card, fp32 then onebit")
    kw = dict(log_every=1, verbose=False)
    counts: dict = {}
    fails: list = []
    readings: dict = {}
    gplan = steps.make_ddp_step(plan=dataclasses.replace(
        plan, device="cpu")).grad_plan
    n_buckets = len(gplan.buckets)
    want_l = want_g = None
    for codec, n in (("fp32", S21_DDP_FP32_STEPS),
                     ("onebit", S21_DDP_ONEBIT_STEPS)):
        mplan = dataclasses.replace(plan, model=2, localities=2,
                                    grad_codec=codec)
        m1_bytes = get_codec(codec).wire_bytes(gplan)
        t0 = time.perf_counter()
        with mplan.compile() as s:
            up_s = time.perf_counter() - t0
            pids = [pr.pid for g in (s.distributed, s.ranks)
                    for pr in g.group.procs.values()]
            if want_l is None:
                # the three other processes' cold start, while this one
                # runs the oracle: model=1 over the same two shards
                for g in (s.distributed, s.ranks):
                    g.spmd_train({"loop": tp_warmup})
                clock = StepClock()
                _zero_counts()
                with plan.compile() as one:
                    oracle = one.train(stream, steps=S21_DDP_FP32_STEPS,
                                       hooks=clock, **kw)
                counts["ddp_m1_oracle"] = _counts()
                want_l, want_g = oracle["losses"], clock.grad_norms
                del oracle
                torch.cuda.empty_cache()
                for g in (s.distributed, s.ranks):
                    warm = g.wait_spmd_done(timeout=300.0)
                    if not all(m.get("ok") for m in warm.values()):
                        raise AssertionError(f"(r) warm-up failed: {warm}")
            s._codec_probe = CodecProbe()
            clock = StepClock()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t1 = time.perf_counter()
            out = s.train(stream, steps=n, hooks=clock, **kw)
            run_s = time.perf_counter() - t1
            c0 = _counts()
            peak0 = torch.cuda.max_memory_allocated()
        reaped = _reaped(pids)
        leader, ranks = out["localities"][1], out["ranks"]
        procs = {"L0": (c0, out["probe"], out["wire"], peak0),
                 "L1": (leader["launches"], leader["probe"], leader["wire"],
                        leader["peak_bytes"])}
        for r, m in ranks.items():
            procs[f"R{r}"] = (m["launches"], m["probe"], m["wire"],
                              m["peak_bytes"])
        nb = n_buckets if codec == "onebit" else 0
        for name, (c, probe, wire, peak) in procs.items():
            counts[f"ddp_m2_{codec}_{name}"] = c
            lead = name.startswith("L")
            want = train_launches(cfg, n, 1, nb if lead else 0, decodes=2)
            if c != want:
                fails.append(f"{codec} {name} launches {c} (want {want})")
            if probe["whole_sums"] != out["probe"]["whole_sums"]:
                fails.append(f"{codec} {name}: whole leaves differ from "
                             f"the driver's")
            if codec == "onebit" and lead and (
                    not _probe_ok(probe) or probe["buckets"] != n * nb
                    or probe["decodes"] != 2 * n * nb):
                fails.append(f"{codec} {name} codec against the plain "
                             f"versions: {probe}")
        wire_ok = (out["codec_bytes"] == m1_bytes
                   and out["grad_wire_bytes"] == n * 1 * m1_bytes
                   and leader["grad_wire_bytes"] == out["grad_wire_bytes"])
        if not wire_ok:
            fails.append(f"{codec} wire {out['grad_wire_bytes']} B, codec "
                         f"{out['codec_bytes']} B (model=1's {m1_bytes} B)")
        if any(m["final_loss"] != out["final_loss"]
               for m in (leader, *ranks.values())):
            fails.append(f"{codec}: a process's loss is not the driver's")
        if codec == "fp32":
            le = abs(out["losses"][0] - want_l[0]) / abs(want_l[0])
            ge = abs(clock.grad_norms[0] - want_g[0]) / abs(want_g[0])
            if le > TP_LOSS_RTOL or ge > MOE_TP_NORM_RTOL:
                fails.append(f"fp32 loss {out['losses']} / gnorm "
                             f"{clock.grad_norms} against model=1's "
                             f"{want_l} / {want_g} (rel {le:.3g}, {ge:.3g})")
        model = {k: v["axes"]["model"] for k, (_, _, v, _) in procs.items()}
        print(f"{codec}: session up in {up_s:.1f} s (4 processes: 2 "
              f"localities x a model group of 2); {n} step(s) in "
              f"{run_s:.1f} s, host wall "
              f"{' '.join(f'{x:.1f}' for x in clock.step_ms())} ms a step; "
              f"losses {' '.join(f'{x:.6f}' for x in out['losses'])}, "
              f"gnorms {' '.join(f'{x:.6f}' for x in clock.grad_norms)}"
              + (f" (model=1: {want_l[0]:.6f} / {want_g[0]:.6f})"
                 if codec == "fp32" else "")
              + f"; grad-wire {out['grad_wire_bytes']} B a locality "
              f"(codec {out['codec_bytes']} B, model=1's {m1_bytes} B)")
        for name, (c, probe, wire, peak) in procs.items():
            w = wire["axes"]["model"]
            print(f"  {name}: K1 {c['flash_attention']} / "
                  f"{c['flash_attention_bwd']}, K3a {c['onebit_quantize']}, "
                  f"K3b {c['onebit_dequantize']}; model group {w['bytes']} B "
                  f"in {w['calls']} collectives, {w['wire_s']:.3f} s in gloo"
                  f", staging {w['staging_s']:.3f} s; peak "
                  f"{peak / 1e9:.3f} GB"
                  + (f"; codec against plain: {probe}"
                     if codec == "onebit" and name.startswith("L") else ""))
        print(f"  whole leaves bit-identical on all four: "
              f"{all(p[1]['whole_sums'] == out['probe']['whole_sums'] for p in procs.values())}; "
              f"every process reaped {reaped}")
        if not reaped:
            fails.append(f"{codec}: a process was not reaped")
        readings[codec] = {
            "up_s": up_s, "run_s": run_s, "step_ms": clock.step_ms(),
            "losses": out["losses"], "grad_norms": clock.grad_norms,
            "grad_wire_bytes": out["grad_wire_bytes"],
            "codec_bytes": out["codec_bytes"], "model_wire": model,
            "peak_bytes": {k: v[3] for k, v in procs.items()},
            "probe": {k: {x: y for x, y in v[1].items() if x != "whole_sums"}
                      for k, v in procs.items()}}
        del out
        torch.cuda.empty_cache()
    readings["model1"] = {"losses": want_l, "grad_norms": want_g}
    if fails:
        raise AssertionError("(r) fabric DDP at model=2: " + "; ".join(fails))
    return counts, readings


class _LossLog(ElasticChurn):
    """``ElasticChurn`` that also keeps the logged losses."""

    def __init__(self, session, join_at, stall_at):
        super().__init__(session, join_at, stall_at)
        self.losses: list = []

    def on_log(self, it, loss):
        self.losses.append(loss)


def mesh_localities() -> tuple[dict, dict]:
    """(s): a mesh beside a task locality and an elastic joiner (ROADMAP
    item 14b part 6): ``Plan(localities=2, elastic=True, data=2)`` with
    phylanx on the mesh phase's plan and repeated batch; two rank
    processes in a gloo world and one task locality in none, which
    builds each step's batch (rank 0 feeds it to both ranks) and owns
    checkpoint shards.  ``examples/train_lm_ddp.py``'s drill: a save at
    step ``S21_EVERY``, an injected failure at ``S21_FAIL_AT`` (it must
    raise), ``resume=True`` to ``S21_STEPS`` on the same session; a
    locality joins after step ``S21_JOIN_AT + 1`` and the driver stalls
    after step ``S21_STALL_AT + 1`` (the steal window).  Checks: the
    first ``MESH_STEPS`` losses and norms the mesh phase's phylanx run's
    bit for bit; the resumed step the failed run's; each rank's K1 as
    the steps give; batches built on locality 1 and on the joiner, stolen
    tasks; the step-2 manifest owned by the three localities.  Then
    ``Session.serve`` (one wave of 4 x 4, its ``stack`` on a task
    locality) and ``serve_stream`` (two replicas, one homed on a task
    locality): the tokens and streams of the mesh phase's session.  Every
    process reaped.  Returns the counts, the readings and the resumed
    run's losses (which (t)'s resume is held to)."""
    base, stream = MESH_ORACLE["plan"], MESH_ORACLE["stream"]
    plan = dataclasses.replace(base, data=2, localities=2, elastic=True,
                               strategy="phylanx")
    cfg = plan.config()
    phase(f"(s) a mesh beside a task locality and an elastic joiner: "
          f"{cfg.name}, {cfg.n_layers} layers, data=2, the example's drill, "
          f"then serve and serve_stream")
    kw = dict(log_every=1, verbose=False)
    counts: dict = {}
    fails: list = []
    root = tempfile.mkdtemp()
    d = f"{root}/s21"
    t0 = time.perf_counter()
    with plan.compile() as s:
        up_s = time.perf_counter() - t0
        first = _LossLog(s, S21_JOIN_AT, S21_STALL_AT)
        torch.cuda.synchronize()
        _zero_counts()
        t1 = time.perf_counter()
        try:
            s.train(stream, steps=S21_STEPS, ckpt_every=S21_EVERY,
                    ckpt_dir=d, fail_at_step=S21_FAIL_AT, hooks=first, **kw)
            raised = False
        except RuntimeError as e:
            raised = "injected node failure" in str(e)
        counts["s21_failed_L0"] = _counts()
        again = _LossLog(s, None, None)
        torch.cuda.synchronize()
        _zero_counts()
        resumed = s.train(stream, steps=S21_STEPS, ckpt_every=S21_EVERY,
                          ckpt_dir=d, resume=True, hooks=again, **kw)
        drill_s = time.perf_counter() - t1
        counts["s21_resumed_L0"] = _counts()
        counts["s21_resumed_L1"] = resumed["localities"][1]["launches"]
        dstats = resumed["runtime_stats"]["distributed"]
        world = torch.distributed.get_world_size()
        _zero_counts()
        t1 = time.perf_counter()
        served = s.serve(**S21_SERVE, verbose=False)
        streamed = s.serve_stream(**S21_STREAM, verbose=False)
        serve_s = time.perf_counter() - t1
        counts["s21_serve_L0"] = _counts()
        pids = [pr.pid for g in (s.distributed, s.ranks)
                for pr in g.group.procs.values()]
    reaped = _reaped(pids)
    manifest = ckfmt.load_manifest(f"{d}/step_{S21_EVERY:08d}")
    shutil.rmtree(root, ignore_errors=True)
    want = train_launches(cfg, S21_STEPS - S21_EVERY, 1, 0)
    for r in (0, 1):
        if counts[f"s21_resumed_L{r}"] != want:
            fails.append(f"rank {r} launches {counts[f's21_resumed_L{r}']} "
                         f"(want {want})")
    k = MESH_STEPS
    same_first = (first.losses[:k] == MESH_ORACLE["losses"][:k]
                  and first.grad_norms[:k] == MESH_ORACLE["grad_norms"][:k])
    if not (raised and same_first and len(first.losses) == S21_FAIL_AT
            and again.losses[0] == first.losses[S21_EVERY]):
        fails.append(f"drill: raised {raised}, losses {first.losses} / "
                     f"{first.grad_norms} then {again.losses} against the "
                     f"mesh phase's {MESH_ORACLE['losses']} / "
                     f"{MESH_ORACLE['grad_norms']}")
    built = dstats["dispatched"]
    if not (built.get(1, 0) > 0 and built.get(first.rank, 0) > 0
            and dstats["stolen_tasks"] > 0 and first.rank == 2):
        fails.append(f"dispatched {built}, stolen {dstats['stolen_tasks']}"
                     f", joiner {first.rank}")
    if sorted(manifest["ownership"]) != ["0", "1", "2"]:
        fails.append(f"ownership {manifest['ownership']}")
    stack_home = [n for n in served["nodes"] if n.startswith("stack:")]
    tokens = [g.tolist() for g in served["generated"]]
    # a replica homed on a task locality runs its requests' stack there
    homes = sorted({n.rsplit("@", 1)[-1] for n in streamed["nodes"]
                    if n.startswith("stack:")})
    used = sorted(set(streamed["replica_assignments"].values()))
    if not (stack_home and all("@L0" not in n for n in stack_home)
            and tokens == MESH_ORACLE["tokens"]
            and streamed["streams"] == MESH_ORACLE["streams"]
            and used == [0, 1] and any(h != "L0" for h in homes)):
        fails.append(f"serve: stacks {stack_home}, tokens "
                     f"{'equal' if tokens == MESH_ORACLE['tokens'] else 'DIFFER'}"
                     f", streams {'equal' if streamed['streams'] == MESH_ORACLE['streams'] else 'DIFFER'}"
                     f", replicas {used}, their stacks on {homes}")
    if world != 2 or not reaped:
        fails.append(f"gloo world {world} (want the 2 ranks), reaped "
                     f"{reaped}")
    print(f"session up in {up_s:.1f} s (2 ranks, 1 task locality); drill "
          f"{drill_s:.1f} s: raised {raised}; losses "
          f"{' '.join(f'{x:.6f}' for x in first.losses)} then "
          f"{' '.join(f'{x:.6f}' for x in again.losses)}; gnorms "
          f"{' '.join(f'{x:.6f}' for x in first.grad_norms)}; the mesh "
          f"phase's first {k} bit for bit: {same_first}; step times "
          f"{' '.join(f'{x:.1f}' for x in first.step_ms())} then "
          f"{' '.join(f'{x:.1f}' for x in again.step_ms())} ms; locality "
          f"{first.rank} joined in {first.join_s:.2f} s; dispatched "
          f"{built}, stolen {dstats['stolen_tasks']}, respawned "
          f"{dstats['respawned']}; step-{S21_EVERY} ownership "
          f"{manifest['ownership']}, ckpt-leaf-wire "
          f"{dstats['ckpt_leaf_wire_bytes']} B; gloo world {world}")
    print(f"serve and serve_stream in {serve_s:.1f} s: stacks {stack_home}; "
          f"tokens {'equal' if tokens == MESH_ORACLE['tokens'] else 'DIFFER'}"
          f"; streams "
          f"{'equal' if streamed['streams'] == MESH_ORACLE['streams'] else 'DIFFER'}"
          f" (replicas {used}, their stacks on {homes}); K1 "
          f"{counts['s21_serve_L0']}"
          f"; every process reaped {reaped}")
    readings = {"up_s": up_s, "drill_s": drill_s, "serve_s": serve_s,
                "losses": first.losses, "resumed": again.losses,
                "grad_norms": first.grad_norms,
                "step_ms": first.step_ms(), "join_s": first.join_s,
                "dispatched": built, "stolen": dstats["stolen_tasks"],
                "ownership": manifest["ownership"],
                "ckpt_leaf_wire_bytes": dstats["ckpt_leaf_wire_bytes"]}
    if fails:
        raise AssertionError("(s) mesh beside localities: "
                             + "; ".join(fails))
    return counts, readings, again.losses


def spmd_mesh(s_resumed: list) -> tuple[dict, dict]:
    """(t): SPMD mode with mesh axes (ROADMAP item 14b part 6):
    ``Plan(spmd=True, localities=2, data=2)`` with phylanx on the mesh
    phase's plan, four processes (two localities, each a gloo world of
    its mesh's two ranks), the sanitizer armed (``PHYRAX_SANITIZE=1``,
    inherited by every process): ``S21_SPMD_STEPS`` steps, each locality
    writing its segments at the last, gathered over its own mesh.
    Checks: the losses and norms the mesh phase's phylanx run's bit for
    bit; ownership ``{"0": [0], "1": [1]}``, ``ckpt_leaf_wire_bytes`` 0,
    every leaf's segments ``checkpoint.spmd.segments``' layout for 2
    processes; every process's K1 as the steps give; ``Session.lint()`` ``[]`` and
    no sanitizer diagnostic anywhere; no ``torch.distributed`` world left;
    then a one-process resume to ``S21_STEPS``, two steps (the second's
    loss reads the restored optimizer state): their losses within
    ``S21_RESUME_RTOL`` of (s)'s resumed steps at data=2.  Returns the
    counts and the readings."""
    base, stream = MESH_ORACLE["plan"], MESH_ORACLE["stream"]
    plan = dataclasses.replace(base, data=2, localities=2, spmd=True,
                               strategy="phylanx")
    cfg = plan.config()
    phase(f"(t) SPMD mode with a data axis: {cfg.name}, {cfg.n_layers} "
          f"layers, two localities of a data=2 mesh (four processes), each "
          f"writing its segments, resumed at one process")
    kw = dict(log_every=1, verbose=False)
    counts: dict = {}
    fails: list = []
    root = tempfile.mkdtemp()
    d = f"{root}/t21"
    n = S21_SPMD_STEPS
    os.environ["PHYRAX_SANITIZE"] = "1"
    sanitize.get().clear()
    try:
        t0 = time.perf_counter()
        with plan.compile() as s:
            up_s = time.perf_counter() - t0
            clock = StepClock()
            torch.cuda.synchronize()
            _zero_counts()
            t1 = time.perf_counter()
            out = s.train(stream, steps=n, ckpt_every=n, ckpt_dir=d,
                          hooks=clock, **kw)
            run_s = time.perf_counter() - t1
            counts["t21_L0"] = _counts()
            findings = [str(f) for f in s.lint()]
            pids = [pr.pid for g in (s.distributed, s.ranks)
                    for pr in g.group.procs.values()]
        diags = [str(x) for x in sanitize.get().diagnostics()]
    finally:
        os.environ.pop("PHYRAX_SANITIZE", None)
    world_left = torch.distributed.is_initialized()
    reaped = _reaped(pids)
    counts["t21_L1"] = out["localities"][1]["launches"]
    for r, m in out["ranks"].items():
        counts[f"t21_R{r}"] = m["launches"]
    want = train_launches(cfg, n, 1, 0)
    for name, c in counts.items():
        if c != want:
            fails.append(f"{name} launches {c} (want {want})")
    remote_diags = [x for m in out["localities"].values()
                    for x in (m.get("diagnostics") or [])]
    manifest = ckfmt.load_manifest(f"{d}/step_{n:08d}")
    dstats = out["runtime_stats"]["distributed"]
    bad_layout, split = [], 0
    by_leaf: dict = {}
    for sh in manifest["shards"]:
        for leaf in sh["leaves"]:
            by_leaf.setdefault(leaf["index"], {})[sh["locality"]] = leaf
    for i, leaves in sorted(by_leaf.items()):
        one = next(iter(leaves.values()))
        shape = one.get("global_shape", one["shape"])
        split += len(leaves) == 2
        for r in (0, 1):
            seg = ckspmd.segments(shape, 2, r)
            got = leaves.get(r)
            if (got is None) != (not seg) or (
                    got is not None and got.get("slice") != seg[0]):
                bad_layout.append((i, r))
    torch.cuda.synchronize()
    _zero_counts()
    with dataclasses.replace(base, strategy="phylanx").compile() as s:
        resumed = s.train(stream, steps=S21_STEPS, ckpt_every=S21_STEPS,
                          ckpt_dir=d, resume=True, **kw)
    counts["t21_resume"] = _counts()
    shutil.rmtree(root, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(resumed["losses"], s_resumed))
    same = (out["losses"] == MESH_ORACLE["losses"][:n]
            and clock.grad_norms == MESH_ORACLE["grad_norms"][:n])
    if not same:
        fails.append(f"losses {out['losses']} / {clock.grad_norms} against "
                     f"{MESH_ORACLE['losses']} / {MESH_ORACLE['grad_norms']}")
    if manifest["ownership"] != {"0": [0], "1": [1]} or bad_layout \
            or not split or dstats["ckpt_leaf_wire_bytes"] != 0:
        fails.append(f"ownership {manifest['ownership']}, layout "
                     f"{bad_layout[:4]}, split {split}, ckpt-leaf-wire "
                     f"{dstats['ckpt_leaf_wire_bytes']}")
    if findings or diags or remote_diags or world_left or not reaped:
        fails.append(f"lint {findings}, diagnostics {diags} / "
                     f"{remote_diags}, world left {world_left}, reaped "
                     f"{reaped}")
    if rel > S21_RESUME_RTOL or len(resumed["losses"]) != len(s_resumed) \
            or len(s_resumed) != S21_STEPS - n:
        fails.append(f"resumed losses {resumed['losses']} against (s)'s "
                     f"{s_resumed} (rel {rel:.3g})")
    nbytes = {sh["locality"]: sh["nbytes"] for sh in manifest["shards"]}
    print(f"session up in {up_s:.1f} s (4 processes: 2 localities x a "
          f"data=2 mesh); {n} steps in {run_s:.1f} s, step times "
          f"{' '.join(f'{x:.1f}' for x in clock.step_ms())} ms; losses "
          f"{' '.join(f'{x:.6f}' for x in out['losses'])}, gnorms "
          f"{' '.join(f'{x:.6f}' for x in clock.grad_norms)} (the mesh "
          f"phase's bit for bit: {same}); ownership {manifest['ownership']}"
          f", bytes by locality {nbytes}, {split} of {len(by_leaf)} leaves "
          f"split, layout {'ok' if not bad_layout else bad_layout[:4]}, "
          f"ckpt-leaf-wire {dstats['ckpt_leaf_wire_bytes']} B; lint "
          f"{findings}, "
          f"diagnostics {diags + remote_diags}; world left {world_left}; "
          f"resumed at one process: steps {n + 1}-{S21_STEPS} losses "
          f"{' '.join(f'{x:.6f}' for x in resumed['losses'])} against "
          f"(s)'s {' '.join(f'{x:.6f}' for x in s_resumed)} at "
          f"data=2 (rel {rel:.3g}); K1 {counts['t21_L0']}")
    readings = {"up_s": up_s, "run_s": run_s, "step_ms": clock.step_ms(),
                "losses": out["losses"], "grad_norms": clock.grad_norms,
                "ownership": manifest["ownership"], "bytes": nbytes,
                "split_leaves": split, "resumed": resumed["losses"],
                "resume_rel": rel}
    if fails:
        raise AssertionError("(t) SPMD mode with a data axis: "
                             + "; ".join(fails))
    return counts, readings


def slice21() -> dict:
    """(r), (s) and (t) after the mesh phase, whose readings they are held
    to: the readings of each, and every run's kernel counts under
    ``counts``."""
    counts: dict = {}
    r_counts, r = ddp_model_axis()
    counts.update(r_counts)
    s_counts, s, s_resumed = mesh_localities()
    counts.update(s_counts)
    t_counts, t = spmd_mesh(s_resumed)
    counts.update(t_counts)
    return {"counts": counts, "ddp_model_axis": r, "mesh_localities": s,
            "spmd_mesh": t}


def tp_warmup(spec: dict, endpoint=None, driver=None) -> dict:
    """A worker rank's cold start, taken while the driver runs an oracle:
    one step of tiny qwen3-4b on the card (the CUDA context, the
    libraries and the kernels' modules; no collective)."""
    cfg = get_config("qwen3-4b", tiny=True)
    step = steps.make_train_step(cfg, steps.Strategy())
    params, opt = step.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    batch = to_device(stream_for(cfg, batch=2, seq=64, seed=0).batch_at(0),
                      "cuda")
    step.fn(params, opt, batch)
    torch.cuda.synchronize()
    return {}


def tp_train(step, params, opt, stream, n_steps: int) -> dict:
    """``n_steps`` of ``step`` from ``params``, each ended by a
    synchronize, every kernel count and the wire counters set to 0 just
    before the steps and read just after: losses, gradient norms, step
    host walls, launches, wire, the device's peak, and after every step
    ``param_bit_sums`` of the leaves no rule splits over the model
    axis."""
    mask = pytree.tree_leaves(step.split_mask) if step.split_mask \
        is not None else [False] * len(pytree.tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    collectives.reset_stats()
    losses, gnorms, wall, sums = [], [], [], []
    for it in range(n_steps):
        batch = to_device(stream.batch_at(it), "cuda")
        t0 = time.perf_counter()
        m, params, opt = step.fn(params, opt, batch)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        sums.append(param_bit_sums([p for p, s in zip(
            pytree.tree_leaves(params), mask) if not s]))
    return {"losses": losses, "grad_norms": gnorms, "step_ms": wall,
            "launches": _counts(), "wire": collectives.stats(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "replicated_bit_sums": sums, "replicated": len(sums[0]),
            "leaves": len(mask)}


def tp_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """One rank's share of the model-axis phase (module level: every
    worker rank runs it too): on the mesh of ``spec["plan"]``, phylanx
    for ``spec["steps"]`` steps from the seed's init (``tp_train``); then,
    where ``spec["logits"]`` holds the oracle's prompts and tokens, the
    prefill and decode steps at that depth, teacher-forced, each step's
    whole last-position logits gathered (rank 0 keeps them).  A
    ``spec["strategy"]`` trains with that strategy instead, and a
    ``spec["opt"]`` with those ``OptConfig`` fields, a ``spec["wq_scale"]``
    from the init with every attention's ``wq`` scaled (``scale_wq``), a
    ``spec["sp"]`` with sequence parallelism (``sp``: the residual's
    split by the tokens, ``steps.residual_seq``, and for an encoder by
    its frames); ``vocab_rows`` is this rank's rows of the embedding."""
    plan, stream = spec["plan"], spec["stream"]
    mesh = make_local_mesh(data=plan.data, model=plan.model, pod=plan.pod)
    cfg = plan.config()
    step = steps.make_train_step(cfg, steps.Strategy(
        name=spec.get("strategy", "phylanx"),
        opt=optimizers.OptConfig(**spec.get("opt", {})),
        sequence_parallel=spec.get("sp", False)), plan=plan, mesh=mesh)
    params, opt = step.init(
        torch.Generator(device="cuda").manual_seed(plan.seed), "cuda")
    scale_wq(params, spec.get("wq_scale"))
    ax = ModelAxis(mesh, step.rules)
    sp = {"seq": steps.residual_seq(cfg, mesh, step.rules,
                                    stream.batch_at(0)),
          "enc": ax.split("seq", cfg.enc_frames)
          if cfg.family == "encdec" else None}
    out = {"train": tp_train(step, params, opt, stream, spec["steps"]),
           "vocab_rows": int(params["embed"]["tok"].shape[0]), "sp": sp}
    del step, params, opt
    torch.cuda.empty_cache()
    lg = spec.get("logits")
    if lg is None:
        return out
    prompts, toks = lg["prompts"], lg["tokens"]
    shape = {"seq_len": prompts.shape[1] + len(toks),
             "global_batch": prompts.shape[0]}
    pre = steps.make_prefill_step(cfg, shape, mesh=mesh)
    dec = steps.make_decode_step(cfg, shape, mesh=mesh)
    params = pre.init(torch.Generator(device="cuda").manual_seed(plan.seed),
                      "cuda")
    keep = mesh.rank == 0 and mesh.model_rank == 0
    got = []
    torch.cuda.synchronize()
    _zero_counts()
    collectives.reset_stats()
    with torch.no_grad():
        logits, cache = pre.fn(params, {"tokens": prompts.cuda()})
        got.append(pre.gather_logits(logits).float().cpu())
        for t, tok in enumerate(toks):
            logits, cache = dec.fn(params, cache, {"tokens": tok.cuda()[:, None]},
                                   prompts.shape[1] + t)
            got.append(dec.gather_logits(logits).float().cpu())
    torch.cuda.synchronize()
    out["logits"] = {"logits": got if keep else None, "launches": _counts(),
                     "wire": collectives.stats()}
    del pre, dec, params, cache
    torch.cuda.empty_cache()
    return out


def scale_wq(params, factor) -> None:
    """Every attention's ``wq`` (a dict holding ``wq`` and ``wo``) of
    ``params`` times ``factor``, in place (None: unchanged)."""
    if factor is None:
        return
    if isinstance(params, dict):
        if "wq" in params and "wo" in params:
            with torch.no_grad():
                params["wq"].mul_(factor)
        for v in params.values():
            scale_wq(v, factor)
    elif isinstance(params, list):
        for v in params:
            scale_wq(v, factor)


def tp_oracle_train(plan_kw: dict, stream, n_steps: int,
                    strategy: str = "phylanx", opt: dict = None,
                    wq_scale=None) -> dict:
    """The one-process run of ``plan_kw`` (``strategy`` at one rank: the
    plain update; ``opt`` the ``OptConfig`` fields, default adamw) from the
    seed's init (every attention's ``wq`` times ``wq_scale``, if given):
    the model axis's oracle."""
    plan = Plan(**plan_kw, device="cuda")
    step = steps.make_train_step(plan.config(), steps.Strategy(
        name=strategy, opt=optimizers.OptConfig(**(opt or {}))), plan=plan)
    params, opt = step.init(
        torch.Generator(device="cuda").manual_seed(plan.seed), "cuda")
    scale_wq(params, wq_scale)
    out = tp_train(step, params, opt, stream, n_steps)
    del step, params, opt
    torch.cuda.empty_cache()
    return out


def tp_oracle_logits(plan_kw: dict, slots: int = SERVE["slots"]) -> dict:
    """The one-process prefill (``slots`` rows of SERVE's prompt length,
    seeded prompts) and ``TP_DECODE_STEPS`` greedy decode steps of
    ``plan_kw``: the prompts, the greedy tokens fed at each decode step
    and each step's last-position logits (float32, on the CPU)."""
    cfg = Plan(**plan_kw).config()
    prompt_len = SERVE["prompt_len"]
    shape = {"seq_len": prompt_len + TP_DECODE_STEPS, "global_batch": slots}
    pre = steps.make_prefill_step(cfg, shape)
    dec = steps.make_decode_step(cfg, shape)
    params = init_params(pre.specs,
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (slots, prompt_len)))
    want, toks = [], []
    with torch.no_grad():
        logits, cache = pre.fn(params, {"tokens": prompts.cuda()})
        want.append(logits.float().cpu())
        for t in range(TP_DECODE_STEPS):
            tok = logits.argmax(-1)
            toks.append(tok.cpu())
            logits, cache = dec.fn(params, cache, {"tokens": tok[:, None]},
                                   prompt_len + t)
            want.append(logits.float().cpu())
    del pre, dec, params, cache
    torch.cuda.empty_cache()
    return {"prompts": prompts, "tokens": toks, "logits": want}


def _tp_held(name: str, got: dict, want: dict, fails: list,
             norm_rtol: float = TP_NORM_RTOL, norm_steps=None) -> dict:
    """A mesh run's losses and gradient norms (of its first
    ``norm_steps``, default all) against the oracle's."""
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    le = rel(got["losses"], want["losses"])
    ge = rel(got["grad_norms"][:norm_steps], want["grad_norms"][:norm_steps])
    if le > TP_LOSS_RTOL or ge > norm_rtol:
        fails.append(f"{name}: losses {got['losses']} / gnorms "
                     f"{got['grad_norms']} against the oracle's "
                     f"{want['losses']} / {want['grad_norms']} (rel "
                     f"{le:.3g}, {ge:.3g})")
    return {"loss_rel_err": le, "grad_norm_rel_err": ge}


def _tp_launches(name: str, launches: dict, k1: int, k1_bwd: int,
                 fails: list) -> None:
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=k1, flash_attention_bwd=k1_bwd)
    if launches != want:
        fails.append(f"{name} launches {launches} (want {want})")


def _tp_wire(w: dict) -> str:
    m, d = w["axes"]["model"], w["axes"]["dp"]
    return (f"model axis {m['bytes']} B in {m['calls']} collectives, "
            f"{m['wire_s']:.3f} s in gloo, staging {m['staging_s']:.3f} s; "
            f"dp axis {d['bytes']} B in {d['calls']}, {d['wire_s']:.3f} s")


def _rel(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    want = want.detach().float()
    return float((got.detach().float() - want).abs().max()
                 / want.abs().max())


def _synced(fn):
    """(fn(), host ms), the call ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def tiled_rank(mesh) -> dict:
    """(h) ``TiledArray`` of a seeded ``TILED`` bf16 activation on this
    rank of a model=2 mesh: tiled by ``("batch", "seq", "embed")`` under
    ``default_rules(sequence_parallel=True)`` (each rank ``S/2`` rows), its
    ``seq`` halo of 1 against the whole array's neighbouring rows (zeros
    at the edges), ``retile(default_rules())`` and ``replicated()``
    against the whole array, bit for bit; each call's bytes on the wire
    and host wall."""
    x = torch.randn(TILED, generator=torch.Generator(device="cuda")
                    .manual_seed(0), device="cuda").to(torch.bfloat16)
    dims, fails, readings = ("batch", "seq", "embed"), [], {}

    def run(name, fn):
        collectives.reset_stats()
        out, ms = _synced(fn)
        readings[name] = {"ms": ms, "bytes": collectives.stats()["bytes"]}
        return out
    t = run("tile", lambda: TiledArray.tile(
        x, dims, mesh, default_rules(sequence_parallel=True)))
    n, r = mesh.model_size, mesh.model_rank
    rows = TILED[1] // n
    if t.tile_shape() != (TILED[0], rows, TILED[2]) or \
            t.global_shape != TILED or t.spec != (None, "model"):
        fails.append(f"tile: {t.tile_shape()} {t.spec}")
    halo = run("halo", lambda: t.with_halo("seq", 1))
    zero = torch.zeros_like(x[:, :1])
    lo = x[:, r * rows - 1:r * rows] if r > 0 else zero
    hi = x[:, (r + 1) * rows:(r + 1) * rows + 1] if r < n - 1 else zero
    if not torch.equal(halo, torch.cat(
            [lo, x[:, r * rows:(r + 1) * rows], hi], 1)):
        fails.append("with_halo differs from the whole array's rows")
    back = run("retile", lambda: t.retile(default_rules()))
    rep = run("replicated", lambda: t.replicated())
    for name, got in (("retile", back), ("replicated", rep)):
        if not torch.equal(got.data, x) or got.tile_shape() != TILED:
            fails.append(f"{name} differs from the whole array")
    return {"readings": readings, "fails": fails}


def gpipe_stage_params(cfg, stage: int):
    """Stage ``stage``'s ``GPIPE_LAYERS`` qwen3-4b decoder blocks as
    leaves ``[1, GPIPE_LAYERS, ...]`` (requiring grad) on the card: layer
    ``l`` drawn from seed ``l`` alone, so that a rank draws its own
    stage's layers and one process all of them."""
    specs = blocks.tblock_specs(cfg)
    layers = [init_params(specs, torch.Generator(device="cuda")
                          .manual_seed(layer), "cuda")
              for layer in range(stage * GPIPE_LAYERS,
                                 (stage + 1) * GPIPE_LAYERS)]
    flat = [pytree.tree_flatten(t)[0] for t in layers]
    stacked = [torch.stack(ts)[None].requires_grad_(True)
               for ts in zip(*flat)]
    return pytree.tree_unflatten(stacked, pytree.tree_flatten(layers[0])[1])


def gpipe_stage_fn(cfg):
    """A stage: its layers' ``tblock_apply`` in order."""
    def stage_fn(p, x):
        for i in range(p["ln_attn"]["w"].shape[0]):
            x = blocks.tblock_apply(
                x, pytree.tree_map(lambda t: t[i], p), cfg)[0]
        return x
    return stage_fn


def gpipe_micro(cfg) -> torch.Tensor:
    """(g)'s seeded input: ``[GPIPE_MICRO, GPIPE_MB, seq, d_model]`` in
    the compute dtype, the same on every rank."""
    return torch.randn((GPIPE_MICRO, GPIPE_MB, TRAIN["seq"], cfg.d_model),
                       generator=torch.Generator(device="cuda")
                       .manual_seed(1), device="cuda").to(cfg.c_dtype)


def gpipe_blocks_rank(cfg) -> dict:
    """(g) on this rank of a stage mesh of ``GPIPE_STAGES``: its stage's
    blocks only; a forward (no grad, timed), then a forward and backward
    of ``mean(y ** 2)`` (timed, every kernel count and the wire counters
    set to 0 just before and read just after); the gradients gathered
    over the stage group, and on stage 0 one process's 4 layers applied
    microbatch by microbatch as the oracle of the outputs and of every
    stage leaf's gradient."""
    mesh = make_mesh((GPIPE_STAGES,), ("stage",))
    s = mesh.stage_rank
    params = gpipe_stage_params(cfg, s)
    fn = pipeline.make_pipeline_fn(gpipe_stage_fn(cfg), mesh)
    x = gpipe_micro(cfg)
    with torch.no_grad():
        _, fwd_ms = _synced(lambda: fn(params, x))
    _zero_counts()
    collectives.reset_stats()

    def fwd_bwd():
        y = fn(params, x)
        y.float().square().mean().backward()
        return y.detach()
    y, fb_ms = _synced(fwd_bwd)
    launches, wire = _counts(), collectives.stats()["axes"]["stage"]
    leaves = pytree.tree_leaves(params)
    grads = [collectives.all_gather(p.grad, mesh, mesh_axis="stage")
             for p in leaves]
    out = {"fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms, "launches": launches,
           "wire": wire, "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, leaves
    if s != 0:
        return out
    oracle = [gpipe_stage_params(cfg, st) for st in range(GPIPE_STAGES)]
    stage_fn = gpipe_stage_fn(cfg)
    ys = []
    for m in range(GPIPE_MICRO):
        h = x[m]
        for p in oracle:
            h = stage_fn(pytree.tree_map(lambda t: t[0], p), h)
        ys.append(h)
    want = torch.stack(ys)
    want.float().square().mean().backward()
    per_stage = [pytree.tree_leaves(p) for p in oracle]
    grad_rel = [_rel(g[st:st + 1], per_stage[st][i].grad)
                for i, g in enumerate(grads)
                for st in range(GPIPE_STAGES)]
    out.update(out_rel_err=_rel(y, want), bit_identical=bool(
        torch.equal(y, want.detach())), grad_rel_err=max(grad_rel),
        leaves=len(grads) * GPIPE_STAGES)
    return out


def tp_part2_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """The model=2 session's part 2 (module level: the worker runs it
    too): (e) ``spec["steps"]`` phylanx steps with sequence parallelism
    (``tp_train``; the residual's split asserted), (h) ``tiled_rank``,
    then (g) ``gpipe_blocks_rank`` on a stage mesh of the same ranks."""
    plan, stream = spec["plan"], spec["stream"]
    mesh = make_local_mesh(data=plan.data, model=plan.model, pod=plan.pod)
    cfg = plan.config()
    step = steps.make_train_step(cfg, steps.Strategy(
        name="phylanx", sequence_parallel=True), plan=plan, mesh=mesh)
    params, opt = step.init(
        torch.Generator(device="cuda").manual_seed(plan.seed), "cuda")
    seq = steps.residual_seq(cfg, mesh, step.rules, stream.batch_at(0))
    out = {"train": dict(tp_train(step, params, opt, stream, spec["steps"]),
                         seq=seq)}
    del step, params, opt
    torch.cuda.empty_cache()
    out["tiled"] = tiled_rank(mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["gpipe"] = gpipe_blocks_rank(cfg)
    torch.cuda.empty_cache()
    return out


def _ex_stage(w, x):
    return torch.tanh(x @ w)


def _ex_sequential(ws, x):
    """The stages one after the other, microbatch by microbatch."""
    outs = []
    for h in x:
        for s in range(ws.shape[0]):
            h = torch.tanh(h @ ws[s])
        outs.append(h)
    return torch.stack(outs)


def gpipe_example_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """(f) ``examples/pipeline_parallel.py``'s program on a stage mesh of
    the session's ranks (module level: every worker runs it too): each
    rank its own ``[1, d, d]`` slice of the seeded weights; the forward at
    each microbatch count (bubble, host ms a microbatch over ``timed``
    calls, the outputs against the sequential loop), then ``steps`` SGD
    steps of ``mean((y - roll(x)) ** 2)``, each step's outputs, loss and
    gathered gradients against the sequential loop at the same
    weights."""
    ex = GPIPE_EX
    S, d = ex["stages"], ex["d"]
    mesh = make_mesh((S,), ("stage",))
    s = mesh.stage_rank
    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)
    ws = torch.randn((S, d, d), generator=gen(0), device="cuda") / d ** 0.5
    w = ws[s:s + 1].clone()
    fn = pipeline.make_pipeline_fn(_ex_stage, mesh)
    sweep, errs = {}, {"out": 0.0, "grad": 0.0, "loss": 0.0}
    for m in ex["micro"]:
        x = torch.randn((m, ex["mb"], d), generator=gen(1), device="cuda")
        with torch.no_grad():
            y = fn(w, x)
            errs["out"] = max(errs["out"], _rel(y, _ex_sequential(ws, x)))
            _, ms = _synced(lambda: [fn(w, x) for _ in range(ex["timed"])])
        sweep[m] = {"bubble": pipeline.bubble_fraction(S, m),
                    "ms_per_micro": ms / ex["timed"] / m}
    x = torch.randn((ex["train_micro"], ex["mb"], d), generator=gen(2),
                    device="cuda")
    target = torch.roll(x, 1, dims=-1)
    w = w.requires_grad_(True)
    losses, t0 = [], time.perf_counter()
    for _ in range(ex["steps"]):
        y = fn(w, x)
        loss = ((y - target) ** 2).mean()
        loss.backward()
        whole = collectives.all_gather(w.detach(), mesh, mesh_axis="stage")
        grad = collectives.all_gather(w.grad, mesh, mesh_axis="stage")
        ref_w = whole.clone().requires_grad_(True)
        ref_y = _ex_sequential(ref_w, x)
        ref_loss = ((ref_y - target) ** 2).mean()
        ref_loss.backward()
        errs["out"] = max(errs["out"], _rel(y.detach(), ref_y.detach()))
        errs["grad"] = max(errs["grad"], _rel(grad, ref_w.grad))
        loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
        errs["loss"] = max(errs["loss"], abs(loss - ref_loss) / ref_loss)
        losses.append(loss)
        with torch.no_grad():
            w -= ex["lr"] * w.grad
        w.grad = None
    torch.cuda.synchronize()
    return {"sweep": sweep, "losses": losses, "errs": errs,
            "train_s": time.perf_counter() - t0}


def _tp_part2(counts: dict, res: dict, oracle: dict, fails: list) -> dict:
    """(e), (h) and (g)'s checks on both ranks' results and their
    printed readings."""
    sp, tiled, gp = {}, {}, res[0]["gpipe"]
    for r in (0, 1):
        rec = res[r]["train"]
        counts[f"tp_sp_L{r}"] = rec["launches"]
        _tp_launches(f"sequence-parallel train rank {r}", rec["launches"],
                     2 * TP_LAYERS * TP_STEPS, TP_LAYERS * TP_STEPS, fails)
        sp[r] = _tp_held(f"sequence-parallel train rank {r}", rec, oracle,
                         fails)
        if rec["seq"] != TRAIN["seq"]:
            fails.append(f"sequence-parallel rank {r}: the residual did not "
                         f"split ({rec['seq']})")
        fails.extend(res[r]["tiled"]["fails"])
        tiled[r] = res[r]["tiled"]["readings"]
        g = res[r]["gpipe"]
        counts[f"gpipe_L{r}"] = g["launches"]
        _tp_launches(f"GPipe stage {r}", g["launches"],
                     GPIPE_MICRO * GPIPE_LAYERS, GPIPE_MICRO * GPIPE_LAYERS,
                     fails)
    same = res[0]["train"]["replicated_bit_sums"] == \
        res[1]["train"]["replicated_bit_sums"]
    if not same or res[0]["train"]["losses"] != res[1]["train"]["losses"]:
        fails.append("sequence-parallel train: the ranks' unsplit leaves or "
                     "losses differ")
    if gp["out_rel_err"] > GPIPE_RTOL or gp["grad_rel_err"] > GPIPE_RTOL:
        fails.append(f"GPipe blocks: outputs {gp['out_rel_err']:.3g}, "
                     f"gradients {gp['grad_rel_err']:.3g} from one process")
    for r in (0, 1):
        rec = res[r]["train"]
        print(f"(e) sequence-parallel train rank {r}: losses "
              f"{' '.join(f'{x:.6f}' for x in rec['losses'])}, gnorms "
              f"{' '.join(f'{x:.6f}' for x in rec['grad_norms'])} (rel err "
              f"{sp[r]['loss_rel_err']:.3g}, {sp[r]['grad_norm_rel_err']:.3g}"
              f"); steps {' '.join(f'{x:.1f}' for x in rec['step_ms'])} ms; "
              f"{_tp_wire(rec['wire'])}; peak {rec['peak_bytes'] / 1e9:.3f} "
              f"GB; K1 {rec['launches']['flash_attention']} / "
              f"{rec['launches']['flash_attention_bwd']}")
    print(f"(e) the {res[0]['train']['replicated']} unsplit leaves "
          f"bit-identical on both ranks after every step: {same}")
    for r in (0, 1):
        print(f"(h) TiledArray {TILED} bf16, rank {r}: " + "; ".join(
            f"{k} {v['ms']:.2f} ms, {v['bytes']} B" for k, v in
            tiled[r].items()))
    bubble = pipeline.bubble_fraction(GPIPE_STAGES, GPIPE_MICRO)
    for r in (0, 1):
        g = res[r]["gpipe"]
        print(f"(g) GPipe stage {r} of {GPIPE_STAGES} ({GPIPE_LAYERS} "
              f"qwen3-4b blocks, {GPIPE_MICRO} x {GPIPE_MB} x {TRAIN['seq']}"
              f", bubble {bubble:.3f}): forward {g['fwd_ms']:.1f} ms, "
              f"forward + backward {g['fwd_bwd_ms']:.1f} ms; stage axis {g['wire']['bytes']} B "
              f"in {g['wire']['calls']} collectives, {g['wire']['wire_s']:.3f}"
              f" s in gloo; peak {g['peak_bytes'] / 1e9:.3f} GB; K1 "
              f"{g['launches']['flash_attention']} / "
              f"{g['launches']['flash_attention_bwd']}")
    print(f"(g) against one process: outputs rel err {gp['out_rel_err']:.3g}"
          f" (bit-identical {gp['bit_identical']}), gradients max rel err "
          f"{gp['grad_rel_err']:.3g} over {gp['leaves']} leaves (tolerance "
          f"{GPIPE_RTOL:g})")
    return {"sp": {r: dict(sp[r], **{k: res[r]["train"][k] for k in (
        "losses", "grad_norms", "step_ms", "wire", "peak_bytes")})
        for r in (0, 1)}, "tiled": tiled,
        "gpipe": {r: {k: v for k, v in res[r]["gpipe"].items()
                      if k != "launches"} for r in (0, 1)}}


def _gpipe_example(ex: dict, fails: list) -> dict:
    """(f)'s checks on the four ranks' results, and its readings."""
    for r, rec in ex.items():
        e = rec["errs"]
        if e["out"] > GPIPE_EX_OUT_RTOL or e["grad"] > GPIPE_EX_GRAD_RTOL \
                or e["loss"] > GPIPE_EX_OUT_RTOL:
            fails.append(f"(f) GPipe example rank {r}: errors {e}")
        if rec["losses"] != ex[0]["losses"]:
            fails.append(f"(f) rank {r}'s losses differ from rank 0's")
    rec = ex[0]
    if not rec["losses"][-1] < rec["losses"][0]:
        fails.append(f"(f) the loss did not fall: {rec['losses']}")
    for m, v in rec["sweep"].items():
        print(f"(f) GPipe example, {GPIPE_EX['stages']} stages, {m} "
              f"microbatches of {GPIPE_EX['mb']}: bubble {v['bubble']:.2%},"
              f" {v['ms_per_micro']:.2f} ms a microbatch (rank 0's host)")
    print(f"(f) {GPIPE_EX['steps']} steps: losses "
          f"{' '.join(f'{x:.5f}' for x in rec['losses'])} in "
          f"{rec['train_s']:.2f} s; against the sequential loop: outputs "
          f"{max(x['errs']['out'] for x in ex.values()):.3g}, gradients "
          f"{max(x['errs']['grad'] for x in ex.values()):.3g}, losses "
          f"{max(x['errs']['loss'] for x in ex.values()):.3g}")
    return {r: {k: v for k, v in x.items()} for r, x in ex.items()}


def stream_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """(j) on this rank of a data=2 mesh (module level: the worker runs it
    too): a single stream (batch 1) whose decode cache is tiled by
    sequence over the dp group.  At ``spec["plan"]``'s depth, the prefill
    and the decode steps teacher-forced with the oracle's tokens, each
    step's logits kept (rank 0) and this rank's cache positions; then one
    request of ``spec["full"]`` (all the layers) through the wave loop
    (``frontend.mesh.serve_loop``)."""
    plan, lg = spec["plan"], spec["logits"]
    mesh = make_local_mesh(data=plan.data, model=plan.model, pod=plan.pod)
    cfg = plan.config()
    prompts, toks = lg["prompts"], lg["tokens"]
    shape = {"seq_len": prompts.shape[1] + len(toks), "global_batch": 1}
    pre = steps.make_prefill_step(cfg, shape, mesh=mesh)
    dec = steps.make_decode_step(cfg, shape, mesh=mesh)
    params = pre.init(torch.Generator(device="cuda").manual_seed(plan.seed),
                      "cuda")
    got = []
    torch.cuda.synchronize()
    _zero_counts()
    collectives.reset_stats()
    with torch.no_grad():
        logits, cache = pre.fn(params, {"tokens": prompts.cuda()})
        got.append(pre.gather_logits(logits).float().cpu())
        positions = cache[0]["k"].shape[1]
        for t, tok in enumerate(toks):
            logits, cache = dec.fn(params, cache,
                                   {"tokens": tok.cuda()[:, None]},
                                   prompts.shape[1] + t)
            got.append(dec.gather_logits(logits).float().cpu())
    torch.cuda.synchronize()
    out = {"logits": got if mesh.rank == 0 else None,
           "positions": positions, "launches": _counts(),
           "wire": collectives.stats()}
    del pre, dec, params, cache
    torch.cuda.empty_cache()
    full = mesh_serve.serve_loop(dict(spec["full"], requests=1, slots=1))
    out["full"] = {k: full[k] for k in (
        "launches", "wire", "prefill_s", "decode_s", "cache_shapes",
        "generated", "tokens_per_s")}
    torch.cuda.empty_cache()
    return out


def gateway_run(runtime, prompts, arrivals, kw: dict):
    """Rank 0's gateway run for ``frontend.mesh.rank_serve_stream`` (the
    driver of a mesh plan other than the session's): ``prompts`` arriving
    at ``arrivals`` rounds through a ``RequestQueue``, every device body
    through the lockstep."""
    def run(pre, dec, params, lockstep):
        gw = gateway.Gateway(runtime, prefill_step=pre, decode_step=dec,
                             params=params, device="cuda",
                             lockstep=lockstep, **kw)
        q = RequestQueue()
        for p, r in zip(prompts, arrivals):
            q.submit(p, at_round=r)
        q.close()
        t0 = time.perf_counter()
        out = gw.run(q)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["serve"] = dict(runtime.stats().serve)
        return out
    return run


def gateway_oracle_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """A plain greedy loop on this rank of the gateway's mesh (module
    level: every rank runs it): for each ``(prompt, slot)`` of
    ``spec["oracle"]``, the batch-1 prefill on this rank's blocks, its
    state written into row ``slot`` of a zero decode cache where that row
    is this rank's, then the ``slots``-wide decode step on this rank's
    rows, the other rows' tokens zero, per-row positions, the greedy
    tokens gathered over the dp group.  Returns the token streams."""
    plan = spec["plan"]
    mesh = make_local_mesh(data=plan.data, model=plan.model, pod=plan.pod)
    P, G, slots = spec["prompt_len"], spec["gen_len"], spec["slots"]
    pre, dec = mesh_serve.stream_steps(plan.config(), mesh, P, G, slots)
    params = pre.init(torch.Generator(device="cuda").manual_seed(plan.seed),
                      "cuda")
    rows = dec.rows
    streams = []
    with torch.no_grad():
        for prompt, slot in spec["oracle"]:
            toks = torch.as_tensor(np.asarray(prompt, np.int64),
                                   device="cuda")[None]
            lg, state = pre.fn(params, {"tokens": toks})
            carry = init_params(dec.cache_specs, None, "cuda")
            if rows.start <= slot < rows.stop:
                for c, st, sp in zip(
                        pytree.tree_leaves(carry), pytree.tree_leaves(state),
                        pytree.tree_leaves(dec.cache_specs,
                                           is_leaf=is_spec)):
                    ax = sp.dims.index("batch")
                    c.select(ax, slot - rows.start).copy_(st.select(ax, 0))
            stream = [int(pre.greedy(lg)[0])]
            tok = torch.zeros((slots, 1), dtype=torch.int64, device="cuda")
            for t in range(G):
                tok[slot, 0] = stream[-1]
                pos = torch.full((slots,), P, dtype=torch.int64,
                                 device="cuda")
                pos[slot] = P + t
                lg, carry = dec.fn(params, carry, {"tokens": tok[rows]},
                                   pos[rows])
                nxt = dec.gather_rows(dec.greedy(lg))
                stream.append(int(nxt[slot]))
            streams.append(stream)
    del params, pre, dec
    torch.cuda.empty_cache()
    return {"streams": streams}


def _mesh_gateway_checks(name: str, res: dict, others: dict, layers,
                         whole_bytes: int, share: int, fails: list) -> None:
    """(l)'s checks of one gateway run: completion, every refill a page
    hit, no recompute, every page reclaimed on every rank, K1 once a
    layer and request on every rank (``layers``: a count, or a config
    whose ``prefill_launches`` each request makes), each rank's parked
    bytes."""
    n = len(GATEWAY_ARRIVALS)
    serve, cache = res["serve"], res["cache"]
    if not (res["completed"] == n and serve["refills"] == serve["page_hits"]
            and serve.get("prefill_recompute", 0) == 0
            and cache["pages_live"] == 0):
        fails.append(f"{name}: completed {res['completed']}, serve {serve}, "
                     f"cache {cache}")
    ranks = {0: res, **others}
    for r, rec in ranks.items():
        want = dict.fromkeys(rec["launches"], 0)
        if isinstance(layers, int):
            want["flash_attention"] = n * layers
        else:
            want.update({k: n * v for k, v in
                         prefill_launches(layers).items()})
        if rec["launches"] != want:
            fails.append(f"{name} rank {r}: launches {rec['launches']} "
                         f"(want {want})")
        if rec["request_bytes"] != whole_bytes // share:
            fails.append(f"{name} rank {r}: {rec['request_bytes']} B parked "
                         f"a request, want {whole_bytes} / {share}")
        if r and (rec["cache"]["pages_live"] or rec["cache"]["cache_entries"]
                  or rec["cache"]["page_allocs"]
                  != rec["cache"]["page_frees"]):
            fails.append(f"{name} rank {r}: pages left {rec['cache']}")


def _b1_cache_bytes(cfg, gen_len: int = SERVE["gen_len"]) -> int:
    """One request's whole batch-1 decode state (one process's)."""
    pre = steps.make_prefill_step(cfg, {
        "seq_len": SERVE["prompt_len"] + gen_len, "global_batch": 1})
    return sum(sp.size * sp.dtype.itemsize for sp in pytree.tree_leaves(
        pre.cache_specs, is_leaf=is_spec))


def _mesh_serve_line(name: str, rec: dict) -> str:
    pre = " ".join(f"{1e3 * x:.1f}" for x in rec["prefill_s"])
    dec = sorted(1e3 * x for x in rec["decode_s"])
    return (f"{name}: {rec['tokens_per_s']:.1f} tok/s, prefill {pre} ms, "
            f"decode step median {dec[len(dec) // 2]:.1f} ms (min "
            f"{dec[0]:.1f}, max {dec[-1]:.1f}); {_tp_wire(rec['wire'])}; K1 "
            f"{rec['launches']['flash_attention']}, K2 "
            f"{rec['launches']['mamba2_chunk_scan']}")


def mesh_serving(session, counts: dict, fails: list) -> dict:
    """(i), (j), (l) and (m) in the two-rank session (ROADMAP item 14b,
    part 3): each through ``Session.run_ranks`` with a plan of its own
    (a session's own ``serve_stream`` at model=2 runs in
    ``model_axis_families``).  Returns the readings."""
    cfg = get_config("qwen3-4b")
    full = cfg.n_layers
    out: dict = {}
    print(f"CUT the gateway at model=2 to {MESH_GATEWAY_M2_LAYERS}, at data=2 "
          f"to {MESH_GATEWAY_LAYERS}, the single request to "
          f"{MESH_STREAM_LAYERS}, zamba2-2.7b to "
          f"{STREAM_LAYERS['zamba2-2.7b']} and data=2, model=2 to "
          f"{TP_LAYERS} layers: the phase's time")
    # (i) the wave loop at data=2
    phase(f"serving over a mesh: (i) the wave loop at data=2, {cfg.name} "
          f"at all {full} layers, one wave of {MESH_SERVE['slots']}")
    t0 = time.perf_counter()
    d2 = Plan(arch=cfg.name, tiny=False, data=2, device="cuda")
    res = session.run_ranks(mesh_serve.rank_serve, dict(
        MESH_SERVE, plan=d2, prompts=None, params=None))
    out["i_s"] = time.perf_counter() - t0
    gen = res[0]["generated"][0]
    ref = SERVE_TOKENS.get(cfg.name)
    same = None if ref is None else int((gen == ref).sum())
    for r in (0, 1):
        rec = res[r]
        counts[f"mesh_serve_i_L{r}"] = rec["launches"]
        _tp_launches(f"(i) rank {r}", rec["launches"], full, 0, fails)
        if rec["wire"]["axes"]["model"]["calls"]:
            fails.append(f"(i) rank {r}: the model axis made calls")
        if not torch.equal(rec["generated"][0], gen):
            fails.append(f"(i) rank {r}'s gathered tokens differ")
    if gen.shape != (MESH_SERVE["slots"], MESH_SERVE["gen_len"] + 1) or \
            int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab:
        fails.append(f"(i) tokens {tuple(gen.shape)} out of range")
    for r in (0, 1):
        print(_mesh_serve_line(f"(i) data=2 rank {r}", res[r]))
    print(f"(i) tokens equal to the one-process serve phase's: {same} of "
          f"{gen.numel()}")
    out["i"] = {r: {k: res[r][k] for k in ("tokens_per_s", "prefill_s",
                                           "decode_s", "wire")}
                for r in (0, 1)}
    out["i"]["same_tokens"] = same
    torch.cuda.empty_cache()

    # (j) the single stream, its cache tiled over data
    one = MESH_STREAM_LAYERS
    phase(f"serving over a mesh: (j) a single stream at data=2, the cache "
          f"tiled by sequence: logits at {TP_LAYERS} layers against one "
          f"process, then one request at {one} of {full}")
    t0 = time.perf_counter()
    want = tp_oracle_logits(TP_TRAIN, slots=1)
    res = session.run_ranks(stream_rank, {
        "plan": Plan(**TP_TRAIN, data=2, device="cuda"),
        "logits": {"prompts": want["prompts"], "tokens": want["tokens"]},
        "full": dict(MESH_SERVE, prompts=None, params=None, plan=Plan(
            arch=cfg.name, tiny=False, data=2, device="cuda",
            overrides={"n_layers": one}))})
    out["j_s"] = time.perf_counter() - t0
    got = res[0]["logits"]
    rel = [mean_rel_err(g, w) for g, w in zip(got, want["logits"])]
    if len(got) != TP_DECODE_STEPS + 1 or max(rel) > TP_LOGIT_MEAN_REL_TOL:
        fails.append(f"(j) logits mean rel err {rel}")
    S = MESH_SERVE["prompt_len"] + MESH_SERVE["gen_len"]
    S_lg = SERVE["prompt_len"] + TP_DECODE_STEPS
    for r in (0, 1):
        rec = res[r]
        counts[f"mesh_stream_lg_L{r}"] = rec["launches"]
        _tp_launches(f"(j) logits rank {r}", rec["launches"], TP_LAYERS, 0,
                     fails)
        counts[f"mesh_stream_L{r}"] = rec["full"]["launches"]
        _tp_launches(f"(j) rank {r}", rec["full"]["launches"], one, 0,
                     fails)
        k_shape = rec["full"]["cache_shapes"][0]
        if rec["positions"] != S_lg // 2 or k_shape[1] != S // 2:
            fails.append(f"(j) rank {r} holds {rec['positions']} of {S_lg} "
                         f"and {k_shape} of {S} positions")
    dec_steps = len(res[0]["full"]["decode_s"])
    per_step = res[0]["full"]["wire"]["axes"]["dp"]["calls"] / dec_steps
    print(f"(j) logits, prefill then {TP_DECODE_STEPS} decode steps at "
          f"{TP_LAYERS} layers: mean rel err "
          f"{' '.join(f'{x:.3g}' for x in rel)} (tolerance "
          f"{TP_LOGIT_MEAN_REL_TOL:g}); {_tp_wire(res[0]['wire'])}")
    for r in (0, 1):
        print(f"(j) rank {r} holds {res[r]['full']['cache_shapes'][0][1]} "
              f"of {S} positions; " + _mesh_serve_line(
                  f"one request at {one} layers", res[r]["full"]))
    print(f"(j) dp all-reduces a decode step: {per_step:.1f} ({one} "
          f"layers; softmax_combine's 3 a layer)")
    out["j"] = {"logits_mean_rel_err": rel, "dp_calls_per_step": per_step,
                **{r: {k: res[r]["full"][k] for k in (
                    "tokens_per_s", "prefill_s", "decode_s", "wire")}
                   for r in (0, 1)}}
    torch.cuda.empty_cache()

    # (l) the gateway at model=2 (the model axis's families' sessions run
    # their own serve_stream), then data=2
    kw = dict(prompt_len=SERVE["prompt_len"], gen_len=SERVE["gen_len"],
              slots=SERVE["slots"])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, SERVE["prompt_len"]).astype(
        np.int32) for _ in GATEWAY_ARRIVALS]
    L = MESH_GATEWAY_M2_LAYERS
    phase(f"serving over a mesh: (l) the gateway at model=2, {cfg.name} at "
          f"{L} of {full} layers, {len(GATEWAY_ARRIVALS)} requests")
    t0 = time.perf_counter()
    m2g = Plan(arch=cfg.name, tiny=False, model=2, device="cuda",
               overrides={"n_layers": L})
    whole = _b1_cache_bytes(m2g.config())
    res = session.run_ranks(
        mesh_serve.rank_serve_stream,
        dict(kw, plan=m2g, page_bytes=PAGE_BYTES, params=None),
        driver=gateway_run(session.runtime, prompts, GATEWAY_ARRIVALS, kw))
    gw = res[0]
    handles = {h.rid: h for h in gw["handles"]}
    oracle = session.run_ranks(gateway_oracle_rank, dict(
        kw, plan=m2g, oracle=[(handles[r].prompt, handles[r]._slot)
                              for r in GATEWAY_ORACLE]))
    out["l_s"] = time.perf_counter() - t0
    for r in (0, 1):
        counts[f"mesh_gateway_m2_L{r}"] = res[r]["launches"]
    _mesh_gateway_checks("(l) model=2", gw, {1: res[1]}, L, whole, 2, fails)
    same_m2 = [oracle[0]["streams"][i] == gw["streams"][r]
               for i, r in enumerate(GATEWAY_ORACLE)]
    if not all(same_m2):
        fails.append(f"(l) model=2: oracle streams differ {same_m2}")
    tokens = sum(len(x) - 1 for x in gw["streams"].values())
    print(f"(l) model=2: {tokens / gw['seconds']:.1f} tok/s, {gw['rounds']} "
          f"rounds, {gw['epochs']} epochs, {gw['commands']} commands; page "
          f"hits {gw['serve']['page_hits']}/{gw['serve']['refills']}; "
          f"parked a request {gw['request_bytes']} B a rank of {whole}; "
          f"oracle {dict(zip(GATEWAY_ORACLE, same_m2))}; "
          f"{_tp_wire(gw['wire'])}")
    out["l_m2"] = {"tokens_per_s": tokens / gw["seconds"],
                   "rounds": gw["rounds"], "commands": gw["commands"],
                   "request_bytes": gw["request_bytes"],
                   "wire": {0: gw["wire"], 1: res[1]["wire"]}}
    torch.cuda.empty_cache()

    L = MESH_GATEWAY_LAYERS
    phase(f"serving over a mesh: (l) the gateway at data=2, {cfg.name} at "
          f"{L} of {full} layers")
    t0 = time.perf_counter()
    d2g = Plan(arch=cfg.name, tiny=False, data=2, device="cuda",
               overrides={"n_layers": L})
    res = session.run_ranks(
        mesh_serve.rank_serve_stream,
        dict(kw, plan=d2g, page_bytes=PAGE_BYTES, params=None),
        driver=gateway_run(session.runtime, prompts, GATEWAY_ARRIVALS, kw))
    gd = res[0]
    handles = {h.rid: h for h in gd["handles"]}
    oracle = session.run_ranks(gateway_oracle_rank, dict(
        kw, plan=d2g, oracle=[(handles[r].prompt, handles[r]._slot)
                              for r in GATEWAY_ORACLE]))
    out["l_d2_s"] = time.perf_counter() - t0
    for r in (0, 1):
        counts[f"mesh_gateway_d2_L{r}"] = res[r]["launches"]
    _mesh_gateway_checks("(l) data=2", gd, {1: res[1]}, L,
                         _b1_cache_bytes(d2g.config()), 1, fails)
    same_d2 = [oracle[0]["streams"][i] == gd["streams"][r]
               for i, r in enumerate(GATEWAY_ORACLE)]
    if not all(same_d2):
        fails.append(f"(l) data=2: oracle streams differ {same_d2}")
    tokens = sum(len(s) - 1 for s in gd["streams"].values())
    print(f"(l) data=2: {tokens / gd['seconds']:.1f} tok/s, {gd['rounds']} "
          f"rounds, {gd['epochs']} epochs, {gd['commands']} commands; page "
          f"hits {gd['serve']['page_hits']}/{gd['serve']['refills']} "
          f"(the session's counters); parked a request "
          f"{gd['request_bytes']} B a rank; oracle "
          f"{dict(zip(GATEWAY_ORACLE, same_d2))}; {_tp_wire(gd['wire'])}")
    out["l_d2"] = {"tokens_per_s": tokens / gd["seconds"],
                   "rounds": gd["rounds"], "commands": gd["commands"],
                   "request_bytes": gd["request_bytes"],
                   "wire": {0: gd["wire"], 1: res[1]["wire"]}}
    torch.cuda.empty_cache()

    # (m) zamba2-2.7b at data=2
    zl = STREAM_LAYERS["zamba2-2.7b"]
    phase(f"serving over a mesh: (m) zamba2-2.7b's wave loop at data=2, "
          f"{zl} layers, one wave of {MESH_SERVE['slots']}")
    t0 = time.perf_counter()
    zp = Plan(arch="zamba2-2.7b", tiny=False, data=2, device="cuda",
              overrides={"n_layers": zl})
    res = session.run_ranks(mesh_serve.rank_serve, dict(
        MESH_SERVE, plan=zp, prompts=None, params=None))
    out["m_s"] = time.perf_counter() - t0
    zcfg = zp.config()
    want_l = prefill_launches(zcfg)
    for r in (0, 1):
        rec = res[r]
        counts[f"mesh_serve_m_L{r}"] = rec["launches"]
        if rec["launches"] != want_l:
            fails.append(f"(m) rank {r}: launches {rec['launches']} (want "
                         f"{want_l})")
        g = rec["generated"][0]
        if g.shape != (MESH_SERVE["slots"], MESH_SERVE["gen_len"] + 1) or \
                int(g.min()) < 0 or int(g.max()) >= zcfg.vocab:
            fails.append(f"(m) rank {r}: tokens out of range")
        print(_mesh_serve_line(f"(m) zamba2-2.7b data=2 rank {r}", rec))
    out["m"] = {r: {k: res[r][k] for k in ("tokens_per_s", "prefill_s",
                                           "decode_s", "wire")}
                for r in (0, 1)}
    torch.cuda.empty_cache()
    return out


def mesh_serving_d2m2(session, counts: dict, fails: list) -> dict:
    """(k) in the four-rank session: the wave loop at data=2, model=2
    (qwen3-4b at TP_LAYERS, one wave of 8: 4 rows a dp rank, half the
    heads a model rank)."""
    phase(f"serving over a mesh: (k) the wave loop at data=2, model=2, "
          f"qwen3-4b at {TP_LAYERS} layers, one wave of "
          f"{MESH_SERVE['slots']}")
    t0 = time.perf_counter()
    res = session.run_ranks(mesh_serve.rank_serve, dict(
        MESH_SERVE, plan=Plan(**TP_TRAIN, data=2, model=2, device="cuda"),
        prompts=None, params=None))
    secs = time.perf_counter() - t0
    gen = res[0]["generated"][0]
    for r in range(4):
        rec = res[r]
        counts[f"mesh_serve_k_L{r}"] = rec["launches"]
        _tp_launches(f"(k) rank {r}", rec["launches"], TP_LAYERS, 0, fails)
        ax = rec["wire"]["axes"]
        if not (ax["dp"]["calls"] and ax["model"]["calls"]):
            fails.append(f"(k) rank {r}: dp or model wire idle {ax}")
        if not torch.equal(rec["generated"][0], gen):
            fails.append(f"(k) rank {r}'s tokens differ from rank 0's")
        print(_mesh_serve_line(f"(k) data=2, model=2 rank {r}", rec))
    if gen.shape != (MESH_SERVE["slots"], MESH_SERVE["gen_len"] + 1):
        fails.append(f"(k) tokens {tuple(gen.shape)}")
    return {"s": secs, **{r: {k: res[r][k] for k in (
        "tokens_per_s", "prefill_s", "decode_s", "wire")} for r in range(4)}}


def har_cnn_oracle() -> dict:
    """The HAR CNN in one process on the card at HAR_BATCH, float32, from
    ``check_har_cnn``'s parameters (drawn on the CPU from seed 0): the
    loss, every gradient (on the CPU) and the forward's device time."""
    params = pytree.tree_map(
        lambda t: t.to("cuda").requires_grad_(True),
        init_params(cnn.har_cnn_specs(), torch.Generator().manual_seed(0),
                    "cpu"))
    batch = to_device(HARStream(batch=HAR_BATCH).batch_at(0), "cuda")
    loss = cnn.har_cnn_loss(params, batch)
    loss.backward()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: cnn.har_cnn_forward(params, batch["x"]),
                         iters=10)
    return {"loss": loss.item(),
            "grads": [t.grad.cpu() for t in pytree.tree_leaves(params)],
            "forward_ms": fwd_ms}


def cnn_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """The HAR CNN at model=2 (module level: every worker rank runs it):
    this rank's blocks of ``har_cnn_oracle``'s parameters (its half of
    every conv's channels, ``init_params(mesh=, rules=default_rules())``
    on the same CPU draws), the whole HAR_BATCH batch; the loss, the
    gradients gathered over the model group (rank 0 keeps them), the
    head's gradient bits, the wire and launches of the loss and its
    backward, and the forward's time a rank (CUDA events around the call,
    its gloo joins inside, so no spin ahead) with the wire of one
    forward."""
    # float32 means float32 on every rank, as main() sets it in this
    # process: a spawned rank keeps cuDNN's TF32 default (on), which moved
    # the loss by 1.8e-4 and the gradients by 8.8e-4 of their largest
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_local_mesh(model=2)
    specs, rules = cnn.har_cnn_specs(), default_rules()
    params = pytree.tree_map(
        lambda t: t.to("cuda").requires_grad_(True),
        init_params(specs, torch.Generator().manual_seed(0), "cpu",
                    mesh=mesh, rules=rules))
    batch = to_device(HARStream(batch=HAR_BATCH).batch_at(0), "cuda")
    torch.cuda.synchronize()
    _zero_counts()
    collectives.reset_stats()
    with act_hook(mesh, rules):
        loss = cnn.har_cnn_loss(params, batch)
        loss.backward()
    torch.cuda.synchronize()
    launched, wire = _counts(), collectives.stats()
    grads = pytree.tree_map(lambda p: p.grad, params)
    whole = gather_tree(grads, specs, mesh, rules)
    with torch.no_grad(), act_hook(mesh, rules):
        fwd_ms = cuda_ms(lambda: cnn.har_cnn_forward(params, batch["x"]),
                         iters=2, warm=0, spin=False)
        collectives.reset_stats()
        cnn.har_cnn_forward(params, batch["x"])
        fwd_wire = collectives.stats()
    keep = mesh.model_rank == 0
    return {"loss": loss.item(), "launches": launched, "wire": wire,
            "grads": pytree.tree_leaves(whole) if keep else None,
            "head": param_bit_sums(grads["head"]),
            "conv1_rows": int(params["conv1"]["b"].shape[0]),
            "forward_ms": fwd_ms, "forward_wire": fwd_wire}


def _cnn_axis(res: dict, oracle: dict, counts: dict, fails: list) -> dict:
    """The HAR CNN at model=2 against one process on the card: the loss
    within HAR_LOSS_RTOL, each gradient leaf within HAR_GRAD_TOL of its
    largest |gradient|, the head's gradient bit-identical on both ranks,
    each rank half of conv1's channels, no kernel launched."""
    got = res[0]
    loss_err = abs(got["loss"] - oracle["loss"]) / abs(oracle["loss"])
    shares = [(g - c).abs().max().item() / c.abs().max().item()
              for c, g in zip(oracle["grads"], got["grads"])]
    share = max(shares)
    same = res[0]["head"] == res[1]["head"] and \
        res[0]["loss"] == res[1]["loss"]
    rows = [res[r]["conv1_rows"] for r in (0, 1)]
    for r in (0, 1):
        counts[f"cnn_tp_L{r}"] = res[r]["launches"]
        _want_launches(f"(a) HAR CNN rank {r}", res[r]["launches"], {},
                       fails)
    if loss_err > HAR_LOSS_RTOL or share > HAR_GRAD_TOL or not same \
            or rows != [32, 32]:
        fails.append(f"(a) HAR CNN at model=2: loss rel err {loss_err:.3g}, "
                     f"gradient share {share:.3g}, head bit-identical "
                     f"{same}, conv1 channels a rank {rows}")
    w, fw = got["wire"]["axes"]["model"], got["forward_wire"]["axes"]["model"]
    print(f"(a) HAR CNN at model=2, minibatch {HAR_BATCH}, float32: loss "
          f"{got['loss']:.7f} against one process's {oracle['loss']:.7f} "
          f"(rel {loss_err:.3g}, tolerance {HAR_LOSS_RTOL:g}); gradients, "
          f"the largest error of a leaf / its largest |gradient| "
          f"{share:.3g} (tolerance {HAR_GRAD_TOL:g}; by leaf "
          f"{' '.join(f'{x:.2g}' for x in shares)}); head bit-identical on "
          f"both ranks {same}; conv1 channels a rank {rows}")
    print(f"(a) HAR CNN forward, device time a rank "
          f"{res[0]['forward_ms']:.4f} / {res[1]['forward_ms']:.4f} ms "
          f"(events around the call, its channel joins over gloo inside) "
          f"against one process's {oracle['forward_ms']:.4f} ms; the "
          f"channel joins of a forward {fw['bytes']} B in {fw['calls']} "
          f"collectives, {fw['wire_s']:.3f} s in gloo; loss and backward "
          f"{w['bytes']} B in {w['calls']}")
    return {"loss_rel_err": loss_err, "grad_err_share": share,
            "head_bit_identical": same, "conv1_rows": rows,
            "forward_ms": [res[r]["forward_ms"] for r in (0, 1)],
            "oracle_forward_ms": oracle["forward_ms"],
            "forward_wire": got["forward_wire"]["axes"]["model"],
            "wire": got["wire"]["axes"]["model"]}


def _bit_sum(t) -> int:
    """``param_bit_sums`` of one float32 tensor, ONEBIT_CHECK_ROWS rows'
    worth of elements at a time (its int64 copy of a whole global bucket
    does not fit beside four ranks' state on the one card)."""
    flat, n = t.detach().reshape(-1).view(torch.int32), ONEBIT_CHECK_ROWS
    n *= 1024
    return sum(int(flat[a:a + n].sum(dtype=torch.int64))
               for a in range(0, flat.numel(), n))


def onebit_rank(spec: dict, endpoint=None, driver=None) -> dict:
    """onebit at data=2, model=2 (module level: every rank runs it): the
    plan's qwen3-4b layers from the seed's init, ``spec["steps"]`` steps
    with plain SGD: an optimizer state beside each rank's global
    residual does not fit four ranks on the one card (adamw ran out of
    memory on an H100 80GB HBM3 at 700 W, momentum at 17.6 GB a rank
    behind the whole script's earlier phases).
    At the first step every bucket's exchange is held as it runs
    (``TrainStep.on_bucket``): this rank's K3a words, scales and residual
    against ``onebit_quantize_ref`` on the same global bucket
    (``k3a_against_plain``), the mean against the plain decode of the
    gathered payloads (bit for bit), and the bucket's, residual's and
    mean's bit sums kept for the other ranks; the later steps run
    unwatched, their host walls the step's.  Launches, wire and the
    unsplit leaves' bit sums over all the steps."""
    plan, stream = spec["plan"], spec["stream"]
    mesh = make_local_mesh(data=2, model=2)
    cfg = plan.config()
    step = steps.make_train_step(cfg, steps.Strategy(
        name="onebit", opt=optimizers.OptConfig(kind="sgd")),
        plan=plan, mesh=mesh)
    params, opt = step.init(
        torch.Generator(device="cuda").manual_seed(plan.seed), "cuda")
    checks = {"bad_words": 0, "near_words": 0, "scale_rel_err": 0.0,
              "err_abs_err": 0.0, "mean_equal": True, "sums": []}

    def check(i, packed, scales, mean, own):
        # rows at a time: the plain versions' temporaries of a whole
        # global bucket (1.56 GB of float32, its sign bits as int64) do
        # not fit beside four ranks' state on the one card
        buf, err, new_err = own
        g, r, n = buf.reshape(err.shape), mesh.rank, ONEBIT_CHECK_ROWS
        for a in range(0, err.shape[0], n):
            rows = slice(a, a + n)
            q = k3a_against_plain(g[rows], err[rows], packed[r][rows],
                                  scales[r][rows], new_err[rows])
            checks["bad_words"] = max(checks["bad_words"], q["bad"])
            checks["near_words"] += q["near"]
            for k in ("scale_rel_err", "err_abs_err"):
                checks[k] = max(checks[k], q[k])
            acc = onebit_dequantize_ref(packed[0][rows], scales[0][rows])
            for o in range(1, packed.shape[0]):
                acc = acc + onebit_dequantize_ref(packed[o][rows],
                                                  scales[o][rows])
            checks["mean_equal"] &= torch.equal(
                acc.div_(packed.shape[0]).reshape(-1),
                mean[a * g.shape[1]:(a + n) * g.shape[1]])
        checks["sums"].append([_bit_sum(t) for t in (buf, new_err, mean)])
    mask = pytree.tree_leaves(step.split_mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    collectives.reset_stats()
    losses, gnorms, wall, sums = [], [], [], []
    for it in range(spec["steps"]):
        step.on_bucket = check if it == 0 else None
        batch = to_device(stream.batch_at(it), "cuda")
        t0 = time.perf_counter()
        m, params, opt = step.fn(params, opt, batch)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        sums.append(param_bit_sums([p for p, s in zip(
            pytree.tree_leaves(params), mask) if not s]))
    out = {"losses": losses, "grad_norms": gnorms, "step_ms": wall,
           "launches": _counts(), "wire": collectives.stats(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "replicated_bit_sums": sums, "checks": checks,
           "buckets": [b.size for b in step.plan.buckets]}
    del step, params, opt, m
    torch.cuda.empty_cache()
    return out


def _onebit_axis(res: dict, counts: dict, fails: list) -> dict:
    """onebit at data=2, model=2 on four ranks: every rank's K3a held to
    its plain version (the kernels phase's tolerance) and its mean equal
    to the plain decode; the two model ranks of each dp coordinate
    bit-identical in bucket, residual and mean, the mean alike on all
    four; the unsplit leaves bit-identical on all four; K3a once and K3b
    twice (2 origins) a bucket a step; the dp wire the reference's
    ``size / 8 + size / 256`` bytes a bucket a step."""
    n_steps = len(res[0]["losses"])
    sizes = res[0]["buckets"]
    want = {"onebit_quantize": len(sizes) * n_steps,
            "onebit_dequantize": 2 * len(sizes) * n_steps}
    for r in range(4):
        rec = res[r]
        counts[f"onebit_tp_L{r}"] = rec["launches"]
        _want_launches(f"(d) onebit rank {r}", rec["launches"],
                       dict(want, flash_attention=2 * TP_D2_LAYERS * n_steps,
                            flash_attention_bwd=TP_D2_LAYERS * n_steps),
                       fails)
        c = rec["checks"]
        if c["bad_words"] or c["scale_rel_err"] > 1e-6 or \
                c["err_abs_err"] > 1e-6 or not c["mean_equal"]:
            fails.append(f"(d) onebit rank {r}: K3a or the mean against "
                         f"their plain versions {c}")
        if rec["replicated_bit_sums"] != res[0]["replicated_bit_sums"] or \
                rec["losses"] != res[0]["losses"]:
            fails.append(f"(d) onebit rank {r}: unsplit leaves or losses "
                         f"differ from rank 0's")
        if not all(np.isfinite(rec["losses"] + rec["grad_norms"])):
            fails.append(f"(d) onebit rank {r}: losses or norms not finite")
    # world ranks: dp rank d's model ranks are 2d and 2d + 1
    pair = all(res[2 * d]["checks"]["sums"] == res[2 * d + 1]["checks"]["sums"]
               for d in (0, 1))
    means = all([s[2] for s in res[r]["checks"]["sums"]] ==
                [s[2] for s in res[0]["checks"]["sums"]] for r in range(4))
    if not pair or not means:
        fails.append(f"(d) onebit: a dp coordinate's model ranks agree in "
                     f"bucket, residual and mean {pair}; the mean on all "
                     f"four {means}")
    dp_want = n_steps * sum(s // 8 + s // 256 for s in sizes)
    w = res[0]["wire"]["axes"]
    if w["dp"]["bytes"] - dp_want not in range(0, 64 * n_steps):
        fails.append(f"(d) onebit: dp wire {w['dp']['bytes']} B, want the "
                     f"reference's {dp_want} B and the loss's pmean")
    c = res[0]["checks"]
    print(f"(d) onebit at data=2, model=2, {TP_D2_LAYERS} layers, "
          f"{n_steps} steps: losses "
          f"{' '.join(f'{x:.6f}' for x in res[0]['losses'])}, gnorms "
          f"{' '.join(f'{x:.6f}' for x in res[0]['grad_norms'])}; "
          f"{len(sizes)} global buckets (largest {max(sizes)} elements); "
          f"K3a against its plain version: other words {c['bad_words']}, "
          f"near-zero words {c['near_words']}, scale rel err "
          f"{c['scale_rel_err']:.3g}, residual abs err "
          f"{c['err_abs_err']:.3g}; mean equal to the plain decode "
          f"{c['mean_equal']}; a dp coordinate's model ranks bit-identical "
          f"(bucket, residual, mean) {pair}; launches {res[0]['launches']}")
    for r in range(4):
        rec = res[r]
        print(f"  (d) onebit rank {r}: steps "
              f"{' '.join(f'{x:.1f}' for x in rec['step_ms'])} ms (the first "
              f"with the holds); {_tp_wire(rec['wire'])} (the reference's dp "
              f"wire {dp_want} B); peak {rec['peak_bytes'] / 1e9:.3f} GB")
    return {"losses": res[0]["losses"], "grad_norms": res[0]["grad_norms"],
            "buckets": sizes, "checks": {k: v for k, v in c.items()
                                         if k != "sums"},
            "pair_bit_identical": pair, "dp_wire_want": dp_want,
            "step_ms": {r: res[r]["step_ms"] for r in range(4)},
            "wire": {r: res[r]["wire"] for r in range(4)},
            "peak_bytes": {r: res[r]["peak_bytes"] for r in range(4)}}


def _fam_sp_runs(session, f32_kw: dict, bf16_kw: dict, f32_stream, stream,
                 opt: dict, wq_scale=None) -> dict:
    """A family's sequence-parallel runs in its ``Plan(model=2)``
    session: FAM_TP_STEPS held float32 steps (``f32_kw``, ``opt``, every
    wq times ``wq_scale``) and SP_BF16_STEPS bf16 steps (``bf16_kw``)."""
    out = {}
    for name, kw, st, n, o, sc in (
            ("f32", f32_kw, f32_stream, FAM_TP_STEPS, opt, wq_scale),
            ("bf16", bf16_kw, stream, SP_BF16_STEPS, {}, None)):
        t1 = time.perf_counter()
        out[name] = session.run_ranks(tp_rank, {
            "plan": Plan(**kw, model=2, device="cuda"), "stream": st,
            "steps": n, "opt": o, "wq_scale": sc, "sp": True})
        out[f"{name}_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    return out


def _fam_sp(tag: str, sp: dict, oracle, plain: dict, want_f32: dict,
            want_bf16: dict, key: str, counts: dict, fails: list,
            expect: dict, **held) -> dict:
    """(n)-(q)'s sequence-parallel runs: the float32 run held to the
    family's one-process oracle (``_fam_train``: its tolerances, its
    unsplit leaves bit-identical on both ranks), the bf16 step counted;
    the residual's split ``expect`` (``seq``: the tokens', None where the
    vocab does not divide; ``enc``: an encoder's frames); where it stays
    whole, the float32 run bit-identical to the run without (``plain``'s
    ``f32``). Prints the bf16 step's collectives, bytes by axis and peak
    a rank with and without sequence parallelism."""
    out = {"f32": _fam_train(f"{tag} phylanx f32 SP", sp["f32"], oracle,
                             want_f32, f"{key}_sp_f32", counts, fails,
                             **held),
           "bf16": _fam_train(f"{tag} phylanx bf16 SP", sp["bf16"], None,
                              want_bf16, f"{key}_sp_bf16", counts, fails)}
    got = {k: sp["bf16"][0]["sp"][k] for k in ("seq", "enc")}
    out["split"] = got
    if got != expect:
        fails.append(f"{tag} SP: the residual's split {got}, want {expect}")
    if got["seq"] is None and got["enc"] is not True:
        same = sp["f32"][0]["train"]["losses"] == \
            plain["f32"][0]["train"]["losses"] and \
            sp["f32"][0]["train"]["grad_norms"] == \
            plain["f32"][0]["train"]["grad_norms"]
        out["same_as_plain"] = same
        if not same:
            fails.append(f"{tag} SP: the residual stays whole, yet the run "
                         f"differs from the one without")
    rows = {}
    for name, rec, n in (("SP", sp["bf16"], SP_BF16_STEPS),
                         ("without", plain["bf16"], plain["bf16_steps"])):
        t = rec[0]["train"]
        ax = t["wire"]["axes"]
        rows[name] = {"calls": ax["model"]["calls"] / n,
                      "bytes": ax["model"]["bytes"] / n,
                      "gloo_s": ax["model"]["wire_s"] / n,
                      "peak_bytes": max(rec[r]["train"]["peak_bytes"]
                                        for r in (0, 1)),
                      "step_ms": t["step_ms"][-1]}
    out["bf16_step"] = rows
    a, b = rows["SP"], rows["without"]
    print(f"{tag} a bf16 step a rank with SP (tokens split by "
          f"{got['seq']}, frames {got['enc']}) against without: "
          f"{a['calls']:.0f} / {b['calls']:.0f} model-axis collectives, "
          f"{a['bytes'] / 1e6:.1f} / {b['bytes'] / 1e6:.1f} MB, "
          f"{a['gloo_s']:.2f} / {b['gloo_s']:.2f} s in gloo, step "
          f"{a['step_ms']:.1f} / {b['step_ms']:.1f} ms, peak "
          f"{a['peak_bytes'] / 1e9:.3f} / {b['peak_bytes'] / 1e9:.3f} GB")
    return out


def model_axis() -> tuple[dict, dict]:
    """The model axis on the one card (ROADMAP item 14b, part 1):
    qwen3-4b at full width, random weights from seed 0, one repeated 8 x
    512 batch.  A ``Plan(model=2)`` session (two rank processes in a gloo
    world: this one and a spawned worker) runs (a) and (b) through
    ``Session.run_ranks`` (``tp_rank``) after their one-process oracles
    (run here while the worker takes its cold start, ``tp_warmup``): (a)
    phylanx at ``TP_LAYERS`` layers for ``TP_STEPS`` steps within
    ``TP_LOSS_RTOL``/``TP_NORM_RTOL`` of the oracle, the leaves no rule
    splits bit-identical on both ranks after every step, K1 24 / 12 a
    rank; (b) the prefill and decode logits within
    ``TP_LOGIT_MEAN_REL_TOL``; (c) ``Session.serve`` at all 36 layers: K1
    72 a rank, the tokens against the one-process serve phase's (counted,
    not held: bf16 near-ties may flip).  Then a ``Plan(data=2, model=2)``
    session of four ranks: (d) one phylanx step at ``TP_D2_LAYERS``
    layers against its oracle, the unsplit leaves bit-identical on all
    four, K1 4 / 2 a rank.  Serving over a mesh (ROADMAP item 14b, part
    3) runs in the same two worlds: (i), (j), (l) and (m) in the first
    (``mesh_serving``), (k) in the second (``mesh_serving_d2m2``).  No
    world is left and the workers are reaped.  Returns the counts by run
    and the readings."""
    cfg = Plan(**TP_TRAIN).config()
    full = get_config(cfg.name).n_layers
    stream = RepeatStream(stream_for(cfg, batch=TRAIN["batch"],
                                     seq=TRAIN["seq"], seed=0))
    phase(f"model axis: {cfg.name} at full width on model=2 rank processes "
          f"on the one card: train {TP_LAYERS} of {full} layers, its logits, "
          f"serve all {full}; one data=2, model=2 step at {TP_D2_LAYERS}")
    print(f"CUT to {TP_LAYERS} (train, logits) and {TP_D2_LAYERS} (data=2, "
          f"model=2) of {full} layers: each oracle's float32 state with adamw "
          f"beside the ranks' on the one card, and the phase's time; "
          f"Session.serve to {TP_SERVE_GEN} of {SERVE['gen_len']} tokens a "
          f"request (the script's time)")
    counts: dict = {}
    fails: list = []
    serve_plan = Plan(arch=cfg.name, tiny=False, model=2, device="cuda")
    t0 = time.perf_counter()
    with serve_plan.compile() as session:
        up_s = time.perf_counter() - t0
        pids = [pr.pid for pr in session.ranks.group.procs.values()]
        session.ranks.spmd_train({"loop": tp_warmup})
        oracle = tp_oracle_train(TP_TRAIN, stream, TP_STEPS)
        want_lg = tp_oracle_logits(TP_TRAIN)
        warm = session.ranks.wait_spmd_done(timeout=300.0)
        if not all(m.get("ok") for m in warm.values()):
            raise AssertionError(f"model-axis warm-up failed: {warm}")
        t1 = time.perf_counter()
        ranks = session.run_ranks(tp_rank, {
            "plan": Plan(**TP_TRAIN, model=2, device="cuda"),
            "stream": stream, "steps": TP_STEPS,
            "logits": {"prompts": want_lg["prompts"],
                       "tokens": want_lg["tokens"]}})
        ranks_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        part2 = session.run_ranks(tp_part2_rank, {
            "plan": Plan(**TP_TRAIN, model=2, device="cuda"),
            "stream": stream, "steps": TP_STEPS})
        part2_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cnn_oracle = har_cnn_oracle()
        cnn_res = session.run_ranks(cnn_rank, {})
        cnn_s = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        _zero_counts()
        served = session.serve(**dict(SERVE, gen_len=TP_SERVE_GEN))
        counts["tp_serve_L0"] = _counts()
        serve_s = time.perf_counter() - t1
        torch.cuda.empty_cache()
        mesh_readings = mesh_serving(session, counts, fails)
    world_left = torch.distributed.is_initialized()
    reaped = _reaped(pids)
    counts["tp_serve_L1"] = served["localities"][1]["launches"]
    res = {r: ranks[r] for r in (0, 1)}
    # (a)
    train = {}
    for r in (0, 1):
        rec = res[r]["train"]
        counts[f"tp_train_L{r}"] = rec["launches"]
        _tp_launches(f"train rank {r}", rec["launches"],
                     2 * TP_LAYERS * TP_STEPS, TP_LAYERS * TP_STEPS, fails)
        train[r] = _tp_held(f"train rank {r}", rec, oracle, fails)
    same = res[0]["train"]["replicated_bit_sums"] == \
        res[1]["train"]["replicated_bit_sums"]
    if not same or res[0]["train"]["losses"] != res[1]["train"]["losses"]:
        fails.append("train: the ranks' unsplit leaves or losses differ")
    # (b)
    got_lg = res[0]["logits"]["logits"]
    lg_rel = [mean_rel_err(g, w) for g, w in zip(got_lg, want_lg["logits"])]
    lg_max = [float((g - w).abs().max())
              for g, w in zip(got_lg, want_lg["logits"])]
    if len(got_lg) != TP_DECODE_STEPS + 1 or \
            max(lg_rel) > TP_LOGIT_MEAN_REL_TOL:
        fails.append(f"logits mean rel err {lg_rel}")
    for r in (0, 1):
        counts[f"tp_logits_L{r}"] = res[r]["logits"]["launches"]
        _tp_launches(f"logits rank {r}", res[r]["logits"]["launches"],
                     TP_LAYERS, 0, fails)
    # (c)
    waves = served["waves"]
    for r in (0, 1):
        _tp_launches(f"serve rank {r}", counts[f"tp_serve_L{r}"],
                     waves * full, 0, fails)
    gen = torch.cat(served["generated"])
    ref = SERVE_TOKENS.get(cfg.name)
    same_tokens = None if ref is None else int(
        (gen == ref[:, :TP_SERVE_GEN + 1]).sum())
    if gen.shape != (waves * SERVE["slots"], TP_SERVE_GEN + 1) or \
            int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab or \
            not bool(torch.isfinite(served["first_prefill_logits"]).all()):
        fails.append(f"serve: tokens {gen.shape} out of range or logits "
                     f"not finite")
    if world_left or not reaped:
        fails.append(f"world left {world_left}, worker reaped {reaped}")
    # (d)
    d2_plan = Plan(**TP_D2_TRAIN, data=2, model=2, device="cuda")
    t1 = time.perf_counter()
    with d2_plan.compile() as session:
        d2_up_s = time.perf_counter() - t1
        pids = [pr.pid for pr in session.ranks.group.procs.values()]
        session.ranks.spmd_train({"loop": tp_warmup})
        d2_oracle = tp_oracle_train(TP_D2_TRAIN, stream, 1)
        warm = session.ranks.wait_spmd_done(timeout=300.0)
        if not all(m.get("ok") for m in warm.values()):
            raise AssertionError(f"data=2, model=2 warm-up failed: {warm}")
        d2 = session.run_ranks(tp_rank, {"plan": d2_plan, "stream": stream,
                                         "steps": 1})
        d2_s = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()
        print(f"(d) before onebit: this process holds "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB of the card "
              f"({torch.cuda.memory_reserved() / 1e9:.3f} GB reserved)")
        t1 = time.perf_counter()
        ob = session.run_ranks(onebit_rank, {"plan": d2_plan,
                                             "stream": stream,
                                             "steps": ONEBIT_TP_STEPS})
        onebit_s = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ex = session.run_ranks(gpipe_example_rank, {})
        ex_s = time.perf_counter() - t1
        torch.cuda.empty_cache()
        mesh_readings["k"] = mesh_serving_d2m2(session, counts, fails)
    world_left = torch.distributed.is_initialized()
    reaped = _reaped(pids)
    d2_held = {}
    for r in range(4):
        rec = d2[r]["train"]
        counts[f"tp_d2_L{r}"] = rec["launches"]
        _tp_launches(f"data=2, model=2 rank {r}", rec["launches"],
                     2 * TP_D2_LAYERS, TP_D2_LAYERS, fails)
        d2_held[r] = _tp_held(f"data=2, model=2 rank {r}", rec, d2_oracle,
                              fails)
        if rec["replicated_bit_sums"] != d2[0]["train"]["replicated_bit_sums"]:
            fails.append(f"data=2, model=2: rank {r}'s unsplit leaves differ")
    if world_left or not reaped:
        fails.append(f"data=2, model=2: world left {world_left}, workers "
                     f"reaped {reaped}")
    part2_readings = _tp_part2(counts, {r: part2[r] for r in (0, 1)},
                               oracle, fails)
    cnn_readings = _cnn_axis({r: cnn_res[r] for r in (0, 1)}, cnn_oracle,
                             counts, fails)
    onebit_readings = _onebit_axis({r: ob[r] for r in range(4)}, counts,
                                   fails)
    ex_readings = _gpipe_example({r: ex[r] for r in range(4)}, fails)

    for r in (0, 1):
        rec = res[r]["train"]
        print(f"train rank {r}: losses "
              f"{' '.join(f'{x:.6f}' for x in rec['losses'])}, gnorms "
              f"{' '.join(f'{x:.6f}' for x in rec['grad_norms'])} (rel err "
              f"{train[r]['loss_rel_err']:.3g}, "
              f"{train[r]['grad_norm_rel_err']:.3g}); steps "
              f"{' '.join(f'{x:.1f}' for x in rec['step_ms'])} ms; "
              f"{_tp_wire(rec['wire'])}; peak "
              f"{rec['peak_bytes'] / 1e9:.3f} GB; K1 "
              f"{rec['launches']['flash_attention']} / "
              f"{rec['launches']['flash_attention_bwd']}")
    print(f"oracle (one process): losses "
          f"{' '.join(f'{x:.6f}' for x in oracle['losses'])}, gnorms "
          f"{' '.join(f'{x:.6f}' for x in oracle['grad_norms'])}; steps "
          f"{' '.join(f'{x:.1f}' for x in oracle['step_ms'])} ms; peak "
          f"{oracle['peak_bytes'] / 1e9:.3f} GB")
    print(f"the {res[0]['train']['replicated']} unsplit leaves (of "
          f"{res[0]['train']['leaves']}) bit-identical on both ranks after "
          f"every step: {same}")
    print(f"logits, prefill then {TP_DECODE_STEPS} decode steps: mean rel "
          f"err {' '.join(f'{x:.3g}' for x in lg_rel)} (tolerance "
          f"{TP_LOGIT_MEAN_REL_TOL:g}); max abs err "
          f"{' '.join(f'{x:.3g}' for x in lg_max)}; "
          f"{_tp_wire(res[0]['logits']['wire'])}")
    pre_ms = [1e3 * x for x in served["prefill_s"]]
    dec_ms = sorted(1e3 * x for x in served["decode_s"])
    print(f"serve at model=2, {full} layers: {served['tokens_per_s']:.1f} "
          f"tok/s, {waves} waves, prefill "
          f"{' '.join(f'{x:.1f}' for x in pre_ms)} ms, decode step median "
          f"{dec_ms[len(dec_ms) // 2]:.1f} ms (min {dec_ms[0]:.1f}, max "
          f"{dec_ms[-1]:.1f}); tokens equal to the one-process serve "
          f"phase's: {same_tokens} of {gen.numel()}; K1 "
          f"{counts['tp_serve_L0']['flash_attention']} / "
          f"{counts['tp_serve_L1']['flash_attention']}")
    for r, w in ((0, served["wire"]), (1, served["localities"][1]["wire"])):
        print(f"  serve rank {r}: {_tp_wire(w)}")
    for r in range(4):
        rec = d2[r]["train"]
        print(f"data=2, model=2 rank {r}: loss {rec['losses'][0]:.6f}, gnorm "
              f"{rec['grad_norms'][0]:.6f} (oracle {d2_oracle['losses'][0]:.6f}"
              f", {d2_oracle['grad_norms'][0]:.6f}); step "
              f"{rec['step_ms'][0]:.1f} ms; {_tp_wire(rec['wire'])}; K1 "
              f"{rec['launches']['flash_attention']} / "
              f"{rec['launches']['flash_attention_bwd']}")
    print(f"session up {up_s:.1f} s (data=2, model=2: {d2_up_s:.1f} s); "
          f"ranks' train and logits {ranks_s:.1f} s; serve {serve_s:.1f} s; "
          f"data=2, model=2 {d2_s:.1f} s; part 2: (e), (h), (g) "
          f"{part2_s:.1f} s, (f) {ex_s:.1f} s; the HAR CNN {cnn_s:.1f} s; "
          f"onebit {onebit_s:.1f} s; world left {world_left}, "
          f"workers reaped {reaped}")
    if fails:
        raise AssertionError("model axis: " + "; ".join(fails))
    readings = {
        "layers": {"train": TP_LAYERS, "serve": full, "d2": TP_D2_LAYERS},
        "session_up_s": up_s, "d2_session_up_s": d2_up_s,
        "ranks_s": ranks_s, "serve_s": serve_s, "d2_s": d2_s,
        "oracle": {k: oracle[k] for k in ("losses", "grad_norms",
                                          "step_ms", "peak_bytes")},
        "train": {r: dict(train[r], **{k: res[r]["train"][k] for k in (
            "losses", "grad_norms", "step_ms", "wire", "peak_bytes")})
            for r in (0, 1)},
        "replicated_bit_identical": same,
        "logits": {"mean_rel_err": lg_rel, "max_abs_err": lg_max},
        "serve": {"tokens_per_s": served["tokens_per_s"],
                  "prefill_ms": pre_ms, "decode_ms": dec_ms,
                  "same_tokens": same_tokens, "tokens": gen.numel(),
                  "wire": {0: served["wire"],
                           1: served["localities"][1]["wire"]}},
        "d2": {r: dict(d2_held[r], **{k: d2[r]["train"][k] for k in (
            "losses", "grad_norms", "step_ms", "wire")}) for r in range(4)},
        "part2_s": part2_s, "gpipe_example_s": ex_s, **part2_readings,
        "har_cnn": dict(cnn_readings, seconds=cnn_s),
        "onebit": dict(onebit_readings, seconds=onebit_s),
        "gpipe_example": ex_readings, "mesh_serving": mesh_readings}
    return counts, readings


def _want_launches(name: str, launches: dict, want: dict,
                   fails: list) -> None:
    """``launches`` equal ``want``, every kernel ``want`` omits at 0."""
    full = dict.fromkeys(launches, 0)
    full.update(want)
    if launches != full:
        fails.append(f"{name} launches {launches} (want {full})")


def _fam_warm_oracle(session, fn):
    """``fn()`` (the one-process oracles) in this process while the
    session's worker takes its cold start (``tp_warmup``)."""
    session.ranks.spmd_train({"loop": tp_warmup})
    out = fn()
    warm = session.ranks.wait_spmd_done(timeout=300.0)
    if not all(m.get("ok") for m in warm.values()):
        raise AssertionError(f"model-axis warm-up failed: {warm}")
    return out


def _fam_train(name: str, res: dict, oracle, want: dict, key: str,
               counts: dict, fails: list, norm_rtol: float = TP_NORM_RTOL,
               norm_steps=None) -> dict:
    """A two-rank training run of (n) or (o): against its one-process
    ``oracle`` where there is one (losses within TP_LOSS_RTOL, the first
    ``norm_steps`` norms within ``norm_rtol``), every loss and norm
    finite, the leaves no rule splits bit-identical on both ranks after
    every step, each rank's launches ``want``."""
    out = {}
    for r in (0, 1):
        rec = res[r]["train"]
        counts[f"{key}_L{r}"] = rec["launches"]
        _want_launches(f"{name} rank {r}", rec["launches"], want, fails)
        held = {} if oracle is None else \
            _tp_held(f"{name} rank {r}", rec, oracle, fails, norm_rtol,
                     norm_steps)
        if not all(np.isfinite(rec["losses"] + rec["grad_norms"])):
            fails.append(f"{name} rank {r}: losses or norms not finite")
        out[r] = dict(held, **{k: rec[k] for k in (
            "losses", "grad_norms", "step_ms", "wire", "peak_bytes")})
        err = "" if oracle is None else (
            f" (rel err {held['loss_rel_err']:.3g}, "
            f"{held['grad_norm_rel_err']:.3g})")
        print(f"{name} rank {r}: losses "
              f"{' '.join(f'{x:.6f}' for x in rec['losses'])}, gnorms "
              f"{' '.join(f'{x:.6f}' for x in rec['grad_norms'])}{err}; "
              f"steps {' '.join(f'{x:.1f}' for x in rec['step_ms'])} ms; "
              f"{_tp_wire(rec['wire'])}; peak "
              f"{rec['peak_bytes'] / 1e9:.3f} GB; launches "
              f"{rec['launches']}")
    a, b = res[0]["train"], res[1]["train"]
    out["replicated_bit_identical"] = same = \
        a["replicated_bit_sums"] == b["replicated_bit_sums"] \
        and a["losses"] == b["losses"]
    if not same:
        fails.append(f"{name}: the ranks' unsplit leaves or losses differ")
    print(f"{name}: the {a['replicated']} unsplit leaves (of {a['leaves']}) "
          f"bit-identical on both ranks after every step: {same}")
    return out


def _oracle_line(name: str, oracle: dict) -> dict:
    print(f"{name} oracle (one process): losses "
          f"{' '.join(f'{x:.6f}' for x in oracle['losses'])}, gnorms "
          f"{' '.join(f'{x:.6f}' for x in oracle['grad_norms'])}; steps "
          f"{' '.join(f'{x:.1f}' for x in oracle['step_ms'])} ms")
    return {k: oracle[k] for k in ("losses", "grad_norms", "step_ms",
                                   "peak_bytes")}


def _fam_serve(name: str, served: dict, cfg, key: str, counts: dict,
               fails: list) -> dict:
    """``Session.serve`` of (n) or (o) at model=2: each rank's launches
    ``prefill_launches`` once a wave, the tokens in range, the first
    logits finite."""
    waves = served["waves"]
    want = {k: waves * v for k, v in prefill_launches(cfg).items()}
    for r in (0, 1):
        _want_launches(f"{name} rank {r}", counts[f"{key}_L{r}"], want,
                       fails)
    gen = torch.cat(served["generated"])
    if gen.shape != (waves * FAM_SERVE["slots"], FAM_SERVE["gen_len"] + 1) \
            or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab or \
            not bool(torch.isfinite(served["first_prefill_logits"]).all()):
        fails.append(f"{name}: tokens {tuple(gen.shape)} out of range or "
                     f"logits not finite")
    pre_ms = [1e3 * x for x in served["prefill_s"]]
    dec_ms = sorted(1e3 * x for x in served["decode_s"])
    depth = f"{cfg.n_enc_layers} + {cfg.n_layers}" \
        if cfg.family == "encdec" else f"{cfg.n_layers}"
    print(f"{name} at model=2, {depth} layers: "
          f"{served['tokens_per_s']:.1f} tok/s, {waves} waves, prefill "
          f"{' '.join(f'{x:.1f}' for x in pre_ms)} ms, decode step median "
          f"{dec_ms[len(dec_ms) // 2]:.1f} ms (min {dec_ms[0]:.1f}, max "
          f"{dec_ms[-1]:.1f}); launches a rank {counts[f'{key}_L0']} / "
          f"{counts[f'{key}_L1']}")
    wires = {0: served["wire"], 1: served["localities"][1]["wire"]}
    for r, w in wires.items():
        print(f"  {name} rank {r}: {_tp_wire(w)}")
    return {"tokens_per_s": served["tokens_per_s"], "prefill_ms": pre_ms,
            "decode_ms": dec_ms, "wire": wires}


def _fam_gateway(name: str, gw: dict, others: dict, oracle: dict, cfg,
                 key: str, counts: dict, fails: list) -> dict:
    """A gateway run of (n) or (o) at model=2 (``_mesh_gateway_checks``:
    each rank parks half of a request's batch-1 state), its
    GATEWAY_ORACLE streams against a plain greedy loop on the ranks."""
    counts[f"{key}_L0"] = gw["launches"]
    for r, rec in others.items():
        counts[f"{key}_L{r}"] = rec["launches"]
    whole = _b1_cache_bytes(cfg, FAM_GATEWAY_GEN)
    _mesh_gateway_checks(name, gw, others, cfg, whole, 2, fails)
    same = [oracle[0]["streams"][i] == gw["streams"][r]
            for i, r in enumerate(GATEWAY_ORACLE)]
    if not all(same):
        fails.append(f"{name}: oracle streams differ {same}")
    tokens = sum(len(x) - 1 for x in gw["streams"].values())
    tps = gw["tokens_per_s"] if "tokens_per_s" in gw \
        else tokens / gw["seconds"]
    print(f"{name}: {tps:.1f} tok/s, {gw['rounds']} "
          f"rounds, {gw['epochs']} epochs, {gw['commands']} commands; page "
          f"hits {gw['serve']['page_hits']}/{gw['serve']['refills']}; "
          f"parked a request {gw['request_bytes']} B a rank of {whole}; "
          f"oracle {dict(zip(GATEWAY_ORACLE, same))}; launches "
          f"{gw['launches']}; {_tp_wire(gw['wire'])}")
    return {"tokens_per_s": tps, "rounds": gw["rounds"],
            "commands": gw["commands"], "request_bytes": gw["request_bytes"],
            "wire": {0: gw["wire"], **{r: o["wire"]
                                       for r, o in others.items()}}}


def _fam_world(name: str, pids, fails: list) -> dict:
    """The session's world closed and its worker reaped, after one of
    (n)-(q)."""
    world_left = torch.distributed.is_initialized()
    reaped = _reaped(pids)
    if world_left or not reaped:
        fails.append(f"{name}: world left {world_left}, worker reaped "
                     f"{reaped}")
    return {"world_left": world_left, "reaped": reaped}


def moe_axis(counts: dict, fails: list) -> dict:
    """(n) granite-moe-1b-a400m at full width in a ``Plan(model=2)``
    session: at FAM_TP_LAYERS layers, phylanx and zero1 in float32 against
    the one-process float32 run and phylanx in bf16 (a step: K1 2 x
    layers, its backward layers, a rank), its vocab whole on both ranks;
    ``Session.serve`` and the session's gateway at MOE_TP_SERVE_LAYERS."""
    cfg = get_config("granite-moe-1b-a400m")
    L, S, SL = FAM_TP_LAYERS, FAM_TP_STEPS, MOE_TP_SERVE_LAYERS
    splan = dict(arch=cfg.name, tiny=False, model=2, device="cuda",
                 overrides={"n_layers": SL})
    scfg = Plan(**splan).config()
    phase(f"model axis, its families: (n) {cfg.name} at full width on "
          f"model=2, {cfg.n_experts // 2} of {cfg.n_experts} experts a rank: "
          f"phylanx and zero1 at {L} of {cfg.n_layers} layers, serve and "
          f"the gateway at {SL}")
    print(f"CUT (n) training to {L} of {cfg.n_layers} layers (the oracle's "
          f"float32 state beside the ranks') and {S} steps, its bf16 run to "
          f"{MOE_BF16_STEPS} steps, the session (Session.serve, the "
          f"gateway) to {SL} layers, Session.serve to one wave of "
          f"{FAM_SERVE['slots']} x {FAM_SERVE['gen_len']} tokens and the "
          f"gateway to {FAM_GATEWAY_GEN} a request: a decode step is 3 gloo "
          f"collectives a layer")
    stream = RepeatStream(stream_for(cfg, batch=MOE_TRAIN["batch"],
                                     seq=MOE_TRAIN["seq"], seed=0))
    out: dict = {}
    t0 = time.perf_counter()
    with Plan(**splan).compile() as session:
        out["up_s"] = time.perf_counter() - t0
        pids = [pr.pid for pr in session.ranks.group.procs.values()]
        t1 = time.perf_counter()
        oracles = _fam_warm_oracle(session, lambda: {
            name: tp_oracle_train(MOE_TP_F32, stream, S, name, opt)
            for name, opt in FAM_OPT.items()})
        out["oracle_s"] = time.perf_counter() - t1
        runs = {}
        for name, kw, n, opt in (
                ("phylanx f32", MOE_TP_F32, S, FAM_OPT["phylanx"]),
                ("zero1 f32", MOE_TP_F32, S, FAM_OPT["zero1"]),
                ("phylanx bf16", MOE_TP_TRAIN, MOE_BF16_STEPS, {})):
            t1 = time.perf_counter()
            runs[name] = session.run_ranks(tp_rank, {
                "plan": Plan(**kw, model=2, device="cuda"),
                "stream": stream, "steps": n,
                "strategy": name.split()[0], "opt": opt})
            out[f"{name} s"] = time.perf_counter() - t1
            torch.cuda.empty_cache()
        sp = _fam_sp_runs(session, MOE_TP_F32, MOE_TP_TRAIN, stream, stream,
                          FAM_OPT["phylanx"])
        out["sp f32 s"], out["sp bf16 s"] = sp["f32_s"], sp["bf16_s"]
        t1 = time.perf_counter()
        _zero_counts()
        served = session.serve(**FAM_SERVE)
        counts["moe_tp_serve_L0"] = _counts()
        counts["moe_tp_serve_L1"] = served["localities"][1]["launches"]
        out["serve_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        kw = dict(prompt_len=SERVE["prompt_len"], gen_len=FAM_GATEWAY_GEN,
                  slots=SERVE["slots"])
        gw = session.serve_stream(
            trace=[{"at_round": r} for r in GATEWAY_ARRIVALS],
            verbose=False, **kw)
        session._gateway = None
        gw["serve"] = gw["runtime_stats"]["serve"]
        handles = {h.rid: h for h in gw["handles"]}
        gw_oracle = session.run_ranks(gateway_oracle_rank, dict(
            kw, plan=session.plan, oracle=[
                (handles[r].prompt, handles[r]._slot)
                for r in GATEWAY_ORACLE]))
        out["gateway_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    out.update(_fam_world("(n)", pids, fails))
    out["oracle"] = {name: _oracle_line(
        f"(n) float32 {name}, {L} layers,", o) for name, o in oracles.items()}
    for name, res in runs.items():
        n = MOE_BF16_STEPS if "bf16" in name else S
        out[name] = _fam_train(
            f"(n) {name}", res, None if "bf16" in name else
            oracles[name.split()[0]],
            {"flash_attention": 2 * L * n, "flash_attention_bwd": L * n},
            f"moe_tp_{name.replace(' ', '_')}", counts, fails,
            MOE_TP_NORM_RTOL, MOE_TP_NORM_STEPS)
    out["sp"] = _fam_sp(
        "(n)", sp, oracles["phylanx"],
        {"f32": runs["phylanx f32"], "bf16": runs["phylanx bf16"],
         "bf16_steps": MOE_BF16_STEPS},
        {"flash_attention": 2 * L * S, "flash_attention_bwd": L * S},
        {"flash_attention": 2 * L * SP_BF16_STEPS,
         "flash_attention_bwd": L * SP_BF16_STEPS}, "moe_tp", counts, fails,
        {"seq": None, "enc": None}, norm_rtol=MOE_TP_NORM_RTOL,
        norm_steps=MOE_TP_NORM_STEPS)
    rows = [runs["phylanx bf16"][r]["vocab_rows"] for r in (0, 1)]
    out["vocab_rows"] = rows
    if rows != [cfg.vocab, cfg.vocab]:
        fails.append(f"(n): embedding rows a rank {rows}, want the whole "
                     f"vocab {cfg.vocab} (odd: unsplit)")
    print(f"(n) the vocab of {cfg.vocab} stays whole on both ranks (rows a "
          f"rank {rows}); the experts split: "
          f"{cfg.n_experts // 2} a rank")
    out["serve"] = _fam_serve("(n) serve", served, steps._serve_cfg(scfg),
                              "moe_tp_serve", counts, fails)
    out["gateway"] = _fam_gateway(
        f"(n) gateway, {SL} layers", gw, gw["localities"], gw_oracle, scfg,
        "moe_tp_gateway", counts, fails)
    print("(n) wall: " + ", ".join(f"{k} {v:.1f}" for k, v in out.items()
                                   if k.endswith("s") and
                                   isinstance(v, float)))
    return out


def zamba_axis(counts: dict, fails: list) -> dict:
    """(o) zamba2-2.7b at full width in a ``Plan(model=2)`` session: 40 of
    80 heads a rank.  At one group (6 mamba layers and the shared block)
    phylanx in float32 against the one-process float32 run and in bf16
    (a step: K2 3 and its backward 1 a mamba layer under the nested
    remat, K1 2 and its backward 1 a group), the prefill and
    TP_DECODE_STEPS decode steps' float32 logits against one process's;
    ``Session.serve`` at all 54 layers (K2 54 and K1 9 a prefill a rank);
    the gateway at ZAMBA_TP_GATEWAY_LAYERS."""
    cfg = get_config("zamba2-2.7b")
    heads = ZAMBA_HEADS
    tcfg = Plan(**ZAMBA_TP_TRAIN).config()
    L, S = tcfg.n_layers, FAM_TP_STEPS
    groups = L // cfg.shared_every
    GL, SL = ZAMBA_TP_GATEWAY_LAYERS, ZAMBA_TP_SERVE_LAYERS
    splan = Plan(arch=cfg.name, tiny=False, model=2, device="cuda",
                 overrides={"n_layers": SL})
    phase(f"model axis, its families: (o) {cfg.name} at full width on "
          f"model=2, {heads // 2} of {heads} heads a rank: phylanx at {L} of "
          f"{cfg.n_layers} layers, with and without sequence parallelism, "
          f"and its logits, serve {SL}, the gateway at {GL}")
    print(f"CUT (o) training and logits to {L} of {cfg.n_layers} layers (one "
          f"group), its float32 run to batch {ZAMBA_TP_F32_BATCH} and its "
          f"bf16 run to {ZAMBA_BF16_STEPS} step, Session.serve to {SL} "
          f"layers and one wave "
          f"of {FAM_SERVE['slots']} x {FAM_SERVE['gen_len']} tokens, the "
          f"gateway to {GL} layers and {FAM_GATEWAY_GEN} tokens a request: a "
          f"mamba layer's projection is gathered over gloo three times a "
          f"training step, its decode takes 4 collectives")
    stream = RepeatStream(stream_for(tcfg, batch=ZAMBA_TRAIN["batch"],
                                     seq=ZAMBA_TRAIN["seq"], seed=0))
    f32_stream = RepeatStream(stream_for(tcfg, batch=ZAMBA_TP_F32_BATCH,
                                         seq=ZAMBA_TRAIN["seq"], seed=0))
    out: dict = {}
    t0 = time.perf_counter()
    with splan.compile() as session:
        out["up_s"] = time.perf_counter() - t0
        pids = [pr.pid for pr in session.ranks.group.procs.values()]
        t1 = time.perf_counter()
        oracle, want_lg = _fam_warm_oracle(session, lambda: (
            tp_oracle_train(ZAMBA_TP_F32, f32_stream, S, "phylanx",
                            FAM_OPT["phylanx"]),
            tp_oracle_logits(ZAMBA_TP_F32)))
        out["oracle_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        f32 = session.run_ranks(tp_rank, {
            "plan": Plan(**ZAMBA_TP_F32, model=2, device="cuda"),
            "stream": f32_stream, "steps": S, "opt": FAM_OPT["phylanx"],
            "logits": {"prompts": want_lg["prompts"],
                       "tokens": want_lg["tokens"]}})
        out["f32_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        bf16 = session.run_ranks(tp_rank, {
            "plan": Plan(**ZAMBA_TP_TRAIN, model=2, device="cuda"),
            "stream": stream, "steps": ZAMBA_BF16_STEPS})
        out["bf16_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        sp = _fam_sp_runs(session, ZAMBA_TP_F32, ZAMBA_TP_TRAIN, f32_stream,
                          stream, FAM_OPT["phylanx"])
        out["sp_f32_s"], out["sp_bf16_s"] = sp["f32_s"], sp["bf16_s"]
        t1 = time.perf_counter()
        _zero_counts()
        served = session.serve(**FAM_SERVE)
        counts["zamba_tp_serve_L0"] = _counts()
        counts["zamba_tp_serve_L1"] = served["localities"][1]["launches"]
        out["serve_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        kw = dict(prompt_len=SERVE["prompt_len"], gen_len=FAM_GATEWAY_GEN,
                  slots=SERVE["slots"])
        gplan = Plan(arch=cfg.name, tiny=False, model=2, device="cuda",
                     overrides={"n_layers": GL})
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, SERVE["prompt_len"]).astype(
            np.int32) for _ in GATEWAY_ARRIVALS]
        res = session.run_ranks(
            mesh_serve.rank_serve_stream,
            dict(kw, plan=gplan, page_bytes=PAGE_BYTES, params=None),
            driver=gateway_run(session.runtime, prompts, GATEWAY_ARRIVALS,
                               kw))
        gw = res[0]
        handles = {h.rid: h for h in gw["handles"]}
        gw_oracle = session.run_ranks(gateway_oracle_rank, dict(
            kw, plan=gplan, oracle=[(handles[r].prompt, handles[r]._slot)
                                    for r in GATEWAY_ORACLE]))
        out["gateway_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    out.update(_fam_world("(o)", pids, fails))
    out["oracle"] = _oracle_line(
        f"(o) float32, {L} layers, batch {ZAMBA_TP_F32_BATCH},", oracle)

    def want(n):
        return {"flash_attention": 2 * groups * n,
                "flash_attention_bwd": groups * n,
                "mamba2_chunk_scan": 3 * L * n,
                "mamba2_chunk_scan_bwd": L * n}
    out["f32"] = _fam_train("(o) phylanx f32", f32, oracle, want(S),
                            "zamba_tp_f32", counts, fails)
    out["bf16"] = _fam_train("(o) phylanx bf16", bf16, None,
                             want(ZAMBA_BF16_STEPS), "zamba_tp_bf16",
                             counts, fails)
    out["sp"] = _fam_sp(
        "(o)", sp, oracle, {"f32": f32, "bf16": bf16,
                            "bf16_steps": ZAMBA_BF16_STEPS},
        want(S), want(SP_BF16_STEPS), "zamba_tp", counts, fails,
        {"seq": ZAMBA_TRAIN["seq"], "enc": None})
    got_lg = f32[0]["logits"]["logits"]
    lg_rel = [mean_rel_err(g, w) for g, w in zip(got_lg, want_lg["logits"])]
    if len(got_lg) != TP_DECODE_STEPS + 1 or \
            max(lg_rel) > TP_LOGIT_MEAN_REL_TOL:
        fails.append(f"(o) logits mean rel err {lg_rel}")
    for r in (0, 1):
        counts[f"zamba_tp_logits_L{r}"] = f32[r]["logits"]["launches"]
        _want_launches(f"(o) logits rank {r}", f32[r]["logits"]["launches"],
                       prefill_launches(tcfg), fails)
    print(f"(o) float32 logits, prefill then {TP_DECODE_STEPS} decode steps "
          f"at {L} layers: mean rel err "
          f"{' '.join(f'{x:.3g}' for x in lg_rel)} (tolerance "
          f"{TP_LOGIT_MEAN_REL_TOL:g}); {_tp_wire(f32[0]['logits']['wire'])}")
    out["logits"] = {"mean_rel_err": lg_rel,
                     "wire": f32[0]["logits"]["wire"]}
    out["serve"] = _fam_serve("(o) serve", served,
                              steps._serve_cfg(splan.config()),
                              "zamba_tp_serve", counts, fails)
    out["gateway"] = _fam_gateway(
        f"(o) gateway, {GL} layers", gw, {1: res[1]}, gw_oracle,
        gplan.config(), "zamba_tp_gateway", counts, fails)
    print("(o) wall: " + ", ".join(f"{k} {v:.1f}" for k, v in out.items()
                                   if k.endswith("s") and
                                   isinstance(v, float)))
    return out


def xlstm_axis(counts: dict, fails: list) -> dict:
    """(p) xlstm-350m at full width in a ``Plan(model=2)`` session: its
    mLSTM and sLSTM layers on a rank's 2 of 4 heads.  At
    XLSTM_TRAIN_LAYERS phylanx in float32 against the one-process float32
    run and in bf16, no kernel launched; ``Session.serve`` at all 24
    layers; the gateway at STREAM_LAYERS, its GATEWAY_ORACLE streams
    against a plain greedy loop on the ranks."""
    cfg = get_config("xlstm-350m")
    L, S = XLSTM_TRAIN_LAYERS, FAM_TP_STEPS
    GL, SL = STREAM_LAYERS[cfg.name], XLSTM_TP_SERVE_LAYERS
    splan = Plan(arch=cfg.name, tiny=False, model=2, device="cuda",
                 overrides={"n_layers": SL})
    phase(f"model axis, its families: (p) {cfg.name} at full width on "
          f"model=2, {cfg.n_heads // 2} of {cfg.n_heads} mLSTM heads and "
          f"{cfg.slstm_heads // 2} of {cfg.slstm_heads} sLSTM heads a rank: "
          f"phylanx at {L} of {cfg.n_layers} layers, with and without "
          f"sequence parallelism, serve {SL}, the gateway at {GL}")
    print(f"CUT (p) training to {L} of {cfg.n_layers} layers (one group: "
          f"seven mLSTM layers and the sLSTM), its float32 run to batch "
          f"{XLSTM_TP_F32_BATCH} and its bf16 run to {XLSTM_BF16_STEPS} "
          f"steps, Session.serve to {SL} layers and one wave of "
          f"{FAM_SERVE['slots']} x "
          f"{FAM_SERVE['gen_len']} tokens, the gateway to {GL} layers and "
          f"{FAM_GATEWAY_GEN} tokens a request: an mLSTM layer "
          f"reduce-scatters its q, k, v and gates over gloo")
    stream = RepeatStream(stream_for(cfg, batch=XLSTM_TRAIN["batch"],
                                     seq=XLSTM_TRAIN["seq"], seed=0))
    f32_stream = RepeatStream(stream_for(cfg, batch=XLSTM_TP_F32_BATCH,
                                         seq=XLSTM_TRAIN["seq"], seed=0))
    out: dict = {}
    t0 = time.perf_counter()
    with splan.compile() as session:
        out["up_s"] = time.perf_counter() - t0
        pids = [pr.pid for pr in session.ranks.group.procs.values()]
        t1 = time.perf_counter()
        oracle = _fam_warm_oracle(session, lambda: tp_oracle_train(
            XLSTM_TP_F32, f32_stream, S, "phylanx", FAM_OPT["phylanx"]))
        out["oracle_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        f32 = session.run_ranks(tp_rank, {
            "plan": Plan(**XLSTM_TP_F32, model=2, device="cuda"),
            "stream": f32_stream, "steps": S, "opt": FAM_OPT["phylanx"]})
        out["f32_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        bf16 = session.run_ranks(tp_rank, {
            "plan": Plan(**XLSTM_TRAIN, model=2, device="cuda"),
            "stream": stream, "steps": XLSTM_BF16_STEPS})
        out["bf16_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        sp = _fam_sp_runs(session, XLSTM_TP_F32, XLSTM_TRAIN, f32_stream,
                          stream, FAM_OPT["phylanx"])
        out["sp_f32_s"], out["sp_bf16_s"] = sp["f32_s"], sp["bf16_s"]
        t1 = time.perf_counter()
        _zero_counts()
        served = session.serve(**FAM_SERVE)
        counts["xlstm_tp_serve_L0"] = _counts()
        counts["xlstm_tp_serve_L1"] = served["localities"][1]["launches"]
        out["serve_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        kw = dict(prompt_len=SERVE["prompt_len"], gen_len=FAM_GATEWAY_GEN,
                  slots=SERVE["slots"])
        gplan = Plan(arch=cfg.name, tiny=False, model=2, device="cuda",
                     overrides={"n_layers": GL})
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, SERVE["prompt_len"]).astype(
            np.int32) for _ in GATEWAY_ARRIVALS]
        res = session.run_ranks(
            mesh_serve.rank_serve_stream,
            dict(kw, plan=gplan, page_bytes=PAGE_BYTES, params=None),
            driver=gateway_run(session.runtime, prompts, GATEWAY_ARRIVALS,
                               kw))
        gw = res[0]
        handles = {h.rid: h for h in gw["handles"]}
        gw_oracle = session.run_ranks(gateway_oracle_rank, dict(
            kw, plan=gplan, oracle=[(handles[r].prompt, handles[r]._slot)
                                    for r in GATEWAY_ORACLE]))
        out["gateway_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    out.update(_fam_world("(p)", pids, fails))
    out["oracle"] = _oracle_line(
        f"(p) float32, {L} layers, batch {XLSTM_TP_F32_BATCH},", oracle)
    none = {}
    out["f32"] = _fam_train("(p) phylanx f32", f32, oracle, none,
                            "xlstm_tp_f32", counts, fails)
    out["bf16"] = _fam_train("(p) phylanx bf16", bf16, None, none,
                             "xlstm_tp_bf16", counts, fails)
    out["sp"] = _fam_sp(
        "(p)", sp, oracle, {"f32": f32, "bf16": bf16,
                            "bf16_steps": XLSTM_BF16_STEPS},
        none, none, "xlstm_tp", counts, fails,
        {"seq": XLSTM_TRAIN["seq"], "enc": None})
    out["serve"] = _fam_serve("(p) serve", served,
                              steps._serve_cfg(splan.config()),
                              "xlstm_tp_serve", counts, fails)
    out["gateway"] = _fam_gateway(
        f"(p) gateway, {GL} layers", gw, {1: res[1]}, gw_oracle,
        gplan.config(), "xlstm_tp_gateway", counts, fails)
    print("(p) wall: " + ", ".join(f"{k} {v:.1f}" for k, v in out.items()
                                   if k.endswith("s") and
                                   isinstance(v, float)))
    return out


def whisper_self_order() -> dict:
    """One float32 step of WHISPER_TP_F32 in one process from the
    reference's init, at the whole batch and in two micro-batches
    (``grad_accum=2``: the same math, other orders of float32 sums), then
    the same two with every ``wq`` times WHISPER_WQ_SCALE: each pair's
    first loss and gradient norm, and their relative differences."""
    plan = Plan(**WHISPER_TP_F32, device="cuda")
    cfg = plan.config()
    batch = to_device(stream_for(cfg, batch=WHISPER_TP_F32_BATCH,
                                 seq=WHISPER_TRAIN["seq"],
                                 seed=0).batch_at(0), "cuda")
    out = {}
    for scale in (None, WHISPER_WQ_SCALE):
        got = []
        for accum in (1, 2):
            step = steps.make_train_step(cfg, steps.Strategy(
                grad_accum=accum, opt=optimizers.OptConfig(
                    **FAM_OPT["phylanx"])), plan=plan)
            params, opt = step.init(
                torch.Generator(device="cuda").manual_seed(plan.seed),
                "cuda")
            scale_wq(params, scale)
            m, params, opt = step.fn(params, opt, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
            del step, params, opt
            torch.cuda.empty_cache()
        (l1, n1), (l2, n2) = got
        key = "reference init" if scale is None else f"wq x {scale:g}"
        out[key] = {"whole": got[0], "two_micro_batches": got[1],
                    "loss_rel": abs(l2 - l1) / abs(l1),
                    "grad_norm_rel": abs(n2 - n1) / abs(n1)}
        print(f"(q) one process against itself in two micro-batches, "
              f"{key}: loss {l1:.6f} / {l2:.6f} (rel "
              f"{out[key]['loss_rel']:.3g}), gnorm {n1:.6g} / {n2:.6g} "
              f"(rel {out[key]['grad_norm_rel']:.3g})")
    return out


def whisper_axis(counts: dict, fails: list) -> dict:
    """(q) whisper-medium at full width in a ``Plan(model=2)`` session: 8
    of 16 heads a rank in the encoder, the decoder and the
    cross-attention, its odd vocab whole on both ranks.  At
    WHISPER_CUT_ENC_LAYERS encoder and WHISPER_TP_DEC_LAYERS decoder
    layers phylanx in float32 against the one-process float32 run (K1's
    float32 kernels) and in bf16 (a step: K1 twice a layer, its backward
    once, a rank); ``Session.serve`` at all 24 + 24 layers (K1 once a
    layer a prefill a rank).  ``serve_stream`` refuses the family, as the
    reference does (``check_stream_refused``)."""
    cfg = get_config("whisper-medium")
    tcfg = Plan(**WHISPER_TP_TRAIN).config()
    S, SL = FAM_TP_STEPS, WHISPER_TP_SERVE_LAYERS
    splan = Plan(arch=cfg.name, tiny=False, model=2, device="cuda",
                 overrides={"n_layers": SL, "n_enc_layers": SL})
    phase(f"model axis, its families: (q) {cfg.name} at full width on "
          f"model=2, {cfg.n_heads // 2} of {cfg.n_heads} heads a rank: "
          f"phylanx at {tcfg.n_enc_layers} + {tcfg.n_layers} of "
          f"{cfg.n_enc_layers} + {cfg.n_layers} layers, with and without "
          f"sequence parallelism, serve {SL} + {SL}")
    print(f"CUT (q) training to {tcfg.n_enc_layers} of {cfg.n_enc_layers} "
          f"encoder layers (the reference's init overflows the float32 "
          f"gradient norm past them) and {tcfg.n_layers} of {cfg.n_layers} "
          f"decoder layers, its float32 run to batch {WHISPER_TP_F32_BATCH} "
          f"(every wq x {WHISPER_WQ_SCALE:g}: the reference's init saturates "
          f"the softmax) and its bf16 run to {WHISPER_BF16_STEPS} step, "
          f"Session.serve to {SL} + {SL} layers and one wave of "
          f"{FAM_SERVE['slots']} x "
          f"{FAM_SERVE['gen_len']} tokens")
    stream = RepeatStream(stream_for(tcfg, batch=WHISPER_TRAIN["batch"],
                                     seq=WHISPER_TRAIN["seq"], seed=0))
    f32_stream = RepeatStream(stream_for(tcfg, batch=WHISPER_TP_F32_BATCH,
                                         seq=WHISPER_TRAIN["seq"], seed=0))
    out: dict = {}
    t0 = time.perf_counter()
    with splan.compile() as session:
        out["up_s"] = time.perf_counter() - t0
        pids = [pr.pid for pr in session.ranks.group.procs.values()]
        t1 = time.perf_counter()
        oracle, self_order = _fam_warm_oracle(session, lambda: (
            tp_oracle_train(WHISPER_TP_F32, f32_stream, S, "phylanx",
                            FAM_OPT["phylanx"], WHISPER_WQ_SCALE),
            whisper_self_order()))
        out["oracle_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        f32 = session.run_ranks(tp_rank, {
            "plan": Plan(**WHISPER_TP_F32, model=2, device="cuda"),
            "stream": f32_stream, "steps": S, "opt": FAM_OPT["phylanx"],
            "wq_scale": WHISPER_WQ_SCALE})
        out["f32_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        bf16 = session.run_ranks(tp_rank, {
            "plan": Plan(**WHISPER_TP_TRAIN, model=2, device="cuda"),
            "stream": stream, "steps": WHISPER_BF16_STEPS})
        out["bf16_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        sp = _fam_sp_runs(session, WHISPER_TP_F32, WHISPER_TP_TRAIN,
                          f32_stream, stream, FAM_OPT["phylanx"],
                          WHISPER_WQ_SCALE)
        out["sp_f32_s"], out["sp_bf16_s"] = sp["f32_s"], sp["bf16_s"]
        t1 = time.perf_counter()
        _zero_counts()
        served = session.serve(**FAM_SERVE)
        counts["whisper_tp_serve_L0"] = _counts()
        counts["whisper_tp_serve_L1"] = served["localities"][1]["launches"]
        out["serve_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    out.update(_fam_world("(q)", pids, fails))
    out["oracle"] = _oracle_line(
        f"(q) float32, {tcfg.n_enc_layers} + {tcfg.n_layers} layers, batch "
        f"{WHISPER_TP_F32_BATCH}, wq x {WHISPER_WQ_SCALE:g},", oracle)
    out["self_order"] = self_order
    out["f32"] = _fam_train("(q) phylanx f32", f32, oracle,
                            train_launches(tcfg, S, 1, 0), "whisper_tp_f32",
                            counts, fails)
    out["bf16"] = _fam_train("(q) phylanx bf16", bf16, None,
                             train_launches(tcfg, WHISPER_BF16_STEPS, 1, 0),
                             "whisper_tp_bf16", counts, fails)
    out["sp"] = _fam_sp(
        "(q)", sp, oracle, {"f32": f32, "bf16": bf16,
                            "bf16_steps": WHISPER_BF16_STEPS},
        train_launches(tcfg, S, 1, 0),
        train_launches(tcfg, SP_BF16_STEPS, 1, 0), "whisper_tp", counts,
        fails, {"seq": None, "enc": True})
    rows = [bf16[r]["vocab_rows"] for r in (0, 1)]
    out["vocab_rows"] = rows
    if rows != [cfg.vocab, cfg.vocab]:
        fails.append(f"(q): embedding rows a rank {rows}, want the whole "
                     f"vocab {cfg.vocab} (odd: unsplit)")
    print(f"(q) the vocab of {cfg.vocab} stays whole on both ranks (rows a "
          f"rank {rows}); the heads split: {cfg.n_heads // 2} a rank")
    out["serve"] = _fam_serve("(q) serve", served,
                              steps._serve_cfg(splan.config()),
                              "whisper_tp_serve", counts, fails)
    print("(q) wall: " + ", ".join(f"{k} {v:.1f}" for k, v in out.items()
                                   if k.endswith("s") and
                                   isinstance(v, float)))
    return out


def model_axis_families() -> tuple[dict, dict]:
    """The model axis beyond the dense family (ROADMAP item 14b, part 4):
    (n) ``moe_axis``, (o) ``zamba_axis``, (p) ``xlstm_axis`` and (q)
    ``whisper_axis``, each in its own ``Plan(model=2)`` session on the
    one card.  Returns the counts by run and the readings.

    Raises:
        AssertionError: any check of any of them failed (after all ran).
    """
    counts: dict = {}
    fails: list = []
    readings = {"n": moe_axis(counts, fails), "o": zamba_axis(counts, fails),
                "p": xlstm_axis(counts, fails),
                "q": whisper_axis(counts, fails)}
    if fails:
        raise AssertionError("model axis, its families: " + "; ".join(fails))
    return counts, readings


def check_reference(arch: str, prompt_len: int = 20, gen_len: int = 8,
                    slots: int = 2, tol: float = 1e-4, scaled: bool = False):
    """Greedy serve of a tiny config on the card against the same
    parameters on the CPU: identical tokens, logits within ``tol`` (with
    ``scaled``, within ``tol`` times the logits' largest magnitude).  The
    enc-dec family gets seeded numpy frames."""
    cfg = get_config(arch, tiny=True)
    shape = {"seq_len": prompt_len + gen_len, "global_batch": slots}
    pre = steps.make_prefill_step(cfg, shape)
    dec = steps.make_decode_step(cfg, shape)
    p_cpu = init_params(pre.specs, torch.Generator().manual_seed(0), "cpu")
    p_gpu = pytree.tree_map(lambda t: t.to("cuda"), p_cpu)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (slots, prompt_len))
    batch = {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy((0.5 * rng.standard_normal(
            (slots, cfg.enc_frames, cfg.d_model))).astype(np.float32))
    runs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, cache = pre.fn(params, {k: v.to(dev) for k, v in batch.items()})
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
    the step's bound (``step_bound``).  The enc-dec prefill encodes zero
    frames, as ``Session.serve`` does.  Returns the prefill's and the
    decode step's kernels (``profile_one``; the latter None without
    ``decode``)."""
    shape = {"seq_len": prompt_len + 1, "global_batch": slots}
    pre = steps.make_prefill_step(cfg, shape)
    dec = steps.make_decode_step(cfg, shape)
    params = init_params(pre.specs,
                         torch.Generator(device="cuda").manual_seed(1), "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab, (slots, prompt_len),
                                     device="cuda")}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((slots, cfg.enc_frames, cfg.d_model),
                                      dtype=cfg.c_dtype, device="cuda")
    lg, cache = pre.fn(params, batch)
    tok = lg.argmax(-1)[:, None]
    runs = ((f"prefill, batch {slots}", lambda: pre.fn(params, batch),
             step_bound(cfg, params, cache, slots, prompt_len,
                        prompt_len * (prompt_len + 1) // 2, encode=True)),
            ("decode step", lambda: dec.fn(params, cache, {"tokens": tok},
                                           prompt_len),
             step_bound(cfg, params, cache, slots, 1, prompt_len + 1)))
    kernels = [profile_one(name, fn, bound)
               for name, fn, bound in runs[:2 if decode else 1]]
    return kernels[0], (kernels[1] if decode else None)


def _zero_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def prefill_launches(cfg) -> dict:
    """Each kernel's launches in one prefill of ``cfg`` (any batch): K1
    once per attention layer (zamba's shared block once per group; the
    enc-dec encoder's and decoder's layers), K2 once per mamba layer,
    nothing else; xlstm-350m runs no kernel (the JAX package has none for
    its mixers)."""
    k1 = {"dense": cfg.n_layers, "moe": cfg.n_layers, "xlstm": 0,
          "zamba": cfg.n_layers // cfg.shared_every,
          "encdec": cfg.n_enc_layers + cfg.n_layers}[cfg.family]
    return {"flash_attention": k1,
            "mamba2_chunk_scan": cfg.n_layers if cfg.family == "zamba" else 0,
            "flash_attention_bwd": 0, "mamba2_chunk_scan_bwd": 0,
            "onebit_quantize": 0, "onebit_dequantize": 0}


def xlstm_request_bytes(cfg) -> int:
    """The bytes of one request's decode state, from the config: per mLSTM
    layer C [H, P, P], n [H, P], m [H] in float32 and the conv state [K-1,
    d_in] in the cache dtype; per sLSTM layer h, c, n [H_s, D/H_s] and m
    [H_s] in float32."""
    H = cfg.n_heads
    d_in = cfg.expand * cfg.d_model
    P = d_in // H
    groups = cfg.n_layers // cfg.slstm_every
    mlstm = 4 * (H * P * P + H * P + H) \
        + (cfg.ssm_d_conv - 1) * d_in * cfg.cache_dtype.itemsize
    slstm = 4 * (3 * cfg.d_model + cfg.slstm_heads)
    return groups * ((cfg.slstm_every - 1) * mlstm + slstm)


#: each serve phase's generated tokens, by arch (the model-axis phase
#: counts how many of qwen3-4b's its own serve reproduces)
SERVE_TOKENS: dict = {}


def serve_full(arch: str) -> dict:
    """``Session.serve`` of ``arch`` at full width and depth (random
    weights, seed 0), with every kernel launch count set to 0 just before
    and read just after; checks the counts against the layers the path
    runs (``prefill_launches`` once per wave), the decode nodes, the token
    range and finite prefill logits.  Returns the counts."""
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
    for name, per_wave in prefill_launches(cfg).items():
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
    SERVE_TOKENS[arch] = gen
    return counts


def check_stream_refused(arch: str) -> None:
    """``serve_stream`` of ``arch`` raises the reference's ``ValueError``
    (its decoder's position embedding takes one scalar position for the
    batch; ``src/repro/frontend/plan.py``) before it builds anything."""
    phase(f"serve_stream {arch}: refused, as in the reference")
    with Plan(arch=arch, tiny=False, device="cuda").compile() as session:
        try:
            session.serve_stream(trace=[{"at_round": 0}], **{
                k: SERVE[k] for k in ("prompt_len", "gen_len", "slots")})
        except ValueError as e:
            if "serve_stream does not support encdec" not in str(e):
                raise
            print(f"ValueError: {e}")
        else:
            raise AssertionError(f"{arch}: serve_stream did not refuse")


def check_xlstm_rollout() -> None:
    """xlstm-350m at full width and depth on the card in float32 (random
    weights, seed 0): the chunked prefill of an ``XLSTM_ROLLOUT``-token
    prompt in chunks of ``XLSTM_CHUNK`` against ``decode_step`` run over
    the same tokens from a zero state, the last token's logits within
    ``XLSTM_RTOL``/``XLSTM_ATOL`` (the reference's chunked-against-stepwise
    tolerance), and the final recurrent states likewise.  The family has
    no kernel to hold against its plain version: this holds the chunked
    form against the recurrence it must equal."""
    phase(f"xlstm-350m at full width, float32: chunked prefill of "
          f"{XLSTM_ROLLOUT} tokens against a decode-step rollout")
    cfg = Plan(arch="xlstm-350m", tiny=False, device="cuda", overrides=dict(
        compute_dtype="f32", cache_dtype_str="f32",
        ssm_chunk=XLSTM_CHUNK)).config()
    model = build_model(cfg)
    params = init_params(model.specs(),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, XLSTM_ROLLOUT))).to("cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, {"tokens": toks}, XLSTM_ROLLOUT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = init_params(model.cache_specs(1, XLSTM_ROLLOUT), None, "cuda")
        for t in range(XLSTM_ROLLOUT):
            step_lg, state = model.decode_step(
                params, state, {"tokens": toks[:, t:t + 1]}, t)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    def excess(a, b) -> float:
        """How far ``a`` lies beyond ``XLSTM_RTOL`` of ``b``, in units of
        b's scale (at least 1): within tolerance when at most
        ``XLSTM_ATOL``."""
        return (((a - b).abs() - XLSTM_RTOL * b.abs()).max()
                / max(1.0, b.abs().max().item())).item()
    worst = {"logits": excess(lg, step_lg)}
    for i, (a, b) in enumerate(zip(pytree.tree_leaves(cache),
                                   pytree.tree_leaves(state))):
        worst[f"state {i}"] = excess(a, b)
    name = max(worst, key=worst.get)
    print(f"{cfg.n_layers} layers, d_model {cfg.d_model}: prefill "
          f"{1e3 * (t1 - t0):.1f} ms, rollout {1e3 * (t2 - t1):.1f} ms; "
          f"last-token logits max abs err "
          f"{(lg - step_lg).abs().max().item():.3g} (largest "
          f"{step_lg.abs().max().item():.3g}); beyond rtol {XLSTM_RTOL:g}: "
          f"logits {worst['logits']:.3g}, worst of {len(worst)} leaves "
          f"{worst[name]:.3g} ({name}) of their scale (tolerance "
          f"{XLSTM_ATOL:g})")
    if worst[name] > XLSTM_ATOL or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"xlstm-350m: the chunked prefill and the "
                             f"rollout part: {name} {worst[name]}")
    del params, cache, state
    torch.cuda.empty_cache()


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
    """``Session.serve_stream`` of ``arch`` at full width, cut to
    ``STREAM_LAYERS`` (random weights, seed 0): 8 requests of
    ``STREAM_GEN`` tokens arriving at ``GATEWAY_ARRIVALS``, with
    every kernel launch count set to 0 just before and read just after.
    Checks completion, the paged-cache counters (every refill a page hit,
    no prefill recompute, every page reclaimed, the parked bytes those of
    the batch-1 cache), the token range, the launch counts (K1 once per
    attention layer and request, K2 once per mamba layer and request,
    nothing else), the streams of ``GATEWAY_ORACLE`` against
    ``gateway_oracle``, two replicas and the replica-death drill against
    one replica (same streams, same launches: prefill never reruns), and
    for qwen3-4b a live ``RequestQueue`` fed from another thread.  Returns
    (the single-replica run's counts, its readings).  For xlstm-350m the
    parked bytes are also held to ``xlstm_request_bytes``."""
    plan = Plan(arch=arch, tiny=False, device="cuda",
                overrides={"n_layers": STREAM_LAYERS[arch]})
    cfg = plan.config()
    phase(f"serve_stream {arch}, full width, {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers, random weights (seed 0)")
    n = len(GATEWAY_ARRIVALS)
    trace = [{"at_round": r} for r in GATEWAY_ARRIVALS]
    gen = STREAM_GEN          # tokens a request
    kw = dict(prompt_len=SERVE["prompt_len"], gen_len=gen,
              slots=SERVE["slots"])
    per_request = prefill_launches(cfg)

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
        pre1 = session._serve_steps_for(SERVE["prompt_len"], gen, 1)[0]
        leaves = pytree.tree_leaves(pre1.cache_specs, is_leaf=is_spec)
        nbytes = sum(sp.size * sp.dtype.itemsize for sp in leaves)
        pages = -(-nbytes // PAGE_BYTES)
        if cfg.family == "xlstm" and nbytes != xlstm_request_bytes(
                pre1.model.cfg):
            raise AssertionError(f"{arch}: a request parks {nbytes} B, the "
                                 f"config gives {xlstm_request_bytes(cfg)}")
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
                and all(len(s) == gen + 1
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
        STREAMS[arch] = (res["streams"], [h.prompt for h in res["handles"]])
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
            t0, wall = time.perf_counter(), time.time()
            fut = save(mgr, step, tree, **kw)
            rec = {"step": step, "host_s": time.perf_counter() - t0,
                   "wall": wall}
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
        layers = min(cfg.n_layers, CKPT_DRILL_LAYERS)
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
              f"model is about {est / 1e9:.1f} GB; CUT to {layers} of "
              f"{cfg.n_layers} layers (at most {CKPT_DRILL_LAYERS}, for the "
              f"time limit"
              + (", and fewer to fit two on the disk)"
                 if layers < CKPT_DRILL_LAYERS else ")"))
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

    if sys.argv[1:] == ["--plant-k1-fault"]:
        phase("K1 with a planted fault against the check")
        print(json.dumps({"plant_k1_fault": check_plant_k1_fault(
            torch.Generator(device="cuda").manual_seed(0))}))
        return 0
    if sys.argv[1:2] == ["--ddp2-repeat"] and len(sys.argv) == 3:
        # the 2-locality fp32 DDP run again and again, with the host's
        # memory (the worker's included) after every step, each held to
        # the 1-locality run
        ddp_two_localities(((1, "fp32", DDP2_FP32_STEPS),)
                           + ((2, "fp32", DDP2_FP32_STEPS),)
                           * int(sys.argv[2]))
        print_phase_times()
        return 0
    if sys.argv[1:] == ["--mesh-only"]:
        # the mesh phase alone (its readings, no kernels line)
        _, mesh = mesh_training()
        print(json.dumps({"mesh_training": mesh}))
        print_phase_times()
        return 0
    if sys.argv[1:] == ["--slice21-only"]:
        # the mesh phase (the oracles), then (r), (s) and (t), after K1 at
        # their shapes (their readings, no kernels line)
        phase("K1 at (r)'s, (s)'s and (t)'s shapes against its plain "
              "version")
        check_kernels(torch.Generator(device="cuda").manual_seed(0),
                      [S21_DDP_ATTN, S21_MESH_ATTN], 0)
        check_fa_bwd(torch.Generator(device="cuda").manual_seed(0),
                     [S21_DDP_ATTN, S21_MESH_ATTN], 0)
        mesh_training()
        s21 = slice21()
        s21.pop("counts")
        print(json.dumps({"slice21": s21}))
        print_phase_times()
        return 0
    if sys.argv[1:] == ["--model-axis-only"]:
        # the model-axis phase alone, serving over a mesh included, after
        # K1 at its sharded shapes and the one-process qwen3-4b serve
        # whose tokens it counts (its readings, no kernels line)
        phase("K1 and K2 at the model axis's shapes against their plain "
              "versions")
        check_kernels(torch.Generator(device="cuda").manual_seed(0),
                      FA_CASES[13:28], 15)
        check_fa_bwd(torch.Generator(device="cuda").manual_seed(0),
                     FA_BWD_CASES[8:15], 7)
        check_scan(torch.Generator(device="cuda").manual_seed(0),
                   SCAN_CASES[4:7], 3)
        check_scan_bwd(torch.Generator(device="cuda").manual_seed(0),
                       SCAN_BWD_CASES[1:2], 1)
        serve_full("qwen3-4b")
        _, tp = model_axis()
        print(json.dumps({"model_axis": tp}))
        _, fam = model_axis_families()
        print(json.dumps({"model_axis_families": fam}))
        print_phase_times()
        return 0
    if sys.argv[1:]:
        print(f"unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

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
    # xlstm-350m runs no kernel, whisper-medium K1 (f32: the CUDA-core
    # kernel) in its encoder and decoder: float32 sums in other orders,
    # held as zamba is
    check_reference("xlstm-350m", scaled=True)
    check_reference("whisper-medium", scaled=True)
    check_xlstm_rollout()
    check_train_reference()
    phase("reference: zamba2-2.7b's gradients, kernels against their plain "
          "versions on the card")
    check_zamba_grads()

    launches = {arch: serve_full(arch) for arch in SERVE_ARCHS}
    stream_readings = {}
    for arch in STREAM_ARCHS:
        launches[f"serve_stream_{arch}"], stream_readings[arch] = \
            serve_stream_full(arch)
    for arch in sorted(set(SERVE_ARCHS) - set(STREAM_ARCHS)):
        check_stream_refused(arch)
    launches["train"] = train_full(TRAIN, False, len(buckets))
    launches["ddp_onebit"] = train_full(TRAIN, True, len(buckets))
    launches["train_zamba"] = train_full(ZAMBA_TRAIN, False, 0)
    launches["train_moe"] = train_full(MOE_TRAIN, False, 0)
    launches["ckpt_resume"], ckpt_readings = checkpoint_drill(MOE_TRAIN)
    phase("HAR CNN (the paper's Fig. 1 model) at minibatch 8000")
    har = check_har_cnn()
    # the xlstm and enc-dec families, each run's step FAMILY_PROFILE_AT
    # profiled (where the time goes, and the kernels by name)
    launches["train_xlstm"] = train_full(XLSTM_TRAIN, False, 0,
                                         FAMILY_TRAIN_STEPS,
                                         FAMILY_PROFILE_AT)
    check_no_kernel("xlstm-350m train step",
                    STEP_PROFILES["xlstm-350m"]["by_name"])
    # whisper-medium at full depth (launch counts and the profile), where
    # the float32 norm overflows, then at the encoder depth where it trains
    k = WHISPER_CUT_ENC_LAYERS
    phase(f"whisper-medium's gradient norm from the reference's init at "
          f"{_WHISPER_CFG.n_enc_layers}, {k} and {k + 1} encoder layers")
    grad_scale = whisper_grad_scale(WHISPER_TRAIN)
    cut_scale = whisper_grad_scale(WHISPER_TRAIN_CUT)
    past_scale = whisper_grad_scale(
        dict(WHISPER_TRAIN, overrides={"n_enc_layers": k + 1}))
    if cut_scale["overflows"] or not past_scale["overflows"]:
        raise AssertionError(f"want whisper-medium's float32 gradient norm "
                             f"finite at {k} encoder layers and overflowing "
                             f"at {k + 1}")
    launches["train_whisper"] = train_full(
        WHISPER_TRAIN, False, 0, FAMILY_TRAIN_STEPS, FAMILY_PROFILE_AT,
        frozen=grad_scale["overflows"])
    kernels = STEP_PROFILES["whisper-medium"]["by_name"]
    busy = STEP_PROFILES["whisper-medium"]["device_busy_ms"]
    check_k1_route("whisper-medium train step", kernels,
                   ("forward", "dkdv", "dq"))
    want = train_launches(Plan(**WHISPER_TRAIN).config(), 1, 1, 0)
    check_k1_train_launches("whisper-medium train step", kernels,
                            STEP_PROFILES["whisper-medium"]["launched"],
                            want["flash_attention"],
                            want["flash_attention_bwd"])
    launches["train_whisper_cut"] = train_full(WHISPER_TRAIN_CUT, False, 0,
                                               FAMILY_TRAIN_STEPS)
    cross = cross_attention_step_ms(WHISPER_TRAIN)
    cross["share_of_step"] = cross["step_ms"] / busy
    print(f"whisper-medium's cross-attention: {cross['step_ms']:.3f} ms of "
          f"the step's {busy:.3f} ms of device busy "
          f"({cross['share_of_step']:.3f})")
    ddp2_launches, ddp2 = ddp_two_localities()
    launches.update(ddp2_launches)
    gw2_launches, gateway_2loc = gateway_two_localities()
    launches.update(gw2_launches)
    launches["ckpt_2loc_resume"], ckpt_2loc, oracle = \
        checkpoint_two_localities()
    spmd_launches, spmd = spmd_two_localities(oracle)
    launches.update(spmd_launches)
    del oracle
    launches["elastic_join"], elastic = elastic_join()
    mesh_launches, mesh = mesh_training()
    launches.update(mesh_launches)
    s21 = slice21()
    launches.update(s21.pop("counts"))
    tp_launches, tp = model_axis()
    launches.update(tp_launches)
    fam_launches, fam = model_axis_families()
    launches.update(fam_launches)

    for arch in SERVE_ARCHS:
        scfg = steps._serve_cfg(get_config(arch))
        if arch in PROFILE_LAYERS:
            scfg = dataclasses.replace(scfg, n_layers=PROFILE_LAYERS[arch])
        depth = ("" if arch not in PROFILE_LAYERS else
                 f" ({scfg.n_layers} of {get_config(arch).n_layers} layers)")
        batches = (SERVE["slots"],) if arch not in STREAM_ARCHS \
            else (SERVE["slots"], 1)
        phase(f"where the time goes: {arch}{depth}, one prefill at batch "
              f"{' and at batch '.join(map(str, batches))}, one decode "
              f"step (not counted)")
        for slots in batches:
            kernels, dec_kernels = profile_steps(
                scfg, slots, SERVE["prompt_len"], decode=slots > 1)
            name = f"{arch} prefill, batch {slots}"
            if scfg.family == "xlstm":
                check_no_kernel(name, kernels)
                if dec_kernels is not None:
                    check_no_kernel(f"{arch} decode step", dec_kernels)
                continue
            check_k1_route(name, kernels, ("forward",))
            if scfg.family == "encdec":
                check_k1_launches(name, kernels,
                                  PROFILES[f"prefill, batch {slots}"]
                                  ["launched"],
                                  prefill_launches(scfg)["flash_attention"])
            if arch == "zamba2-2.7b":
                check_ran(name, kernels, K2_TC, K2_F32)
    phase("where the time goes: one full-width train step, qwen3-4b plain "
          "and world-1 DDP onebit, zamba2-2.7b and granite-moe-1b-a400m "
          f"plain, at {', '.join(map(str, PROFILE_TRAIN_LAYERS.values()))} "
          f"layers (not counted)")
    for train, ddp in ((TRAIN, False), (TRAIN, True), (ZAMBA_TRAIN, False),
                       (MOE_TRAIN, False)):
        name = (f"{train['arch']} "
                f"{'DDP train step' if ddp else 'train step'}")
        kernels = profile_train(dict(train, overrides={
            "n_layers": PROFILE_TRAIN_LAYERS[train["arch"]]}), ddp)
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
    print(json.dumps({"mesh_training": mesh}))
    print(json.dumps({"slice21": s21}))
    print(json.dumps({"model_axis": tp}))
    print(json.dumps({"model_axis_families": fam}))
    print(json.dumps({"gateway_two_localities": gateway_2loc,
                      "checkpoint_two_localities": ckpt_2loc,
                      "spmd_two_localities": spmd,
                      "elastic_join": elastic}))
    print(json.dumps({"ddp_two_localities": ddp2,
                      "whisper_cross_attention": cross,
                      "whisper_grad_scale": {
                          "full": grad_scale, "cut": cut_scale,
                          "cut_plus_one": past_scale},
                      "profiles": PROFILES}))
    print_phase_times()
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
    fa_whisper_enc = {f"whisper_enc_{k}": v for k, v in fa[9].items()}
    fa_whisper_dec = {f"whisper_dec_{k}": v for k, v in fa[10].items()}
    fa_whisper_train_enc = {f"whisper_train_enc_{k}": v
                            for k, v in fa[11].items()}
    fa_whisper_train_dec = {f"whisper_train_dec_{k}": v
                            for k, v in fa[12].items()}
    fa_tp_serve = {f"tp_serve_{k}": v for k, v in fa[13].items()}
    fa_tp_train = {f"tp_train_{k}": v for k, v in fa[14].items()}
    fa_tp_b1 = {f"tp_serve_b1_{k}": v for k, v in fa[15].items()}
    fa_fam = {f"{name}_{k}": v for i, name in enumerate((
        "moe_tp_serve", "moe_tp_train", "moe_tp_serve_b1", "zamba_tp_serve",
        "zamba_tp_train", "zamba_tp_serve_b1", "whisper_tp_enc",
        "whisper_tp_dec", "whisper_tp_train_enc", "whisper_tp_train_dec",
        "whisper_tp_f32_enc", "whisper_tp_f32_dec"), 16)
        for k, v in fa[i].items()}
    bwd_b8 = {f"train_b8_{k}": v for k, v in fa_bwd[1].items()}
    bwd_d80 = {f"zamba_train_{k}": v for k, v in fa_bwd[2].items()}
    bwd_d96 = {f"phi3_d96_{k}": v for k, v in fa_bwd[3].items()}
    bwd_moe = {f"moe_train_{k}": v for k, v in fa_bwd[4].items()}
    bwd_whisper = {f"whisper_enc_{k}": v for k, v in fa_bwd[5].items()}
    bwd_whisper_train_enc = {f"whisper_train_enc_{k}": v
                             for k, v in fa_bwd[6].items()}
    bwd_whisper_train_dec = {f"whisper_train_dec_{k}": v
                             for k, v in fa_bwd[7].items()}
    bwd_tp_train = {f"tp_train_{k}": v for k, v in fa_bwd[8].items()}
    bwd_fam = {f"{name}_{k}": v for i, name in enumerate((
        "moe_tp_train", "zamba_tp_train", "whisper_tp_train_enc",
        "whisper_tp_train_dec", "whisper_tp_f32_enc", "whisper_tp_f32_dec"),
        9) for k, v in fa_bwd[i].items()}
    largest = {k[len("largest_bucket_"):]: v for k, v in onebit.items()
               if k.startswith("largest_bucket_")}
    print(json.dumps({"kernels": [
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:86", fa[0], **fa_zamba,
              **fa_b8, **fa_zamba_b8, **fa_b1, **fa_zamba_b1, **fa_moe,
              **fa_moe_b1, **fa_moe_b8, **fa_whisper_enc, **fa_whisper_dec,
              **fa_whisper_train_enc, **fa_whisper_train_dec, **fa_tp_serve,
              **fa_tp_train, **fa_tp_b1, **fa_fam),
        entry("flash_attention_bwd",
              "src/repro_torch/csrc/flash_attention.cu", None, fa_bwd[0],
              **bwd_b8, **bwd_d80, **bwd_d96, **bwd_moe, **bwd_whisper,
              **bwd_whisper_train_enc, **bwd_whisper_train_dec,
              **bwd_tp_train, **bwd_fam,
              note="no Pallas counterpart: the JAX package differentiates "
                   "attend_chunked (src/repro/models/attention.py:130)"),
        entry("mamba2_chunk_scan", "src/repro_torch/csrc/mamba2_scan.cu",
              "src/repro/kernels/mamba2_scan.py:75", scan[0],
              per_head_bc=scan[1], train_b8=scan[2], serve_b1=scan[3],
              tp_serve=scan[4], tp_train_b8=scan[5], tp_serve_b1=scan[6]),
        entry("mamba2_chunk_scan_bwd", "src/repro_torch/csrc/mamba2_scan.cu",
              None, scan_bwd[0], tp_train=scan_bwd[1],
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
