"""Gradient compression for the data-parallel wire: 1-bit signs with
per-row L1 scales and error feedback.

Counterpart: ``repro/optim/compression.py:19-83`` (``ROW``,
``pack_bits``/``unpack_bits``, ``pack_signs``/``unpack_signs``,
``quantize_bucket``, ``dequantize_bucket``, ``make_plan``,
``init_error_state``).  ``exchange_onebit``, the in-jit dp exchange, waits
for the mesh-parallel strategies (ROADMAP item 14).

PyTorch's uint32 arithmetic is thin, so sign words are int32 tensors
whose bytes equal the reference's little-endian uint32 words: bit j of
word w is element ``32 w + j``.  ``pack_bits``/``unpack_bits`` live
beside the 1-bit kernels (``kernels/onebit.py``), whose plain versions use
them; ``quantize_bucket`` and ``dequantize_bucket`` run those kernels,
which take their plain versions on CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ..core import fusion
from ..kernels.onebit import (onebit_dequantize, onebit_quantize, pack_bits,
                              unpack_bits)

__all__ = ["ROW", "dequantize_bucket", "init_error_state", "make_plan",
           "pack_bits", "pack_signs", "quantize_bucket", "unpack_bits",
           "unpack_signs"]

ROW = 1024  # bucket rows are reshaped to [R, ROW] for per-row scales


def pack_signs(signs):
    """bool [n] (any n) -> int32 [ceil(n/32)] bitmap, zero-padded; the 1-D
    face of :func:`pack_bits`.  Inverse: ``unpack_signs(packed, n)``."""
    n = signs.shape[0]
    flat = torch.nn.functional.pad(signs.to(torch.bool), (0, (-n) % 32))
    return pack_bits(flat.reshape(1, -1))[0]


def unpack_signs(packed, n: int):
    """int32 [ceil(n/32)] -> bool [n]; inverse of :func:`pack_signs`."""
    return unpack_bits(packed.reshape(1, -1))[0, :n]


def quantize_bucket(buf, err):
    """1-D float32 bucket (len % ROW*32 == 0) and its ``[R, ROW]``
    residual -> (packed int32 [R, ROW/32], scale [R, 1], new_err [R,
    ROW])."""
    return onebit_quantize(buf.reshape(-1, ROW), err)


def dequantize_bucket(packed, scale, n: int):
    """(packed, scale) of :func:`quantize_bucket` -> the first ``n``
    elements of the ``+-scale`` bucket."""
    return onebit_dequantize(packed, scale).reshape(-1)[:n]


def make_plan(grads_specs, dp_degree: int) -> fusion.FusionPlan:
    """Fusion plan whose buckets are divisible by both the dp degree and
    the [R, 1024] quantization view (32 MB buckets)."""
    pad = math.lcm(max(dp_degree, 1), ROW * 32)
    return fusion.make_plan(grads_specs, cap_bytes=32 << 20, pad_to=pad)


def init_error_state(plan: fusion.FusionPlan, device="cpu"):
    """Zero residual ``[R, ROW]`` float32 per bucket, on ``device``."""
    return [torch.zeros((b.size // ROW, ROW), dtype=torch.float32,
                        device=device) for b in plan.buckets]
