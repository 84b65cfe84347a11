"""Causal / sliding-window GQA flash attention, forward: the wrapper of the
hand-written CUDA kernel ``csrc/flash_attention.cu`` and its plain PyTorch
version.

Counterparts: ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel), ``repro/kernels/ref.py`` (``flash_attention_ref``, its oracle) and
``repro/kernels/ops.py`` (the dispatch).  The wrapper picks by the device
of its inputs: a CUDA tensor launches the kernel or raises; a CPU tensor
runs the plain version.  There is no other switch and no fallback.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, scale=None):
    """Plain version: materialized softmax attention, in the dtype order of
    ``repro/kernels/ref.py``.  q: [B, H, S, d]; k, v: [B, Hkv, S, d] ->
    [B, H, S, d]."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    lg = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    pos = torch.arange(S, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = torch.zeros((S, S), dtype=torch.float32, device=q.device)
    if causal:
        mask = torch.where(diff < 0, NEG_INF, mask)
    if window is not None:
        mask = torch.where(diff >= window, NEG_INF, mask)
    p = torch.softmax(lg + mask, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q [B,H,S,d] and k, v "
                         f"[B,Hkv,S,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, d) \
            or k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of Hkv)")
    if S == 0 or B == 0:
        raise ValueError("flash_attention of an empty sequence or batch")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1 or q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"q, k, v must lie on one CUDA or CPU device; got "
                         f"{sorted(map(str, devs))}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")


def _kernel_fn():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, scale=None):
    """q: [B, H, S, d]; k, v: [B, Hkv, S, d] -> [B, H, S, d] in q's dtype.

    float32 or bfloat16, d in ``HEAD_DIMS``, any S, contiguous inputs on
    one device, ``window`` None or at least 1; anything else raises.
    ``scale`` defaults to ``1/sqrt(d)`` (a falsy scale too, as in the TPU
    kernel).  On CUDA
    tensors this launches the kernel on the current stream and adds one to
    ``flash_attention.launches``; on CPU tensors it runs
    ``flash_attention_ref``."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window {window} masks every key of a row; "
                         f"want window >= 1 or None")
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    B, H, S, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):   # the launch goes to q's card
        rc = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, k.shape[1], S, d, _DTYPE_CODES[q.dtype],
            int(bool(causal)), int(window is not None), int(window or 0),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
