"""Causal / sliding-window GQA flash attention, forward and backward: the
wrapper of the hand-written CUDA kernels ``csrc/flash_attention.cu`` and
their plain PyTorch version.

Counterparts: ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel, forward only), ``repro/kernels/ref.py`` (``flash_attention_ref``,
its oracle) and ``repro/kernels/ops.py`` (the dispatch).  The wrapper picks
by the device of its inputs: a CUDA tensor launches the kernels or raises;
a CPU tensor runs the plain version under ordinary autograd.  There is no
other switch and no fallback.

On CUDA tensors ``flash_attention`` is a ``torch.autograd.Function``: its
forward kernel also writes each row's float32 log-sum-exp, and its
backward launches the backward kernel (dq, dk, dv), which the JAX package
does not have (its training differentiates ``attend_chunked``).  The
backward is built for every head dim of the forward (``BWD_HEAD_DIMS ==
HEAD_DIMS``).

The C entries pick the route by dtype, with no fallback between them:
bfloat16, which every main path runs, goes to the tensor-core kernels
(Hopper ``wgmma``); float32 to kernels that compute in f32 on the CUDA
cores, because f32 inputs must match this module's plain version to 1e-5,
which bf16 or tf32 products cannot.  Both routes count in the same
``launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 96, 128)
BWD_HEAD_DIMS = HEAD_DIMS
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
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
    _check_aligned(q, k, v)


def _check_aligned(*ts):
    """The bf16 kernels read their tensors in 16-byte words: a CUDA bf16
    tensor must start on a 16-byte boundary (a view at another offset
    would fault on the card)."""
    if any(t.device.type == "cuda" and t.dtype == torch.bfloat16
           and t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention's bf16 kernels take tensors that "
                         "start on a 16-byte boundary")


def _kernel_fn(name: str, argtypes):
    fn = getattr(build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch_fwd(q, k, v, causal, window, scale, with_lse: bool):
    B, H, S, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):   # the launch goes to q's card
        rc = _kernel_fn("flash_attention_fwd", _FWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, H, k.shape[1], S, d, _DTYPE_CODES[q.dtype],
            int(bool(causal)), int(window is not None), int(window or 0),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    build.count_launch(flash_attention)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None, scale=None):
    """The backward kernel on CUDA tensors: (dq, dk, dv) in q's dtype from
    q, k, v, the forward's output ``o`` and row log-sum-exp ``lse`` ([B, H,
    S] float32) and the output's gradient ``dout``.  The inputs' contract
    is ``flash_attention``'s; anything else raises.  Adds one to
    ``flash_attention_bwd.launches``."""
    _check(q, k, v)
    B, H, S, d = q.shape
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd launches the CUDA kernel; on "
                         "the CPU, autograd differentiates the plain version")
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype \
            or dout.dtype != q.dtype or tuple(lse.shape) != (B, H, S) \
            or lse.dtype != torch.float32:
        raise ValueError(f"o, dout must be [B,H,S,d] in q's dtype and lse "
                         f"[B,H,S] float32; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(dout.shape)} {dout.dtype}, "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not all(t.is_contiguous() and t.device == q.device
               for t in (o, lse, dout)):
        raise ValueError("o, lse, dout must be contiguous on q's device")
    _check_aligned(o, dout)
    scale = scale or 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernel_fn("flash_attention_bwd", _BWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, H, k.shape[1], S, d,
            _DTYPE_CODES[q.dtype], int(bool(causal)),
            int(window is not None), int(window or 0), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {rc}")
    build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving its output and row log-sum-exp; the
    backward kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, train):
        # ``train``: autograd records this call (grad mode is off in here)
        out, lse = _launch_fwd(q, k, v, causal, window, scale, train)
        if train:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dout = dout.contiguous()
        if dout.data_ptr() % 16:    # a view into another tensor's storage
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal,
            window=window, scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, scale=None):
    """q: [B, H, S, d]; k, v: [B, Hkv, S, d] -> [B, H, S, d] in q's dtype.

    float32 or bfloat16, d in ``HEAD_DIMS``, any S, contiguous inputs on
    one device, ``window`` None or at least 1; anything else raises.
    ``scale`` defaults to ``1/sqrt(d)`` (a falsy scale too, as in the TPU
    kernel).  On CUDA tensors this launches the forward kernel on the
    current stream and adds one to ``flash_attention.launches``; when
    autograd records it, the gradient launches ``flash_attention_bwd``.
    On CPU tensors it runs ``flash_attention_ref``."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window {window} masks every key of a row; "
                         f"want window >= 1 or None")
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, window, scale, train)


flash_attention.launches = 0
