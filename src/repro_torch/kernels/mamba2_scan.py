"""Mamba-2 SSD chunked scan: the wrapper of the hand-written CUDA kernel
``csrc/mamba2_scan.cu`` and its plain PyTorch version.

Counterparts: ``repro/kernels/mamba2_scan.py`` (the Pallas TPU kernel),
``repro/kernels/ref.py`` (``mamba2_scan_ref``, its oracle) and
``repro/kernels/ops.py`` (the dispatch).  The wrapper picks by the device
of its inputs: a CUDA tensor launches the kernel or raises; a CPU tensor
runs the plain version.  There is no other switch and no fallback.

``chunk`` keeps the TPU kernel's contract (``chunk = min(chunk, L)`` and
``L % chunk == 0``, else ``ValueError``), but the function does not depend
on it: the CUDA kernels walk the sequence in tiles of their own (64 rows)
and mask a ragged last tile themselves.

``Bm`` and ``Cm`` are ``[B, G, L, N]`` with ``H % G == 0``: head ``h``
reads group ``h // (H / G)``, as K1's query head reads its kv head, so a
model with few groups hands the kernel its B and C once per group instead
of repeated over heads.  ``G == H`` is the TPU kernel's own contract.

The kernel is picked by dtype: float32 runs ``ssd_scan`` on the CUDA cores
(2e-4 parity), bfloat16 runs ``ssd_scan_mma`` on the tensor cores.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# (P, N) pairs the CUDA kernel is built for: zamba2-2.7b, zamba tiny, and
# the smallest shape of the kernel sweep
SHAPES = ((64, 64), (32, 16), (16, 8))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def mamba2_chunk_scan_ref(xdt, a, Bm, Cm):
    """Plain version: the sequential recurrence of ``ref.mamba2_scan_ref``
    in float32, ``h_t = exp(a_t) h_{t-1} + x_t (x) B_t``, ``y_t = h_t C_t``.
    xdt: [B, H, L, P]; a: [B, H, L]; Bm, Cm: [B, G, L, N], repeated here
    over the H / G heads of each group -> (y [B, H, L, P] in xdt's dtype,
    final state [B, H, P, N] float32)."""
    Bsz, H, L, P = xdt.shape
    N = Bm.shape[-1]
    rep = H // Bm.shape[1]
    x, a32 = xdt.float(), a.float()
    b32 = Bm.float().repeat_interleave(rep, dim=1)
    c32 = Cm.float().repeat_interleave(rep, dim=1)
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(L):
        h = h * torch.exp(a32[:, :, t])[..., None, None] \
            + x[:, :, t, :, None] * b32[:, :, t, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, c32[:, :, t]))
    return torch.stack(ys, dim=2).to(xdt.dtype), h


def _check(xdt, a, Bm, Cm, chunk: int):
    if xdt.dim() != 4 or a.dim() != 3 or Bm.dim() != 4 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"mamba2_chunk_scan wants xdt [B,H,L,P], a [B,H,L] "
                         f"and Bm, Cm [B,G,L,N]; got {tuple(xdt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, H, L, P = xdt.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    if tuple(a.shape) != (B, H, L) or Bm.shape[0] != B or Bm.shape[2] != L:
        raise ValueError(f"a {tuple(a.shape)} and Bm {tuple(Bm.shape)} do "
                         f"not match xdt {tuple(xdt.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups of Bm, "
                         f"Cm")
    if B == 0 or H == 0 or L == 0:
        raise ValueError("mamba2_chunk_scan of an empty batch or sequence")
    if (P, N) not in SHAPES:
        raise ValueError(f"(P, N) = {(P, N)} not in {SHAPES}")
    if xdt.dtype not in _DTYPE_CODES or Bm.dtype != xdt.dtype \
            or Cm.dtype != xdt.dtype:
        raise TypeError(f"mamba2_chunk_scan takes float32 or bfloat16 xdt, "
                        f"Bm, Cm of one dtype; got {xdt.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"mamba2_chunk_scan takes float32 a; got {a.dtype}")
    devs = {xdt.device, a.device, Bm.device, Cm.device}
    if len(devs) != 1 or xdt.device.type not in ("cuda", "cpu"):
        raise ValueError(f"xdt, a, Bm, Cm must lie on one CUDA or CPU "
                         f"device; got {sorted(map(str, devs))}")
    if not all(t.is_contiguous() for t in (xdt, a, Bm, Cm)):
        raise ValueError("mamba2_chunk_scan takes contiguous inputs")
    if any(t.device.type == "cuda" and t.dtype == torch.bfloat16
           and t.data_ptr() % 16 for t in (xdt, Bm, Cm)):
        # the bf16 kernel copies its tiles in 16-byte words
        raise ValueError("mamba2_chunk_scan's bf16 kernel takes tensors "
                         "that start on a 16-byte boundary")
    chunk = min(chunk, L)
    if chunk < 1 or L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of chunk "
                         f"{chunk}")


def _kernel_fn():
    fn = build.load("mamba2_scan").mamba2_chunk_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def mamba2_chunk_scan(xdt, a, Bm, Cm, *, chunk: int = 128):
    """xdt: [B, H, L, P]; a: [B, H, L] float32 log-decays; Bm, Cm: [B, G,
    L, N] with ``H % G == 0`` (head h reads group h // (H / G)) -> (y [B,
    H, L, P] in xdt's dtype, final state [B, H, P, N] float32).

    xdt, Bm, Cm float32 or bfloat16 of one dtype, (P, N) in ``SHAPES``,
    contiguous inputs on one device (bf16 ones on CUDA starting on a
    16-byte boundary), ``L`` a multiple of ``min(chunk, L)``; anything
    else raises.  On CUDA tensors this launches the kernel
    on the current stream and adds one to ``mamba2_chunk_scan.launches``;
    it raises ``NotImplementedError`` when autograd would record it (grad
    mode on and an input that requires grad), since the kernel has no
    backward yet.  On CPU tensors it runs ``mamba2_chunk_scan_ref``."""
    _check(xdt, a, Bm, Cm, chunk)
    if xdt.device.type == "cpu":
        return mamba2_chunk_scan_ref(xdt, a, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xdt, a, Bm, Cm)):
        raise NotImplementedError(
            "mamba2_chunk_scan has no backward kernel yet (zamba training, "
            "ROADMAP item 16): call it under torch.no_grad() or on inputs "
            "that do not require grad")
    B, H, L, P = xdt.shape
    y = torch.empty_like(xdt)
    state = torch.empty(B, H, P, Bm.shape[-1], dtype=torch.float32,
                        device=xdt.device)
    with torch.cuda.device(xdt.device):   # the launch goes to xdt's card
        rc = _kernel_fn()(
            xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, H, Bm.shape[1], L, P,
            Bm.shape[-1],
            _DTYPE_CODES[xdt.dtype],
            torch.cuda.current_stream(xdt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_chunk_scan kernel launch failed: CUDA "
                           f"error {rc}")
    mamba2_chunk_scan.launches += 1
    return y, state


mamba2_chunk_scan.launches = 0
