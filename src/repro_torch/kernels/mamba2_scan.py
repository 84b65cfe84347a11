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

On CUDA tensors that autograd records, ``mamba2_chunk_scan`` is a
``torch.autograd.Function``: the forward kernel, and for the gradient the
backward kernel ``mamba2_chunk_scan_bwd``, which the JAX package does not
have (it trains zamba by differentiating the jnp ``mamba2_chunked``).  It
is picked by dtype too: float32 runs ``ssd_scan_bwd`` on the CUDA cores,
bfloat16 ``ssd_scan_bwd_mma`` on the tensor cores (bf16 operands, f32
sums).  Its plain version, ``mamba2_chunk_scan_bwd_ref``, is autograd
through ``mamba2_chunk_scan_ref``.
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
_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p])
TILE = 64        # rows per tile of the CUDA kernels


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


def _kernel_fn(name: str, argtypes):
    fn = getattr(build.load("mamba2_scan"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch_fwd(xdt, a, Bm, Cm):
    B, H, L, P = xdt.shape
    y = torch.empty_like(xdt)
    state = torch.empty(B, H, P, Bm.shape[-1], dtype=torch.float32,
                        device=xdt.device)
    with torch.cuda.device(xdt.device):   # the launch goes to xdt's card
        rc = _kernel_fn("mamba2_chunk_scan_fwd", _ARGTYPES)(
            xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, H, Bm.shape[1], L, P,
            Bm.shape[-1],
            _DTYPE_CODES[xdt.dtype],
            torch.cuda.current_stream(xdt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_chunk_scan kernel launch failed: CUDA "
                           f"error {rc}")
    build.count_launch(mamba2_chunk_scan)
    return y, state


def mamba2_chunk_scan_bwd_ref(xdt, a, Bm, Cm, dy, dstate=None):
    """Plain version of the backward: autograd through
    ``mamba2_chunk_scan_ref`` -> (dxdt, da, dBm, dCm) in the inputs'
    dtypes."""
    ins = [t.detach().requires_grad_(True) for t in (xdt, a, Bm, Cm)]
    with torch.enable_grad():
        y, state = mamba2_chunk_scan_ref(*ins)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, ins, grads)


def mamba2_chunk_scan_bwd(xdt, a, Bm, Cm, dy, dstate=None):
    """The backward kernel on CUDA tensors: (dxdt in xdt's dtype, da
    float32, dBm and dCm ``[B, G, L, N]`` in Bm's dtype, each summed over
    the H / G heads of its group) from the forward's inputs, ``dy`` (y's
    gradient, xdt's shape and dtype) and ``dstate`` (the final state's
    gradient, ``[B, H, P, N]`` float32, or None for none).  The inputs'
    contract is ``mamba2_chunk_scan``'s; anything else raises.  Adds one to
    ``mamba2_chunk_scan_bwd.launches``."""
    _check(xdt, a, Bm, Cm, xdt.shape[2])
    if xdt.device.type != "cuda":
        raise ValueError("mamba2_chunk_scan_bwd launches the CUDA kernel; "
                         "on the CPU, autograd differentiates the plain "
                         "version")
    B, H, L, P = xdt.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    if dy.shape != xdt.shape or dy.dtype != xdt.dtype \
            or dy.device != xdt.device or not dy.is_contiguous() \
            or (dy.dtype == torch.bfloat16 and dy.data_ptr() % 16):
        raise ValueError(f"dy must be a contiguous [B,H,L,P] tensor in xdt's "
                         f"dtype on its device; got {tuple(dy.shape)} "
                         f"{dy.dtype} {dy.device}")
    if dstate is not None and (
            tuple(dstate.shape) != (B, H, P, N)
            or dstate.dtype != torch.float32 or dstate.device != xdt.device
            or not dstate.is_contiguous()):
        raise ValueError(f"dstate must be a contiguous [B,H,P,N] float32 "
                         f"tensor on xdt's device; got "
                         f"{tuple(dstate.shape)} {dstate.dtype}")
    dev = xdt.device
    dxdt, da = torch.empty_like(xdt), torch.empty_like(a)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    tiles = -(-L // TILE)
    # the state before each tile, in xdt's dtype (the bf16 kernel rounds
    # it there, as its products take it)
    states = torch.empty(B, H, tiles, P, N, dtype=xdt.dtype, device=dev)
    dBh = torch.empty(B, H, L, N, dtype=torch.float32, device=dev)
    dCh = torch.empty_like(dBh)
    with torch.cuda.device(dev):
        rc = _kernel_fn("mamba2_chunk_scan_bwd", _BWD_ARGTYPES)(
            xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            dxdt.data_ptr(), da.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
            states.data_ptr(), dBh.data_ptr(), dCh.data_ptr(),
            B, H, G, L, P, N, _DTYPE_CODES[xdt.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_chunk_scan backward kernel launch "
                           f"failed: CUDA error {rc}")
    build.count_launch(mamba2_chunk_scan_bwd)
    return dxdt, da, dBm, dCm


mamba2_chunk_scan_bwd.launches = 0


class _MambaChunkScan(torch.autograd.Function):
    """The forward kernel, saving its inputs; the backward kernel for the
    gradient."""

    @staticmethod
    def forward(ctx, xdt, a, Bm, Cm):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xdt, a, Bm, Cm)
        return _launch_fwd(xdt, a, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstate):
        xdt, a, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xdt)
        dy = dy.contiguous()
        if dy.data_ptr() % 16:      # a view into another tensor's storage
            dy = dy.clone()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        return mamba2_chunk_scan_bwd(xdt, a, Bm, Cm, dy, dstate)


def mamba2_chunk_scan(xdt, a, Bm, Cm, *, chunk: int = 128):
    """xdt: [B, H, L, P]; a: [B, H, L] float32 log-decays; Bm, Cm: [B, G,
    L, N] with ``H % G == 0`` (head h reads group h // (H / G)) -> (y [B,
    H, L, P] in xdt's dtype, final state [B, H, P, N] float32).

    xdt, Bm, Cm float32 or bfloat16 of one dtype, (P, N) in ``SHAPES``,
    contiguous inputs on one device (bf16 ones on CUDA starting on a
    16-byte boundary), ``L`` a multiple of ``min(chunk, L)``; anything
    else raises.  On CUDA tensors this launches the kernel on the current
    stream and adds one to ``mamba2_chunk_scan.launches``; when autograd
    records it (grad mode on and an input that requires grad), the
    gradient launches ``mamba2_chunk_scan_bwd``.  On CPU tensors it runs
    ``mamba2_chunk_scan_ref``."""
    _check(xdt, a, Bm, Cm, chunk)
    if xdt.device.type == "cpu":
        return mamba2_chunk_scan_ref(xdt, a, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xdt, a, Bm, Cm)):
        return _MambaChunkScan.apply(xdt, a, Bm, Cm)
    return _launch_fwd(xdt, a, Bm, Cm)


mamba2_chunk_scan.launches = 0
