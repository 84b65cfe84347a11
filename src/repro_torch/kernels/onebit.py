"""1-bit gradient compression with error feedback: the wrappers of the
hand-written CUDA kernels ``csrc/onebit.cu`` (K3a quantize, K3b
dequantize) and their plain PyTorch versions.

Counterparts: ``repro/kernels/onebit.py`` (the Pallas TPU kernels),
``repro/kernels/ref.py`` (``onebit_quantize_ref``/``onebit_dequantize_ref``,
their oracles) and ``repro/optim/compression.py`` (``pack_bits``,
``unpack_bits``, the bit-exact pack).  The wrappers pick by the device of
their inputs: a CUDA tensor launches the kernel or raises; a CPU tensor
runs the plain version.  There is no other switch and no fallback.

Sign words are int32 tensors whose bytes equal the TPU kernel's
little-endian uint32 words (PyTorch's uint32 arithmetic is thin).  The
TPU kernel returns the scale lane-replicated to ``[R, 128]``, its own
layout; here it is ``[R, 1]``, the one column the codec uses.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_Q_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_D_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def pack_bits(signs):
    """bool [R, C] -> int32 [R, C/32], the bytes of little-endian uint32
    words: bit j of word w is element ``32 w + j``."""
    R, C = signs.shape
    bits = signs.reshape(R, C // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=signs.device)
    words = (bits << shifts).sum(-1)               # in [0, 2**32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_bits(packed):
    """int32 [R, C/32] -> bool [R, C]."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).bool()


def _row_abs_mean(q):
    """mean |q| over each row of ``q`` [R, C], summed in the order of the
    reference's ``jnp.mean`` on XLA's CPU backend: each 32-element run in
    sequence, then the C/32 run sums in sequence.  At C <= 1024 (the
    codec's rows) the scales, and so the wire payloads, equal the
    reference's bit for bit.  That order is a detail of the XLA version
    the JAX package runs on, not a contract of ``jnp.mean``: if a jax
    upgrade breaks the byte-identity tests of the onebit payloads (the
    scales an ulp apart), XLA's order changed, not this port."""
    R, C = q.shape
    runs = q.abs().reshape(R, C // 32, 32)
    s = torch.zeros((R, C // 32), dtype=q.dtype, device=q.device)
    for j in range(32):
        s = s + runs[:, :, j]
    t = torch.zeros((R, 1), dtype=q.dtype, device=q.device)
    for k in range(C // 32):
        t = t + s[:, k:k + 1]
    return t / C


def onebit_quantize_ref(g, err):
    """Plain version: q = g + err -> (packed int32 [R, C/32], scale = mean
    |q| per row [R, 1], new_err = q - (+-scale)), in float32."""
    q = g + err
    scale = _row_abs_mean(q)
    signs = q >= 0
    new_err = q - torch.where(signs, scale, -scale)
    return pack_bits(signs), scale, new_err


def onebit_dequantize_ref(packed, scale):
    """Plain version: packed int32 [R, C/32], scale [R, 1] -> +-scale [R,
    C] float32."""
    return torch.where(unpack_bits(packed), scale, -scale)


def _check_device(*ts):
    devs = {t.device for t in ts}
    if len(devs) != 1 or ts[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"inputs must lie on one CUDA or CPU device; got "
                         f"{sorted(map(str, devs))}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the 1-bit kernels take contiguous inputs")


def _fn(name: str, argtypes):
    fn = getattr(build.load("onebit"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def onebit_quantize(g, err):
    """g, err: [R, C] float32 with ``C % 128 == 0`` -> (packed int32 [R,
    C/32], scale [R, 1] float32, new_err [R, C] float32).

    Anything else raises.  On CUDA tensors this launches K3a on the
    current stream and adds one to ``onebit_quantize.launches``; on CPU
    tensors it runs ``onebit_quantize_ref``."""
    if g.dim() != 2 or g.shape != err.shape or g.shape[1] % 128 \
            or g.shape[0] == 0:
        raise ValueError(f"onebit_quantize wants g, err [R, C] with C % 128 "
                         f"== 0; got {tuple(g.shape)}, {tuple(err.shape)}")
    if g.dtype != torch.float32 or err.dtype != torch.float32:
        raise TypeError(f"onebit_quantize takes float32; got {g.dtype}, "
                        f"{err.dtype}")
    _check_device(g, err)
    if g.device.type == "cpu":
        return onebit_quantize_ref(g, err)
    R, C = g.shape
    packed = torch.empty(R, C // 32, dtype=torch.int32, device=g.device)
    scale = torch.empty(R, 1, dtype=torch.float32, device=g.device)
    new_err = torch.empty_like(err)
    with torch.cuda.device(g.device):
        rc = _fn("onebit_quantize_fwd", _Q_ARGTYPES)(
            g.data_ptr(), err.data_ptr(), packed.data_ptr(),
            scale.data_ptr(), new_err.data_ptr(), R, C,
            torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"onebit_quantize kernel launch failed: CUDA "
                           f"error {rc}")
    build.count_launch(onebit_quantize)
    return packed, scale, new_err


onebit_quantize.launches = 0


def onebit_dequantize(packed, scale):
    """packed: int32 [R, C/32] with ``C % 128 == 0``; scale: float32 [R, 1]
    -> +-scale [R, C] float32.

    Anything else raises.  On CUDA tensors this launches K3b on the
    current stream and adds one to ``onebit_dequantize.launches``; on CPU
    tensors it runs ``onebit_dequantize_ref``."""
    if packed.dim() != 2 or packed.shape[1] % 4 or packed.shape[0] == 0 \
            or tuple(scale.shape) != (packed.shape[0], 1):
        raise ValueError(f"onebit_dequantize wants packed [R, C/32] with C "
                         f"% 128 == 0 and scale [R, 1]; got "
                         f"{tuple(packed.shape)}, {tuple(scale.shape)}")
    if packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"onebit_dequantize takes int32 words and float32 "
                        f"scales; got {packed.dtype}, {scale.dtype}")
    _check_device(packed, scale)
    if packed.device.type == "cpu":
        return onebit_dequantize_ref(packed, scale)
    R, C = packed.shape[0], packed.shape[1] * 32
    out = torch.empty(R, C, dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        rc = _fn("onebit_dequantize_fwd", _D_ARGTYPES)(
            packed.data_ptr(), scale.data_ptr(), out.data_ptr(), R, C,
            torch.cuda.current_stream(packed.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"onebit_dequantize kernel launch failed: CUDA "
                           f"error {rc}")
    build.count_launch(onebit_dequantize)
    return out


onebit_dequantize.launches = 0
