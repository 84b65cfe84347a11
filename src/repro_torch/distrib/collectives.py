"""Gradient collectives of fabric DDP: the wire codecs and the ring
all-reduce, at world 1.

Counterpart: ``repro/distrib/collectives.py:65-188,193-383``
(``GradCodec``, ``Fp32Codec``, ``OneBitCodec``, ``CODECS``, ``get_codec``,
``RingAllReduce``).  The multi-locality wire (``distrib/messaging.py``,
AGAS, the runtime) is ROADMAP item 12, so ``RingAllReduce`` runs at world
1 only, where it posts nothing: every contribution still passes through
the codec (``decode(encode(...))``), as in the reference, so a world-1 run
with ``onebit`` quantizes and dequantizes every gradient bucket every
step.

The gradient buckets stay on the device.  A codec's payload is the
reference's wire bytes: ``fp32`` ships the bucket's little-endian float32
bytes; ``onebit`` runs the 1-bit kernels (``kernels/onebit.py``: K3a on
``encode``, K3b on ``decode``) with a per-locality error-feedback
residual on the device, and ships the sign words (the bytes of
little-endian uint32 words) followed by the R float32 row scales.  Only
the payload crosses to the host; ``decode`` returns the contribution on
the codec's device.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..optim import compression

__all__ = ["CODECS", "Fp32Codec", "GradCodec", "OneBitCodec",
           "RingAllReduce", "get_codec"]

_WIRE = "the multi-locality wire (messaging, AGAS, runtime): ROADMAP item 12"


def _from_bytes(data: bytes, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype).copy()).to(device)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------
class GradCodec:
    """Payload codec for one locality's per-bucket gradient partials: the
    fused float32 bucket buffers of a ``FusionPlan``
    (``optim.compression.make_plan``) to wire bytes and back.  It may be
    stateful per locality; ``reset(plan, device)`` re-initializes that
    state at run start.  ``decode`` is deterministic."""

    name = "base"

    def __init__(self):
        self.device = torch.device("cpu")

    def reset(self, plan, device="cpu") -> None:
        """(Re-)initialize per-run codec state for ``plan``'s buckets on
        ``device``, where ``decode`` also puts its results."""
        self.device = torch.device(device)

    def encode(self, bufs) -> list[bytes]:
        """float32 bucket buffers -> one wire payload per bucket."""
        raise NotImplementedError

    def decode(self, data: bytes, bucket) -> torch.Tensor:
        """One wire payload -> float32[bucket.size] contribution on the
        codec's device."""
        raise NotImplementedError

    def wire_bytes(self, plan) -> int:
        """Exact payload bytes of one full encode over ``plan``."""
        raise NotImplementedError


class Fp32Codec(GradCodec):
    """Passthrough codec: raw little-endian float32 bucket bytes;
    ``decode(encode(x))`` is bitwise ``x``."""

    name = "fp32"

    def encode(self, bufs) -> list[bytes]:
        return [b.detach().to("cpu", torch.float32).contiguous().numpy()
                .tobytes() for b in bufs]

    def decode(self, data: bytes, bucket) -> torch.Tensor:
        return _from_bytes(data, np.float32, self.device)

    def wire_bytes(self, plan) -> int:
        return sum(4 * b.size for b in plan.buckets)


class OneBitCodec(GradCodec):
    """1-bit sign quantization with persistent error feedback.

    Each bucket is viewed as ``[R, 1024]`` (the plan pads buckets to a
    multiple of ``ROW * 32``); K3a folds the running residual in and gives
    the sign words, the per-row L1 scales and the new residual.  Wire
    format per bucket: ``size/8`` bytes of sign words, then ``R`` float32
    scales, both little-endian.  The residual lives on this locality's
    device only; ``reset`` zeroes it."""

    name = "onebit"

    def __init__(self):
        super().__init__()
        self._err: list = []

    def reset(self, plan, device="cpu") -> None:
        super().reset(plan, device)
        self._err = compression.init_error_state(plan, self.device)

    def encode(self, bufs) -> list[bytes]:
        out = []
        for i, buf in enumerate(bufs):
            packed, scale, self._err[i] = compression.quantize_bucket(
                buf.float(), self._err[i])
            out.append(packed.cpu().numpy().tobytes()
                       + scale.cpu().numpy().tobytes())
        return out

    def decode(self, data: bytes, bucket) -> torch.Tensor:
        rows = bucket.size // compression.ROW
        nb = rows * (compression.ROW // 32) * 4
        packed = _from_bytes(data[:nb], np.int32, self.device)
        scale = _from_bytes(data[nb:], np.float32, self.device)
        return compression.dequantize_bucket(
            packed.reshape(rows, compression.ROW // 32),
            scale.reshape(rows, 1), bucket.size)

    def wire_bytes(self, plan) -> int:
        return sum(b.size // 8 + 4 * (b.size // compression.ROW)
                   for b in plan.buckets)


CODECS: dict[str, type] = {Fp32Codec.name: Fp32Codec,
                           OneBitCodec.name: OneBitCodec}


def get_codec(name: str) -> GradCodec:
    """A fresh codec instance by name (``fp32`` | ``onebit``).

    Raises:
        ValueError: unknown codec name.
    """
    try:
        return CODECS[name]()
    except KeyError:
        raise ValueError(f"unknown grad codec {name!r} "
                         f"(have: {sorted(CODECS)})") from None


# ---------------------------------------------------------------------------
# Ring all-reduce, world 1
# ---------------------------------------------------------------------------
class RingAllReduce:
    """The gradient ring at world 1: ``allreduce`` runs every bucket
    through the codec and returns the decoded sums; nothing is posted,
    so ``wire_bytes`` stays 0.

    Args:
        endpoint: the locality's active-message endpoint; must be None
            (there is no wire yet).
        world: ring size; must be 1.
    Raises:
        NotImplementedError: ``world > 1`` or an endpoint (ROADMAP item
            12).
    """

    def __init__(self, endpoint: Any = None, world: int = 1):
        if int(world) > 1 or endpoint is not None:
            raise NotImplementedError(f"RingAllReduce at world {world}: "
                                      f"{_WIRE}")
        self.endpoint = None
        self.world = 1
        self.rank = 0
        self.wire_bytes = 0          # payload bytes sent this run
        self._codec: Optional[GradCodec] = None
        self._plan = None

    def configure(self, codec_name: str, plan, *,
                  device="cpu") -> GradCodec:
        """Arm the ring for one DDP run: a fresh codec, reset for
        ``plan``'s buckets on ``device``; zeroes ``wire_bytes``.  Returns
        the codec."""
        codec = get_codec(codec_name)
        codec.reset(plan, device)
        self._codec, self._plan = codec, plan
        self.wire_bytes = 0
        return codec

    def allreduce(self, step: int, bufs, meta: Any = None):
        """Sum ``bufs`` (this rank's float32 bucket partials) across the
        ring: at world 1, ``decode(encode(bufs))``.  The caller divides by
        its shard count.

        Returns:
            ``(summed_bufs, metas)``: the per-bucket sums on the codec's
            device and ``{origin_rank: meta}``.
        Raises:
            RuntimeError: the ring was never ``configure``d.
        """
        if self._codec is None:
            raise RuntimeError("RingAllReduce.configure must run before "
                               "allreduce")
        payloads = self._codec.encode(bufs)
        summed = [self._codec.decode(data, b)
                  for data, b in zip(payloads, self._plan.buckets)]
        return summed, {0: meta}
