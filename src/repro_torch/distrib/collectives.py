"""Gradient collectives of fabric DDP: the wire codecs and the ring
all-reduce over the active-message fabric.

Counterpart: ``repro/distrib/collectives.py`` (``GradCodec``,
``Fp32Codec``, ``OneBitCodec``, ``CODECS``, ``get_codec``,
``RingAllReduce``).  The ring is the reference's **ring all-gather with a
deterministic local combine**: every locality encodes its per-bucket
gradient partials and posts one ``grad_ring`` active message per bucket
to its successor; a received segment is stored and relayed until it has
made ``world - 1`` hops; then every locality decodes every origin's
payload (its own included) and sums them in origin-rank order 0..W-1.
Float addition does not associate, so that fixed order is what makes
every locality, and a 1-locality run over the same shards, compute the
same bits.  Segments are keyed by run generation, step, origin and
bucket; a lost peer or an ``abort`` poisons the ring and a blocked
``allreduce`` raises ``LocalityLostError``, never hangs.

The gradient buckets stay on the device.  A codec's payload is the
reference's wire bytes: ``fp32`` ships the bucket's little-endian float32
bytes; ``onebit`` runs the 1-bit kernels (``kernels/onebit.py``: K3a on
``encode``, K3b on ``decode``) with a per-locality error-feedback
residual on the device, and ships the sign words (the bytes of
little-endian uint32 words) followed by the R float32 row scales.  Only
the payload bytes cross to the host and the wire, through a pageable
``.cpu().numpy().tobytes()`` copy; ``decode`` returns the contribution on
the codec's device.  At world 1 nothing is posted, but every bucket still
passes through the codec, as in the reference.  The runtime sanitizer
flags a ring generation that goes back in ``configure`` (PHY103), as the
reference's does.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..analysis import sanitize as _san
from ..optim import compression
from .messaging import Endpoint, PeerLostError

__all__ = ["CODECS", "Fp32Codec", "GradCodec", "OneBitCodec",
           "RingAllReduce", "get_codec"]

#: action name of ring segments on the active-message wire
GRAD_RING_ACTION = "grad_ring"


def _lost_error():
    from .runtime import LocalityLostError   # circular at import time only
    return LocalityLostError


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
        #: a measurement seam (None in runs): the onebit codec calls
        #: ``probe.encoded(i, buf, err, packed, scale, new_err)`` after
        #: each bucket's K3a and ``probe.decoded(packed, scale, out)``
        #: after each K3b, the residual ``err`` copied first
        self.probe = None

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
            err = self._err[i] if self.probe is None else self._err[i].clone()
            packed, scale, self._err[i] = compression.quantize_bucket(
                buf.float(), self._err[i])
            if self.probe is not None:
                self.probe.encoded(i, buf, err, packed, scale, self._err[i])
            out.append(packed.cpu().numpy().tobytes()
                       + scale.cpu().numpy().tobytes())
        return out

    def decode(self, data: bytes, bucket) -> torch.Tensor:
        rows = bucket.size // compression.ROW
        nb = rows * (compression.ROW // 32) * 4
        packed = _from_bytes(data[:nb], np.int32, self.device)
        scale = _from_bytes(data[nb:], np.float32, self.device)
        packed = packed.reshape(rows, compression.ROW // 32)
        scale = scale.reshape(rows, 1)
        out = compression.dequantize_bucket(packed, scale, bucket.size)
        if self.probe is not None:
            self.probe.decoded(packed, scale, out)
        return out

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
# Ring all-reduce
# ---------------------------------------------------------------------------
class RingAllReduce:
    """Chunked ring all-reduce of gradient buckets as active messages.

    One instance lives on each locality's endpoint for the process
    lifetime (``Locality``/``DistributedGraph`` construct it, so the
    ``grad_ring`` handler exists before any peer can send: posts to an
    unregistered action are dropped, never delivered late).
    ``configure`` arms it for one DDP run: it picks the codec, resets the
    codec's state on the run's device, sets the generation (segments of
    an earlier run are dropped by generation) and zeroes ``wire_bytes``.

    Args:
        endpoint: this locality's active-message endpoint (None only at
            ``world == 1``: nothing crosses the wire).
        world: ring size = total locality count, driver included.
        account: optional callback receiving payload byte counts as they
            are sent (the driver wires it to
            ``DistributedGraph.account_grad_wire_bytes``).
    Raises:
        ValueError: ``world > 1`` without an endpoint.
    """

    def __init__(self, endpoint: Optional[Endpoint] = None, world: int = 1,
                 *, account: Optional[Callable[[int], None]] = None):
        self.endpoint = endpoint
        self.world = max(int(world), 1)
        if self.world > 1 and endpoint is None:
            raise ValueError(f"RingAllReduce at world {self.world} needs an "
                             f"endpoint to post its segments on")
        self.rank = endpoint.rank if endpoint is not None else 0
        self.account = account
        self.wire_bytes = 0          # payload bytes sent this run
        self._codec: Optional[GradCodec] = None
        self._plan = None
        self._gen = 0
        self._active = False
        self._dead: Optional[str] = None
        self._cond = threading.Condition()
        # (gen, step, origin, bucket) -> (payload bytes, meta | None)
        self._inbox: dict[tuple, tuple] = {}
        if endpoint is not None:
            endpoint.register(GRAD_RING_ACTION, self._on_seg)

    @property
    def active(self) -> bool:
        """True between ``configure`` and ``deactivate``: peer loss only
        poisons an active ring."""
        return self._active

    @property
    def gen(self) -> int:
        """Current run generation (segments of earlier gens are dropped)."""
        return self._gen

    # -- run lifecycle -------------------------------------------------------
    def configure(self, codec_name: str, plan, *, device="cpu",
                  gen: Optional[int] = None) -> GradCodec:
        """Arm the ring for one DDP run.

        Args:
            codec_name: a :data:`CODECS` key (``fp32`` | ``onebit``).
            plan: the run's gradient ``FusionPlan`` (every rank builds the
                identical plan from the same ``Plan``).
            device: where the codec keeps its state and decodes to.
            gen: explicit generation.  The driver configures first and
                ships its generation in the ``ddp_train`` spec, so every
                ring keys segments identically, even a ring on a freshly
                spawned locality whose counter starts at 0.  None
                increments the local counter (driver use).
        Returns:
            The codec instance, with freshly reset state.
        """
        codec = get_codec(codec_name)
        codec.reset(plan, device)
        with self._cond:
            if gen is not None and int(gen) < self._gen and _san.active():
                # a regressed generation would resurrect stale inbox
                # segments this ring already agreed to drop (PHY103)
                _san.get().record(
                    "PHY103",
                    f"rank {self.rank}: ring generation regressed "
                    f"{self._gen} -> {int(gen)} in configure()",
                    once_key=f"{self.rank}:{self._gen}:{gen}")
            self._gen = int(gen) if gen is not None else self._gen + 1
            gen = self._gen
            self._inbox = {k: v for k, v in self._inbox.items()
                           if k[0] >= gen}
            self._codec, self._plan = codec, plan
            self._dead = None
            self._active = True
            self.wire_bytes = 0
            self._cond.notify_all()
        return codec

    def deactivate(self):
        """Disarm after a run: later peer losses (normal teardown) no
        longer poison the ring."""
        with self._cond:
            self._active = False

    def abort(self, reason: str):
        """Poison the ring: blocked and future ``allreduce`` calls of
        this generation raise ``LocalityLostError(reason)``."""
        with self._cond:
            if not self._active or self._dead is not None:
                return
            self._dead = str(reason)
            self._cond.notify_all()

    def peer_lost(self, rank: int):
        """Endpoint peer-loss hook: abort the step if a run is active."""
        if self._active:
            self.abort(f"locality {rank} died mid-all-reduce; "
                       f"the step aborted (DESIGN.md §11 failure model)")

    # -- the collective ------------------------------------------------------
    def allreduce(self, step: int, bufs, meta: Any = None, *,
                  timeout: float = 300.0,
                  consume: Optional[Callable] = None):
        """Sum ``bufs`` (this rank's float32 bucket partials) across the
        ring.

        Every contribution, this rank's included, passes through the codec
        (``decode(encode(...))``), and the per-bucket sum runs in
        origin-rank order 0..world-1 on the codec's device, so every
        locality computes the same bits.  The caller divides by its shard
        count; this method only sums.

        Args:
            step: monotone step index (keys segment matching).
            bufs: float32 bucket buffers, one per plan bucket (any
                iterable: the encode takes one bucket at a time, so a
                generator that builds each bucket keeps one resident).
            meta: small picklable sidecar (the shard loss, as numpy)
                carried on the bucket-0 segment; not counted as gradient
                wire bytes.
            timeout: seconds to wait for the other ranks' segments.
            consume: ``consume(i, sum)`` as soon as bucket ``i``'s sum is
                made, which is then not kept (a sum at a time resident).
        Returns:
            ``(summed_bufs, metas)``: the rank-ordered per-bucket sums on
            the codec's device (None each, with ``consume``) and
            ``{origin_rank: meta}``.
        Raises:
            LocalityLostError: a peer died mid-exchange (ring poisoned).
            TimeoutError: segments missing after ``timeout``.
            RuntimeError: the ring was never ``configure``d.
        """
        with self._cond:
            if self._codec is None:
                raise RuntimeError("RingAllReduce.configure must run before "
                                   "allreduce")
            codec, plan, gen = self._codec, self._plan, self._gen
        payloads = codec.encode(bufs)
        got: dict = {}
        if self.world > 1:
            succ = (self.rank + 1) % self.world
            for i, data in enumerate(payloads):
                try:
                    self.endpoint.post(succ, GRAD_RING_ACTION, {
                        "gen": gen, "step": int(step), "origin": self.rank,
                        "hop": 1, "bucket": i, "data": data,
                        "meta": meta if i == 0 else None})
                except PeerLostError as e:
                    self.abort(f"locality {succ} died mid-all-reduce "
                               f"at step {step}: {e}")
                    break
                self._count(len(data))
            need = [(gen, int(step), o, i)
                    for o in range(self.world) if o != self.rank
                    for i in range(len(payloads))]
            with self._cond:
                ok = self._cond.wait_for(
                    lambda: self._dead is not None
                    or all(k in self._inbox for k in need),
                    timeout)
                if self._dead is not None:
                    raise _lost_error()(
                        f"all-reduce at step {step}: {self._dead}")
                if not ok:
                    missing = [k for k in need if k not in self._inbox]
                    raise TimeoutError(
                        f"all-reduce at step {step}: {len(missing)} "
                        f"segment(s) missing after {timeout}s "
                        f"(first: origin {missing[0][2]} bucket "
                        f"{missing[0][3]})")
                got = {o: [self._inbox.pop((gen, int(step), o, i))
                           for i in range(len(payloads))]
                       for o in range(self.world) if o != self.rank}
        datas = {o: payloads if o == self.rank else [d for d, _ in got[o]]
                 for o in range(self.world)}
        metas = {o: meta if o == self.rank else got[o][0][1]
                 for o in range(self.world)}
        acc: list = [None] * len(payloads)
        for i in range(len(payloads)):
            for origin in range(self.world):      # fixed combine order
                dec = codec.decode(datas[origin][i], plan.buckets[i])
                acc[i] = dec if acc[i] is None else acc[i] + dec
            if consume is not None:    # handed out, and let go at once
                consume(i, acc[i])
                acc[i] = None
        return acc, metas

    # -- wire handler --------------------------------------------------------
    def _on_seg(self, src: int, msg: dict):
        key = (msg["gen"], msg["step"], msg["origin"], msg["bucket"])
        with self._cond:
            if msg["gen"] < self._gen:
                return                             # stale run: drop
            self._inbox[key] = (msg["data"], msg.get("meta"))
            self._cond.notify_all()
        if msg["hop"] < self.world - 1:            # relay around the ring
            succ = (self.rank + 1) % self.world
            try:
                self.endpoint.post(succ, GRAD_RING_ACTION,
                                   dict(msg, hop=msg["hop"] + 1))
            except PeerLostError as e:
                self.abort(f"locality {succ} died relaying step "
                           f"{msg['step']}: {e}")
                return
            self._count(len(msg["data"]))

    def _count(self, n: int):
        with self._cond:
            self.wire_bytes += int(n)
        if self.account is not None:
            self.account(int(n))
