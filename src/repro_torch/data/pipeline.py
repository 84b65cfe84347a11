"""Data pipeline: deterministic synthetic streams and host prefetch.

Counterpart: ``repro/data/pipeline.py:26-163`` (``LMStream``,
``stream_for``, ``HARStream``, ``Prefetcher``).  The streams are numpy, drawn exactly as
the reference draws them, so a step's batch is the reference's batch.
``Prefetcher`` builds batch ``step + k`` as a ``Lane.PREFETCH`` node of the
futurized runtime while step ``step`` runs, and places it on the
session's device (tokens and labels as int64), where the reference places
it by shardings; with no device the batch stays numpy on the host.
``HARStream`` feeds the HAR CNN (``models/cnn.py``).

Synthetic LM stream: a noisy affine bigram process
    x_{t+1} = (a * x_t + b) mod V   with prob (1 - noise), else uniform
- deterministic per (seed, step), learnable and unbounded.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.futures import FuturizedGraph, Lane

__all__ = ["HARStream", "LMStream", "Prefetcher", "stream_for"]


@dataclasses.dataclass
class LMStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    noise: float = 0.1
    a: int = 31
    b: int = 7
    frames_dim: int = 0            # >0: also emit encoder frames (enc-dec)
    frames_len: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        x = np.empty((self.batch, self.seq + 1), np.int32)
        x[:, 0] = rng.integers(0, self.vocab, self.batch)
        noise_mask = rng.random((self.batch, self.seq)) < self.noise
        noise_tok = rng.integers(0, self.vocab, (self.batch, self.seq))
        for t in range(self.seq):
            nxt = (self.a * x[:, t] + self.b) % self.vocab
            x[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        out = {"tokens": x[:, :-1], "labels": x[:, 1:]}
        if self.frames_dim:
            out["frames"] = rng.standard_normal(
                (self.batch, self.frames_len, self.frames_dim)
            ).astype(np.float32) * 0.1
        return out


def stream_for(cfg, *, batch: int, seq: int, seed: int = 0) -> LMStream:
    """The default synthetic stream for an architecture: bigram LM tokens,
    plus encoder frames for enc-dec families.  ``Session.train`` uses this
    when no stream is supplied."""
    encdec = cfg.family == "encdec"
    return LMStream(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed,
                    frames_dim=cfg.d_model if encdec else 0,
                    frames_len=cfg.enc_frames if encdec else 0)


@dataclasses.dataclass
class HARStream:
    """Windows of 9-channel signals; class = dominant frequency band."""
    batch: int
    length: int = 128
    channels: int = 9
    classes: int = 6
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        y = rng.integers(0, self.classes, self.batch)
        t = np.arange(self.length)[None, :, None] / self.length
        freq = (y[:, None, None] + 1) * 2.0
        phase = rng.random((self.batch, 1, self.channels)) * 6.28
        x = np.sin(6.28 * freq * t + phase) + \
            0.3 * rng.standard_normal((self.batch, self.length,
                                       self.channels))
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: integer fields as int64 (embedding and
    gather indices), float fields as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


class Prefetcher:
    """Double-buffered prefetch as futurized-graph nodes: batch ``step+k``
    is built on a runtime worker while ``step`` runs, then placed on
    ``device``.  Each outstanding batch is a ``Lane.PREFETCH`` node, so on
    a shared runtime prefetch yields to step-critical compute but beats
    checkpoint I/O.  ``device=None`` leaves batches as numpy (the DDP loop
    slices its shards from the host batch)."""

    def __init__(self, stream, device=None, depth: int = 2,
                 graph: Optional[FuturizedGraph] = None):
        self.stream = stream
        self.device = device
        self._own_graph = graph is None
        self.graph = graph if graph is not None else FuturizedGraph(
            max_workers=2, name="prefetch")
        self._futs: dict = {}
        self.depth = depth

    def _make(self, step: int):
        b = self.stream.batch_at(step)
        return b if self.device is None else to_device(b, self.device)

    def schedule(self, step: int):
        """Ensure batches [step, step+depth) are in flight as graph nodes."""
        for s in range(step, step + self.depth):
            if s not in self._futs:
                self._futs[s] = self.graph.defer(
                    self._make, s, lane=Lane.PREFETCH, name=f"prefetch:{s}")

    def get_future(self, step: int):
        """The batch's future - lets a consumer depend on it by edge
        instead of blocking here."""
        self.schedule(step)
        return self._futs.pop(step)

    def get(self, step: int) -> dict:
        return self.get_future(step).result()

    def close(self):
        for f in self._futs.values():
            if not f.cancel():
                # lookahead batch finished before the cancel landed: observe
                # it so the node doesn't read as silently dropped
                f.exception()
        self._futs.clear()
        if self._own_graph:
            self.graph.shutdown(wait=True)
