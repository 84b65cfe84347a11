"""Fabric DDP: the per-locality train engine behind ``Plan(ddp=True)``.

Counterpart: ``repro/frontend/ddp.py:42-143`` (``shard_batch``,
``DDPEngine``).  The global batch is split into ``Plan.ddp_shards`` row
shards; a locality computes the gradients of its contiguous block of
shards, sums them in fixed shard order into the fused float32 buckets,
and ``distrib.collectives.RingAllReduce`` sums the buckets across
localities through the gradient codec; every locality then applies the
same optimizer update to the same averaged gradient.  The port runs the
ring at world 1 only (the wire is ROADMAP item 12, and so is
``ddp_shadow_train``, the loop a worker locality runs): one locality owns
every shard, and with ``onebit`` each step still quantizes and
dequantizes every bucket (K3a and K3b).

The buckets stay on the device: where the reference sums numpy copies of
the buckets (``frontend/ddp.py:132``), the port adds each shard's buckets
into the first shard's in place, and the loss stays a device scalar.
"""
from __future__ import annotations

import torch

from ..core import steps as steps_lib
from ..data.pipeline import to_device

__all__ = ["DDPEngine", "shard_batch"]


def shard_batch(batch: dict, shard: int, n_shards: int) -> dict:
    """Row shard ``shard`` of ``n_shards`` of a batch dict: contiguous
    dim-0 slices, so shards 0..n-1 concatenate back to the batch.

    Raises:
        ValueError: a batch dim is not divisible by ``n_shards``.
    """
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % n_shards:
            raise ValueError(f"batch field {k!r} has {n} rows, not "
                             f"divisible into {n_shards} ddp shards")
        per = n // n_shards
        out[k] = v[shard * per:(shard + 1) * per]
    return out


class DDPEngine:
    """One locality's half of a DDP run: local gradients in, globally
    averaged update out.  ``rank`` owns the contiguous shard block
    ``[rank*S/W, (rank+1)*S/W)`` of the ``S = plan.ddp_shards or world``
    batch shards.

    Args:
        plan: the run's ``Plan`` (``ddp=True``).
        ring: this locality's ``RingAllReduce`` (configured here, for the
            plan's device).
    Raises:
        ValueError: shard count not divisible by the world size, batch
            not divisible by the shard count, or an unsupported strategy
            (see ``core.steps.make_ddp_step``).
    """

    def __init__(self, plan, ring):
        self.plan = plan
        self.ring = ring
        self.world = ring.world
        self.device = torch.device(plan.device)
        shards = plan.ddp_shards or self.world
        if shards % self.world:
            raise ValueError(f"ddp_shards={shards} must be a multiple of "
                             f"the locality count {self.world}")
        if plan.batch % shards:
            raise ValueError(f"batch={plan.batch} must be divisible by "
                             f"ddp_shards={shards}")
        self.shards = shards
        self.step = steps_lib.make_ddp_step(plan=plan)
        self.codec = ring.configure(plan.grad_codec, self.step.grad_plan,
                                    device=self.device)
        #: exact payload bytes ONE locality sends per exchange hop
        self.codec_bytes = self.codec.wire_bytes(self.step.grad_plan)
        per = shards // self.world
        self.owned = range(ring.rank * per, (ring.rank + 1) * per)

    def init(self):
        """Deterministic (params, opt) from ``Plan.seed``."""
        return self.step.init(
            torch.Generator(device=self.device).manual_seed(self.plan.seed),
            self.device)

    def train_step(self, it: int, batch: dict, params, opt):
        """One DDP step: owned-shard gradients -> ring all-reduce ->
        optimizer update (in place).

        Args:
            it: step index (keys the ring exchange).
            batch: the GLOBAL numpy batch dict for step ``it``.
        Returns:
            ``(metrics, params, opt)`` with ``metrics["loss"]`` the global
            mean loss and ``metrics["grad_norm"]`` the post-average
            gradient norm, both float32 device scalars.
        """
        step = self.step
        part = None
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for s in self.owned:                    # fixed shard order
            sb = to_device(shard_batch(batch, s, self.shards), self.device)
            l, bufs = step.grad_fn(params, sb)
            loss = loss + l
            if part is None:
                part = bufs
            else:
                for a, b in zip(part, bufs):
                    a.add_(b)
                del bufs
        summed, metas = self.ring.allreduce(it, part, meta={"loss": loss})
        del part
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for o in range(self.world):             # fixed rank order
            total = total + metas[o]["loss"]
        ns = float(self.shards)
        for b in summed:                        # the mean, in place
            b.div_(ns)
        gnorm, params, opt = step.apply_fn(summed, params, opt)
        return ({"loss": total / ns, "grad_norm": gnorm}, params, opt)
