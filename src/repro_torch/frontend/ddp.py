"""Fabric DDP: the per-locality train engine behind ``Plan(ddp=True)``.

Counterpart: ``repro/frontend/ddp.py`` (``shard_batch``, ``DDPEngine``,
``ddp_shadow_train``).  The global batch is split into ``Plan.ddp_shards``
row shards; a locality computes the gradients of its contiguous block of
shards, sums them in fixed shard order into the fused float32 buckets,
and ``distrib.collectives.RingAllReduce`` sums the buckets across
localities through the gradient codec; every locality then applies the
same optimizer update to the same averaged gradient, so parameters stay
replicated without ever being exchanged.  With ``onebit`` every step
quantizes each locality's buckets on its device (K3a) and dequantizes
every origin's payload there (K3b).

Determinism is the contract: every locality draws the same step-keyed
batch (``stream.batch_at(it)``), slices its shards by rows, and both the
partial sums and the ring's combine run in fixed shard and rank order.
With the fp32 codec a W-locality run is bit-identical in loss to a
1-locality run over the same ``ddp_shards``.

The buckets stay on the device: where the reference sums numpy copies of
the buckets (``frontend/ddp.py:132``), the port adds each shard's buckets
into the first shard's in place.  At world 1 the loss stays a device
scalar; across localities each shard block's loss crosses the wire as a
float32 numpy scalar and is summed on the device in rank order.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..core import steps as steps_lib
from ..data.pipeline import stream_for, to_device
from ..kernels import KERNELS

__all__ = ["DDPEngine", "ddp_shadow_train", "shard_batch"]


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
        gen: explicit ring generation (the driver's, shipped in the
            ``ddp_train`` spec); None lets the ring self-increment.
    Raises:
        ValueError: shard count not divisible by the world size, batch
            not divisible by the shard count, or an unsupported strategy
            (see ``core.steps.make_ddp_step``).
    """

    def __init__(self, plan, ring, *, gen: Optional[int] = None):
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
                                    device=self.device, gen=gen)
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
        if self.world > 1:       # the shard loss crosses the wire as numpy
            loss = loss.cpu().numpy()
        summed, metas = self.ring.allreduce(it, part, meta={"loss": loss})
        del part
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for o in range(self.world):             # fixed rank order
            total = total + torch.as_tensor(metas[o]["loss"],
                                            device=self.device)
        ns = float(self.shards)
        for b in summed:                        # the mean, in place
            b.div_(ns)
        gnorm, params, opt = step.apply_fn(summed, params, opt)
        return ({"loss": total / ns, "grad_norm": gnorm}, params, opt)


def ddp_shadow_train(spec: dict, endpoint: Optional[Any] = None,
                     ring=None) -> dict:
    """What a worker locality runs for ``Plan(ddp=True)``: the DDP loop
    over this locality's shard block, on the device of the plan in
    ``spec`` (a CUDA plan without a GPU raises).

    Checkpoints are driver-only in DDP mode - parameters are replicated,
    so the driver's save is the global state; on ``resume`` this loop
    restores the same latest checkpoint from the shared directory.

    Args:
        spec: ``{"plan", "steps", "ckpt_dir", "resume", "stream", "gen"}``
            as posted by ``DistributedGraph.ddp_train``.
        endpoint: this locality's active-message ``Endpoint``.
        ring: the locality's long-lived ``RingAllReduce``; built from
            ``endpoint`` when None (test use).
    Returns:
        dict with ``step``, ``grad_wire_bytes`` (payload bytes this
        locality sent), ``final_loss`` and ``launches``: the launches of
        each kernel wrapper during this loop, by wrapper name.  The
        launch counts are the port's own addition, so that a driver can
        see that every locality's steps ran the kernels (the K3 codec's
        above all); the reference has no kernel counts.
    Raises:
        RuntimeError: the plan asks for CUDA and there is none.
    """
    plan = spec["plan"]
    if torch.device(plan.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(f"Plan(device={plan.device!r}) on a locality "
                           f"without a GPU")
    steps: int = spec["steps"]
    ckpt_dir: str = spec.get("ckpt_dir") or ""
    if ring is None:
        from ..distrib.collectives import RingAllReduce
        ring = RingAllReduce(endpoint, plan.localities)
    before = {fn.__name__: fn.launches for fn in KERNELS}
    engine = DDPEngine(plan, ring, gen=spec.get("gen"))
    params, opt = engine.init()
    start = 0
    if spec.get("resume") and ckpt_dir:
        with CheckpointManager(ckpt_dir, async_save=False) as cm:
            if cm.latest_step() is not None:
                start, (params, opt) = cm.restore((params, opt))
    stream = spec.get("stream")
    if stream is None:
        stream = stream_for(plan.config(), batch=plan.batch, seq=plan.seq,
                            seed=plan.seed)
    metrics = None
    try:
        for it in range(start, steps):
            metrics, params, opt = engine.train_step(
                it, stream.batch_at(it), params, opt)
    finally:
        ring.deactivate()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return {"step": steps, "grad_wire_bytes": int(ring.wire_bytes),
            "final_loss": (float(metrics["loss"])
                           if metrics is not None else float("nan")),
            "launches": {fn.__name__: fn.launches - before[fn.__name__]
                         for fn in KERNELS}}
