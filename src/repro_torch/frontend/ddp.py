"""Fabric DDP: the per-locality train engine behind ``Plan(ddp=True)``.

Counterpart: ``repro/frontend/ddp.py`` (``shard_batch``, ``DDPEngine``,
``ddp_shadow_train``).  The global batch is split into ``Plan.ddp_shards``
row shards; a locality computes the gradients of its contiguous block of
shards, sums them in fixed shard order, packs them into the fused float32
buckets, and ``distrib.collectives.RingAllReduce`` sums the buckets across
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

The gradients stay on the device: where the reference sums numpy copies
of the buckets (``frontend/ddp.py:132``), the port adds each shard's
gradient leaves into the first shard's in place (the same float32 sums,
element for element), then packs one bucket at a time, letting each leaf
go once packed.  At world 1 the loss stays a device scalar; across
localities each shard block's loss crosses the wire as a float32 numpy
scalar and is summed on the device in rank order.

One step serves every layout: the mesh train step's gradient and update
halves (``TrainStep.grads``, ``TrainStep.apply``) on this process's
mesh, which without a model axis is a mesh of one, where the gathers
and the broadcast below are no-ops.  Beside a model axis
(``Plan(ddp=True, model=M)``) each locality is a model group of M rank
processes (its own gloo world, ``Session.ranks`` holding the ranks but
coordinate 0), laid out row-major as a mesh lays out a dp axis: process
``locality * M + m``.  Every rank computes its blocks' gradients of the
locality's shards under the activation hook, as the mesh train step
does.  The wire is the
reference's: its buckets are ``make_plan`` over the GLOBAL float32
leaves with ``dp=1`` (``repro/core/steps.py:408``), the buckets of
``model=1``.  So model coordinate 0 is the locality's member of the ring:
it gathers the group's split leaves into one global bucket at a time, on
the device (``compression.global_bucket``, a collective over the model
group), the codec encodes it (K3a for onebit, with the residual of the
global buckets kept there, one per locality as in the reference), the
ring runs over ``L`` members, and each summed bucket is decoded (K3b),
divided and broadcast over the group as soon as it is made, each rank
cutting its blocks (``compression.bucket_blocks``).  The wire therefore
carries exactly ``model=1``'s payloads (``codec_bytes`` the
reference's), and an fp32 ``L``-locality run is bit-identical to one
locality over the same shards at the same ``M``, since summing blocks
and gathering commute exactly.  The update takes the global norm over
the model group; every leaf that stays whole gets the same broadcast
mean on every rank and stays bit-identical.  A save gathers the driver
locality's blocks into the reference's global layout; its other ranks
join that gather (``ddp_rank_train``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from ..checkpoint.checkpoint import CheckpointManager
from ..core import collectives
from ..core import steps as steps_lib
from ..data.pipeline import stream_for, to_device
from ..distrib.collectives import get_codec
from ..kernels import KERNELS
from ..optim import compression

__all__ = ["DDPEngine", "ddp_rank_train", "ddp_shadow_train", "shard_batch"]


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

    On a model axis (``mesh`` with ``model > 1``, the locality's own
    world of ``model`` ranks) every rank of the locality's model group
    builds an engine: model coordinate 0 holds the ``ring``, the others
    pass None with the locality's ``world`` and ``rank`` (see the module
    docstring).

    Args:
        plan: the run's ``Plan`` (``ddp=True``).
        ring: this locality's ``RingAllReduce`` (configured here, for the
            plan's device); None on a model group's other ranks.
        gen: explicit ring generation (the driver's, shipped in the
            ``ddp_train`` spec); None lets the ring self-increment.
        mesh: the locality's model mesh (None: one process).
        world, rank: the ring's size and this locality's place in it,
            where ``ring`` is None.
        probe: the codec's measurement seam (``GradCodec.probe``; None
            in runs).
    Raises:
        ValueError: shard count not divisible by the world size, batch
            not divisible by the shard count, or an unsupported strategy
            (``core.steps.check_ddp``).
    """

    def __init__(self, plan, ring, *, gen: Optional[int] = None,
                 mesh=None, world: Optional[int] = None,
                 rank: Optional[int] = None, probe=None):
        self.plan = plan
        self.ring = ring
        self.world = ring.world if ring is not None else int(world)
        self.rank = ring.rank if ring is not None else int(rank)
        self.device = torch.device(plan.device)
        shards = plan.ddp_shards or self.world
        if shards % self.world:
            raise ValueError(f"ddp_shards={shards} must be a multiple of "
                             f"the locality count {self.world}")
        if plan.batch % shards:
            raise ValueError(f"batch={plan.batch} must be divisible by "
                             f"ddp_shards={shards}")
        self.shards = shards
        strategy = plan.build_strategy()
        steps_lib.check_ddp(strategy, mesh)
        # this rank's blocks (the whole model without a model axis): the
        # mesh train step's gradient and update halves, the exchange left
        # to the fabric
        self.tstep = steps_lib.make_train_step(
            plan.config(), dataclasses.replace(strategy, name="phylanx"),
            plan=plan, mesh=mesh)
        self.mesh = self.tstep.mesh
        self.specs = pytree.tree_leaves(self.tstep.specs,
                                        is_leaf=steps_lib.is_spec)
        self.grad_plan = steps_lib.ddp_grad_plan(self.tstep.specs)
        if ring is not None:
            self.codec = ring.configure(plan.grad_codec, self.grad_plan,
                                        device=self.device, gen=gen)
            self.codec.probe = probe
        #: exact payload bytes ONE locality sends per exchange hop
        self.codec_bytes = get_codec(plan.grad_codec).wire_bytes(
            self.grad_plan)
        per = shards // self.world
        self.owned = range(self.rank * per, (self.rank + 1) * per)

    def init(self):
        """Deterministic (params, opt) from ``Plan.seed`` (this rank's
        blocks of the one-process init on a model axis)."""
        return self.tstep.init(
            torch.Generator(device=self.device).manual_seed(self.plan.seed),
            self.device)

    def state(self, params, opt):
        """The train state in the reference's global layout (a collective
        over the model group on a model axis: every rank calls it)."""
        return (self.tstep.gather_params(params),
                self.tstep.gather_opt(opt))

    def restore(self, cm, params, opt):
        """``(step, params, opt)`` of ``cm``'s latest checkpoint (this
        rank's blocks on a model axis), or ``(0, params, opt)``."""
        if cm.latest_step() is None:
            return 0, params, opt
        ts = self.tstep
        start, (pg, og) = cm.restore((ts.params_like(), ts.global_like()))
        return start, ts.shard_params(pg, self.device), \
            ts.shard_opt(og, self.device)

    def train_step(self, it: int, batch: dict, params, opt):
        """One DDP step: this rank's blocks' gradients of the owned
        shards, summed in shard order; model coordinate 0 gathers them
        into the reference's global buckets one at a time (letting each
        leaf go once packed), runs the ring over them and hands each rank
        its blocks of every mean bucket (a broadcast over the model group;
        without a model axis the gathers and the broadcast are no-ops);
        then the optimizer update (in place).

        Args:
            it: step index (keys the ring exchange).
            batch: the GLOBAL numpy batch dict for step ``it``.
        Returns:
            ``(metrics, params, opt)`` with ``metrics["loss"]`` the global
            mean loss and ``metrics["grad_norm"]`` the post-average
            gradient norm, both float32 device scalars.
        """
        ts, mesh, gplan = self.tstep, self.mesh, self.grad_plan
        part = None
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for s in self.owned:                    # fixed shard order
            sb = to_device(shard_batch(batch, s, self.shards), self.device)
            l, g = ts.grads(params, sb)
            loss = loss + l
            g = pytree.tree_leaves(g)
            if part is None:
                part = g
            else:
                for a, b in zip(part, g):
                    a.add_(b)
                del g
        ns, n_buckets = float(self.shards), len(gplan.buckets)
        mine: list = [None] * len(part)

        def gathered():
            for i in range(n_buckets):
                buf = compression.global_bucket(part, gplan, i, self.specs,
                                                mesh, ts.rules)
                for e in gplan.buckets[i].entries:    # packed: let go
                    for m in gplan.members[e.index]:
                        part[m] = None
                yield buf

        def take(i: int, mean: torch.Tensor) -> None:
            compression.bucket_blocks(mine, mean, gplan, i, self.specs,
                                      mesh, ts.rules)

        if self.ring is not None:
            meta = loss.cpu().numpy() if self.world > 1 else loss
            _, metas = self.ring.allreduce(
                it, gathered(), meta={"loss": meta},
                consume=lambda i, s: take(i, collectives.broadcast(
                    s.div_(ns), mesh)))
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for o in range(self.world):         # fixed rank order
                total = total + torch.as_tensor(metas[o]["loss"],
                                                device=self.device)
        else:
            for _ in gathered():                # the leader packs them
                pass
            for i in range(n_buckets):
                take(i, collectives.broadcast(torch.empty(
                    gplan.buckets[i].size, dtype=torch.float32,
                    device=self.device), mesh))
            total = torch.zeros((), dtype=torch.float32, device=self.device)
        del part
        total = collectives.broadcast(total, mesh)
        grads = pytree.tree_unflatten(mine, pytree.tree_structure(params))
        params, opt, m = ts.apply(grads, opt, params)
        return ({"loss": total / ns, "grad_norm": m["grad_norm"]}, params,
                opt)


def _fails(spec: dict, it: int) -> bool:
    return spec.get("fail_at_step") == it and not spec.get("resume")


def ddp_shadow_train(spec: dict, endpoint: Optional[Any] = None,
                     ring=None) -> dict:
    """What a worker locality runs for ``Plan(ddp=True)``: the DDP loop
    over this locality's shard block, on the device of the plan in
    ``spec`` (a CUDA plan without a GPU raises).  On a model axis this
    process is its locality's model coordinate 0 (``ddp_rank_train``
    runs on the others).

    Checkpoints are driver-only in DDP mode - parameters are replicated,
    so the driver's save is the global state; on ``resume`` this loop
    restores the same latest checkpoint from the shared directory.

    Args:
        spec: ``{"plan", "steps", "ckpt_dir", "resume", "stream", "gen",
            "fail_at_step"}`` as posted by ``DistributedGraph.ddp_train``
            (the injected failure raises here at the driver's step, so
            that no model group waits on a locality that stopped).
        endpoint: this locality's active-message ``Endpoint``.
        ring: the locality's long-lived ``RingAllReduce``; built from
            ``endpoint`` when None (test use).
    Returns:
        dict with ``step``, ``grad_wire_bytes`` (payload bytes this
        locality sent), ``final_loss``, ``launches`` (the launches of
        each kernel wrapper during this loop, by wrapper name), ``wire``
        (``core.collectives.stats``: the model group's traffic),
        ``peak_bytes`` (the device's peak allocation, 0 on the CPU) and
        ``probe`` (``spec["probe"].report(engine, params)``: a
        measurement seam, None in runs).  The launch counts are the port's own addition, so that
        a driver can see that every locality's steps ran the kernels (the
        K3 codec's above all); the reference has no kernel counts.
    Raises:
        RuntimeError: the plan asks for CUDA and there is none.
    """
    plan = spec["plan"]
    if torch.device(plan.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(f"Plan(device={plan.device!r}) on a locality "
                           f"without a GPU")
    if ring is None:
        from ..distrib.collectives import RingAllReduce
        ring = RingAllReduce(endpoint, plan.localities)
    try:
        out = _ddp_loop(spec, lambda mesh: DDPEngine(
            plan, ring, gen=spec.get("gen"), mesh=mesh,
            probe=spec.get("probe")))
    finally:
        ring.deactivate()
    out["grad_wire_bytes"] = int(ring.wire_bytes)
    return out


def ddp_rank_train(spec: dict, endpoint: Optional[Any] = None, *,
                   driver: Optional[Any] = None) -> dict:
    """What a model group's rank other than coordinate 0 runs for
    ``Plan(ddp=True, model=M)`` (a ``Session.run_ranks``-style loop over
    the rank processes): the same steps on its blocks, its locality read
    from its place (``launch.mesh.place_of``); on the driver's locality
    it joins every save's gather.  Returns ``ddp_shadow_train``'s dict
    but ``grad_wire_bytes``."""
    from ..launch.mesh import place_of
    place = place_of()
    locality = int(place["locality"]) if place is not None else 0
    plan = spec["plan"]
    return _ddp_loop(spec, lambda mesh: DDPEngine(
        plan, None, mesh=mesh, world=max(plan.localities, 1),
        rank=locality), saves=locality == 0)


def _ddp_loop(spec: dict, make_engine, *, saves: bool = False) -> dict:
    plan = spec["plan"]
    steps: int = spec["steps"]
    ckpt_dir: str = spec.get("ckpt_dir") or ""
    every = int(spec.get("ckpt_every") or 0) if saves and ckpt_dir else 0
    if spec.get("num_threads"):
        torch.set_num_threads(int(spec["num_threads"]))
    mesh = None
    if plan.model > 1:
        from ..launch.mesh import make_local_mesh
        mesh = make_local_mesh(model=plan.model)
    before = {fn.__name__: fn.launches for fn in KERNELS}
    collectives.reset_stats()
    engine = make_engine(mesh)
    if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(engine.device)
    params, opt = engine.init()
    start = 0
    if spec.get("resume") and ckpt_dir:
        with CheckpointManager(ckpt_dir, async_save=False) as cm:
            start, params, opt = engine.restore(cm, params, opt)
    stream = spec.get("stream")
    if stream is None:
        stream = stream_for(plan.config(), batch=plan.batch, seq=plan.seq,
                            seed=plan.seed)
    metrics = None
    for it in range(start, steps):
        if _fails(spec, it):
            raise RuntimeError(f"injected node failure at step {it}")
        metrics, params, opt = engine.train_step(
            it, stream.batch_at(it), params, opt)
        if every and (it + 1) % every == 0:
            engine.state(params, opt)         # the driver's save gathers
    if every and steps % every and metrics is not None:
        engine.state(params, opt)
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
    probe = spec.get("probe")
    return {"step": steps,
            "final_loss": (float(metrics["loss"])
                           if metrics is not None else float("nan")),
            "launches": {fn.__name__: fn.launches - before[fn.__name__]
                         for fn in KERNELS},
            "wire": collectives.stats(),
            "peak_bytes": (torch.cuda.max_memory_allocated(engine.device)
                           if cuda else 0),
            "probe": (probe.report(engine, params)
                      if probe is not None else None)}
