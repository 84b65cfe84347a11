"""Step builders: train, fabric-DDP grad/apply, prefill and decode.

Counterpart: ``repro/core/steps.py:38-57,71-72,120-437,473-542``
(``Strategy``, ``TrainStep``/``make_train_step``, ``DDPStep``/
``make_ddp_step``, ``_serve_cfg``, ``ServeStep``, ``make_prefill_step``,
``make_decode_step``).  ``fn`` is a plain callable: PyTorch runs eagerly,
on one device, so there is no jit, mesh or sharding to build.

Training runs on one device.  There the reference's dp axes are size 1
and dropped (``steps.py:193-196``), so ``phylanx`` and ``horovod`` are the
same plain update; ``zero1`` and ``onebit`` shard or compress across those
axes and wait for the mesh-parallel strategies (ROADMAP item 14).  Where
JAX donates the parameters and the optimizer state to the step, the port
updates them in place (``optim.update``) and returns the same objects.
Serving runs the model with bfloat16 parameters and no
rematerialization, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from . import fusion
from .sharding import init_params
from ..models.model import build_model
from ..optim import compression
from ..optim import optimizers as optim
from ..optim.optimizers import OptConfig

_STRATEGIES = ("phylanx", "horovod", "zero1", "onebit")


# ---------------------------------------------------------------------------
# Strategy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Strategy:
    """The reference's fields that act on one device; its ``bucket_bytes``
    and ``sequence_parallel`` act on the dp and model mesh axes and come
    with them (ROADMAP item 14)."""
    name: str = "phylanx"            # phylanx | horovod | zero1 | onebit
    grad_accum: int = 1
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)


def _resolve(plan, cfg, strategy):
    if plan is not None:
        cfg = cfg if cfg is not None else plan.config()
        strategy = strategy if strategy is not None \
            else plan.build_strategy()
    return cfg, strategy or Strategy()


def _init(specs, oc: OptConfig, generator, device):
    """Parameters from ``specs`` (requiring grad) and their zero state."""
    params = init_params(specs, generator, device)
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    return params, optim.init(params, oc)


def _grad_leaves(params) -> list:
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
        p.grad = None
    return leaves


def _grads(leaves, unread) -> list:
    """The leaves' gradients after a backward pass.  A parameter the model
    declares ``unread`` (``model.unread``: whisper's cross ``bk``/``bv``)
    gets zeros, as ``jax.grad`` gives; any other leaf without a gradient
    was cut from the graph, and raises."""
    skip = {id(t) for t in unread}
    lost = [i for i, p in enumerate(leaves)
            if p.grad is None and id(p) not in skip]
    if lost:
        raise RuntimeError(f"parameter leaves {lost} got no gradient: the "
                           f"loss does not reach them")
    return [torch.zeros_like(p) if p.grad is None else p.grad
            for p in leaves]


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainStep:
    # the buffers fn takes over per call: updated in place where the
    # reference donates them (donate_argnums=(0, 1)); the phylint
    # step-contract builder lints against this declaration
    donated_buffers = ("params", "opt")
    fn: Any          # (params, opt, batch) -> (metrics, params, opt)
    model: Any = None
    specs: Any = None            # ParamSpec tree
    strategy: Any = None

    def init(self, generator: torch.Generator, device):
        """(params, opt) on ``device``, parameters drawn from
        ``generator``."""
        return _init(self.specs, self.strategy.opt, generator, device)


def make_train_step(cfg=None, strategy: Optional[Strategy] = None, *,
                    plan=None) -> TrainStep:
    """``fn(params, opt, batch) -> (metrics, params, opt)``: loss and
    gradients (``grad_accum`` micro-batches of the batch rows, their loss
    and gradients averaged), then the dense optimizer update in place.
    ``metrics`` holds ``loss`` and ``grad_norm`` as device scalars.

    Raises:
        NotImplementedError: ``zero1`` or ``onebit`` (ROADMAP item 14).
        ValueError: an unknown strategy.
    """
    cfg, strategy = _resolve(plan, cfg, strategy)
    if strategy.name not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy.name!r}")
    if strategy.name in ("zero1", "onebit"):
        raise NotImplementedError(
            f"strategy {strategy.name!r} shards or compresses over the "
            f"in-process dp axes: mesh-parallel strategies, ROADMAP item 14")
    model = build_model(cfg)
    oc = strategy.opt
    k = max(strategy.grad_accum, 1)

    def fn(params, opt_state, batch):
        leaves = _grad_leaves(params)
        rows = next(iter(batch.values())).shape[0]
        if rows % k:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"grad_accum={k} micro-batches")
        if k == 1:
            loss = model.loss(params, batch)
            loss.backward()
            grads = _grads(leaves, model.unread(params))
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for i in range(k):
                mb = {n: v[i * rows // k:(i + 1) * rows // k]
                      for n, v in batch.items()}
                micro = model.loss(params, mb)
                micro.backward()
                loss = loss + micro.detach() / k
                for g, p, mg in zip(grads, leaves,
                                    _grads(leaves, model.unread(params))):
                    g.add_(mg / k)
                    p.grad = None
        for p in leaves:
            p.grad = None
        params, opt_state, m = optim.update(
            pytree.tree_unflatten(grads, pytree.tree_structure(params)),
            opt_state, params, oc)
        return {"loss": loss, "grad_norm": m["grad_norm"]}, params, opt_state

    return TrainStep(fn=fn, model=model, specs=model.specs(),
                     strategy=strategy)


# ---------------------------------------------------------------------------
# DDP step (data parallelism over the fabric's gradient ring)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DDPStep:
    """Split train step for fabric DDP: ``grad_fn`` gives the local loss
    and the fused float32 gradient buckets (``grad_plan``); the ring sums
    them across localities; ``apply_fn`` applies the optimizer update to
    the summed-and-averaged buckets."""

    # apply_fn updates (params, opt) in place where the reference's
    # apply donates them (donate_argnums=(1, 2)); phylint lints against it
    donated_buffers = ("params", "opt")
    grad_fn: Any     # (params, batch) -> (loss, [bufs])
    apply_fn: Any    # ([bufs], params, opt) -> (gnorm, params, opt)
    model: Any = None
    specs: Any = None            # ParamSpec tree
    grad_plan: Any = None        # FusionPlan for the wire buckets
    strategy: Any = None

    def init(self, generator: torch.Generator, device):
        """Deterministic (params, opt) from ``generator``: identical on
        every locality fed the same seed."""
        return _init(self.specs, self.strategy.opt, generator, device)


def make_ddp_step(cfg=None, strategy: Optional[Strategy] = None, *,
                  plan=None) -> DDPStep:
    """Build the split grad/apply step pair for fabric DDP.  Gradient
    buckets come from ``optim.compression.make_plan`` with ``dp=1``: the
    wire codec owns the data-parallel exchange.  ``grad_fn`` frees each
    parameter's ``.grad`` once it has been packed into its bucket.

    Raises:
        ValueError: strategy is zero1 or uses grad accumulation, as in
            the reference.
    """
    cfg, strategy = _resolve(plan, cfg, strategy)
    if strategy.name == "zero1":
        raise ValueError("ddp=True cannot use the zero1 strategy: its "
                         "optimizer state is dp-sharded inside one process, "
                         "but fabric DDP replicates state per locality")
    if strategy.grad_accum > 1:
        raise ValueError("ddp=True with grad_accum > 1 is not supported "
                         "yet; raise Plan.ddp_shards instead")
    model = build_model(cfg)
    specs = model.specs()
    f32_specs = pytree.tree_map(
        lambda s: dataclasses.replace(s, dtype=torch.float32), specs,
        is_leaf=lambda x: hasattr(x, "dims"))
    gplan = compression.make_plan(f32_specs, 1)
    oc = strategy.opt

    def grad_fn(params, batch):
        leaves = _grad_leaves(params)
        loss = model.loss(params, batch)
        loss.backward()
        grads = _grads(leaves, model.unread(params))
        for p in leaves:
            p.grad = None
        bufs = []
        for i, b in enumerate(gplan.buckets):
            bufs.append(fusion.pack_bucket(grads, gplan, i))
            for e in b.entries:          # packed: free the leaves' grads
                for m in gplan.members[e.index]:
                    grads[m] = None
        return loss.detach().float(), bufs

    def apply_fn(bufs, params, opt_state):
        grads = fusion.unpack(bufs, gplan)
        params, opt_state, m = optim.update(grads, opt_state, params, oc)
        return m["grad_norm"], params, opt_state

    return DDPStep(grad_fn=grad_fn, apply_fn=apply_fn, model=model,
                   specs=specs, grad_plan=gplan, strategy=strategy)


def _serve_cfg(cfg):
    return dataclasses.replace(cfg, param_dtype="bf16", remat=False)


@dataclasses.dataclass
class ServeStep:
    # decode updates the cache in place where the reference donates it
    # (donate_argnums=(1,)); phylint lints against this declaration
    donated_buffers = ("cache",)
    fn: Any
    model: Any
    specs: Any
    cache_specs: Any


def make_prefill_step(cfg, shape: dict) -> ServeStep:
    """``fn(params, batch) -> (last-token logits, cache)``; the cache is
    padded to ``shape["seq_len"]``.  ``batch`` holds ``"tokens"``, and for
    the encdec family also the encoder's ``"frames"``."""
    scfg = _serve_cfg(cfg)
    model = build_model(scfg)
    S = shape["seq_len"]

    def fn(params, batch):
        return model.prefill(params, batch, S)

    return ServeStep(fn=fn, model=model, specs=model.specs(),
                     cache_specs=model.cache_specs(shape["global_batch"], S))


def make_decode_step(cfg, shape: dict) -> ServeStep:
    """``fn(params, cache, batch, pos) -> (logits, cache)``.  The cache is
    updated in place and returned: this stands in for JAX's
    ``donate_argnums=(1,)``, so the caller must not reuse the cache it
    passed in as the state before the step."""
    scfg = _serve_cfg(cfg)
    model = build_model(scfg)

    def fn(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos)

    return ServeStep(fn=fn, model=model, specs=model.specs(),
                     cache_specs=model.cache_specs(shape["global_batch"],
                                                   shape["seq_len"]))
