"""Step builders: train, fabric-DDP grad/apply, prefill and decode.

Counterpart: ``repro/core/steps.py:38-72,120-437,473-542``
(``Strategy``, ``dp_axes``, ``dp_degree``, ``TrainStep``/
``make_train_step``, ``DDPStep``/``make_ddp_step``, ``_serve_cfg``,
``ServeStep``, ``make_prefill_step``, ``make_decode_step``).  ``fn`` is a
plain callable: PyTorch runs eagerly, so there is no jit to build.

The train step runs on a mesh of rank processes (``launch/mesh.py``):
each rank computes the loss and gradients of its own rows of the global
batch (contiguous rows by dp rank, the whole batch on every rank when it
does not divide, as the reference's ``batch_shardings``), exchanges over
the mesh's dp group with the strategy's exchange (``core/overlap.py``:
``horovod``, ``phylanx``, ``zero1``; ``optim/compression.py``:
``onebit``), and ends with the same parameters as every other rank.  At
a dp degree of 1 (``mesh=None`` included) every exchange is dropped and
``onebit`` is the plain update, as in the reference.  The reference's
``sequence_parallel`` acts on the model axis, ROADMAP item 14b.  Where
JAX donates the parameters and the optimizer state to the step, the port
updates them in place and returns the same objects; ``fn_nodonate``
leaves its inputs as they were (the resilience modes replay from them).
Serving runs the model with bfloat16 parameters and no
rematerialization, as in JAX.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from . import collectives, fusion, overlap
from .granularity import GrainPolicy
from .sharding import ParamSpec, default_rules, init_params, is_spec, \
    spec_for
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
    """The reference's fields but ``sequence_parallel``, which acts on
    the model axis (ROADMAP item 14b)."""
    name: str = "phylanx"            # phylanx | horovod | zero1 | onebit
    bucket_bytes: int = 0            # 0 -> runtime-adaptive (GrainPolicy)
    grad_accum: int = 1
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)

    def resolve_bucket_bytes(self, cfg, mesh, n_tensors: int,
                             shape: dict) -> int:
        if self.bucket_bytes:
            return self.bucket_bytes
        tot, _ = cfg.n_params()
        dec = GrainPolicy.derive(
            n_params=tot, n_tensors=n_tensors,
            global_batch=shape.get("global_batch", 8),
            seq=shape.get("seq_len", 1024), d_model=cfg.d_model,
            n_layers=cfg.n_layers, head_dim=max(cfg.head_dim, 1),
            dp_degree=dp_degree(mesh))
        return dec.bucket_bytes


def dp_axes(mesh) -> tuple[str, ...]:
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def dp_degree(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


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


def batch_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: contiguous dim-0 blocks by dp
    rank where the batch divides by the dp degree, the whole batch on
    every rank where it does not (the reference's ``batch_shardings``)."""
    n = dp_degree(mesh)
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape and v.shape[0] % n == 0:
            per = v.shape[0] // n
            v = v[mesh.rank * per:(mesh.rank + 1) * per]
        out[k] = v
    return out


def _copy_tree(tree):
    """A deep copy of a tree of tensors (parameters keep requiring
    grad)."""
    def one(t):
        c = t.detach().clone()
        return c.requires_grad_(True) if t.requires_grad else c
    return pytree.tree_map(one, tree)


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
    fn_nodonate: Any = None      # the same, its inputs left as they were
    model: Any = None
    specs: Any = None            # ParamSpec tree
    strategy: Any = None
    mesh: Any = None
    plan: Any = None             # onebit's FusionPlan
    leaves: Any = None           # zero1: the reference's leaves
    scatter_mask: Any = None     # zero1: per reference leaf
    bucket_bytes: int = 0        # phylanx's fusion cap
    #: onebit: ``exchange_onebit``'s ``on_bucket`` seam (measurement)
    on_bucket: Any = None
    #: what ``fn_nodonate``'s input copies cost this process: calls, bytes
    #: and host seconds (the copies double the state's memory)
    copy_stats: dict = dataclasses.field(default_factory=lambda: {
        "calls": 0, "bytes": 0, "seconds": 0.0})

    def _ndp(self) -> int:
        return dp_degree(self.mesh)

    def init(self, generator: torch.Generator, device):
        """(params, opt) on ``device``, parameters drawn from
        ``generator`` (the same on every rank), the optimizer state in
        this rank's layout."""
        name = self.strategy.name
        if name == "zero1":
            params = init_params(self.specs, generator, device)
            for p in pytree.tree_leaves(params):
                p.requires_grad_(True)
            return params, overlap.zero1_local_state(
                self.leaves, self.scatter_mask, self.mesh, device)
        params, opt = _init(self.specs, self.strategy.opt, generator,
                            device)
        if name == "onebit":
            opt["ef"] = compression.init_error_state(self.plan, device)
        return params, opt

    def opt_structs(self):
        """The optimizer state's specs in the reference's GLOBAL layout
        (``TrainStep.opt_structs`` there): zero1's m and v whole, onebit's
        residual ``[ndp R, ROW]`` a bucket."""
        def zeros():
            return pytree.tree_map(
                lambda s: ParamSpec(s.shape, s.dims, torch.float32, "zeros"),
                self.specs, is_leaf=is_spec)
        if self.strategy.name == "zero1":
            return {"count": ParamSpec((), (), torch.int32, "zeros"),
                    "m": zeros(), "v": zeros()}
        out = optim.init_specs(self.specs, self.strategy.opt)
        if self.strategy.name == "onebit":
            out["ef"] = [ParamSpec((self._ndp() * b.size // compression.ROW,
                                    compression.ROW), (None, None),
                                   torch.float32, "zeros")
                         for b in self.plan.buckets]
        return out

    def global_like(self):
        """Empty CPU tensors in the global layout: a restore template for
        ``(params, opt)``'s optimizer half."""
        return pytree.tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype),
            self.opt_structs(), is_leaf=is_spec)

    def gather_opt(self, opt):
        """The optimizer state in the reference's global layout, on the
        CPU: a collective (every rank of the mesh calls it, in step)."""
        name = self.strategy.name
        if name == "zero1":
            return overlap.zero1_gather_state(
                opt, self.leaves, self.scatter_mask, self.mesh,
                self.specs)
        if name == "onebit":
            out = dict(opt)
            out["ef"] = [collectives.all_gather(e, self.mesh).cpu()
                         for e in opt["ef"]]
            return out
        return opt

    def shard_opt(self, opt_global, device):
        """This rank's optimizer state cut from the global layout (the
        inverse of ``gather_opt``)."""
        name = self.strategy.name
        if name == "zero1":
            return overlap.zero1_shard_state(
                opt_global, self.leaves, self.scatter_mask, self.mesh,
                device)
        out = {k: (v.to(device) if k == "count" else
                   pytree.tree_map(lambda t: t.to(device), v))
               for k, v in opt_global.items() if k != "ef"}
        if name == "onebit":
            n, r = self._ndp(), (self.mesh.rank if self.mesh else 0)
            out["ef"] = [e[r * e.shape[0] // n:(r + 1) * e.shape[0] // n]
                         .to(device, copy=True) for e in opt_global["ef"]]
        return out


def make_train_step(cfg=None, strategy: Optional[Strategy] = None, *,
                    plan=None, mesh=None, shape: Optional[dict] = None
                    ) -> TrainStep:
    """``fn(params, opt, batch) -> (metrics, params, opt)`` on this rank
    of ``mesh`` (None: one process): loss and gradients of this rank's
    rows of the global ``batch`` (``grad_accum`` micro-batches of them,
    their loss and gradients averaged), the loss averaged over the dp
    group, the strategy's exchange and the optimizer update in place.
    ``metrics`` holds ``loss`` and ``grad_norm`` as device scalars.  The
    reference's positional order is ``(cfg, mesh, strategy, shape)``;
    here ``mesh`` and ``shape`` are keywords, so that the one-device
    callers keep theirs.  ``shape`` (``global_batch``, ``seq_len``) sizes
    phylanx's fusion cap (default: the plan's batch and sequence).

    Raises:
        ValueError: an unknown strategy.
    """
    cfg, strategy = _resolve(plan, cfg, strategy)
    if strategy.name not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy.name!r}")
    if shape is None:
        shape = {"global_batch": plan.batch if plan is not None else 8,
                 "seq_len": plan.seq if plan is not None else 1024,
                 "kind": "train"}
    if mesh is None:            # one process: a mesh of one rank
        from ..launch.mesh import Mesh
        mesh = Mesh(shape={"data": 1, "model": 1})
    model = build_model(cfg)
    specs = model.specs()
    oc = strategy.opt
    k = max(strategy.grad_accum, 1)
    ndp = dp_degree(mesh)
    rules = default_rules()
    leaves = overlap.stacked_specs(specs)
    bucket_bytes = strategy.resolve_bucket_bytes(cfg, mesh, len(leaves),
                                                 shape)
    f32 = pytree.tree_map(
        lambda s: dataclasses.replace(s, dtype=torch.float32), specs,
        is_leaf=is_spec)
    onebit_plan = scatter_mask = None
    if strategy.name == "zero1":
        scatter_mask = overlap.zero1_scatter_mask(
            [l.spec for l in leaves], mesh, rules, ndp)
    elif strategy.name == "onebit":
        onebit_plan = compression.make_plan(f32, ndp)

    # tensors safe to coalesce into fused buckets: not sharded on "model"
    def _fusable(sp):
        return not any("model" in ((p,) if isinstance(p, str)
                                   else tuple(p or ()))
                       for p in spec_for(mesh, rules, sp.shape, sp.dims))
    fuse_mask = pytree.tree_map(_fusable, specs, is_leaf=is_spec)

    def grads_of(params, batch):
        leaves_p = _grad_leaves(params)
        rows = next(iter(batch.values())).shape[0]
        if rows % k:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"grad_accum={k} micro-batches")
        if k == 1:
            loss = model.loss(params, batch)
            loss.backward()
            grads = _grads(leaves_p, model.unread(params))
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves_p[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves_p]
            for i in range(k):
                mb = {n: v[i * rows // k:(i + 1) * rows // k]
                      for n, v in batch.items()}
                micro = model.loss(params, mb)
                micro.backward()
                loss = loss + micro.detach() / k
                for g, p, mg in zip(grads, leaves_p,
                                    _grads(leaves_p, model.unread(params))):
                    g.add_(mg / k)
                    p.grad = None
        for p in leaves_p:
            p.grad = None
        return loss, pytree.tree_unflatten(grads,
                                           pytree.tree_structure(params))

    def fn(params, opt_state, batch):
        loss, grads = grads_of(params, batch_rows(batch, mesh))
        loss = collectives.pmean(loss, mesh)
        if strategy.name == "zero1":
            params, opt_state, m = overlap.zero1_update(
                grads, opt_state, params, oc, mesh, leaves, scatter_mask)
        elif strategy.name == "onebit":
            ef = opt_state["ef"]
            if ndp > 1:
                grads, ef = compression.exchange_onebit(
                    grads, ef, mesh, onebit_plan, on_bucket=step.on_bucket)
            inner = {n: v for n, v in opt_state.items() if n != "ef"}
            params, inner, m = optim.update(grads, inner, params, oc)
            opt_state = dict(inner, ef=ef)
        else:
            if ndp > 1:
                grads = (overlap.exchange_horovod(grads, mesh)
                         if strategy.name == "horovod" else
                         overlap.exchange_phylanx(grads, mesh, bucket_bytes,
                                                  fuse_mask=fuse_mask))
            params, opt_state, m = optim.update(grads, opt_state, params, oc)
        return {"loss": loss, "grad_norm": m["grad_norm"]}, params, opt_state

    step = TrainStep(fn=fn, model=model, specs=specs, strategy=strategy,
                     mesh=mesh, plan=onebit_plan, leaves=leaves,
                     scatter_mask=scatter_mask, bucket_bytes=bucket_bytes)

    def fn_nodonate(params, opt_state, batch):
        dev = pytree.tree_leaves(params)[0].device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state = _copy_tree(params), _copy_tree(opt_state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        st = step.copy_stats
        st["calls"] += 1
        st["bytes"] += sum(t.numel() * t.element_size() for t in
                           pytree.tree_leaves((params, opt_state)))
        st["seconds"] += time.perf_counter() - t0
        return fn(params, opt_state, batch)

    step.fn_nodonate = fn_nodonate
    return step


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
                  plan=None, mesh=None) -> DDPStep:
    """Build the split grad/apply step pair for fabric DDP.  Gradient
    buckets come from ``optim.compression.make_plan`` with ``dp=1``: the
    wire codec owns the data-parallel exchange.  ``grad_fn`` frees each
    parameter's ``.grad`` once it has been packed into its bucket.

    Raises:
        ValueError: strategy is zero1, uses grad accumulation, or the
            mesh has a dp axis > 1, as in the reference.
    """
    cfg, strategy = _resolve(plan, cfg, strategy)
    if strategy.name == "zero1":
        raise ValueError("ddp=True cannot use the zero1 strategy: its "
                         "optimizer state is dp-sharded inside one process, "
                         "but fabric DDP replicates state per locality")
    if strategy.grad_accum > 1:
        raise ValueError("ddp=True with grad_accum > 1 is not supported "
                         "yet; raise Plan.ddp_shards instead")
    if dp_degree(mesh) > 1:
        raise ValueError("ddp=True replaces the in-process dp axes: use a "
                         "mesh with data=pod=1 (model-axis sharding is fine)")
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
