"""Step builders: train, fabric-DDP grad/apply, prefill and decode.

Counterpart: ``repro/core/steps.py:38-72,120-437,454-542``
(``Strategy``, ``dp_axes``, ``dp_degree``, ``TrainStep``/
``make_train_step``, ``DDPStep``/``make_ddp_step``, ``_serve_cfg``,
``decode_rules``, ``ServeStep``, ``make_prefill_step``,
``make_decode_step``).  ``fn`` is a plain callable: PyTorch runs eagerly,
so there is no jit to build.

The train step runs on a mesh of rank processes (``launch/mesh.py``):
each rank computes the loss and gradients of its own rows of the global
batch (contiguous rows by dp rank, the whole batch on every rank when it
does not divide, as the reference's ``batch_shardings``), exchanges over
the mesh's dp group with the strategy's exchange (``core/overlap.py``:
``horovod``, ``phylanx``, ``zero1``; ``optim/compression.py``:
``onebit``), and ends with the same parameters as every other rank.  At
a dp degree of 1 (``mesh=None`` included) every exchange is dropped and
``onebit`` is the plain update, as in the reference.

A model axis (every family, and the HAR CNN's channels,
``models/cnn.py``) splits each dp
rank into a model group of rank processes (``launch/mesh.py``): each
holds its blocks of the parameters (``core/sharding.py``), runs the
model under the activation hook (``sharding.act_hook``: vocab-parallel
embedding and loss, Megatron blocks, the experts split, the mamba,
mLSTM and sLSTM layers on a rank's heads, whisper's encoder, decoder and
cross-attention on a rank's heads), sums over its model group the
gradients of the replicated leaves whose use depends on its rank
(``model.partial_mask``: ``q_norm``, ``k_norm``, a replicated
``wk``/``wv``/``bk``/``bv``, a whole mamba ``in_proj`` or conv beside
split heads), exchanges over
its column's dp group on its own blocks, and takes the global gradient
norm over the model group (``optim.global_norm``).  The serve steps tile
the KV cache by ``decode_rules`` on any mesh: each dp rank serves its
rows of the batch (``ServeStep.rows``, gathered back by
``ServeStep.gather_rows``), and a single stream (batch 1) tiles its
cache by sequence over ``data`` or the whole mesh, every family on data
axes and on a model axis (the steps give
the layers the global batch, ``act_hook(batch=)``: the moe layers route
every dp rank's tokens as the reference routes a serve step's whole
batch).  ``sequence_parallel`` installs the
reference's ``default_rules(sequence_parallel=True)`` for every family:
where the batch's sequence divides by the model axis (and the vocab
splits, as the loss needs), the residual between layers holds each
rank's ``S/M`` rows (``sharding.ModelAxis.seq``; an encoder's by its
frames, ``models/model.py``), and every unsplit leaf's gradient is a
part to sum over the model group; elsewhere, and at a model axis of 1,
it is the plain path, as in the reference.  ``onebit`` on a model axis
packs the reference's global buckets (``compression.exchange_onebit``:
each bucket's split leaves gathered over the model group, its residual
the same on every model rank of a dp coordinate), and the update takes
the global norm over the model group.  Where
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
from .sharding import ModelAxis, ParamSpec, act_hook, default_rules, \
    gather_tree, init_params, is_spec, local_slices, local_specs, \
    model_sharded, shard_tree
from ..models import layers
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
    """The reference's fields."""
    name: str = "phylanx"            # phylanx | horovod | zero1 | onebit
    bucket_bytes: int = 0            # 0 -> runtime-adaptive (GrainPolicy)
    sequence_parallel: bool = False  # shard residual seq dim on "model"
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


def _init(specs, oc: OptConfig, generator, device, mesh=None, rules=None):
    """Parameters from ``specs`` (requiring grad; this rank's blocks on a
    mesh) and their zero state."""
    params = init_params(specs, generator, device, mesh=mesh, rules=rules)
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


def residual_seq(cfg, mesh, rules, batch) -> Optional[int]:
    """The global sequence length by which the residual splits over the
    model group (sequence parallelism), or None: the batch's sequence
    where ``rules`` put ``seq`` on a model axis > 1 that it divides, and
    the model's vocab splits over it too (the loss's exchange is over
    the vocab, of the gathered sequence)."""
    if mesh is None or mesh.model_size == 1 or "tokens" not in batch:
        return None
    n = batch["tokens"].shape[1]
    ax = ModelAxis(mesh, rules)
    return n if ax.split("seq", n) and ax.split("vocab", cfg.vocab) \
        else None


def _sum_partials(grads, mask, mesh):
    """``grads`` with the leaves of ``mask`` summed over the model group
    (one fused exchange)."""
    flat, spec = pytree.tree_flatten(grads)
    picked = {f"{i:08d}": g for i, (g, m) in
              enumerate(zip(flat, pytree.tree_leaves(mask))) if m}
    if not picked:
        return grads
    summed = collectives.fused_psum(picked, mesh, mesh_axis="model")
    for k, g in summed.items():
        flat[int(k)] = g
    return pytree.tree_unflatten(flat, spec)


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
    rules: Any = None            # the tiling plan of the parameters
    split_mask: Any = None       # per leaf: split over the model axis
    #: onebit: ``exchange_onebit``'s ``on_bucket`` seam (measurement)
    on_bucket: Any = None
    #: ``(params, batch) -> (loss, grads)``: this rank's loss and its
    #: blocks' gradients of its rows (the model group's partial sums
    #: taken), before any dp exchange: fabric DDP's gradient half
    grads: Any = None
    #: ``(grads, opt, params) -> (params, opt, metrics)``: the optimizer
    #: update in place, the norm global over the model group
    apply: Any = None
    #: what ``fn_nodonate``'s input copies cost this process: calls, bytes
    #: and host seconds (the copies double the state's memory)
    copy_stats: dict = dataclasses.field(default_factory=lambda: {
        "calls": 0, "bytes": 0, "seconds": 0.0})

    def _ndp(self) -> int:
        return dp_degree(self.mesh)

    def _split(self) -> bool:
        return self.mesh is not None and self.mesh.model_size > 1

    def init(self, generator: torch.Generator, device):
        """(params, opt) on ``device``, parameters drawn from
        ``generator`` (the same on every rank; this rank's blocks of
        them on a model axis), the optimizer state in this rank's
        layout."""
        name = self.strategy.name
        if name == "zero1":
            params = init_params(self.specs, generator, device,
                                 mesh=self.mesh, rules=self.rules)
            for p in pytree.tree_leaves(params):
                p.requires_grad_(True)
            return params, overlap.zero1_local_state(
                self.leaves, self.scatter_mask, self.mesh, device)
        params, opt = _init(self.specs, self.strategy.opt, generator,
                            device, self.mesh, self.rules)
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

    def params_like(self):
        """Empty CPU tensors of the global parameters: a restore template
        for ``(params, opt)``'s parameter half."""
        return pytree.tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype), self.specs,
            is_leaf=is_spec)

    def gather_params(self, params):
        """The global parameters, on the CPU on a model axis (a collective
        over the model group); ``params`` itself otherwise."""
        if not self._split():
            return params
        return gather_tree(params, self.specs, self.mesh, self.rules)

    def shard_params(self, params_global, device):
        """This rank's blocks of the global parameters, on ``device``,
        requiring grad (the inverse of ``gather_params``)."""
        if self._split():
            out = shard_tree(params_global, self.specs, self.mesh,
                             self.rules, device)
        else:
            out = pytree.tree_map(lambda t: t.to(device), params_global)
        for p in pytree.tree_leaves(out):
            p.requires_grad_(True)
        return out

    def _gather_moments(self, out):
        if self._split():
            for k in ("m", "v"):
                if k in out:
                    out[k] = gather_tree(out[k], self.specs, self.mesh,
                                         self.rules)
        return out

    def gather_opt(self, opt):
        """The optimizer state in the reference's global layout, on the
        CPU: a collective (every rank of the mesh calls it, in step)."""
        name = self.strategy.name
        if name == "zero1":
            return self._gather_moments(overlap.zero1_gather_state(
                opt, self.leaves, self.scatter_mask, self.mesh,
                self.specs))
        if name == "onebit":
            # the residual is the same on a dp coordinate's model ranks:
            # gathered over the dp group only
            out = self._gather_moments(dict(opt))
            out["ef"] = [collectives.all_gather(e, self.mesh).cpu()
                         for e in opt["ef"]]
            return out
        return self._gather_moments(dict(opt))

    def shard_opt(self, opt_global, device):
        """This rank's optimizer state cut from the global layout (the
        inverse of ``gather_opt``)."""
        name = self.strategy.name
        if self._split():
            opt_global = dict(opt_global)
            for k in ("m", "v"):
                if k in opt_global:
                    opt_global[k] = shard_tree(opt_global[k], self.specs,
                                               self.mesh, self.rules, "cpu")
        if name == "zero1":
            return overlap.zero1_shard_state(
                opt_global, self.leaves, self.scatter_mask, self.mesh,
                device)
        out = {k: (v.to(device) if k == "count" else
                   pytree.tree_map(lambda t: t.to(device), v))
               for k, v in opt_global.items() if k != "ef"}
        if name == "onebit":         # this dp rank's rows, on every model rank
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

    On a model axis each rank computes on its blocks (the module's
    docstring).

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
    split = mesh.model_size > 1
    model = build_model(cfg)
    specs = model.specs()
    oc = strategy.opt
    k = max(strategy.grad_accum, 1)
    ndp = dp_degree(mesh)
    rules = default_rules(sequence_parallel=strategy.sequence_parallel)
    # the reference's leaves decide (global shapes); this rank's state
    # holds its blocks of them (local shapes)
    global_leaves = overlap.stacked_specs(specs)
    leaves = overlap.stacked_specs(local_specs(specs, mesh, rules))
    bucket_bytes = strategy.resolve_bucket_bytes(cfg, mesh, len(leaves),
                                                 shape)
    f32 = pytree.tree_map(
        lambda s: dataclasses.replace(s, dtype=torch.float32), specs,
        is_leaf=is_spec)
    onebit_plan = scatter_mask = None
    if strategy.name == "zero1":
        scatter_mask = overlap.zero1_scatter_mask(
            [l.spec for l in global_leaves], mesh, rules, ndp)
    elif strategy.name == "onebit":
        onebit_plan = compression.make_plan(f32, ndp)

    # tensors safe to coalesce into fused buckets: not sharded on "model"
    split_mask = pytree.tree_map(
        lambda sp: model_sharded(mesh, rules, sp.shape, sp.dims), specs,
        is_leaf=is_spec)
    fuse_mask = pytree.tree_map(lambda m: not m, split_mask)
    split_flat = pytree.tree_leaves(split_mask)
    leaf_split = [split_flat[l.members[0]] for l in leaves]
    partial_masks = {}
    norm_kw = dict(mesh=mesh, split_mask=split_mask) if split else {}

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

    def rank_grads(params, batch):
        seq = residual_seq(cfg, mesh, rules, batch)
        with act_hook(mesh, rules, seq_len=seq):
            loss, grads = grads_of(params, batch_rows(batch, mesh))
        if split:
            # an encoder's frames split by their own length
            frames = batch["frames"].shape[1] if "frames" in batch else None
            if (seq, frames) not in partial_masks:
                ax = ModelAxis(mesh, rules, seq_len=seq)
                partial_masks[seq, frames] = (
                    model.partial_mask(specs, ax) if frames is None else
                    model.partial_mask(specs, ax, enc_len=frames))
            grads = _sum_partials(grads, partial_masks[seq, frames], mesh)
        return loss, grads

    def apply(grads, opt_state, params):
        return optim.update(grads, opt_state, params, oc, **norm_kw)

    def fn(params, opt_state, batch):
        loss, grads = rank_grads(params, batch)
        loss = collectives.pmean(loss, mesh)
        if strategy.name == "zero1":
            params, opt_state, m = overlap.zero1_update(
                grads, opt_state, params, oc, mesh, leaves, scatter_mask,
                leaf_split=leaf_split)
        elif strategy.name == "onebit":
            ef = opt_state["ef"]
            if ndp > 1:
                grads, ef = compression.exchange_onebit(
                    grads, ef, mesh, onebit_plan, on_bucket=step.on_bucket,
                    **(dict(specs=specs, rules=rules) if split else {}))
            inner = {n: v for n, v in opt_state.items() if n != "ef"}
            params, inner, m = optim.update(grads, inner, params, oc,
                                            **norm_kw)
            opt_state = dict(inner, ef=ef)
        else:
            if ndp > 1:
                grads = (overlap.exchange_horovod(grads, mesh)
                         if strategy.name == "horovod" else
                         overlap.exchange_phylanx(grads, mesh, bucket_bytes,
                                                  fuse_mask=fuse_mask))
            params, opt_state, m = optim.update(grads, opt_state, params, oc,
                                                **norm_kw)
        return {"loss": loss, "grad_norm": m["grad_norm"]}, params, opt_state

    step = TrainStep(fn=fn, model=model, specs=specs, strategy=strategy,
                     mesh=mesh, plan=onebit_plan, leaves=leaves,
                     scatter_mask=scatter_mask, bucket_bytes=bucket_bytes,
                     rules=rules, split_mask=split_mask, grads=rank_grads,
                     apply=apply)

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


def check_ddp(strategy: Strategy, mesh=None) -> None:
    """The reference's refusals of fabric DDP.

    Raises:
        ValueError: strategy is zero1, uses grad accumulation, or the
            mesh has a dp axis > 1.
    """
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


def ddp_grad_plan(specs):
    """Fabric DDP's gradient buckets: ``optim.compression.make_plan`` over
    the GLOBAL float32 leaves of ``specs`` with ``dp=1``, the buckets of
    ``model=1`` on any model axis (the wire codec owns the exchange)."""
    f32_specs = pytree.tree_map(
        lambda s: dataclasses.replace(s, dtype=torch.float32), specs,
        is_leaf=lambda x: hasattr(x, "dims"))
    return compression.make_plan(f32_specs, 1)


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
    check_ddp(strategy, mesh)
    model = build_model(cfg)
    specs = model.specs()
    gplan = ddp_grad_plan(specs)
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


def decode_rules(cfg, mesh, shape: dict):
    """The tiling plan of the serve steps' parameters and KV caches: the
    cache's kv heads on the model axis when they divide it, else its
    sequence (``kv_seq``); a single stream spreads it over ``data``
    too."""
    r = default_rules()
    model_n = 1 if mesh is None else mesh.shape.get("model", 1)
    over = {}
    if model_n > 1 and cfg.n_kv_heads % model_n != 0:
        over["kv_seq"] = "model"
        over["kv_heads"] = None
    if shape["global_batch"] == 1:
        over["kv_seq"] = ("data", "model") if over.get("kv_seq") == "model" \
            else "data"
    return r.with_overrides(**over)


@dataclasses.dataclass
class ServeStep:
    # decode updates the cache in place where the reference donates it
    # (donate_argnums=(1,)); phylint lints against this declaration
    donated_buffers = ("cache",)
    fn: Any
    model: Any
    specs: Any                  # global parameter specs
    cache_specs: Any            # this rank's cache blocks (local shapes)
    mesh: Any = None
    rules: Any = None           # ``decode_rules``
    batch: int = 1              # the global batch (slots)

    def init(self, generator: torch.Generator, device):
        """The serve parameters (this rank's blocks on a model axis)."""
        return init_params(self.specs, generator, device, mesh=self.mesh,
                           rules=self.rules)

    @property
    def rows(self) -> slice:
        """This rank's rows of the global batch: its dp block where the
        rules split ``batch`` (``spec_for``'s fallback: every row where
        the batch does not divide by the dp degree)."""
        if self.mesh is None:
            return slice(0, self.batch)
        return local_slices(self.mesh, self.rules, (self.batch,),
                            ("batch",))[0]

    def greedy(self, logits):
        """The greedy tokens of this step's logits (over the model group's
        whole vocab on a model axis)."""
        with act_hook(self.mesh, self.rules):
            return layers.greedy(logits, self.model.cfg.vocab)

    def gather_logits(self, logits):
        """The whole vocab of this step's logits (a collective over the
        model group on a model axis)."""
        with act_hook(self.mesh, self.rules):
            return layers.gather_vocab(logits, self.model.cfg.vocab)

    def gather_rows(self, x):
        """Every row of the global batch of a tensor whose dim 0 is this
        rank's ``rows`` (a collective over the dp group where the rules
        split the batch; ``x`` itself where they do not)."""
        if self.rows.stop - self.rows.start == self.batch:
            return x
        return collectives.all_gather(x.contiguous(), self.mesh, axis=0)


def _serve_step(cfg, shape: dict, mesh, body, rules=None) -> ServeStep:
    scfg = _serve_cfg(cfg)
    model = build_model(scfg)
    S = shape["seq_len"]
    rules = rules or decode_rules(scfg, mesh, shape)
    cache = model.cache_specs(shape["global_batch"], S)
    if mesh is not None and mesh.world_size > 1:
        cache = local_specs(cache, mesh, rules)

    def fn(*args):
        with act_hook(mesh, rules, cache_len=S,
                      batch=shape["global_batch"]):
            return body(model, S, *args)

    return ServeStep(fn=fn, model=model, specs=model.specs(),
                     cache_specs=cache, mesh=mesh, rules=rules,
                     batch=shape["global_batch"])


def make_prefill_step(cfg, shape: dict, *, mesh=None,
                      rules=None) -> ServeStep:
    """``fn(params, batch) -> (last-token logits, cache)``; the cache is
    padded to ``shape["seq_len"]``.  ``batch`` holds ``"tokens"``, and for
    the encdec family also the encoder's ``"frames"``.  On a ``mesh``:
    ``batch`` is this rank's ``rows`` of the global batch, and the step
    gives this rank's vocab columns of their logits (a model axis) and
    its blocks of the cache (``decode_rules``, or ``rules``: the
    gateway's batch-1 prefill tiles its cache as the decode step's)."""
    return _serve_step(cfg, shape, mesh,
                       lambda model, S, params, batch:
                       model.prefill(params, batch, S), rules)


def make_decode_step(cfg, shape: dict, *, mesh=None) -> ServeStep:
    """``fn(params, cache, batch, pos) -> (logits, cache)``.  The cache is
    updated in place and returned: this stands in for JAX's
    ``donate_argnums=(1,)``, so the caller must not reuse the cache it
    passed in as the state before the step.  On a ``mesh``, as
    ``make_prefill_step``; a ``[B]`` ``pos`` is this rank's rows'."""
    return _serve_step(cfg, shape, mesh,
                       lambda model, S, params, cache, batch, pos:
                       model.decode_step(params, cache, batch, pos))
