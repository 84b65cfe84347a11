"""Parameter specs, the tiling rules that map logical dims to mesh axes,
and placing tensors by them.

Counterpart: ``repro/core/sharding.py:28-132`` (``DEFAULT_RULES``,
``ShardingRules``, ``default_rules``, ``_axis_size``, ``_present``,
``spec_for``), ``:142-196`` (``ParamSpec``, ``initialize``,
``init_params``, ``param_shardings`` as ``local_slices``/``local_specs``)
and ``:199-230`` (``set_act_hook``; ``model_axis`` stands for
``act_constrain``: where the reference constrains an activation, the
port's layer asks the hook how it is split; ``constrain`` has no port:
nothing is placed lazily).  The rules are pure functions of the
mesh's axis sizes (any object with a ``shape`` dict), and a spec is a
plain tuple: the reference's ``PartitionSpec`` parts, trailing Nones
stripped.  They decide the ZeRO-1 scatter mask and the phylanx fuse mask
(``core/overlap.py``), and where a tensor lives: on a mesh with a model
axis each rank process holds exactly the block of every parameter and
cache leaf that the reference's tiling plan gives its device
(``local_slices``; a dim that does not divide stays replicated), and
``init_params`` on a mesh draws every global leaf as one process does,
then keeps this rank's block, one leaf at a time.

The activation hook (``act_hook``) is where the model's layers learn the
mesh: a step installs ``(mesh, rules)`` around its call, and the layers
read it through ``model_axis()``, which says per logical dim whether it
is split over the model group, and which block this rank holds.  The
decode cache's tiling is one view for every mesh (``act_axis()``, with
or without a model axis): ``ModelAxis.tiles`` names the group a cache
dim lies on (``model``, the dp group or the whole mesh, as the rules put
``kv_seq`` on ``model``, ``data`` or ``("data", "model")``), this
rank's index in it and its block, the same block ``local_specs`` cuts.  Under
sequence parallelism (``default_rules(sequence_parallel=True)``: ``seq``
on ``model``) the train step also tells it the residual's global
sequence length, and the hook says whether the residual between blocks
holds only this rank's ``S/M`` rows (``ModelAxis.seq``): where the
reference constrains the residual to ``("batch", "seq", "embed")``
before and after every block.  An encoder-decoder's encoder runs under
its own split, by its frames (``residual_hook``).  With no
hook installed (or a model axis of 1) the layers are the one-process
code.  The same init rules: ``normal`` draws
with std ``scale / sqrt(fan_in)``, fan_in = ``shape[-2]`` (or the last dim
of a vector); ``scaled`` with std ``scale``; ``ones`` and ``zeros``.  Random
draws come from a ``torch.Generator``, so they differ from JAX's
``PRNGKey`` draws: tests carry parameters across with ``bridge`` instead.
Every parameter is made directly on its device in its spec dtype, one leaf
at a time, so a full-size model never exists in float32 on the host.  The
logical dims feed the mesh rules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
import torch.utils._pytree as pytree

__all__ = ["DEFAULT_RULES", "ModelAxis", "ParamSpec", "ShardingRules", "Tiles",
           "act_axis", "act_hook", "default_rules", "gather_leaf",
           "gather_tree", "init_params", "initialize", "is_spec",
           "local_slices", "local_specs", "model_axis", "model_sharded",
           "residual_hook", "set_act_hook", "shard_leaf", "shard_tree",
           "spec_for"]

#   batch      -> data-parallel axes ("pod","data")
#   seq        -> sequence; sharded only under sequence parallelism
#   model-ish  -> "model" axis: heads, kv_heads, d_ff, vocab, experts, inner
#   replicated -> None
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "inner": "model",
    "state": None,
    "conv": None,
    "layers": None,
    "stage": None,
    "channels": "model",
    "spatial": None,
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A tiling plan: logical dim name -> mesh axis (or tuple of axes)."""

    rules: Mapping

    def with_overrides(self, **ov) -> "ShardingRules":
        new = dict(self.rules)
        new.update(ov)
        return ShardingRules(new)

    def axis_for(self, dim: str):
        return self.rules.get(dim, None)


def default_rules(*, sequence_parallel: bool = False,
                  long_context_kv: bool = False) -> ShardingRules:
    r = dict(DEFAULT_RULES)
    if sequence_parallel:
        r["seq"] = "model"
    if long_context_kv:
        r["kv_seq"] = "data"
    return ShardingRules(r)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        axis = (axis,)
    return math.prod(mesh.shape[a] for a in axis if a in mesh.shape)


def _present(mesh, axis):
    """Filter an axis assignment down to axes present in this mesh."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in mesh.shape else None
    axes = tuple(a for a in axis if a in mesh.shape)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def spec_for(mesh, rules: ShardingRules, shape: Sequence[int],
             dims: Sequence) -> tuple:
    """The reference's ``PartitionSpec`` parts for a concrete shape, with
    its divisibility fallback: a dim is sharded on its mapped axes only
    when it divides evenly, an axis is used at most once (first dim
    wins), and trailing Nones are stripped."""
    if len(shape) != len(dims):
        raise ValueError(f"shape {tuple(shape)} vs dims {tuple(dims)}")
    used: set = set()
    parts: list = []
    for size, dim in zip(shape, dims):
        axis = _present(mesh, rules.axis_for(dim)) if dim is not None \
            else None
        if axis is None:
            parts.append(None)
            continue
        ax_tuple = (axis,) if isinstance(axis, str) else tuple(axis)
        asize = _axis_size(mesh, ax_tuple)
        if any(a in used for a in ax_tuple) or asize <= 1 \
                or size % asize != 0:
            parts.append(None)
            continue
        used.update(ax_tuple)
        parts.append(ax_tuple if len(ax_tuple) > 1 else ax_tuple[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dims: tuple[str | None, ...]
    dtype: Any = torch.float32
    init: str = "normal"      # normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} vs dims {self.dims}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def initialize(spec: ParamSpec, generator: torch.Generator,
               device) -> torch.Tensor:
    kw = dict(dtype=spec.dtype, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, **kw)
    if spec.init == "ones":
        return torch.ones(spec.shape, **kw)
    if spec.init == "normal":
        fan_in = (spec.shape[-2] if len(spec.shape) >= 2
                  else max(spec.shape[-1], 1))
        std = spec.scale / math.sqrt(max(fan_in, 1))
    elif spec.init == "scaled":
        std = spec.scale
    else:
        raise ValueError(f"unknown init {spec.init}")
    x = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.mul_(std).to(spec.dtype)


def _parts(spec) -> tuple:
    return tuple((p,) if isinstance(p, str) else tuple(p or ())
                 for p in spec)


def local_slices(mesh, rules: ShardingRules, shape: Sequence[int],
                 dims: Sequence) -> tuple:
    """This rank's block of a global tensor of ``shape``: one ``slice``
    per dim, cut by ``spec_for`` over the rank's mesh coordinates (a dim
    on several axes is cut row-major over them, as JAX lays a tuple of
    axes out)."""
    spec = spec_for(mesh, rules, shape, dims)
    out = []
    for i, n in enumerate(shape):
        axes = _parts(spec)[i] if i < len(spec) else ()
        k, idx = 1, 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords.get(a, 0)
            k *= mesh.shape[a]
        out.append(slice(idx * n // k, (idx + 1) * n // k))
    return tuple(out)


def model_sharded(mesh, rules: ShardingRules, shape: Sequence[int],
                  dims: Sequence) -> bool:
    """Whether the tiling plan splits any dim of the leaf over the model
    axis."""
    return any("model" in p for p in
               _parts(spec_for(mesh, rules, shape, dims)))


def local_specs(specs, mesh, rules: ShardingRules):
    """The spec tree of this rank's blocks (local shapes)."""
    def one(s: ParamSpec) -> ParamSpec:
        sl = local_slices(mesh, rules, s.shape, s.dims)
        return dataclasses.replace(
            s, shape=tuple(x.stop - x.start for x in sl))
    return pytree.tree_map(one, specs, is_leaf=is_spec)


def shard_leaf(t: torch.Tensor, spec: ParamSpec, mesh,
               rules: ShardingRules) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` (a view)."""
    return t[local_slices(mesh, rules, spec.shape, spec.dims)]


def shard_tree(tree, specs, mesh, rules: ShardingRules, device=None):
    """This rank's blocks of a tree of global tensors (owned copies on
    ``device``, default: each leaf's own)."""
    return pytree.tree_map(
        lambda t, s: shard_leaf(t, s, mesh, rules).to(
            device if device is not None else t.device, copy=True),
        tree, specs)


def gather_leaf(t: torch.Tensor, spec: ParamSpec, mesh,
                rules: ShardingRules) -> torch.Tensor:
    """The global tensor of every model rank's block ``t`` (a collective
    over the model group; ``t`` itself where the leaf is replicated)."""
    from . import collectives
    spec_p = spec_for(mesh, rules, spec.shape, spec.dims)
    for i, axes in enumerate(_parts(spec_p)):
        if "model" in axes:
            return collectives.all_gather(t, mesh, axis=i,
                                          mesh_axis="model")
    return t


def gather_tree(tree, specs, mesh, rules: ShardingRules):
    """The global tensors of a tree of model blocks, on the CPU: a
    collective over the model group (every model rank calls it)."""
    return pytree.tree_map(
        lambda t, s: gather_leaf(t, s, mesh, rules).detach().cpu(),
        tree, specs)


def init_params(specs, generator: torch.Generator, device, *, mesh=None,
                rules: ShardingRules | None = None):
    """Initialize a tree (dicts/lists) of ParamSpec into tensors on
    ``device``, leaf by leaf in tree order.  On a ``mesh`` with a model
    axis every global leaf is drawn in the same order from the same
    generator as one process draws it, and only this rank's block is
    kept (``local_slices``, by ``rules``): the weights of a mesh are the
    weights of ``model=1``, and one global leaf at a time exists."""
    if mesh is None or mesh.model_size == 1:
        return pytree.tree_map(lambda s: initialize(s, generator, device),
                               specs, is_leaf=is_spec)
    rules = rules or default_rules()

    def one(s: ParamSpec) -> torch.Tensor:
        full = initialize(s, generator, device)
        part = shard_leaf(full, s, mesh, rules)
        return part if part.shape == full.shape else part.clone()
    return pytree.tree_map(one, specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# The activation hook: where the layers learn the model axis
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Tiles:
    """Where one split dim of global size ``n`` lives: over the
    collectives ``axis`` (``"model"``, ``"dp"`` or ``"mesh"``) of
    ``mesh``, whose reference axes are ``axes``, ``size`` ranks; this
    rank's ``block``."""
    mesh: Any
    axis: str
    axes: tuple
    size: int
    block: slice


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A layer's view of the mesh's model axis: ``size`` ranks, this one
    at ``index``, the tiling ``rules``, the serve steps' global decode
    ``cache_len`` and global ``batch`` (None in training, where each dp
    rank computes its own rows as the reference's ``shard_map`` does),
    and ``seq_len``: the residual's global sequence length where it is
    split by sequence over the model group (None: every rank holds the
    whole sequence)."""
    mesh: Any
    rules: ShardingRules
    cache_len: Any = None
    seq_len: Any = None
    batch: Any = None

    @property
    def seq(self) -> bool:
        """Whether the residual between blocks holds only this rank's
        rows of the sequence (``seq_block``): sequence parallelism."""
        return self.seq_len is not None

    @property
    def seq_block(self) -> slice:
        """This rank's rows of the residual's sequence."""
        return self.block(self.seq_len)

    @property
    def size(self) -> int:
        return self.mesh.model_size

    @property
    def index(self) -> int:
        return self.mesh.model_rank

    def split(self, dim: str, n: int) -> bool:
        """Whether a logical ``dim`` of global size ``n`` is split over
        the model group."""
        return model_sharded(self.mesh, self.rules, (n,), (dim,))

    def block(self, n: int) -> slice:
        """This rank's block of a split dim of global size ``n``."""
        k = self.size
        return slice(self.index * n // k, (self.index + 1) * n // k)

    def tiles(self, dim: str, n) -> "Tiles | None":
        """Where the cache dim ``dim`` of global size ``n`` lives, by the
        rules (``spec_for``'s fallback); None where every rank holds it
        whole, or ``n`` is None."""
        if n is None:
            return None
        from . import collectives
        spec = spec_for(self.mesh, self.rules, (n,), (dim,))
        if not spec:
            return None
        axes = _parts(spec)[0]
        return Tiles(self.mesh, collectives.axis_of(self.mesh, axes), axes,
                     math.prod(self.mesh.shape[a] for a in axes),
                     local_slices(self.mesh, self.rules, (n,), (dim,))[0])


_ACT_HOOK: list = [None]


def set_act_hook(mesh, rules: ShardingRules | None, *,
                 cache_len=None, seq_len=None, batch=None) -> None:
    """Install ``(mesh, rules)`` for the layers (None: no mesh).  A
    ``seq_len`` splits the residual by sequence where the rules put a
    ``seq`` of that length on the model axis (``spec_for``'s fallback:
    only when it divides); the train step passes it only where the
    model's vocab splits too.  A serve step passes its global ``batch``,
    whose rows the rules may split over the dp group."""
    if mesh is None:
        _ACT_HOOK[0] = None
        return
    ax = ModelAxis(mesh, rules or default_rules(), cache_len, batch=batch)
    if seq_len is not None and ax.split("seq", seq_len):
        ax = dataclasses.replace(ax, seq_len=seq_len)
    _ACT_HOOK[0] = ax


class act_hook:
    """``with act_hook(mesh, rules): ...`` installs the hook for the
    block and restores the one before it."""

    def __init__(self, mesh, rules: ShardingRules | None, *,
                 cache_len=None, seq_len=None, batch=None):
        self.mesh, self.rules = mesh, rules
        self.cache_len, self.seq_len, self.batch = cache_len, seq_len, batch

    def __enter__(self):
        self.prev = _ACT_HOOK[0]
        set_act_hook(self.mesh, self.rules, cache_len=self.cache_len,
                     seq_len=self.seq_len, batch=self.batch)
        return _ACT_HOOK[0]

    def __exit__(self, *exc):
        _ACT_HOOK[0] = self.prev


class residual_hook:
    """``with residual_hook(n): ...`` installs, for the block, the hook
    with the residual split by a sequence of ``n`` rows where the rules
    put ``seq`` on a model axis that ``n`` divides, and not split
    otherwise (an encoder's frames beside the decoder's tokens, whose
    split the step installed); it restores the hook before it.  No hook:
    nothing changes."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        self.prev = hook = _ACT_HOOK[0]
        if hook is not None:
            _ACT_HOOK[0] = dataclasses.replace(
                hook, seq_len=self.n if hook.split("seq", self.n) else None)
        return _ACT_HOOK[0]

    def __exit__(self, *exc):
        _ACT_HOOK[0] = self.prev


def act_axis() -> ModelAxis | None:
    """The installed hook, whatever the model axis's size (None: no
    hook): the decode cache's tiling over data axes (``tiles``)."""
    return _ACT_HOOK[0]


def model_axis() -> ModelAxis | None:
    """The installed hook's model axis, or None when there is no hook or
    the model axis is 1 (the one-process code)."""
    hook = _ACT_HOOK[0]
    if hook is None or hook.size == 1:
        return None
    return hook
