"""Parameter specs, and the tiling rules that map logical dims to mesh axes.

Counterpart: ``repro/core/sharding.py:28-132`` (``DEFAULT_RULES``,
``ShardingRules``, ``default_rules``, ``_axis_size``, ``_present``,
``spec_for``) and ``:142-196`` (``ParamSpec``, ``initialize``,
``init_params``).  The rules are pure functions of the mesh's axis sizes
(any object with a ``shape`` dict), and a spec is a plain tuple: the
reference's ``PartitionSpec`` parts, trailing Nones stripped.  They
decide the ZeRO-1 scatter mask and the phylanx fuse mask
(``core/overlap.py``); placing tensors by them (``param_shardings``,
``constrain``, the activation hook) comes with the model axis, ROADMAP
item 14b.  The same init rules: ``normal`` draws
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

__all__ = ["DEFAULT_RULES", "ParamSpec", "ShardingRules", "default_rules",
           "init_params", "initialize", "is_spec", "spec_for"]

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


def init_params(specs, generator: torch.Generator, device):
    """Initialize a tree (dicts/lists) of ParamSpec into tensors on
    ``device``, leaf by leaf in tree order."""
    return pytree.tree_map(lambda s: initialize(s, generator, device),
                           specs, is_leaf=is_spec)
