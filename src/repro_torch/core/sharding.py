"""Parameter specs: shape + logical dims + dtype + init rule.

Counterpart: ``repro/core/sharding.py:142-196`` (``ParamSpec``,
``initialize``, ``init_params``).  The same init rules: ``normal`` draws
with std ``scale / sqrt(fan_in)``, fan_in = ``shape[-2]`` (or the last dim
of a vector); ``scaled`` with std ``scale``; ``ones`` and ``zeros``.  Random
draws come from a ``torch.Generator``, so they differ from JAX's
``PRNGKey`` draws: tests carry parameters across with ``bridge`` instead.
Every parameter is made directly on its device in its spec dtype, one leaf
at a time, so a full-size model never exists in float32 on the host.  The
logical dims are kept for the mesh rules, which wait for ROADMAP item 14.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils._pytree as pytree

__all__ = ["ParamSpec", "init_params", "initialize", "is_spec"]


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
