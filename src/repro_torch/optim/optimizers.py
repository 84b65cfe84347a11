"""Solvers (paper terminology): synchronous SGD / momentum / AdamW, in the
dense layout (m/v mirror the parameter tree).

Counterpart: ``repro/optim/optimizers.py:22-109`` (``OptConfig``,
``init_specs``, ``init``, ``global_norm``, ``clip_by_global_norm``, and the
dense ``update``).  The ZeRO-1 layout waits for the mesh-parallel
strategies (ROADMAP item 14).

The arithmetic is the reference's, leaf by leaf in float32.  One
difference on purpose: ``update`` writes the new parameters and the new
m/v into the tensors it was given and returns those same objects, where
JAX returns new arrays.  At full width a second copy of the parameters
and of m/v would not fit beside the first (7.96 GB of float32 a copy for
12 layers of qwen3-4b).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from ..core.sharding import ParamSpec, is_spec

__all__ = ["OptConfig", "clip_by_global_norm", "global_norm", "init",
           "init_specs", "update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | momentum | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0


def init_specs(param_specs, oc: OptConfig):
    """ParamSpec tree for the optimizer state."""
    def zeros():
        return pytree.tree_map(
            lambda s: ParamSpec(s.shape, s.dims, torch.float32, "zeros"),
            param_specs, is_leaf=is_spec)
    st = {"count": ParamSpec((), (), torch.int32, "zeros")}
    if oc.kind == "adamw":
        st["m"] = zeros()
        st["v"] = zeros()
    elif oc.kind == "momentum":
        st["m"] = zeros()
    return st


def init(params, oc: OptConfig):
    """Zero state on the parameters' device: ``count`` int32 and float32
    m (and v) shaped like the parameters."""
    dev = pytree.tree_leaves(params)[0].device

    def zeros():
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    st = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
    if oc.kind == "adamw":
        st["m"] = zeros()
        st["v"] = zeros()
    elif oc.kind == "momentum":
        st["m"] = zeros()
    return st


def global_norm(tree):
    return torch.sqrt(sum(g.float().square().sum()
                          for g in pytree.tree_leaves(tree)))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / norm)``, norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           grads), gn


@torch.no_grad()
def update(grads, state, params, oc: OptConfig):
    """Dense update.  Returns (params, state, metrics) with the parameters
    and m/v updated in place; ``metrics["grad_norm"]`` is the norm before
    clipping, a device scalar."""
    gn = global_norm(grads)
    clip = _clip_scale(gn, oc.grad_clip)
    count = state["count"] + 1
    g_leaves = pytree.tree_leaves(grads)
    p_leaves = pytree.tree_leaves(params)
    if len(g_leaves) != len(p_leaves):
        raise ValueError(f"{len(g_leaves)} gradients for {len(p_leaves)} "
                         f"parameters")

    def clipped(g):
        return (g.float() * clip).to(g.dtype).float()

    if oc.kind == "adamw":
        t = count.float()
        bc1 = 1 - torch.pow(torch.tensor(oc.b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(oc.b2, device=t.device), t)
        for g, p, m, v in zip(g_leaves, p_leaves,
                              pytree.tree_leaves(state["m"]),
                              pytree.tree_leaves(state["v"])):
            g = clipped(g)
            m.mul_(oc.b1).add_((1 - oc.b1) * g)
            v.mul_(oc.b2).add_((1 - oc.b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps) \
                + oc.weight_decay * p.float()
            p.copy_(p.float() - oc.lr * upd)
        return params, {"count": count, "m": state["m"],
                        "v": state["v"]}, {"grad_norm": gn}
    if oc.kind == "momentum":
        for g, p, m in zip(g_leaves, p_leaves,
                           pytree.tree_leaves(state["m"])):
            m.mul_(oc.momentum).add_(clipped(g))
            p.copy_(p.float() - oc.lr * m)
        return params, {"count": count, "m": state["m"]}, {"grad_norm": gn}
    if oc.kind != "sgd":
        raise ValueError(f"unknown optimizer {oc.kind!r}")
    for g, p in zip(g_leaves, p_leaves):
        p.copy_(p.float() - oc.lr * clipped(g))
    return params, {"count": count}, {"grad_norm": gn}
