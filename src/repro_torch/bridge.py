"""Carry parameters and caches between the JAX package and the port.

No counterpart in ``repro/``.  The JAX model keeps every layer's
parameters and cache stacked with leading layer dims
(``repro/models/model.py``: ``[layers, ...]`` for the dense family,
``[groups, shared_every, ...]`` for zamba's mamba layers and ``[groups,
...]`` for its shared block's KV cache); the port keeps nested lists of
per-layer dicts in their place.  The inputs are nested dicts of numpy
arrays (float32; a caller holding ``ml_dtypes`` bfloat16 arrays converts
them to float32 first), so this module needs nothing of JAX.
``tree_to_numpy`` maps back: a port tree (parameters, gradients, optimizer
state) to the JAX layout in float32 numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.sharding import is_spec
from .models.model import build_model

__all__ = ["cache_from_numpy", "params_from_numpy", "tree_to_numpy"]


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _from_stacked(tree: dict, specs, device, what: str):
    """Fill the port's spec tree ``specs`` from the JAX tree ``tree``: a
    list level of the port's tree is a leading dim of the JAX leaf at the
    same key path.  Raises ``KeyError`` if a port leaf has no JAX leaf and
    ``ValueError`` on a shape mismatch or a JAX leaf left over."""
    flat = _flatten(tree)
    used: set = set()

    def fill(sp, path, index, stacked):
        if isinstance(sp, list):
            return [fill(s, path, index + (i,), stacked + (len(sp),))
                    for i, s in enumerate(sp)]
        if isinstance(sp, dict):
            return {k: fill(v, path + (k,), index, stacked)
                    for k, v in sp.items()}
        assert is_spec(sp)
        name = "/".join(map(str, path))
        if path not in flat:
            raise KeyError(f"no JAX leaf for port {what} {name}")
        used.add(path)
        arr = np.asarray(flat[path])
        if arr.shape != stacked + tuple(sp.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != port "
                             f"spec {stacked} + {sp.shape}")
        return torch.tensor(arr[index], dtype=sp.dtype, device=device)

    out = fill(specs, (), (), ())
    left = sorted("/".join(map(str, p)) for p in set(flat) - used)
    if left:
        raise ValueError(f"JAX leaves with no port {what}: {left}")
    return out


def params_from_numpy(tree: dict, cfg, device) -> dict:
    """The JAX parameter tree of ``cfg``'s model as the port's parameters
    (in the dtypes of the port's specs for ``cfg``) on ``device``.

    Raises ``KeyError`` if a port parameter has no JAX leaf, and
    ``ValueError`` on a shape mismatch or a JAX leaf left over."""
    return _from_stacked(tree, build_model(cfg).specs(), device, "parameter")


def cache_from_numpy(tree: dict, cfg, device):
    """The JAX decode cache of ``cfg``'s model as the port's cache, in the
    dtypes of the port's cache specs (copies: the decode step writes the
    cache in place).  Dense: ``{"k", "v"}`` of shape ``[layers, B, S, Hkv,
    hd]``.  Zamba: ``{"mamba": {"ssm", "conv"}`` with ``[groups,
    shared_every]`` leading dims, ``"shared": {"k", "v"}`` with
    ``[groups]``}.  Raises as ``params_from_numpy`` does."""
    k = np.asarray((tree["shared"] if cfg.family == "zamba" else tree)["k"])
    if k.ndim != 5:
        raise ValueError(f"cache k has shape {k.shape}; want [layers, B, S, "
                         f"Hkv, hd]")
    specs = build_model(cfg).cache_specs(k.shape[1], k.shape[2])
    return _from_stacked(tree, specs, device, "cache leaf")


def _stack(parts: list):
    if isinstance(parts[0], dict):
        return {k: _stack([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)


def tree_to_numpy(tree):
    """A port tree in the JAX layout: each list level becomes a leading
    dim of the leaves below it (row-major over nested lists); tensors
    become float32 numpy arrays (detached, on the host)."""
    if isinstance(tree, list):
        return _stack([tree_to_numpy(t) for t in tree])
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()
