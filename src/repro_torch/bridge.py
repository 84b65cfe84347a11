"""Carry parameters and KV caches from the JAX package into the port.

No counterpart in ``repro/``.  The JAX model keeps every layer's
parameters stacked under ``"stack"`` with a leading ``layers`` dim
(``repro/models/model.py:28-33,57-58``); the port keeps a list of
per-layer dicts.  The inputs are nested dicts of numpy arrays (float32;
a caller holding ``ml_dtypes`` bfloat16 arrays converts them to float32
first), so this module needs nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.sharding import is_spec
from .models.model import build_model

__all__ = ["cache_from_numpy", "params_from_numpy"]


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _tensor(arr, spec, path, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(spec.shape):
        raise ValueError(f"{'/'.join(map(str, path))}: shape "
                         f"{tuple(arr.shape)} != port spec {spec.shape}")
    return torch.tensor(arr, dtype=spec.dtype, device=device)


def params_from_numpy(tree: dict, cfg, device) -> dict:
    """The JAX parameter tree of ``cfg``'s model as the port's parameters
    (in the dtypes of the port's specs for ``cfg``) on ``device``.

    Raises ``KeyError`` if a port parameter has no JAX leaf, and
    ``ValueError`` on a shape mismatch or a JAX leaf left over."""
    flat = _flatten(tree)
    used: set = set()

    def take(path):
        if path not in flat:
            raise KeyError(f"no JAX leaf for port parameter "
                           f"{'/'.join(map(str, path))}")
        used.add(path)
        return flat[path]

    def fill(specs, path, layer=None):
        if is_spec(specs):
            arr = take(path)
            if layer is not None:
                arr = np.asarray(arr)[layer]
            return _tensor(arr, specs, path, device)
        return {k: fill(v, path + (k,), layer) for k, v in specs.items()}

    specs = build_model(cfg).specs()
    out = {k: fill(v, (k,)) for k, v in specs.items() if k != "stack"}
    out["stack"] = [fill(layer_specs, ("stack",), layer=i)
                    for i, layer_specs in enumerate(specs["stack"])]
    left = sorted("/".join(map(str, p)) for p in set(flat) - used)
    if left:
        raise ValueError(f"JAX leaves with no port parameter: {left}")
    return out


def cache_from_numpy(tree: dict, cfg, device) -> list:
    """The JAX KV cache ``{"k", "v"}`` of shape ``[layers, B, S, Hkv, hd]``
    as the port's per-layer cache list, in ``cfg.cache_dtype``."""
    if set(tree) != {"k", "v"}:
        raise ValueError(f"a dense KV cache has keys k, v; got {sorted(tree)}")
    k, v = np.asarray(tree["k"]), np.asarray(tree["v"])
    want = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    for name, arr in (("k", k), ("v", v)):
        if arr.ndim != 5 or (arr.shape[0], arr.shape[3], arr.shape[4]) != want:
            raise ValueError(f"cache {name} has shape {arr.shape}; want "
                             f"[{want[0]}, B, S, {want[1]}, {want[2]}]")

    def t(a):
        # a copy: the decode step writes the cache in place
        return torch.tensor(a, dtype=cfg.cache_dtype, device=device)
    return [{"k": t(k[i]), "v": t(v[i])} for i in range(cfg.n_layers)]
