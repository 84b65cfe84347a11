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
state) to the JAX layout in float32 numpy.  ``host_leaves`` and
``place_leaves`` are the checkpoint's pair: the leaves of a port tree in
the JAX layout *and* in ``jax.tree.flatten``'s order (dict keys sorted,
tuples in order), each in its own dtype, and back into a port tree.
``cnn_params_from_numpy`` carries the HAR CNN's plain parameter dict.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.sharding import is_spec
from .models.model import build_model

__all__ = ["cache_from_numpy", "cnn_params_from_numpy", "host_leaves",
           "leaf_names", "params_from_numpy", "place_leaves",
           "tree_to_numpy"]


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


def cnn_params_from_numpy(tree: dict, device) -> dict:
    """The JAX HAR CNN's parameters (``repro/models/cnn.py``: a plain dict
    of ``{"w", "b"}`` per layer, no stacked dims) as float32 tensors on
    ``device``, in the JAX layout (``models/cnn.py`` maps the conv weights
    to torch's at each call)."""
    return {name: {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                   device=device) for k, v in layer.items()}
            for name, layer in tree.items()}


def _slots(tree, path=()) -> list:
    """The leaves of ``tree`` grouped as the JAX layout's leaves, in
    ``jax.tree.flatten``'s order: ``[(path, lead, [(index, leaf)])]``.  A
    dict is visited in sorted key order and a tuple in order; a list level
    is a leading dim (``lead``) of the leaves below it, row-major over
    nested lists, and ``index`` is a leaf's place in those dims.  ``None``
    holds no leaf.  Raises ``ValueError`` if a list's items differ in
    structure, or it is empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _slots(tree[k], path + (k,))]
    if isinstance(tree, tuple):
        return [s for i, t in enumerate(tree) for s in _slots(t, path + (i,))]
    if isinstance(tree, list):
        if not tree:
            raise ValueError(f"{_name(path)}: an empty list has no JAX "
                             f"layout")
        parts = [_slots(t, path) for t in tree]
        differ = ValueError(f"{_name(path)}: the list's items differ in "
                            f"structure")
        if any(len(part) != len(parts[0]) for part in parts):
            raise differ
        out = []
        for rows in zip(*parts):
            p, lead, _ = rows[0]
            if any(r[0] != p or r[1] != lead for r in rows):
                raise differ
            out.append((p, (len(tree),) + lead,
                        [((i,) + idx, leaf) for i, r in enumerate(rows)
                         for idx, leaf in r[2]]))
        return out
    return [(path, (), [((), tree)])]


def _name(path) -> str:
    return "/".join(map(str, path)) or "<root>"


def leaf_names(tree) -> list[str]:
    """The paths of ``host_leaves``' leaves, in its order, copying
    nothing."""
    return [_name(path) for path, _, _ in _slots(tree)]


def host_leaves(tree) -> tuple[list, list]:
    """The leaves of a port tree (tensors, or numpy arrays and scalars) in
    the JAX layout and in ``jax.tree.flatten``'s order (``_slots``):
    ``(names, arrays)``.  Each array is an owned host copy in its leaf's
    own dtype (int32 stays int32), taken now and synchronously, so that
    a later in-place update of the tree cannot reach it.

    Raises:
        ValueError: a leaf's dtype has no numpy counterpart (bfloat16),
            naming the leaf; the leaves of one stacked list differ in
            shape or dtype; a list is empty or its items differ in
            structure.
    """
    names, arrays = [], []
    for path, lead, items in _slots(tree):
        name = _name(path)
        parts = [(idx, torch.as_tensor(leaf)) for idx, leaf in items]
        first = parts[0][1]
        try:
            torch.empty(0, dtype=first.dtype).numpy()
        except TypeError as e:
            raise ValueError(f"leaf {name}: dtype {first.dtype} has no "
                             f"numpy counterpart ({e})") from e
        if any(t.shape != first.shape or t.dtype != first.dtype
               for _, t in parts):
            raise ValueError(f"leaf {name}: the stacked leaves differ in "
                             f"shape or dtype")
        out = torch.empty(lead + tuple(first.shape), dtype=first.dtype)
        for idx, t in parts:
            out[idx].copy_(t.detach())
        names.append(name)
        arrays.append(out.numpy())
    return names, arrays


def place_leaves(like, arrays: list):
    """The inverse of ``host_leaves``: a tree with the structure of the
    port tree ``like`` whose leaves are cut from ``arrays`` (in
    ``host_leaves``' order and layout), each a tensor in its array's dtype
    on the device of the ``like`` leaf it replaces.

    Raises:
        ValueError: the leaf count differs, or an array's shape is not the
            ``like`` leaf's under its stacked dims.
    """
    slots = _slots(like)
    if len(slots) != len(arrays):
        raise ValueError(f"{len(arrays)} arrays for {len(slots)} leaves")
    placed = {}
    for (path, lead, items), arr in zip(slots, arrays):
        want = lead + tuple(torch.as_tensor(items[0][1]).shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {_name(path)}: shape {tuple(arr.shape)}"
                             f" != {want}")
        for idx, leaf in items:
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            part = arr[idx + (...,)]          # a view, 0-d ones included
            if not part.flags.c_contiguous:
                part = part.copy()
            placed[path, idx] = torch.from_numpy(part).to(dev)

    def rebuild(t, path, idx):
        # the walk of _slots: a dict key or tuple place extends the path,
        # a list place the index
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: rebuild(v, path + (k,), idx) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(rebuild(v, path + (i,), idx)
                         for i, v in enumerate(t))
        if isinstance(t, list):
            return [rebuild(v, path, idx + (i,)) for i, v in enumerate(t)]
        return placed[path, idx]
    return rebuild(like, (), ())
