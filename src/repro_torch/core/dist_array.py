"""Tiled distributed arrays: what the port has of them.

Counterpart: ``repro/core/dist_array.py`` (``TiledArray``: a
``jax.Array`` with its tiling plan, re-tiling and halos).  A port tensor
lives on one rank process; a tile that knows the whole array across the
ranks of a mesh is ROADMAP item 14b.  The tiling rules themselves are
``core/sharding.py``'s (``spec_for``, ``local_slices``).
"""
from __future__ import annotations

__all__ = ["TiledArray"]


class TiledArray:
    """Raises on construction: NotImplementedError (ROADMAP item 14b)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "tiled distributed arrays over rank processes (TiledArray) are "
            "ROADMAP item 14b")

    @classmethod
    def tile(cls, *args, **kwargs):
        return cls(*args, **kwargs)
