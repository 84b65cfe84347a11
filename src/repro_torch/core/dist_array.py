"""Tiled distributed arrays with whole-array metadata (paper §4.1).

Counterpart: ``repro/core/dist_array.py`` (``TiledArray``: ``tile``,
``spec``, ``global_shape``, ``tile_shape``, ``retile``, ``replicated``,
``with_halo``).  Phylanx: "Each of the tiles of the data arrays handled by
a locality is internally represented exactly like a fully local data
array except that it carries additional meta-information describing the
whole (distributed) array."  Where the reference's ``data`` is a global
``jax.Array`` laid over the devices of one process, a port
``TiledArray`` lives on one rank process of a mesh (``launch/mesh.py``):
``data`` is this rank's tile, the block that the tiling plan
(``core/sharding.py``: ``spec_for``, ``local_slices``) gives its mesh
coordinates, and ``global_shape`` the whole array's shape.  Every rank of
the mesh holds its own ``TiledArray`` of the same array and calls the
methods that exchange (``retile``, ``replicated``, ``with_halo``) in
step.  Re-tiling gathers the whole array over the process groups of the
axes that split it, then cuts the new plan's tile; ``with_halo`` is the
paper's overlapped tiling, ``collectives.halo_exchange`` over the axis
that splits the dim (``collectives.axis_of`` maps the reference's axis
names onto the port's groups).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from . import collectives
from .sharding import ShardingRules, local_slices, spec_for

__all__ = ["TiledArray"]


def _groups(mesh, part) -> list:
    """The collectives axes of a spec part (one mesh axis or a tuple,
    outer first), consecutive dp axes as one group."""
    out: list = []
    run: list = []
    for a in ((part,) if isinstance(part, str) else part) + (None,):
        if a in ("pod", "data"):
            run.append(a)
            continue
        if run:
            out.append(collectives.axis_of(mesh, tuple(run)))
            run = []
        if a is not None:
            out.append(collectives.axis_of(mesh, a))
    return out


@dataclasses.dataclass
class TiledArray:
    """This rank's tile of a distributed array, and the tiling plan that
    produced it.

    Attributes:
        data: this rank's tile (the whole array where nothing is split).
        dims: the logical dim names, one per dim.
        mesh: the port's mesh of rank processes.
        rules: the tiling plan.
        global_shape: the whole array's shape (default: ``data``'s).
    """

    data: torch.Tensor
    dims: tuple
    mesh: Any
    rules: ShardingRules
    global_shape: Optional[tuple] = None

    def __post_init__(self):
        self.dims = tuple(self.dims)
        self.global_shape = tuple(self.data.shape) \
            if self.global_shape is None else tuple(self.global_shape)

    # -- construction -------------------------------------------------------
    @classmethod
    def tile(cls, x: torch.Tensor, dims: Sequence, mesh,
             rules: ShardingRules) -> "TiledArray":
        """This rank's tile of the whole array ``x`` (the same on every
        rank): the block ``local_slices`` gives its coordinates; a dim
        that does not divide stays whole."""
        sl = local_slices(mesh, rules, x.shape, dims)
        return cls(x[sl].contiguous(), tuple(dims), mesh, rules,
                   tuple(x.shape))

    # -- metadata ------------------------------------------------------------
    @property
    def spec(self) -> tuple:
        """The reference's ``PartitionSpec`` parts of the whole array."""
        return spec_for(self.mesh, self.rules, self.global_shape, self.dims)

    def tile_shape(self) -> tuple:
        """Shape of this rank's tile."""
        return tuple(self.data.shape)

    # -- re-tiling (declarative redistribution) ------------------------------
    def _whole(self) -> torch.Tensor:
        """The whole array on every rank: an all-gather along each split
        dim over its groups, the inner axis first."""
        x = self.data
        for i, part in enumerate(self.spec):
            if part is None:
                continue
            for g in reversed(_groups(self.mesh, part)):
                x = collectives.all_gather(x.contiguous(), self.mesh,
                                           axis=i, mesh_axis=g)
        return x

    def retile(self, rules: ShardingRules) -> "TiledArray":
        """The same array under ``rules``: gathered, then cut."""
        return TiledArray.tile(self._whole(), self.dims, self.mesh, rules)

    def replicated(self) -> "TiledArray":
        """The whole array on every rank (no rule splits it)."""
        return TiledArray(self._whole(), self.dims, self.mesh,
                          ShardingRules({}), self.global_shape)

    # -- overlapped tiling ----------------------------------------------------
    def with_halo(self, dim_name: str, halo: int) -> torch.Tensor:
        """This rank's tile of ``dim_name`` extended by ``halo`` ghost
        rows from each neighbour along the axis that splits it (zeros at
        the edges: the reference's non-periodic boundary); the tile as it
        is where the dim is not split (spatial parallelism).

        Raises:
            NotImplementedError: the dim is split over two groups.
        """
        dim = self.dims.index(dim_name)
        spec = self.spec
        part = spec[dim] if dim < len(spec) else None
        if part is None:
            return self.data
        axis = _groups(self.mesh, part)
        if len(axis) != 1:
            raise NotImplementedError(f"a halo exchange over {part}: one "
                                      f"mesh axis only, as in the reference")
        return collectives.halo_exchange(self.data, self.mesh, halo,
                                         dim=dim, mesh_axis=axis[0])
