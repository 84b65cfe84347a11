"""Meshes as worlds of rank processes, and the multi-process bring-up.

Counterpart: ``repro/launch/mesh.py`` (``make_mesh``,
``make_production_mesh``, ``make_local_mesh``, ``mesh_devices``,
``free_port`` and ``maybe_init_jax_distributed``, here
``maybe_init_distributed``).  Everything here is a function: importing
this module touches no ``torch.distributed`` state.

Where the reference lays a mesh of D*P host devices out in one process
and runs the train step on each under ``shard_map``, a port mesh is a
``torch.distributed`` world of D*P rank *processes*: each computes on its
own rows of the global batch and exchanges over the mesh's dp process
group.  A ``model`` axis of M splits every rank of the dp axes into M
rank processes, laid out as ``jax.make_mesh((..., D, M), (..., "data",
"model"))`` lays out devices: row-major, ``model`` the fastest axis, so
world rank = dp rank * M + model coordinate.  Each row of M ranks is a
model group (tensor parallelism: ``core/sharding.py`` places the
parameters, the layers exchange over it), each column of D*P ranks a dp
group, and all D*P*M ranks, in that data-major order, the whole-mesh
group: the one a ``NamedSharding`` over ``("data", "model")`` tiles a dim
over (rank ``(d, m)`` holds block ``d * M + m``; the single stream's
decode cache at ``kv_seq`` on ``("data", "model")``), and the gateway's
command stream (``frontend/mesh.py``).  The backend is ``gloo``, on the
card too: NCCL refuses two ranks on one GPU, and every rank of a
one-card run shares ``cuda:0``.  Compute
stays on the device; ``core/collectives.py`` stages CUDA tensors through
pinned host buffers for the wire.  The production meshes are dryrun's,
item 15.

SPMD mode uses the same world for persistence only (its compute is
lockstep and local): the world makes its size and this process's rank
known to the checkpoint layer (``checkpoint.spmd.is_multiprocess``).  The
environment names are the port's own: ``PHYRAX_DIST_COORDINATOR``
(``host:port`` of rank 0), ``PHYRAX_DIST_NUM_PROCESSES`` and
``PHYRAX_DIST_PROCESS_ID``.  A session whose localities each run a mesh
(SPMD mode with mesh axes, fabric DDP beside a model axis), or whose
task localities sit beside a mesh, names every spawned process's world
in ``PHYRAX_DIST_PLACES`` (``mesh_places``, read by ``place_of``): a
world a locality, each with its own coordinator, so that
``make_local_mesh`` on any rank sees its own locality's mesh.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from datetime import timedelta
from typing import Any, Optional, Sequence

__all__ = ["Mesh", "free_port", "make_local_mesh", "make_mesh",
           "make_production_mesh", "maybe_init_distributed", "mesh_devices",
           "mesh_places", "place_of"]

#: how long a rank waits for the others to join the world
INIT_TIMEOUT_S = 120.0
#: how long a collective of a mesh's dp group waits for its peers before
#: it fails the run: a rank that raised alone must not hang the others
MESH_TIMEOUT_S = 300.0

_DP_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh of rank processes.

    Attributes:
        shape: axis name -> size, the reference's ``mesh.shape``
            (``data`` and ``model`` always, ``pod`` when > 1).
        rank: this process's rank along the dp axes (``pod`` major).
        coords: axis name -> this rank's coordinate.
        ranks: the world ranks of this rank's dp group (its column), by
            dp rank.
        group: the dp process group (None when the dp size is 1).
        model_ranks: the world ranks of this rank's model group (its
            row), by model coordinate.
        model_group: the model process group (None when the model axis
            is 1).
        stage_ranks: the world ranks of the stage group, by stage.
        stage_group: the stage process group (None when the stage axis
            is 1).
        world_ranks: the world ranks of the whole mesh, data-major (mesh
            order).
        world_group: the whole-mesh process group (None at a mesh of 1
            and on a stage mesh, whose stage group is the whole mesh).
        data_ranks, data_group: with ``pod`` and ``data`` > 1, the ranks
            of this rank's pod and model coordinate (its ``data`` axis
            alone) and their group.
        pod_ranks, pod_group: with ``pod``, ``data`` and ``model`` > 1,
            the ranks of this rank's pod, data-major (its ``("data",
            "model")``), and their group.
    """
    shape: dict
    rank: int = 0
    coords: dict = dataclasses.field(default_factory=dict)
    ranks: tuple = (0,)
    group: Any = None
    model_ranks: tuple = (0,)
    model_group: Any = None
    stage_ranks: tuple = (0,)
    stage_group: Any = None
    world_ranks: tuple = (0,)
    world_group: Any = None
    data_ranks: tuple = (0,)
    data_group: Any = None
    pod_ranks: tuple = (0,)
    pod_group: Any = None

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape.get(a, 1) for a in _DP_AXES)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def world_size(self) -> int:
        """The ranks of the whole mesh (its dp and model axes)."""
        return self.dp_size * self.model_size

    @property
    def world_rank(self) -> int:
        """This rank's place in the whole mesh, data-major."""
        return self.rank * self.model_size + self.model_rank

    @property
    def stage_size(self) -> int:
        return self.shape.get("stage", 1)

    @property
    def stage_rank(self) -> int:
        return self.coords.get("stage", 0)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              devices: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A mesh of ``shape`` over ``axes`` whose every device is a rank
    process of the current ``torch.distributed`` world.

    Every rank of the world calls this in the same order: it makes every
    dp group (one per model coordinate), every model group (one per dp
    rank), the stage group and the whole-mesh group, then at ``pod`` > 1
    every pod's data groups and whole-pod groups, in that fixed order,
    because ``new_group`` is collective over the whole world.
    ``devices`` are the world ranks of the mesh in mesh order (row-major,
    ``model`` fastest; default: the whole world, whose size must then be
    the mesh's; at a mesh size of 1, this process alone); a rank outside
    ``devices`` gets None.

    Raises:
        NotImplementedError: an axis the port does not know, or a
            ``stage`` axis > 1 beside dp or model axes > 1 (ROADMAP item
            14b, part 7).
        ValueError: the mesh size is not the world's (or ``devices``')
            size, or the mesh spans processes without a world.
    """
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    sizes = dict(zip(axes, shape))
    unknown = set(axes) - {"pod", "data", "model", "stage"}
    if unknown:
        raise NotImplementedError(f"mesh axes {sorted(unknown)}: the port "
                                  f"knows pod, data, model and stage")
    ndp = math.prod(sizes.get(a, 1) for a in _DP_AXES)
    nm = sizes.get("model", 1)
    ns = sizes.get("stage", 1)
    if ns > 1 and ndp * nm > 1:
        raise NotImplementedError(
            f"a stage axis combined with other mesh axes ({sizes}): GPipe "
            f"beside data or model parallelism is ROADMAP item 14b, part 7")
    n = ndp * nm * ns
    import torch.distributed as dist
    in_world = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if in_world else 1
    me = dist.get_rank() if in_world else 0
    if devices is not None:
        ranks = tuple(int(r) for r in devices)
    else:       # a mesh of 1 is this process alone, in a world or not
        ranks = tuple(range(world)) if n > 1 else (me,)
    if n > 1 and not in_world:
        raise ValueError(f"a mesh of {n} ranks needs a torch.distributed "
                         f"world of rank processes (Plan(data=..., "
                         f"model=...).compile() stands one up)")
    if len(ranks) != n:
        raise ValueError(f"a mesh of {n} ranks over "
                         f"{'the world of ' if devices is None else ''}"
                         f"{len(ranks)} rank processes")
    cols = [tuple(ranks[d * nm + c] for d in range(ndp)) for c in range(nm)]
    rows = [tuple(ranks[d * nm:(d + 1) * nm]) for d in range(ndp)]
    timeout = timedelta(seconds=MESH_TIMEOUT_S)
    dp_groups = [dist.new_group(ranks=list(c), backend="gloo",
                                timeout=timeout) if ndp > 1 else None
                 for c in cols]
    model_groups = [dist.new_group(ranks=list(r), backend="gloo",
                                   timeout=timeout) if nm > 1 else None
                    for r in rows]
    # the stage group and the whole-mesh group: the same ranks
    whole = dist.new_group(ranks=list(ranks), backend="gloo",
                           timeout=timeout) if n > 1 else None
    # a pod's own groups, where the reference names "data" or ("data",
    # "model") on a mesh with pods
    npod, data = sizes.get("pod", 1), sizes.get("data", 1)
    per_pod = data * nm
    data_sets = [tuple(ranks[p * per_pod + d * nm + c] for d in range(data))
                 for p in range(npod) for c in range(nm)] \
        if npod > 1 and data > 1 else []
    pod_sets = [tuple(ranks[p * per_pod:(p + 1) * per_pod])
                for p in range(npod)] if data_sets and nm > 1 else []
    sub = {t: dist.new_group(ranks=list(t), backend="gloo", timeout=timeout)
           for t in data_sets + pod_sets}
    if ns > 1:
        if me not in ranks:
            return None
        s = ranks.index(me)
        coords = {a: 0 for a in axes}
        coords["stage"] = s
        return Mesh(shape=sizes, coords=coords, ranks=(me,),
                    model_ranks=(me,), stage_ranks=ranks,
                    stage_group=whole)
    if me not in ranks:
        return None
    i = ranks.index(me)
    r, c = divmod(i, nm)
    coords = {a: 0 for a in axes}
    if "data" in coords:
        coords["data"] = r % data
    if "pod" in coords:
        coords["pod"] = r // data
    if "model" in coords:
        coords["model"] = c
    mine = [t for t in data_sets if me in t] or [(me,)]
    pod = [t for t in pod_sets if me in t] or [(me,)]
    return Mesh(shape=sizes, rank=r, coords=coords, ranks=cols[c],
                group=dp_groups[c], model_ranks=rows[r],
                model_group=model_groups[r], world_ranks=ranks,
                world_group=whole, data_ranks=mine[0],
                data_group=sub.get(mine[0]), pod_ranks=pod[0],
                pod_group=sub.get(pod[0]))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 256/512-chip production meshes are dryrun's.

    Raises:
        NotImplementedError: always (ROADMAP item 15).
    """
    raise NotImplementedError(
        f"the {'multipod' if multi_pod else 'single'} production mesh is "
        f"dryrun's (ROADMAP item 15)")


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1) -> Mesh:
    """The mesh of ``Plan(mesh="local")``: ``data`` and ``model`` always
    present, ``pod`` when > 1, as in the reference.  At ``data * pod *
    model > 1`` this process must be in a world of exactly that many rank
    processes.

    Raises:
        ValueError: the mesh size is not the world's size.
    """
    shape, axes = [], []
    for n, a in ((pod, "pod"), (data, "data"), (model, "model")):
        if n > 1 or a in ("data", "model"):
            shape.append(n)
            axes.append(a)
    return make_mesh(tuple(shape), tuple(axes))


def mesh_devices(mesh) -> int:
    """The mesh's size: its rank processes, D * P * M (or S)."""
    return math.prod(mesh.shape.values())


def free_port() -> int:
    """An ephemeral loopback port for the coordinator of a single-machine
    SPMD run (the OS-assigned port is released before returning; the race
    window is acceptable for tests and drills)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mesh_places(coordinators: Sequence[str], size: int) -> dict:
    """The places of a session whose localities each run a mesh world of
    ``size`` rank processes (``coordinators[w]``: world ``w``'s): the
    spawned processes of the session's two groups and where each one
    joins.  World ``w``'s rank 0 is locality ``w`` (the driver for ``w =
    0``); its ranks ``1..size-1`` are the rank group's processes
    ``w * (size - 1) + 1 ..``, in order.

    Returns:
        ``{"localities": {rank: place}, "ranks": {rank: place}}``, a place
        being ``{"coordinator", "size", "rank", "locality"}``: the world
        to join, its size, the process's rank in it and the locality
        whose mesh it is.
    """
    def place(w: int, r: int) -> dict:
        return {"coordinator": coordinators[w], "size": int(size),
                "rank": r, "locality": w}
    return {"localities": {w: place(w, 0)
                           for w in range(1, len(coordinators))},
            "ranks": {w * (size - 1) + r: place(w, r)
                      for w in range(len(coordinators))
                      for r in range(1, size)}}


def place_of(rank: Optional[int] = None) -> Optional[dict]:
    """This process's place (``mesh_places``), from the spawn
    environment's ``PHYRAX_DIST_PLACES`` (a JSON object by locality rank;
    ``rank`` defaults to ``PHYRAX_LOCALITY_RANK``), or None: no places
    named, or none for this rank (a task locality, an elastic joiner)."""
    import json
    raw = os.environ.get("PHYRAX_DIST_PLACES")
    if not raw:
        return None
    if rank is None:
        rank = int(os.environ.get("PHYRAX_LOCALITY_RANK", "0"))
    return json.loads(raw).get(str(int(rank)))


def maybe_init_distributed(*, process_id: int | None = None,
                           num_processes: int | None = None,
                           coordinator: str | None = None) -> bool:
    """Join the ``torch.distributed`` world of a spawned multi-process run.

    Reads ``PHYRAX_DIST_COORDINATOR`` (``host:port`` of process 0) plus
    optional ``PHYRAX_DIST_NUM_PROCESSES`` / ``PHYRAX_DIST_PROCESS_ID``
    overrides; explicit arguments win over the environment.  Returns
    False without touching ``torch.distributed`` unless a coordinator is
    configured: the one-process path stays cold.  Blocks until every rank
    has joined (at most ``INIT_TIMEOUT_S``).

    Args:
        process_id: this process's rank (defaults to the env override).
        num_processes: world size (defaults to the env override).
        coordinator: ``host:port`` of process 0 (defaults to the env gate;
            an SPMD ``Session`` passes it explicitly so the driver
            process's environment is never mutated).
    Returns:
        True if ``torch.distributed.init_process_group`` was called.
    Raises:
        ValueError: a coordinator is configured but the world size is not
            (set ``PHYRAX_DIST_NUM_PROCESSES`` or pass ``num_processes``):
            half-configured must be loud, not a guaranteed-wrong world of
            size 0.
        RuntimeError: initialization was configured but failed (surfaced
            from ``torch.distributed``: a misconfigured coordinator should
            be loud).
    """
    coordinator = coordinator or os.environ.get("PHYRAX_DIST_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("PHYRAX_DIST_NUM_PROCESSES", "0"))
    if not num_processes:
        raise ValueError(
            "PHYRAX_DIST_COORDINATOR is set but the world size is unknown: "
            "set PHYRAX_DIST_NUM_PROCESSES (and PHYRAX_DIST_PROCESS_ID) or "
            "pass num_processes/process_id explicitly")
    if process_id is None:
        process_id = int(os.environ.get("PHYRAX_DIST_PROCESS_ID", "0"))
    import torch.distributed as dist
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes,
                            timeout=timedelta(seconds=INIT_TIMEOUT_S))
    return True
