"""The multi-process world of SPMD mode (DESIGN.md §10).

Counterpart: ``repro/launch/mesh.py``, only ``free_port`` and
``maybe_init_jax_distributed``, here ``maybe_init_distributed``: it joins
a ``torch.distributed`` world over the ``gloo`` backend, on the card too.
SPMD mode runs no collective (its compute is lockstep and local, its
checkpoint segments are written by their own processes); the world only
makes its size and this process's rank known to the checkpoint layer
(``checkpoint.spmd.is_multiprocess``), and NCCL would refuse two ranks on
one GPU.  The environment names are the port's own:
``PHYRAX_DIST_COORDINATOR`` (``host:port`` of rank 0),
``PHYRAX_DIST_NUM_PROCESSES`` and ``PHYRAX_DIST_PROCESS_ID``.  The mesh
builders (``make_local_mesh`` and the rest) come with the mesh-parallel
strategies, ROADMAP item 14.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta

__all__ = ["free_port", "maybe_init_distributed"]

#: how long a rank waits for the others to join the world
INIT_TIMEOUT_S = 120.0


def free_port() -> int:
    """An ephemeral loopback port for the coordinator of a single-machine
    SPMD run (the OS-assigned port is released before returning; the race
    window is acceptable for tests and drills)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


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
