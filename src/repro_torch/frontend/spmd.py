"""The SPMD shadow train loop: what a worker locality runs under
``Plan(spmd=True)`` (DESIGN.md §10).

Counterpart: ``repro/frontend/spmd.py`` (``shadow_train``).  Every process
keeps its *compute* local and bit-identical: each builds the same config,
train step and stream from the same ``Plan`` and steps them in lockstep
(the same seed, batches keyed by step index, deterministic kernels), which
is the state evolution a true SPMD program would give each process for its
replicated parameters.  What IS distributed is persistence: at every save
point this loop writes only this process's segments
(``checkpoint.spmd.write_spmd_shard``) into the shared checkpoint
directory and posts the driver just the manifest *entry* (offsets,
checksums: metadata).  No leaf bytes cross the messaging layer either way.

The loop is started by a ``spmd_train`` active message
(``DistributedGraph.spmd_train`` -> ``Locality._on_spmd_train``) and
reports completion in a ``spmd_done`` post.

Lockstep invariants this loop mirrors from ``Session.train`` - drift here
would corrupt checkpoints (segments of different logical steps):
  * params/opt come from ``step.init(generator seeded with plan.seed,
    device)``;
  * batch ``it`` is ``stream.batch_at(it)``, moved to the plan's device;
  * the state advances ONLY through ``step.fn``;
  * saves happen when ``(it + 1) % ckpt_every == 0``, plus a final save
    when ``steps % ckpt_every != 0`` and a step ran (the port's driver
    skips it when a resume left nothing to run), always after a device
    synchronize (the step retired);
  * a resume restores the same latest checkpoint the driver restores
    (shared directory, committed manifests only);
  * CPU float32 sums run on the driver's thread count (``num_threads`` in
    the spec): a different count may sum in another order.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

from ..checkpoint import spmd as ckspmd
from ..checkpoint.checkpoint import CheckpointManager
from ..core.futures import block_until_ready
from .mesh import train_loop

__all__ = ["shadow_train"]


def shadow_train(spec: dict, endpoint: Optional[Any] = None) -> dict:
    """Mirror ``Session.train``'s device computation on this process and
    write this process's checkpoint segments (see the module docstring):
    ``frontend.mesh.train_loop`` on a mesh of one, or with mesh axes on
    this locality's mesh (this process its rank 0, the others running
    ``frontend.mesh.rank_train``), whose saves write segments: the
    locality's ``p``-th slice of every leaf that splits over the
    ``localities`` processes, assembled from its mesh's blocks.

    Args:
        spec: ``{"plan", "steps", "ckpt_every", "ckpt_dir", "resume",
            "stream", "num_threads"}`` as posted by
            ``DistributedGraph.spmd_train``.
        endpoint: this locality's active-message ``Endpoint``; shard
            manifest entries are posted to the driver through it (None
            writes shards without reporting: test use).
    Returns:
        dict with ``step`` (the final step count), ``final_loss``,
        ``launches`` (each kernel wrapper's launches during this loop, by
        name) and ``wire`` (its mesh's collectives).  The reference
        returns the step alone; the launch counts are the port's, so
        that a driver can see that every process's steps ran the
        kernels.
    Raises:
        RuntimeError: the plan asks for CUDA and there is none.
    """
    ckpt_dir: str = spec.get("ckpt_dir") or ""
    rank = int(os.environ.get("PHYRAX_LOCALITY_RANK", "0"))
    world = spec["plan"].localities
    start = 0
    if spec.get("resume") and ckpt_dir:
        with CheckpointManager(ckpt_dir, async_save=False, spmd=False) as cm:
            start = cm.latest_step() or 0

    def save(s: int, step, params, opt, metrics):
        # the global layout: on a mesh, gathered over this locality's
        # ranks (collectives of its own world, not the messaging layer)
        state = (step.gather_params(params), step.gather_opt(opt))
        block_until_ready(metrics)          # save only retired state
        tmp = Path(ckpt_dir) / f".tmp_step_{s:08d}"
        entry = ckspmd.write_spmd_shard(str(tmp), rank, state, world=world,
                                        rank=rank)
        if endpoint is not None:
            endpoint.post(0, "ckpt_entries",
                          {"step": int(s), "rank": rank, "entry": entry})

    out = train_loop(dict(spec, start=start),
                     save=save if ckpt_dir else None)
    return {k: out[k] for k in ("step", "final_loss", "launches", "wire")}
