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

import torch

from ..checkpoint import spmd as ckspmd
from ..checkpoint.checkpoint import CheckpointManager
from ..core import steps as steps_lib
from ..core.futures import block_until_ready
from ..data.pipeline import stream_for, to_device
from ..kernels import KERNELS

__all__ = ["shadow_train"]


def shadow_train(spec: dict, endpoint: Optional[Any] = None) -> dict:
    """Mirror ``Session.train``'s device computation on this process and
    write this process's checkpoint segments (see the module docstring).

    Args:
        spec: ``{"plan", "steps", "ckpt_every", "ckpt_dir", "resume",
            "stream", "num_threads"}`` as posted by
            ``DistributedGraph.spmd_train``.
        endpoint: this locality's active-message ``Endpoint``; shard
            manifest entries are posted to the driver through it (None
            writes shards without reporting: test use).
    Returns:
        dict with ``step`` (the final step count), ``final_loss`` and
        ``launches``: each kernel wrapper's launches during this loop, by
        name.  The reference returns the step alone; the launch counts
        are the port's, so that a driver can see that every process's
        steps ran the kernels.
    Raises:
        RuntimeError: the plan asks for CUDA and there is none.
    """
    plan = spec["plan"]
    device = torch.device(plan.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Plan(device={plan.device!r}) on a locality "
                           f"without a GPU")
    if spec.get("num_threads"):
        torch.set_num_threads(int(spec["num_threads"]))
    steps: int = spec["steps"]
    ckpt_every: int = spec.get("ckpt_every") or 0
    ckpt_dir: str = spec.get("ckpt_dir") or ""
    rank = int(os.environ.get("PHYRAX_LOCALITY_RANK", "0"))
    before = {fn.__name__: fn.launches for fn in KERNELS}
    step = steps_lib.make_train_step(plan.config(), plan.build_strategy(),
                                     plan=plan)
    params, opt = step.init(
        torch.Generator(device=device).manual_seed(plan.seed), device)
    start = 0
    if spec.get("resume") and ckpt_dir:
        with CheckpointManager(ckpt_dir, async_save=False) as cm:
            if cm.latest_step() is not None:
                start, (params, opt) = cm.restore((params, opt))
    stream = spec.get("stream")
    if stream is None:
        stream = stream_for(plan.config(), batch=plan.batch, seq=plan.seq,
                            seed=plan.seed)

    def save(s: int, state):
        tmp = Path(ckpt_dir) / f".tmp_step_{s:08d}"
        entry = ckspmd.write_spmd_shard(str(tmp), rank, state)
        if endpoint is not None:
            endpoint.post(0, "ckpt_entries",
                          {"step": int(s), "rank": rank, "entry": entry})

    metrics = None
    for it in range(start, steps):
        batch = to_device(stream.batch_at(it), device)
        metrics, params, opt = step.fn(params, opt, batch)
        if ckpt_dir and ckpt_every and (it + 1) % ckpt_every == 0:
            block_until_ready(metrics)      # save only retired state
            save(it + 1, (params, opt))
    block_until_ready(metrics)
    if ckpt_dir and ckpt_every and steps % ckpt_every != 0 \
            and metrics is not None:
        save(steps, (params, opt))          # mirrors the driver's final save
    return {"step": steps,
            "final_loss": (float(metrics["loss"]) if metrics is not None
                           else float("nan")),
            "launches": {fn.__name__: fn.launches - before[fn.__name__]
                         for fn in KERNELS}}
