"""The train loop of every rank of a mesh session (``Plan(data=...)``).

No counterpart file: the reference runs a mesh's ranks as devices of one
process under ``shard_map`` (``repro/frontend/plan.py``'s train loop over
``make_train_step``), and the port runs them as the processes of a
``torch.distributed`` world (``launch/mesh.py``).  ``Session.train`` runs
``rank_train`` here as rank 0, with a ``driver`` that logs, calls the
hooks and writes the checkpoints; each worker locality of the session
runs the same function, started by the ``spmd_train`` active message
with this loop in its spec, and reports in a ``spmd_done`` post.  Its
loop, ``train_loop``, is also SPMD mode's shadow loop
(``frontend/spmd.py``): a mesh of one with a save of its own.

Lockstep is the contract: every rank issues the same collectives in the
same order, so everything that decides one is a function of the spec
alone, never of one rank's state:
  * every rank builds the mesh (making its dp group is collective) and
    the train step from the same ``Plan``, and draws the same parameters
    from ``plan.seed``;
  * batch ``it`` is ``stream.batch_at(it)`` on every rank, each taking its
    own rows (``steps.batch_rows``);
  * a resume restores the step the driver chose (``spec["start"]``) from
    the shared directory on every rank, each cutting its own shard;
  * saves happen at the same steps on every rank, each starting with the
    collective that gathers the optimizer state into the reference's
    global layout; rank 0 alone writes it;
  * the injected failure (``fail_at_step``) raises on every rank before
    the step's collectives, so the world survives it;
  * the resilience modes agree every verdict over the dp group
    (``core/resilience.py``).
A rank that raises alone leaves the others waiting in a collective until
the dp group's timeout (``launch.mesh.MESH_TIMEOUT_S``), which fails them
loudly.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..core import collectives
from ..core import steps as steps_lib
from ..core.futures import block_until_ready
from ..core.resilience import ResilientRunner
from ..data.pipeline import stream_for, to_device
from ..kernels import KERNELS
from ..launch.mesh import make_local_mesh

__all__ = ["rank_train", "train_loop"]


def train_loop(spec: dict, *, save: Optional[Callable] = None,
               on_step: Optional[Callable] = None) -> dict:
    """The lockstep train loop of one rank: a mesh rank's (``rank_train``)
    and an SPMD shadow process's (``frontend.spmd.shadow_train``, on a
    mesh of one), each with its own ``save``.

    Args:
        spec: ``{"plan", "steps", "start", "ckpt_dir", "ckpt_every",
            "fail_at_step", "resilience", "fault_hook", "stream",
            "num_threads"}``; ``start`` is the checkpoint step to resume
            from (0: the seed's init), ``fault_hook`` a module-level
            callable given to ``ResilientRunner`` on every rank (a test
            seam; None in runs).
        save: ``save(step_count, train_step, params, opt, metrics)``
            every ``ckpt_every`` steps and after the last step unless the
            cadence saved it or nothing ran (None: no saves).
        on_step: ``on_step(it, metrics)`` after every step.
    Returns:
        dict with ``step``, ``final_loss``, ``params``, ``launches`` (each
        kernel wrapper's launches in this loop), ``wire``
        (``collectives.stats`` of this loop), ``resilience`` (the runner's
        stats and the input copies' cost) and ``peak_bytes`` (the device's
        peak allocation during the loop, 0 on the CPU).
    Raises:
        RuntimeError: the injected failure, or the plan asks for CUDA and
            there is none.
    """
    plan = spec["plan"]
    device = torch.device(plan.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Plan(device={plan.device!r}) on a rank "
                           f"without a GPU")
    if spec.get("num_threads"):
        torch.set_num_threads(int(spec["num_threads"]))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = {fn.__name__: fn.launches for fn in KERNELS}
    mesh = make_local_mesh(data=plan.data, model=plan.model, pod=plan.pod)
    step = steps_lib.make_train_step(plan.config(), plan.build_strategy(),
                                     plan=plan, mesh=mesh)
    params, opt = step.init(
        torch.Generator(device=device).manual_seed(plan.seed), device)
    start, ckpt_dir = int(spec.get("start") or 0), spec.get("ckpt_dir")
    if start:
        with CheckpointManager(ckpt_dir, async_save=False, spmd=False) as cm:
            _, (params, og) = cm.restore((params, step.global_like()),
                                         step=start)
        opt = step.shard_opt(og, device)
        del og
    stream = spec.get("stream") or stream_for(
        plan.config(), batch=plan.batch, seq=plan.seq, seed=plan.seed)
    resilience = spec.get("resilience", "none")
    runner = ResilientRunner(step.fn_nodonate, mesh=mesh,
                             fault_hook=spec.get("fault_hook")) \
        if resilience in ("replay", "replicate") else None
    steps = spec["steps"]
    every = (spec.get("ckpt_every") or 0) if save is not None else 0
    collectives.reset_stats()
    metrics = None
    for it in range(start, steps):
        if spec.get("fail_at_step") == it:
            raise RuntimeError(f"injected node failure at step {it}")
        batch = to_device(stream.batch_at(it), device)
        if resilience == "replay":
            metrics, params, opt = runner.replay(params, opt, batch)
        elif resilience == "replicate":
            metrics, params, opt = runner.replicate(params, opt, batch, n=2)
        else:
            metrics, params, opt = step.fn(params, opt, batch)
        if on_step is not None:
            on_step(it, metrics)
        if every and (it + 1) % every == 0:
            save(it + 1, step, params, opt, metrics)
    if every and steps % every and metrics is not None:
        save(steps, step, params, opt, metrics)
    block_until_ready(metrics)
    return {"step": steps,
            "final_loss": (float(metrics["loss"]) if metrics is not None
                           else float("nan")),
            "params": params,
            "launches": {fn.__name__: fn.launches - before[fn.__name__]
                         for fn in KERNELS},
            "wire": collectives.stats(),
            "resilience": dict(runner.stats if runner else {},
                               copies=dict(step.copy_stats)),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0)}


def rank_train(spec: dict, endpoint: Optional[Any] = None, *,
               driver: Optional[Any] = None) -> dict:
    """Train this rank of the mesh in lockstep with the others
    (``train_loop``): every save starts with the collective that gathers
    the optimizer state into the reference's global layout on every
    rank, and rank 0's ``driver`` writes it.

    Args:
        spec: ``train_loop``'s.
        endpoint: the worker's active-message endpoint (unused: a mesh
            exchanges over its process group).
        driver: rank 0's ``on_step(it, metrics)`` and ``save(step,
            state, metrics)`` (None on the workers).
    Returns:
        ``train_loop``'s dict; ``params`` is None on the workers.
    """
    def save(s: int, step, params, opt, metrics):
        gathered = step.gather_opt(opt)           # every rank: collective
        if driver is not None:
            driver.save(s, (params, gathered), metrics)

    out = train_loop(spec, save=save if spec.get("ckpt_dir") else None,
                     on_step=driver.on_step if driver is not None else None)
    if driver is None:
        out["params"] = None
    return out
