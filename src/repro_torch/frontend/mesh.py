"""The train and serve loops of every rank of a mesh session
(``Plan(data=..., model=...)``).

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
``Session.serve`` on any mesh runs ``rank_serve`` the same way: the wave
loop on every rank, on the same requests, each dp rank on its rows of
every wave (waves stacked on a task locality where the session has
some).  ``Session.serve_stream`` on a mesh runs
``rank_serve_stream``: rank 0 drives the gateway (``frontend/gateway.py``:
admission, deadlines, routing and the live queue stay on its clock and
threads), and every other rank follows its command stream.

Lockstep is the contract: every rank issues the same collectives in the
same order, so everything that decides one is a function of the spec
alone, never of one rank's state:
  * every rank builds the mesh (making its dp group is collective) and
    the train step from the same ``Plan``, and draws the same parameters
    from ``plan.seed``;
  * batch ``it`` is ``stream.batch_at(it)`` on every rank, each taking its
    own rows (``steps.batch_rows``), or, beside task localities, the
    batch a task locality built, fed by rank 0 over the whole-mesh group;
  * a resume restores the step the driver chose (``spec["start"]``) from
    the shared directory on every rank, each cutting its own shard;
  * saves happen at the same steps on every rank, each starting with the
    collectives that gather the parameters and the optimizer state into
    the reference's global layout (over the model group and the dp
    group); rank 0 alone writes it;
  * the injected failure (``fail_at_step``) raises on every rank before
    the step's collectives, so the world survives it;
  * the resilience modes agree every verdict over the whole world
    (``core/resilience.py``);
  * the serve loop's greedy tokens are the global argmax of the model
    group's logits (``LM.greedy``), the same on every rank; each wave's
    tokens are gathered over the dp group;
  * the gateway's device bodies (a request's batch-1 prefill, a
    replica's refill, its decode round, a page drop) run on rank 0 only
    after it has broadcast their command over the whole-mesh group, under
    one lock (``Lockstep``): the followers run the same bodies in the
    order rank 0 ran them, and rank 0's runtime threads never interleave
    two bodies' collectives.  A poisoned prefill raises before its
    command is sent.  The closing command ends the followers' loop.
A rank that raises alone leaves the others waiting in a collective until
the dp group's timeout (``launch.mesh.MESH_TIMEOUT_S``), which fails them
loudly.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..checkpoint.checkpoint import CheckpointManager
from ..core import collectives
from ..core import steps as steps_lib
from ..core.futures import block_until_ready
from ..core.paging import InferenceCache, PagePool
from ..core.resilience import ResilientRunner
from ..data.pipeline import stream_for, to_device
from ..kernels import KERNELS
from ..launch.mesh import make_local_mesh
from .gateway import DeviceBodies, _adopt

__all__ = ["Lockstep", "rank_serve", "rank_serve_stream", "rank_train",
           "serve_loop", "serve_waves", "spec_prompts", "stream_steps",
           "train_loop"]


def train_loop(spec: dict, *, save: Optional[Callable] = None,
               on_step: Optional[Callable] = None,
               batch_of: Optional[Callable] = None) -> dict:
    """The lockstep train loop of one rank: a mesh rank's (``rank_train``)
    and an SPMD shadow process's (``frontend.spmd.shadow_train``, on a
    mesh of one, or on its locality's mesh), each with its own ``save``.

    Args:
        spec: ``{"plan", "steps", "start", "ckpt_dir", "ckpt_every",
            "fail_at_step", "resilience", "fault_hook", "stream",
            "num_threads", "feed", "params"}``; ``start`` is the
            checkpoint step to resume from (0: the seed's init, or
            ``params``: a host tree of the global parameters in the
            reference's layout, a test seam), ``fault_hook`` a
            module-level callable given to ``ResilientRunner`` on every
            rank (a test seam; None in runs); ``feed`` (a mesh with task
            localities) says that rank 0 hands every rank each step's
            host batch over the whole-mesh group (axis ``mesh``) instead
            of each rank drawing it from the stream.
        save: ``save(step_count, train_step, params, opt, metrics)``
            every ``ckpt_every`` steps and after the last step unless the
            cadence saved it or nothing ran (None: no saves).
        on_step: ``on_step(it, metrics)`` after every step.
        batch_of: rank 0's ``batch_of(it)``: the host batch it feeds
            (built on a task locality).
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
    feed = bool(spec.get("feed"))
    params, opt = step.init(
        torch.Generator(device=device).manual_seed(plan.seed), device)
    start, ckpt_dir = int(spec.get("start") or 0), spec.get("ckpt_dir")
    if spec.get("params") is not None and not start:
        from ..bridge import params_from_numpy
        params = step.shard_params(
            params_from_numpy(spec["params"], plan.config(), "cpu"), device)
    if start:
        with CheckpointManager(ckpt_dir, async_save=False, spmd=False) as cm:
            _, (pg, og) = cm.restore(
                (step.params_like(), step.global_like()), step=start)
        params = step.shard_params(pg, device)
        opt = step.shard_opt(og, device)
        del pg, og
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
        if feed:
            host = collectives.broadcast_object(
                batch_of(it) if batch_of is not None else None, mesh)
        else:
            host = stream.batch_at(it)
        batch = to_device(host, device)
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
        # every rank: collectives
        gathered = (step.gather_params(params), step.gather_opt(opt))
        if driver is not None:
            driver.save(s, gathered, metrics)

    out = train_loop(spec, save=save if spec.get("ckpt_dir") else None,
                     on_step=driver.on_step if driver is not None else None,
                     batch_of=driver.batch if driver is not None else None)
    if driver is None:
        out["params"] = None
    return out


def _rank_device(spec: dict) -> torch.device:
    plan = spec["plan"]
    device = torch.device(plan.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Plan(device={plan.device!r}) on a rank "
                           f"without a GPU")
    if spec.get("num_threads"):
        torch.set_num_threads(int(spec["num_threads"]))
    return device


def _serve_params(spec: dict, step, device):
    """The serve parameters of ``step``'s rank: ``spec["params"]`` (a host
    tree of the global parameters in the reference's layout, a test
    seam), else drawn from ``plan.seed``."""
    if spec.get("params") is not None:
        from ..bridge import params_from_numpy
        return params_from_numpy(spec["params"],
                                 steps_lib._serve_cfg(spec["plan"].config()),
                                 device, mesh=step.mesh, rules=step.rules)
    return step.init(torch.Generator(device=device).manual_seed(
        spec["plan"].seed), device)


def _launches(before: dict) -> dict:
    return {fn.__name__: fn.launches - before[fn.__name__] for fn in KERNELS}


def spec_prompts(spec: dict) -> list:
    """The requests of a serve spec: ``spec["prompts"]``, else
    ``spec["requests"]`` seeded ones (the one-process loop's)."""
    prompts = spec.get("prompts")
    if prompts is None:
        plan = spec["plan"]
        rng = np.random.default_rng(plan.seed)
        prompts = [rng.integers(0, plan.config().vocab, spec["prompt_len"])
                   .astype(np.int32) for _ in range(spec["requests"])]
    return list(prompts)


def serve_waves(prompts: list, slots: int, prompt_len: int) -> list:
    """The wave loop's waves, as the one-process loop takes them: ``[(the
    wave's ``slots`` prompts, idle slots padded with zeros, its real
    count), ...]``."""
    waiting, out = list(prompts), []
    while waiting:
        wave = [waiting.pop() for _ in range(min(slots, len(waiting)))]
        n_real = len(wave)
        out.append((wave + [np.zeros(prompt_len, np.int32)]
                    * (slots - n_real), n_real))
    return out


def serve_loop(spec: dict) -> dict:
    """The wave loop of one rank of a mesh: the serve steps on this
    rank's blocks (``core/steps.py`` over ``decode_rules``), the same
    requests in the same waves on every rank, each dp rank on its
    ``rows`` of every wave (every row where the slots do not divide by the
    dp degree), greedy tokens by the model group's argmax, each wave's
    tokens gathered over the dp group.

    Args:
        spec: ``{"plan", "requests", "prompt_len", "gen_len", "slots",
            "prompts", "waves", "params", "num_threads"}``; ``prompts`` a
            list of int32 arrays (None: ``requests`` seeded ones, the
            one-process loop's), ``waves`` the waves already stacked
            (``[(int32 [slots, prompt_len], real count), ...]``: a task
            locality's ``stack``; None: ``serve_waves`` of the prompts),
            ``params`` a host tree of the global serve parameters in the
            reference's layout (a test seam; None: drawn from
            ``plan.seed``).
    Returns:
        dict with the one-process loop's keys (``tokens_per_s``,
        ``requests``, ``tokens``, ``padded_tokens``, ``nodes``, ``waves``,
        ``generated``: every row, ``first_prefill_logits``: every row and
        the whole vocab) and ``launches``, ``wire``
        (``collectives.stats``), ``cache_shapes`` (the shapes of this
        rank's cache leaves after the first prefill), ``prefill_s`` and
        ``decode_s`` (each step's host wall, ended by a synchronize on the
        card) and ``peak_bytes``.
    """
    plan = spec["plan"]
    device = _rank_device(spec)
    cfg = plan.config()
    prompt_len, gen_len = spec["prompt_len"], spec["gen_len"]
    slots = spec["slots"]
    mesh = make_local_mesh(data=plan.data, model=plan.model, pod=plan.pod)
    shape = {"seq_len": prompt_len + gen_len, "global_batch": slots}
    pre = steps_lib.make_prefill_step(cfg, shape, mesh=mesh)
    dec = steps_lib.make_decode_step(cfg, shape, mesh=mesh)
    params = _serve_params(spec, pre, device)
    rows = pre.rows
    waves = spec.get("waves")
    if waves is None:
        waves = serve_waves(spec_prompts(spec), slots, prompt_len)
    requests = sum(n for _, n in waves)

    def clock(t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = {fn.__name__: fn.launches for fn in KERNELS}
    collectives.reset_stats()
    generated, nodes, first, cache_shapes = [], [], None, None
    prefill_s, decode_s = [], []
    tokens_out = padded_out = 0
    t_start = time.perf_counter()
    with torch.no_grad():
        for w, (wave, n_real) in enumerate(waves):
            toks = torch.from_numpy(np.stack(wave)[rows]).to(device,
                                                             torch.int64)
            batch = {"tokens": toks}
            if cfg.family == "encdec":
                # the stub audio frontend's frames, as in the reference
                batch["frames"] = torch.zeros(
                    (len(toks), cfg.enc_frames, cfg.d_model),
                    dtype=cfg.c_dtype, device=device)
            t0 = time.perf_counter()
            logits, cache = pre.fn(params, batch)
            if first is None:
                first = pre.gather_rows(pre.gather_logits(logits)).float() \
                    .cpu()
                cache_shapes = [tuple(t.shape)
                                for t in pytree.tree_leaves(cache)]
            tok = pre.greedy(logits)[:, None]
            prefill_s.append(clock(t0))
            nodes.append(f"prefill:w{w}")
            out = torch.empty((len(toks), gen_len + 1), dtype=torch.int64,
                              device=device)
            out[:, 0] = tok[:, 0]
            for t in range(gen_len):
                t0 = time.perf_counter()
                logits, cache = dec.fn(params, cache, {"tokens": tok},
                                       prompt_len + t)
                tok = dec.greedy(logits)[:, None]
                out[:, t + 1] = tok[:, 0]
                decode_s.append(clock(t0))
                nodes.append(f"decode:w{w}:t{t}")
            generated.append(dec.gather_rows(out).cpu())
            tokens_out += n_real * gen_len
            padded_out += (slots - n_real) * gen_len
    dt = clock(t_start)
    return {"tokens_per_s": tokens_out / dt if dt else 0.0,
            "requests": requests, "tokens": tokens_out,
            "padded_tokens": padded_out, "nodes": nodes,
            "waves": len(generated), "generated": generated,
            "first_prefill_logits": first, "cache_shapes": cache_shapes,
            "launches": _launches(before), "wire": collectives.stats(),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0)}


def rank_serve(spec: dict, endpoint: Optional[Any] = None, *,
               driver: Optional[Any] = None) -> dict:
    """Serve on this rank of the mesh in lockstep with the others
    (``serve_loop``); ``endpoint`` and ``driver`` are unused (the
    ``Session.run_ranks`` contract)."""
    return serve_loop(spec)


# ---------------------------------------------------------------------------
# The gateway over rank processes
# ---------------------------------------------------------------------------
def stream_steps(cfg, mesh, prompt_len: int, gen_len: int, slots: int):
    """The gateway's (batch-1 prefill, ``slots``-wide decode) steps on
    ``mesh``: the prefill's cache is tiled as the decode step's along
    every dim but ``batch`` (its rules), so that a parked state writes
    straight into a slot row of this rank's decode cache."""
    S = prompt_len + gen_len
    dec = steps_lib.make_decode_step(cfg, {"seq_len": S,
                                           "global_batch": slots}, mesh=mesh)
    pre = steps_lib.make_prefill_step(cfg, {"seq_len": S, "global_batch": 1},
                                      mesh=mesh, rules=dec.rules)
    return pre, dec


class Lockstep:
    """Rank 0's side of the gateway's command stream: ``run`` broadcasts
    a device body's command over the whole-mesh group, then runs the body,
    both under one lock, so that the bodies' collectives keep one order on
    every rank whichever runtime thread runs them; ``close`` sends the
    closing command."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.lock = threading.Lock()
        self.commands = 0

    def run(self, cmd: tuple, body: Callable, *args):
        with self.lock:
            collectives.broadcast_object(cmd, self.mesh)
            self.commands += 1
            return body(*args)

    def close(self) -> None:
        with self.lock:
            collectives.broadcast_object(("close",), self.mesh)


def _follow(mesh, bodies: DeviceBodies, page_bytes: int) -> dict:
    """A follower's loop: run each command's body on this rank's blocks
    until the closing command; returns its page ``cache`` counters and
    the ``commands`` it took, the closing one included.  Its page caches
    mirror rank 0's (one per replica over one pool; a dropped request's
    late prefill parks nothing), so every refill finds its state where
    rank 0 finds it."""
    pool = PagePool(page_bytes)
    caches: dict = {}
    carries: dict = {}
    prompts: dict = {}
    dropped: set = set()
    commands = 0

    def cache(i: int) -> InferenceCache:
        if i not in caches:
            caches[i] = InferenceCache(pool, name=f"R{i}")
        return caches[i]

    while True:
        cmd = collectives.broadcast_object(None, mesh)
        commands += 1
        kind = cmd[0]
        if kind == "close":
            break
        if kind == "prefill":
            _, rid, replica, prompt = cmd
            prompts[rid] = prompt
            _, state = bodies.prefill(prompt)
            if rid not in dropped:
                cache(replica).put(rid, bodies.park(state))
        elif kind == "refill":
            _, i, fresh, joins = cmd
            tok, kv = bodies.fresh_carry() if fresh else carries[i]
            tok = tok.clone()
            for slot, rid, first in joins:
                state, _ = _adopt(cache(i), [c for j, c in caches.items()
                                             if j != i], rid)
                if state is None:
                    first, state = bodies.prefill(prompts[rid])
                bodies.write_row(kv, state, slot)
                tok[slot, 0] = first
            carries[i] = (tok, kv)
        elif kind == "decode":
            _, i, pos = cmd
            carries[i] = bodies.decode(carries[i], pos)
        elif kind == "drop":
            dropped.add(cmd[1])
            for c in caches.values():
                if cmd[1] in c:
                    c.drop(cmd[1])
        else:
            raise ValueError(f"unknown gateway command {kind!r}")
    counters: dict = {}
    for c in caches.values():
        for k, v in c.counters().items():
            if k.startswith("cache_"):
                counters[k] = counters.get(k, 0) + v
    counters.update(pool.counters())
    return {"cache": counters, "commands": commands}


def rank_serve_stream(spec: dict, endpoint: Optional[Any] = None, *,
                      driver: Optional[Callable] = None) -> dict:
    """The gateway on this rank of the mesh: rank 0 calls
    ``driver(pre, dec, params, lockstep)`` (``Session.serve_stream``'s
    gateway run, whose device bodies go through ``lockstep``); every other
    rank follows the command stream (``_follow``).

    Args:
        spec: ``{"plan", "prompt_len", "gen_len", "slots", "page_bytes",
            "params", "num_threads"}`` (``params`` as ``serve_loop``'s).
        driver: rank 0's gateway run (None on the followers).
    Returns:
        rank 0: the driver's result; a follower: its ``cache`` counters
        and ``commands``; each with ``launches``, ``wire`` and
        ``request_bytes`` (one request's parked state on this rank).
    """
    plan = spec["plan"]
    device = _rank_device(spec)
    mesh = make_local_mesh(data=plan.data, model=plan.model, pod=plan.pod)
    pre, dec = stream_steps(plan.config(), mesh, spec["prompt_len"],
                            spec["gen_len"], spec["slots"])
    params = _serve_params(spec, pre, device)
    before = {fn.__name__: fn.launches for fn in KERNELS}
    collectives.reset_stats()
    with torch.no_grad():
        if driver is not None:
            lockstep = Lockstep(mesh)
            try:
                out = driver(pre, dec, params, lockstep)
            finally:
                lockstep.close()
            out["commands"] = lockstep.commands
        else:
            bodies = DeviceBodies(pre, dec, params, device, spec["slots"])
            out = _follow(mesh, bodies, spec["page_bytes"])
    out.update(launches=_launches(before), wire=collectives.stats(),
               request_bytes=sum(
                   sp.size * sp.dtype.itemsize for sp in pytree.tree_leaves(
                       pre.cache_specs, is_leaf=steps_lib.is_spec)))
    return out
