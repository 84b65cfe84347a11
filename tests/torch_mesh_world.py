"""A gloo world of rank processes for the port's mesh tests (CPU).

``run_world(job, n, payload)`` spawns ``n`` processes that join one
``torch.distributed`` gloo world over a loopback port, run
``JOBS[job](rank, n, payload)`` and hand back each rank's result.  The
ranks import torch and the port only (no JAX); the module also holds the
picklable fault hooks the Session tests ship to their worker ranks.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
import traceback

import numpy as np

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TIMEOUT_S = 240


def _rank_main(job, rank, n, port, payload, queue):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = JOBS[job](rank, n, payload)
        queue.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - shipped to the test
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(job: str, n: int, payload: dict) -> list:
    """Each rank's result of ``JOBS[job]`` in a world of ``n`` ranks.

    Raises:
        RuntimeError: a rank failed (its traceback in the message).
    """
    from repro_torch.launch.mesh import free_port
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, n, port, payload, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(n):
            rank, status, out = queue.get(timeout=TIMEOUT_S)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(n)]


# -- jobs ---------------------------------------------------------------------
def _sub_mesh(n_ranks: int, world: int):
    """A data mesh over world ranks ``0..n_ranks-1`` (every rank calls
    this, in step); None on a rank outside it."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n_ranks, 1), ("data", "model"),
                     devices=list(range(n_ranks)))


def _trajectory(mesh, case: dict) -> dict:
    import torch

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core import steps
    from repro_torch.data.pipeline import LMStream, to_device
    from repro_torch.optim.optimizers import OptConfig
    name = case["name"]
    cfg = get_config(case["arch"], tiny=True)
    step = steps.make_train_step(
        cfg, steps.Strategy(name=name, opt=OptConfig(lr=case["lr"])),
        mesh=mesh, shape={"global_batch": case["batch"],
                          "seq_len": case["seq"]})
    params, opt = step.init(torch.Generator().manual_seed(0), "cpu")
    if case.get("params") is not None:
        params = bridge.params_from_numpy(case["params"], cfg, "cpu")
    stream = LMStream(vocab=cfg.vocab, batch=case["batch"], seq=case["seq"],
                      seed=case["stream_seed"])
    out = {"loss": [], "grad_norm": [], "bucket0": None}
    if case.get("onebit_bufs") is not None:
        # one exchange of the reference's fixed gradient buckets
        from repro_torch.optim import compression
        buf = case["onebit_bufs"][mesh.rank]
        plan = compression.make_plan({"g": torch.zeros(len(buf))},
                                     mesh.dp_size)
        got = {}

        def keep(i, packed, scales, mean, own):
            got[i] = (packed.numpy().copy(), scales.numpy().copy(),
                      mean.numpy().copy())
        compression.exchange_onebit(
            {"g": torch.from_numpy(buf)},
            compression.init_error_state(plan), mesh, plan, on_bucket=keep)
        out["bucket0"] = got[0]
    for it in range(case["steps"]):
        m, params, opt = step.fn(params, opt,
                                 to_device(stream.batch_at(it), "cpu"))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


def job_trajectories(rank: int, n: int, payload: dict) -> dict:
    """Each case of ``payload["cases"]`` (dicts with ``key``, ``name``,
    ``ndp`` and the run's ``arch``, ``lr``, ``batch``, ``seq``,
    ``stream_seed``, ``steps``, optional ``params`` and ``onebit_bufs``)
    on a mesh over the world's first ``ndp`` ranks, the others waiting;
    an ``ndp`` of 1 runs on rank 0 alone."""
    import torch.distributed as dist
    out = {}
    for case in payload["cases"]:
        ndp = case["ndp"]
        mesh = _sub_mesh(ndp, n) if ndp > 1 else None
        if (ndp > 1 and mesh is None) or (ndp == 1 and rank != 0):
            continue
        out[case["key"]] = _trajectory(mesh, case)
    dist.barrier()
    return out


def job_collectives(rank: int, n: int, payload: dict) -> dict:
    """The collectives of ``core/collectives.py`` on seeded inputs (rank
    ``r`` holds row ``r`` of each input), with the ring's hop count."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(data=n)
    x = {k: torch.from_numpy(v[rank]) for k, v in payload.items()}
    tree = {"a": x["a"], "b": x["b"]}
    out = {"naive": {k: v.numpy() for k, v in
                     collectives.naive_psum(tree, mesh).items()},
           "fused": {k: v.numpy() for k, v in collectives.fused_psum(
               tree, mesh, cap_bytes=64).items()}}
    collectives.reset_stats()
    out["ring"] = {k: collectives.ring_all_reduce(v, mesh).numpy()
                   for k, v in tree.items()}
    out["ring_hops"] = collectives.stats()["hops"]
    out["halo"] = collectives.halo_exchange(x["halo"], mesh, 1).numpy()
    lg, v = x["logits"], x["values"]
    m = lg.max()[None]
    w = torch.exp(lg - m)
    out["combine"] = collectives.softmax_combine(
        (m, w.sum()[None], w @ v), mesh).numpy()
    out["scatter"] = collectives.reduce_scatter(x["rs"], mesh).numpy()
    out["gather"] = collectives.all_gather(x["rs"], mesh).numpy()
    out["shift"] = collectives.pipeline_shift(x["b"], mesh).numpy()
    out["shift_back"] = collectives.pipeline_shift(
        x["b"], mesh, reverse=True).numpy()
    out["pmean"] = collectives.pmean(x["b"], mesh).numpy()
    return out


JOBS = {"trajectories": job_trajectories, "collectives": job_collectives}


# -- fault hooks (shipped to worker ranks by reference) -----------------------
def with_fault_hook(session, hook) -> None:
    """Give ``session``'s next ``train`` calls ``hook`` as
    ``ResilientRunner``'s ``fault_hook`` on every rank (the port's test
    seam, kept out of ``Session.train``'s signature)."""
    session._fault_hook = hook


class NanOnRank:
    """``ResilientRunner.fault_hook``: on world rank ``rank``, the first
    ``n`` step results get a NaN loss (every other rank's pass)."""

    def __init__(self, rank: int, n: int = 1):
        self.rank, self.n, self.calls = rank, n, 0

    def __call__(self, out):
        import torch
        import torch.distributed as dist
        me = dist.get_rank() if dist.is_initialized() else 0
        if me != self.rank or self.calls >= self.n:
            return out
        self.calls += 1
        metrics, params, opt = out
        return dict(metrics, loss=torch.full_like(metrics["loss"],
                                                  float("nan"))), params, opt


def seeded(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
