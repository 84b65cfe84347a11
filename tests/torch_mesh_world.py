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

    import torch.distributed as dist

    import torch_threads
    torch_threads.apply(torch_threads.RANK)
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


def _digest(t) -> str:
    import hashlib
    return hashlib.blake2b(t.detach().cpu().contiguous().numpy().tobytes(),
                           digest_size=8).hexdigest()


def _tp_grads(mesh, cfg, params_np, batch_np) -> dict:
    """Loss and the gathered gradient of every leaf (reference layout)."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import bridge
    from repro_torch.core import steps
    from repro_torch.core.sharding import ModelAxis, act_hook, gather_tree
    step = steps.make_train_step(cfg, steps.Strategy(), mesh=mesh)
    params = bridge.params_from_numpy(params_np, cfg, "cpu", mesh=mesh)
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    with act_hook(mesh, step.rules):
        loss = step.model.loss(params, batch)
        loss.backward()
    grads = pytree.tree_map(lambda p: p.grad, params)
    grads = steps._sum_partials(
        grads, step.model.partial_mask(step.specs, ModelAxis(mesh,
                                                             step.rules)),
        mesh)
    whole = gather_tree(grads, step.specs, mesh, step.rules)
    return {"loss": float(loss.detach()),
            "grads": bridge.tree_to_numpy(whole)}


def _replicated_digests(step, params) -> list:
    """The digests of this rank's leaves that no rule splits over the
    model axis, in leaf order."""
    import torch.utils._pytree as pytree
    return [_digest(p) for p, m in zip(pytree.tree_leaves(params),
                                       pytree.tree_leaves(step.split_mask))
            if not m]


def _tp_trajectory(mesh, cfg, case: dict) -> dict:
    import torch

    from repro_torch import bridge
    from repro_torch.core import steps
    from repro_torch.data.pipeline import stream_for, to_device
    from repro_torch.optim.optimizers import OptConfig
    step = steps.make_train_step(
        cfg, steps.Strategy(name=case["name"], opt=OptConfig(
            kind=case.get("opt", "adamw"), lr=case["lr"]),
            sequence_parallel=case.get("sp", False)),
        mesh=mesh, shape={"global_batch": case["batch"],
                          "seq_len": case["seq"]})
    _, opt = step.init(torch.Generator().manual_seed(0), "cpu")
    params = bridge.params_from_numpy(case["params"], cfg, "cpu", mesh=mesh)
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_(True)
    stream = stream_for(cfg, batch=case["batch"], seq=case["seq"], seed=0)
    out = {"loss": [], "grad_norm": [], "replicated": []}
    for it in range(case["steps"]):
        m, params, opt = step.fn(params, opt,
                                 to_device(stream.batch_at(it), "cpu"))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["replicated"].append(_replicated_digests(step, params))
    return out


def _vocab_checks(mesh) -> dict:
    """The vocab-parallel cross entropy (loss and the logits' gradient)
    and greedy argmax on this rank's columns, and their plain versions on
    the whole logits (seeded; a tie planted across two shards)."""
    import torch

    from repro_torch.core.sharding import act_hook, default_rules
    from repro_torch.models import layers
    V, n = 64, mesh.model_size
    lg = torch.from_numpy(seeded((3, 5, V), 11))
    labels = torch.from_numpy(
        np.random.default_rng(12).integers(0, V, (3, 5)))
    # row (0, 0): the max at column 3 (shard 0) and 40 (a later shard)
    lg[0, 0, 3] = lg[0, 0, 40] = lg[0, 0].max() + 1.0
    mask = torch.from_numpy((seeded((3, 5), 13) > -0.5).astype(np.float32))
    blk = slice(mesh.model_rank * V // n, (mesh.model_rank + 1) * V // n)
    mine = lg[..., blk].clone().requires_grad_(True)
    with act_hook(mesh, default_rules()):
        loss = layers.softmax_xent(mine, labels, mask, vocab=V)
        loss.backward()
        tok = layers.greedy(mine.detach(), vocab=V)
        whole = layers.gather_vocab(mine.detach(), vocab=V)
    ref = lg.clone().requires_grad_(True)
    want = layers.softmax_xent(ref, labels, mask)
    want.backward()
    return {"loss": float(loss.detach()), "want": float(want.detach()),
            "grad": mine.grad.numpy(), "want_grad": ref.grad[..., blk].numpy(),
            "tok": tok.numpy(), "want_tok": lg.argmax(-1).numpy(),
            "gathered": bool(torch.equal(whole, lg))}


def _tp_checkpoints(mesh, cfg, payload: dict) -> dict:
    """zero1 at ``mesh``: 2 steps from the reference's init, saved (rank
    0) to ``payload["dir_a"]`` in the global layout; then the model=1
    checkpoint ``payload["dir_b"]`` restored on the mesh, each rank's
    parameter blocks and zero1 state returned, and gathered back."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import bridge
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import steps
    from repro_torch.data.pipeline import LMStream, to_device
    step = steps.make_train_step(cfg, steps.Strategy(name="zero1"),
                                 mesh=mesh, shape={"global_batch": 8,
                                                   "seq_len": 16})
    _, opt = step.init(torch.Generator().manual_seed(0), "cpu")
    params = bridge.params_from_numpy(payload["params"], cfg, "cpu",
                                      mesh=mesh)
    stream = LMStream(vocab=cfg.vocab, batch=8, seq=16, seed=0)
    for it in range(2):
        _, params, opt = step.fn(params, opt,
                                 to_device(stream.batch_at(it), "cpu"))
    state = (step.gather_params(params), step.gather_opt(opt))
    # host_leaves on the mesh gathers the same global leaves
    names_m, arrays_m = bridge.host_leaves(params, mesh=mesh,
                                           specs=step.specs)
    host_gathers = [_digest(torch.from_numpy(a)) for a in arrays_m] == [
        _digest(torch.from_numpy(a))
        for a in bridge.host_leaves(state[0])[1]]
    if mesh.rank == 0 and mesh.model_rank == 0:
        with CheckpointManager(payload["dir_a"], async_save=False,
                               spmd=False) as cm:
            cm.save(2, state)
    names, arrays = bridge.host_leaves(state)
    saved = {n: _digest(torch.from_numpy(a)) for n, a in zip(names, arrays)}
    with CheckpointManager(payload["dir_b"], async_save=False,
                           spmd=False) as cm:
        _, (pg, og) = cm.restore((step.params_like(), step.global_like()))
    params_b = step.shard_params(pg, "cpu")
    opt_b = step.shard_opt(og, "cpu")
    back = (step.gather_params(params_b), step.gather_opt(opt_b))
    names, arrays = bridge.host_leaves(back)
    return {"saved": saved, "host_gathers": host_gathers,
            "round_trip": {n: _digest(torch.from_numpy(a))
                           for n, a in zip(names, arrays)},
            "blocks": bridge.tree_to_numpy(pytree.tree_map(
                lambda t: t.detach(), params_b)),
            "coords": dict(mesh.coords)}


def job_tensor_parallel(rank: int, n: int, payload: dict) -> dict:
    """The model-axis checks of ``tests/test_torch_tensor_parallel.py`` on
    a world of 4: the layout of ``make_local_mesh(data=2, model=2)``, the
    gradients at model 2 (ranks 0, 1) and 4, the strategies' trajectories
    (``payload["cases"]``), the vocab-parallel loss and argmax, and the
    checkpoints."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    cfg = get_config(payload["arch"], tiny=True)
    out: dict = {}
    mesh22 = make_local_mesh(data=2, model=2)
    out["layout"] = {"coords": dict(mesh22.coords), "ranks": mesh22.ranks,
                     "model_ranks": mesh22.model_ranks}
    mesh14 = make_local_mesh(model=4)
    mesh12 = make_mesh((1, 2), ("data", "model"), devices=[0, 1])
    out["grads"] = {}
    for m, mesh in ((2, mesh12), (4, mesh14)):
        if mesh is not None:
            out["grads"][m] = _tp_grads(mesh, cfg, payload["params"],
                                        payload["batch"])
    out["cases"] = {}
    for case in payload["cases"]:
        mesh = mesh22 if case["mesh"] == (2, 2) else mesh14
        out["cases"][case["key"]] = _tp_trajectory(
            mesh, cfg, dict(case, params=payload["params"]))
    out["vocab"] = _vocab_checks(mesh14)
    out["ckpt"] = _tp_checkpoints(mesh22, cfg, payload)
    dist.barrier()
    return out


def _sp_grads(mesh, cfg, params_np, batch_np, sp: bool = True) -> dict:
    """The loss and every leaf's gradient of the global batch (each dp
    rank's rows, averaged over the dp group), gathered to the reference's
    layout, with or without sequence parallelism; and the residual's
    split (``seq``)."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import bridge
    from repro_torch.core import collectives, steps
    from repro_torch.core.sharding import ModelAxis, act_hook, gather_tree
    step = steps.make_train_step(
        cfg, steps.Strategy(sequence_parallel=sp), mesh=mesh)
    params = bridge.params_from_numpy(params_np, cfg, "cpu", mesh=mesh)
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    batch = steps.batch_rows(
        {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
         else torch.from_numpy(v) for k, v in batch_np.items()}, mesh)
    seq = steps.residual_seq(cfg, mesh, step.rules, batch)
    with act_hook(mesh, step.rules, seq_len=seq):
        loss = step.model.loss(params, batch)
        loss.backward()
    # a leaf the loss never reads (whisper's cross bk, bv) gets zeros, as
    # jax.grad gives
    ax = ModelAxis(mesh, step.rules, seq_len=seq)
    grads = steps._sum_partials(
        pytree.tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                        else p.grad, params),
        step.model.partial_mask(step.specs, ax) if "frames" not in batch
        else step.model.partial_mask(step.specs, ax,
                                     enc_len=batch["frames"].shape[1]),
        mesh)
    grads = pytree.tree_map(lambda g: collectives.pmean(g, mesh), grads)
    whole = gather_tree(grads, step.specs, mesh, step.rules)
    return {"loss": float(collectives.pmean(loss.detach(), mesh)),
            "grads": bridge.tree_to_numpy(whole), "seq": seq}


def _sp_pairs(mesh) -> dict:
    """``all_gather_seq`` and ``reduce_scatter_seq`` forward and backward
    on seeded ``[2, 4M, 3]`` tensors (rank ``r``'s own seeds ``100 + r``,
    ``200 + r``), with their plain one-process versions: the whole
    tensor, and sums over the ranks' seeds cut to this rank's rows."""
    import torch

    from repro_torch.core import collectives
    n, r = mesh.model_size, mesh.model_rank
    shape = (2, 4 * n, 3)
    blk = slice(r * 4, (r + 1) * 4)
    x = torch.from_numpy(seeded(shape, 7))
    mine = x[:, blk].clone().requires_grad_(True)
    y = collectives.all_gather_seq(mine, mesh)
    y.backward(torch.from_numpy(seeded(shape, 100 + r)))
    part = torch.from_numpy(seeded(shape, 200 + r)).requires_grad_(True)
    z = collectives.reduce_scatter_seq(part, mesh)
    gz = seeded((2, 4, 3), 300 + r)
    z.backward(torch.from_numpy(gz))
    return {
        "gather": y.detach().numpy(), "gather_want": x.numpy(),
        "gather_grad": mine.grad.numpy(),
        "gather_grad_want": sum(seeded(shape, 100 + k)
                                for k in range(n))[:, blk],
        "scatter": z.detach().numpy(),
        "scatter_want": sum(seeded(shape, 200 + k)
                            for k in range(n))[:, blk],
        "scatter_grad": part.grad.numpy(),
        "scatter_grad_want": np.concatenate(
            [seeded((2, 4, 3), 300 + k) for k in range(n)], axis=1)}


def _tiled(mesh, x_np) -> dict:
    """``TiledArray`` on ``mesh`` of the seeded ``[B, S, D]`` array under
    the default rules and sequence parallelism's: each plan's tile,
    spec and shapes, its ``seq`` halo of 1, and whether ``retile`` and
    ``replicated`` give the tiles and the array bit for bit."""
    import torch

    from repro_torch.core.dist_array import TiledArray
    from repro_torch.core.sharding import default_rules
    x = torch.from_numpy(x_np)
    dims = ("batch", "seq", "embed")
    rules = {"default": default_rules(),
             "sp": default_rules(sequence_parallel=True)}
    tiles = {k: TiledArray.tile(x, dims, mesh, r) for k, r in rules.items()}
    out = {k: {"data": t.data.numpy(), "tile_shape": list(t.tile_shape()),
               "global_shape": list(t.global_shape),
               "spec": [list(p) if isinstance(p, tuple) else p
                        for p in t.spec],
               "halo": t.with_halo("seq", 1).numpy()}
           for k, t in tiles.items()}
    to_sp = tiles["default"].retile(rules["sp"])
    back = tiles["sp"].retile(rules["default"])
    out["retile"] = bool(torch.equal(to_sp.data, tiles["sp"].data)) and \
        bool(torch.equal(back.data, tiles["default"].data)) and \
        to_sp.global_shape == tiles["sp"].global_shape
    out["replicated"] = all(
        torch.equal(t.replicated().data, x) and
        t.replicated().tile_shape() == tuple(x.shape)
        for t in tiles.values())
    return out


def job_seq_parallel(rank: int, n: int, payload: dict) -> dict:
    """The sequence-parallel checks of ``tests/test_torch_seq_parallel.py``
    on a world of 4: the gradients at ``data=2, model=2`` and ``model=4``
    with sequence parallelism (and at ``model=4`` without), the
    strategies' trajectories (``payload["cases"]``), the two autograd
    pairs, and ``TiledArray`` on the ``data=2, model=2`` mesh."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    cfg = get_config(payload["arch"], tiny=True)
    mesh22 = make_local_mesh(data=2, model=2)
    mesh14 = make_local_mesh(model=4)
    meshes = {(2, 2): mesh22, (1, 4): mesh14}
    out: dict = {"grads": {
        "2x2": _sp_grads(mesh22, cfg, payload["params"], payload["batch"]),
        "1x4": _sp_grads(mesh14, cfg, payload["params"], payload["batch"]),
        "1x4 plain": _sp_grads(mesh14, cfg, payload["params"],
                               payload["batch"], sp=False)}}
    out["cases"] = {}
    for case in payload["cases"]:
        c = cfg if case.get("d_ff") is None else \
            dataclasses.replace(cfg, d_ff=case["d_ff"])
        out["cases"][case["key"]] = _tp_trajectory(
            meshes[tuple(case["mesh"])], c,
            dict(case, params=case.get("params", payload["params"])))
    out["pairs"] = {2: _sp_pairs(mesh22), 4: _sp_pairs(mesh14)}
    out["tiled"] = _tiled(mesh22, payload["tiled"])
    dist.barrier()
    return out


def _tanh_stage(w, x):
    """The reference test's stage: ``tanh(x @ W)``."""
    import torch
    return torch.tanh(x @ w)


def _sequential(ws, x):
    import torch
    for s in range(ws.shape[0]):
        x = torch.tanh(x @ ws[s])
    return x


def _gpipe_case(mesh, ws_np, x_np, own_slice: bool = False) -> dict:
    """The reference test's program on the stage mesh: the outputs and
    the gradient of ``mean(y ** 2)`` with respect to the stacked weights
    (each rank's slice, gathered over the stage group) and to the input,
    beside a sequential loop's on the same tensors."""
    import torch

    from repro_torch.core import collectives, pipeline
    ws, x = torch.from_numpy(ws_np), torch.from_numpy(x_np)
    s = mesh.stage_rank
    fn = pipeline.make_pipeline_fn(_tanh_stage, mesh)
    w = (ws[s:s + 1] if own_slice else ws).clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y = fn(w, xg)
    (y ** 2).mean().backward()
    gw = w.grad if own_slice else w.grad[s:s + 1]
    wr = ws.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    ref = _sequential(wr, xr)
    (ref ** 2).mean().backward()
    return {"y": y.detach().numpy(), "seq_y": ref.detach().numpy(),
            "grad": collectives.all_gather(gw, mesh,
                                           mesh_axis="stage").numpy(),
            "seq_grad": wr.grad.numpy(), "x_grad": xg.grad.numpy(),
            "seq_x_grad": xr.grad.numpy(),
            "others_zero": bool(own_slice or not any(
                w.grad[k].any() for k in range(ws.shape[0]) if k != s))}


def _block_stage(cfg):
    def stage_fn(p, x):
        import torch.utils._pytree as pytree

        from repro_torch.models import blocks
        for i in range(p["ln_attn"]["w"].shape[0]):
            x = blocks.tblock_apply(x, pytree.tree_map(lambda t: t[i], p),
                                    cfg)[0]
        return x
    return stage_fn


def _block_pipeline(mesh, payload) -> dict:
    """GPipe over tiny qwen3-4b decoder blocks: each stage applies its
    ``[S, L, ...]`` slice's L layers with ``tblock_apply``; the outputs
    and the gradient of ``mean(y ** 2)`` with respect to every stage
    leaf, gathered over the stage group."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.core import collectives, pipeline
    cfg = get_config(payload["arch"], tiny=True)
    s = mesh.stage_rank
    stack = pytree.tree_map(
        lambda a: torch.from_numpy(a[s:s + 1]).requires_grad_(True),
        payload["blocks"])
    fn = pipeline.make_pipeline_fn(_block_stage(cfg), mesh)
    y = fn(stack, torch.from_numpy(payload["block_x"]))
    (y ** 2).mean().backward()
    grads = pytree.tree_map(
        lambda t: collectives.all_gather(t.grad, mesh,
                                         mesh_axis="stage").numpy(), stack)
    return {"y": y.detach().numpy(), "grads": grads}


def job_pipeline(rank: int, n: int, payload: dict) -> dict:
    """The GPipe checks of ``tests/test_torch_pipeline.py`` on a stage
    mesh of the world's ``n`` ranks: the reference test's program at
    each ``payload["micro"]`` count (the global stack, and at the first
    count each rank's own slice), the decoder-block pipeline, and
    ``pipeline_shift``'s backward."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((n,), ("stage",))
    ws = payload["ws"]
    out = {"layout": {"coords": dict(mesh.coords),
                      "stage_ranks": mesh.stage_ranks,
                      "shape": dict(mesh.shape)}}
    out["gpipe"] = {m: _gpipe_case(mesh, ws, x) for m, x in
                    payload["micro"].items()}
    m0 = next(iter(payload["micro"]))
    out["own_slice"] = _gpipe_case(mesh, ws, payload["micro"][m0],
                                   own_slice=True)
    out["blocks"] = _block_pipeline(mesh, payload)
    x = torch.from_numpy(seeded((3, 5), 40 + rank)).requires_grad_(True)
    y = collectives.pipeline_shift(x, mesh, mesh_axis="stage")
    y.backward(torch.from_numpy(seeded((3, 5), 50 + rank)))
    out["shift"] = {"y": y.detach().numpy(), "grad": x.grad.numpy()}
    dist.barrier()
    return out


def _family_cfg(arch: str, over: dict):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, tiny=True), **over)


def _gather_pairs(mesh) -> dict:
    """``gather_from_model`` and ``sum_over_model`` forward and backward
    on seeded ``[3, 2M]`` tensors (rank ``r``'s own seeds ``500 + r``,
    ``600 + r``), with their plain one-process versions."""
    import torch

    from repro_torch.core import collectives
    n, r = mesh.model_size, mesh.model_rank
    x = torch.from_numpy(seeded((3, 2 * n), 8))
    mine = x[:, 2 * r:2 * r + 2].clone().requires_grad_(True)
    y = collectives.gather_from_model(mine, mesh, -1)
    y.backward(torch.from_numpy(seeded((3, 2 * n), 500 + r)))
    part = torch.from_numpy(seeded((3, 4), 600 + r)).requires_grad_(True)
    z = collectives.sum_over_model(part, mesh)
    z.backward(torch.from_numpy(seeded((3, 4), 700 + r)))
    return {
        "gather": y.detach().numpy(), "gather_want": x.numpy(),
        "gather_grad": mine.grad.numpy(),
        "gather_grad_want": seeded((3, 2 * n), 500 + r)[:, 2 * r:2 * r + 2],
        "sum": z.detach().numpy(),
        "sum_want": sum(seeded((3, 4), 600 + k) for k in range(n)),
        "sum_grad": part.grad.numpy(),
        "sum_grad_want": sum(seeded((3, 4), 700 + k) for k in range(n))}


def job_model_axis_families(rank: int, n: int, payload: dict) -> dict:
    """The checks of ``tests/test_torch_model_axis_families.py`` on a
    world of 4: the loss and gathered gradients of each ``grad_cases``
    key ``cfg@mesh`` (``payload["cfgs"][cfg]`` an ``(arch, overrides)``
    pair, its parameters and batch in ``payload["params"]`` and
    ``payload["batch"]``), the strategies' trajectories
    (``payload["cases"]``), and the two new autograd pairs."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    meshes = {"2x2": make_local_mesh(data=2, model=2),
              "1x4": make_local_mesh(model=4)}
    out: dict = {"grads": {}, "cases": {}}
    for key in payload["grad_cases"]:
        c, m = key.split("@")
        out["grads"][key] = _sp_grads(
            meshes[m], _family_cfg(*payload["cfgs"][c]), payload["params"][c],
            payload["batch"][c], sp=False)
    for case in payload["cases"]:
        c, m = case["cfg"], case["mesh"]
        out["cases"][case["key"]] = _tp_trajectory(
            meshes[m], _family_cfg(*payload["cfgs"][c]),
            dict(case, params=payload["params"][c]))
    out["pairs"] = {k: _gather_pairs(v) for k, v in meshes.items()}
    dist.barrier()
    return out


def job_model_axis_xlstm_encdec(rank: int, n: int, payload: dict) -> dict:
    """The checks of ``tests/test_torch_model_axis_xlstm_encdec.py`` on a
    world of 4, as ``job_model_axis_families``'s: the loss and gathered
    gradients of each ``grad_cases`` key at ``payload["grad_params"]``
    (rank 0 returns them, every rank their digests) and the strategies'
    trajectories from ``payload["params"]``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    meshes = {"2x2": make_local_mesh(data=2, model=2),
              "1x4": make_local_mesh(model=4)}
    out: dict = {"grads": {}, "cases": {}}
    for key in payload["grad_cases"]:
        c, m = key.split("@")
        got = _sp_grads(meshes[m], _family_cfg(*payload["cfgs"][c]),
                        payload["grad_params"][c], payload["batch"][c],
                        sp=False)
        leaves = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                  _np_leaves(got["grads"])]
        got["digests"] = [_digest(t) for t in leaves]
        if rank:
            del got["grads"]
        out["grads"][key] = got
    for case in payload["cases"]:
        c, m = case["cfg"], case["mesh"]
        out["cases"][case["key"]] = _tp_trajectory(
            meshes[m], _family_cfg(*payload["cfgs"][c]),
            dict(case, params=payload["params"][c]))
    dist.barrier()
    return out


def job_seq_parallel_families(rank: int, n: int, payload: dict) -> dict:
    """The checks of ``tests/test_torch_seq_parallel_families.py`` on a
    world of 4: for each ``grad_cases`` key ``cfg@mesh[ plain]`` the loss
    and gathered gradients with sequence parallelism (without it for
    ``plain``) at ``payload["grad_params"][cfg]`` of
    ``payload["batch"][cfg]`` (``payload["odd"][cfg]`` for
    an ``@...odd`` key: a sequence the model axis does not divide; rank
    0 returns them, every rank their digests), and the strategies'
    trajectories with it; meshes ``2x2``, ``1x4`` and ``1x2`` (the
    world's ranks 0 and 1)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    meshes = {"2x2": make_local_mesh(data=2, model=2),
              "1x4": make_local_mesh(model=4),
              "1x2": make_mesh((1, 2), ("data", "model"), devices=[0, 1])}
    out: dict = {"grads": {}, "cases": {}}
    for key in payload["grad_cases"]:
        c, m = key.split(" ")[0].split("@")
        odd = m.endswith("odd")
        mesh = meshes[m[:-len("odd")] if odd else m]
        if mesh is None:
            continue
        got = _sp_grads(mesh, _family_cfg(*payload["cfgs"][c]),
                        payload["grad_params"][c],
                        payload["odd" if odd else "batch"][c],
                        sp=not key.endswith(" plain"))
        leaves = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                  _np_leaves(got["grads"])]
        got["digests"] = [_digest(t) for t in leaves]
        if rank:
            del got["grads"]
        out["grads"][key] = got
    for case in payload["cases"]:
        c, m = case["cfg"], case["mesh"]
        if meshes[m] is None:
            continue
        out["cases"][case["key"]] = _tp_trajectory(
            meshes[m], _family_cfg(*payload["cfgs"][c]),
            dict(case, params=payload["params"][c], sp=True))
    dist.barrier()
    return out


def _cnn_grads(mesh, params_np, batch_np) -> dict:
    """The HAR CNN's loss and every gradient (gathered) on ``mesh``:
    this rank's blocks of the channels, its dp rows of the batch, the
    loss and gradients averaged over the dp group; the digests of this
    rank's head gradients."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import bridge
    from repro_torch.core import collectives, steps
    from repro_torch.core.sharding import act_hook, default_rules, \
        gather_tree, shard_tree
    from repro_torch.models.cnn import har_cnn_loss, har_cnn_specs
    specs, rules = har_cnn_specs(), default_rules()
    glob = pytree.tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                           params_np)
    params = shard_tree(glob, specs, mesh, rules)
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    batch = steps.batch_rows({"x": torch.from_numpy(batch_np["x"]),
                              "y": torch.from_numpy(batch_np["y"])}, mesh)
    collectives.reset_stats()
    with act_hook(mesh, rules):
        loss = har_cnn_loss(params, batch)
        loss.backward()
    wire = collectives.stats()["axes"]["model"]
    grads = pytree.tree_map(lambda p: collectives.pmean(p.grad, mesh),
                            params)
    whole = gather_tree(grads, specs, mesh, rules)
    return {"loss": float(collectives.pmean(loss.detach(), mesh)),
            "grads": bridge.tree_to_numpy(whole),
            "head": [_digest(grads["head"][k]) for k in ("w", "b")],
            "conv1_rows": int(params["conv1"]["b"].shape[0]),
            "model_calls": wire["calls"]}


def _onebit_exchange(mesh, cfg, grads_np: list) -> dict:
    """One ``exchange_onebit`` on ``mesh`` of dp rank ``r``'s global
    gradient tree ``grads_np[r]`` (the reference's layout), this rank's
    blocks of it: every bucket's gathered words and scales, the mean and
    the new residual (rank 0 keeps them; every rank their digests), and
    this rank's blocks of the mean, gathered back."""
    import torch

    from repro_torch import bridge
    from repro_torch.core import collectives, steps
    from repro_torch.core.sharding import gather_tree
    from repro_torch.optim import compression
    step = steps.make_train_step(cfg, steps.Strategy(name="onebit"),
                                 mesh=mesh)
    grads = bridge.params_from_numpy(grads_np[mesh.rank], cfg, "cpu",
                                     mesh=mesh)
    got = {}

    def keep(i, packed, scales, mean, own):
        got[i] = [packed.numpy().copy(), scales.numpy().copy(),
                  mean.numpy().copy(), own[2].numpy().copy()]
    collectives.reset_stats()
    mean, _ = compression.exchange_onebit(
        grads, compression.init_error_state(step.plan), mesh, step.plan,
        on_bucket=keep, specs=step.specs, rules=step.rules)
    wire = collectives.stats()["axes"]
    whole = gather_tree(mean, step.specs, mesh, step.rules)
    return {"buckets": got if mesh.rank == 0 and mesh.model_rank == 0
            else None,
            "digests": {i: [_digest(torch.from_numpy(a)) for a in v]
                        for i, v in got.items()},
            "mean": bridge.tree_to_numpy(whole),
            "wire": {a: dict(wire[a]) for a in ("dp", "model")},
            "sizes": [b.size for b in step.plan.buckets],
            "totals": [b.total for b in step.plan.buckets]}


def _onebit_run(mesh, cfg, case: dict) -> dict:
    """``case["steps"]`` onebit (or ``case["name"]``) steps from the
    reference's init: losses, norms, the residuals' and the unsplit
    leaves' digests after every step; with ``case["resume_at"]`` the
    state after that step gathered to the global layout, cut again by a
    new step and trained on, and that run's losses and leaf digests."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import bridge
    from repro_torch.core import steps
    from repro_torch.data.pipeline import stream_for, to_device
    from repro_torch.optim.optimizers import OptConfig

    def build():
        return steps.make_train_step(
            cfg, steps.Strategy(name=case["name"], opt=OptConfig(
                kind=case["opt"], lr=case["lr"])),
            mesh=mesh, shape={"global_batch": case["batch"],
                              "seq_len": case["seq"]})
    step = build()
    _, opt = step.init(torch.Generator().manual_seed(0), "cpu")
    params = bridge.params_from_numpy(case["params"], cfg, "cpu", mesh=mesh)
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    stream = stream_for(cfg, batch=case["batch"], seq=case["seq"], seed=0)
    out = {"loss": [], "grad_norm": [], "ef": [], "replicated": [],
           "params": []}
    saved = None
    for it in range(case["steps"]):
        m, params, opt = step.fn(params, opt,
                                 to_device(stream.batch_at(it), "cpu"))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["ef"].append([_digest(e) for e in opt.get("ef", [])])
        out["replicated"].append(_replicated_digests(step, params))
        out["params"].append([_digest(p) for p in
                              pytree.tree_leaves(params)])
        if it + 1 == case.get("resume_at"):
            # copies: the steps after it update the state in place
            saved = pytree.tree_map(lambda t: t.clone(), (
                step.gather_params(params), step.gather_opt(opt)))
    if saved is None:
        return out
    fresh = build()
    params = fresh.shard_params(saved[0], "cpu")
    opt = fresh.shard_opt(saved[1], "cpu")
    out["resumed"] = {"loss": [], "params": []}
    for it in range(case["resume_at"], case["steps"]):
        m, params, opt = fresh.fn(params, opt,
                                  to_device(stream.batch_at(it), "cpu"))
        out["resumed"]["loss"].append(float(m["loss"]))
        out["resumed"]["params"].append([_digest(p) for p in
                                         pytree.tree_leaves(params)])
    return out


def job_cnn_onebit(rank: int, n: int, payload: dict) -> dict:
    """The checks of ``tests/test_torch_model_axis_cnn_onebit.py`` on a
    world of 4: the HAR CNN's loss and gradients at ``1x2``, ``1x4`` and
    ``2x2``; onebit's exchange of ``payload["onebit_grads"]`` at ``2x2``;
    the onebit runs of ``payload["runs"]`` (each on its ``mesh``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    meshes = {"2x2": make_local_mesh(data=2, model=2),
              "1x4": make_local_mesh(model=4),
              "1x2": make_mesh((1, 2), ("data", "model"), devices=[0, 1])}
    out: dict = {"cnn": {}, "runs": {}}
    for m in ("1x2", "1x4", "2x2"):
        if meshes[m] is not None:
            out["cnn"][m] = _cnn_grads(meshes[m], payload["cnn_params"],
                                       payload["cnn_batch"])
    cfg = _family_cfg(payload["arch"], {})
    out["exchange"] = _onebit_exchange(meshes["2x2"], cfg,
                                       payload["onebit_grads"])
    for case in payload["runs"]:
        mesh = meshes[case["mesh"]]
        if mesh is not None:
            out["runs"][case["key"]] = _onebit_run(
                mesh, cfg, dict(case, params=payload["params"]))
    dist.barrier()
    return out


def _np_leaves(tree) -> list:
    """The arrays of a nested dict in sorted key order (``jax.tree``'s)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _np_leaves(tree[k])]
    return [tree]


JOBS = {"trajectories": job_trajectories, "collectives": job_collectives,
        "tensor_parallel": job_tensor_parallel,
        "seq_parallel": job_seq_parallel, "pipeline": job_pipeline,
        "model_axis_families": job_model_axis_families,
        "model_axis_xlstm_encdec": job_model_axis_xlstm_encdec,
        "seq_parallel_families": job_seq_parallel_families,
        "cnn_onebit": job_cnn_onebit}


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
