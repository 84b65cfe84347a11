#!/usr/bin/env python3
"""How far the moe and zamba families part from themselves on a model
axis: the witness for the tolerances with which
``tests/test_torch_model_axis_families.py`` and ``chip_smoke.py`` hold
them (CPU only).

    python3 tools/model_axis_families_check.py jax-self
    python3 tools/model_axis_families_check.py mesh-f32
    python3 tools/model_axis_families_check.py bf16

``jax-self``: the JAX package's own tiny granite-moe-1b-a400m and tiny
zamba2-2.7b, the loss and every gradient on one host device and on a
``model=4`` mesh of four (``XLA_FLAGS`` sets them), from ``PRNGKey(0)``
on one seeded 8 x 16 batch: each leaf's largest difference over the
largest |gradient| of all leaves and over its own.

``mesh-f32``: the port's granite-moe-1b-a400m at full width, 1 layer,
float32, one 1 x 256 batch from seed 0: three momentum steps on two gloo
rank processes at ``model=2`` and in one process, each step's loss and
gradient norm.

``bf16``: the port's zamba2-2.7b cut to d_model 1024 (16 attention
heads of 64, 32 mamba heads), 6 layers: the prefill logits of two 64
token prompts in bf16 and float32 compute, in one process and at
``model=2``; the mean relative error of each pair.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def jax_self() -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.core.sharding import (default_rules, init_params,
                                     param_shardings, set_act_hook)
    from repro.launch.mesh import make_local_mesh
    from repro.models.model import build_model
    for arch in ("granite-moe-1b-a400m", "zamba2-2.7b"):
        cfg = get_config(arch, tiny=True)
        model = build_model(cfg)
        specs = model.specs()
        params = init_params(specs, jax.random.PRNGKey(0))
        rng = np.random.default_rng(5)
        batch = {k: jnp.asarray(rng.integers(0, cfg.vocab, (8, 16)),
                                jnp.int32) for k in ("tokens", "labels")}
        _, g1 = jax.jit(jax.value_and_grad(model.loss))(params, batch)
        mesh, rules = make_local_mesh(model=4), default_rules()
        sh = param_shardings(specs, mesh, rules)
        set_act_hook(mesh, rules)
        _, g4 = jax.jit(jax.value_and_grad(model.loss),
                        in_shardings=(sh, None))(jax.device_put(params, sh),
                                                 batch)
        set_act_hook(None, None)
        a = [np.asarray(x) for x in jax.tree.leaves(g1)]
        b = [np.asarray(x) for x in jax.tree.leaves(g4)]
        scale = max(np.abs(x).max() for x in a)
        names = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(g1)[0]]
        print(f"{arch}: one device against model=4, of the largest "
              f"|gradient| {scale:.4g}")
        for n, x, y in zip(names, a, b):
            d = np.abs(x - y).max()
            print(f"  {n:48s} {d / scale:.3e} of all, "
                  f"{d / max(np.abs(x).max(), 1e-30):.3e} of its own")


def _port(fn, *args) -> list:
    """``fn(rank, 2, *args)`` on two gloo rank processes (spawned), each
    rank's result."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [ctx.Process(target=_rank, args=(fn, r, port, args, q))
             for r in range(2)]
    for p in procs:
        p.start()
    out = dict(q.get(timeout=1800) for _ in procs)
    for p in procs:
        p.join()
    return [out[r] for r in range(2)]


def _rank(fn, rank, port, args, q) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=900))
    q.put((rank, fn(rank, *args)))
    dist.barrier()
    dist.destroy_process_group()


def _mesh_f32(rank: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import steps
    from repro_torch.data.pipeline import stream_for, to_device
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.optimizers import OptConfig
    import torch
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=1, compute_dtype="f32")
    strategy = steps.Strategy(opt=OptConfig(kind="momentum"))
    batch = to_device(stream_for(cfg, batch=1, seq=256, seed=0).batch_at(0),
                      "cpu")
    out = {}
    for name, mesh in (("model=2", make_local_mesh(model=2)),
                       ("one process", None)):
        if mesh is None and rank:
            continue
        step = steps.make_train_step(cfg, strategy, mesh=mesh, shape={
            "global_batch": 1, "seq_len": 256})
        params, opt = step.init(torch.Generator().manual_seed(0), "cpu")
        out[name] = []
        for _ in range(3):
            m, params, opt = step.fn(params, opt, batch)
            out[name].append((float(m["loss"]), float(m["grad_norm"])))
    return out


def mesh_f32() -> None:
    got = _port(_mesh_f32)[0]
    for name, rows in got.items():
        print(f"{name:12s} " + "  ".join(f"loss {l:.7f} norm {n:.7f}"
                                         for l, n in rows))
    for (l1, n1), (l2, n2) in zip(got["model=2"], got["one process"]):
        print(f"relative: loss {abs(l1 - l2) / abs(l2):.2e}, norm "
              f"{abs(n1 - n2) / abs(n2):.2e}")


def _bf16(rank: int) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.sharding import init_params, shard_tree
    from repro_torch.core.steps import make_prefill_step
    from repro_torch.launch.mesh import make_local_mesh
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=6,
                              d_model=1024, n_heads=16, n_kv_heads=16,
                              head_dim=64)
    mesh = make_local_mesh(model=2)
    shape = {"seq_len": 72, "global_batch": 2}
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(3))
    out = {}
    for cd in ("bf16", "f32"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        one = make_prefill_step(c, shape)
        params = init_params(one.specs, torch.Generator().manual_seed(1),
                             "cpu")
        split = make_prefill_step(c, shape, mesh=mesh)
        mine = shard_tree(params, split.specs, mesh, split.rules, "cpu")
        with torch.no_grad():
            lg1 = one.fn(params, {"tokens": toks})[0].float()
            lg2 = split.gather_logits(
                split.fn(mine, {"tokens": toks})[0]).float()
        out[cd] = (lg1, lg2)
    return out


def bf16() -> None:
    got = _port(_bf16)[0]

    def mre(a, b):
        return float((a - b).abs().mean() / b.abs().mean())
    print(f"one process, bf16 against float32: "
          f"{mre(got['bf16'][0], got['f32'][0]):.3e}")
    print(f"model=2 against one process, bf16: "
          f"{mre(got['bf16'][1], got['bf16'][0]):.3e}")
    print(f"model=2 against one process, float32: "
          f"{mre(got['f32'][1], got['f32'][0]):.3e}")


if __name__ == "__main__":
    modes = {"jax-self": jax_self, "mesh-f32": mesh_f32, "bf16": bf16}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    modes[sys.argv[1]]()
