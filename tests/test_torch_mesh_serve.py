"""Serving over a mesh with data axes (``Session.serve`` on ``Plan(data=D,
pod=P, model=M)``) against the JAX package's ``Session.serve`` on the
same mesh, weights and prompts.

* The wave loop: tiny qwen3-4b at ``data=2`` (slots 2 and 4, and 3, which
  does not divide: every rank takes every row, the reference's
  fallback), at ``pod=2`` and at ``data=2, model=2``: every wave's
  tokens, the first prefill's logits (within 1e-5 relative), ``tokens``
  and ``padded_tokens``.
* The single stream (``slots=1``): the decode cache tiled by sequence as
  ``decode_rules`` says, each rank's cache blocks checked against the
  local specs of its coordinates: tiny qwen3-4b at ``data=2`` (``kv_seq``
  on ``data``), at ``data=2, model=2`` with one kv head (``kv_seq`` on
  ``("data", "model")``: four blocks, the whole-mesh group) and at
  ``pod=2, data=2`` (``kv_seq`` on each pod's ``data`` axis), tiny
  whisper-medium (its self and cross caches both split), zamba2-2.7b and
  granite-moe-1b-a400m at ``data=2``.

One JAX subprocess with 4 host devices writes the reference's serve
parameters first, then serves every cell while the port's sessions run.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import steps
from repro_torch.frontend import Plan
from repro_torch.launch.mesh import Mesh
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
WAVES = dict(requests=5, prompt_len=18, gen_len=6)
STREAM = dict(requests=2, prompt_len=18, gen_len=6, slots=1)
ONE_KV = {"n_kv_heads": 1}
# (key, arch, overrides, mesh, serve kwargs)
CELLS = [
    ("data2-slots2", "qwen3-4b", {}, dict(data=2), dict(WAVES, slots=2)),
    ("data2-slots4", "qwen3-4b", {}, dict(data=2), dict(WAVES, slots=4)),
    ("data2-slots3", "qwen3-4b", {}, dict(data=2), dict(WAVES, slots=3)),
    ("data2-stream", "qwen3-4b", {}, dict(data=2), STREAM),
    ("pod2-slots2", "qwen3-4b", {}, dict(pod=2), dict(WAVES, slots=2)),
    ("data2-model2-slots4", "qwen3-4b", {}, dict(data=2, model=2),
     dict(WAVES, slots=4)),
    ("data2-model2-stream", "qwen3-4b", ONE_KV, dict(data=2, model=2),
     STREAM),
    ("pod2-data2-stream", "qwen3-4b", {}, dict(pod=2, data=2), STREAM),
    ("whisper-stream", "whisper-medium", {}, dict(data=2), STREAM),
    ("zamba-stream", "zamba2-2.7b", {}, dict(data=2), STREAM),
    ("granite-stream", "granite-moe-1b-a400m", {}, dict(data=2), STREAM),
]

_REF = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.core.sharding import init_params
    from repro.frontend import Plan
    spec = json.loads(sys.stdin.read())
    paths = {}
    for key, (arch, over) in spec["params"].items():
        with Plan(arch=arch, overrides=over).compile() as s:
            pre = s._serve_steps_for(8, 8, 1)[0]
            params = init_params(pre.specs, jax.random.PRNGKey(s.plan.seed))
        flat = {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
                for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
        paths[key] = os.path.join(spec["tmp"], key + ".npz")
        np.savez(paths[key], **flat)
    print("PARAMS " + json.dumps(paths), flush=True)
    out = {}
    for key, arch, over, mesh, kw in spec["cells"]:
        with Plan(arch=arch, overrides=over, **mesh).compile() as s:
            pre, dec = s._serve_steps_for(kw["prompt_len"], kw["gen_len"],
                                          kw["slots"])
            waves, first = [], []
            def wrap(fn, prefill):
                def call(*a):
                    logits, cache = fn(*a)
                    tok = np.asarray(jnp.argmax(logits, -1))
                    if prefill:
                        waves.append([tok])
                        if not first:
                            first.append(np.asarray(logits, np.float32))
                    else:
                        waves[-1].append(tok)
                    return logits, cache
                return call
            pre.fn, dec.fn = wrap(pre.fn, True), wrap(dec.fn, False)
            got = s.serve(verbose=False, **kw)
        out[key] = {"tokens": [np.stack(w, 1).tolist() for w in waves],
                    "first": first[0].tolist(), "n_tokens": got["tokens"],
                    "padded": got["padded_tokens"]}
    print(json.dumps(out))
""")


def _param_key(arch, over) -> str:
    return arch + "".join(f"-{k}{v}" for k, v in sorted(over.items()))


def _tree(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference's waves and the port's, the port's sessions running
    while the reference serves (one session per arch and mesh)."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    archs = {_param_key(a, o): (a, o) for _, a, o, _, _ in CELLS}
    spec = {"params": archs, "cells": CELLS, "tmp": str(tmp)}
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", _REF], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    proc.stdin.write(json.dumps(spec))
    proc.stdin.close()
    try:
        line = proc.stdout.readline()
        if not line.startswith("PARAMS "):
            proc.wait(timeout=60)
            err.seek(0)
            pytest.fail(f"reference failed: {err.read()[-3000:]}")
        paths = json.loads(line[len("PARAMS "):])
        torch_threads.apply(torch_threads.RANK)
        port = {}
        sessions: dict = {}
        for key, arch, over, mesh, kw in CELLS:
            sessions.setdefault((arch, _param_key(arch, over),
                                 tuple(sorted(mesh.items()))), []).append(
                (key, kw))
        for (arch, pkey, mesh), cells in sessions.items():
            over = archs[pkey][1]
            with Plan(arch=arch, overrides=over, device="cpu",
                      **dict(mesh)).compile() as s:
                s._serve_params = _tree(paths[pkey])
                for key, kw in cells:
                    port[key] = s.serve(verbose=False, **kw)
        rest = proc.stdout.read()
        assert proc.wait(timeout=600) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        err.seek(0)
        log = err.read()
        err.close()
    assert rest.strip(), log[-3000:]
    return json.loads(rest.strip().splitlines()[-1]), port


@pytest.mark.parametrize("key", [c[0] for c in CELLS])
def test_mesh_serve_tokens_equal_the_references(served, key):
    ref, port = served
    got, want = port[key], ref[key]
    assert [g.tolist() for g in got["generated"]] == want["tokens"]
    assert got["tokens"] == want["n_tokens"]
    assert got["padded_tokens"] == want["padded"]
    first = np.asarray(want["first"], np.float32)
    mine = got["first_prefill_logits"].numpy()
    assert mine.shape == first.shape
    assert np.abs(mine - first).max() <= 1e-5 * np.abs(first).max()
    # every rank served the same requests
    for loc in got["localities"].values():
        assert loc["tokens"] == got["tokens"]


def _local_shapes(cell, coords: dict) -> list:
    """The cache leaves' shapes that ``decode_rules`` gives the rank at
    ``coords`` of the cell's mesh."""
    _, arch, over, mesh, kw = cell
    plan = Plan(arch=arch, overrides=over, device="cpu")
    shape = {"data": mesh.get("data", 1), "model": mesh.get("model", 1)}
    if mesh.get("pod", 1) > 1:
        shape = {"pod": mesh["pod"], **shape}
    dec = steps.make_decode_step(
        plan.config(), {"seq_len": kw["prompt_len"] + kw["gen_len"],
                        "global_batch": kw["slots"]},
        mesh=Mesh(shape=shape, coords=coords))
    import torch.utils._pytree as pytree

    from repro_torch.core.sharding import is_spec
    return [tuple(s.shape) for s in pytree.tree_leaves(
        dec.cache_specs, is_leaf=is_spec)]


def _coords(mesh: dict, rank: int) -> dict:
    m = mesh.get("model", 1)
    d = mesh.get("data", 1)
    r, c = divmod(rank, m)
    out = {"data": r % d, "model": c}
    if mesh.get("pod", 1) > 1:
        out["pod"] = r // d
    return out


@pytest.mark.parametrize("key", [c[0] for c in CELLS
                                 if c[4]["slots"] == 1])
def test_single_stream_cache_is_tiled_by_sequence(served, key):
    """Each rank holds its block of the cache's positions, the block its
    coordinates give (``kv_seq`` on ``data``, or on ``("data",
    "model")``: four blocks)."""
    _, port = served
    cell = next(c for c in CELLS if c[0] == key)
    mesh, kw = cell[3], cell[4]
    S = kw["prompt_len"] + kw["gen_len"]
    got = port[key]
    ranks = {0: got["cache_shapes"],
             **{r: loc["cache_shapes"]
                for r, loc in got["localities"].items()}}
    n = mesh.get("data", 1) * mesh.get("model", 1)
    for r, shapes in ranks.items():
        assert [tuple(s) for s in shapes] == \
            _local_shapes(cell, _coords(mesh, r))
    # the kv caches hold S / blocks positions: 2 blocks on data, 4 on
    # ("data", "model") where the one kv head does not split
    blocks = 4 if cell[2] == ONE_KV else 2
    kv = [s for s in ranks[0] if len(s) == 4 and s[1] == S // blocks]
    assert kv, ranks[0]
    if cell[1] == "whisper-medium":      # the cross cache splits too
        assert any(len(s) == 4 and s[1] == 16 // 2 for s in ranks[0])
    # the partials merge over the cache's group: the dp group, the whole
    # mesh, or a pod's data axis
    group = {"data2-model2-stream": "mesh",
             "pod2-data2-stream": "data"}.get(key, "dp")
    assert got["wire"]["axes"][group]["calls"] > 0 and n > 1
