"""The port's collectives over a mesh of rank processes
(``core/collectives.py``) and the pure mesh rules (``core/sharding.py``'s
``spec_for``, ``core/overlap.zero1_scatter_mask``, ``core/granularity``,
``core/fusion.fused_apply``/``collective_stats``) against the JAX
package's.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``) and one
JAX subprocess with 4 host devices running the reference's collectives
under ``shard_map`` on the same seeded inputs, module-scoped and run at
once.  The reference's own checks are ported on the port alone (fused =
naive = ring all-reduce, the ring's point-to-point hops counted; the halo
against a manual shift; the flash-decode combine against a full
softmax), and every output is held against the reference's.
"""
import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import compat as jax_compat
from repro.core import fusion as jax_fusion
from repro.core import granularity as jax_grain
from repro.core import overlap as jax_overlap
from repro.core import sharding as jax_sharding
from repro_torch.core import fusion, granularity, overlap, sharding
from repro_torch.launch import mesh as mesh_lib
from torch_mesh_world import run_world, seeded
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
N = 4


def _inputs() -> dict:
    """Rank ``r``'s inputs are row ``r`` of each array."""
    return {"a": np.stack([np.arange(32, dtype=np.float32).reshape(4, 8)
                           + r for r in range(N)]),
            "b": np.stack([np.full((3, 5), 2.0 + r, np.float32)
                           for r in range(N)]),
            "halo": np.arange(16, dtype=np.float32).reshape(N, 4, 1),
            "logits": seeded((64,), 0).reshape(N, 16),
            "values": seeded((64, 8), 1).reshape(N, 16, 8),
            "rs": seeded((N, 8, 3), 2)}


_REF = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core import collectives as C
    from repro.core.compat import shard_map
    from repro.launch.mesh import make_mesh
    x = {k: np.asarray(v, np.float32) for k, v in
         json.loads(sys.stdin.read()).items()}
    mesh = make_mesh((4,), ("data",))

    def body(a, b, halo, lg, v, rs):
        a, b, halo, lg, v, rs = (t[0] for t in (a, b, halo, lg, v, rs))
        tree = {"a": a, "b": b}
        m = jnp.max(lg)[None]
        w = jnp.exp(lg - m)
        out = {"naive": C.naive_psum(tree, "data"),
               "fused": C.fused_psum(tree, "data", cap_bytes=64),
               "ring": {k: C.ring_all_reduce(t, "data")
                        for k, t in tree.items()},
               "halo": C.halo_exchange(halo, "data", 1),
               "combine": C.softmax_combine((m, jnp.sum(w)[None], w @ v),
                                            "data"),
               "scatter": C.reduce_scatter(rs, "data"),
               "gather": C.all_gather(rs, "data"),
               "shift": C.pipeline_shift(b, "data"),
               "shift_back": C.pipeline_shift(b, "data", reverse=True),
               "pmean": jax.lax.pmean(b, "data")}
        return jax.tree.map(lambda t: t[None], out)

    f = shard_map(body, mesh=mesh, in_specs=(P("data"),) * 6,
                  out_specs=P("data"), check_vma=False)
    out = f(*(jnp.asarray(x[k]) for k in
              ("a", "b", "halo", "logits", "values", "rs")))
    print(json.dumps(jax.tree.map(lambda t: np.asarray(t).tolist(), out)))
""")


def _reference(inputs) -> dict:
    env = torch_threads.jax_env(N, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _REF],
                       input=json.dumps({k: v.tolist()
                                         for k, v in inputs.items()}),
                       env=env, text=True, capture_output=True, timeout=200)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def world():
    """(inputs, the reference's outputs by rank, the port's by rank)."""
    inputs = _inputs()
    ref: dict = {}
    t = threading.Thread(target=lambda: ref.update(_reference(inputs)))
    t.start()
    try:
        port = run_world("collectives", N, inputs)
    finally:
        t.join()
    return inputs, ref, port


def test_fused_equals_naive_equals_ring_allreduce(world):
    inputs, _, port = world
    for r in range(N):
        for k in ("a", "b"):
            want = inputs[k].sum(0)
            np.testing.assert_allclose(port[r]["naive"][k], want, rtol=1e-6)
            np.testing.assert_allclose(port[r]["fused"][k],
                                       port[r]["naive"][k], rtol=1e-6)
            np.testing.assert_allclose(port[r]["ring"][k],
                                       port[r]["naive"][k], rtol=1e-5)
        # "a" (32 elements) takes N - 1 point-to-point hops; "b" (15)
        # does not divide by 4 and takes the plain all-reduce
        assert port[r]["ring_hops"] == N - 1


def test_halo_exchange_matches_manual_shift(world):
    _, _, port = world
    out = np.stack([port[r]["halo"][:, 0] for r in range(N)])  # [4, 6]
    # shard 1 holds rows 4..7; halo = row 3 (left) and row 8 (right)
    np.testing.assert_allclose(out[1], [3, 4, 5, 6, 7, 8])
    assert out[0, 0] == 0 and out[3, -1] == 0      # edges zero-padded


def test_flash_decode_combine_matches_full_softmax(world):
    inputs, _, port = world
    lg, v = inputs["logits"].reshape(-1), inputs["values"].reshape(-1, 8)
    w = np.exp(lg - lg.max())
    want = (w / w.sum()) @ v
    for r in range(N):
        np.testing.assert_allclose(port[r]["combine"], want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("op", ["naive", "fused", "ring", "halo", "combine",
                                "scatter", "gather", "shift", "shift_back",
                                "pmean"])
def test_collective_matches_reference(world, op):
    _, ref, port = world
    for r in range(N):
        got, want = port[r][op], ref[op]
        if isinstance(got, dict):
            for k in got:
                np.testing.assert_allclose(got[k], np.asarray(want[k])[r],
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{op}/{k} rank {r}")
        else:
            np.testing.assert_allclose(got, np.asarray(want)[r], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{op} rank {r}")


# -- the pure rules ------------------------------------------------------------
class _Mesh:
    """A stand-in with the one attribute the rules read."""

    def __init__(self, **shape):
        self.shape = shape


SPEC_CASES = [
    ((4096, 1024), ("vocab", "embed")), ((1024, 16, 128),
                                         ("embed", "heads", "head_dim")),
    ((48, 1024, 4096), ("layers", "embed", "d_ff")), ((7,), ("embed",)),
    ((3, 5), ("kv_heads", "head_dim")), ((8, 512, 64), ("batch", "seq",
                                                         "embed")),
    ((16, 16), ("heads", "kv_heads")), ((2, 4096, 8, 1024),
                                        ("layers", "experts", "embed",
                                         "d_ff")),
    ((1 << 14,), (None,)), ((32, 1 << 10), ("layers", "inner")),
    ((), ()), ((6, 6, 6), ("batch", "batch", "channels")),
]


@pytest.mark.parametrize("mesh_shape", [
    {"data": 1, "model": 1}, {"data": 2, "model": 1}, {"data": 4, "model": 2},
    {"pod": 2, "data": 2, "model": 1}, {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16}], ids=lambda s: "x".join(
        f"{k}{v}" for k, v in s.items()))
def test_spec_for_and_scatter_mask_match_reference(monkeypatch, mesh_shape):
    """``spec_for`` (with and without sequence parallelism) and
    ``zero1_scatter_mask`` at dp degrees 1, 2, 4 and 16 are the
    reference's pure functions over every case shape (the reference's
    mask with its old-jax gate off, the decision rule itself)."""
    monkeypatch.setattr(jax_compat, "NEEDS_DP_OPERAND_REPLICATION", False)
    mesh = _Mesh(**mesh_shape)
    for sp in (False, True):
        jr = jax_sharding.default_rules(sequence_parallel=sp)
        pr = sharding.default_rules(sequence_parallel=sp)
        for shape, dims in SPEC_CASES:
            assert sharding.spec_for(mesh, pr, shape, dims) == tuple(
                jax_sharding.spec_for(mesh, jr, shape, dims)), (shape, dims)
    jspecs = {f"{i:02d}": jax_sharding.ParamSpec(s, d)
              for i, (s, d) in enumerate(SPEC_CASES)}
    pspecs = {f"{i:02d}": sharding.ParamSpec(s, d)
              for i, (s, d) in enumerate(SPEC_CASES)}
    for ndp in (1, 2, 4, 16):
        mask = overlap.zero1_scatter_mask(pspecs, mesh,
                                          sharding.default_rules(), ndp)
        assert mask == jax_overlap.zero1_scatter_mask(
            jspecs, mesh, jax_sharding.default_rules(), ndp), ndp
    # the global zero state: m and v whole, whatever the mask
    got = overlap.zero1_init_state(pspecs, mask, 16)
    want = jax_overlap.zero1_init_state(jspecs, mask, 16)
    for k in ("m", "v"):
        assert {n: tuple(t.shape) for n, t in got[k].items()} == \
            {n: tuple(t.shape) for n, t in want[k].items()}


@pytest.mark.parametrize("dp", [1, 2, 4, 16])
def test_grain_policy_matches_reference(monkeypatch, dp):
    """With the reference's TPU v5e constants patched in, the port's
    ``GrainPolicy.derive`` is the reference's decision for decision."""
    monkeypatch.setattr(granularity, "PEAK_FLOPS", jax_grain.PEAK_FLOPS)
    monkeypatch.setattr(granularity, "WIRE_BW",
                        jax_grain.ICI_BW * jax_grain.ICI_LINKS)
    monkeypatch.setattr(granularity, "COLL_LATENCY", jax_grain.COLL_LATENCY)
    monkeypatch.setattr(granularity, "HBM_BYTES", 16e9)
    for n_params, layers, d, seq, batch in [
            (4_000_000_000, 36, 2560, 4096, 256), (125_000_000, 12, 768,
                                                   1024, 8),
            (40_000_000_000, 60, 8192, 32768, 64), (1_000_000, 2, 128, 64,
                                                    1)]:
        kw = dict(n_params=n_params, n_tensors=layers * 9, global_batch=batch,
                  seq=seq, d_model=d, n_layers=layers, head_dim=128,
                  dp_degree=dp)
        got = granularity.GrainPolicy.derive(**kw)
        want = jax_grain.GrainPolicy.derive(**kw)
        assert dataclasses_as_dict(got) == dataclasses_as_dict(want)


def dataclasses_as_dict(d) -> dict:
    return {"bucket_bytes": d.bucket_bytes,
            "n_microbatches": d.n_microbatches, "remat": d.remat,
            "attn_block_q": d.attn_block_q, "attn_block_kv": d.attn_block_kv,
            "rationale": d.rationale}


@pytest.mark.parametrize("cap", [64, 1 << 20])
def test_fused_apply_and_collective_stats_match_reference(cap):
    import torch
    shapes = {"a": (4, 8), "b": (3, 5), "c": (100,)}
    jtree = {k: jnp.arange(np.prod(s), dtype=jnp.float32).reshape(s)
             for k, s in shapes.items()}
    ptree = {k: torch.arange(int(np.prod(s)), dtype=torch.float32).reshape(s)
             for k, s in shapes.items()}
    assert fusion.collective_stats(ptree, cap) == \
        jax_fusion.collective_stats(jtree, cap)
    want = jax_fusion.fused_apply(jtree, lambda b: b * 2 + 1, cap)
    got = fusion.fused_apply(ptree, lambda b: b * 2 + 1, cap)
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_mesh_builders_and_refusals():
    mesh = mesh_lib.make_local_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.dp_size == 1
    assert mesh_lib.mesh_devices(mesh) == 1
    with pytest.raises(ValueError, match="world"):
        mesh_lib.make_local_mesh(model=2)      # no world of rank processes
    with pytest.raises(ValueError, match="world"):
        mesh_lib.make_local_mesh(data=2)       # no world of rank processes
    with pytest.raises(NotImplementedError, match="item 15"):
        mesh_lib.make_production_mesh(multi_pod=True)
