"""The port's optimizers, fusion plan and bit packing against the JAX
package, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core import fusion as jax_fusion
from repro.core.sharding import param_structs
from repro.models.model import build_model as build_jax_model
from repro.optim import compression as jax_compression
from repro.optim import optimizers as jax_optim
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import fusion
from repro_torch.models.model import build_model
from repro_torch.optim import compression, optimizers


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "d": rng.standard_normal((2, 3)).astype(np.float32)}}


def _torch(tree):
    return pytree.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


@pytest.mark.parametrize("kind", ["adamw", "momentum", "sgd"])
@pytest.mark.parametrize("clip", [0.5, 100.0])      # clipping on, off
def test_update_matches_reference(kind, clip):
    oc = dict(kind=kind, lr=1e-2, weight_decay=0.1, grad_clip=clip)
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jax_optim.init(jp, jax_optim.OptConfig(**oc))
    tp = _torch(params)
    tst = optimizers.init(tp, optimizers.OptConfig(**oc))
    for step in range(3):
        grads = _tree(10 + step)
        jp, jst, jm = jax_optim.update(jax.tree.map(jnp.asarray, grads), jst,
                                       jp, jax_optim.OptConfig(**oc))
        tp, tst, tm = optimizers.update(_torch(grads), tst, tp,
                                        optimizers.OptConfig(**oc))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        for name in ("m", "v"):
            if name in jst:
                np.testing.assert_allclose(tree_to_numpy(tst[name])["a"],
                                           np.asarray(jst[name]["a"]),
                                           atol=1e-6, rtol=1e-6)
        got = tree_to_numpy(tp)
        for want, have in ((jp["a"], got["a"]), (jp["b"]["c"], got["b"]["c"]),
                           (jp["b"]["d"], got["b"]["d"])):
            np.testing.assert_allclose(have, np.asarray(want), atol=1e-6,
                                       rtol=1e-6)


def test_clip_by_global_norm_matches_reference():
    g = _tree(3)
    jg, jn = jax_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = optimizers.clip_by_global_norm(_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(tree_to_numpy(tg)["b"]["d"],
                               np.asarray(jg["b"]["d"]), rtol=1e-6)


def test_init_specs_mirror_the_parameters():
    cfg = get_config("qwen3-4b", tiny=True)
    specs = build_model(cfg).specs()
    st = optimizers.init_specs(specs, optimizers.OptConfig())
    assert set(st) == {"count", "m", "v"}
    assert st["m"]["stack"][1]["attn"]["wq"].shape == \
        specs["stack"][1]["attn"]["wq"].shape
    assert st["v"]["embed"]["tok"].dtype == torch.float32
    assert set(optimizers.init_specs(
        specs, optimizers.OptConfig(kind="sgd"))) == {"count"}


def _f32_structs(arch):
    cfg = jax_get_config(arch, tiny=True)
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                        param_structs(build_jax_model(cfg).specs()))


def _f32_specs(arch):
    import dataclasses
    specs = build_model(get_config(arch, tiny=True)).specs()
    return pytree.tree_map(
        lambda s: dataclasses.replace(s, dtype=torch.float32), specs,
        is_leaf=lambda x: hasattr(x, "dims"))


def _assert_same_plan(mine, ref):
    assert mine.n_leaves == ref.n_leaves
    assert mine.n_buckets == ref.n_buckets
    for b, rb in zip(mine.buckets, ref.buckets):
        assert (b.total, b.padded, b.size) == (rb.total, rb.padded, rb.size)
        assert [(e.index, e.shape, e.size, e.offset) for e in b.entries] == \
            [(e.index, e.shape, e.size, e.offset) for e in rb.entries]


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-3b", "zamba2-2.7b"])
def test_compression_plan_matches_reference(arch):
    _assert_same_plan(compression.make_plan(_f32_specs(arch), 1),
                      jax_compression.make_plan(_f32_structs(arch), 1))


@pytest.mark.parametrize("cap, pad", [(1 << 16, 1), (1 << 18, 128),
                                      (1 << 12, 32768)])
def test_fusion_plan_matches_reference_across_caps(cap, pad):
    """Small caps split the tree into many buckets: the boundaries, the
    entries' order and offsets and the padding are the reference's."""
    mine = fusion.make_plan(_f32_specs("qwen3-4b"), cap, pad)
    ref = jax_fusion.make_plan(_f32_structs("qwen3-4b"), cap, pad)
    assert mine.n_buckets > 3
    _assert_same_plan(mine, ref)


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_pack_of_bridged_gradients_matches_reference(arch):
    """Random gradients in the JAX layout, bridged into the port: the
    port's buckets equal the reference's, element for element, and unpack
    gives the gradients back."""
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        _f32_structs(arch))
    cfg = get_config(arch, tiny=True)
    tgrads = params_from_numpy(grads, cfg, "cpu")
    ref_plan = jax_fusion.make_plan(grads, 1 << 16, 32768)
    plan = fusion.make_plan(tgrads, 1 << 16, 32768)
    want = jax_fusion.pack(jax.tree.map(jnp.asarray, grads), ref_plan)
    got = fusion.pack(tgrads, plan)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tree_to_numpy(fusion.unpack(got, plan))
    for path, w in jax.tree_util.tree_flatten_with_path(grads)[0]:
        h = back
        for p in path:
            h = h[p.key]
        np.testing.assert_array_equal(h, w)


def test_unpack_gives_views_into_the_buckets():
    tree = _torch(_tree(1))
    plan = fusion.make_plan(tree)
    bufs = fusion.pack(tree, plan)
    out = fusion.unpack(bufs, plan)
    bufs[0].zero_()
    assert float(out["b"]["d"].abs().sum()) == 0.0


@pytest.mark.parametrize("R, C", [(1, 32), (4, 128), (64, 1024)])
def test_pack_bits_bytes_match_reference(R, C):
    signs = np.random.default_rng(R).random((R, C)) < 0.5
    signs[0, :32] = True                 # a word with its top bit set
    got = compression.pack_bits(torch.from_numpy(signs))
    want = np.asarray(jax_compression.pack_bits(jnp.asarray(signs)))
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == want.tobytes()
    assert np.array_equal(compression.unpack_bits(got).numpy(), signs)


@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_pack_signs_ragged_matches_reference(n):
    signs = np.random.default_rng(n).random(n) < 0.5
    got = compression.pack_signs(torch.from_numpy(signs))
    want = np.asarray(jax_compression.pack_signs(jnp.asarray(signs)))
    assert got.numpy().tobytes() == want.tobytes()
    assert np.array_equal(compression.unpack_signs(got, n).numpy(), signs)
