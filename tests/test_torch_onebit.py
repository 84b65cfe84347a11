"""The port's 1-bit codec (on CPU tensors: the plain versions of K3a/K3b)
against the JAX package's Pallas kernels in interpret mode and its
``OneBitCodec``, on the same numpy inputs.  The CUDA kernels themselves
are held against the plain versions on the card by chip_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core.sharding import param_structs
from repro.distrib.collectives import get_codec as jax_get_codec
from repro.kernels.onebit import onebit_dequantize as jax_dequantize
from repro.kernels.onebit import onebit_quantize as jax_quantize
from repro.models.model import build_model as build_jax_model
from repro.optim import compression as jax_compression
from repro_torch.configs import get_config
from repro_torch.distrib.collectives import (CODECS, RingAllReduce,
                                             get_codec)
from repro_torch.kernels.onebit import (onebit_dequantize,
                                        onebit_dequantize_ref,
                                        onebit_quantize, onebit_quantize_ref)
from repro_torch.models.model import build_model
from repro_torch.optim import compression
import torch_threads

torch_threads.apply()


def _inputs(R, C, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, C)).astype(np.float32),
            (0.1 * rng.standard_normal((R, C))).astype(np.float32))


@pytest.mark.parametrize("R, C, bm", [(8, 128, 8), (32, 1024, 16),
                                      (512, 256, 256), (3, 1024, 3)])
def test_plain_quantize_matches_pallas_kernel(R, C, bm):
    g, e = _inputs(R, C, seed=R)
    jp, js, je = jax_quantize(jnp.asarray(g), jnp.asarray(e), block_rows=bm,
                              interpret=True)
    packed, scale, new_err = onebit_quantize(torch.from_numpy(g),
                                             torch.from_numpy(e))
    assert packed.dtype == torch.int32 and packed.shape == (R, C // 32)
    assert scale.shape == (R, 1)
    assert packed.numpy().tobytes() == np.asarray(jp).tobytes()
    np.testing.assert_allclose(scale.numpy()[:, 0], np.asarray(js)[:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(je), atol=1e-6)
    deq = onebit_dequantize(packed, scale)
    want = jax_dequantize(jp, jnp.broadcast_to(jnp.asarray(scale.numpy()),
                                               (R, 128)),
                          block_rows=bm, interpret=True)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(want))


@pytest.mark.parametrize("R, C", [(7, 128), (3, 4096), (8, 1024)])
def test_plain_dequantize_matches_pallas_kernel_on_random_words(R, C):
    """K3b's row widths on chip_smoke.py's card check (several rows a
    block, a loop over a wide row, the codec's 1024): the plain version
    equals the Pallas kernel bit for bit on any words, sign bit included."""
    rng = np.random.default_rng(R * C)
    words = rng.integers(0, 2**32, (R, C // 32), dtype=np.uint32)
    scale = rng.random((R, 1), dtype=np.float32)
    got = onebit_dequantize(torch.from_numpy(words.view(np.int32)),
                            torch.from_numpy(scale))
    want = jax_dequantize(jnp.asarray(words),
                          jnp.broadcast_to(jnp.asarray(scale), (R, 128)),
                          block_rows=R, interpret=True)
    assert got.shape == (R, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_wrappers_are_the_plain_versions_on_the_cpu():
    g, e = (torch.from_numpy(a) for a in _inputs(4, 128, seed=7))
    for got, want in zip(onebit_quantize(g, e), onebit_quantize_ref(g, e)):
        assert torch.equal(got, want)
    p, s, _ = onebit_quantize_ref(g, e)
    assert torch.equal(onebit_dequantize(p, s), onebit_dequantize_ref(p, s))
    # dequantized + residual reconstructs the input
    np.testing.assert_allclose((onebit_dequantize(p, s)
                                + onebit_quantize(g, e)[2]).numpy(),
                               (g + e).numpy(), atol=1e-6)


@pytest.mark.parametrize("change, err", [
    (dict(C=100), ValueError),                 # C not a multiple of 128
    (dict(dtype=torch.float64), TypeError),
    (dict(device="meta"), ValueError),
    (dict(transpose=True), ValueError),        # not contiguous
])
def test_quantize_rejects_what_the_kernel_does_not_take(change, err):
    C = change.get("C", 128)
    g = torch.zeros(4, C, dtype=change.get("dtype", torch.float32),
                    device=change.get("device", "cpu"))
    if change.get("transpose"):
        g = torch.zeros(C, 4).t()
    with pytest.raises(err):
        onebit_quantize(g, torch.zeros(4, C, dtype=torch.float32))


def test_dequantize_rejects_bad_shapes_and_types():
    with pytest.raises(ValueError):
        onebit_dequantize(torch.zeros(4, 3, dtype=torch.int32),
                          torch.ones(4, 1))
    with pytest.raises(TypeError):
        onebit_dequantize(torch.zeros(4, 4, dtype=torch.int64),
                          torch.ones(4, 1))


def _plans(arch="qwen3-4b"):
    jcfg = jax_get_config(arch, tiny=True)
    structs = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape,
                                                          jnp.float32),
                           param_structs(build_jax_model(jcfg).specs()))
    specs = pytree.tree_map(
        lambda s: dataclasses.replace(s, dtype=torch.float32),
        build_model(get_config(arch, tiny=True)).specs(),
        is_leaf=lambda x: hasattr(x, "dims"))
    return (jax_compression.make_plan(structs, 1),
            compression.make_plan(specs, 1))


def _buckets(plan, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(b.size).astype(np.float32)
            for b in plan.buckets]


def test_codec_payload_matches_reference():
    """Same bucket, zero residual: the sign words are byte-equal, the
    scales agree to 1e-6, and so do wire_bytes; each side decodes the
    other's payload to the same contribution."""
    ref_plan, plan = _plans()
    bufs = _buckets(ref_plan, 1)
    ref, mine = jax_get_codec("onebit"), get_codec("onebit")
    ref.reset(ref_plan)
    mine.reset(plan)
    want = ref.encode(bufs)
    got = mine.encode([torch.from_numpy(b) for b in bufs])
    assert mine.wire_bytes(plan) == ref.wire_bytes(ref_plan)
    for w, g, b in zip(want, got, plan.buckets):
        rows = b.size // compression.ROW
        nb = b.size // 8
        assert len(g) == len(w) == nb + 4 * rows
        assert g[:nb] == w[:nb]
        np.testing.assert_allclose(np.frombuffer(g[nb:], np.float32),
                                   np.frombuffer(w[nb:], np.float32),
                                   rtol=1e-6)
        np.testing.assert_array_equal(mine.decode(w, b).numpy(),
                                      ref.decode(w, b))


def test_fp32_codec_matches_reference():
    ref_plan, plan = _plans()
    bufs = _buckets(ref_plan, 2)
    ref, mine = jax_get_codec("fp32"), get_codec("fp32")
    got = mine.encode([torch.from_numpy(b) for b in bufs])
    assert got == ref.encode(bufs)
    assert mine.wire_bytes(plan) == ref.wire_bytes(ref_plan)
    assert torch.equal(mine.decode(got[0], plan.buckets[0]),
                       torch.from_numpy(bufs[0]))


def test_onebit_codec_error_feedback_is_stateful():
    """A second encode of the SAME gradient must differ: the residual of
    the first quantization is folded in (and a reset clears it)."""
    _, plan = _plans()
    g = torch.from_numpy(_buckets(plan, 3)[0])
    codec = get_codec("onebit")
    codec.reset(plan)
    first = codec.encode([g])[0]
    second = codec.encode([g])[0]
    assert first != second
    codec.reset(plan)
    assert codec.encode([g])[0] == first


def test_world1_ring_passes_every_bucket_through_the_codec():
    _, plan = _plans()
    bufs = [torch.from_numpy(b) for b in _buckets(plan, 4)]
    ring = RingAllReduce(None, 1)
    codec = ring.configure("onebit", plan)
    summed, metas = ring.allreduce(0, bufs, meta={"loss": 1.0})
    assert metas == {0: {"loss": 1.0}} and ring.wire_bytes == 0
    check = get_codec("onebit")
    check.reset(plan)
    for s, b, bucket in zip(summed, bufs, plan.buckets):
        assert torch.equal(s, check.decode(check.encode([b])[0], bucket))
    assert codec.name == "onebit"


def test_codecs_and_ring_surface():
    assert sorted(CODECS) == ["fp32", "onebit"]
    with pytest.raises(ValueError):
        get_codec("int8")
    with pytest.raises(ValueError, match="endpoint"):
        RingAllReduce(None, 2)
    with pytest.raises(RuntimeError):
        RingAllReduce(None, 1).allreduce(0, [])
