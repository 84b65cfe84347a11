"""The encdec family against the JAX package: the sinusoidal embedding,
the tanh-gelu MLP, tiny whisper-medium's encoder, prefill and greedy
decode on bridged serve parameters, the loss and every gradient, a bf16
run, train steps, its decode cache through the bridge, and the serving
surface (``Session.serve``'s tree, ``serve_stream``'s refusal, the
CLI)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.frontend import Plan as JaxPlan
from repro.models import layers as jax_layers
from repro.models.model import build_model as build_jax_model
from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import sharding, steps
from repro_torch.data.pipeline import stream_for, to_device
from repro_torch.frontend import Plan
from repro_torch.models import layers
from repro_torch.models.model import EncDec, build_model
from torch_parity import (GEN, PROMPT, SLOTS, bf16_parity,
                          resume_is_bit_identical, train_cli_runs,
                          jax_train_params, loss_and_grads_match,
                          serve_cli_runs, serve_parity, train_steps_match)
import torch_threads

torch_threads.apply()

ATOL = 1e-4
ARCH = "whisper-medium"


@pytest.mark.parametrize("seq, d", [(16, 128), (1500, 1024), (7, 10)])
def test_sinusoidal_embedding_matches_jax(seq, d):
    want = np.asarray(jax_layers.sinusoidal_embedding(seq, d))
    got = layers.sinusoidal_embedding(seq, d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # at position 1499 the float32 angle's own rounding is 1.2e-4: the two
    # packages' sines part by up to 3e-5 there
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def _gelu_params(d, ff, seed):
    rng = np.random.default_rng(seed)
    return {"w_up": rng.standard_normal((d, ff)) / np.sqrt(d),
            "b_up": 0.5 * rng.standard_normal(ff),
            "w_down": rng.standard_normal((ff, d)) / np.sqrt(ff),
            "b_down": 0.5 * rng.standard_normal(d)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """The gelu MLP (biased up and down projections) against the
    reference's: f32 within ATOL, bf16 within 2**-7 of the output's
    scale (one bf16 rounding step there); its specs leaf for leaf."""
    d, ff = 64, 160
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in _gelu_params(d, ff, 4).items()}
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_layers.apply_mlp(
        jnp.asarray(x, jdt), {k: jnp.asarray(v) for k, v in p.items()},
        "gelu"), np.float32)
    got = layers.apply_mlp(torch.from_numpy(x).to(getattr(torch, dtype)),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           "gelu").float().numpy()
    tol = ATOL if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=ATOL)
    jspecs = jax_layers.mlp_specs(d, ff, "gelu")
    specs = layers.mlp_specs(d, ff, "gelu")
    assert set(specs) == set(jspecs)
    for k, js in jspecs.items():
        assert (specs[k].shape, specs[k].dims, specs[k].init) == \
            (js.shape, js.dims, js.init), k


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; the exact erf form
    differs from it by more than the parity tolerance."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = layers.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def _frames(cfg, batch, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_frames, cfg.d_model))).astype(np.float32)


def test_encode_matches_jax():
    """The encoder (frames + sinusoidal positions, the non-causal blocks,
    ln_enc) on bridged float32 parameters."""
    jcfg, cfg = jax_get_config(ARCH, tiny=True), get_config(ARCH, tiny=True)
    jparams, tree = jax_train_params(jcfg)
    fr = _frames(cfg, 2, 5)
    want = jax.jit(build_jax_model(jcfg).encode)(jparams, jnp.asarray(fr))
    model = build_model(cfg)
    assert isinstance(model, EncDec)
    got = model.encode(params_from_numpy(tree, cfg, "cpu"),
                       torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_prefill_and_greedy_decode_match_jax():
    """Prefill (the encoder, then the decoder's prefill with the cross K/V
    cached) and GEN greedy decode steps on bridged bf16 serve parameters
    and seeded numpy frames: logits within ATOL, the same tokens; the
    prefill's cache within ATOL, its cross K/V ``enc_frames`` long."""
    cache, jcache, scfg = serve_parity(ARCH, frames=True)
    assert jcache["ck"].shape[2] == scfg.enc_frames
    assert len(cache) == scfg.n_layers
    assert cache[0]["ck"].shape == (SLOTS, scfg.enc_frames, scfg.n_kv_heads,
                                    scfg.head_dim)


def test_loss_and_gradients_match_jax():
    """Held as tests/test_torch_train.py holds zamba2-2.7b: tiny whisper's
    float32 gradient is ill-conditioned (a relative 1e-6 of noise on the
    parameters moves the reference's own gradient by 1.3e-3 of max
    |grad|); the port's lies within 5.1e-4 of the reference's."""
    cfg = get_config(ARCH, tiny=True)
    batch = stream_for(cfg, batch=4, seq=32, seed=3).batch_at(0)
    assert batch["frames"].shape == (4, cfg.enc_frames, cfg.d_model)
    loss_and_grads_match(ARCH, batch, 1e-3)


def test_bf16_prefill_and_decode_match_jax():
    """``bf16_parity``: the logits' mean |error| within 2e-2 and the
    largest within 0.25 of the largest |logit|.  Read on the CPU: 1.57e-2
    and 0.177; with LayerNorm's statistics taken in bf16, 2.45e-2 and
    0.327 (fails both)."""
    bf16_parity(ARCH, 2e-2, 0.25, frames=True)


def test_cache_from_numpy_carries_the_encdec_cache():
    cfg = steps._serve_cfg(get_config(ARCH, tiny=True))
    jmodel = build_jax_model(jax_get_config(ARCH, tiny=True))
    rng = np.random.default_rng(0)
    cache = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        jmodel.cache_specs(SLOTS, PROMPT + GEN),
        is_leaf=lambda x: hasattr(x, "init"))
    mine = cache_from_numpy(cache, cfg, "cpu")
    assert len(mine) == cfg.n_layers
    assert set(mine[0]) == {"k", "v", "ck", "cv"}
    assert mine[1]["ck"].shape == (SLOTS, cfg.enc_frames, cfg.n_kv_heads,
                                   cfg.head_dim)
    assert mine[1]["k"].shape == (SLOTS, PROMPT + GEN, cfg.n_kv_heads,
                                  cfg.head_dim)
    np.testing.assert_array_equal(mine[1]["cv"].numpy(), cache["cv"][1])
    cache["extra"] = cache["k"]
    with pytest.raises(ValueError, match="extra"):
        cache_from_numpy(cache, cfg, "cpu")


def test_decode_position_embedding_clamps_as_dynamic_slice():
    """``_dec_embed`` at a start past the table's end takes the last rows,
    as ``lax.dynamic_slice_in_dim`` clamps its start."""
    over = dict(max_dec_len=40)
    jcfg = dataclasses.replace(jax_get_config(ARCH, tiny=True), **over)
    cfg = dataclasses.replace(get_config(ARCH, tiny=True), **over)
    jparams, tree = jax_train_params(jcfg)
    toks = np.arange(6)[None] % cfg.vocab
    params = params_from_numpy(tree, cfg, "cpu")
    for pos0 in (0, 30, 37):
        want = build_jax_model(jcfg)._dec_embed(jparams, jnp.asarray(toks),
                                                pos0)
        got = build_model(cfg)._dec_embed(params, torch.from_numpy(toks),
                                          pos0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_session_serve_traces_the_same_tree_as_jax():
    kw = dict(requests=5, slots=2, prompt_len=16, gen_len=4, verbose=False)
    with JaxPlan(arch=ARCH).compile() as session:
        want = session.serve(**kw)
    with Plan(arch=ARCH, device="cpu").compile() as session:
        got = session.serve(**kw)
    assert got["trace"] == want["trace"]
    assert got["nodes"] == want["nodes"]
    for key in ("tokens", "padded_tokens", "requests"):
        assert got[key] == want[key]
    assert got["waves"] == 3
    assert torch.isfinite(got["first_prefill_logits"]).all()


def test_serve_stream_refuses_encdec_with_the_reference_message():
    kw = dict(requests=2, slots=2, prompt_len=8, gen_len=2, verbose=False)
    with JaxPlan(arch=ARCH).compile() as session:
        with pytest.raises(ValueError) as want:
            session.serve_stream(**kw)
    with Plan(arch=ARCH, device="cpu").compile() as session:
        with pytest.raises(ValueError) as got:
            session.serve_stream(**kw)
    assert str(got.value) == str(want.value)
    assert "serve_stream does not support encdec" in str(got.value)


def test_serve_cli_runs_on_cpu():
    serve_cli_runs(ARCH)


def test_train_steps_match_jax():
    """tiny whisper's float32 gradient is ill-conditioned (the loss and
    gradients test above): adamw's normalized step turns every near-zero
    gradient whose sign differs into a whole +-lr step, so, as for tiny
    zamba in tests/test_torch_train.py, momentum, whose step is
    proportional to the gradient, shows the two train steps' agreement.
    The cross-attention ``bk``/``bv`` are never read by the loss: their
    gradient is zeros, as ``jax.grad`` gives it."""
    train_steps_match(ARCH, "momentum", 1e-3)


def test_train_cli_runs_on_cpu(tmp_path):
    train_cli_runs(ARCH, tmp_path)


def test_checkpoint_resume_is_bit_identical(tmp_path):
    resume_is_bit_identical(ARCH, tmp_path)


def test_unread_cross_biases_come_out_of_adamw_unchanged():
    """``Session.train`` with adamw: the step zero-fills the gradients of
    exactly ``EncDec.unread``'s leaves (the cross ``bk``/``bv``), so
    adamw's moments stay zero and those leaves leave the run as they
    entered it; every other leaf moved."""
    plan = Plan(arch=ARCH, batch=4, seq=16, device="cpu")
    with plan.compile() as session:
        init, _ = session.train_step.init(
            torch.Generator().manual_seed(plan.seed), "cpu")
        before = [t.detach().clone()
                  for t in session.train_step.model.unread(init)]
        out = session.train(steps=3, log_every=1, verbose=False)
        after = session.train_step.model.unread(out["params"])
    assert len(before) == 2 * session.cfg.n_layers > 0
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    unread = {id(t) for t in after}
    moved = [not torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(init), pytree.tree_leaves(out["params"]))
        if id(b) not in unread]
    assert all(moved)


def _encoder_grad_norms(model, params, batch) -> list:
    for t in pytree.tree_leaves(params):
        t.requires_grad_(True)
    model.loss(params, to_device(batch, "cpu")).backward()
    return [float(torch.sqrt(sum(t.grad.double().square().sum()
                                 for t in pytree.tree_leaves(p)
                                 if t.grad is not None)))
            for p in params["enc_stack"]]


def _fan_in_d(spec):
    """``spec`` with the std of a rank-3 attention projection rescaled to
    1/sqrt(its input width), d_model or H*hd."""
    if spec.init != "normal" or len(spec.shape) != 3:
        return spec
    fan = spec.shape[0] if spec.dims[0] == "embed" \
        else spec.shape[0] * spec.shape[1]
    return dataclasses.replace(
        spec, scale=spec.scale * math.sqrt(spec.shape[-2] / fan))


def test_reference_init_grows_the_encoder_gradient_layer_by_layer():
    """Why whisper-medium does not train from the reference's random init
    (ROADMAP §3): the init takes fan-in ``shape[-2]`` for every weight, H
    for the attention projections [d, H, hd] and hd for [H, hd, d], so at
    full width (3 encoder and 3 decoder layers here, one row of 16 tokens
    over the 1,500 frames) each encoder layer's gradient is several times
    the one above it, in the JAX package and in the port on the same
    weights; drawn with fan-in d_model the growth goes.  At 24 layers
    the float32 norm overflows (``chip_smoke.py``, whisper_grad_scale)."""
    over = dict(n_layers=3, n_enc_layers=3)
    jcfg = dataclasses.replace(jax_get_config(ARCH), **over)
    cfg = dataclasses.replace(get_config(ARCH), **over)
    batch = stream_for(cfg, batch=1, seq=16, seed=0).batch_at(0)
    jmodel = build_jax_model(jcfg)
    jparams = jax_init_params(jmodel.specs(), jax.random.PRNGKey(0))
    jgrads = jax.grad(jmodel.loss)(jparams, jax.tree.map(jnp.asarray, batch))
    enc = jgrads["enc_stack"]
    layer = (lambda i: enc[i]) if isinstance(enc, list) else \
        (lambda i: jax.tree.map(lambda x: x[i], enc))
    ref = [float(np.sqrt(sum(np.sum(np.square(np.asarray(x, np.float64)))
                             for x in jax.tree.leaves(layer(i)))))
           for i in range(3)]
    model = build_model(cfg)
    mine = _encoder_grad_norms(
        model, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu"), batch)
    specs = pytree.tree_map(_fan_in_d, model.specs(),
                            is_leaf=sharding.is_spec)
    fixed = _encoder_grad_norms(model, sharding.init_params(
        specs, torch.Generator().manual_seed(0), "cpu"), batch)
    print(f"encoder layers 0..2 gradient norms: JAX {ref}, port {mine}, "
          f"fan-in d_model {fixed}")
    for norms in (ref, mine):
        assert norms[0] > 4 * norms[1] > 16 * norms[2]
    assert max(fixed) < 2 * min(fixed)
