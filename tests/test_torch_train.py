"""The training slice against the JAX package: the loss and every
parameter gradient, a 20-step train trajectory, world-1 fabric DDP with
the fp32 and onebit codecs, and the Session/launcher surface on the CPU."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core import steps as jax_steps
from repro.core.sharding import init_params as jax_init_params
from repro.data.pipeline import LMStream as JaxLMStream
from repro.distrib.collectives import RingAllReduce as JaxRing
from repro.frontend import Plan as JaxPlan
from repro.frontend.ddp import DDPEngine as JaxDDPEngine
from repro.launch.mesh import make_local_mesh
from repro.models import layers as jax_layers
from repro.models.model import build_model as build_jax_model
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.data.pipeline import LMStream, stream_for, to_device
from repro_torch.distrib.collectives import RingAllReduce
from repro_torch.frontend import Plan
from repro_torch.frontend.ddp import DDPEngine, shard_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers

BATCH, SEQ = 4, 32


def _jax_params(cfg, seed=0):
    """JAX f32 parameters with the zero/one-initialized leaves (biases,
    norm weights) drawn at random, so that their gradients are exercised;
    returns the JAX tree and its numpy copy."""
    model = build_jax_model(cfg)
    params = jax_init_params(model.specs(), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def to_np(a):
        a = np.asarray(a, np.float32)
        if np.all(a == a.flat[0]):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    tree = jax.tree.map(to_np, params)
    return jax.tree.map(jnp.asarray, tree), tree


def _port_params(tree, cfg):
    params = params_from_numpy(tree, cfg, "cpu")
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _batch(cfg, step=0):
    return LMStream(vocab=cfg.vocab, batch=BATCH, seq=SEQ,
                    seed=3).batch_at(step)


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


@pytest.mark.parametrize("arch, grad_tol", [
    ("qwen3-4b", 1e-4),
    # without qk-norm the tiny model's gradient is ill-conditioned: each
    # float32 implementation, the port's and the reference's, lies about
    # 3e-4 of max |grad| from a float64 run of the port (embedding rows);
    # they are held to 5e-4 of each other
    ("qwen2.5-3b", 5e-4),
])
def test_loss_and_gradients_match_jax(arch, grad_tol):
    jcfg = jax_get_config(arch, tiny=True)
    cfg = get_config(arch, tiny=True)
    jparams, tree = _jax_params(jcfg)
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(build_jax_model(jcfg).loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = _port_params(tree, cfg)
    loss = build_model(cfg).loss(params, to_device(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    grads = tree_to_numpy(pytree.tree_map(lambda p: p.grad, params))
    scale = max(float(jnp.abs(g).max()) for g in jax.tree.leaves(jgrads))
    for path, want in _leaves_with_paths(jgrads):
        np.testing.assert_allclose(_get(grads, path), np.asarray(want),
                                   atol=grad_tol * scale, err_msg=str(path))


def test_softmax_xent_with_mask_matches_jax():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_layers.softmax_xent(
            jnp.asarray(lg), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = layers.softmax_xent(
            torch.from_numpy(lg), torch.from_numpy(labels).long(),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)


def test_remat_gives_identical_loss_and_gradients():
    cfg = get_config("qwen3-4b", tiny=True)
    _, tree = _jax_params(jax_get_config("qwen3-4b", tiny=True))
    batch = to_device(_batch(cfg), "cpu")
    out = []
    for remat in (False, True):
        params = _port_params(tree, cfg)
        loss = build_model(dataclasses.replace(cfg, remat=remat)).loss(
            params, batch)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in
                                    pytree.tree_leaves(params)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_trajectory_matches_jax(grad_accum):
    """20 steps of make_train_step from bridged init: loss and grad_norm
    per step within 1e-4 relative of the reference's."""
    shape = {"seq_len": SEQ, "global_batch": BATCH, "kind": "train"}
    jcfg = jax_get_config("qwen3-4b", tiny=True)
    jstep = jax_steps.make_train_step(
        jcfg, make_local_mesh(),
        jax_steps.Strategy(grad_accum=grad_accum), shape)
    jparams, jopt = jstep.init(jax.random.PRNGKey(0))
    cfg = get_config("qwen3-4b", tiny=True)
    step = steps.make_train_step(cfg, steps.Strategy(grad_accum=grad_accum))
    params = _port_params(jax.tree.map(np.asarray, jparams), cfg)
    opt = optimizers.init(params, optimizers.OptConfig())
    stream = JaxLMStream(vocab=cfg.vocab, batch=BATCH, seq=SEQ, seed=1)
    for it in range(20):
        batch = stream.batch_at(it)
        jm, jparams, jopt = jstep.fn(jparams, jopt,
                                     jax.tree.map(jnp.asarray, batch))
        m, params, opt = step.fn(params, opt, to_device(batch, "cpu"))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {it} {k}")
    assert int(opt["count"]) == 20


@pytest.mark.parametrize("codec, rtol", [
    ("fp32", 1e-4),
    # a sign whose q lies near 0 may flip between the two sides, which
    # moves that element by a whole +-scale: held to 1e-3
    ("onebit", 1e-3),
])
def test_world1_ddp_matches_reference_engine(codec, rtol):
    """10 steps of DDPEngine.train_step, two shards, one locality, from
    bridged init: loss and grad_norm per step against the reference's
    DDPEngine; grad_wire_bytes 0 and codec_bytes equal."""
    kw = dict(arch="qwen3-4b", tiny=True, batch=BATCH, seq=SEQ, ddp=True,
              grad_codec=codec, ddp_shards=2)
    jeng = JaxDDPEngine(JaxPlan(**kw), JaxRing(None, 1))
    jparams, jopt = jeng.init()
    eng = DDPEngine(Plan(**kw, device="cpu"), RingAllReduce(None, 1))
    cfg = get_config("qwen3-4b", tiny=True)
    params = _port_params(jax.tree.map(np.asarray, jparams), cfg)
    opt = optimizers.init(params, optimizers.OptConfig())
    assert eng.codec_bytes == jeng.codec_bytes
    stream = stream_for(cfg, batch=BATCH, seq=SEQ, seed=2)
    for it in range(10):
        batch = stream.batch_at(it)
        jm, jparams, jopt = jeng.train_step(it, batch, jparams, jopt)
        m, params, opt = eng.train_step(it, batch, params, opt)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"step {it} {k}")
    assert eng.ring.wire_bytes == jeng.ring.wire_bytes == 0


def test_ddp_grad_fn_frees_the_gradients_it_packs():
    cfg = get_config("qwen3-4b", tiny=True)
    step = steps.make_ddp_step(cfg, steps.Strategy())
    params, _ = step.init(torch.Generator().manual_seed(0), "cpu")
    loss, bufs = step.grad_fn(params, to_device(_batch(cfg), "cpu"))
    assert all(p.grad is None for p in pytree.tree_leaves(params))
    assert [b.numel() for b in bufs] == [b.size for b in
                                         step.grad_plan.buckets]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def test_shard_batch_concatenates_back():
    batch = _batch(get_config("qwen3-4b", tiny=True))
    parts = [shard_batch(batch, s, 2) for s in range(2)]
    assert np.array_equal(np.concatenate([p["tokens"] for p in parts]),
                          batch["tokens"])
    with pytest.raises(ValueError):
        shard_batch(batch, 0, 3)


def test_stream_matches_reference():
    mine = LMStream(vocab=512, batch=3, seq=16, seed=4).batch_at(7)
    want = JaxLMStream(vocab=512, batch=3, seq=16, seed=4).batch_at(7)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(mine[k], want[k])


class _Hooks:
    def __init__(self):
        self.steps, self.logs = [], []

    def on_step(self, it, metrics):
        self.steps.append(it)

    def on_log(self, it, loss):
        self.logs.append((it, loss))


@pytest.mark.parametrize("extra", [{}, dict(ddp=True, grad_codec="onebit",
                                            ddp_shards=2)])
def test_session_train_on_the_cpu(extra):
    hooks = _Hooks()
    plan = Plan(batch=BATCH, seq=SEQ, device="cpu", **extra)
    with plan.compile() as session:
        out = session.train(steps=6, log_every=2, hooks=hooks,
                            verbose=False)
    assert hooks.steps == list(range(6))
    assert [it for it, _ in hooks.logs] == [1, 3, 5]
    assert out["step"] == 6 and len(out["losses"]) == 3
    assert out["final_loss"] == pytest.approx(out["losses"][-1])
    assert np.isfinite(out["final_loss"])
    if extra:
        assert out["grad_wire_bytes"] == 0 and out["codec_bytes"] > 0


@pytest.mark.parametrize("extra", [{}, dict(ddp=True, grad_codec="onebit",
                                            ddp_shards=2)])
def test_session_train_fail_at_step_raises(extra):
    with Plan(batch=BATCH, seq=SEQ, device="cpu", **extra).compile() \
            as session:
        with pytest.raises(RuntimeError, match="injected node failure"):
            session.train(steps=4, fail_at_step=2, verbose=False)


def test_launch_train_run_on_the_cpu(tmp_path):
    stats = tmp_path / "stats.json"
    args = train_cli.parser().parse_args([
        "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
        "--log-every", "2", "--ddp", "--grad-codec", "onebit",
        "--ddp-shards", "2", "--stats-out", str(stats)])
    out = train_cli.run(args)
    saved = json.loads(stats.read_text())
    assert saved["step"] == 4 and len(saved["losses"]) == 2
    assert saved["grad_wire_bytes"] == 0
    assert saved["codec_bytes"] == out["codec_bytes"]


@pytest.mark.parametrize("argv, match", [
    (["--ckpt", "ck"], "item 8"),
    (["--resume"], "item 8"),
    (["--localities", "2"], "item 12"),
    (["--join", "127.0.0.1:1"], "item 12"),
    (["--elastic"], "item 13"),
    (["--strategy", "zero1"], "item 14"),
    (["--strategy", "onebit"], "item 14"),
])
def test_launch_train_raises_for_what_the_port_does_not_run(argv, match):
    args = train_cli.parser().parse_args(
        ["--device", "cpu", "--steps", "1", *argv])
    with pytest.raises(NotImplementedError, match=match):
        train_cli.run(args)


def test_not_implemented_surface():
    with Plan(device="cpu").compile() as session:
        with pytest.raises(NotImplementedError, match="item 14"):
            session.train(steps=1, resilience="replay", verbose=False)
    cfg = get_config("zamba2-2.7b", tiny=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        build_model(cfg).apply({}, {})
    with pytest.raises(ValueError, match="zero1"):
        steps.make_ddp_step(get_config("qwen3-4b", tiny=True),
                            steps.Strategy(name="zero1"))
    with pytest.raises(ValueError, match="grad_codec"):
        Plan(device="cpu", ddp=True, grad_codec="int8").compile()
