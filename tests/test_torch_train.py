"""The training slices against the JAX package: the loss and every
parameter gradient of the dense ids and zamba2-2.7b, a 20-step train
trajectory (world-1 fabric DDP is tests/test_torch_train_ddp*.py), the
Session/launcher surface on the CPU, and the crash-and-resume drill
through ``launch/train.py``."""
import dataclasses
import json
import shutil

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
from repro.launch import train as jax_train_cli
from repro.launch.mesh import make_local_mesh
from repro.models import layers as jax_layers
from repro.models.model import build_model as build_jax_model
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.checkpoint import format as ckfmt
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.data.pipeline import LMStream, to_device
from repro_torch.frontend import Plan
from repro_torch.frontend.ddp import shard_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers
import torch_threads

torch_threads.apply()

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
    ("phi3-mini-3.8b", 1e-4),
    # no qk-norm either: held as qwen2.5-3b
    ("mistral-nemo-12b", 5e-4),
    ("chameleon-34b", 1e-4),
    # the reference computes the SSD scan in chunks, the port's plain
    # version step by step over 32 positions and 4 layers: each float32
    # implementation lies up to 3.2e-4 of max |grad| from a float64 run of
    # the port (the embedding rows), so they are held to 1e-3 of each other
    ("zamba2-2.7b", 1e-3),
])
def test_loss_and_gradients_match_jax(arch, grad_tol):
    """The loss, and every gradient within ``grad_tol`` of the largest
    |gradient| over all leaves.  zamba's leaves span three decades (A_log's
    and dt_bias's largest |gradient| is 1/550 and 1/250 of the
    embedding's), so each
    of its leaves is also held within ``grad_tol`` of its own largest
    |gradient|."""
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
        want = np.asarray(want)
        np.testing.assert_allclose(_get(grads, path), want,
                                   atol=grad_tol * scale, err_msg=str(path))
        if cfg.family == "zamba":
            np.testing.assert_allclose(
                _get(grads, path), want, rtol=0,
                atol=grad_tol * np.abs(want).max(), err_msg=str(path))


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


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_remat_gives_identical_loss_and_gradients(arch):
    """Remat on and off give the same bits (zamba: remat at both levels,
    each mamba layer and each group)."""
    cfg = get_config(arch, tiny=True)
    _, tree = _jax_params(jax_get_config(arch, tiny=True))
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


def test_zamba_nested_remat_recomputes_each_forward(monkeypatch):
    """Under remat a zamba step runs each mamba layer's scan three times
    (the forward, its group's recompute, its own recompute) and the shared
    block's attention twice a group, each backward once: the launch counts
    chip_smoke.py asserts on the card.  Counted on the CPU by wrapping the
    two calls the kernels sit behind."""
    from repro_torch.models import attention, ssm
    calls = {"scan": 0, "attn": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(ssm, "mamba2_chunk_scan",
                        counted("scan", ssm.mamba2_chunk_scan))
    monkeypatch.setattr(attention, "flash_attention",
                        counted("attn", attention.flash_attention))
    cfg = get_config("zamba2-2.7b", tiny=True)
    assert cfg.remat
    _, tree = _jax_params(jax_get_config("zamba2-2.7b", tiny=True))
    loss = build_model(cfg).loss(_port_params(tree, cfg),
                                 to_device(_batch(cfg), "cpu"))
    groups = cfg.n_layers // cfg.shared_every
    assert calls == {"scan": cfg.n_layers, "attn": groups}
    loss.backward()
    assert calls == {"scan": 3 * cfg.n_layers, "attn": 2 * groups}


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


def test_ddp_grad_fn_frees_the_gradients_it_packs():
    cfg = get_config("qwen3-4b", tiny=True)
    step = steps.make_ddp_step(cfg, steps.Strategy())
    params, _ = step.init(torch.Generator().manual_seed(0), "cpu")
    loss, bufs = step.grad_fn(params, to_device(_batch(cfg), "cpu"))
    assert all(p.grad is None for p in pytree.tree_leaves(params))
    assert [b.numel() for b in bufs] == [b.size for b in
                                         step.grad_plan.buckets]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


@pytest.mark.parametrize("kind, extra", [("train", {}),
                                         ("train", {"grad_accum": 2}),
                                         ("ddp", {})])
def test_a_parameter_cut_from_the_graph_raises(kind, extra):
    """Only the leaves a model declares unread (``model.unread``) may end a
    backward pass without a gradient: a leaf the loss was cut from raises
    in the train step, with gradient accumulation, and in the DDP step."""
    cfg = get_config("qwen3-4b", tiny=True)
    strategy = steps.Strategy(**extra)
    step = (steps.make_train_step if kind == "train" else
            steps.make_ddp_step)(cfg, strategy)
    params, opt = step.init(torch.Generator().manual_seed(0), "cpu")
    loss = step.model.loss
    step.model.loss = lambda p, b: loss(
        dict(p, ln_f={k: v.detach() for k, v in p["ln_f"].items()}), b)
    batch = to_device(_batch(cfg), "cpu")
    with pytest.raises(RuntimeError, match="got no gradient"):
        if kind == "train":
            step.fn(params, opt, batch)
        else:
            step.grad_fn(params, batch)


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


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b",
                                  "granite-moe-1b-a400m"])
def test_launch_train_run_on_the_cpu(tmp_path, arch):
    stats = tmp_path / "stats.json"
    args = train_cli.parser().parse_args([
        "--arch", arch, "--device", "cpu", "--steps", "4", "--batch", "4",
        "--seq", "16",
        "--log-every", "2", "--ddp", "--grad-codec", "onebit",
        "--ddp-shards", "2", "--stats-out", str(stats)])
    out = train_cli.run(args)
    saved = json.loads(stats.read_text())
    assert saved["step"] == 4 and len(saved["losses"]) == 2
    assert saved["grad_wire_bytes"] == 0
    assert saved["codec_bytes"] == out["codec_bytes"]


@pytest.mark.parametrize("argv, match", [
    # item 14b's part 6: sequence parallelism beside fabric DDP on a model
    # axis (a model group of two rank processes), and SPMD mode with a
    # data axis (a mesh world of two ranks for each of two localities)
    (["--model", "2", "--seq-parallel", "--arch", "zamba2-2.7b", "--ddp"],
     "item 14b"),
    (["--data", "2", "--spmd", "--localities", "2"], "item 14b"),
])
def test_launch_train_raises_for_what_the_port_does_not_run(argv, match):
    """What raised before item 14b's part 6 now runs one step through
    the CLI: the DDP run's wire is world 1's (0 bytes, the codec's
    buckets those of the reference's global plan), and the SPMD run's
    other locality ends at the same step on its own mesh."""
    args = train_cli.parser().parse_args(
        ["--device", "cpu", "--steps", "1", "--batch", "4", "--seq", "16",
         "--log-every", "1", *argv])
    out = train_cli.run(args)
    assert out["step"] == 1 and np.isfinite(out["final_loss"])
    if "--ddp" in argv:
        assert out["grad_wire_bytes"] == 0 and out["codec_bytes"] > 0
        assert out["ranks"][1]["final_loss"] == out["final_loss"]
    else:
        assert out["localities"][1]["final_loss"] == out["final_loss"]
        assert out["localities"][1]["step"] == 1


def test_not_implemented_surface():
    # xlstm and onebit run on a model axis, beside fabric DDP too; the
    # production meshes still raise (item 15)
    with pytest.raises(NotImplementedError, match="item 15"):
        Plan(device="cpu", model=2, arch="xlstm-350m", strategy="onebit",
             ddp=True, mesh="single").compile()
    with Plan(device="cpu").compile() as session:
        with pytest.raises(ValueError, match="resilience"):
            session.train(steps=1, resilience="retry", verbose=False)
    with pytest.raises(ValueError, match="zero1"):
        steps.make_ddp_step(get_config("qwen3-4b", tiny=True),
                            steps.Strategy(name="zero1"))
    with pytest.raises(ValueError, match="grad_codec"):
        Plan(device="cpu", ddp=True, grad_codec="int8").compile()


# -- checkpoints and the crash-and-resume drill --------------------------------

DRILL = ["--device", "cpu", "--steps", "8", "--batch", "4", "--seq", "16",
         "--log-every", "2", "--ckpt-every", "4"]
DRILL_DDP = {"plain": [], "ddp-fp32": ["--ddp", "--grad-codec", "fp32",
                                      "--ddp-shards", "2"]}


def _checksums(step_dir) -> list:
    """Every leaf checksum of a committed checkpoint, in leaf order."""
    m = ckfmt.load_manifest(step_dir)
    return [leaf["checksum"] for s in m["shards"] for leaf in s["leaves"]]


@pytest.mark.parametrize("mode", sorted(DRILL_DDP))
def test_crash_and_resume_is_bit_identical_to_an_uninterrupted_run(
        tmp_path, mode):
    """``--ckpt --ckpt-every 4 --fail-at-step 6`` raises after the step-4
    checkpoint; ``--resume`` continues from it to step 8.  Its losses, its
    final parameters and the step-8 checkpoint (parameters and optimizer
    state, leaf by leaf) are bit-identical to an uninterrupted run's."""
    extra = DRILL_DDP[mode]

    def run(ckpt, *argv):
        return train_cli.run(train_cli.parser().parse_args(
            DRILL + extra + ["--ckpt", str(ckpt), *argv]))
    ref = run(tmp_path / "straight")
    with pytest.raises(RuntimeError, match="injected node failure at step 6"):
        run(tmp_path / "drill", "--fail-at-step", "6")
    assert sorted(p.name for p in (tmp_path / "drill").iterdir()) == [
        "step_00000004"]
    out = run(tmp_path / "drill", "--resume", "--fail-at-step", "6")
    assert out["step"] == 8
    assert out["losses"] == ref["losses"][2:]
    assert out["final_loss"] == ref["final_loss"]
    for a, b in zip(pytree.tree_leaves(out["params"]),
                    pytree.tree_leaves(ref["params"])):
        assert torch.equal(a, b)
    assert _checksums(tmp_path / "drill" / "step_00000008") == \
        _checksums(tmp_path / "straight" / "step_00000008")


def test_resumed_onebit_ddp_matches_the_jax_packages_resumed_run(tmp_path):
    """The JAX package's world-1 onebit DDP drill fails after its step-4
    checkpoint and resumes; the port resumes from a copy of that same
    checkpoint.  Both restart the codec's error-feedback residual at zero
    (it is not part of the checkpoint), and the resumed losses agree
    within the onebit tolerance of the world-1 DDP test (1e-3)."""
    argv = ["--steps", "8", "--batch", "4", "--seq", "16", "--log-every",
            "1", "--ckpt-every", "4", "--ddp", "--grad-codec", "onebit",
            "--ddp-shards", "2", "--ckpt", str(tmp_path / "jax")]
    with pytest.raises(RuntimeError, match="injected node failure"):
        jax_train_cli.run(jax_train_cli.parser().parse_args(
            argv + ["--fail-at-step", "6"]))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jout = jax_train_cli.run(jax_train_cli.parser().parse_args(
        argv + ["--resume"]))
    argv[argv.index(str(tmp_path / "jax"))] = str(tmp_path / "port")
    out = train_cli.run(train_cli.parser().parse_args(
        argv + ["--device", "cpu", "--resume"]))
    assert len(out["losses"]) == len(jout["losses"]) == 4
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-3)


class _CkptHooks:
    def __init__(self):
        self.saves = []

    def on_checkpoint(self, step, future):
        self.saves.append((step, future))


def test_session_train_calls_on_checkpoint_and_saves_the_last_step(
        tmp_path):
    hooks = _CkptHooks()
    with Plan(batch=BATCH, seq=SEQ, device="cpu").compile() as session:
        out = session.train(steps=5, ckpt_dir=str(tmp_path), ckpt_every=2,
                            hooks=hooks, verbose=False)
    assert out["step"] == 5
    assert [s for s, _ in hooks.saves] == [2, 4]
    assert [f.result().name for _, f in hooks.saves] == [
        "step_00000002", "step_00000004"]
    # the final snapshot lands too; keep=3 holds the three latest
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004", "step_00000005"]
    assert ckfmt.load_manifest(tmp_path / "step_00000005")["meta"] == {
        "arch": "qwen3-4b"}


def test_resume_at_or_past_the_last_step_has_nothing_to_do(tmp_path):
    plan = Plan(batch=BATCH, seq=SEQ, device="cpu")
    with plan.compile() as session:
        session.train(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                      verbose=False)
    with plan.compile() as session:
        out = session.train(steps=3, ckpt_dir=str(tmp_path), ckpt_every=2,
                            resume=True, verbose=False)
    assert out["step"] == 4 and np.isnan(out["final_loss"])
    assert out["losses"] == []
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
