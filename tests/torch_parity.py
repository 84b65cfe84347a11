"""Parity helpers shared by the port's family tests (tests/test_torch_xlstm.py
and tests/test_torch_encdec.py): a tiny config's serve steps, loss and
gradients, train steps and serve CLI, the port against the JAX package on
the same bridged parameters and seeded numpy inputs; and the train CLI and
its crash-and-resume drill, the port alone; and world-1 fabric DDP
against the reference's engine (tests/test_torch_train_ddp*.py)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core import steps as jax_steps
from repro.core.sharding import init_params as jax_init_params
from repro.launch.mesh import make_local_mesh
from repro.models.model import build_model as build_jax_model
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.checkpoint import format as ckfmt
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.data.pipeline import stream_for, to_device
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers

ATOL = 1e-4
PROMPT, GEN, SLOTS = 20, 8, 2


def close(got, want, atol=ATOL, rtol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _jax_serve_params(jcfg, seed=0):
    """JAX serve parameters (bf16) with the zero/one-initialized leaves
    moved off their constant; returns (the prefill step, the JAX tree, its
    float32 numpy copy)."""
    shape = {"seq_len": PROMPT + GEN, "global_batch": SLOTS,
             "kind": "prefill"}
    pre = jax_steps.make_prefill_step(jcfg, make_local_mesh(),
                                      jax_steps.Strategy(), shape)
    params = jax_init_params(pre.specs, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(a):
        f = np.asarray(a, np.float32)
        if np.all(f == f.flat[0]):
            f = f + 0.1 * rng.standard_normal(f.shape).astype(np.float32)
        return jnp.asarray(f, a.dtype)
    jparams = jax.tree.map(perturb, params)
    return pre, jparams, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jparams)


def _serve_setup(arch, overrides, frames):
    """The JAX and the port's prefill and decode steps of the tiny config
    with ``overrides``, on the same bridged serve parameters, and one
    batch of seeded numpy prompts (and frames) for each side."""
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True), **overrides)
    cfg = dataclasses.replace(get_config(arch, tiny=True), **overrides)
    jpre, jparams, tree = _jax_serve_params(jcfg)
    shape = {"seq_len": PROMPT + GEN, "global_batch": SLOTS}
    jdec = jax_steps.make_decode_step(jcfg, make_local_mesh(),
                                      jax_steps.Strategy(),
                                      dict(shape, kind="decode"))
    params = params_from_numpy(tree, steps._serve_cfg(cfg), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (SLOTS, PROMPT))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    batch = {"tokens": torch.from_numpy(toks)}
    if frames:
        fr = (0.5 * rng.standard_normal((SLOTS, cfg.enc_frames, cfg.d_model))
              ).astype(np.float32)
        jbatch["frames"] = jnp.asarray(fr, jcfg.c_dtype)
        batch["frames"] = torch.from_numpy(fr).to(cfg.c_dtype)
    return (dict(pre=jpre, dec=jdec, params=jparams, batch=jbatch),
            dict(pre=steps.make_prefill_step(cfg, shape),
                 dec=steps.make_decode_step(cfg, shape), params=params,
                 batch=batch, cfg=steps._serve_cfg(cfg)))


def _jax_steps(j, feed=None):
    """Prefill and GEN decode steps of the JAX side ``j``: greedy, or fed
    the tokens ``feed`` [GEN, SLOTS, 1].  Returns (the logits of each
    step as float32 numpy, the tokens it chose, the prefill's cache as
    numpy, the last cache)."""
    lg, cache = j["pre"].fn(j["params"], j["batch"])
    cache0 = jax.tree.map(np.asarray, cache)
    lgs, toks = [np.asarray(lg, np.float32)], []
    for t in range(GEN):
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32) if feed is None \
            else jnp.asarray(feed[t], jnp.int32)
        toks.append(np.asarray(tok))
        lg, cache = j["dec"].fn(j["params"], cache, {"tokens": tok},
                                jnp.int32(PROMPT + t))
        lgs.append(np.asarray(lg, np.float32))
    return lgs, toks, cache0, cache


def _port_steps(m, feed):
    """The port's prefill and GEN decode steps, fed the tokens ``feed``:
    (its logits, the prefill's cache, the last cache)."""
    lg, cache = m["pre"].fn(m["params"], m["batch"])
    cache0 = jax.tree.map(lambda t: t.clone(), cache)
    lgs = [lg]
    for t in range(GEN):
        lg, cache = m["dec"].fn(m["params"], cache,
                                {"tokens": torch.tensor(feed[t]).long()},
                                PROMPT + t)
        lgs.append(lg)
    return lgs, cache0, cache


def serve_parity(arch, *, frames=False):
    """Prefill and GEN greedy decode steps of the tiny config on bridged
    bf16 serve parameters, port against JAX: each step's logits within
    ATOL, the same greedy tokens, and every leaf of the prefill's cache
    within ATOL.  Returns (the port's prefill cache, the JAX one, the
    port's serve config)."""
    j, m = _serve_setup(arch, {}, frames)
    jlgs, jtoks, jcache, _ = _jax_steps(j)
    lgs, cache, _ = _port_steps(m, jtoks)
    for t, (lg, want) in enumerate(zip(lgs, jlgs)):
        close(lg, want, what=f"step {t}")
        if t < GEN:
            np.testing.assert_array_equal(lg.argmax(-1)[:, None].numpy(),
                                          jtoks[t])
    # each cache leaf within ATOL of its own scale: float32 sums taken in
    # other orders (the encoder's attention: K1's plain version against
    # the reference's chunked form) part by about 1e-5 of a leaf's scale
    mine = tree_to_numpy(cache)
    for path, want in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        got = mine
        for k in path:
            got = got[k.key]
        close(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())),
               what=str(path))
    return cache, jcache, m["cfg"]


# bf16 throughout (parameters, compute, cache).  The two packages round
# the same values in other orders (matmul sums, elementwise chains that
# XLA fuses), and a random tiny model amplifies that, so each family's
# test holds the logits' error at limits set from its own reading.
BF16 = dict(param_dtype="bf16", compute_dtype="bf16", cache_dtype_str="bf16")


def _port_leaves(tree, path) -> list:
    """The port's leaves at a JAX key path: a list level of the port's
    tree is a stacked dim of the JAX leaf, so every item of it."""
    if isinstance(tree, list):
        return [t for item in tree for t in _port_leaves(item, path)]
    if not path:
        return [tree]
    return _port_leaves(tree[path[0].key], path[1:])


def bf16_parity(arch, mean_tol, max_tol, *, frames=False):
    """The tiny config in ``BF16``, both sides fed the reference's greedy
    tokens: every logit and cache leaf in the reference's dtype, and the
    logits' mean |error| within ``mean_tol`` and their largest within
    ``max_tol`` of the largest |logit|.  Returns the two readings as
    shares of that scale."""
    j, m = _serve_setup(arch, BF16, frames)
    jlgs, jtoks, _, jcache = _jax_steps(j)
    lgs, _, cache = _port_steps(m, jtoks)
    assert all(lg.dtype == torch.bfloat16 for lg in lgs)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        assert {str(t.dtype)[6:] for t in _port_leaves(cache, path)} == \
            {str(leaf.dtype)}, path
    want = np.stack(jlgs)
    err = np.abs(np.stack([lg.float().numpy() for lg in lgs]) - want)
    scale = float(np.abs(want).max())
    mean, worst = err.mean() / scale, err.max() / scale
    assert mean <= mean_tol, (mean, mean_tol)
    assert worst <= max_tol, (worst, max_tol)
    return mean, worst


def jax_train_params(jcfg, seed=0):
    """JAX f32 training parameters, zero/one leaves perturbed; (JAX tree,
    numpy copy)."""
    params = jax_init_params(build_jax_model(jcfg).specs(),
                             jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def to_np(a):
        a = np.asarray(a, np.float32)
        if np.all(a == a.flat[0]):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    tree = jax.tree.map(to_np, params)
    return jax.tree.map(jnp.asarray, tree), tree


def loss_and_grads_match(arch, batch, grad_tol):
    """``build_model(cfg).loss`` and its gradients against
    ``jax.value_and_grad`` of the reference's on the same parameters and
    batch: the loss within 1e-5, every gradient within ``grad_tol`` of the
    largest |gradient| over all leaves."""
    jcfg = jax_get_config(arch, tiny=True)
    cfg = get_config(arch, tiny=True)
    jparams, tree = jax_train_params(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(build_jax_model(jcfg).loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = params_from_numpy(tree, cfg, "cpu")
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    model = build_model(cfg)
    loss = model.loss(params, to_device(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    # exactly the parameters the model declares unread (the cross-
    # attention's bk, bv) have no gradient: JAX's is zeros
    assert {id(p) for p in pytree.tree_leaves(params) if p.grad is None} \
        == {id(p) for p in model.unread(params)}
    grads = tree_to_numpy(pytree.tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params))
    scale = max(float(jnp.abs(g).max()) for g in jax.tree.leaves(jgrads))
    for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        got = grads
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got, np.asarray(want),
                                   atol=grad_tol * scale, err_msg=str(path))
    return params


def train_steps_match(arch, opt_kind, rtol, steps_n=6):
    """``steps_n`` steps of make_train_step from bridged init on the
    synthetic stream (with frames for the enc-dec family), port against
    the reference's train step: loss and grad_norm per step within
    ``rtol``."""
    jcfg, cfg = jax_get_config(arch, tiny=True), get_config(arch, tiny=True)
    shape = {"seq_len": 32, "global_batch": 4, "kind": "train"}
    jopt_cfg = dataclasses.replace(jax_steps.Strategy().opt, kind=opt_kind)
    jstep = jax_steps.make_train_step(jcfg, make_local_mesh(),
                                      jax_steps.Strategy(opt=jopt_cfg), shape)
    jparams, jopt = jstep.init(jax.random.PRNGKey(0))
    oc = optimizers.OptConfig(kind=opt_kind)
    step = steps.make_train_step(cfg, steps.Strategy(opt=oc))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    opt = optimizers.init(params, oc)
    stream = stream_for(cfg, batch=4, seq=32, seed=1)
    for it in range(steps_n):
        batch = stream.batch_at(it)
        jm, jparams, jopt = jstep.fn(jparams, jopt,
                                     jax.tree.map(jnp.asarray, batch))
        m, params, opt = step.fn(params, opt, to_device(batch, "cpu"))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"step {it} {k}")


def serve_cli_runs(arch):
    """``launch/serve.py --device cpu --arch`` serves 3 requests in two
    waves of 2 slots."""
    args = serve_cli.parser().parse_args(
        ["--device", "cpu", "--arch", arch, "--requests", "3", "--slots",
         "2", "--prompt-len", "8", "--gen-len", "2"])
    res = serve_cli.run(args)
    assert res["tokens"] == 6 and res["waves"] == 2
    assert res["padded_tokens"] == 2
    assert torch.isfinite(res["first_prefill_logits"]).all()


def train_cli_runs(arch, tmp_path):
    """``launch/train.py --device cpu --arch`` trains 4 steps with adamw
    (the enc-dec family on the stream's frames): finite losses, logged
    every 2 steps, in the ``--stats-out`` summary too."""
    stats = tmp_path / "stats.json"
    out = train_cli.run(train_cli.parser().parse_args([
        "--device", "cpu", "--arch", arch, "--steps", "4", "--batch", "4",
        "--seq", "16", "--log-every", "2", "--stats-out", str(stats)]))
    assert out["step"] == 4 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert json.loads(stats.read_text())["losses"] == out["losses"]
    return out


def _checksums(step_dir) -> list:
    m = ckfmt.load_manifest(step_dir)
    return [leaf["checksum"] for s in m["shards"] for leaf in s["leaves"]]


def resume_is_bit_identical(arch, tmp_path):
    """The crash-and-resume drill of ``launch/train.py`` for ``arch``:
    ``--ckpt-every 3 --fail-at-step 4`` raises after the step-3
    checkpoint; ``--resume`` continues from it to step 6.  Its losses,
    final parameters and step-6 checkpoint (parameters and optimizer
    state, leaf by leaf) equal an uninterrupted run's bit for bit."""
    drill = ["--device", "cpu", "--arch", arch, "--steps", "6", "--batch",
             "4", "--seq", "16", "--log-every", "1", "--ckpt-every", "3"]

    def run(ckpt, *argv):
        return train_cli.run(train_cli.parser().parse_args(
            drill + ["--ckpt", str(ckpt), *argv]))
    ref = run(tmp_path / "straight")
    try:
        run(tmp_path / "drill", "--fail-at-step", "4")
    except RuntimeError as e:
        assert "injected node failure at step 4" in str(e)
    else:
        raise AssertionError("the drill did not fail at step 4")
    assert sorted(p.name for p in (tmp_path / "drill").iterdir()) == [
        "step_00000003"]
    out = run(tmp_path / "drill", "--resume")
    assert out["step"] == 6 and out["losses"] == ref["losses"][3:]
    for a, b in zip(pytree.tree_leaves(out["params"]),
                    pytree.tree_leaves(ref["params"])):
        assert torch.equal(a, b)
    assert _checksums(tmp_path / "drill" / "step_00000006") == \
        _checksums(tmp_path / "straight" / "step_00000006")


def world1_ddp_matches_reference_engine(arch, codec, opt_kind, rtol, *,
                                        batch=4, seq=32):
    """10 steps of DDPEngine.train_step, two shards, one locality, from
    bridged init: loss and grad_norm per step against the reference's
    DDPEngine; the gradient fusion plan the reference's, bucket for bucket
    and entry for entry (zamba: ``stack/mamba/*`` stacked ``[groups,
    shared_every, ...]``, ``stack/shared/*`` unstacked); grad_wire_bytes
    0 and codec_bytes equal."""
    from repro.distrib.collectives import RingAllReduce as JaxRing
    from repro.frontend import Plan as JaxPlan
    from repro.frontend.ddp import DDPEngine as JaxDDPEngine
    from repro_torch.distrib.collectives import RingAllReduce
    from repro_torch.frontend import Plan
    from repro_torch.frontend.ddp import DDPEngine
    kw = dict(arch=arch, tiny=True, batch=batch, seq=seq, ddp=True,
              grad_codec=codec, ddp_shards=2)
    jstrategy = jax_steps.Strategy(opt=dataclasses.replace(
        jax_steps.Strategy().opt, kind=opt_kind))
    jeng = JaxDDPEngine(JaxPlan(**kw, strategy=jstrategy), JaxRing(None, 1))
    jparams, jopt = jeng.init()
    oc = optimizers.OptConfig(kind=opt_kind)
    eng = DDPEngine(Plan(**kw, strategy=steps.Strategy(opt=oc),
                         device="cpu"), RingAllReduce(None, 1))
    cfg = get_config(arch, tiny=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    opt = optimizers.init(params, oc)
    mine, ref = eng.grad_plan, jeng.step.grad_plan
    assert mine.n_leaves == ref.n_leaves
    assert [(b.total, b.padded) for b in mine.buckets] == \
        [(b.total, b.padded) for b in ref.buckets]
    for b, rb in zip(mine.buckets, ref.buckets):
        assert [(e.index, e.shape, e.size, e.offset) for e in b.entries] == \
            [(e.index, e.shape, e.size, e.offset) for e in rb.entries]
    assert eng.codec_bytes == jeng.codec_bytes
    stream = stream_for(cfg, batch=batch, seq=seq, seed=2)
    for it in range(10):
        b = stream.batch_at(it)
        jm, jparams, jopt = jeng.train_step(it, b, jparams, jopt)
        m, params, opt = eng.train_step(it, b, params, opt)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"step {it} {k}")
    assert eng.ring.wire_bytes == jeng.ring.wire_bytes == 0
