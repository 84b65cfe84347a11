"""The serving slice end to end against the JAX package: prefill and
greedy decode on bridged bf16 serve parameters, and Session.serve's
futurized tree."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import steps as jax_steps
from repro.core.sharding import init_params as jax_init_params
from repro.frontend import Plan as JaxPlan
from repro.launch.mesh import make_local_mesh
from repro.models.model import build_model as build_jax_model
from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.frontend import Plan
from repro_torch.launch import serve as serve_cli

ATOL = 1e-4
PROMPT, GEN, SLOTS = 20, 8, 2


def _jax_serve_params(cfg, seed=0):
    """JAX serve parameters (bf16) with the zero/one-initialized leaves
    (biases, norm weights) drawn at random, so that they are exercised;
    returns the JAX tree and its float32 numpy copy."""
    shape = {"seq_len": PROMPT + GEN, "global_batch": SLOTS, "kind": "prefill"}
    pre = jax_steps.make_prefill_step(cfg, make_local_mesh(),
                                      jax_steps.Strategy(), shape)
    params = jax_init_params(pre.specs, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def to_np(a):
        a = np.asarray(a, np.float32)
        if np.all(a == a.flat[0]):              # a zeros or ones init
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(
                ml_dtypes.bfloat16).astype(np.float32)
        return a
    tree = jax.tree.map(to_np, params)
    return pre, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree), tree


def _stack_cache(cache):
    """The port's cache in the JAX layout: each list level becomes a
    leading dim of the leaves below it; float32 numpy."""
    if isinstance(cache, list):
        return jax.tree.map(lambda *xs: np.stack(xs),
                            *[_stack_cache(c) for c in cache])
    if isinstance(cache, dict):
        return {k: _stack_cache(v) for k, v in cache.items()}
    return cache.float().numpy()


def _assert_cache_close(mine, jcache, *, scaled=False):
    """Every leaf within ATOL; with ``scaled``, within ATOL times the
    leaf's largest magnitude: the JAX zamba model computes the SSD scan in
    chunked form and the port's plain version as the sequential
    recurrence, and float32 sums taken in another order differ by about
    1e-5 of a leaf's scale after its layers."""
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(jflat) == len(jax.tree.leaves(mine))
    for path, want in jflat:
        got = mine
        for p in path:
            got = got[p.key]
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape, path
        atol = ATOL * max(1.0, float(np.abs(want).max())) if scaled else ATOL
        np.testing.assert_allclose(got, want, atol=atol, rtol=ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-3b", "zamba2-2.7b"])
def test_prefill_and_greedy_decode_match_jax(arch):
    cfg = get_config(arch, tiny=True)
    assert cfg.qk_norm or cfg.qkv_bias or cfg.family == "zamba"
    _prefill_and_greedy_decode_match_jax(arch)


# the other ported dense ids (phi3-mini: MHA; mistral-nemo: GQA; neither
# has qk-norm nor a qkv bias; chameleon: GQA with qk-norm), held at the
# same ATOL
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mistral-nemo-12b",
                                  "chameleon-34b"])
def test_prefill_and_greedy_decode_of_other_dense_ids_match_jax(arch):
    _prefill_and_greedy_decode_match_jax(arch)


# the moe ids under both dispatch engines (phi3.5-moe: LayerNorm), at the
# same ATOL
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_prefill_and_greedy_decode_of_moe_ids_match_jax(arch, dispatch):
    _prefill_and_greedy_decode_match_jax(arch, moe_dispatch=dispatch)


def _prefill_and_greedy_decode_match_jax(arch, **overrides):
    """Prefill and GEN greedy decode steps of the tiny config (with
    ``overrides``) on bridged bf16 serve parameters: logits within ATOL
    of the reference's, the same tokens, the cache within ATOL (zamba: of
    its scale)."""
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True), **overrides)
    cfg = dataclasses.replace(get_config(arch, tiny=True), **overrides)
    jpre, jparams, tree = _jax_serve_params(jcfg)
    jdec = jax_steps.make_decode_step(
        jcfg, make_local_mesh(), jax_steps.Strategy(),
        {"seq_len": PROMPT + GEN, "global_batch": SLOTS, "kind": "decode"})
    shape = {"seq_len": PROMPT + GEN, "global_batch": SLOTS}
    pre, dec = steps.make_prefill_step(cfg, shape), \
        steps.make_decode_step(cfg, shape)
    params = params_from_numpy(tree, steps._serve_cfg(cfg), "cpu")
    assert {t.dtype for t in jax.tree.leaves(params)} == {torch.bfloat16}

    toks = np.random.default_rng(1).integers(0, cfg.vocab, (SLOTS, PROMPT))
    jlg, jcache = jpre.fn(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    lg, cache = pre.fn(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                               rtol=ATOL)
    kv = jcache["shared"] if cfg.family == "zamba" else jcache
    assert kv["k"].shape[1:] == (SLOTS, PROMPT + GEN, cfg.n_kv_heads,
                                 cfg.head_dim)
    _assert_cache_close(_stack_cache(cache), jcache,
                        scaled=cfg.family == "zamba")
    # the bridged JAX cache is the same cache
    bridged = _stack_cache(cache_from_numpy(
        jax.tree.map(np.asarray, jcache), steps._serve_cfg(cfg), "cpu"))
    jax.tree.map(np.testing.assert_array_equal, bridged,
                 jax.tree.map(np.asarray, jcache))

    jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
    tok = lg.argmax(-1)[:, None]
    for t in range(GEN):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlg, jcache = jdec.fn(jparams, jcache, {"tokens": jtok},
                              jnp.int32(PROMPT + t))
        lg, cache = dec.fn(params, cache, {"tokens": tok}, PROMPT + t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                                   rtol=ATOL)
        jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
        tok = lg.argmax(-1)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_bridge_rejects_missing_and_leftover_leaves():
    cfg = get_config("qwen3-4b", tiny=True)
    _, _, tree = _jax_serve_params(jax_get_config("qwen3-4b", tiny=True))
    extra = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(extra, cfg, "cpu")
    missing = dict(tree, ln_f={})
    with pytest.raises(KeyError, match="ln_f"):
        params_from_numpy(missing, cfg, "cpu")
    other = steps._serve_cfg(dataclasses.replace(cfg, d_ff=cfg.d_ff * 2))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, other, "cpu")


def test_bridge_carries_the_zamba_tree_and_rejects_leftovers():
    cfg = steps._serve_cfg(get_config("zamba2-2.7b", tiny=True))
    _, _, tree = _jax_serve_params(jax_get_config("zamba2-2.7b", tiny=True))
    params = params_from_numpy(tree, cfg, "cpu")
    groups = cfg.n_layers // cfg.shared_every
    mamba = params["stack"]["mamba"]
    assert [len(g) for g in mamba] == [cfg.shared_every] * groups
    w = tree["stack"]["mamba"]["mixer"]["in_proj"]
    np.testing.assert_array_equal(mamba[1][0]["mixer"]["in_proj"].float(),
                                  w[1, 0])
    np.testing.assert_array_equal(
        params["stack"]["shared"]["attn"]["wq"].float(),
        tree["stack"]["shared"]["attn"]["wq"])
    extra = jax.tree.map(lambda a: a, tree)
    extra["stack"]["mamba"]["mixer"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(extra, cfg, "cpu")
    short = jax.tree.map(lambda a: a, tree)
    short["stack"]["mamba"]["ln"]["w"] = short["stack"]["mamba"]["ln"]["w"][:1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(short, cfg, "cpu")
    cache = jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        build_jax_model(jax_get_config("zamba2-2.7b", tiny=True)).cache_specs(
            SLOTS, PROMPT + GEN),
        is_leaf=lambda x: hasattr(x, "init"))
    mine = cache_from_numpy(cache, cfg, "cpu")
    assert mine["mamba"][1][0]["ssm"].dtype == torch.float32
    assert len(mine["shared"]) == groups
    cache["shared"]["extra"] = cache["shared"]["k"]
    with pytest.raises(ValueError, match="extra"):
        cache_from_numpy(cache, cfg, "cpu")


def _serve_trace_matches_jax(arch):
    kw = dict(requests=5, slots=2, prompt_len=16, gen_len=4, verbose=False)
    with JaxPlan(arch=arch).compile() as session:
        want = session.serve(**kw)
    with Plan(arch=arch, device="cpu").compile() as session:
        got = session.serve(**kw)
    assert got["trace"] == want["trace"]
    assert got["nodes"] == want["nodes"]
    for key in ("tokens", "padded_tokens", "requests"):
        assert got[key] == want[key]
    assert got["waves"] == 3
    assert [g.shape for g in got["generated"]] == [(2, 5)] * 3
    assert torch.isfinite(got["first_prefill_logits"]).all()


def test_session_serve_traces_the_same_tree_as_jax():
    _serve_trace_matches_jax("qwen3-4b")


def test_session_serve_traces_the_same_tree_as_jax_for_zamba():
    _serve_trace_matches_jax("zamba2-2.7b")


def test_serve_cli_on_cpu_writes_its_stats(tmp_path):
    out = tmp_path / "serve.json"
    args = serve_cli.parser().parse_args(
        ["--device", "cpu", "--requests", "3", "--slots", "2",
         "--prompt-len", "8", "--gen-len", "2", "--stats-out", str(out)])
    assert args.tiny and args.arch == "qwen3-4b"
    res = serve_cli.run(args)
    stats = json.loads(out.read_text())
    assert stats["tokens"] == res["tokens"] == 6
    assert stats["padded_tokens"] == 2 and stats["waves"] == 2
    assert serve_cli.parser().parse_args([]).device == "cuda"


def test_serve_cli_runs_the_gateway_drill_and_writes_its_stats(tmp_path):
    """``--serve-stream --replicas 2 --kill-replica-at 0:2``: every request
    completes on the survivor, and the stats file carries the gateway's
    summary keys."""
    out = tmp_path / "stream.json"
    args = serve_cli.parser().parse_args(
        ["--device", "cpu", "--serve-stream", "--replicas", "2",
         "--kill-replica-at", "0:2", "--requests", "5", "--slots", "2",
         "--prompt-len", "16", "--gen-len", "4", "--stats-out", str(out)])
    assert args.replicas == 2 and args.kill_replica_at == "0:2"
    res = serve_cli.run(args)
    stats = json.loads(out.read_text())
    assert set(stats) == {"requests", "completed", "cancelled", "expired",
                          "failed", "rejected", "tokens", "padded_tokens",
                          "tokens_per_s", "rounds", "epochs", "replicas",
                          "replica_assignments", "streams", "cache",
                          "runtime_stats"}
    assert stats["completed"] == res["completed"] == 5
    assert stats["replicas"] == 2 and stats["tokens"] == 5 * 4
    assert set(stats["replica_assignments"].values()) == {1}
    serve = stats["runtime_stats"]["serve"]
    assert serve["replica_deaths"] == 1
    assert serve["cross_replica_page_fetches"] >= 1
    assert serve.get("prefill_recompute", 0) == 0
    assert stats["cache"]["pages_live"] == 0
    with pytest.raises(SystemExit):
        serve_cli._parse_kill_at("0-2")


def test_launch_counts_lose_no_increment_under_threads():
    """Eight threads count launches of every kernel wrapper at once, with
    the interpreter switching threads as often as it can: each count is
    exact."""
    import sys
    import threading

    from repro_torch import kernels
    from repro_torch.kernels import build

    wrappers = (kernels.flash_attention, kernels.flash_attention_bwd,
                kernels.mamba2_chunk_scan, kernels.mamba2_chunk_scan_bwd,
                kernels.onebit_quantize, kernels.onebit_dequantize)
    saved = [w.launches for w in wrappers]
    interval = sys.getswitchinterval()
    n_threads, per_thread = 8, 2000

    def work():
        for _ in range(per_thread):
            for w in wrappers:
                build.count_launch(w)
    try:
        sys.setswitchinterval(1e-6)
        for w in wrappers:
            w.launches = 0
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert [w.launches for w in wrappers] == \
            [n_threads * per_thread] * len(wrappers)
    finally:
        sys.setswitchinterval(interval)
        for w, n in zip(wrappers, saved):
            w.launches = n


def test_plan_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert Plan().device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        Plan().compile()


@pytest.mark.parametrize("field, item", [
    # fabric DDP runs at one locality; across localities it needs the wire
    (dict(localities=2), "item 12"),
    (dict(ddp=True, localities=2), "item 12"),
    (dict(spmd=True), "item 13"), (dict(elastic=True), "item 13"),
    (dict(replicas=2, localities=2), "item 12"), (dict(data=2), "item 14")])
def test_plans_beyond_one_device_name_their_roadmap_item(field, item):
    with pytest.raises(NotImplementedError, match=item):
        Plan(device="cpu", **field).compile()
