"""The port's configs and parameter specs against the JAX package's."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.sharding import ParamSpec as JaxParamSpec
from repro.models.model import build_model as jax_build_model
from repro.configs import REGISTRY as JAX_REGISTRY
from repro_torch.configs import ARCH_IDS, REGISTRY, get_config
from repro_torch.core.sharding import is_spec
from repro_torch.models.model import EncDec, LM, build_model
import torch_threads

torch_threads.apply()

PORTED = sorted(REGISTRY)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if "torch" in str(dt) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_jax_field_for_field(arch, tiny):
    ours, ref = get_config(arch, tiny=tiny), jax_get_config(arch, tiny=tiny)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("p_dtype", "c_dtype", "cache_dtype"):
        assert _dtype_name(getattr(ours, prop)) == \
            _dtype_name(getattr(ref, prop))


def test_every_reference_arch_is_ported():
    assert sorted(REGISTRY) == ARCH_IDS == sorted(JAX_REGISTRY)


@pytest.mark.parametrize("arch", PORTED)
def test_build_model_picks_the_reference_class(arch):
    cfg = get_config(arch, tiny=True)
    want = type(jax_build_model(jax_get_config(arch, tiny=True))).__name__
    model = build_model(cfg)
    assert type(model).__name__ == want
    assert isinstance(model, EncDec if cfg.family == "encdec" else LM)


def _unstack(node, stacked=()):
    """Descend through the list levels that stand for JAX's stacked layer
    dims (every element alike); returns (their lengths, the node)."""
    while isinstance(node, list):
        assert all(n == node[0] for n in node)
        stacked += (len(node),)
        node = node[0]
    return stacked, node


def _n_leaves(node) -> int:
    node = _unstack(node)[1]
    if isinstance(node, dict):
        return sum(_n_leaves(v) for v in node.values())
    return 1


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_specs_match_jax_leaf_for_leaf(arch, tiny):
    cfg = get_config(arch, tiny=tiny)
    ours = build_model(cfg).specs()
    ref = jax_build_model(jax_get_config(arch, tiny=tiny)).specs()
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    if cfg.family in ("dense", "moe"):
        assert len(ours["stack"]) == cfg.n_layers
    elif cfg.family == "xlstm":
        groups = cfg.n_layers // cfg.slstm_every
        assert _unstack(ours["stack"]["m"])[0] == (groups,
                                                    cfg.slstm_every - 1)
        assert _unstack(ours["stack"]["s"])[0] == (groups,)
    elif cfg.family == "encdec":
        assert _unstack(ours["enc_stack"])[0] == (cfg.n_enc_layers,)
        assert _unstack(ours["dec_stack"])[0] == (cfg.n_layers,)
    else:
        groups = cfg.n_layers // cfg.shared_every
        assert _unstack(ours["stack"]["mamba"])[0] == (groups,
                                                        cfg.shared_every)
    for path, js in ref_leaves:
        keys = [p.key for p in path]
        mine, stacked = ours, ()
        for k in keys:
            stacked, mine = _unstack(mine, stacked)
            mine = mine[k]
        assert is_spec(mine), keys
        assert js.shape == stacked + mine.shape, keys
        assert js.dims == ("layers",) * len(stacked) + mine.dims, keys
        assert (mine.init, mine.scale) == (js.init, js.scale), keys
        assert _dtype_name(mine.dtype) == _dtype_name(js.dtype), keys
    assert len(ref_leaves) == _n_leaves(ours)


@pytest.mark.parametrize("arch", PORTED)
def test_cache_specs_match_jax_leaf_for_leaf(arch):
    """The decode cache's specs (KV caches, recurrent states, the enc-dec
    cross K/V): shapes, dims (the batch dim named, which the gateway's
    row writes find) and dtypes, the port's list levels standing for the
    reference's stacked dims."""
    cfg = get_config(arch, tiny=True)
    ours = build_model(cfg).cache_specs(3, 24)
    ref = jax_build_model(jax_get_config(arch, tiny=True)).cache_specs(3, 24)
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    for path, js in ref_leaves:
        keys = [p.key for p in path]
        mine, stacked = ours, ()
        for k in keys:
            stacked, mine = _unstack(mine, stacked)
            mine = mine[k]
        stacked, mine = _unstack(mine, stacked)
        assert is_spec(mine), keys
        assert js.shape == stacked + mine.shape, keys
        assert js.dims == ("layers",) * len(stacked) + mine.dims, keys
        assert "batch" in mine.dims and mine.init == js.init == "zeros", keys
        assert _dtype_name(mine.dtype) == _dtype_name(js.dtype), keys
    assert len(ref_leaves) == _n_leaves(ours)
