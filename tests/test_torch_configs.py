"""The port's configs and parameter specs against the JAX package's."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.sharding import ParamSpec as JaxParamSpec
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import PENDING, REGISTRY, get_config
from repro_torch.core.sharding import is_spec
from repro_torch.models.model import LM, build_model

DENSE = sorted(REGISTRY)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if "torch" in str(dt) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_config_equals_jax_field_for_field(arch, tiny):
    ours, ref = get_config(arch, tiny=tiny), jax_get_config(arch, tiny=tiny)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("p_dtype", "c_dtype", "cache_dtype"):
        assert _dtype_name(getattr(ours, prop)) == \
            _dtype_name(getattr(ref, prop))


@pytest.mark.parametrize("arch", sorted(PENDING))
def test_unported_arch_ids_name_their_roadmap_item(arch):
    jax_get_config(arch)                       # the reference has it
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        get_config(arch)


@pytest.mark.parametrize("family", ["moe", "xlstm", "zamba", "encdec"])
def test_unported_families_raise(family):
    cfg = dataclasses.replace(get_config("qwen3-4b", tiny=True), family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        build_model(cfg)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_specs_match_jax_leaf_for_leaf(arch, tiny):
    cfg = get_config(arch, tiny=tiny)
    ours = LM(cfg).specs()
    ref = jax_build_model(jax_get_config(arch, tiny=tiny)).specs()
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    assert len(ours["stack"]) == cfg.n_layers
    seen = 0
    for path, js in ref_leaves:
        keys = [p.key for p in path]
        if keys[0] == "stack":
            specs = [layer for layer in ours["stack"]]
            for k in keys[1:]:
                specs = [s[k] for s in specs]
            assert js.shape == (cfg.n_layers,) + specs[0].shape, keys
            assert js.dims == ("layers",) + specs[0].dims, keys
            mine = specs[0]
        else:
            mine = ours
            for k in keys:
                mine = mine[k]
            assert mine.shape == js.shape and mine.dims == js.dims, keys
        assert is_spec(mine)
        assert (mine.init, mine.scale) == (js.init, js.scale), keys
        assert _dtype_name(mine.dtype) == _dtype_name(js.dtype), keys
        seen += 1
    n_ours = sum(1 for k, v in ours.items() if k != "stack"
                 for _ in v.values())
    n_ours += sum(len(v) for v in ours["stack"][0].values())
    assert seen == n_ours
