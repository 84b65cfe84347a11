"""Serve step builders: prefill and decode.

Counterpart: ``repro/core/steps.py:71-72,473-542`` (``_serve_cfg``,
``ServeStep``, ``make_prefill_step``, ``make_decode_step``).  Serving runs
the model with bfloat16 parameters and no rematerialization, as in JAX.
``fn`` is a plain callable: PyTorch runs eagerly, one device, so there is
no jit, mesh or sharding to build.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..models.model import build_model


def _serve_cfg(cfg):
    return dataclasses.replace(cfg, param_dtype="bf16", remat=False)


@dataclasses.dataclass
class ServeStep:
    fn: Any
    model: Any
    specs: Any
    cache_specs: Any


def make_prefill_step(cfg, shape: dict) -> ServeStep:
    """``fn(params, batch) -> (last-token logits, cache)``; the cache is
    padded to ``shape["seq_len"]``."""
    scfg = _serve_cfg(cfg)
    model = build_model(scfg)
    S = shape["seq_len"]

    def fn(params, batch):
        return model.prefill(params, batch, S)

    return ServeStep(fn=fn, model=model, specs=model.specs(),
                     cache_specs=model.cache_specs(shape["global_batch"], S))


def make_decode_step(cfg, shape: dict) -> ServeStep:
    """``fn(params, cache, batch, pos) -> (logits, cache)``.  The cache is
    updated in place and returned: this stands in for JAX's
    ``donate_argnums=(1,)``, so the caller must not reuse the cache it
    passed in as the state before the step."""
    scfg = _serve_cfg(cfg)
    model = build_model(scfg)

    def fn(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos)

    return ServeStep(fn=fn, model=model, specs=model.specs(),
                     cache_specs=model.cache_specs(shape["global_batch"],
                                                   shape["seq_len"]))
