"""Architecture assembly: the dense decoder LM.

Counterpart: ``repro/models/model.py`` (``LM`` for ``family == "dense"``:
``specs``, ``cache_specs``, ``prefill``, ``decode_step``).  The JAX model
stacks every layer's parameters under ``"stack"`` with a leading
``layers`` dim and runs ``lax.scan`` over them; here ``"stack"`` is a list
of per-layer dicts and the scan is a Python loop.  The KV cache is a list
of per-layer ``{"k", "v"}`` dicts in the same way.

Contract:
  m = build_model(cfg)
  m.specs()                                  ParamSpec tree
  m.cache_specs(batch, cache_len)            ParamSpec tree (zeros init)
  m.prefill(params, batch, cache_len)     -> (last logits, cache)
  m.decode_step(params, cache, batch, pos)-> (logits, cache)
"""
from __future__ import annotations

import dataclasses

import torch.utils._pytree as pytree

from ..core.sharding import is_spec
from . import blocks, layers

# family -> the ROADMAP item that ports it
_PENDING_FAMILIES = {"moe": "ROADMAP item 10", "xlstm": "ROADMAP item 11",
                     "zamba": "ROADMAP item 11", "encdec": "ROADMAP item 11"}


class LM:
    """Decoder-only LM of the dense family."""

    def __init__(self, cfg):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} comes with "
                f"{_PENDING_FAMILIES.get(cfg.family, 'a later ROADMAP item')}")
        self.cfg = cfg

    def specs(self) -> dict:
        cfg = self.cfg
        sp = {
            "embed": layers.embed_specs(cfg.vocab, cfg.d_model),
            "ln_f": layers.norm_specs(cfg.d_model, cfg.norm),
            "unembed": layers.unembed_specs(cfg.d_model, cfg.vocab),
            "stack": [blocks.tblock_specs(cfg) for _ in range(cfg.n_layers)],
        }
        return pytree.tree_map(
            lambda s: dataclasses.replace(s, dtype=cfg.p_dtype)
            if s.dtype.is_floating_point else s, sp, is_leaf=is_spec)

    def cache_specs(self, batch: int, cache_len: int) -> list:
        return [blocks.kv_cache_specs(self.cfg, batch, cache_len)
                for _ in range(self.cfg.n_layers)]

    def prefill(self, params, batch, cache_len: int):
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"]).to(cfg.c_dtype)
        cache = []
        for p in params["stack"]:
            x, c = blocks.tblock_prefill(x, p, cfg, cache_len)
            cache.append(c)
        x = layers.apply_norm(x[:, -1:], params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"])[:, 0], cache

    def decode_step(self, params, cache, batch, pos):
        """batch["tokens"]: [B, 1]; pos: scalar int, or a ``[B]`` tensor of
        per-row positions.  Updates ``cache`` in place."""
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"]).to(cfg.c_dtype)
        new_cache = []
        for p, c in zip(params["stack"], cache):
            x, c = blocks.tblock_decode(x, p, cfg, c, pos)
            new_cache.append(c)
        x = layers.apply_norm(x, params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"])[:, 0], new_cache


def build_model(cfg) -> LM:
    """The model for ``cfg``; raises ``NotImplementedError`` for a family
    that is not ported yet (``EncDec`` included)."""
    return LM(cfg)
