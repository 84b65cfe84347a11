"""Architecture assembly: the decoder LM of the dense, moe and zamba
families.

Counterpart: ``repro/models/model.py`` (``LM`` for ``family`` ``"dense"``,
``"moe"`` and ``"zamba"``: ``specs``, ``cache_specs``, ``prefill``,
``decode_step``, ``apply``, ``loss``; ``_backbone``).  The JAX
model stacks every layer's parameters under ``"stack"`` with leading
layer dims and runs ``lax.scan`` over them; here the stacked dims become
nested lists and the scans Python loops:

- dense and moe: ``"stack"`` is a list of per-layer dicts (a moe layer
  holds ``"moe"`` in place of ``"mlp"``), the cache a list of per-layer
  ``{"k", "v"}`` dicts;
- zamba: ``"stack"`` is ``{"mamba": [[per-layer dict] x shared_every] x
  groups, "shared": one transformer-block dict}``; each group runs its
  mamba layers, then the shared block, which writes that group's own KV
  cache.  The cache is ``{"mamba": [[{"ssm", "conv"}] x shared_every] x
  groups, "shared": [{"k", "v"}] x groups}``.

``apply`` (training) runs every family, as ``_backbone`` does: the dense
and moe layers in order, summing the moe layers' aux (load-balance)
losses; zamba's groups in order, each its mamba layers
(``mamba_block_apply``) and then the shared block.  With ``cfg.remat``
the counterpart of ``_maybe_remat``'s ``jax.checkpoint`` is
``torch.utils.checkpoint`` (non-reentrant), at the reference's levels:
each dense or moe layer, its aux included; each mamba layer, and each
zamba group around them (the activations are recomputed in the backward
pass).

Contract:
  m = build_model(cfg)
  m.specs()                                  ParamSpec tree
  m.apply(params, batch)                  -> (logits, aux)     train fwd
  m.loss(params, batch)                   -> scalar
  m.cache_specs(batch, cache_len)            ParamSpec tree (zeros init)
  m.prefill(params, batch, cache_len)     -> (last logits, cache)
  m.decode_step(params, cache, batch, pos)-> (logits, cache)
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..core.sharding import is_spec
from . import blocks, layers

FAMILIES = ("dense", "moe", "zamba")
# family -> the ROADMAP item that ports it
_PENDING_FAMILIES = {"xlstm": "ROADMAP item 11", "encdec": "ROADMAP item 11"}


class LM:
    """Decoder-only LM of the dense, moe and zamba families."""

    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} comes with "
                f"{_PENDING_FAMILIES.get(cfg.family, 'a later ROADMAP item')}")
        self.cfg = cfg

    def _groups(self) -> int:
        return self.cfg.n_layers // self.cfg.shared_every

    def specs(self) -> dict:
        cfg = self.cfg
        sp = {
            "embed": layers.embed_specs(cfg.vocab, cfg.d_model),
            "ln_f": layers.norm_specs(cfg.d_model, cfg.norm),
            "unembed": layers.unembed_specs(cfg.d_model, cfg.vocab),
        }
        if cfg.family in ("dense", "moe"):
            sp["stack"] = [blocks.tblock_specs(cfg,
                                               use_moe=cfg.family == "moe")
                           for _ in range(cfg.n_layers)]
        else:
            sp["stack"] = {
                "mamba": [[blocks.mamba_block_specs(cfg)
                           for _ in range(cfg.shared_every)]
                          for _ in range(self._groups())],
                "shared": blocks.tblock_specs(cfg),
            }
        return pytree.tree_map(
            lambda s: dataclasses.replace(s, dtype=cfg.p_dtype)
            if s.dtype.is_floating_point else s, sp, is_leaf=is_spec)

    def _remat(self, fn, *args, **kwargs):
        if self.cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return fn(*args, **kwargs)

    def _mamba_group(self, x, group, shared):
        """One zamba group: its mamba layers, then the shared block."""
        cfg = self.cfg
        for p in group:
            x = self._remat(blocks.mamba_block_apply, x, p, cfg,
                            chunk=cfg.ssm_chunk)
        return blocks.tblock_apply(x, shared, cfg)[0]

    def apply(self, params, batch):
        """The training forward: (logits [B, S, vocab] in the compute
        dtype, aux loss: the moe layers' sum, 0 for the other families)."""
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"]).to(cfg.c_dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("dense", "moe"):
            for p in params["stack"]:
                x, a = self._remat(blocks.tblock_apply, x, p, cfg)
                aux = aux + a
        else:
            shared = params["stack"]["shared"]
            for group in params["stack"]["mamba"]:
                x = self._remat(self._mamba_group, x, group, shared)
        x = layers.apply_norm(x, params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"]), aux

    def loss(self, params, batch):
        lg, aux = self.apply(params, batch)
        return layers.softmax_xent(lg, batch["labels"], batch.get("mask")) \
            + self.cfg.aux_weight * aux

    def cache_specs(self, batch: int, cache_len: int):
        cfg = self.cfg
        if cfg.family in ("dense", "moe"):
            return [blocks.kv_cache_specs(cfg, batch, cache_len)
                    for _ in range(cfg.n_layers)]
        return {
            "mamba": [[blocks.mamba_state_specs(cfg, batch)
                       for _ in range(cfg.shared_every)]
                      for _ in range(self._groups())],
            "shared": [blocks.kv_cache_specs(cfg, batch, cache_len)
                       for _ in range(self._groups())],
        }

    def prefill(self, params, batch, cache_len: int):
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"]).to(cfg.c_dtype)
        if cfg.family in ("dense", "moe"):
            cache = []
            for p in params["stack"]:
                x, c = blocks.tblock_prefill(x, p, cfg, cache_len)
                cache.append(c)
        else:
            shared = params["stack"]["shared"]
            cache = {"mamba": [], "shared": []}
            for group in params["stack"]["mamba"]:
                states = []
                for p in group:
                    x, st = blocks.mamba_block_prefill(x, p, cfg,
                                                       chunk=cfg.ssm_chunk)
                    states.append(st)
                x, c = blocks.tblock_prefill(x, shared, cfg, cache_len)
                cache["mamba"].append(states)
                cache["shared"].append(c)
        x = layers.apply_norm(x[:, -1:], params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"])[:, 0], cache

    def decode_step(self, params, cache, batch, pos):
        """batch["tokens"]: [B, 1]; pos: scalar int, or a ``[B]`` tensor of
        per-row positions (the mamba blocks ignore it).  Updates the KV
        caches in place."""
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"]).to(cfg.c_dtype)
        if cfg.family in ("dense", "moe"):
            new_cache = []
            for p, c in zip(params["stack"], cache):
                x, c = blocks.tblock_decode(x, p, cfg, c, pos)
                new_cache.append(c)
        else:
            shared = params["stack"]["shared"]
            new_cache = {"mamba": [], "shared": []}
            for group, states, kv in zip(params["stack"]["mamba"],
                                         cache["mamba"], cache["shared"]):
                new_states = []
                for p, st in zip(group, states):
                    x, st = blocks.mamba_block_decode(x, p, cfg, st, pos)
                    new_states.append(st)
                x, kv = blocks.tblock_decode(x, shared, cfg, kv, pos)
                new_cache["mamba"].append(new_states)
                new_cache["shared"].append(kv)
        x = layers.apply_norm(x, params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"])[:, 0], new_cache


def build_model(cfg) -> LM:
    """The model for ``cfg``; raises ``NotImplementedError`` for a family
    that is not ported yet (``EncDec`` included)."""
    return LM(cfg)
