"""Pre-norm residual transformer block of the dense family: specs, prefill
(returns the populated KV cache) and single-token decode.

Counterpart: ``repro/models/blocks.py`` (``tblock_specs``,
``kv_cache_specs``, ``tblock_prefill``, ``tblock_decode``) without the
cross-attention and MoE variants, and without the recurrent blocks, which
come with ROADMAP items 10 and 11.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sharding import ParamSpec
from . import attention, layers


def tblock_specs(cfg) -> dict:
    return {
        "ln_attn": layers.norm_specs(cfg.d_model, cfg.norm),
        "attn": attention.attn_specs(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
        "ln_mlp": layers.norm_specs(cfg.d_model, cfg.norm),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_kind),
    }


def kv_cache_specs(cfg, batch: int, seq: int) -> dict:
    """One layer's cache: {"k", "v"} [batch, seq, Hkv, hd] in cache dtype."""
    mk = lambda: ParamSpec((batch, seq, cfg.n_kv_heads, cfg.head_dim),  # noqa: E731
                           ("batch", "kv_seq", "kv_heads", "head_dim"),
                           dtype=cfg.cache_dtype, init="zeros")
    return {"k": mk(), "v": mk()}


def _out_proj(o, wo, dt):
    return torch.einsum("bqhk,hkd->bqd", o, wo.to(dt))


def tblock_prefill(x, p, cfg, cache_len: int):
    """Run the block over a full prompt, returning (x, kv-cache cast to
    the cache dtype and padded to cache_len)."""
    h = layers.apply_norm(x, p["ln_attn"], cfg.norm)
    q, k, v = attention.project_qkv(
        h, p["attn"], rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    o = attention.attend(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + _out_proj(o, p["attn"]["wo"], x.dtype)
    pad = cache_len - k.shape[1]
    cache = {"k": F.pad(k.to(cfg.cache_dtype), (0, 0, 0, 0, 0, pad)),
             "v": F.pad(v.to(cfg.cache_dtype), (0, 0, 0, 0, 0, pad))}
    h = layers.apply_norm(x, p["ln_mlp"], cfg.norm)
    return x + layers.apply_mlp(h, p["mlp"], cfg.mlp_kind), cache


def tblock_decode(x, p, cfg, cache, pos):
    """x: [B,1,D]; cache: {"k","v"} [B,S,Hkv,hd], updated in place; pos:
    scalar int, or a ``[B]`` tensor of per-row positions."""
    h = layers.apply_norm(x, p["ln_attn"], cfg.norm)
    if isinstance(pos, torch.Tensor) and pos.dim():
        positions = pos.to(x.device)[:, None]
    else:
        positions = torch.full((h.shape[0], 1), int(pos), device=x.device)
    q, k, v = attention.project_qkv(
        h, p["attn"], positions=positions,
        rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    kc, vc = attention.cache_update(cache["k"], cache["v"], k, v, pos,
                                    mode=cfg.cache_update)
    o = attention.decode_attend(q, kc, vc, pos, window=cfg.sliding_window)
    x = x + _out_proj(o, p["attn"]["wo"], x.dtype)
    h = layers.apply_norm(x, p["ln_mlp"], cfg.norm)
    return x + layers.apply_mlp(h, p["mlp"], cfg.mlp_kind), {"k": kc, "v": vc}
