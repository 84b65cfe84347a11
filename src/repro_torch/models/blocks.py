"""Blocks of the dense, moe and zamba families: specs, the training
forward, prefill (returns the populated cache) and single-token decode.

Counterpart: ``repro/models/blocks.py``: the pre-norm residual transformer
block with an MLP or a mixture of experts (``tblock_specs``,
``tblock_apply``, ``kv_cache_specs``, ``tblock_prefill``,
``tblock_decode``) without the cross-attention variant (ROADMAP item 11),
and the Mamba-2 block
(``mamba_block_specs``, ``mamba_block_apply``, ``mamba_block_prefill``,
``mamba_block_decode``, ``mamba_state_specs``); the xLSTM blocks wait for
ROADMAP item 11.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sharding import ParamSpec
from . import attention, layers, moe, ssm


def tblock_specs(cfg, *, use_moe: bool = False) -> dict:
    sp = {
        "ln_attn": layers.norm_specs(cfg.d_model, cfg.norm),
        "attn": attention.attn_specs(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
        "ln_mlp": layers.norm_specs(cfg.d_model, cfg.norm),
    }
    if use_moe:
        sp["moe"] = moe.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts)
    else:
        sp["mlp"] = layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_kind)
    return sp


def _ffn(h, p, cfg):
    """The block's feed-forward half on the normed ``h``: (y, aux loss),
    the aux a float32 zero for an MLP."""
    if "moe" in p:
        return moe.apply_moe(h, p["moe"], top_k=cfg.top_k,
                             group_size=cfg.moe_group,
                             dispatch=cfg.moe_dispatch)
    return (layers.apply_mlp(h, p["mlp"], cfg.mlp_kind),
            torch.zeros((), dtype=torch.float32, device=h.device))


def kv_cache_specs(cfg, batch: int, seq: int) -> dict:
    """One layer's cache: {"k", "v"} [batch, seq, Hkv, hd] in cache dtype."""
    mk = lambda: ParamSpec((batch, seq, cfg.n_kv_heads, cfg.head_dim),  # noqa: E731
                           ("batch", "kv_seq", "kv_heads", "head_dim"),
                           dtype=cfg.cache_dtype, init="zeros")
    return {"k": mk(), "v": mk()}


def _out_proj(o, wo, dt):
    return torch.einsum("bqhk,hkd->bqd", o, wo.to(dt))


def tblock_apply(x, p, cfg):
    """The training forward of the block: x [B,S,D] -> (x [B,S,D], aux
    loss); causal attention through the flash-attention kernel, whose
    backward is a kernel too."""
    h = layers.apply_norm(x, p["ln_attn"], cfg.norm)
    q, k, v = attention.project_qkv(
        h, p["attn"], rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    o = attention.attend(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + _out_proj(o, p["attn"]["wo"], x.dtype)
    h = layers.apply_norm(x, p["ln_mlp"], cfg.norm)
    y, aux = _ffn(h, p, cfg)
    return x + y, aux


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
    return x + _ffn(h, p, cfg)[0], cache


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
    return x + _ffn(h, p, cfg)[0], {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# Mamba-2 block (pre-norm + mixer; no separate MLP, as in Mamba/Zamba)
# ---------------------------------------------------------------------------
def mamba_block_specs(cfg) -> dict:
    return {
        "ln": layers.norm_specs(cfg.d_model, cfg.norm),
        "mixer": ssm.mamba2_specs(
            cfg.d_model, expand=cfg.expand, head_dim=cfg.ssm_head_dim,
            state=cfg.ssm_state, n_groups=cfg.ssm_groups,
            d_conv=cfg.ssm_d_conv),
    }


def mamba_block_apply(x, p, cfg, *, chunk: int = 256):
    """The training forward: x [B,S,D] -> x [B,S,D]; the scan through the
    chunk-scan kernel, whose backward is a kernel too."""
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    return x + ssm.mamba2_chunked(h, p["mixer"], cfg, chunk=chunk)


def mamba_block_prefill(x, p, cfg, *, chunk: int = 256):
    """Returns (x, state ``{"ssm", "conv"}``)."""
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    y, st = ssm.mamba2_chunked(h, p["mixer"], cfg, chunk=chunk,
                               return_state=True)
    return x + y, st


def mamba_block_decode(x, p, cfg, state, pos):
    """x: [B,1,D]; the recurrent state needs no position (``pos`` is
    taken for the uniform block contract)."""
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    y, state = ssm.mamba2_step(h, state, p["mixer"], cfg)
    return x + y, state


def mamba_state_specs(cfg, batch: int) -> dict:
    """One layer's state: ``"ssm"`` [batch, H, P, N] float32 and
    ``"conv"`` [batch, K-1, conv channels] in the cache dtype."""
    d_in = cfg.expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": ParamSpec((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                         ("batch", "heads", "head_dim", "state"),
                         dtype=torch.float32, init="zeros"),
        "conv": ParamSpec((batch, cfg.ssm_d_conv - 1, conv_ch),
                          ("batch", "conv", "inner"),
                          dtype=cfg.cache_dtype, init="zeros"),
    }
