"""Grouped-query attention: prefill on the flash-attention kernel, decode
against a KV cache.

Counterpart: ``repro/models/attention.py``.  The model works in
``[B, S, H, hd]``.  ``attend`` sends every prefill and every training
forward to the flash-attention kernel (``kernels/flash_attention.py``,
``[B, H, S, d]``): on CUDA tensors it launches the kernel or raises, and
its gradient launches the backward kernel; on CPU tensors it runs the
kernel's plain version under ordinary autograd.  This differs from the
JAX package on purpose: its ``attend`` dispatches only to
``full``/``chunked`` and never calls its own Pallas kernel.  The kernel
masks a ragged S itself, so there is no switch to ``attend_full``, which
stays as the oracle.

Decode attends one new token against the cache with plain tensor code.
``cache_update`` writes the cache in place: that stands in for JAX's
donation of the cache buffer to the decode step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.sharding import ParamSpec
from ..kernels.flash_attention import flash_attention
from . import layers

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
def attn_specs(d: int, n_heads: int, n_kv: int, head_dim: int, *,
               qkv_bias: bool = False, qk_norm: bool = False) -> dict:
    sp = {
        "wq": ParamSpec((d, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, head_dim, d), ("heads", "head_dim", "embed")),
    }
    if qkv_bias:
        sp["bq"] = ParamSpec((n_heads, head_dim), ("heads", "head_dim"), init="zeros")
        sp["bk"] = ParamSpec((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
        sp["bv"] = ParamSpec((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
    if qk_norm:
        sp["q_norm"] = ParamSpec((head_dim,), ("head_dim",), init="ones")
        sp["k_norm"] = ParamSpec((head_dim,), ("head_dim",), init="ones")
    return sp


def project_qkv(x, p, *, positions=None, rope_theta: float = 10000.0,
                use_rope: bool = True):
    """x: [B, S, D] -> q [B,S,H,hd], k/v [B,S,Hkv,hd]."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "q_norm" in p:
        q = layers.rms_norm(q, p["q_norm"])
        k = layers.rms_norm(k, p["k_norm"])
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)
    return q, k, v


def _expand_kv(k, n_heads: int):
    """[B,S,Hkv,hd] -> [B,S,H,hd] by repeating each kv head (GQA)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=2)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """[.., Sq, Sk] additive bias from position grids."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.zeros(diff.shape, dtype=torch.float32, device=diff.device)
    if causal:
        m = torch.where(diff < 0, NEG_INF, m)
    if window is not None:
        m = torch.where(diff >= window, NEG_INF, m)
    return m


# ---------------------------------------------------------------------------
# Prefill attention
# ---------------------------------------------------------------------------
def attend_full(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                q_offset: int = 0, scale: Optional[float] = None):
    """Oracle: materialized [B,H,Sq,Sk] logits."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = scale or (1.0 / math.sqrt(hd))
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    lg = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    q_pos = (torch.arange(Sq, device=q.device) + q_offset)[None, :]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    lg = lg + _mask_bias(q_pos, k_pos, causal=causal, window=window)[:, None]
    pr = torch.softmax(lg, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", pr, v)


def attend(q, k, v, *, causal: bool = True, window: Optional[int] = None,
           scale: Optional[float] = None):
    """q: [B,S,H,hd], k/v: [B,S,Hkv,hd] -> [B,S,H,hd] through the
    flash-attention kernel (its plain version for CPU tensors);
    differentiable."""
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(),
                        causal=causal, window=window, scale=scale)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# Decode (KV-cache) attention
# ---------------------------------------------------------------------------
def _is_scalar(pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.dim() == 0


def decode_attend(q, k_cache, v_cache, pos, *, scale: Optional[float] = None,
                  window: Optional[int] = None):
    """q: [B,1,H,hd]; caches [B,S,Hkv,hd]; pos: scalar current index, or a
    ``[B]`` tensor when batch rows sit at different offsets.  Grouped-GQA
    form: KV heads are never expanded."""
    B, _, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(hd))
    qg = q.reshape(B, 1, Hkv, G, hd)
    lg = torch.einsum("bqhgk,bshk->bhgqs", qg, k_cache).float() * scale
    k_pos = torch.arange(S, device=q.device)
    if _is_scalar(pos):
        valid = k_pos <= pos
        if window is not None:
            valid = valid & (k_pos > pos - window)
        mask = valid[None, None, None, None, :]
    else:                                   # per-row positions: [B] -> [B,S]
        pos = pos.to(q.device)
        valid = k_pos[None, :] <= pos[:, None]
        if window is not None:
            valid = valid & (k_pos[None, :] > pos[:, None] - window)
        mask = valid[:, None, None, None, :]
    lg = torch.where(mask, lg, NEG_INF)
    pr = torch.softmax(lg, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqs,bshk->bqhgk", pr, v_cache)
    return o.reshape(B, 1, H, hd)


def cache_update(k_cache, v_cache, k_new, v_new, pos, *, mode: str = "dus"):
    """Write the new token's K/V at ``pos`` (scalar, or ``[B]`` for
    per-row write offsets), in place; returns the two caches.

    mode="dus" writes the one slice; mode="masked" is the one-hot select
    over the sequence dim, the form a ``[B]`` pos always takes (each row
    writes only its own offset)."""
    if mode not in ("dus", "masked"):
        raise ValueError(f"unknown cache_update mode {mode!r}")
    k_new = k_new.to(k_cache.dtype)
    v_new = v_new.to(v_cache.dtype)
    if mode == "dus" and _is_scalar(pos):
        k_cache.narrow(1, int(pos), 1).copy_(k_new)
        v_cache.narrow(1, int(pos), 1).copy_(v_new)
        return k_cache, v_cache
    S = k_cache.shape[1]
    s_idx = torch.arange(S, device=k_cache.device)
    if _is_scalar(pos):
        hit = (s_idx == pos)[None, :, None, None]
    else:
        hit = (s_idx[None, :] == pos.to(k_cache.device)[:, None])[:, :, None, None]
    k_cache.copy_(torch.where(hit, k_new, k_cache))
    v_cache.copy_(torch.where(hit, v_new, v_cache))
    return k_cache, v_cache
