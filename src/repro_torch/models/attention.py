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

On a mesh with a model axis (``head_plan``) each rank projects its own
query heads (``wq``, ``wo`` split by heads) and its own kv heads when
``kv_heads`` divides the axis.  When it does not, ``wk``/``wv`` stay
replicated and each rank picks the kv heads its query heads read,
``(r * H/M + i) // (H/Hkv)``, before K1, whose ``h // (H/Hkv)`` then maps
its local heads right.  The decode cache is tiled as ``decode_rules``
tiles it, on any mesh (``head_plan``'s ``seq``, the hook's ``tiles`` of
``kv_seq``): by heads, or by sequence over the model group (``kv_seq`` on
``model``), over the dp group (a single stream's cache on ``data``) or
over the whole mesh (``("data", "model")``).  Each rank holds its block
of cache positions, attends it (``decode_partial``: with every query
head, gathered over the model group, where the group spans the model
axis; else with its own) and merges the partials exactly over the group
with ``collectives.softmax_combine``; only the rank that owns ``pos``
writes the new k, v (``cache_update``'s ``offset``).  Prefill computes
the whole sequence on every rank, as the reference's replicated
activations do, and each rank keeps its block.  This is what the
reference leaves to XLA (``repro/models/attention.py:229-251``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import collectives
from ..core.sharding import ModelAxis, ParamSpec, Tiles, act_axis, model_axis
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


# ---------------------------------------------------------------------------
# The model axis
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """How one rank's attention splits over the mesh: over the model
    axis ``ax`` (None: no model axis) ``heads`` (the query heads are
    split), ``kv`` (the kv heads are split), ``pick`` (kv replicated: the
    kv heads this rank's query heads read, in K1's grouping); and ``seq``,
    the decode cache's ``kv_seq`` tiles (None: every rank holds every
    position)."""
    ax: Optional[ModelAxis]
    heads: bool
    kv: bool
    pick: Optional[tuple]
    seq: Optional[Tiles]

    @property
    def seq_block(self) -> slice:
        """This rank's cache positions."""
        return self.seq.block

    @property
    def gather_q(self) -> bool:
        """Whether a sequence-tiled decode attends with every query head:
        the heads split over a model axis that the cache's group spans."""
        return self.heads and "model" in self.seq.axes

    def pick_kv(self, k, v):
        """k, v ``[B, S, Hkv, hd]`` with all kv heads -> the heads this
        rank's query heads read (a view where they are contiguous)."""
        if self.pick is None:
            return k, v
        lo, n = self.pick[0], len(self.pick)
        if self.pick == tuple(range(lo, lo + n)):
            return k.narrow(2, lo, n), v.narrow(2, lo, n)
        idx = torch.tensor(self.pick, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)


def head_plan(n_heads: int, n_kv: int,
              cache_len: Optional[int] = None) -> Optional[HeadPlan]:
    """The installed hook's plan for ``n_heads`` query and ``n_kv`` kv
    heads (global), with the decode cache's global ``cache_len``; None
    with neither a model axis nor a tiled cache (the one-process
    code)."""
    hook = act_axis()
    if hook is None:
        return None
    ax = model_axis()
    seq = hook.tiles("kv_seq", cache_len)
    if ax is None and seq is None:
        return None
    heads = ax is not None and ax.split("heads", n_heads)
    kv = heads and ax.split("kv_heads", n_kv)
    pick = None
    if heads and not kv:
        loc, g = n_heads // ax.size, n_heads // n_kv
        idx = [(ax.index * loc + i) // g for i in range(loc)]
        uniq = sorted(set(idx))
        rep = loc // len(uniq)
        grouped = loc % len(uniq) == 0 and \
            idx == [u for u in uniq for _ in range(rep)]
        pick = tuple(uniq if grouped else idx)
    return HeadPlan(ax, heads, kv, pick, seq)


def partial_grad_leaves(n_heads: int, n_kv: int, ax: ModelAxis) -> tuple:
    """The replicated attention leaves whose use depends on the model
    rank, so that each rank's gradient is a part to sum over the group:
    ``q_norm``/``k_norm`` (applied to this rank's heads) and, when the kv
    heads do not split, ``wk``/``wv``/``bk``/``bv`` (read through
    ``pick``).  None when the query heads do not split (every rank
    computes the whole attention)."""
    if not ax.split("heads", n_heads):
        return ()
    out = ("q_norm", "k_norm")
    if not ax.split("kv_heads", n_kv):
        out += ("wk", "wv", "bk", "bv")
    return out


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


def _decode_mask(k_pos, pos, window):
    """``[.., 1, S]`` (``[B, 1, 1, 1, S]`` for a ``[B]`` pos): which cache
    positions ``k_pos`` the token at ``pos`` attends."""
    if _is_scalar(pos):
        valid = k_pos <= pos
        if window is not None:
            valid = valid & (k_pos > pos - window)
        return valid[None, None, None, None, :]
    pos = pos.to(k_pos.device)              # per-row positions: [B] -> [B,S]
    valid = k_pos[None, :] <= pos[:, None]
    if window is not None:
        valid = valid & (k_pos[None, :] > pos[:, None] - window)
    return valid[:, None, None, None, :]


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
    mask = _decode_mask(torch.arange(S, device=q.device), pos, window)
    lg = torch.where(mask, lg, NEG_INF)
    pr = torch.softmax(lg, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqs,bshk->bqhgk", pr, v_cache)
    return o.reshape(B, 1, H, hd)


def decode_partial(q, k_cache, v_cache, pos, *, offset: int = 0,
                   scale: Optional[float] = None,
                   window: Optional[int] = None):
    """One rank's share of decode attention over a cache chunk that holds
    the positions ``[offset, offset + S)``: the softmax partials ``(m, l,
    o)`` (``[B, 1, H, 1]``, ``[B, 1, H, 1]``, ``[B, 1, H, hd]``, float32)
    that ``collectives.softmax_combine`` merges exactly.  Grouped-GQA
    form, as ``decode_attend``."""
    B, _, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(hd))
    qg = q.reshape(B, 1, Hkv, G, hd)
    lg = torch.einsum("bqhgk,bshk->bhgqs", qg, k_cache).float() * scale
    mask = _decode_mask(offset + torch.arange(S, device=q.device), pos,
                        window)
    lg = torch.where(mask, lg, NEG_INF)
    m = lg.amax(-1, keepdim=True)
    w = torch.where(mask, torch.exp(lg - m), 0.0)
    o = torch.einsum("bhgqs,bshk->bqhgk", w, v_cache.float())
    shape = (B, 1, H, 1)
    return (m.permute(0, 3, 1, 2, 4).reshape(shape),
            w.sum(-1, keepdim=True).permute(0, 3, 1, 2, 4).reshape(shape),
            o.reshape(B, 1, H, hd))


def cache_update(k_cache, v_cache, k_new, v_new, pos, *, mode: str = "dus",
                 offset: int = 0):
    """Write the new token's K/V at ``pos`` (scalar, or ``[B]`` for
    per-row write offsets), in place; returns the two caches.  A cache
    chunk holding the positions ``[offset, offset + S)`` (a
    sequence-tiled cache) writes only where ``pos`` falls in it.

    mode="dus" writes the one slice; mode="masked" is the one-hot select
    over the sequence dim, the form a ``[B]`` pos always takes (each row
    writes only its own offset)."""
    if mode not in ("dus", "masked"):
        raise ValueError(f"unknown cache_update mode {mode!r}")
    k_new = k_new.to(k_cache.dtype)
    v_new = v_new.to(v_cache.dtype)
    S = k_cache.shape[1]
    if mode == "dus" and _is_scalar(pos):
        at = int(pos) - offset
        if 0 <= at < S:
            k_cache.narrow(1, at, 1).copy_(k_new)
            v_cache.narrow(1, at, 1).copy_(v_new)
        return k_cache, v_cache
    s_idx = offset + torch.arange(S, device=k_cache.device)
    if _is_scalar(pos):
        hit = (s_idx == pos)[None, :, None, None]
    else:
        hit = (s_idx[None, :] == pos.to(k_cache.device)[:, None])[:, :, None, None]
    k_cache.copy_(torch.where(hit, k_new, k_cache))
    v_cache.copy_(torch.where(hit, v_new, v_cache))
    return k_cache, v_cache
