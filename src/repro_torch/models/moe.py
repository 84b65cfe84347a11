"""Mixture-of-Experts with capacity-based top-k routing.

Counterpart: ``repro/models/moe.py`` (``moe_specs``, ``capacity``,
``router_probs``, ``_expert_ffn``, ``_dispatch_einsum``,
``_dispatch_sort``, ``apply_moe``), with the same token-drop semantics:
token-choice top-k, overflowing assignments dropped (they contribute
zero), underflow slots zero-padded.  The two dispatch engines:

  * ``einsum`` - GShard/Switch one-hot dispatch matmuls, capacity per
    group of ``min(group_size, T)`` contiguous tokens;
  * ``sort`` - argsort the (token, k) assignments by expert, gather into
    per-expert buffers, scatter back; capacity over all ``T`` tokens.

Orders are the reference's: ``router_probs`` takes the top k from a
stable descending sort, so ties go to the lower index as in
``jax.lax.top_k``; ``torch.argsort(stable=True)`` replaces
``jnp.argsort(..., stable=True)`` and ``torch.cummax`` the running-max
``associative_scan``.
No step adds with atomics, so reruns on the card give the same bits: the
sort dispatch writes each kept assignment into its own buffer slot, and
sums each token's ``top_k`` contributions in a fixed order, in order of
expert id as the reference's scatter-add meets them in the sorted run.
The expert products are ``torch.einsum``, as the reference's are
``jnp.einsum`` outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.sharding import ParamSpec

__all__ = ["apply_moe", "capacity", "moe_specs", "router_probs"]


def moe_specs(d: int, ff: int, n_experts: int) -> dict:
    return {
        "router": ParamSpec((d, n_experts), ("embed", "experts"), scale=0.5),
        "w_gate": ParamSpec((n_experts, d, ff), ("experts", "embed", "d_ff")),
        "w_up": ParamSpec((n_experts, d, ff), ("experts", "embed", "d_ff")),
        "w_down": ParamSpec((n_experts, ff, d), ("experts", "d_ff", "embed")),
    }


def capacity(group_tokens: int, n_experts: int, top_k: int,
             factor: float = 1.25) -> int:
    c = int(math.ceil(group_tokens * top_k * factor / n_experts))
    return max(8, ((c + 7) // 8) * 8)  # pad to 8 for tiling friendliness


def _one_hot(ids, n: int):
    """``jax.nn.one_hot`` in float32: an id outside [0, n) gives a row of
    zeros (``F.one_hot`` raises, and checks the range on the host)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).float()


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    ties toward the lower index.  ``torch.topk`` on CUDA gives no order
    among equal values, so the ids are taken from a stable descending
    sort."""
    ids = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(probs, -1, ids), ids


def router_probs(x, w_router, top_k: int):
    """Returns (weights [T,k], expert ids [T,k], aux load-balance loss)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = _top_k(probs, top_k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E * sum_e(f_e * p_e)
    E = w_router.shape[-1]
    me = probs.mean(dim=0)
    one_hot = _one_hot(gate_i[..., 0], E)
    ce = one_hot.mean(dim=0)
    aux = E * (me * ce).sum()
    return gate_w, gate_i, aux


def _expert_ffn(xin, p, dt):
    """xin: [E, C', d] -> [E, C', d] per-expert SwiGLU."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, p["w_gate"].to(dt)))
    h = h * torch.einsum("ecd,edf->ecf", xin, p["w_up"].to(dt))
    return torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))


# ---------------------------------------------------------------------------
# einsum (GShard) dispatch
# ---------------------------------------------------------------------------
def _dispatch_einsum(x, p, top_k: int, group_size: int, cap_factor: float):
    """x: [T, d] (T a multiple of group_size)."""
    T, d = x.shape
    E = p["router"].shape[-1]
    dt = x.dtype
    G = T // group_size
    xg = x.reshape(G, group_size, d)
    gate_w, gate_i, aux = router_probs(x, p["router"], top_k)
    gate_w = gate_w.reshape(G, group_size, top_k)
    gate_i = gate_i.reshape(G, group_size, top_k)
    C = capacity(group_size, E, top_k, cap_factor)

    # position of each (token, k) within its expert's capacity buffer
    e_onehot = _one_hot(gate_i, E)                                # [G,S,k,E]
    # rank among same-expert assignments in (token, k) order
    flat = e_onehot.reshape(G, group_size * top_k, E)
    ranks = torch.cumsum(flat, dim=1) - flat                      # [G,S*k,E]
    pos = (ranks * flat).sum(-1).reshape(G, group_size, top_k)
    keep = (pos < C).float()
    gate_w = gate_w * keep

    pos_onehot = _one_hot(pos, C)                                 # [G,S,k,C]
    # combine[g,s,e,c] = sum_k gate_w * onehot(e) * onehot(c): a token's k
    # assignments name distinct experts, so each (e, c) has at most one
    # term and the product order does not matter
    combine = torch.einsum("gske,gskc->gsec", e_onehot * gate_w[..., None],
                           pos_onehot)
    dispatch = (combine > 0).to(dt)
    xin = torch.einsum("gsec,gsd->egcd", dispatch, xg)           # [E,G,C,d]
    xin = xin.reshape(E, G * C, d)
    yout = _expert_ffn(xin, p, dt).reshape(E, G, C, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(dt), yout)
    return y.reshape(T, d), aux


# ---------------------------------------------------------------------------
# sort-based dispatch (flop-free)
# ---------------------------------------------------------------------------
def _dispatch_sort(x, p, top_k: int, group_size: int, cap_factor: float):
    T, d = x.shape
    E = p["router"].shape[-1]
    dt = x.dtype
    dev = x.device
    gate_w, gate_i, aux = router_probs(x, p["router"], top_k)
    C = capacity(T, E, top_k, cap_factor)

    flat_e = gate_i.reshape(-1)                                   # [T*k]
    flat_w = gate_w.reshape(-1)
    n = T * top_k
    tok = torch.arange(T, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], tok[order], flat_w[order]
    # rank within expert along the sorted run
    idx = torch.arange(n, device=dev)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      se[1:] == se[:-1]])
    seg_start = torch.where(same, torch.zeros_like(idx), idx)
    run_start = torch.cummax(seg_start, dim=0).values
    rank = idx - run_start
    keep = rank < C
    slot = se * C + torch.where(keep, rank, torch.zeros_like(rank))

    # each kept assignment owns its slot, written without atomics; the
    # dropped ones, which add zeros in the reference, go to a spare row
    # past the buffer's end
    dest = torch.where(keep, slot, torch.full_like(slot, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=dev)
    buf = buf.index_put((dest,), x[st])[:E * C]
    yout = _expert_ffn(buf.reshape(E, C, d), p, dt).reshape(E * C, d)
    contrib = torch.where(keep, sw, 0.0).to(dt)[:, None] * yout[slot]
    # back in (token, k) order, each token's contributions by expert id:
    # the order in which the sorted run meets them
    by_tok = torch.empty_like(contrib).index_put((order,), contrib)
    by_tok = by_tok.reshape(T, top_k, d)
    e_order = torch.argsort(gate_i, dim=-1)
    by_tok = torch.gather(by_tok, 1, e_order[..., None].expand(T, top_k, d))
    y = by_tok[:, 0]
    for j in range(1, top_k):
        y = y + by_tok[:, j]
    return y, aux


def apply_moe(x, p, *, top_k: int, group_size: int = 512,
              cap_factor: float = 1.25, dispatch: str = "einsum"):
    """x: [B, S, d] -> [B, S, d], aux-loss scalar."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    gs = min(group_size, flat.shape[0])
    if dispatch == "sort":
        y, aux = _dispatch_sort(flat, p, top_k, gs, cap_factor)
    else:
        y, aux = _dispatch_einsum(flat, p, top_k, gs, cap_factor)
    return y.reshape(B, S, d), aux
