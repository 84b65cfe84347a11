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

On a mesh with a model axis (the hook's ``model_axis()``) the experts
split as the tiling plan stores them: ``experts`` on ``model``, so a rank
holds ``E/M`` of the router's columns and of the experts.  Every rank
routes every token: its router columns' logits are gathered
(``collectives.gather_from_model``: the softmax, the top-k and the aux
loss need all ``E``, and every rank then uses them alike), the capacity
positions are the plain ones (the cumsum runs per expert column, so a
rank's columns are a slice of them), and the rank runs only its own
experts, whose share of the output leaves through
``collectives.reduce_from_model``.  The token input and the combine
weights enter that rank-local region through
``collectives.copy_to_model``: their gradients there are per-rank parts
(the router's input gradient over the rank's columns, the combine
weights' over its experts).  Where ``experts`` does not divide the axis
the experts are whole on every rank and their ``d_ff`` splits instead,
as ``spec_for`` stores them: the router is then every rank's own, and
the experts' products are column- and row-parallel.

Under sequence parallelism (the hook's ``seq``: the residual holds this
rank's ``S/M`` rows, as the reference constrains it before and after
every layer, ``repro/models/model.py:93,97``) the token input enters
through ``collectives.all_gather_seq`` where it enters through
``copy_to_model`` above (``layers.enter_split``), so that every rank
still routes every token of its dp rows, and the group's sum of the
experts' outputs leaves through ``collectives.reduce_scatter_seq`` to
the rank's rows where it leaves through ``reduce_from_model``
(``layers.leave_split``).  A router that is every rank's own (the
``d_ff`` split) takes the logits of the rank's rows and gathers them
(``gather_from_model``: every rank routes them alike), so that its
gradient is the rank's rows' part, as every unsplit leaf's is under
sequence parallelism.  A serve step whose
batch rows the dp group splits routes them as the reference routes its
whole batch: where a routing group spans ranks and an expert may
overflow, the ranks' expert ids are gathered and each rank places its
tokens among all of them (``_rows_over_dp``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..core import collectives
from ..core.sharding import ParamSpec, act_axis, model_axis
from . import layers

__all__ = ["ExpertPlan", "apply_moe", "capacity", "expert_plan",
           "moe_specs", "router_probs"]


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


def router_probs(x, w_router, top_k: int, ax=None):
    """Returns (weights [T,k], expert ids [T,k], aux load-balance loss).
    On the model axis ``ax`` the router holds this rank's expert columns,
    whose logits are gathered over the group first."""
    logits = x.float() @ w_router.float()
    if ax is not None:
        logits = collectives.gather_from_model(logits, ax.mesh, -1)
    return _gates(logits, top_k)


def _gates(logits, top_k: int):
    """``router_probs`` from the whole ``[T, E]`` float32 logits."""
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = _top_k(probs, top_k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E * sum_e(f_e * p_e)
    E = logits.shape[-1]
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
# routing on the model axis
# ---------------------------------------------------------------------------
class ExpertPlan(NamedTuple):
    """How the model axis ``ax`` splits ``n`` experts: by experts
    (``by_experts``: this rank runs the experts of ``block``) or by their
    ``d_ff`` columns (every expert, ``block`` all of them)."""
    ax: Any
    by_experts: bool
    block: slice
    n: int


def _plan_of(p, plan):
    """(global expert count, this rank's expert ids) of ``plan``."""
    if plan is None:
        E = p["router"].shape[-1]
        return E, slice(0, E)
    return plan.n, plan.block


def _route(x, p, top_k: int, plan):
    """(the experts' token input [T, d], combine weights [T,k], expert
    ids [T,k], aux loss) of ``x`` [B, S, d] under the expert ``plan``
    (None: one process); under sequence parallelism ``x`` holds this
    rank's rows and T every row of the gathered sequence."""
    d = x.shape[-1]
    if plan is None:
        flat = x.reshape(-1, d)
        return (flat, *router_probs(flat, p["router"], top_k))
    ax, mesh = plan.ax, plan.ax.mesh
    xe = layers.enter_split(x, ax, True).reshape(-1, d)
    if plan.by_experts:
        gate_w, gate_i, aux = router_probs(xe, p["router"], top_k, ax)
    elif ax.seq:
        lg = x.float() @ p["router"].float()
        gate_w, gate_i, aux = _gates(collectives.gather_from_model(
            lg, mesh, 1).reshape(-1, lg.shape[-1]), top_k)
    else:
        gate_w, gate_i, aux = router_probs(x.reshape(-1, d), p["router"],
                                           top_k)
    return xe, collectives.copy_to_model(gate_w, mesh), gate_i, aux


# ---------------------------------------------------------------------------
# einsum (GShard) dispatch
# ---------------------------------------------------------------------------
def _dispatch_einsum(x, gate_w, gate_i, p, top_k: int, group_size: int,
                     cap_factor: float, E: int, eb: slice):
    """x: [T, d] (T a multiple of group_size), routed to ``E`` experts by
    ``gate_w``, ``gate_i`` [T, k]; the output of the experts ``eb``."""
    T, d = x.shape
    dt = x.dtype
    G = T // group_size
    xg = x.reshape(G, group_size, d)
    gate_w = gate_w.reshape(G, group_size, top_k)
    gate_i = gate_i.reshape(G, group_size, top_k)
    C = capacity(group_size, E, top_k, cap_factor)

    # position of each (token, k) within its expert's capacity buffer,
    # over this rank's expert columns (an id outside them: a zero row)
    El = eb.stop - eb.start
    e_onehot = _one_hot(gate_i - eb.start, El)                    # [G,S,k,E]
    # rank among same-expert assignments in (token, k) order
    flat = e_onehot.reshape(G, group_size * top_k, El)
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
    xin = xin.reshape(El, G * C, d)
    yout = _expert_ffn(xin, p, dt).reshape(El, G, C, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(dt), yout)
    return y.reshape(T, d)


# ---------------------------------------------------------------------------
# sort-based dispatch (flop-free)
# ---------------------------------------------------------------------------
def _dispatch_sort(x, gate_w, gate_i, p, top_k: int, cap_factor: float,
                   E: int, eb: slice):
    """As ``_dispatch_einsum``, capacity over all ``T`` tokens."""
    T, d = x.shape
    dt = x.dtype
    dev = x.device
    El = eb.stop - eb.start
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
    # kept, and one of this rank's experts (every expert in one process)
    keep = (rank < C) & (se >= eb.start) & (se < eb.stop)
    slot = (se - eb.start) * C + torch.where(keep, rank,
                                             torch.zeros_like(rank))

    # each kept assignment owns its slot, written without atomics; the
    # dropped ones, which add zeros in the reference, go to a spare row
    # past the buffer's end
    dest = torch.where(keep, slot, torch.full_like(slot, El * C))
    buf = torch.zeros((El * C + 1, d), dtype=dt, device=dev)
    buf = buf.index_put((dest,), x[st])[:El * C]
    yout = _expert_ffn(buf.reshape(El, C, d), p, dt).reshape(El * C, d)
    contrib = torch.where(keep, sw, 0.0).to(dt)[:, None] * \
        yout[slot.clamp(0, El * C - 1)]
    # back in (token, k) order, each token's contributions by expert id:
    # the order in which the sorted run meets them
    by_tok = torch.empty_like(contrib).index_put((order,), contrib)
    by_tok = by_tok.reshape(T, top_k, d)
    e_order = torch.argsort(gate_i, dim=-1)
    by_tok = torch.gather(by_tok, 1, e_order[..., None].expand(T, top_k, d))
    y = by_tok[:, 0]
    for j in range(1, top_k):
        y = y + by_tok[:, j]
    return y


def _rows_over_dp(T: int, E: int, top_k: int, group_size: int,
                  cap_factor: float, dispatch: str):
    """Where a serve step's batch rows are split over a group (the
    hook's ``batch`` tiles) and a routing group of the reference's
    global batch spans ranks with a drop possible, that group's
    ``Tiles``; else None (each rank routes its own tokens exactly as the
    reference routes them).  The reference routes the whole batch of a
    serve step at once; its training step routes each dp shard's own
    (``shard_map``), as this rank does without the hook's ``batch``."""
    hook = act_axis()
    if hook is None or hook.batch is None:
        return None
    rows = hook.tiles("batch", hook.batch)
    if rows is None:
        return None
    Tg = T * rows.size
    if dispatch == "sort":
        return rows if Tg > capacity(Tg, E, top_k, cap_factor) else None
    gs = min(group_size, Tg)
    local = gs == min(group_size, T) and T % gs == 0
    # an expert takes at most one assignment of each token of a group
    drops = gs > capacity(gs, E, top_k, cap_factor)
    return None if local or not drops else rows


def _global_rows(rows, x, gate_w, gate_i):
    """The global batch's tokens as the reference routes them: every
    rank's expert ids (gathered over the rows' group), this rank's
    tokens and combine weights at its offset, zeros elsewhere (the other
    ranks' tokens take their capacity slots and add nothing); and this
    rank's slice of them."""
    T = x.shape[0]
    idx = rows.block.start // (rows.block.stop - rows.block.start)
    own = slice(idx * T, (idx + 1) * T)
    ids = collectives.all_gather(gate_i.contiguous(), rows.mesh, axis=0,
                                 mesh_axis=rows.axis)
    xs = x.new_zeros((T * rows.size, x.shape[1]))
    ws = gate_w.new_zeros((T * rows.size, gate_w.shape[1]))
    xs[own], ws[own] = x, gate_w
    return xs, ws, ids, own


def _leave(y, plan):
    """This rank's experts' share of the output ``[B, S, d]``, summed
    over the model group (to the rank's rows under sequence parallelism;
    ``y`` itself in one process)."""
    return y if plan is None else layers.leave_split(y, plan.ax, True)


def expert_plan(n_experts=None, d_ff=None):
    """The installed model axis's ``ExpertPlan`` for ``n_experts``
    (global) with ``d_ff`` columns: None in one process, or where the
    tiling plan splits neither."""
    ax = model_axis()
    if ax is None or n_experts is None:
        return None
    if ax.split("experts", n_experts):
        return ExpertPlan(ax, True, ax.block(n_experts), n_experts)
    if d_ff is not None and ax.split("d_ff", d_ff):
        return ExpertPlan(ax, False, slice(0, n_experts), n_experts)
    return None


def apply_moe(x, p, *, top_k: int, group_size: int = 512,
              cap_factor: float = 1.25, dispatch: str = "einsum",
              n_experts=None, d_ff=None):
    """x: [B, S, d] -> [B, S, d], aux-loss scalar.  ``n_experts`` and
    ``d_ff`` (global) let the experts split over the model axis."""
    B, _, d = x.shape
    plan = expert_plan(n_experts, d_ff)
    E, eb = _plan_of(p, plan)
    flat, gate_w, gate_i, aux = _route(x, p, top_k, plan)
    rows = _rows_over_dp(flat.shape[0], E, top_k, group_size, cap_factor,
                         dispatch)
    if rows is not None:
        flat, gate_w, gate_i, own = _global_rows(rows, flat, gate_w, gate_i)
    if dispatch == "sort":
        y = _dispatch_sort(flat, gate_w, gate_i, p, top_k, cap_factor, E, eb)
    else:
        y = _dispatch_einsum(flat, gate_w, gate_i, p, top_k,
                             min(group_size, flat.shape[0]), cap_factor, E,
                             eb)
    if rows is not None:
        y = y[own]
    return _leave(y.reshape(B, -1, d), plan), aux
