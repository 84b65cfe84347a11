"""State-space / recurrent mixers: Mamba-2 (SSD) of the zamba family,
mLSTM and sLSTM of the xlstm family.

Counterpart: ``repro/models/ssm.py`` (``causal_conv1d``, ``mamba2_specs``,
``_mamba2_split`` as ``_project``, ``mamba2_chunked``,
``mamba2_init_state``, ``mamba2_step``; ``mlstm_specs``, ``_mlstm_qkvif``,
``mlstm_chunked``, ``mlstm_init_state``, ``mlstm_step``; ``slstm_specs``,
``_slstm_cell``, ``slstm_apply``, ``slstm_init_state``, ``slstm_step``).
The same contract as attention: a chunked form for prefill and a step
form for decode carrying an explicit state.

``mamba2_chunked`` keeps every step of the JAX function up to the scan and
then sends the scan to the chunk-scan kernel (``kernels/mamba2_scan.py``,
``[B, H, L, .]``): on CUDA tensors it launches the kernel or raises, on
CPU tensors it runs the kernel's plain version.  This differs from the
JAX package on purpose, as ``attend`` does for attention: the JAX model
computes the scan with jnp einsums and never calls its own Pallas kernel.
``mamba2_step`` (decode) stays plain tensor code: no kernel exists for it.

On a mesh with a model axis (the hook's ``model_axis()``) a Mamba-2 layer
runs on this rank's ``H/M`` heads, every leaf stored as the contiguous
block the tiling plan gives it (``spec_for``: the fused ``in_proj``
columns z | x | B | C | dt and the conv channels x | B | C are cut
across their segments).  The input enters through ``copy_to_model``;
``x @ in_proj``'s block is joined over the group by
``collectives.all_gather_seq`` (its backward sums each rank's part of
the columns it reads), and the rank takes its heads' z, x and dt and all
of B and C.  Over a sequence the split conv weights are gathered (with
their bias: ``K + 1`` rows, where the conv's output would be ``B * L``
rows) and the rank convolves the channels it reads; a decode step
convolves the cache's own block of channels and gathers that output.
K2 and its backward run on ``[B, H/M, L, P]`` with the groups of B and C
that the rank's heads read.  The gated norm's sum of squares over all of
``d_in`` is summed over the group (``collectives.sum_over_model``) and
``out_proj``'s rows leave through ``reduce_from_model``.  A leaf that
does not divide stays whole (``_Heads``: an unsplit ``in_proj`` or conv
is computed whole and its gradient summed, ``partial_grad_leaves``), and
where the heads do not divide every rank gathers the split leaves
(``gather_from_model``) and runs the whole layer.

On a model axis the mLSTM and sLSTM layers run on this rank's ``H/M``
heads, every leaf the reference's contiguous block.  The mLSTM
(``_mlstm_qkvif``, ``_mlstm_out``): the input enters through
``copy_to_model``; ``up_proj``'s fused ``xi | z`` columns are joined
(``_fused_cols``: as the product's output or as the weight, whichever
is the fewer bytes); the conv runs on the rank's channels, which are its
heads' (``d_in`` is head-major); ``wq``, ``wk``, ``wv`` and ``w_gates``
hold the rank's rows, so their four products are its parts of the
whole, laid out by head and reduce-scattered over the heads
(``reduce_scatter_seq``); the norm's sum of squares over ``d_in`` is
summed over the group and ``down_proj``'s rows leave through
``reduce_from_model``.  The sLSTM (``slstm_apply``, ``_slstm_out``):
``w_in``, ``b`` and ``r`` are the rank's heads', so the time loop needs
no collective; one ``gather_from_model`` of ``h`` after it feeds the
rms_norm over ``embed``, ``up``'s fused ``gelu | up`` columns are
joined as the mLSTM's are and ``down``'s rows reduced.  Where the heads
do not divide (tiny xlstm's 2 sLSTM heads at ``model=4``) the layer
runs whole on gathered leaves (``_gathered``).  No xLSTM leaf's
gradient is a per-rank part.

Under sequence parallelism (the hook's ``seq``: the residual holds this
rank's ``S/M`` rows between every pair of layers) each mixer enters and
leaves through ``_enter``/``_leave`` (``layers.enter_split``/
``leave_split``): its input is gathered by ``all_gather_seq`` where it
takes ``copy_to_model`` above (the mamba layer's ``_project``, the
mLSTM's ``_mlstm_qkvif``, the sLSTM's input), and its output leaves to
the rank's rows through ``reduce_scatter_seq`` where it takes
``reduce_from_model`` (``out_proj`` after ``_gate_out``, ``down_proj``
after ``_mlstm_out``, the sLSTM's ``down``), or through a plain cut
where it is whole on every rank (``d_ff`` that does not split, heads
that do not split: the layer then runs whole on the gathered sequence,
its leaves gathered by ``all_gather_seq`` so that their gradients, its
rows' parts, are summed).  The causal conv, K2 and its backward (on
``[B, H/M, L, P]``), the mLSTM's chunks and the sLSTM's time loop run
on the whole gathered sequence; the gated norms' ``sum_over_model`` is
unchanged.  The sLSTM joins its heads' ``h`` with ``all_gather_seq``
in place of ``gather_from_model`` and ``copy_to_model`` (the backward
then sums the ranks' parts of the whole sequence).  The reference
constrains the residual at each zamba group's entry and exit
(``repro/models/model.py:125,129``) and nowhere in the xlstm backbone
(``:104-115``); the port splits it between every pair of layers, whose
ring bytes equal the all-reduces they replace.

mLSTM and sLSTM are plain tensor code throughout, as in the JAX package
(which has no kernel for them): the reference's ``compat.layer_scan`` over
chunks (mLSTM) and over time steps (sLSTM) becomes a Python loop.  The
reference's numerics are kept, parity depends on them: the stabilizer
starts at ``m = 0``, ``k`` is scaled by ``1/sqrt(P)`` before the gates,
``v`` is projected from the pre-conv ``xi``, the sLSTM's gates are the
means over each head's lanes, and its recurrence runs in float32 while the
stacked outputs are in the compute dtype.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..core import collectives
from ..core.sharding import ParamSpec, model_axis, spec_for
from ..kernels.mamba2_scan import mamba2_chunk_scan
from . import layers


def causal_conv1d(x, w, b=None, *, cache=None):
    """Depthwise causal conv. x: [B, L, C]; w: [K, C].

    With ``cache`` [B, K-1, C] (decode), prepends it instead of zero pad and
    returns (y, new_cache).
    """
    K = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None].to(x.dtype)
            for i in range(K))
    if b is not None:
        y = y + b.to(x.dtype)
    new_cache = xp[:, -(K - 1):, :] if cache is not None else None
    return y, new_cache


def mamba2_specs(d: int, *, expand: int = 2, head_dim: int = 64,
                 state: int = 64, n_groups: int = 1, d_conv: int = 4) -> dict:
    d_in = expand * d
    H = d_in // head_dim
    conv_ch = d_in + 2 * n_groups * state
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * n_groups * state + H),
                             ("embed", "inner")),
        "conv_w": ParamSpec((d_conv, conv_ch), ("conv", "inner"), init="scaled",
                            scale=0.1),
        "conv_b": ParamSpec((conv_ch,), ("inner",), init="zeros"),
        "A_log": ParamSpec((H,), ("heads",), init="zeros"),
        "D": ParamSpec((H,), ("heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("heads",), init="zeros"),
        "norm_w": ParamSpec((d_in,), ("inner",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("inner", "embed")),
    }


def _dims(cfg) -> tuple:
    """(d_in, H, P, N, G) of the Mamba-2 layer."""
    d_in = cfg.expand * cfg.d_model
    return (d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_groups)


class _Heads(NamedTuple):
    """One rank's part of a Mamba-2 layer whose heads split over the model
    axis ``ax``: its heads ``hb``, whether ``in_proj``'s fused columns
    split (``proj``) and whether the conv's channels split (``conv``: its
    weights and the decode cache's ``conv``, this rank's block ``cb`` of
    them); a leaf that does not split is whole on every rank."""
    ax: Any
    hb: slice
    proj: bool
    conv: bool
    cb: slice


def _split_of(cfg):
    """(the installed model axis, this rank's ``_Heads``): (None, None)
    in one process, (ax, None) where the heads do not split (every rank
    computes every head)."""
    ax = model_axis()
    if ax is None:
        return None, None
    d_in, H, _, N, G = _dims(cfg)
    if not ax.split("heads", H):
        return ax, None
    conv_ch = d_in + 2 * G * N
    return ax, _Heads(ax, ax.block(H),
                      ax.split("inner", 2 * d_in + 2 * G * N + H),
                      ax.split("inner", conv_ch), ax.block(conv_ch))


def _gathered(p, specs: dict, ax) -> dict:
    """``p`` with every leaf that the model axis splits (by its spec in
    ``specs``) gathered whole (``gather_from_model``): every rank then
    computes the whole layer alike, where its heads do not split.  Under
    sequence parallelism the layer's output is cut to the rank's rows, so
    each rank's gradient of the whole leaf is its rows' part: the leaves
    are gathered by ``all_gather_seq``, whose backward sums the parts."""
    gather = collectives.all_gather_seq if ax.seq \
        else collectives.gather_from_model
    out = dict(p)
    for name, s in specs.items():
        for i, part in enumerate(spec_for(ax.mesh, ax.rules, s.shape,
                                          s.dims)):
            if part is not None and "model" in (
                    (part,) if isinstance(part, str) else part):
                out[name] = gather(p[name], ax.mesh, i)
    return out


def _enter(x, ax, hs):
    """A mixer's input ``[B, L, D]`` on the model axis ``ax`` (None: one
    process): every rank's rows, gathered, under sequence parallelism
    (``all_gather_seq``); else through ``copy_to_model`` on a rank's
    heads ``hs``, as it is where the layer runs whole."""
    return x if ax is None else layers.enter_split(x, ax, hs is not None)


def _leave(y, ax, hs):
    """A mixer's output ``[B, L, D]``: on a rank's heads ``hs`` its part,
    summed over the model group (``reduce_from_model``; to the rank's
    rows under sequence parallelism, ``reduce_scatter_seq``); where the
    layer runs whole, ``y`` (cut to the rank's rows under sequence
    parallelism)."""
    return y if ax is None else layers.leave_split(y, ax, hs is not None)


def _whole(p, cfg, ax) -> dict:
    """The layer's parameters with every leaf that the model axis splits
    gathered whole (``_gathered``): where the heads do not split."""
    return _gathered(p, mamba2_specs(
        cfg.d_model, expand=cfg.expand, head_dim=cfg.ssm_head_dim,
        state=cfg.ssm_state, n_groups=cfg.ssm_groups,
        d_conv=cfg.ssm_d_conv), ax)


def _project(x, p, cfg, hs):
    """Project: (z of this rank's heads, the conv's input channels (all of
    them), dt of its heads).  With heads ``hs`` the input has entered
    through ``_enter`` and a split ``in_proj``'s columns are joined by
    ``all_gather_seq`` (its backward sums each rank's part of them)."""
    d_in, H, P, N, G = _dims(cfg)
    gn = G * N
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    if hs is not None and hs.proj:
        zxbcdt = collectives.all_gather_seq(zxbcdt, hs.ax.mesh, dim=-1)
    hb = slice(0, H) if hs is None else hs.hb
    z = zxbcdt[..., hb.start * P:hb.stop * P]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn + hb.start:2 * d_in + 2 * gn + hb.stop]
    return z, xbc, dt


def _read(t, cfg, hs):
    """The conv channels of ``t`` (last dim: all of them) that this
    rank's heads read: their x channels, then all of B and C."""
    if hs is None:
        return t
    d_in, P = _dims(cfg)[0], cfg.ssm_head_dim
    return torch.cat([t[..., hs.hb.start * P:hs.hb.stop * P],
                      t[..., d_in:]], dim=-1)


def _conv_seq(xbc, p, cfg, hs):
    """silu of the causal conv over a whole sequence, on the channels this
    rank reads.  Split conv weights are gathered (with their bias, one
    exchange; ``all_gather_seq``, so that each rank's gradient of them is
    its own block's sum): they are ``K + 1`` rows, where the conv's output
    would be ``B * L``."""
    w, b = p["conv_w"], p["conv_b"]
    if hs is not None and hs.conv:
        wb = collectives.all_gather_seq(torch.cat([w, b[None]]),
                                        hs.ax.mesh, dim=-1)
        w, b = wb[:-1], wb[-1]
    y, _ = causal_conv1d(_read(xbc, cfg, hs), _read(w, cfg, hs),
                         _read(b, cfg, hs))
    return F.silu(y)


def _groups(H: int, G: int, hb: slice):
    """The B/C groups that heads ``hb`` read (head h reads group
    ``h // (H / G)``), as K2 takes them: a slice of whole groups when the
    heads cover them evenly, else one group per head (an index list)."""
    per = H // G
    idx = [h // per for h in range(hb.start, hb.stop)]
    uniq = sorted(set(idx))
    rep = len(idx) // len(uniq)
    if len(idx) % len(uniq) == 0 and idx == [u for u in uniq
                                             for _ in range(rep)]:
        return slice(uniq[0], uniq[-1] + 1)
    return idx


def _gate_out(y, xs, z, p, cfg, hs):
    """``+ xs D``, the gated rms_norm and the output projection.  On a
    rank's heads the norm's sum of squares over all of ``d_in`` is summed
    over the model group (``sum_over_model``) and the projection's rows
    are this rank's: its output is the rank's part, which leaves through
    ``_leave``."""
    dt_f = y.dtype
    y = y + xs * p["D"].to(dt_f)[:, None]
    y = y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])
    g = y * F.silu(z)
    if hs is None:
        return layers.rms_norm(g, p["norm_w"]) @ p["out_proj"].to(dt_f)
    ss = collectives.sum_over_model(
        g.float().square().sum(dim=-1, keepdim=True), hs.ax.mesh)
    scale = torch.rsqrt(ss / _dims(cfg)[0] + 1e-6).to(dt_f)
    return (g * scale * p["norm_w"].to(dt_f)) @ p["out_proj"].to(dt_f)


def mamba2_chunked(x, p, cfg, *, chunk: int = 256, return_state: bool = False):
    """Prefill pass. x: [B, L, D] -> [B, L, D] (+ final state
    ``{"ssm": [B, H, P, N] float32, "conv": [B, K-1, conv channels]}``;
    on a model axis this rank's heads of ``ssm`` and its block of the
    conv channels)."""
    _, H, P, N, G = _dims(cfg)
    dt_f = x.dtype
    ax, hs = _split_of(cfg)
    if ax is not None and hs is None:
        p = _whole(p, cfg, ax)
    x = _enter(x, ax, hs)
    B, L, D = x.shape
    hb = slice(0, H) if hs is None else hs.hb
    Hl = hb.stop - hb.start

    z, xbc_in, dt = _project(x, p, cfg, hs)
    xbc = _conv_seq(xbc_in, p, cfg, hs)
    d_loc = Hl * P
    xs = xbc[..., :d_loc].reshape(B, L, Hl, P)
    Bm = xbc[..., d_loc:d_loc + G * N].reshape(B, L, G, N)
    Cm = xbc[..., d_loc + G * N:].reshape(B, L, G, N)
    if hs is not None:
        grp = _groups(H, G, hb)
        Bm, Cm = Bm[:, :, grp], Cm[:, :, grp]

    dt = F.softplus(dt.float() + p["dt_bias"].float())             # [B,L,H]
    A = -torch.exp(p["A_log"].float())                             # [H]
    a = dt * A[None, None]                                         # log decay
    xdt = xs * dt.to(dt_f)[..., None]                              # dt-weighted

    # the kernel's layout: [B, H, L, .], B and C once per group [B, G, L, N]
    # (the kernel reads head h's from group h // (H / G))
    y, S_final = mamba2_chunk_scan(
        xdt.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous(),
        Bm.transpose(1, 2).contiguous(), Cm.transpose(1, 2).contiguous(),
        chunk=chunk)
    out = _leave(_gate_out(y.transpose(1, 2), xs, z, p, cfg, hs), ax, hs)
    if return_state:
        K = p["conv_w"].shape[0]
        # the pre-conv inputs of the last K-1 positions (this rank's block
        # of the channels where they split), copied out of the projection
        # so that the cache does not hold all of it
        conv = xbc_in[:, -(K - 1):, :]
        if ax is not None and ax.split("inner", conv.shape[-1]):
            conv = conv[..., ax.block(conv.shape[-1])]
        return out, {"ssm": S_final, "conv": conv.contiguous()}
    return out


def mamba2_init_state(batch: int, cfg, dtype=torch.float32,
                      device=None) -> dict:
    d_in = cfg.expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def _conv_step(xbc, p, cfg, hs, ax, cache):
    """silu of one decode step's conv on the channels this rank reads,
    and the new conv cache (this rank's block where the channels split:
    the block's conv, its outputs gathered over the model group)."""
    conv_ch = xbc.shape[-1]
    if ax is None or not ax.split("inner", conv_ch):
        y, cache = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                 cache=cache)
    elif hs is None:              # the whole conv, on the gathered cache
        cb = ax.block(conv_ch)
        whole = collectives.all_gather(cache, ax.mesh, axis=-1,
                                       mesh_axis="model")
        y, cache = causal_conv1d(xbc, p["conv_w"], p["conv_b"], cache=whole)
        cache = cache[..., cb].contiguous()
    else:
        y, cache = causal_conv1d(xbc[..., hs.cb], p["conv_w"], p["conv_b"],
                                 cache=cache)
        y = collectives.all_gather(y.contiguous(), ax.mesh, axis=-1,
                                   mesh_axis="model")
    return F.silu(_read(y, cfg, hs)), cache


def mamba2_step(x, state, p, cfg):
    """Decode one token. x: [B, 1, D] -> (y [B,1,D], new state); on a
    model axis the state holds this rank's blocks, as ``mamba2_chunked``
    returns them."""
    B, _, D = x.shape
    _, H, P, N, G = _dims(cfg)
    ax, hs = _split_of(cfg)
    if ax is not None and hs is None:
        p = _whole(p, cfg, ax)
    x = _enter(x, ax, hs)
    hb = slice(0, H) if hs is None else hs.hb
    Hl = hb.stop - hb.start

    z, xbc, dt = _project(x, p, cfg, hs)
    xbc, conv_cache = _conv_step(xbc, p, cfg, hs, ax, state["conv"])
    d_loc = Hl * P
    xs = xbc[..., :d_loc].reshape(B, Hl, P)
    Bm = xbc[..., d_loc:d_loc + G * N].reshape(B, G, N).repeat_interleave(
        H // G, dim=1)[:, hb]
    Cm = xbc[..., d_loc + G * N:].reshape(B, G, N).repeat_interleave(
        H // G, dim=1)[:, hb]

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())       # [B,H]
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None])                                # [B,H]
    S = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhp,bhe,bh->bhpe", xs.float(), Bm.float(), dt)
    y = torch.einsum("bhpe,bhe->bhp", S, Cm.float()).to(x.dtype)
    out = _leave(_gate_out(y[:, None], xs[:, None], z, p, cfg, hs), ax, hs)
    return out, {"ssm": S, "conv": conv_cache}


def partial_grad_leaves(cfg, ax) -> tuple:
    """The Mamba-2 leaves that the model axis ``ax`` leaves whole while
    the heads split, so that each rank's gradient is a part to sum over
    the group: ``in_proj`` (each rank reads its heads' columns and a
    share of B and C), ``conv_w``/``conv_b`` (each rank convolves its
    heads' channels and B and C)."""
    d_in, H, _, N, G = _dims(cfg)
    if not ax.split("heads", H):
        return ()
    conv_ch = d_in + 2 * G * N
    out = () if ax.split("inner", conv_ch + d_in + H) else ("in_proj",)
    if not ax.split("inner", conv_ch):
        out += ("conv_w", "conv_b")
    return out


# ===========================================================================
# mLSTM (xLSTM) - matrix-memory gated linear recurrence
# ===========================================================================
NEG_INF = -1e30


def mlstm_specs(d: int, *, n_heads: int, expand: int = 2,
                d_conv: int = 4) -> dict:
    d_in = expand * d
    return {
        "up_proj": ParamSpec((d, 2 * d_in), ("embed", "inner")),
        "conv_w": ParamSpec((d_conv, d_in), ("conv", "inner"), init="scaled",
                            scale=0.1),
        "conv_b": ParamSpec((d_in,), ("inner",), init="zeros"),
        "wq": ParamSpec((d_in, d_in), ("inner", None)),
        "wk": ParamSpec((d_in, d_in), ("inner", None)),
        "wv": ParamSpec((d_in, d_in), ("inner", None)),
        "w_gates": ParamSpec((d_in, 2 * n_heads), ("inner", None), scale=0.3),
        "b_i": ParamSpec((n_heads,), ("heads",), init="zeros"),
        "b_f": ParamSpec((n_heads,), ("heads",), init="ones"),
        "skip": ParamSpec((d_in,), ("inner",), init="ones"),
        "norm_w": ParamSpec((d_in,), ("inner",), init="ones"),
        "down_proj": ParamSpec((d_in, d), ("inner", "embed")),
    }


class _XHeads(NamedTuple):
    """One rank's part of an xLSTM layer whose heads split over the model
    axis ``ax``: its heads ``hb`` (the channels of every split leaf are
    head-major, so its blocks are its heads' channels)."""
    ax: Any
    hb: slice


def _xsplit(H: int, width: int):
    """(the installed model axis, this rank's ``_XHeads`` over ``H``
    heads of ``width`` channels): (None, None) in one process, (ax,
    None) where the heads do not split (every rank computes every
    head)."""
    ax = model_axis()
    if ax is None:
        return None, None
    if not (ax.split("heads", H) and ax.split("inner", width)):
        return ax, None
    return ax, _XHeads(ax, ax.block(H))


def _fused_cols(x, w, parts: int, ax) -> list:
    """This rank's block of each of the ``parts`` equal segments of
    ``x @ W``, where the fused weight W's columns split over the model
    axis ``ax`` (``w``: this rank's block of them; at ``model=2`` with
    two segments, rank 0 holds all of the first and rank 1 all of the
    second).  The columns are joined by ``all_gather_seq`` (its backward
    sums each rank's part of the columns it read), as the product's
    output where that is the fewer bytes (``x``'s rows fewer than W's:
    decode, small batches), else as the weight (training).  ``x`` must
    have entered through ``copy_to_model``."""
    seg = w.shape[-1] * ax.size // parts
    blk = ax.block(seg)
    rows = x.numel() // x.shape[-1]
    if rows * x.element_size() < w.shape[0] * w.element_size():
        y = collectives.all_gather_seq(x @ w.to(x.dtype), ax.mesh, dim=-1)
        return [y[..., i * seg + blk.start:i * seg + blk.stop]
                for i in range(parts)]
    whole = collectives.all_gather_seq(w, ax.mesh, dim=-1)
    y = x @ torch.cat([whole[:, i * seg + blk.start:i * seg + blk.stop]
                       for i in range(parts)], dim=-1).to(x.dtype)
    n = blk.stop - blk.start
    return [y[..., i * n:(i + 1) * n] for i in range(parts)]


def _split_rms_norm(h, w, n: int, ax):
    """``layers.rms_norm`` of ``h``, this rank's block of ``n`` channels
    split over the model axis ``ax``: the sum of squares summed over the
    group (``sum_over_model``)."""
    ss = collectives.sum_over_model(
        h.float().square().sum(dim=-1, keepdim=True), ax.mesh)
    return h * torch.rsqrt(ss / n + 1e-6).to(h.dtype) * w.to(h.dtype)


def _mlstm_dims(cfg) -> tuple:
    """(d_in, H, P) of the mLSTM layer."""
    d_in = cfg.expand * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def _mlstm_split(p, cfg):
    """(the installed model axis, this rank's ``_XHeads`` or None, the
    parameters it computes with: the split leaves gathered where the
    heads do not split)."""
    d_in, H, _ = _mlstm_dims(cfg)
    ax, hs = _xsplit(H, d_in)
    if ax is not None and hs is None:
        p = _gathered(p, mlstm_specs(cfg.d_model, n_heads=H,
                                     expand=cfg.expand,
                                     d_conv=cfg.ssm_d_conv), ax)
    return ax, hs, p


def _mlstm_qkvif(x, p, cfg, conv_cache=None, hs=None):
    """Project, conv and split: q, k (scaled by 1/sqrt(P)), v (from the
    pre-conv ``xi``) [B, L, H, P] in x's dtype, the input and forget gate
    pre-activations [B, L, H] in float32, ``xi``, the gate ``z`` and the
    new conv cache (None without ``conv_cache``).

    On a rank's heads ``hs`` (``H/M`` heads, ``d_in/M`` channels) the
    input has entered through ``_enter``, ``up_proj``'s fused ``xi |
    z`` columns are joined (``_fused_cols``) and the conv runs on the
    rank's own channels with its own weights.  ``wq``, ``wk``, ``wv`` and
    ``w_gates`` hold the rank's rows, so each product is its part of the
    whole: the four are laid out by head (``[.., H, 3P + 2]``) and one
    reduce-scatter over the heads (``reduce_scatter_seq``, an all-gather
    backward) gives each rank the sums of its own heads."""
    d_in, H, P = _mlstm_dims(cfg)
    dt = x.dtype
    if hs is None:
        up = x @ p["up_proj"].to(dt)
        xi, z = up[..., :d_in], up[..., d_in:]
    else:
        xi, z = _fused_cols(x, p["up_proj"], 2, hs.ax)
    xc, new_cache = causal_conv1d(xi, p["conv_w"], p["conv_b"],
                                  cache=conv_cache)
    xc = F.silu(xc)
    B, L = x.shape[:2]
    if hs is None:
        q = (xc @ p["wq"].to(dt)).reshape(B, L, H, P)
        k = (xc @ p["wk"].to(dt)).reshape(B, L, H, P) / math.sqrt(P)
        v = (xi @ p["wv"].to(dt)).reshape(B, L, H, P)
        gates = (xc @ p["w_gates"].to(dt)).float()
        i_pre, f_pre = gates[..., :H], gates[..., H:]
    else:
        parts = torch.cat([
            (xc @ p["wq"].to(dt)).reshape(B, L, H, P),
            (xc @ p["wk"].to(dt)).reshape(B, L, H, P),
            (xi @ p["wv"].to(dt)).reshape(B, L, H, P),
            (xc @ p["w_gates"].to(dt)).reshape(B, L, 2, H).transpose(2, 3),
        ], dim=-1)
        parts = collectives.reduce_scatter_seq(parts, hs.ax.mesh, dim=2)
        q, k, v = (parts[..., i * P:(i + 1) * P] for i in range(3))
        k = k / math.sqrt(P)
        gates = parts[..., 3 * P:].float()
        i_pre, f_pre = gates[..., 0], gates[..., 1]
    i_pre = i_pre + p["b_i"].float()
    f_pre = f_pre + p["b_f"].float()
    return q, k, v, i_pre, f_pre, xi, z, new_cache


def _mlstm_out(h, xi, z, p, hs=None):
    """The skip connection, the gate, rms_norm and the down projection;
    on a rank's heads ``hs`` the norm's sum of squares over all of
    ``d_in`` is summed over the group and ``down_proj``'s rows give the
    rank's part of the output, which leaves through ``_leave``."""
    dt_f = h.dtype
    h = h + xi * p["skip"].to(dt_f)
    h = h * F.silu(z)
    if hs is None:
        return layers.rms_norm(h, p["norm_w"]) @ p["down_proj"].to(dt_f)
    h = _split_rms_norm(h, p["norm_w"], p["down_proj"].shape[0] * hs.ax.size,
                        hs.ax)
    return h @ p["down_proj"].to(dt_f)


def mlstm_chunked(x, p, cfg, *, chunk: int = 256, return_state: bool = False):
    """Stabilized chunkwise mLSTM. x: [B, L, D] -> [B, L, D] (+ final state
    ``{"C" [B,H,P,P], "n" [B,H,P], "m" [B,H]`` float32, ``"conv" [B, K-1,
    d_in]}``; on a model axis this rank's heads and channels of them).
    The carry across chunks is (C, n, m), m the running log stabilizer
    (xLSTM eq. 15-19 in chunk form).

    Raises:
        ValueError: ``L`` is not a multiple of ``min(chunk, L)`` (the
            reference asserts it).
    """
    _, H, P = _mlstm_dims(cfg)
    dt_f = x.dtype
    ax, hs, p = _mlstm_split(p, cfg)
    if hs is not None:
        H = hs.hb.stop - hs.hb.start
    x = _enter(x, ax, hs)
    B, L, D = x.shape
    q, k, v, i_pre, f_pre, xi, z, _ = _mlstm_qkvif(x, p, cfg, hs=hs)

    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"mlstm_chunked: length {L} is not a multiple of "
                         f"the chunk {chunk}")
    nc = L // chunk
    log_f = F.logsigmoid(f_pre)                          # [B,L,H]
    qc = q.reshape(B, nc, chunk, H, P)
    kc = k.reshape(B, nc, chunk, H, P)
    vc = v.reshape(B, nc, chunk, H, P)
    ic = i_pre.reshape(B, nc, chunk, H)
    g = torch.cumsum(log_f.reshape(B, nc, chunk, H), dim=2)
    g_tot = g[:, :, -1]                                  # [B,nc,H]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]

    C = torch.zeros((B, H, P, P), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    outs = []
    for c in range(nc):
        qi, ki, vi = (t[:, c].float() for t in (qc, kc, vc))
        ii, gi, gt = ic[:, c], g[:, c], g_tot[:, c]
        # state-contribution log-weights at the end of the chunk
        w = gt[:, None] - gi + ii                        # [B,c,H]
        m_new = torch.maximum(m + gt, w.amax(dim=1))
        scale_old = torch.exp(m + gt - m_new)            # [B,H]
        w_exp = torch.exp(w - m_new[:, None])            # [B,c,H]
        kw = ki * w_exp[..., None]
        C_new = C * scale_old[..., None, None] + torch.einsum(
            "bchp,bchn->bhpn", kw, vi)
        n_new = n * scale_old[..., None] + kw.sum(dim=1)

        # outputs: inter (old state) + intra (this chunk)
        u = gi[:, :, None, :] - gi[:, None, :, :] + ii[:, None, :, :]
        u = torch.where(tri, u, NEG_INF)                 # [B,t,s,H]
        m_out = torch.maximum(m[:, None] + gi, u.amax(dim=2))   # [B,t,H]
        w_inter = torch.exp(m[:, None] + gi - m_out)     # [B,t,H]
        w_intra = torch.exp(u - m_out[:, :, None])       # [B,t,s,H]
        qkw = torch.einsum("bthp,bshp->btsh", qi, ki) * w_intra
        h_intra = torch.einsum("btsh,bshn->bthn", qkw, vi)
        h_inter = torch.einsum("bthp,bhpn->bthn", qi, C) * w_inter[..., None]
        den = torch.einsum("bthp,bhp->bth", qi, n) * w_inter \
            + qkw.sum(dim=2)
        denom = torch.maximum(den.abs(), torch.exp(-m_out))
        outs.append(((h_inter + h_intra) / denom[..., None]).to(dt_f))
        C, n, m = C_new, n_new, m_new
    h = torch.cat(outs, dim=1).reshape(B, L, H * P)
    out = _leave(_mlstm_out(h, xi, z, p, hs), ax, hs)
    if return_state:
        K = p["conv_w"].shape[0]
        # the pre-conv inputs of the last K-1 positions (this rank's
        # channels on a rank's heads), copied out of the projection so
        # that the state does not hold all of it
        return out, {"C": C, "n": n, "m": m,
                     "conv": xi[:, -(K - 1):, :].contiguous()}
    return out


def mlstm_init_state(batch: int, cfg, dtype=torch.float32,
                     device=None) -> dict:
    d_in = cfg.expand * cfg.d_model
    H = cfg.n_heads
    P = d_in // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, P, P), **f32),
        "n": torch.zeros((batch, H, P), **f32),
        "m": torch.zeros((batch, H), **f32),
        "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, d_in), dtype=dtype,
                            device=device),
    }


def mlstm_step(x, state, p, cfg):
    """Decode one token, the exact recurrent form. x: [B, 1, D] -> (y
    [B, 1, D], new state); on a model axis the state holds this rank's
    heads and channels, as ``mlstm_chunked`` returns them."""
    B = x.shape[0]
    dt_f = x.dtype
    ax, hs, p = _mlstm_split(p, cfg)
    x = _enter(x, ax, hs)
    q, k, v, i_pre, f_pre, xi, z, conv_cache = _mlstm_qkvif(
        x, p, cfg, conv_cache=state["conv"], hs=hs)
    q, k, v = (t[:, 0].float() for t in (q, k, v))               # [B,H,P]
    ii = i_pre[:, 0]
    lf = F.logsigmoid(f_pre[:, 0])                                # [B,H]
    m_new = torch.maximum(lf + state["m"], ii)
    sf = torch.exp(lf + state["m"] - m_new)
    si = torch.exp(ii - m_new)
    C = state["C"] * sf[..., None, None] + si[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = state["n"] * sf[..., None] + si[..., None] * k
    num = torch.einsum("bhp,bhpn->bhn", q, C)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, -1).to(dt_f)
    y = _leave(_mlstm_out(h, xi, z, p, hs), ax, hs)
    return y, {"C": C, "n": n, "m": m_new, "conv": conv_cache}


# ===========================================================================
# sLSTM - scalar-memory LSTM with exponential gating (sequential)
# ===========================================================================
def slstm_specs(d: int, *, n_heads: int) -> dict:
    P = d // n_heads
    return {
        "w_in": ParamSpec((d, 4 * d), ("embed", "inner")),
        "r": ParamSpec((n_heads, P, 4 * P), ("heads", "head_dim", None),
                       scale=0.5),
        "b": ParamSpec((4 * d,), ("inner",), init="zeros"),
        "norm_w": ParamSpec((d,), ("embed",), init="ones"),
        "up": ParamSpec((d, 2 * d), ("embed", "d_ff")),
        "down": ParamSpec((d, d), ("d_ff", "embed")),
    }


def _slstm_cell(x_t, h_prev, state, r, H, P):
    """One step. x_t: [B, 4d] pre-activations from the input; h_prev
    [B, H, P]; ``r`` the recurrent matrix [H, P, 4P] in h_prev's dtype
    (float32: the carry's, as the reference casts it)."""
    c, n, m = state
    rec = torch.einsum("bhp,hpq->bhq", h_prev, r)
    pre = x_t.reshape(x_t.shape[0], H, 4 * P) + rec
    zi, ii, fi, oi = pre.float().chunk(4, dim=-1)
    zt = torch.tanh(zi)
    it = ii.mean(-1)                       # scalar gates per head
    ft = fi.mean(-1)
    ot = torch.sigmoid(oi)
    m_new = torch.maximum(ft + m, it)
    ig = torch.exp(it - m_new)[..., None]
    fg = torch.exp(ft + m - m_new)[..., None]
    c_new = fg * c + ig * zt
    n_new = fg * n + ig
    h_new = ot * (c_new / torch.clamp(n_new, min=1e-6))
    return h_new, (c_new, n_new, m_new)


def _slstm_split(p, cfg):
    """(this rank's ``_XHeads`` or None, the parameters it computes
    with), as ``_mlstm_split``: heads that do not split (tiny xlstm's 2
    at ``model=4``, where ``w_in``'s columns still do: a rank's block
    would be part of a head) run the whole layer on gathered leaves."""
    H, D = cfg.n_heads, cfg.d_model
    ax, hs = _xsplit(H, 4 * D)
    if ax is not None and hs is None:
        p = _gathered(p, slstm_specs(D, n_heads=H), ax)
    return ax, hs, p


def _slstm_out(h, p, D: int, hs=None):
    """rms_norm, the gelu-gated up projection and the down projection.
    On a rank's heads ``hs`` its heads' ``h`` are gathered whole
    (``gather_from_model``), normed alike on every rank and enter the
    projections through ``copy_to_model``; ``up``'s fused ``gelu | up``
    columns are joined (``_fused_cols``) and ``down``'s rows leave
    through ``reduce_from_model``.  Where ``d_ff`` does not split, every
    rank computes the projections whole on gathered leaves.  Under
    sequence parallelism the heads are joined by ``all_gather_seq``
    (whose backward sums the ranks' parts, so no ``copy_to_model``
    follows) and the output leaves to the rank's rows: reduce-scattered
    where ``d_ff`` splits, cut where it does not (``layers.leave_split``),
    so that ``norm_w``'s gradient is the rank's part, as every unsplit
    leaf's is under sequence parallelism."""
    dt_f = h.dtype
    ax = None if hs is None else hs.ax
    if ax is not None:
        h = collectives.all_gather_seq(h, ax.mesh, dim=-1) if ax.seq \
            else collectives.gather_from_model(h, ax.mesh, -1)
    h = layers.rms_norm(h, p["norm_w"])
    if ax is not None and ax.split("d_ff", 2 * D) and ax.split("d_ff", D):
        if not ax.seq:
            h = collectives.copy_to_model(h, ax.mesh)
        g, u = _fused_cols(h, p["up"], 2, ax)
        return layers.leave_split((layers.gelu(g) * u) @ p["down"].to(dt_f),
                                  ax, True)
    if ax is not None:          # (the heads do not shape up or down)
        p = _gathered(p, {k: v for k, v in slstm_specs(D, n_heads=1).items()
                          if k in ("up", "down")}, ax)
    u = h @ p["up"].to(dt_f)
    u = layers.gelu(u[..., :D]) * u[..., D:]
    return layers.leave_split(u @ p["down"].to(dt_f), ax, False)


def slstm_apply(x, p, cfg, *, return_state: bool = False):
    """x: [B, L, D]; a sequential loop over L (no parallel form exists).
    ``cfg`` needs ``n_heads`` (the sLSTM's heads) and ``d_model``.
    With ``return_state``, also the final state ``{"h", "c", "n"}
    [B, H, P], ``"m"`` [B, H]``, all float32.  On a rank's heads the
    input enters through ``copy_to_model``, ``w_in``'s and ``b``'s
    columns and ``r`` are this rank's heads', and the recurrence runs on
    them with no collective inside the loop (the state is this rank's
    heads')."""
    H = cfg.n_heads
    dt_f = x.dtype
    ax, hs, p = _slstm_split(p, cfg)
    if hs is not None:
        H = hs.hb.stop - hs.hb.start
    x = _enter(x, ax, hs)
    B, L, D = x.shape
    P = D // cfg.n_heads
    pre = x @ p["w_in"].to(dt_f) + p["b"].to(dt_f)
    r = p["r"].float()
    h = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
    st = (torch.zeros_like(h), torch.zeros_like(h),
          torch.zeros((B, H), dtype=torch.float32, device=x.device))
    outs = []
    for t in range(L):
        h, st = _slstm_cell(pre[:, t], h, st, r, H, P)
        # the carry stays float32; the stacked outputs are in the compute
        # dtype, as the reference emits them
        outs.append(h.to(dt_f))
    out = _slstm_out(torch.stack(outs, dim=1).reshape(B, L, H * P), p, D,
                     hs)
    if hs is None:
        out = _leave(out, ax, hs)
    if return_state:
        c, n, m = st
        return out, {"h": h, "c": c, "n": n, "m": m}
    return out


def slstm_init_state(batch: int, cfg, dtype=torch.float32,
                     device=None) -> dict:
    H = cfg.n_heads
    P = cfg.d_model // H
    z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                               device=device)
    return {"h": z(batch, H, P), "c": z(batch, H, P), "n": z(batch, H, P),
            "m": z(batch, H)}


def slstm_step(x, state, p, cfg):
    """Decode one token. x: [B, 1, D] -> (y [B, 1, D], new state); on a
    model axis the state holds this rank's heads, as ``slstm_apply``
    returns them."""
    B, _, D = x.shape
    H = cfg.n_heads
    P = D // H
    dt_f = x.dtype
    ax, hs, p = _slstm_split(p, cfg)
    if hs is not None:
        H = hs.hb.stop - hs.hb.start
    x = _enter(x, ax, hs)
    pre = (x @ p["w_in"].to(dt_f) + p["b"].to(dt_f))[:, 0]
    h_new, (c, n, m) = _slstm_cell(
        pre, state["h"], (state["c"], state["n"], state["m"]),
        p["r"].to(state["h"].dtype), H, P)
    y = _slstm_out(h_new.reshape(B, 1, H * P).to(dt_f), p, D, hs)
    return y, {"h": h_new, "c": c, "n": n, "m": m}
