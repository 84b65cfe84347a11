"""Blocks of every family: specs, the training forward, prefill (returns
the populated cache or state) and single-token decode.

Counterpart: ``repro/models/blocks.py``: the pre-norm residual transformer
block with an MLP or a mixture of experts and optional cross-attention
(``tblock_specs``, ``tblock_apply``, ``kv_cache_specs``,
``tblock_prefill``, ``tblock_decode``), the Mamba-2 block
(``mamba_block_specs``, ``mamba_block_apply``, ``mamba_block_prefill``,
``mamba_block_decode``, ``mamba_state_specs``) and the xLSTM blocks
(``mlstm_block_*``, ``mlstm_state_specs``, ``slstm_block_*``,
``slstm_state_specs``).  The state specs take no stacked ``prefix``: the
port's model keeps one spec per layer in nested lists.

Cross-attention (the enc-dec decoder) takes the encoder's K/V from the
caller, projected without biases as the reference's ``EncDec`` does; only
its query gets ``bq``.  It always runs through ``attention.attend_full``
(the query and key lengths differ, which K1 does not take), as the
reference computes it with jnp.

On a mesh with a model axis the transformer block is Megatron's: the
normed input enters the attention and the MLP through
``collectives.copy_to_model``, each rank computes its own heads and its
own ``d_ff`` columns, and the row-parallel out projection
(``_out_proj``) and ``w_down`` leave through
``collectives.reduce_from_model`` (the gelu MLP's ``b_down`` is added
once, after the sum); the residual stream and the norms are the same on
every rank.  Whisper's encoder runs it non-causal and its decoder's
cross-attention splits the same way (``_cross``: this rank's query
heads against its kv heads of the encoder's K/V).  A moe block's
experts split instead of its ``d_ff`` (``moe.apply_moe``: every rank
routes every token, runs its own experts and sums over the group),
zamba's shared block is the dense one, and the mamba, mLSTM and sLSTM
blocks run their mixers on this rank's heads (``ssm.py``: their states
hold this rank's heads and its block of the conv channels, the blocks
the state specs give on the mesh).  Under
sequence parallelism (the hook's ``seq``) the residual and the norms
hold this rank's rows of the sequence: the attention and the MLP enter
through ``collectives.all_gather_seq`` (RoPE and the qk-norms see the
whole sequence, K1 this rank's heads of it, as without) and leave
through ``collectives.reduce_scatter_seq`` (``layers.enter_split``,
``layers.leave_split``).
"""
from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from ..core import collectives
from ..core.sharding import ParamSpec
from . import attention, layers, moe, ssm


def tblock_specs(cfg, *, cross: bool = False, use_moe: bool = False) -> dict:
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
    if cross:
        sp["ln_cross"] = layers.norm_specs(cfg.d_model, cfg.norm)
        sp["cross"] = attention.attn_specs(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=False)
    return sp


def _ffn(h, p, cfg):
    """The block's feed-forward half on the normed ``h``: (y, aux loss),
    the aux a float32 zero for an MLP."""
    if "moe" in p:
        return moe.apply_moe(h, p["moe"], top_k=cfg.top_k,
                             group_size=cfg.moe_group,
                             dispatch=cfg.moe_dispatch,
                             n_experts=cfg.n_experts, d_ff=cfg.d_ff)
    return (layers.apply_mlp(h, p["mlp"], cfg.mlp_kind, d_ff=cfg.d_ff),
            torch.zeros((), dtype=torch.float32, device=h.device))


def kv_cache_specs(cfg, batch: int, seq: int) -> dict:
    """One layer's cache: {"k", "v"} [batch, seq, Hkv, hd] in cache dtype."""
    mk = lambda: ParamSpec((batch, seq, cfg.n_kv_heads, cfg.head_dim),  # noqa: E731
                           ("batch", "kv_seq", "kv_heads", "head_dim"),
                           dtype=cfg.cache_dtype, init="zeros")
    return {"k": mk(), "v": mk()}


def _out_proj(o, wo, dt, hp=None):
    """The attention's out projection; row-parallel (this rank's heads'
    rows of ``wo``, summed over the model group) under a head plan that
    splits the heads; cut to this rank's rows under sequence
    parallelism."""
    y = torch.einsum("bqhk,hkd->bqd", o, wo.to(dt))
    if hp is None:
        return y
    return layers.leave_split(y, hp.ax, hp.heads)


def _attn_in(h, cfg, cache_len=None):
    """(the attention's input, its head plan): ``h`` enters a head-split
    attention through ``copy_to_model``, or gathered by sequence under
    sequence parallelism."""
    hp = attention.head_plan(cfg.n_heads, cfg.n_kv_heads, cache_len)
    if hp is not None:
        h = layers.enter_split(h, hp.ax, hp.heads)
    return h, hp


def _pick(hp, k, v):
    return (k, v) if hp is None else hp.pick_kv(k, v)


def _enc_tiles(cfg):
    """The tiles of the cross-attention cache's ``kv_seq`` (the encoder's
    ``enc_frames``) under the installed hook (None: whole on every
    rank)."""
    hook = attention.act_axis()
    return None if hook is None else hook.tiles("kv_seq", cfg.enc_frames)


def _cross(x, p, cfg, enc_kv, tiles=None):
    """The cross-attention half: x [B,S,D] attends the encoder's ``enc_kv``
    = (ck, cv) [B, S_enc, Hkv, hd], non-causal, with plain tensor code.
    With ``tiles`` (decode against a sequence-tiled cross cache: this
    rank's ``tiles.block`` of the encoder's positions) each rank attends
    its block and the partials merge over the tiles' group.  On a model
    axis that splits the heads the normed ``x`` enters through
    ``copy_to_model``, the query and ``bq`` are this rank's heads,
    ``enc_kv`` this rank's kv heads (or every kv head, of which it picks
    the ones its heads read: with every query head, gathered, against a
    cache tiled over the model group) and ``wo``'s rows leave through
    ``reduce_from_model``."""
    h = layers.apply_norm(x, p["ln_cross"], cfg.norm)
    h, hp = _attn_in(h, cfg)
    q = torch.einsum("bsd,dhk->bshk", h, p["cross"]["wq"].to(x.dtype))
    if "bq" in p["cross"]:
        q = q + p["cross"]["bq"].to(x.dtype)
    if tiles is None:
        o = attention.attend_full(q, *_pick(hp, *enc_kv), causal=False)
    else:
        gather_q = hp is not None and hp.heads and "model" in tiles.axes
        if gather_q:
            q = collectives.all_gather(q, hp.ax.mesh, axis=2,
                                       mesh_axis="model")
            kv = enc_kv
        else:
            kv = _pick(hp, *enc_kv)
        part = attention.decode_partial(q, *kv, cfg.enc_frames,
                                        offset=tiles.block.start)
        o = collectives.softmax_combine(part, tiles.mesh,
                                        mesh_axis=tiles.axis).to(q.dtype)
        if gather_q:
            o = o[:, :, hp.ax.block(cfg.n_heads)]
    return x + _out_proj(o, p["cross"]["wo"], x.dtype, hp)


def tblock_apply(x, p, cfg, *, causal: bool = True, enc_kv=None):
    """The training forward of the block: x [B,S,D] -> (x [B,S,D], aux
    loss); self-attention (causal, or not: the encoder) through the
    flash-attention kernel, whose backward is a kernel too, then
    cross-attention to ``enc_kv`` where the block has it."""
    h = layers.apply_norm(x, p["ln_attn"], cfg.norm)
    h, hp = _attn_in(h, cfg)
    q, k, v = attention.project_qkv(
        h, p["attn"], rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    k, v = _pick(hp, k, v)
    o = attention.attend(q, k, v, causal=causal, window=cfg.sliding_window)
    x = x + _out_proj(o, p["attn"]["wo"], x.dtype, hp)
    if "cross" in p:
        x = _cross(x, p, cfg, enc_kv)
    h = layers.apply_norm(x, p["ln_mlp"], cfg.norm)
    y, aux = _ffn(h, p, cfg)
    return x + y, aux


def tblock_prefill(x, p, cfg, cache_len: int, *, enc_kv=None):
    """Run the block over a full prompt, returning (x, kv-cache cast to
    the cache dtype and padded to cache_len).  A block with
    cross-attention also caches the encoder's K/V as ``"ck"``, ``"cv"``."""
    h = layers.apply_norm(x, p["ln_attn"], cfg.norm)
    h, hp = _attn_in(h, cfg, cache_len)
    q, k, v = attention.project_qkv(
        h, p["attn"], rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    o = attention.attend(q, *_pick(hp, k, v), causal=True,
                         window=cfg.sliding_window)
    x = x + _out_proj(o, p["attn"]["wo"], x.dtype, hp)
    pad = cache_len - k.shape[1]
    cache = {"k": F.pad(k.to(cfg.cache_dtype), (0, 0, 0, 0, 0, pad)),
             "v": F.pad(v.to(cfg.cache_dtype), (0, 0, 0, 0, 0, pad))}
    if hp is not None and hp.seq:        # this rank's cache positions
        b = hp.seq_block
        cache = {n: c[:, b].contiguous() for n, c in cache.items()}
    if "cross" in p:
        x = _cross(x, p, cfg, enc_kv)
        tiles = _enc_tiles(cfg)
        cache["ck"], cache["cv"] = enc_kv if tiles is None else (
            c[:, tiles.block].contiguous() for c in enc_kv)
    h = layers.apply_norm(x, p["ln_mlp"], cfg.norm)
    return x + _ffn(h, p, cfg)[0], cache


def tblock_decode(x, p, cfg, cache, pos, *, enc_kv=None):
    """x: [B,1,D]; cache: {"k","v"} [B,S,Hkv,hd], updated in place; pos:
    scalar int, or a ``[B]`` tensor of per-row positions.  A block with
    cross-attention attends ``enc_kv`` (the encoder's K/V the cache holds
    as ``"ck"``, ``"cv"``) and returns them in the new cache."""
    h = layers.apply_norm(x, p["ln_attn"], cfg.norm)
    if isinstance(pos, torch.Tensor) and pos.dim():
        positions = pos.to(x.device)[:, None]
    else:
        positions = torch.full((h.shape[0], 1), int(pos), device=x.device)
    hook = attention.act_axis()
    h, hp = _attn_in(h, cfg, None if hook is None else hook.cache_len)
    q, k, v = attention.project_qkv(
        h, p["attn"], positions=positions,
        rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    off = hp.seq_block.start if hp is not None and hp.seq else 0
    kc, vc = attention.cache_update(cache["k"], cache["v"], k, v, pos,
                                    mode=cfg.cache_update, offset=off)
    if hp is not None and hp.seq:
        # a sequence-tiled cache: the query heads against this rank's
        # positions, the partials merged over the cache's group (every
        # query head where that group spans the model axis)
        if hp.gather_q:
            q = collectives.all_gather(q, hp.ax.mesh, axis=2,
                                       mesh_axis="model")
            kv = (kc, vc)
        else:
            kv = _pick(hp, kc, vc)
        part = attention.decode_partial(q, *kv, pos, offset=off,
                                        window=cfg.sliding_window)
        o = collectives.softmax_combine(part, hp.seq.mesh,
                                        mesh_axis=hp.seq.axis).to(q.dtype)
        if hp.gather_q:
            o = o[:, :, hp.ax.block(cfg.n_heads)]
    else:
        o = attention.decode_attend(q, *_pick(hp, kc, vc), pos,
                                    window=cfg.sliding_window)
    x = x + _out_proj(o, p["attn"]["wo"], x.dtype, hp)
    new_cache = {"k": kc, "v": vc}
    if "cross" in p:
        x = _cross(x, p, cfg, enc_kv, _enc_tiles(cfg))
        new_cache["ck"], new_cache["cv"] = enc_kv
    h = layers.apply_norm(x, p["ln_mlp"], cfg.norm)
    return x + _ffn(h, p, cfg)[0], new_cache


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


# ---------------------------------------------------------------------------
# xLSTM blocks (pre-norm + mixer; the mixers carry their own projections)
# ---------------------------------------------------------------------------
def mlstm_block_specs(cfg) -> dict:
    return {
        "ln": layers.norm_specs(cfg.d_model, cfg.norm),
        "mixer": ssm.mlstm_specs(cfg.d_model, n_heads=cfg.n_heads,
                                 expand=cfg.expand, d_conv=cfg.ssm_d_conv),
    }


def mlstm_block_apply(x, p, cfg, *, chunk: int = 256):
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    return x + ssm.mlstm_chunked(h, p["mixer"], cfg, chunk=chunk)


def mlstm_block_prefill(x, p, cfg, *, chunk: int = 256):
    """Returns (x, state ``{"C", "n", "m", "conv"}``)."""
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    y, st = ssm.mlstm_chunked(h, p["mixer"], cfg, chunk=chunk,
                              return_state=True)
    return x + y, st


def mlstm_block_decode(x, p, cfg, state, pos):
    """x: [B,1,D]; the recurrent state needs no position."""
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    y, state = ssm.mlstm_step(h, state, p["mixer"], cfg)
    return x + y, state


def mlstm_state_specs(cfg, batch: int) -> dict:
    """One layer's state: ``"C"`` [batch, H, P, P], ``"n"`` [batch, H, P]
    and ``"m"`` [batch, H] in float32, ``"conv"`` [batch, K-1, d_in] in the
    cache dtype."""
    d_in = cfg.expand * cfg.d_model
    H = cfg.n_heads
    P = d_in // H
    f32 = torch.float32
    return {
        "C": ParamSpec((batch, H, P, P), ("batch", "heads", "head_dim",
                                          "state"), dtype=f32, init="zeros"),
        "n": ParamSpec((batch, H, P), ("batch", "heads", "head_dim"),
                       dtype=f32, init="zeros"),
        "m": ParamSpec((batch, H), ("batch", "heads"), dtype=f32,
                       init="zeros"),
        "conv": ParamSpec((batch, cfg.ssm_d_conv - 1, d_in),
                          ("batch", "conv", "inner"),
                          dtype=cfg.cache_dtype, init="zeros"),
    }


def _slstm_cfg(cfg):
    """The sLSTM mixer's view of ``cfg``: its own head count."""
    return types.SimpleNamespace(n_heads=cfg.slstm_heads,
                                 d_model=cfg.d_model)


def slstm_block_specs(cfg) -> dict:
    return {
        "ln": layers.norm_specs(cfg.d_model, cfg.norm),
        "mixer": ssm.slstm_specs(cfg.d_model, n_heads=cfg.slstm_heads),
    }


def slstm_block_apply(x, p, cfg):
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    return x + ssm.slstm_apply(h, p["mixer"], _slstm_cfg(cfg))


def slstm_block_prefill(x, p, cfg):
    """Returns (x, state ``{"h", "c", "n", "m"}``)."""
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    y, st = ssm.slstm_apply(h, p["mixer"], _slstm_cfg(cfg),
                            return_state=True)
    return x + y, st


def slstm_block_decode(x, p, cfg, state, pos):
    h = layers.apply_norm(x, p["ln"], cfg.norm)
    y, state = ssm.slstm_step(h, state, p["mixer"], _slstm_cfg(cfg))
    return x + y, state


def slstm_state_specs(cfg, batch: int) -> dict:
    """One layer's state, all float32: ``"h"``, ``"c"``, ``"n"`` [batch,
    H, P] and ``"m"`` [batch, H], H the sLSTM's heads."""
    H = cfg.slstm_heads
    P = cfg.d_model // H
    mk = lambda *s, dims: ParamSpec(s, dims, dtype=torch.float32,  # noqa: E731
                                    init="zeros")
    return {
        "h": mk(batch, H, P, dims=("batch", "heads", "head_dim")),
        "c": mk(batch, H, P, dims=("batch", "heads", "head_dim")),
        "n": mk(batch, H, P, dims=("batch", "heads", "head_dim")),
        "m": mk(batch, H, dims=("batch", "heads")),
    }
