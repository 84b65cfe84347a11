"""State-space mixer of the zamba family: Mamba-2 (SSD).

Counterpart: ``repro/models/ssm.py``, its Mamba-2 part (``causal_conv1d``,
``mamba2_specs``, ``_mamba2_split``, ``mamba2_chunked``,
``mamba2_init_state``, ``mamba2_step``); mLSTM and sLSTM wait for the
xlstm family (ROADMAP item 11).  The same contract as attention: a chunked
form for prefill and a step form for decode carrying an explicit state.

``mamba2_chunked`` keeps every step of the JAX function up to the scan and
then sends the scan to the chunk-scan kernel (``kernels/mamba2_scan.py``,
``[B, H, L, .]``): on CUDA tensors it launches the kernel or raises, on
CPU tensors it runs the kernel's plain version.  This differs from the
JAX package on purpose, as ``attend`` does for attention: the JAX model
computes the scan with jnp einsums and never calls its own Pallas kernel.
``mamba2_step`` (decode) stays plain tensor code: no kernel exists for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sharding import ParamSpec
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


def _mamba2_split(x, p, cfg):
    """Project and split into (z, xbc-conv inputs, dt)."""
    d_in = cfg.expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * gn]
    dt = zxbcdt[..., -H:]
    return z, xbc, dt


def _gate_out(y, xs, z, p, d_in: int):
    """``+ xs D``, the gated rms_norm and the output projection."""
    dt_f = y.dtype
    y = y + xs * p["D"].to(dt_f)[:, None]
    y = y.reshape(*y.shape[:-2], d_in)
    y = layers.rms_norm(y * F.silu(z), p["norm_w"])
    return y @ p["out_proj"].to(dt_f)


def mamba2_chunked(x, p, cfg, *, chunk: int = 256, return_state: bool = False):
    """Prefill pass. x: [B, L, D] -> [B, L, D] (+ final state
    ``{"ssm": [B, H, P, N] float32, "conv": [B, K-1, conv channels]}``)."""
    B, L, D = x.shape
    d_in = cfg.expand * D
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = cfg.ssm_groups
    dt_f = x.dtype

    z, xbc_in, dt = _mamba2_split(x, p, cfg)
    xbc, _ = causal_conv1d(xbc_in, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(B, L, H, P)
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, L, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B, L, G, N)
    rep = H // G
    Bm = Bm.repeat_interleave(rep, dim=2)            # [B,L,H,N]
    Cm = Cm.repeat_interleave(rep, dim=2)

    dt = F.softplus(dt.float() + p["dt_bias"].float())             # [B,L,H]
    A = -torch.exp(p["A_log"].float())                             # [H]
    a = dt * A[None, None]                                         # log decay
    xdt = xs * dt.to(dt_f)[..., None]                              # dt-weighted

    # the kernel's layout: [B, H, L, .]
    y, S_final = mamba2_chunk_scan(
        xdt.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous(),
        Bm.transpose(1, 2).contiguous(), Cm.transpose(1, 2).contiguous(),
        chunk=chunk)
    out = _gate_out(y.transpose(1, 2), xs, z, p, d_in)
    if return_state:
        K = p["conv_w"].shape[0]
        # the pre-conv inputs of the last K-1 positions, copied out of the
        # projection so that the cache does not hold all of it
        conv = xbc_in[:, -(K - 1):, :].contiguous()
        return out, {"ssm": S_final, "conv": conv}
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


def mamba2_step(x, state, p, cfg):
    """Decode one token. x: [B, 1, D] -> (y [B,1,D], new state)."""
    B, _, D = x.shape
    d_in = cfg.expand * D
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = cfg.ssm_groups

    z, xbc, dt = _mamba2_split(x, p, cfg)
    xbc, conv_cache = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                    cache=state["conv"])
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(B, H, P)
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, G, N).repeat_interleave(
        H // G, dim=1)
    Cm = xbc[..., d_in + G * N:].reshape(B, G, N).repeat_interleave(
        H // G, dim=1)

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())       # [B,H]
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None])                                # [B,H]
    S = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhp,bhe,bh->bhpe", xs.float(), Bm.float(), dt)
    y = torch.einsum("bhpe,bhe->bhp", S, Cm.float()).to(x.dtype)
    out = _gate_out(y[:, None], xs[:, None], z, p, d_in)
    return out, {"ssm": S, "conv": conv_cache}
