"""Shared neural-net layers (functional; params are plain dicts of tensors).

Counterpart: ``repro/models/layers.py``.  Every parameter is declared
through ``ParamSpec`` with logical dims, as in the JAX package.  The dtype
order is kept exactly: ``rms_norm`` takes its statistics in float32 and
scales in the input dtype; ``layer_norm`` takes its statistics in
float32 and normalizes in the input dtype; RoPE rotates the split halves
in float32 and casts back; the cross entropy reduces in float32.  The
gelu MLP uses the tanh approximation, which is ``jax.nn.gelu``'s
default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sharding import ParamSpec


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-6):
    """Statistics in fp32, scaling in the input dtype."""
    msq = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(msq + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    """Mean and variance in fp32, normalization and affine in the input
    dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return y * w.to(x.dtype) + b.to(x.dtype)


def norm_specs(d: int, kind: str) -> dict:
    if kind == "rms":
        return {"w": ParamSpec((d,), ("embed",), init="ones")}
    return {"w": ParamSpec((d,), ("embed",), init="ones"),
            "b": ParamSpec((d,), ("embed",), init="zeros")}


def apply_norm(x, p, kind: str, eps: float = 1e-6):
    if kind == "rms":
        return rms_norm(x, p["w"], eps)
    return layer_norm(x, p["w"], p["b"], eps)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # [hd/2]
    angles = positions[..., None].float() * freqs              # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(seq: int, d: int, device=None):
    """[seq, d] float32: the sines of the positions' angles, then their
    cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / 10000.0 ** (2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def gelu(x):
    """``jax.nn.gelu``'s default form: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_specs(d: int, ff: int, kind: str = "swiglu") -> dict:
    if kind == "swiglu":
        return {
            "w_gate": ParamSpec((d, ff), ("embed", "d_ff")),
            "w_up": ParamSpec((d, ff), ("embed", "d_ff")),
            "w_down": ParamSpec((ff, d), ("d_ff", "embed")),
        }
    return {  # gelu
        "w_up": ParamSpec((d, ff), ("embed", "d_ff")),
        "b_up": ParamSpec((ff,), ("d_ff",), init="zeros"),
        "w_down": ParamSpec((ff, d), ("d_ff", "embed")),
        "b_down": ParamSpec((d,), ("embed",), init="zeros"),
    }


def apply_mlp(x, p, kind: str = "swiglu"):
    dt = x.dtype
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    h = gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_specs(vocab: int, d: int) -> dict:
    return {"tok": ParamSpec((vocab, d), ("vocab", "embed"), init="scaled",
                             scale=0.02)}


def embed(tokens, p):
    return F.embedding(tokens, p["tok"])


def unembed_specs(d: int, vocab: int) -> dict:
    return {"w": ParamSpec((d, vocab), ("embed", "vocab"))}


def logits(x, p):
    return x @ p["w"].to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(lg, labels, mask=None):
    """Token-mean cross entropy; fp32 for the reduction.  With ``mask``,
    the mean over the tokens it keeps (at least 1)."""
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
