"""Shared neural-net layers (functional; params are plain dicts of tensors).

Counterpart: ``repro/models/layers.py``.  Every parameter is declared
through ``ParamSpec`` with logical dims, as in the JAX package.  The dtype
order is kept exactly: ``rms_norm`` takes its statistics in float32 and
scales in the input dtype; ``layer_norm`` takes its statistics in
float32 and normalizes in the input dtype; RoPE rotates the split halves
in float32 and casts back; the cross entropy reduces in float32.  The
gelu MLP uses the tanh approximation, which is ``jax.nn.gelu``'s
default.

On a mesh with a model axis (``core.sharding.model_axis()``: the hook a
step installs) the layers that the tiling plan splits compute their
share and exchange over the model group, as the reference's SPMD
partitioner does: the embedding is vocab-parallel (each rank looks up
the tokens of its rows, the model group sums), the logits are this
rank's vocab columns, ``softmax_xent`` reduces over the group
(``vocab_parallel_xent``), the MLP splits ``d_ff`` (column-parallel
``w_gate``/``w_up``, row-parallel ``w_down``, ``b_down`` added once after
the sum) and ``greedy`` takes the argmax over the whole vocab.  Each
takes the dim's global size from its caller; without the hook, or when
the dim does not divide, they are the one-process code.

Under sequence parallelism (the hook's ``seq``) the residual between
blocks holds this rank's rows of the sequence: a split product enters
through ``collectives.all_gather_seq`` and leaves through
``collectives.reduce_scatter_seq`` (``enter_split``, ``leave_split``),
an unsplit one computes the whole sequence and keeps its rows; the
embedding's vocab-parallel sum is the reduce-scatter, and the logits
take the gathered sequence after ``ln_f``.

Every family runs on the model axis through these layers (an odd
vocab, granite's or whisper's, stays whole: every rank computes its
embedding and logits alike); a moe layer's experts and the mamba,
mLSTM and sLSTM layers' heads split in ``moe.py`` and ``ssm.py``, whose
norms over a split ``d_in`` sum their squares over the group rather
than calling ``rms_norm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import collectives
from ..core.sharding import ParamSpec, model_axis


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


def _split(dim: str, n):
    """The model axis when the hook splits the logical ``dim`` of global
    size ``n`` (None: the one-process code)."""
    ax = model_axis()
    return ax if ax is not None and n is not None and ax.split(dim, n) \
        else None


def enter_split(x, ax, split: bool):
    """The input ``[B, S, D]`` of a product on the model axis ``ax``
    (None: one process) that splits its output columns over the group
    (``split``) or not: under sequence parallelism every rank's rows,
    gathered; else ``copy_to_model`` where it splits."""
    if ax is None:
        return x
    if ax.seq:
        return collectives.all_gather_seq(x, ax.mesh)
    return collectives.copy_to_model(x, ax.mesh) if split else x


def leave_split(y, ax, split: bool):
    """The output ``[B, S, D]`` of a product that ``enter_split`` began:
    summed over the group where it split (row-parallel), and under
    sequence parallelism cut to this rank's rows (a reduce-scatter, or
    a plain cut of a whole output)."""
    if ax is None:
        return y
    if ax.seq:
        return collectives.reduce_scatter_seq(y, ax.mesh) if split \
            else y[:, ax.seq_block]
    return collectives.reduce_from_model(y, ax.mesh) if split else y


def apply_mlp(x, p, kind: str = "swiglu", d_ff=None):
    """The MLP; ``d_ff`` (global) lets it split over the model axis."""
    ax = model_axis()
    split = _split("d_ff", d_ff) is not None
    x = enter_split(x, ax, split)
    dt = x.dtype
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return leave_split(h @ p["w_down"].to(dt), ax, split)
    h = gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    y = leave_split(h @ p["w_down"].to(dt), ax, split)
    return y + p["b_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_specs(vocab: int, d: int) -> dict:
    return {"tok": ParamSpec((vocab, d), ("vocab", "embed"), init="scaled",
                             scale=0.02)}


def embed(tokens, p, vocab=None):
    """Token embedding; ``vocab`` (global) lets it split over the model
    axis: each rank looks up the tokens of its own rows (zeros for the
    others) and the model group sums, exactly (under sequence
    parallelism, the sum of this rank's rows of the sequence)."""
    ax = _split("vocab", vocab)
    if ax is None:
        return F.embedding(tokens, p["tok"])
    rows = ax.block(vocab)
    local = tokens - rows.start
    hit = (local >= 0) & (local < rows.stop - rows.start)
    out = F.embedding(torch.where(hit, local, torch.zeros_like(local)),
                      p["tok"])
    out = out.masked_fill(~hit[..., None], 0)
    return leave_split(out, ax, True)


def unembed_specs(d: int, vocab: int) -> dict:
    return {"w": ParamSpec((d, vocab), ("embed", "vocab"))}


def logits(x, p, vocab=None):
    """``[..., vocab]``; split over the model axis (``vocab`` global):
    this rank's vocab columns (of the whole sequence, gathered, under
    sequence parallelism, which needs the vocab split: the loss's
    exchange is over the vocab).

    Raises:
        ValueError: a residual split by sequence with a vocab that is
            not.
    """
    ax = model_axis()
    split = _split("vocab", vocab) is not None
    if ax is not None and ax.seq and not split:
        raise ValueError(f"sequence parallelism with a vocab of {vocab} "
                         f"that does not split over {ax.size} ranks")
    x = enter_split(x, ax, split)
    return x @ p["w"].to(x.dtype)


def greedy(lg, vocab=None):
    """The argmax over the last dim of logits that may be split over the
    model axis (``vocab`` global): each rank's (max, global index) is
    gathered and ties go to the lowest global index, as ``torch.argmax``
    breaks them."""
    ax = _split("vocab", vocab)
    if ax is None:
        return lg.argmax(-1)
    val, idx = lg.max(-1)
    idx = idx + ax.block(vocab).start
    both = torch.stack([val.float(), idx.float()])
    allr = collectives.all_gather(both, ax.mesh, tiled=False,
                                  mesh_axis="model")        # [M, 2, ...]
    best = allr[:, 0].max(0).values
    cand = torch.where(allr[:, 0] == best, allr[:, 1],
                       torch.full_like(allr[:, 1], float("inf")))
    return cand.min(0).values.long()


def gather_vocab(lg, vocab=None):
    """The whole ``[..., vocab]`` logits of a model group's columns (a
    collective; ``lg`` itself where the vocab is not split)."""
    ax = _split("vocab", vocab)
    if ax is None:
        return lg
    return collectives.all_gather(lg, ax.mesh, axis=lg.dim() - 1,
                                  mesh_axis="model")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
class _VocabXent(torch.autograd.Function):
    """Per-token ``logsumexp - logit[label]`` of float32 logits split
    over the model group by vocab columns ``[start, start + V/M)``: the
    max, then the sum of exponentials and the label's logit (from the
    rank that owns it) summed over the group in one exchange.  Backward:
    ``softmax - onehot`` on this rank's columns, no exchange."""

    @staticmethod
    def forward(ctx, lg, labels, start, mesh):
        m = collectives.all_reduce(lg.max(-1).values, mesh, "max",
                                   mesh_axis="model")
        e = torch.exp(lg - m[..., None])
        local = labels.long() - start
        hit = (local >= 0) & (local < lg.shape[-1])
        local = torch.where(hit, local, torch.zeros_like(local))
        ll = torch.gather(lg, -1, local[..., None])[..., 0]
        ll = torch.where(hit, ll, torch.zeros_like(ll))
        sums = collectives.all_reduce(torch.stack([e.sum(-1), ll]), mesh,
                                      mesh_axis="model")
        ctx.save_for_backward(e, sums[0], local, hit)
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(ctx, g):
        e, s, local, hit = ctx.saved_tensors
        grad = e * (g / s)[..., None]
        grad.scatter_add_(-1, local[..., None],
                          torch.where(hit, -g, torch.zeros_like(g))[..., None])
        return grad, None, None, None


def vocab_parallel_xent(lg, labels, vocab: int):
    """Per-token negative log-likelihood ``[...]`` (float32) of logits
    split over the installed model axis by vocab columns; the plain
    version is ``softmax_xent``'s one-process body."""
    ax = model_axis()
    return _VocabXent.apply(lg.float(), labels, ax.block(vocab).start,
                            ax.mesh)


def softmax_xent(lg, labels, mask=None, vocab=None):
    """Token-mean cross entropy; fp32 for the reduction.  With ``mask``,
    the mean over the tokens it keeps (at least 1).  ``vocab`` (global)
    lets the logits be split over the model axis
    (``vocab_parallel_xent``)."""
    if _split("vocab", vocab) is not None:
        nll = vocab_parallel_xent(lg, labels, vocab)
    else:
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, labels[..., None].long())[..., 0]
        nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
