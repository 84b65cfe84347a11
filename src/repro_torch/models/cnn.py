"""The paper's benchmark model: a 4-layer 1-D CNN for Human Activity
Recognition (Fig. 1 times its forward pass at minibatch 8000).

Counterpart: ``repro/models/cnn.py`` (``har_cnn_specs``, ``_conv1d``,
``har_cnn_forward``, ``har_cnn_loss``), on the same parameter dict: each
conv weight ``[K, Cin, Cout]`` (JAX's WIO), the inputs ``[B, L, Cin]``
(NWC).  Here the activations run in torch's NCW layout: the input is
transposed once, each weight permuted to ``[Cout, Cin, K]`` at its call;
``conv_general_dilated`` and ``F.conv1d`` are both cross-correlations, so
no kernel is flipped.  VALID padding, a max pool of 2 between the two
conv pairs, a global mean over time and a linear head, as there.  The
convolutions are ``F.conv1d``, as the reference's are
``conv_general_dilated`` outside any kernel.

On a mesh with a model axis (the hook's ``model_axis()``) the channels
split as the reference's rules store them (``DEFAULT_RULES["channels"]
= "model"``: every conv weight ``("conv", None, "channels")``, each bias
``("channels",)``): each rank holds its block of every conv's output
channels (``init_params(..., mesh=, rules=default_rules())``) and
computes them from every input channel, through a convolution of the
whole output width whose other channels' weights and bias are zero, cut
to its block: the card then runs one process's convolution and the
rank's channels hold one process's bits.  A convolution of the rank's
width alone rounds otherwise (cuDNN picks its algorithm by the width),
which flips relu masks downstream: conv4's weight gradient moved by
1.9e-4 of its largest from one process's on an NVIDIA H100 80GB HBM3
at 700 W at minibatch 8,000 (``chip_smoke.py``'s HAR CNN at model=2,
whose tolerance is 1e-4).  So the axis splits the CNN's weights and
activations, not its convolutions' FLOPs.  Before the next conv the
blocks are joined over the model group by
``collectives.all_gather_seq(..., dim=1)`` (NCW), whose backward, a
reduce-scatter, sums each rank's part of the joined activation's
gradient.  The max pool and the mean over time act per channel, so they
run on the rank's block before its join.  The head ``[2c, classes]``
runs whole on every rank on the pooled channels, joined by
``collectives.gather_from_model`` (every rank uses them alike, so its
gradient is already the whole one): its gradient needs no sum and stays
bit-identical on every rank.  A conv whose channels do not divide the
axis runs whole on every rank.  The batch splits over the dp group as
the train step's ``batch_rows`` splits it; no exchange over it is here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import collectives
from ..core.sharding import ParamSpec, model_axis

__all__ = ["har_cnn_forward", "har_cnn_loss", "har_cnn_specs"]


def har_cnn_specs(*, in_ch: int = 9, width: int = 64, classes: int = 6,
                  kernel: int = 3) -> dict:
    c = width
    # gain 1.5 on the conv stack, as in the reference: four VALID relu
    # convs + maxpool + global average pooling attenuate the signal
    g = 1.5
    return {
        "conv1": {"w": ParamSpec((kernel, in_ch, c), ("conv", None, "channels"),
                                 scale=g),
                  "b": ParamSpec((c,), ("channels",), init="zeros")},
        "conv2": {"w": ParamSpec((kernel, c, c), ("conv", None, "channels"),
                                 scale=g),
                  "b": ParamSpec((c,), ("channels",), init="zeros")},
        "conv3": {"w": ParamSpec((kernel, c, 2 * c), ("conv", None, "channels"),
                                 scale=g),
                  "b": ParamSpec((2 * c,), ("channels",), init="zeros")},
        "conv4": {"w": ParamSpec((kernel, 2 * c, 2 * c),
                                 ("conv", None, "channels"), scale=g),
                  "b": ParamSpec((2 * c,), ("channels",), init="zeros")},
        "head": {"w": ParamSpec((2 * c, classes), (None, None)),
                 "b": ParamSpec((classes,), (None,), init="zeros")},
    }


def _conv1d(x, w, b):
    """x: [B, Cin, L] (NCW); w: [K, Cin, Cout] (WIO) -> [B, Cout, L-K+1]
    (VALID padding), the bias added after the convolution as there."""
    y = F.conv1d(x, w.to(x.dtype).permute(2, 1, 0))
    return y + b.to(x.dtype)[:, None]


def _conv_block(h, p, ax, n: int):
    """(relu of one conv of ``n`` output channels (global) on the whole
    input channels ``h``, whether the model axis ``ax`` splits them):
    this rank's block of them where it does, cut from a convolution of
    all ``n`` whose other channels' weights and bias are zero."""
    if ax is None or not ax.split("channels", n):
        return F.relu(_conv1d(h, p["w"], p["b"])), False
    blk = ax.block(n)
    w, b = (F.pad(t, (blk.start, n - blk.stop)) for t in (p["w"], p["b"]))
    return F.relu(_conv1d(h, w, b)[:, blk]), True


def _join(h, ax, split: bool):
    """The whole channels (dim 1) of a block split over the model axis:
    every rank's block, joined (``all_gather_seq``); ``h`` where they do
    not split."""
    return collectives.all_gather_seq(h, ax.mesh, dim=1) if split else h


def har_cnn_forward(params, x):
    """x: [B, 128, 9] -> logits [B, classes]; on a model axis this
    rank's blocks of the conv channels (module docstring)."""
    ax = model_axis()
    c2 = params["head"]["w"].shape[0]           # the head is never split
    h = x.transpose(1, 2)                                  # NWC -> NCW
    h, split = _conv_block(h, params["conv1"], ax, c2 // 2)
    h, split = _conv_block(_join(h, ax, split), params["conv2"], ax, c2 // 2)
    # maxpool /2 between the two conv pairs (Kaggle architecture)
    h = F.max_pool1d(h, 2, 2)
    h, split = _conv_block(_join(h, ax, split), params["conv3"], ax, c2)
    h, split = _conv_block(_join(h, ax, split), params["conv4"], ax, c2)
    h = h.mean(dim=-1)  # global average pool
    if split:
        h = collectives.gather_from_model(h, ax.mesh, 1)
    return h @ params["head"]["w"].to(h.dtype) + params["head"]["b"].to(h.dtype)


def har_cnn_loss(params, batch):
    """Mean cross entropy of ``batch["x"]`` against ``batch["y"]``: the
    logsumexp form, in float32."""
    lg = har_cnn_forward(params, batch["x"]).float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, batch["y"].long()[:, None])[:, 0]
    return (lse - ll).mean()
