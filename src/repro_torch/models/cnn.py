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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sharding import ParamSpec

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


def har_cnn_forward(params, x):
    """x: [B, 128, 9] -> logits [B, classes]."""
    h = x.transpose(1, 2)                                  # NWC -> NCW
    h = F.relu(_conv1d(h, params["conv1"]["w"], params["conv1"]["b"]))
    h = F.relu(_conv1d(h, params["conv2"]["w"], params["conv2"]["b"]))
    # maxpool /2 between the two conv pairs (Kaggle architecture)
    h = F.max_pool1d(h, 2, 2)
    h = F.relu(_conv1d(h, params["conv3"]["w"], params["conv3"]["b"]))
    h = F.relu(_conv1d(h, params["conv4"]["w"], params["conv4"]["b"]))
    h = h.mean(dim=-1)  # global average pool
    return h @ params["head"]["w"].to(h.dtype) + params["head"]["b"].to(h.dtype)


def har_cnn_loss(params, batch):
    """Mean cross entropy of ``batch["x"]`` against ``batch["y"]``: the
    logsumexp form, in float32."""
    lg = har_cnn_forward(params, batch["x"]).float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, batch["y"].long()[:, None])[:, 0]
    return (lse - ll).mean()
