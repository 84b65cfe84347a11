"""ArchConfig: declarative architecture description (paper R8 - the user
describes the network; distribution is the framework's job).

Counterpart: ``repro/configs/base.py``, field for field; only the dtype
table maps to torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | xlstm | zamba | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention details
    norm: str = "rms"                # rms | ln
    mlp_kind: str = "swiglu"         # swiglu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    q_chunk: int = 1024
    kv_chunk: int = 1024

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_group: int = 512
    moe_dispatch: str = "einsum"     # einsum (GShard baseline) | sort (opt)
    capacity_factor: float = 1.25

    # SSM / recurrent
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_state: int = 64
    ssm_groups: int = 1
    ssm_d_conv: int = 4
    ssm_chunk: int = 256
    slstm_every: int = 8             # xlstm: 1 sLSTM per this many layers
    slstm_heads: int = 4
    shared_every: int = 6            # zamba: shared attn block cadence

    # encoder-decoder
    n_enc_layers: int = 0
    enc_frames: int = 1500           # stub audio frontend output length
    max_dec_len: int = 65536

    # decode cache write: "dus" (dynamic-update-slice) or "masked"
    # (iota-mask select: no resharding when the seq dim is sharded)
    cache_update: str = "dus"

    # numerics
    param_dtype: str = "f32"
    compute_dtype: str = "bf16"
    cache_dtype_str: str = "bf16"

    # stacking / remat
    scan_layers: bool = True
    remat: bool = True

    # metadata
    source: str = ""
    aux_weight: float = 0.01
    subquadratic: bool = False       # eligible for long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- dtypes ---------------------------------------------------------------
    @property
    def p_dtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def c_dtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def cache_dtype(self):
        return _DTYPES[self.cache_dtype_str]

    # -- reductions for smoke tests -------------------------------------------
    def tiny(self) -> "ArchConfig":
        changes = dict(
            n_layers=min(self.n_layers, 4 if self.family in ("xlstm", "zamba")
                         else 2),
            d_model=128, n_heads=4, head_dim=32,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256, vocab=512,
            q_chunk=64, kv_chunk=64, ssm_chunk=32, moe_group=64,
            expand=2, ssm_head_dim=32, ssm_state=16, slstm_heads=2,
            compute_dtype="f32", cache_dtype_str="f32",
        )
        if self.family == "moe":
            changes.update(n_experts=min(self.n_experts, 4),
                           top_k=min(self.top_k, 2))
        if self.family == "xlstm":
            changes.update(n_layers=4, slstm_every=4)
        if self.family == "zamba":
            changes.update(n_layers=4, shared_every=2)
        if self.family == "encdec":
            changes.update(n_enc_layers=2, enc_frames=16)
        return dataclasses.replace(self, **changes)
