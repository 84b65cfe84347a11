"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA(kv=32 -> MHA)
[arXiv:2404.14219; unverified].
Counterpart: ``repro/configs/phi3_mini.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    norm="rms", mlp_kind="swiglu",
    source="arXiv:2404.14219",
)
