"""whisper-medium [audio]: encoder-decoder; conv frontend is a STUB -
the model takes precomputed frame embeddings [arXiv:2212.04356].
24 encoder + 24 decoder layers, LayerNorm + GELU, learned/sinusoidal
positions (no RoPE), biased QKV.
Counterpart: ``repro/configs/whisper_medium.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865,
    norm="ln", mlp_kind="gelu", use_rope=False, qkv_bias=True,
    enc_frames=1500,
    source="arXiv:2212.04356",
)
