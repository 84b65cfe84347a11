"""chameleon-34b [vlm]: early-fusion VQ image tokens share the text vocab,
so the backbone is a dense decoder; modality frontend is a stub
[arXiv:2405.09818; unverified].
Counterpart: ``repro/configs/chameleon_34b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    qk_norm=True,              # chameleon's qk-norm stabilization
    norm="rms", mlp_kind="swiglu", rope_theta=10000.0,
    source="arXiv:2405.09818",
)
