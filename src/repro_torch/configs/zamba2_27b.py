"""zamba2-2.7b [hybrid]: Mamba2 backbone + one shared attention+MLP block
applied every 6 mamba layers [arXiv:2411.15242].  Simplifications as in
the JAX package: shared block on the residual stream (no
concat-with-embedding or per-application LoRA).
Counterpart: ``repro/configs/zamba2_27b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="zamba",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    expand=2, ssm_head_dim=64, ssm_state=64, ssm_groups=1, ssm_d_conv=4,
    shared_every=6,
    norm="rms", mlp_kind="swiglu",
    subquadratic=True,
    source="arXiv:2411.15242",
)
