"""mistral-nemo-12b [dense]: 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].
head_dim 128 is explicit (32 x 128 != 5120).
Counterpart: ``repro/configs/mistral_nemo_12b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    norm="rms", mlp_kind="swiglu", rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
