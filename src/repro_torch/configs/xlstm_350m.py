"""xlstm-350m [ssm]: sLSTM + mLSTM blocks, ratio 7:1 (xLSTM[7:1])
[arXiv:2405.04517; unverified].  d_ff=0: xLSTM blocks carry their own
up/down projections.  Sub-quadratic -> runs long_500k.
Counterpart: ``repro/configs/xlstm_350m.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304,
    expand=2, slstm_every=8, slstm_heads=4, ssm_d_conv=4,
    norm="ln", use_rope=False,
    subquadratic=True,
    source="arXiv:2405.04517",
)
