"""Model zoo of the port (counterpart: ``repro/models/``): the dense,
moe, xlstm and zamba decoder families and the encoder-decoder, on the
flash-attention kernel for prefill and training attention (forward and
backward) and the Mamba-2 chunk-scan kernel for the prefill scan."""
from .model import EncDec, LM, build_model  # noqa: F401

__all__ = ["EncDec", "LM", "build_model"]
