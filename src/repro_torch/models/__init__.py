"""Model zoo of the port (counterpart: ``repro/models/``): the dense
decoder family and the zamba hybrid, on the flash-attention kernel for
prefill and training attention (forward and backward) and the Mamba-2
chunk-scan kernel for the prefill scan."""
from .model import LM, build_model  # noqa: F401

__all__ = ["LM", "build_model"]
