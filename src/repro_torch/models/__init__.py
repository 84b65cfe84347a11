"""Model zoo of the port (counterpart: ``repro/models/``): the dense
decoder family, on the flash-attention kernel for prefill."""
from .model import LM, build_model  # noqa: F401

__all__ = ["LM", "build_model"]
