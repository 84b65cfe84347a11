"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart: ``repro/kernels/``).  ``build`` compiles
``csrc/*.cu`` at first use; nothing is built when a module is imported."""
from .flash_attention import (flash_attention, flash_attention_bwd,  # noqa: F401
                              flash_attention_ref)
from .mamba2_scan import (mamba2_chunk_scan, mamba2_chunk_scan_bwd,  # noqa: F401
                          mamba2_chunk_scan_bwd_ref, mamba2_chunk_scan_ref)
from .onebit import (onebit_dequantize, onebit_dequantize_ref,  # noqa: F401
                     onebit_quantize, onebit_quantize_ref)

#: every kernel wrapper, each counting its launches in ``.launches``
KERNELS = (flash_attention, flash_attention_bwd, mamba2_chunk_scan,
           mamba2_chunk_scan_bwd, onebit_quantize, onebit_dequantize)

__all__ = ["KERNELS", "flash_attention", "flash_attention_bwd",
           "flash_attention_ref", "mamba2_chunk_scan", "mamba2_chunk_scan_bwd",
           "mamba2_chunk_scan_bwd_ref", "mamba2_chunk_scan_ref",
           "onebit_dequantize",
           "onebit_dequantize_ref", "onebit_quantize", "onebit_quantize_ref"]
