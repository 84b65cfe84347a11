"""phyrax on PyTorch and CUDA: the port of ``repro`` (the JAX package) to
one NVIDIA H100.

It imports ``torch`` and nothing of ``repro`` or JAX.  It covers the
serving path of the dense decoder family and of the zamba hybrid, and
the training path of the dense family (single device, and world-1 fabric
DDP with the fp32 and onebit gradient codecs): ``configs``, ``models``,
the hand-written kernels in ``kernels``/``csrc`` (flash attention forward
and backward, the Mamba-2 chunk scan, the 1-bit quantize and
dequantize), ``optim``, ``data``, ``distrib.collectives``, the train and
serve steps, the futurized runtime and ``frontend.Plan``/``Session``.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
