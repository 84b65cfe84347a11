"""phyrax on PyTorch and CUDA: the port of ``repro`` (the JAX package) to
one NVIDIA H100.

It imports ``torch`` and nothing of ``repro`` or JAX.  It covers the
serving path of the dense decoder family and of the zamba hybrid:
``configs``, ``models``, the hand-written flash-attention and Mamba-2
chunk-scan kernels in ``kernels``/``csrc``, the serve steps, the
futurized runtime and ``frontend.Plan``/``Session.serve``.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
