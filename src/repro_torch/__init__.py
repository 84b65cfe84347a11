"""phyrax on PyTorch and CUDA: the port of ``repro`` (the JAX package) to
one NVIDIA H100.

It imports ``torch`` and nothing of ``repro`` or JAX.  Slice 1 covers the
serving path of the dense decoder family: ``configs``, ``models``, the
hand-written flash-attention kernel in ``kernels``/``csrc``, the serve
steps, the futurized runtime and ``frontend.Plan``/``Session.serve``.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
