"""Multi-locality runtime of the port (counterpart: ``repro/distrib/``,
DESIGN.md §9): ``messaging`` is the TCP active-message (parcel) layer,
``agas`` the global object directory, ``collectives`` the gradient codecs
and the ring all-reduce of fabric DDP, and ``runtime`` the
``Locality``/``DistributedGraph`` scheduler that places tasks by lane and
data affinity and streams results back as futures resolve, with elastic
membership (``join_locality``, ``rebalance_plan``; DESIGN.md §13)."""
from .agas import ObjectDirectory, RemoteRef, rebalance_plan  # noqa: F401
from .collectives import (CODECS, Fp32Codec, GradCodec,  # noqa: F401
                          OneBitCodec, RingAllReduce, get_codec)
from .messaging import Endpoint, PeerLostError, raw_request  # noqa: F401
from .runtime import (DistributedGraph, Locality,  # noqa: F401
                      LocalityGroup, LocalityLostError, RemoteTaskError,
                      join_locality, worker_main)

__all__ = ["CODECS", "DistributedGraph", "Endpoint", "Fp32Codec",
           "GradCodec", "Locality", "LocalityGroup", "LocalityLostError",
           "ObjectDirectory", "OneBitCodec", "PeerLostError", "RemoteRef",
           "RemoteTaskError", "RingAllReduce", "get_codec", "join_locality",
           "raw_request", "rebalance_plan", "worker_main"]
