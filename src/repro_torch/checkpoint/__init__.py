"""Checkpoints of the port (counterpart: ``repro/checkpoint/``).

``format`` is the reference's byte-level contract, copied whole: shard
files of (possibly device-shard) segments, the driver-written manifest,
atomic rename commit; ``checkpoint`` is the futurized I/O layer for one
locality.  The multi-locality placement and the SPMD save path wait for
ROADMAP items 12 and 13."""
from .checkpoint import CheckpointManager  # noqa: F401
from .format import (CheckpointCorruptError, assemble_leaf,  # noqa: F401
                     assign_shards, build_manifest, commit_manifest,
                     load_manifest, read_shard, read_shard_segments,
                     save_shard)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "assemble_leaf",
           "assign_shards", "build_manifest", "commit_manifest",
           "load_manifest", "read_shard", "read_shard_segments",
           "save_shard"]
