"""Checkpoints of the port (counterpart: ``repro/checkpoint/``).

``format`` is the reference's byte-level contract, copied whole: shard
files of (possibly device-shard) segments, the driver-written manifest,
atomic rename commit; ``checkpoint`` is the futurized I/O layer, with
shards written by the localities that own them; ``spmd`` is the SPMD save
path, where every process of a ``torch.distributed`` world writes only
its own segments of the train state."""
from .checkpoint import CheckpointManager  # noqa: F401
from .format import (CheckpointCorruptError, assemble_leaf,  # noqa: F401
                     assign_shards, build_manifest, commit_manifest,
                     load_manifest, read_shard, read_shard_segments,
                     save_shard)
from .spmd import write_spmd_shard  # noqa: F401

__all__ = ["CheckpointCorruptError", "CheckpointManager", "assemble_leaf",
           "assign_shards", "build_manifest", "commit_manifest",
           "load_manifest", "read_shard", "read_shard_segments",
           "save_shard", "write_spmd_shard"]
