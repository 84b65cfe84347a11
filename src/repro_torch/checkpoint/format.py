"""Checkpoint format layer: shard files + manifest (DESIGN.md §10).

Counterpart: ``repro/checkpoint/format.py``, copied whole, so that the
two packages write the same shard bytes and manifests, read each other's
checkpoints (SPMD segments included) and raise the same
``CheckpointCorruptError`` messages.  The text below is the reference's.

The byte-level contract of a checkpoint, kept free of scheduling (and of
jax): everything here is plain numpy + files, so a shard task ships to a
worker locality by reference and runs anywhere.  ``checkpoint.py`` is
the I/O layer that schedules these functions as futurized tasks on
their owning localities.

Layout (one directory per step):

    <dir>/step_00000120/
        manifest.json       tree structure, shard->locality ownership
                            map, per-shard checksums; driver-written,
                            committed LAST (atomic rename)
        shard_00000.bin     the leaves owned by locality 0
        shard_00001.bin     the leaves owned by locality 1 ...

A shard file is the concatenation of raw ``.npy`` segments; the
manifest records each segment's byte offset and length, so any single
segment is loadable without parsing a container format - and a flipped
byte is caught by a checksum mismatch (``CheckpointCorruptError``
naming the shard), never by a zip CRC blowing up the parse.

A segment is usually a whole leaf, but under multi-host SPMD saves
(DESIGN.md §10) a leaf may be split into *device-shard* segments: each
process persists exactly the blocks of the global array it can address
(``jax.Array.addressable_shards``), so a segment then also records the
``slice`` of the global leaf it holds plus the leaf's ``global_shape``.
``assemble_leaf`` re-joins segments (from any number of shard files)
into the full leaf at restore, verifying exact coverage.

Invariants the I/O layer relies on:
  * ``save_shard`` is idempotent and atomic (write-ahead temp file +
    ``os.replace``): re-running it after a locality died mid-write
    converges to the same bytes, never a torn shard;
  * the manifest is assembled by the driver only after every shard
    entry resolved, written into the temp step directory, and the
    directory is then renamed - a crash at any point leaves either the
    previous checkpoint or a complete new one, never a torn manifest;
  * every leaf is checksummed (blake2b over dtype + shape + bytes) at
    save and verified at restore;
  * shard->locality ownership is recorded (the writer's actual rank,
    from ``PHYRAX_LOCALITY_RANK``), but restore never requires it:
    shards are readable by any locality count (N->M resharding,
    M=1 included).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import time
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

__all__ = ["CheckpointCorruptError", "FORMAT_VERSION", "MANIFEST_NAME",
           "assemble_leaf", "assign_shards", "build_manifest",
           "commit_manifest", "leaf_checksum", "load_manifest",
           "read_shard", "read_shard_segments", "save_shard",
           "shard_checksum", "shard_filename", "writer_rank"]

FORMAT_VERSION = "phyrax-ckpt/3"
# phyrax-ckpt/2 checkpoints (whole-leaf segments only) read unchanged
COMPAT_VERSIONS = frozenset({"phyrax-ckpt/2", FORMAT_VERSION})
MANIFEST_NAME = "manifest.json"


class CheckpointCorruptError(IOError):
    """A checkpoint failed verification at restore: a shard file is
    missing, truncated, unparseable, or a checksum does not match the
    manifest.  The message names the offending shard (and leaf)."""


def writer_rank() -> int:
    """The locality rank this process writes shards as.

    Read from ``PHYRAX_LOCALITY_RANK`` (exported by
    ``distrib.runtime.worker_main`` at spawn); 0 - the driver - when
    unset.  Recorded in every shard entry, so the manifest's ownership
    map reflects the *actual* writer even after a failure re-spawn.
    """
    return int(os.environ.get("PHYRAX_LOCALITY_RANK", "0"))


def shard_filename(shard_id: int) -> str:
    """Canonical shard file name (``shard_00003.bin``)."""
    return f"shard_{shard_id:05d}.bin"


def leaf_checksum(a: np.ndarray) -> str:
    """blake2b over one leaf's dtype + shape + raw bytes."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def shard_checksum(leaf_checksums: Iterable[str]) -> str:
    """Shard-level checksum: blake2b over the ordered leaf checksums."""
    h = hashlib.blake2b(digest_size=16)
    for c in leaf_checksums:
        h.update(c.encode())
    return h.hexdigest()


def assign_shards(n_leaves: int, ranks) -> list[tuple[int, int, list[int]]]:
    """Partition ``n_leaves`` global leaf indices into one shard per
    locality rank (contiguous blocks, sized as evenly as possible).

    Args:
        n_leaves: leaf count of the flattened tree.
        ranks: locality ranks that will own a shard, in order (the
            save-time world, e.g. ``[0, 1, 2]`` - 0 is the driver).
    Returns:
        ``[(shard_id, rank, leaf_indices), ...]``; empty shards are
        dropped, so ``n_leaves < len(ranks)`` yields fewer shards than
        ranks.
    """
    ranks = list(ranks)
    n = max(1, len(ranks))
    base, extra = divmod(n_leaves, n)
    out: list[tuple[int, int, list[int]]] = []
    start = 0
    for i, rank in enumerate(ranks):
        size = base + (1 if i < extra else 0)
        if size == 0:
            continue
        out.append((len(out), rank, list(range(start, start + size))))
        start += size
    return out


def save_shard(directory: str, shard_id: int, indices, arrays,
               *_deps, slices=None) -> dict:
    """Write one shard file (idempotent, atomic) and return its manifest
    entry.

    Runs on the owning locality as a futurized CHECKPOINT task; the
    trailing ``*_deps`` swallow dependency-edge values (step retirement,
    the previous save) that exist only for ordering.

    Args:
        directory: the *temporary* step directory (created here if
            missing - concurrent writers race benignly on mkdir).
        shard_id: shard index within the checkpoint.
        indices: global leaf indices stored in this shard, in order.
            The same index may repeat when a leaf is split into
            device-shard segments.
        arrays: the segment values (numpy) matching ``indices``.
        slices: optional parallel list; entry ``i`` is None for a whole
            leaf, or ``(slice_pairs, global_shape)`` where
            ``slice_pairs`` is ``[[start, stop], ...]`` per dimension of
            the global leaf - the SPMD addressable-shard save path
            (DESIGN.md §10).
    Returns:
        The shard's manifest entry: file name, writer locality,
        per-segment byte offsets / shapes / dtypes / checksums (plus
        ``slice``/``global_shape`` for device-shard segments), and a
        shard-level checksum.
    """
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    name = shard_filename(shard_id)
    leaves, offset = [], 0
    if slices is None:
        slices = [None] * len(list(indices))
    tmp = d / f"{name}.wip-{os.getpid()}"
    # stream segment by segment: only one serialized blob is in memory
    # at a time, not the whole shard
    with open(tmp, "wb") as f:
        for idx, a, sl in zip(indices, arrays, slices):
            a = np.asarray(a)
            buf = io.BytesIO()
            np.save(buf, a)
            blob = buf.getvalue()
            entry = {"index": int(idx), "shape": list(a.shape),
                     "dtype": str(a.dtype),
                     "offset": offset, "nbytes": len(blob),
                     "checksum": leaf_checksum(a)}
            if sl is not None:
                pairs, global_shape = sl
                entry["slice"] = [[int(s), int(e)] for s, e in pairs]
                entry["global_shape"] = [int(n) for n in global_shape]
            leaves.append(entry)
            f.write(blob)
            offset += len(blob)
    os.replace(tmp, d / name)     # atomic: re-runs converge, never tear
    return {"file": name, "shard": int(shard_id),
            "locality": writer_rank(), "nbytes": offset, "leaves": leaves,
            "checksum": shard_checksum(e["checksum"] for e in leaves)}


def read_shard_segments(directory: str, entry: dict, *,
                        verify: bool = True) -> list:
    """Read one shard file back as a list of segments.

    Runs on *any* locality - a resharded restore does not need the
    writer; with ``verify`` every segment is re-checksummed against the
    manifest entry.

    Args:
        directory: the committed step directory.
        entry: this shard's manifest entry (``manifest["shards"][i]``).
        verify: verify per-segment checksums plus the shard checksum.
    Returns:
        List of ``{"index", "slice", "global_shape", "array"}`` dicts;
        ``slice``/``global_shape`` are None for whole-leaf segments.
    Raises:
        CheckpointCorruptError: the shard file is missing, truncated, or
            fails verification; the message names the shard (and leaf).
    """
    path = Path(directory) / entry["file"]
    try:
        raw = path.read_bytes()
    except OSError as e:
        raise CheckpointCorruptError(
            f"shard {entry['file']} unreadable in {directory}: {e}") from e
    out: list[dict] = []
    sums = []
    for leaf in entry["leaves"]:
        blob = raw[leaf["offset"]:leaf["offset"] + leaf["nbytes"]]
        if len(blob) != leaf["nbytes"]:
            raise CheckpointCorruptError(
                f"shard {entry['file']} truncated at leaf {leaf['index']} "
                f"({len(blob)} of {leaf['nbytes']} bytes)")
        try:
            a = np.load(io.BytesIO(blob), allow_pickle=False)
        except Exception as e:
            raise CheckpointCorruptError(
                f"shard {entry['file']} leaf {leaf['index']} does not "
                f"parse: {e}") from e
        if verify:
            got = leaf_checksum(a)
            sums.append(got)
            if got != leaf["checksum"]:
                raise CheckpointCorruptError(
                    f"checksum mismatch in shard {entry['file']} "
                    f"(leaf {leaf['index']}) - refusing to load a corrupt "
                    f"checkpoint")
        out.append({"index": int(leaf["index"]),
                    "slice": leaf.get("slice"),
                    "global_shape": leaf.get("global_shape"),
                    "array": a})
    if verify and shard_checksum(sums) != entry["checksum"]:
        raise CheckpointCorruptError(
            f"shard checksum mismatch in {entry['file']}")
    return out


def read_shard(directory: str, entry: dict, *, verify: bool = True) -> dict:
    """Read one whole-leaf shard file back into
    ``{global_leaf_index: array}``.

    Thin wrapper over ``read_shard_segments`` for shards whose segments
    are full leaves (every host-copy-mode shard).  Shards holding
    device-shard segments span leaves across files and must be
    assembled via ``read_shard_segments`` + ``assemble_leaf`` instead.

    Args:
        directory: the committed step directory.
        entry: this shard's manifest entry (``manifest["shards"][i]``).
        verify: verify per-segment checksums plus the shard checksum.
    Returns:
        Mapping of global leaf index -> numpy array.
    Raises:
        CheckpointCorruptError: corrupt shard, or a sliced (device-shard)
            segment that this whole-leaf API cannot represent.
    """
    out: dict[int, np.ndarray] = {}
    for seg in read_shard_segments(directory, entry, verify=verify):
        if seg["slice"] is not None:
            raise CheckpointCorruptError(
                f"shard {entry['file']} leaf {seg['index']} is a "
                f"device-shard segment (SPMD save); use "
                f"read_shard_segments + assemble_leaf")
        out[seg["index"]] = seg["array"]
    return out


def assemble_leaf(leaf_index: int, segments: list) -> np.ndarray:
    """Re-join one leaf from its segments (possibly from several shard
    files - the N->M restore of an SPMD checkpoint).

    Args:
        leaf_index: global leaf index (for error messages).
        segments: this leaf's ``read_shard_segments`` dicts.
    Returns:
        The full leaf as a numpy array.
    Raises:
        CheckpointCorruptError: no segments, a whole-leaf segment mixed
            with sliced ones, disagreeing global shapes, or segments
            that do not cover the leaf exactly.
    """
    if not segments:
        raise CheckpointCorruptError(f"leaf {leaf_index}: no segments")
    whole = [s for s in segments if s["slice"] is None]
    if whole:
        if len(segments) != 1:
            raise CheckpointCorruptError(
                f"leaf {leaf_index}: whole-leaf segment duplicated or "
                f"mixed with device-shard segments")
        return whole[0]["array"]
    shapes = {tuple(s["global_shape"]) for s in segments}
    if len(shapes) != 1:
        raise CheckpointCorruptError(
            f"leaf {leaf_index}: segments disagree on the global shape "
            f"({sorted(shapes)})")
    shape = shapes.pop()
    out = np.empty(shape, dtype=segments[0]["array"].dtype)
    covered = 0
    boxes = [seg["slice"] for seg in segments]
    # disjointness + total count == exact cover (overlapping segments
    # would hide an uncovered - uninitialized - region from the count)
    for i, a in enumerate(boxes):
        for b in boxes[i + 1:]:
            if all(s1 < e2 and s2 < e1
                   for (s1, e1), (s2, e2) in zip(a, b)):
                raise CheckpointCorruptError(
                    f"leaf {leaf_index}: segments {a} and {b} overlap")
    for seg in segments:
        sl = tuple(slice(s, e) for s, e in seg["slice"])
        if out[sl].shape != seg["array"].shape:
            raise CheckpointCorruptError(
                f"leaf {leaf_index}: segment slice {seg['slice']} does "
                f"not match its array shape {seg['array'].shape}")
        out[sl] = seg["array"]
        covered += seg["array"].size
    if covered != out.size:
        raise CheckpointCorruptError(
            f"leaf {leaf_index}: segments cover {covered} of {out.size} "
            f"elements - a device shard is missing from every shard file")
    return out


def build_manifest(*, step: int, treedef: str, n_leaves: int,
                   shards: list, meta: Optional[dict] = None) -> dict:
    """Assemble the manifest (driver-side, after every shard entry
    resolved).

    The ownership map is derived from the entries' recorded writer
    localities, so a shard re-written elsewhere after its owner died is
    attributed to its actual writer.

    Args:
        step: training step the snapshot belongs to.
        treedef: ``str(jax.tree.flatten(tree)[1])`` - the tree structure.
        n_leaves: global leaf count (shards must cover exactly these).
        shards: the ``save_shard`` entries, any order.
        meta: free-form user metadata.
    Returns:
        The manifest dict (see DESIGN.md §10 for the schema).
    """
    shards = sorted(shards, key=lambda e: e["shard"])
    ownership: dict[str, list[int]] = {}
    for e in shards:
        ownership.setdefault(str(e["locality"]), []).append(e["shard"])
    return {"format": FORMAT_VERSION, "step": int(step),
            "treedef": treedef, "n_leaves": int(n_leaves),
            "n_shards": len(shards), "shards": shards,
            "ownership": ownership, "meta": meta or {},
            "saved_at": time.strftime("%Y-%m-%d %H:%M:%S")}


def commit_manifest(tmp_dir, final_dir, manifest: dict) -> Path:
    """Atomic commit: write ``manifest.json`` into the temp step
    directory, then rename the directory to its final name (replacing a
    previous checkpoint of the same step).

    The manifest lands LAST: a crash before the rename leaves no
    ``step_*`` directory at all, so a reader never observes a torn
    checkpoint.

    Args:
        tmp_dir: the temp step directory holding every shard file.
        final_dir: the committed ``step_XXXXXXXX`` path.
        manifest: the ``build_manifest`` result.
    Returns:
        ``final_dir`` as a ``Path``.
    """
    tmp_dir, final_dir = Path(tmp_dir), Path(final_dir)
    # every shard entry has resolved by now, so anything the manifest
    # does not reference is a dead writer's orphan - a .wip-* write-ahead
    # file, or a stale shard from an aborted attempt with a different
    # world size - and must not be committed
    referenced = {e["file"] for e in manifest.get("shards", [])}
    for p in tmp_dir.iterdir():
        if p.name != MANIFEST_NAME and p.name not in referenced:
            p.unlink()
    (tmp_dir / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
    if final_dir.exists():
        shutil.rmtree(final_dir)
    os.rename(tmp_dir, final_dir)
    return final_dir


def load_manifest(step_dir) -> dict:
    """Read and minimally validate a committed step's manifest.

    Args:
        step_dir: a committed ``step_XXXXXXXX`` directory.
    Returns:
        The manifest dict.
    Raises:
        CheckpointCorruptError: missing or unparseable manifest, or a
            format version this layer does not understand.
    """
    path = Path(step_dir) / MANIFEST_NAME
    try:
        manifest = json.loads(path.read_text())
    except OSError as e:
        raise CheckpointCorruptError(
            f"no manifest in {step_dir}: {e}") from e
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"manifest in {step_dir} does not parse: {e}") from e
    if manifest.get("format") not in COMPAT_VERSIONS:
        raise CheckpointCorruptError(
            f"{step_dir}: unsupported checkpoint format "
            f"{manifest.get('format')!r} (want one of "
            f"{sorted(COMPAT_VERSIONS)})")
    return manifest
