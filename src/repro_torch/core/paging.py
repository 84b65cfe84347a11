"""Paged inference cache: a slot-free page pool over per-request decode
state.

Counterpart: ``repro/core/paging.py`` (``PagePool``, ``InferenceCache``,
``PageError``), with the same single-owner, LIFO-reuse and zero-scrub
semantics and the same counters.  The serving gateway
(``frontend/gateway.py``) prefills a request once, at admission, and parks
its KV/conv/SSM decode state here until a batch slot frees up; slot refill
then loads pages instead of recomputing prefill.

Two layers, both on the host:

  * ``PagePool`` - a fixed-page-size byte allocator over ``np.uint8``
    pages.  The free list is LIFO, so freed pages are reused before the
    pool grows; every live page has exactly one owner; pages are
    zero-scrubbed on allocation, so a recycled page never leaks a previous
    request's state.
  * ``InferenceCache`` - maps a request id to the pages holding its
    serialized decode-state pytree (nested dicts and lists of tensors).
    ``put`` flattens it with ``torch.utils._pytree`` and spills the leaves'
    bytes across pages, ``get`` reassembles a bit-identical tree of CPU
    tensors, ``drop`` reclaims.

numpy has no bfloat16, and ``Tensor.numpy()`` refuses it, so a leaf parks
as its raw bytes (a ``torch.uint8`` view) beside its torch dtype and shape,
and comes back as ``.view(dtype).reshape(shape)`` of those bytes.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["InferenceCache", "PagePool", "PageError"]


class PageError(RuntimeError):
    """Page-accounting violation: double free, foreign page, unknown id."""


@dataclasses.dataclass
class _Entry:
    """One cached request: its pages plus the template to rebuild the
    pytree (leaf shapes and torch dtypes in flatten order, the treespec)."""
    pages: list[int]
    nbytes: int
    shapes: list[tuple]
    dtypes: list[torch.dtype]
    treespec: Any


class PagePool:
    """Fixed-size byte pages with single-owner accounting.

    The pool starts empty and grows on demand; it never shrinks (pages are
    cheap host memory and reuse is the point).  All methods are
    thread-safe: gateway node bodies allocate and free from worker threads.

    Args:
        page_bytes: size of every page in bytes (>= 1).
    """

    def __init__(self, page_bytes: int = 1 << 16):
        if page_bytes < 1:
            raise ValueError(f"page_bytes must be >= 1, got {page_bytes}")
        self.page_bytes = int(page_bytes)
        self._lock = threading.Lock()
        self._pages: list[np.ndarray] = []      # page id -> buffer
        self._free: list[int] = []              # LIFO: reuse before grow
        self._owner: dict[int, str] = {}        # live page id -> owner
        self.allocs = 0      # pages handed out
        self.frees = 0       # pages returned
        self.grown = 0       # pages created (pool size)
        self.reused = 0      # allocations served from the free list
        self.peak_live = 0   # high-water mark of live pages

    # -- allocation ---------------------------------------------------------
    def alloc(self, owner: str, n: int = 1) -> list[int]:
        """Allocate ``n`` zero-scrubbed pages owned by ``owner``.

        Args:
            owner: non-empty tag recorded as the pages' single owner.
            n: page count (>= 0; 0 returns ``[]``).
        Returns:
            The allocated page ids, free-list pages first.
        """
        if not owner:
            raise ValueError("pages must have a non-empty owner")
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        out: list[int] = []
        with self._lock:
            for _ in range(n):
                if self._free:
                    pid = self._free.pop()      # LIFO reuse
                    self._pages[pid][:] = 0     # scrub: no stale bytes
                    self.reused += 1
                else:
                    pid = len(self._pages)
                    self._pages.append(np.zeros(self.page_bytes, np.uint8))
                    self.grown += 1
                self._owner[pid] = owner
                out.append(pid)
            self.allocs += n
            self.peak_live = max(self.peak_live, len(self._owner))
        return out

    def free(self, pages: list[int], owner: str):
        """Return ``pages`` (all owned by ``owner``) to the free list.

        Raises:
            PageError: a page is unknown, already free, or owned by
                someone else; the whole call then frees nothing.
        """
        with self._lock:
            for pid in pages:
                got = self._owner.get(pid)
                if got is None:
                    raise PageError(f"free of non-live page {pid} "
                                    f"by {owner!r}")
                if got != owner:
                    raise PageError(f"page {pid} owned by {got!r}, "
                                    f"freed by {owner!r}")
            for pid in pages:
                del self._owner[pid]
                self._free.append(pid)
            self.frees += len(pages)

    # -- page I/O -----------------------------------------------------------
    def write(self, pid: int, owner: str, data: np.ndarray):
        """Copy ``data`` (uint8, <= page_bytes) into page ``pid``."""
        with self._lock:
            self._check_owned(pid, owner)
            buf = self._pages[pid]
        if data.nbytes > self.page_bytes:
            raise ValueError(f"{data.nbytes} bytes > page size "
                             f"{self.page_bytes}")
        buf[:data.size] = data

    def read(self, pid: int, owner: str, nbytes: Optional[int] = None
             ) -> np.ndarray:
        """The first ``nbytes`` (default: all) of page ``pid`` as uint8."""
        with self._lock:
            self._check_owned(pid, owner)
            buf = self._pages[pid]
        return buf[:self.page_bytes if nbytes is None else nbytes].copy()

    def _check_owned(self, pid: int, owner: str):
        got = self._owner.get(pid)
        if got != owner:
            raise PageError(f"page {pid} owned by {got!r}, "
                            f"accessed by {owner!r}")

    # -- inspection ---------------------------------------------------------
    @property
    def live(self) -> int:
        """Pages currently owned (allocated and not yet freed)."""
        with self._lock:
            return len(self._owner)

    @property
    def size(self) -> int:
        """Total pages ever created (live + free)."""
        with self._lock:
            return len(self._pages)

    def owners(self) -> dict[int, str]:
        """Snapshot of the live page -> owner map."""
        with self._lock:
            return dict(self._owner)

    def counters(self) -> dict[str, int]:
        """Accounting snapshot for stats."""
        with self._lock:
            return {"page_allocs": self.allocs, "page_frees": self.frees,
                    "pages_grown": self.grown, "pages_reused": self.reused,
                    "pages_live": len(self._owner),
                    "pages_peak": self.peak_live}


def _leaf_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bytes on the host, as flat uint8 (any dtype, bf16
    included; a device tensor is copied to the host)."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


class InferenceCache:
    """Per-request decode state parked in ``PagePool`` pages.

    ``put`` serializes a state pytree of tensors into freshly allocated
    pages; ``get`` reassembles a bit-identical pytree of CPU tensors;
    ``drop`` frees the pages.  One entry per request id; a request's pages
    are owned by ``"req:{rid}"``, so cross-request aliasing is a
    ``PageError``, not a corruption.

    A multi-replica gateway gives every replica its own *named* cache over
    one shared pool: ``name="R0"`` prefixes the owner tag
    (``"R0:req:{rid}"``), so one replica freeing or reading another
    replica's pages is a ``PageError``, and the only sanctioned
    cross-replica path is ``transfer``.
    """

    def __init__(self, pool: Optional[PagePool] = None, *,
                 page_bytes: int = 1 << 16, name: str = ""):
        self.pool = pool if pool is not None else PagePool(page_bytes)
        self.name = name
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        self.puts = 0
        self.hits = 0        # successful get()s
        self.misses = 0      # get()/drop() of an absent rid
        self.drops = 0
        self.transfers_in = 0    # entries adopted from a sibling cache
        self.transfers_out = 0   # entries handed to a sibling cache

    def _owner(self, rid: str) -> str:
        return f"{self.name}:req:{rid}" if self.name else f"req:{rid}"

    def put(self, rid: str, state: Any) -> int:
        """Park ``state`` (pytree of tensors, on any device) for request
        ``rid``.

        Returns the page count used.  Raises ``PageError`` if ``rid``
        already has an entry: callers drop before re-putting.
        """
        leaves, treespec = pytree.tree_flatten(state)
        raw = [_leaf_bytes(t) for t in leaves]
        blob = np.concatenate(raw) if raw else np.zeros(0, np.uint8)
        with self._lock:
            if rid in self._entries:
                raise PageError(f"request {rid!r} already cached")
        npages = -(-blob.nbytes // self.pool.page_bytes) if blob.nbytes else 0
        pages = self.pool.alloc(self._owner(rid), npages)
        for i, pid in enumerate(pages):
            lo = i * self.pool.page_bytes
            self.pool.write(pid, self._owner(rid),
                            blob[lo:lo + self.pool.page_bytes])
        entry = _Entry(pages=pages, nbytes=blob.nbytes,
                       shapes=[tuple(t.shape) for t in leaves],
                       dtypes=[t.dtype for t in leaves], treespec=treespec)
        with self._lock:
            if rid in self._entries:    # lost a put/put race: roll back
                self.pool.free(pages, self._owner(rid))
                raise PageError(f"request {rid!r} already cached")
            self._entries[rid] = entry
            self.puts += 1
        return npages

    def get(self, rid: str) -> Any:
        """The bit-identical state pytree parked by ``put``, as CPU
        tensors; None (a recorded miss) if ``rid`` has no entry."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
        chunks = []
        left = entry.nbytes
        for pid in entry.pages:
            take = min(left, self.pool.page_bytes)
            chunks.append(self.pool.read(pid, self._owner(rid), take))
            left -= take
        blob = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
        leaves, off = [], 0
        for shape, dtype in zip(entry.shapes, entry.dtypes):
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            raw = torch.from_numpy(blob[off:off + n])
            leaves.append(raw.view(dtype).reshape(shape))
            off += n
        return pytree.tree_unflatten(leaves, entry.treespec)

    def drop(self, rid: str) -> bool:
        """Free ``rid``'s pages; True if an entry existed."""
        with self._lock:
            entry = self._entries.pop(rid, None)
            if entry is None:
                self.misses += 1
                return False
            self.drops += 1
        self.pool.free(entry.pages, self._owner(rid))
        return True

    def transfer(self, rid: str, dst: "InferenceCache") -> bool:
        """Move ``rid``'s parked state into ``dst`` (bit-identical).

        The only sanctioned cross-cache page path: the state is read under
        this cache's ownership, the pages are freed, and ``dst`` re-parks it
        under its own owner tag, so the single-owner invariant holds at
        every instant.  Used by the gateway when a surviving replica adopts
        a dead replica's requests.

        Returns True if an entry existed (False is a recorded miss, as for
        ``get``/``drop``).
        """
        state = self.get(rid)
        if state is None:
            return False
        self.drop(rid)
        dst.put(rid, state)
        with self._lock:
            self.transfers_out += 1
        with dst._lock:
            dst.transfers_in += 1
        return True

    def __contains__(self, rid: str) -> bool:
        with self._lock:
            return rid in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __iter__(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._entries))

    def counters(self) -> dict[str, int]:
        """Cache and pool accounting, merged (the stats payload)."""
        with self._lock:
            out = {"cache_puts": self.puts, "cache_hits": self.hits,
                   "cache_misses": self.misses, "cache_drops": self.drops,
                   "cache_transfers_in": self.transfers_in,
                   "cache_transfers_out": self.transfers_out,
                   "cache_entries": len(self._entries)}
        out.update(self.pool.counters())
        return out
