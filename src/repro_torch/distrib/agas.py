"""AGAS-style object directory: global ids for locality-owned values.

Counterpart: ``repro/distrib/agas.py`` (``RemoteRef``, ``_Forward``,
``ObjectDirectory``, ``rebalance_plan``).  The reference walks a value's
leaves with JAX to size it (``_nbytes``); the port walks dicts, lists and
tuples itself and sums the bytes of the numpy arrays and tensors it
finds.  The runtime sanitizer's hooks are the reference's: unbalanced
pin/deref accounting (PHY105) and a deref through a dead forwarding stub
(PHY107).

HPX's Active Global Address Space names every distributed object with a
global id (gid) and resolves gids to owning localities, so tasks can be
co-located with their data instead of the data moving to the task
(DESIGN.md §9):

  * a ``gid`` is ``(owner_rank, index)``: ownership is encoded in the id
    itself, so resolution is a tuple read, never a lookup round-trip.
    Under *failure* a dead locality's values die with it (re-create,
    never migrate), but elastic scale-out migrates: ``rebalance`` moves a
    contiguous block of live objects to newcomer localities and leaves a
    ``_Forward`` stub per moved gid, so a stale ``RemoteRef`` derefs
    through one extra hop (DESIGN.md §13);
  * ``ObjectDirectory.put`` registers a value owned by this locality and
    returns a ``RemoteRef`` others can hold, ship, or deref;
  * ``fetch`` resolves a ref: a local dictionary hit when this locality
    owns it, one active-message request (``agas_fetch``) otherwise;
  * the distributed scheduler uses ref ownership for *data affinity*:
    a task whose arguments hold refs is placed on the majority owner,
    where every deref is local.

Pinned task results (``DistributedGraph.defer(..., pin=True)``) live
here: the worker keeps the value and streams back only the ref.  Values
that cross the wire are host values (numpy, Python objects), never CUDA
tensors.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Optional

from ..analysis import sanitize as _san

from .messaging import Endpoint, PeerLostError

__all__ = ["ObjectDirectory", "RemoteRef", "rebalance_plan", "tree_leaves"]


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of nested dicts (in sorted key order, as JAX orders
    them), lists and tuples; ``None`` is an empty subtree, as in JAX, and
    anything else is a leaf.  ``is_leaf(x)`` true stops the walk at
    ``x``."""
    out: list = []

    def walk(x):
        if is_leaf is not None and is_leaf(x):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is not None:
            out.append(x)
    walk(tree)
    return out


def tree_map(fn, tree, is_leaf=None):
    """``fn`` applied to every leaf of ``tree`` (as ``tree_leaves`` finds
    them), the containers rebuilt around the results."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return tree if tree is None else fn(tree)


def _nbytes(value: Any) -> int:
    """Rough payload size: summed array bytes over the value's leaves
    (used for reporting only, never for correctness)."""
    total = 0
    for leaf in tree_leaves(value):
        if hasattr(leaf, "nbytes"):
            total += int(getattr(leaf, "nbytes", 0))
    return total


@dataclasses.dataclass(frozen=True)
class RemoteRef:
    """A global name for a value owned by one locality.

    Ships freely over the wire (it is just the id plus bookkeeping);
    holding a ref does not keep the owner alive.  Deref via
    ``ObjectDirectory.fetch`` or by passing it as an argument to a
    distributed task - the worker dereferences refs before calling the
    task function.
    """
    gid: tuple[int, int]        # (owner_rank, index)
    nbytes: int = 0
    summary: str = ""

    @property
    def owner(self) -> int:
        """Rank of the owning locality (encoded in the gid)."""
        return self.gid[0]

    def __repr__(self):
        return (f"<RemoteRef {self.gid[0]}:{self.gid[1]} "
                f"{self.summary or 'value'} ~{self.nbytes}B>")


@dataclasses.dataclass(frozen=True)
class _Forward:
    """Owner-side forwarding stub left behind by ``rebalance``: the value
    migrated to ``ref``'s locality; a deref of the old gid chases the stub
    one hop.  Stored in ``_store`` in place of the value, so a stale
    ``RemoteRef`` held anywhere keeps resolving."""
    ref: RemoteRef


def rebalance_plan(indices: list[int], owner: int,
                   newcomers: list[int]) -> dict[int, list[int]]:
    """Contiguous-block reassignment of one owner's live object indices
    across ``[owner] + newcomers``: the ownership math of
    ``checkpoint.format.assign_shards`` (blocks as even as possible, at
    most one element of spread); the owner keeps the first block, each
    newcomer adopts one of the rest.

    Returns:
        ``{newcomer_rank: [indices to migrate]}`` (the owner's block is
        implied; empty blocks are omitted).
    """
    # imported here: the checkpoint package imports this one
    from ..checkpoint.format import assign_shards

    idxs = sorted(indices)
    plan: dict[int, list[int]] = {}
    for _sid, rank, block in assign_shards(len(idxs), [owner, *newcomers]):
        if rank != owner and block:
            plan[rank] = [idxs[i] for i in block]
    return plan


class ObjectDirectory:
    """This locality's slice of the global address space.

    Args:
        rank: owning locality rank, baked into every gid issued here.
        endpoint: active-message endpoint; ``agas_fetch``/``agas_free``
            handlers are registered on it so any peer can deref/free.
    """

    def __init__(self, rank: int, endpoint: Optional[Endpoint] = None):
        self.rank = rank
        self.endpoint = endpoint
        self._store: dict[int, Any] = {}
        self._lock = threading.Lock()
        self._counter = itertools.count()
        # pin/deref accounting: every local put/fetch/free of gids owned
        # HERE, and derefs that chased a forwarding stub
        self.puts = 0
        self.local_fetches = 0
        self.frees = 0
        self.migrated = 0
        self.forwarded_fetches = 0
        self._freed: set[int] = set()
        if endpoint is not None:
            endpoint.register("agas_fetch", self._on_fetch)
            endpoint.register("agas_free", self._on_free)
            endpoint.register("agas_adopt", self._on_adopt)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    # -- registration -------------------------------------------------------
    def put(self, value: Any, *, summary: str = "") -> RemoteRef:
        """Register ``value`` as owned by this locality.

        Returns:
            A ``RemoteRef`` naming it globally; the value stays here
            until ``free``d or the locality shuts down.
        """
        with self._lock:
            idx = next(self._counter)
            self._store[idx] = value
            self.puts += 1
        return RemoteRef(gid=(self.rank, idx), nbytes=_nbytes(value),
                         summary=summary)

    # -- resolution ---------------------------------------------------------
    def fetch(self, ref: RemoteRef, *, timeout: float = 60.0) -> Any:
        """Deref: local dictionary hit when owned here, one
        ``agas_fetch`` round-trip to the owner otherwise.  A gid whose
        value migrated away (elastic rebalance) resolves through its
        forwarding stub: one extra hop.

        Raises:
            KeyError: the gid was never registered or already freed.
            PeerLostError: the owning locality is gone (its values die
                with it - the failure model's re-create-not-migrate rule).
        """
        owner, idx = ref.gid
        if owner == self.rank:
            with self._lock:
                if idx not in self._store:
                    self._diagnose_miss(idx, self.rank)
                    raise KeyError(f"gid {ref.gid} not in directory")
                value = self._store[idx]
                if not isinstance(value, _Forward):
                    self.local_fetches += 1
                    return value
            return self._chase(ref, value, timeout)
        if self.endpoint is None:
            raise KeyError(f"gid {ref.gid} is remote and this directory "
                           f"has no endpoint")
        out = self.endpoint.request(owner, "agas_fetch", list(ref.gid),
                                    timeout=timeout)
        if isinstance(out, _Forward):
            return self._chase(ref, out, timeout)
        return out

    def _chase(self, ref: RemoteRef, fwd: _Forward, timeout: float) -> Any:
        """Deref one hop through a forwarding stub.  A chase that lands
        on a dead locality or a freed target means the stub outlived the
        migrated value: PHY107."""
        with self._lock:
            self.forwarded_fetches += 1
        try:
            return self.fetch(fwd.ref, timeout=timeout)
        except (KeyError, ConnectionError) as e:
            if _san.active():
                _san.get().record(
                    "PHY107",
                    f"locality {self.rank}: deref of gid {ref.gid} chased "
                    f"a forwarding stub to dead gid {fwd.ref.gid}: {e}",
                    once_key=f"fwd:{self.rank}:{ref.gid}")
            raise

    def free(self, ref: RemoteRef):
        """Drop the value behind ``ref`` (idempotent; remote owners get
        a fire-and-forget ``agas_free``)."""
        owner, idx = ref.gid
        if owner == self.rank:
            self._free_local(idx)
        elif self.endpoint is not None:
            self.endpoint.post(owner, "agas_free", list(ref.gid))

    def _free_local(self, idx: int):
        with self._lock:
            value = self._store.pop(idx, None)
            present = value is not None
            if present:
                self.frees += 1
                self._freed.add(idx)
            # double-free is idempotent by contract; freeing an index
            # that was never issued is an accounting bug (PHY105)
            unknown = not present and idx not in self._freed
        if unknown and _san.active():
            _san.get().record(
                "PHY105",
                f"locality {self.rank}: free of never-registered gid "
                f"({self.rank}, {idx})",
                once_key=f"free:{self.rank}:{idx}")
        if isinstance(value, _Forward) and self.endpoint is not None:
            # freeing a migrated gid frees the migrated value too
            try:
                self.endpoint.post(value.ref.owner, "agas_free",
                                   list(value.ref.gid))
            except PeerLostError:
                pass                  # new owner already gone; nothing held

    def _diagnose_miss(self, idx: int, requester) -> None:
        """Classify a fetch miss for the sanitizer (caller raises)."""
        if not _san.active():
            return
        kind = ("fetch after free" if idx in self._freed
                else "fetch of never-registered gid")
        _san.get().record(
            "PHY105",
            f"locality {self.rank}: {kind} ({self.rank}, {idx}) "
            f"requested by locality {requester}",
            once_key=f"fetch:{self.rank}:{idx}")

    def audit(self) -> dict:
        """Pin/deref accounting for this locality's slice of the address
        space: informational (surfaced in runtime stats); imbalances that
        are provable bugs are reported as PHY105 diagnostics instead."""
        with self._lock:
            return {"live": len(self._store), "puts": self.puts,
                    "local_fetches": self.local_fetches,
                    "frees": self.frees, "migrated": self.migrated,
                    "forwarded_fetches": self.forwarded_fetches}

    # -- elastic rebalance ---------------------------------------------------
    def rebalance(self, newcomers: list[int]) -> int:
        """Migrate contiguous tail blocks of this locality's live objects
        onto ``newcomers`` (``rebalance_plan``), leaving a forwarding stub
        per moved gid so that stale refs keep resolving.  Values that
        cannot cross the wire and gids freed mid-pass stay put: migration
        is best-effort and never needed for correctness.

        Returns:
            Number of objects migrated away.
        """
        newcomers = [r for r in newcomers if r != self.rank]
        if not newcomers or self.endpoint is None:
            return 0
        with self._lock:
            live = [i for i, v in self._store.items()
                    if not isinstance(v, _Forward)]
        moved = 0
        for rank, idxs in rebalance_plan(live, self.rank, newcomers).items():
            for idx in idxs:
                with self._lock:
                    value = self._store.get(idx)
                if value is None or isinstance(value, _Forward):
                    continue          # freed or migrated concurrently
                try:
                    new_ref = self.endpoint.request(
                        rank, "agas_adopt",
                        {"value": value,
                         "summary": f"migrated:{self.rank}:{idx}"})
                except Exception:  # noqa: BLE001 - unshippable value or
                    continue       # unreachable newcomer: keep it home
                with self._lock:
                    still_here = idx in self._store
                    if still_here:
                        self._store[idx] = _Forward(ref=new_ref)
                        self.migrated += 1
                        moved += 1
                if not still_here:
                    # freed while in flight: release the adopted copy
                    try:
                        self.endpoint.post(rank, "agas_free",
                                           list(new_ref.gid))
                    except PeerLostError:
                        pass
        return moved

    # -- handlers ------------------------------------------------------------
    def _on_fetch(self, src: int, gid) -> Any:
        _, idx = gid
        with self._lock:
            if idx in self._store:
                self.local_fetches += 1
                return self._store[idx]
        self._diagnose_miss(idx, src)
        raise KeyError(f"gid {tuple(gid)} not in directory of "
                       f"locality {self.rank}")

    def _on_free(self, src: int, gid):
        _, idx = gid
        self._free_local(idx)

    def _on_adopt(self, src: int, p: dict) -> RemoteRef:
        """Rebalance target side: take ownership of a migrated value and
        return its new ref (the old owner stores it in a stub)."""
        return self.put(p["value"], summary=p.get("summary", ""))
