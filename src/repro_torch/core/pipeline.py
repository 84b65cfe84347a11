"""GPipe-style pipeline parallelism: what the port has of it.

Counterpart: ``repro/core/pipeline.py`` (``bubble_fraction``,
``gpipe_apply``, ``make_pipeline_fn``).  The reference runs its schedule
as a ``lax.scan`` over ticks inside ``shard_map`` and lets JAX
differentiate ``ppermute`` for the backward pipeline; the port needs an
autograd ``pipeline_shift`` over rank processes first, ROADMAP item 14b.
The schedule's bubble is plain arithmetic and is here.
"""
from __future__ import annotations

__all__ = ["bubble_fraction", "gpipe_apply", "make_pipeline_fn"]

_REFUSAL = ("GPipe pipeline parallelism over rank processes (an autograd "
            "pipeline_shift) is ROADMAP item 14b")


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The idle share of a GPipe schedule: ``(S - 1) / (M + S - 1)``."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def gpipe_apply(*args, **kwargs):
    """Raises: NotImplementedError (ROADMAP item 14b)."""
    raise NotImplementedError(_REFUSAL)


def make_pipeline_fn(*args, **kwargs):
    """Raises: NotImplementedError (ROADMAP item 14b)."""
    raise NotImplementedError(_REFUSAL)
