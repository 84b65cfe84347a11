"""phylint: static execution-tree analysis + runtime concurrency sanitizer.

Counterpart: ``repro/analysis/__init__.py``.  Two layers (DESIGN.md §12):

* **static** — :mod:`repro_torch.analysis.lint` runs passes
  (PHY001–PHY006) over a built graph, a ``@futurize`` trace, or the
  dryrun mirrors in :mod:`repro_torch.analysis.trace_builders`, without
  executing anything; ``python -m repro_torch.analysis.phylint`` lints
  every shipped config's mirrors;
* **dynamic** — :mod:`repro_torch.analysis.sanitize` (armed by
  ``PHYRAX_SANITIZE=1``) turns hangs and silent protocol violations into
  named diagnostics (PHY101–PHY107): a wait-for-graph deadlock watchdog,
  active-message protocol checks, AGAS pin/deref accounting, steal-lease
  fencing and ring generation keys.

``sanitize`` is imported eagerly (it is stdlib-only and ``core.futures``
hooks into it at import time); the lint layer imports the core and is
loaded lazily so ``repro_torch.core.futures -> repro_torch.analysis``
stays acyclic.
"""

from __future__ import annotations

from . import sanitize
from .sanitize import DeadlockError, Diagnostic, Sanitizer

_LAZY = {
    # the ``lint`` *function* is deliberately not re-exported here:
    # ``repro_torch.analysis.lint`` must always name the submodule
    # whatever the import order (a lazy function attr would shadow it)
    "Finding": "lint",
    "LintGraph": "lint",
    "LintNode": "lint",
    "STATIC_RULES": "lint",
    "gateway_trace": "trace_builders",
    "plan_traces": "trace_builders",
    "serve_trace": "trace_builders",
    "step_contract": "trace_builders",
    "train_trace": "trace_builders",
}

__all__ = sorted(
    ["DeadlockError", "Diagnostic", "Sanitizer", "sanitize", *_LAZY]
)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value
