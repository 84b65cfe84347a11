"""Core of the port (counterpart: ``repro/core/``).

Modules:
  sharding - parameter specs and their initialization
  futures  - host-side futurized execution runtime
  fusion   - gradient buckets in the reference's layout
  steps    - train / DDP / prefill / decode step builders
"""
