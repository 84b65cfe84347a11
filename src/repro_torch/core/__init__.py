"""Core of the port (counterpart: ``repro/core/``).

Modules:
  sharding - parameter specs and their initialization
  futures  - host-side futurized execution runtime
  steps    - prefill / decode step builders
"""
