"""Core of the port (counterpart: ``repro/core/``).

Modules:
  sharding    - parameter specs, their initialization, the tiling rules
  futures     - host-side futurized execution runtime
  fusion      - gradient buckets in the reference's layout
  collectives - collectives over a mesh's dp or model process group
  granularity - grain-size napkin math (the fusion cap)
  overlap     - the horovod / phylanx / zero1 gradient exchange
  resilience  - checksums, replay and replicate of a step
  steps       - train / DDP / prefill / decode step builders
  pipeline    - GPipe's bubble; the schedule raises (ROADMAP item 14b)
  dist_array  - TiledArray raises (ROADMAP item 14b)
"""
