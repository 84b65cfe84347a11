"""Core of the port (counterpart: ``repro/core/``).

Modules:
  sharding    - parameter specs, their initialization, the tiling rules
  futures     - host-side futurized execution runtime
  fusion      - gradient buckets in the reference's layout
  collectives - collectives over a mesh's dp, model or stage process
                group, and the model axis's autograd pairs
  granularity - grain-size napkin math (the fusion cap)
  overlap     - the horovod / phylanx / zero1 gradient exchange
  resilience  - checksums, replay and replicate of a step
  steps       - train / DDP / prefill / decode step builders
  pipeline    - the GPipe schedule over a stage axis of rank processes
  dist_array  - TiledArray: one rank's tile with the tiling plan
"""
