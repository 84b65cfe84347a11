"""Distribution layer of the port (counterpart: ``repro/distrib/``): the
gradient codecs and the ring all-reduce at world 1.  The multi-locality
runtime (messaging, AGAS, the runtime itself) waits for ROADMAP item 12."""
