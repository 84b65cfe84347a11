"""Data pipeline of the port (counterpart: ``repro/data/``)."""
