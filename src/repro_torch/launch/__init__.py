"""Launchers of the port (counterpart: ``repro/launch/``)."""
