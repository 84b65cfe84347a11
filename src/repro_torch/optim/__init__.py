"""Optimizers and gradient compression of the port (counterpart:
``repro/optim/``)."""
