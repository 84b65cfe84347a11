"""Productivity frontend of the port (counterpart: ``repro/frontend/``):
the ``@futurize`` tracing decorator and the declarative ``Plan`` ->
``Session`` API the launchers are shims over."""
from .cli import (cli_args, plan_from_args, serve_flags,  # noqa: F401
                  train_flags)
from .futurize import (Trace, TraceNode, current_trace,  # noqa: F401
                       futurize, tracing)
from .plan import Plan, Session  # noqa: F401

__all__ = ["Plan", "Session", "Trace", "TraceNode", "cli_args",
           "current_trace", "futurize", "plan_from_args", "serve_flags",
           "tracing", "train_flags"]
