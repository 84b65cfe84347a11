"""Shared launcher flags, mapped 1:1 onto ``Plan`` fields.

Counterpart: ``repro/frontend/cli.py`` (``cli_args``, ``plan_from_args``,
``serve_flags``), cut to the flags that ``Session.serve`` uses, plus
``--device``.  The mesh, locality, DDP and elastic flags come with the
ROADMAP items that port those modes; the gateway flags with item 7.
"""
from __future__ import annotations

import argparse
from typing import Optional

from ..configs import ARCH_IDS
from .plan import Plan

__all__ = ["cli_args", "plan_from_args", "serve_flags"]


def cli_args(ap: Optional[argparse.ArgumentParser] = None
             ) -> argparse.ArgumentParser:
    """Add the shared launcher flags (``--arch``, ``--tiny``/``--full``,
    ``--device``, ``--seed``) to ``ap`` (created if None)."""
    if ap is None:
        ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs; 'cpu' runs the kernels' "
                         "plain versions")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def serve_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The serve flags ``Session.serve`` uses (``launch/serve.py``)."""
    ap.add_argument("--stats-out", dest="stats_out", default=None,
                    metavar="FILE",
                    help="write the serve summary (counts, throughput, "
                         "runtime stats) as JSON to FILE")
    return ap


def plan_from_args(args, **overrides) -> Plan:
    """Build a ``Plan`` from a ``cli_args()`` namespace; keyword overrides
    win over parsed flags."""
    fields = {name: getattr(args, name)
              for name in ("arch", "tiny", "seed", "device")}
    fields.update(overrides)
    return Plan(**fields)
