"""Shared launcher flags, mapped 1:1 onto ``Plan`` fields.

Counterpart: ``repro/frontend/cli.py`` (``cli_args``, ``plan_from_args``,
``serve_flags``), cut to the flags that ``Session.serve``,
``Session.serve_stream`` and ``Session.train`` use, plus ``--device``.
``--localities``, ``--spmd``, ``--ddp``, ``--grad-codec``,
``--ddp-shards``, ``--elastic``, ``--elastic-port`` and ``--replicas``
map onto the plan, and so do the mesh flags ``--data``, ``--model`` and
``--pod`` (``--data 2 --model 2`` trains on four rank processes, every
family's layers split over each pair; ``--model 2`` or ``--data 2``
serves on two, through either loop; whisper-medium through the wave
loop only, as in the reference).  ``launch/train.py``'s
``--ckpt`` maps onto ``Plan.ckpt_dir``.
"""
from __future__ import annotations

import argparse
from typing import Optional

from ..configs import ARCH_IDS
from .plan import Plan

__all__ = ["cli_args", "plan_from_args", "serve_flags", "train_flags"]


def cli_args(ap: Optional[argparse.ArgumentParser] = None
             ) -> argparse.ArgumentParser:
    """Add the shared launcher flags (``--arch``, ``--tiny``/``--full``,
    ``--device``, ``--seed``, the mesh axes ``--data``/``--model``/
    ``--pod``, ``--localities``, ``--spmd``) to ``ap`` (created if
    None)."""
    if ap is None:
        ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs; 'cpu' runs the kernels' "
                         "plain versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", type=int, default=1,
                    help="the mesh's data axis: rank processes, each "
                         "training (or serving) its rows of the batch")
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model axis: rank processes that split "
                         "every family's layers (tensor and expert "
                         "parallelism)")
    ap.add_argument("--pod", type=int, default=1,
                    help="the mesh's pod axis (a second dp axis)")
    ap.add_argument("--localities", type=int, default=1,
                    help="total process count, the driver included: "
                         "worker localities build the batches (or with "
                         "--ddp each trains its own shard block), write "
                         "their checkpoint shards, and host the gateway's "
                         "replicas")
    ap.add_argument("--spmd", action="store_true",
                    help="SPMD mode over a torch.distributed world (needs "
                         "--localities > 1): every process trains in "
                         "lockstep and checkpoints only its own segments "
                         "(DESIGN.md §10)")
    return ap


def train_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The shape, fabric-DDP and elastic flags of ``launch/train.py``."""
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-layers", dest="n_layers", type=int, default=None,
                    help="override the config's layer count (full qwen3-4b "
                         "trains 12 of its 36 layers on one 80 GB card)")
    ap.add_argument("--ddp", action="store_true",
                    help="fabric data parallelism: the batch is split into "
                         "--ddp-shards row shards and the summed gradient "
                         "buckets go through --grad-codec every step")
    ap.add_argument("--grad-codec", dest="grad_codec", default="fp32",
                    choices=("fp32", "onebit"),
                    help="DDP gradient codec: fp32 (exact) or onebit (1-bit "
                         "+ error feedback, ~1/31 of the bytes)")
    ap.add_argument("--ddp-shards", dest="ddp_shards", type=int, default=0,
                    help="batch shard count for --ddp (0 = one per "
                         "locality); must divide --batch")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic membership: accept --join dial-ins "
                         "mid-run, arm the work-stealing loop on every "
                         "locality, and rebalance AGAS objects toward "
                         "newcomers (DESIGN.md §13)")
    ap.add_argument("--elastic-port", dest="elastic_port", type=int,
                    default=0,
                    help="fixed driver listen port for --join dialers "
                         "(0 = ephemeral; printed at start)")
    return ap


def serve_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The serving-gateway flag block (``launch/serve.py``): opt into the
    streamed gateway and its admission-control knobs."""
    ap.add_argument("--serve-stream", dest="serve_stream",
                    action="store_true",
                    help="serve through the continuous-batching gateway "
                         "(Session.serve_stream): requests arrive "
                         "mid-flight, prefill state parks in the paged "
                         "inference cache, slot refill loads pages "
                         "instead of recomputing")
    ap.add_argument("--max-inflight", dest="max_inflight", type=int,
                    default=None,
                    help="admission cap on requests holding resources "
                         "(queued-for-a-slot + decoding); default "
                         "2 * slots * replicas")
    ap.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                    default=None,
                    help="per-request deadline: a request still short of "
                         "a decode slot when it lapses expires cleanly "
                         "(its node chain is cancelled and its pages "
                         "reclaimed)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="model replica count for --serve-stream: each "
                         "replica has its own decode chain and the router "
                         "assigns every request to exactly one (page "
                         "affinity first); streams are bit-identical to "
                         "--replicas 1.  With --localities N the replicas "
                         "are homed on the localities in turn")
    ap.add_argument("--kill-replica-at", dest="kill_replica_at",
                    default=None, metavar="IDX:ROUND",
                    help="replica-death drill for --serve-stream: mark "
                         "replica IDX dead at decode round ROUND; "
                         "survivors absorb its queued and in-flight "
                         "requests (e.g. 0:2)")
    ap.add_argument("--stats-out", dest="stats_out", default=None,
                    metavar="FILE",
                    help="write the serve summary (counts, throughput, "
                         "gateway counters with the per-replica split, "
                         "latency histograms) as JSON to FILE")
    return ap


def plan_from_args(args, **overrides) -> Plan:
    """Build a ``Plan`` from a ``cli_args()`` namespace; keyword overrides
    win over parsed flags."""
    fields = {name: getattr(args, name)
              for name in ("arch", "tiny", "seed", "device", "batch", "seq",
                           "data", "model", "pod",
                           "localities", "spmd", "ddp", "grad_codec",
                           "ddp_shards",
                           "elastic", "elastic_port", "replicas")
              if hasattr(args, name)}
    if getattr(args, "ckpt", ""):
        fields["ckpt_dir"] = args.ckpt
    if getattr(args, "n_layers", None) is not None:
        fields["overrides"] = {"n_layers": args.n_layers}
    fields.update(overrides)
    return Plan(**fields)
