"""Serving launcher: a thin argparse shim over ``frontend.Plan/Session``.

Counterpart: ``repro/launch/serve.py``.  Two serving loops share this
entry point:

* the default wave loop (``Session.serve``): a fixed pool of decode slots;
  finished sequences (hit --gen-len) are retired and refilled from the
  waiting queue with a fresh prefill, each wave a futurized tree;
* ``--serve-stream`` (``Session.serve_stream``): the continuous-batching
  gateway - requests arrive mid-flight through a ``RequestQueue``,
  admission control caps in-flight work (``--max-inflight``) and expires
  laggards (``--deadline-ms``), and prefill state parks in the paged
  inference cache so retire-and-refill loads pages instead of
  recomputing.  ``--replicas N`` fans the gateway out over N model
  replicas, homed on the ``--localities`` in turn (each replica's request
  prep runs on its home; the model runs here), and ``--kill-replica-at
  IDX:ROUND`` runs the replica-death drill.

``--data D``, ``--pod P`` and ``--model M`` run either loop on a mesh of
D * P * M rank processes: the wave loop on every rank, each dp rank on
its rows of every wave (a single stream, ``--slots 1``, tiles its cache
by sequence over the mesh), M ranks splitting the dense, moe and zamba
families' layers (tensor and expert parallelism,
``frontend/mesh.rank_serve``); the gateway on rank
0, every other rank following its command stream
(``frontend/mesh.rank_serve_stream``).
``--stats-out FILE`` writes the run summary as JSON.  Runs on the GPU
unless ``--device cpu`` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 8 \
      --slots 4 --prompt-len 512 --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --full --serve-stream --requests 8 --slots 4 --prompt-len 512 \
      --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --serve-stream --replicas 2 --kill-replica-at 0:2 --requests 5 \
      --slots 2 --prompt-len 16 --gen-len 4 --stats-out serve_stats.json
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --serve-stream --localities 2 --replicas 2 --requests 8 --slots 2 \
      --prompt-len 16 --gen-len 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --model 2 --requests 5 --slots 2 --prompt-len 16 --gen-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --data 2 --requests 5 --slots 2 --prompt-len 16 --gen-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --serve-stream --model 2 --requests 5 --slots 2 --prompt-len 16 \
      --gen-len 4
"""
from __future__ import annotations

import argparse
import json

from repro_torch.frontend import cli_args, plan_from_args, serve_flags

# result keys that serialize cleanly (handles hold threads and futures)
_JSON_KEYS = ("requests", "completed", "cancelled", "expired", "failed",
              "rejected", "tokens", "padded_tokens", "tokens_per_s",
              "rounds", "epochs", "waves", "replicas",
              "replica_assignments", "streams", "cache", "runtime_stats")


def _parse_kill_at(spec):
    """``IDX:ROUND`` -> ``(idx, round)`` for the replica-death drill."""
    if spec is None:
        return None
    try:
        idx, round_ = spec.split(":")
        return (int(idx), int(round_))
    except ValueError:
        raise SystemExit(f"--kill-replica-at wants IDX:ROUND, got {spec!r}")


def run(args) -> dict:
    plan = plan_from_args(args)
    with plan.compile() as session:
        if getattr(args, "serve_stream", False):
            out = session.serve_stream(
                requests=args.requests, prompt_len=args.prompt_len,
                gen_len=args.gen_len, slots=args.slots,
                max_inflight=args.max_inflight,
                deadline_ms=args.deadline_ms,
                replicas=getattr(args, "replicas", None),
                kill_replica_at_round=_parse_kill_at(
                    getattr(args, "kill_replica_at", None)))
        else:
            out = session.serve(
                requests=args.requests, prompt_len=args.prompt_len,
                gen_len=args.gen_len, slots=args.slots)
    if getattr(args, "stats_out", None):
        payload = {k: out[k] for k in _JSON_KEYS if k in out}
        with open(args.stats_out, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        print(f"[serve] stats -> {args.stats_out}")
    return out


def parser() -> argparse.ArgumentParser:
    ap = cli_args()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    serve_flags(ap)
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
