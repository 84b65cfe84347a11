"""Serving launcher: a thin argparse shim over ``frontend.Plan/Session``.

Counterpart: ``repro/launch/serve.py``, the wave loop (``Session.serve``):
a fixed pool of decode slots; finished sequences (hit --gen-len) are
retired and refilled from the waiting queue with a fresh prefill, each
wave a futurized tree.  The streaming gateway (``--serve-stream``) comes
with ROADMAP item 7.  Runs on the GPU unless ``--device cpu`` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 8 \
      --slots 4 --prompt-len 512 --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --full --requests 8 --slots 4 --prompt-len 512 --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch zamba2-2.7b --requests 5 --slots 2 --prompt-len 16 --gen-len 8
"""
from __future__ import annotations

import argparse
import json

from repro_torch.frontend import cli_args, plan_from_args, serve_flags

# result keys that serialize cleanly
_JSON_KEYS = ("requests", "tokens", "padded_tokens", "tokens_per_s",
              "waves", "runtime_stats")


def run(args) -> dict:
    plan = plan_from_args(args)
    with plan.compile() as session:
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
