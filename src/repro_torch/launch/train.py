"""Training launcher: a thin argparse shim over ``frontend.Plan/Session``.

Counterpart: ``repro/launch/train.py``, cut to the flags the port can
run: ``--steps``, ``--strategy``, ``--grad-accum``, ``--remat``,
``--ckpt``, ``--ckpt-every``, ``--resume``, ``--log-every``,
``--fail-at-step``, ``--stats-out`` and world-1 fabric DDP (``--ddp``,
``--grad-codec``, ``--ddp-shards``), plus ``--device`` and
``--n-layers``.  ``--localities`` above 1 (ROADMAP item 12), ``--join``
(item 12) and ``--elastic`` (item 13) raise.  Runs on the GPU unless
``--device cpu`` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 12 --batch 4 --seq 32 --log-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 12 --batch 4 --seq 32 --ddp --grad-codec onebit \\
      --ddp-shards 2 --log-every 4
  # the fault drill: crash after the step-4 checkpoint, then resume
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --batch 4 --seq 32 --ckpt /tmp/ck --ckpt-every 4 \
      --fail-at-step 6
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --batch 4 --seq 32 --ckpt /tmp/ck --ckpt-every 4 --resume
  PYTHONPATH=src python -m repro_torch.launch.train --full --n-layers 12 \\
      --steps 6 --batch 8 --seq 512 --log-every 1
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.steps import Strategy
from repro_torch.frontend import cli_args, plan_from_args, train_flags


def run(args) -> dict:
    if getattr(args, "join", None):
        raise NotImplementedError(
            "--join dials into a multi-locality driver: the multi-locality "
            "runtime is ROADMAP item 12")
    strategy = Strategy(name=args.strategy, grad_accum=args.grad_accum)
    plan = plan_from_args(args, strategy=strategy, remat=args.remat)
    with plan.compile() as session:
        out = session.train(
            steps=args.steps, ckpt_dir=args.ckpt,
            ckpt_every=args.ckpt_every, log_every=args.log_every,
            resume=args.resume, fail_at_step=args.fail_at_step)
    if getattr(args, "stats_out", None):
        payload = {"final_loss": out["final_loss"], "losses": out["losses"],
                   "step": out["step"]}
        for k in ("grad_wire_bytes", "codec_bytes"):
            if k in out:
                payload[k] = out[k]
        with open(args.stats_out, "w") as f:
            json.dump(payload, f, indent=2)
    return out


def parser() -> argparse.ArgumentParser:
    ap = train_flags(cli_args())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--strategy", default="phylanx",
                    choices=["phylanx", "horovod", "zero1", "onebit"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (empty: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="save (params, opt) to --ckpt every this many "
                         "steps, and after the last step")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="drill: raise an injected failure at this step "
                         "(ignored with --resume)")
    ap.add_argument("--join", default=None, metavar="HOST:PORT",
                    help="join a running --elastic driver (ROADMAP item 12: "
                         "raises)")
    ap.add_argument("--stats-out", dest="stats_out", default=None,
                    metavar="FILE",
                    help="write a JSON summary (losses, and the DDP byte "
                         "counts) here after training")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
