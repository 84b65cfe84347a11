"""Training launcher: a thin argparse shim over ``frontend.Plan/Session``.

Counterpart: ``repro/launch/train.py``, cut to the flags the port can
run: ``--steps``, ``--strategy``, ``--grad-accum``, ``--remat``,
``--ckpt``, ``--ckpt-every``, ``--resume``, ``--log-every``,
``--fail-at-step``, ``--stats-out``, ``--localities`` and
``--kill-locality-at-step`` (the multi-locality runtime: with ``--ckpt``
each locality writes its own shards, and ``--resume`` reads them at any
locality count), fabric DDP (``--ddp``, ``--grad-codec``,
``--ddp-shards``), SPMD mode (``--spmd`` with ``--localities N``: all N
processes join one ``torch.distributed`` world, train in lockstep and
each writes only its own checkpoint segments, DESIGN.md §10; a later
``--resume`` run at any process count reads them back) and elastic
membership (DESIGN.md §13: ``--elastic``
and ``--elastic-port`` start a driver that prints its join address and
takes new localities mid-run; ``--join HOST:PORT`` makes this invocation
a dial-in locality of that driver instead of a training run, which
steals host tasks when idle and exits when the driver's run ends;
``--expect-joins N`` holds the driver's first step until N dial-ins
joined, and ``--stall-at-step K`` sleeps 250 ms on the driver at step K,
the deterministic steal window), the mesh axes (``--data``, ``--pod``:
that many rank processes, each training its rows of the batch with
``--strategy`` phylanx, horovod, zero1 or onebit; ``--model M``: M rank
processes for each, splitting every family's layers;
``--seq-parallel``: the residual split by sequence over the model
group) and ``--resilience``
(``none``, ``replay``, ``replicate``), plus ``--device`` and
``--n-layers``.  The mesh axes compose with the other modes: beside
``--localities`` or ``--elastic`` the localities are task localities
(batch builds, checkpoint shards), ``--ddp --model M`` makes each
locality a model group of M rank processes, and ``--spmd`` gives each
locality a mesh of its own.
Runs on the GPU unless ``--device cpu`` is given; every locality runs on
that device.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 12 --batch 4 --seq 32 --log-every 4
  # a mesh of two rank processes with sharded (ZeRO-1) solver state
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 12 --batch 4 --seq 32 --log-every 4 --data 2 --strategy zero1
  # a data=2, model=2 mesh: four rank processes, tensor parallel in pairs
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --tiny \
      --data 2 --model 2 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 12 --batch 4 --seq 32 --ddp --grad-codec onebit \\
      --ddp-shards 2 --log-every 4
  # the fault drill: crash after the step-4 checkpoint, then resume
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --batch 4 --seq 32 --ckpt /tmp/ck --ckpt-every 4 \
      --fail-at-step 6
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --batch 4 --seq 32 --ckpt /tmp/ck --ckpt-every 4 --resume
  # two localities: batches built on the worker, a worker killed at step
  # 10 (training goes on); then 2-locality fabric DDP over the ring
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 20 --batch 4 --seq 32 --localities 2 \\
      --kill-locality-at-step 10
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 12 --batch 4 --seq 32 --localities 2 --ddp \\
      --grad-codec onebit --ddp-shards 2 --log-every 4
  # fabric DDP beside a model axis: two localities, each a model group
  # of two rank processes (the ring carries model=1's buckets)
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 4 --batch 4 --seq 32 --ddp --model 2 --localities 2 \
      --grad-codec onebit --ddp-shards 2
  # owner-written checkpoint shards at two localities, resumed at one
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 8 --batch 4 --seq 32 --localities 2 --ckpt /tmp/ck2 \\
      --ckpt-every 4 --fail-at-step 6
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 8 --batch 4 --seq 32 --ckpt /tmp/ck2 --ckpt-every 4 --resume
  # SPMD host-loss drill: two processes in lockstep, each writing its own
  # segments; the run fails after the step-4 save, resumes at one process
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --batch 4 --seq 32 --localities 2 --spmd --ckpt /tmp/ck3 \
      --ckpt-every 4 --fail-at-step 6
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --batch 4 --seq 32 --ckpt /tmp/ck3 --ckpt-every 4 --resume
  # an elastic driver held for one dial-in, and the dial-in (two shells)
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 12 --batch 4 --seq 32 --elastic --elastic-port 29517 \\
      --expect-joins 1 --stall-at-step 6
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --join 127.0.0.1:29517
  PYTHONPATH=src python -m repro_torch.launch.train --full --n-layers 12 \\
      --steps 6 --batch 8 --seq 512 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch whisper-medium --steps 6 --batch 8 --seq 512 --log-every 1
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.steps import Strategy
from repro_torch.distrib import join_locality
from repro_torch.frontend import cli_args, plan_from_args, train_flags

JOIN_WAIT_S = 180.0


class StallHook:
    """A driver-side 250 ms stall at one step: a joined locality drains
    its queue, goes hungry, and the next steerable prefetch build is
    diverted to it - the deterministic steal window (DESIGN.md §13)."""

    def __init__(self, at: int):
        self.at = at

    def on_step(self, it, metrics):
        if it == self.at:
            time.sleep(0.25)


def wait_for_joins(session, n: int, timeout: float = JOIN_WAIT_S):
    """Hold until ``n`` dial-ins are members: a ``--join`` dialer pays
    its own interpreter and import start-up, and a fast driver would
    finish before the dial lands.

    Raises:
        TimeoutError: fewer than ``n`` joined within ``timeout``.
    """
    deadline = time.monotonic() + timeout
    while session.distributed.stats()["joined_localities"] < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"expected {n} --join dial-in(s) within "
                               f"{timeout}s")
        time.sleep(0.1)


def run(args) -> dict:
    if getattr(args, "join", None):
        # this process is a dial-in locality, not a training driver
        host, _, port = args.join.rpartition(":")
        rank = join_locality((host or "127.0.0.1", int(port)))
        print(f"[train] served as elastic locality {rank}; driver run "
              f"ended", flush=True)
        return {"joined_as": rank}
    strategy = Strategy(name=args.strategy, grad_accum=args.grad_accum,
                        sequence_parallel=args.seq_parallel)
    plan = plan_from_args(args, strategy=strategy, remat=args.remat)
    with plan.compile() as session:
        if session.join_address is not None:
            host, port = session.join_address
            print(f"[train] elastic: accepting --join {host}:{port}",
                  flush=True)
        if args.expect_joins:
            wait_for_joins(session, args.expect_joins)
            print(f"[train] elastic: {args.expect_joins} dial-in(s) "
                  f"joined; training", flush=True)
        hooks = (StallHook(args.stall_at_step)
                 if args.stall_at_step is not None else None)
        out = session.train(
            steps=args.steps, hooks=hooks, ckpt_dir=args.ckpt,
            ckpt_every=args.ckpt_every, log_every=args.log_every,
            resume=args.resume, fail_at_step=args.fail_at_step,
            kill_locality_at_step=args.kill_locality_at_step,
            resilience=args.resilience)
    if getattr(args, "stats_out", None):
        payload = {"final_loss": out["final_loss"], "losses": out["losses"],
                   "step": out["step"],
                   "distributed": out["runtime_stats"].get("distributed")}
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
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence parallelism on the model axis: the "
                         "residual between blocks holds each model rank's "
                         "rows of the sequence (the plain path at --model "
                         "1)")
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
    ap.add_argument("--kill-locality-at-step", dest="kill_locality_at_step",
                    type=int, default=None,
                    help="drill: SIGKILL a worker locality at this step "
                         "(plain training re-spawns its tasks; DDP aborts)")
    ap.add_argument("--resilience", default="none",
                    choices=["none", "replay", "replicate"],
                    help="HPX-style step resilience: replay a step whose "
                         "result is not finite, or run two replicas and "
                         "pick by checksum (a mesh agrees the verdict)")
    ap.add_argument("--join", default=None, metavar="HOST:PORT",
                    help="join a running --elastic driver as an extra "
                         "locality instead of training (all other flags "
                         "are ignored; the driver ships its config)")
    ap.add_argument("--expect-joins", dest="expect_joins", type=int,
                    default=0, metavar="N",
                    help="drill (needs --elastic): wait for N --join "
                         "dial-ins before the first step, so the joiner "
                         "is a member for the whole run")
    ap.add_argument("--stall-at-step", dest="stall_at_step", type=int,
                    default=None, metavar="K",
                    help="drill: sleep 250 ms on the driver at step K - "
                         "the deterministic work-steal window")
    ap.add_argument("--stats-out", dest="stats_out", default=None,
                    metavar="FILE",
                    help="write a JSON summary (losses, the distributed "
                         "counters and the DDP byte counts) here after "
                         "training")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
