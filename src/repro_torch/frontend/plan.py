"""Plan/Session: the declarative frontend over the futurized runtime.

Counterpart: ``repro/frontend/plan.py`` (``Plan``, and ``Session``'s
``__init__``, ``_start_jax_distributed`` as ``_start_distributed``,
``close``, ``stats``, ``lint``, ``train_step``, ``train`` with
``_train_ddp`` folded into it, ``_serve_steps_for``, ``serve`` and
``serve_stream``).  A
``Plan`` is the *what* of a run, a frozen value that touches no device state;
``plan.compile()`` builds a ``Session`` that owns ONE futurized runtime
(``core/futures.py``) for every host-side task of the session.

``Plan`` has the JAX package's fields plus ``device``, which is ``"cuda"``
unless the caller asks for ``"cpu"``: a CUDA plan on a machine without a
GPU raises, it never carries on on the CPU.  ``Session.train`` runs the
single-device loop and, with ``ddp=True``, fabric DDP with the ``fp32`` or
``onebit`` gradient codec, each with checkpoints and resume
(``checkpoint/``).  With ``localities > 1`` the session owns a
``distrib.DistributedGraph`` (``self.distributed``) of spawned worker
processes, as the reference's does: ``train`` builds its batches and
``serve`` stacks its waves on worker localities while every device step
stays here, checkpoint shards are written by the localities that own
them, and ``train`` with ``ddp=True`` runs the DDP loop on every
locality, each on its own device, summing gradients over the active
message ring.  ``serve_stream`` homes its gateway replicas on the
localities (their requests' ``stack`` prep runs there; the model runs
here).  ``Plan(elastic=True)`` takes new localities mid-run
(``Session.add_locality``, or a ``--join`` dial-in at
``Session.join_address``) that steal host tasks (DESIGN.md §13).
``Plan(spmd=True, localities=N)`` is SPMD mode (DESIGN.md §10): the N
processes join a ``torch.distributed`` gloo world, every worker runs the
train loop in lockstep (``frontend/spmd.py``) and each process writes its
own checkpoint segments (``checkpoint/spmd.py``).  ``Session.lint`` runs
phylint's static passes over the session's live graph.
``Plan(data=D, pod=P, model=M)`` with ``D * P * M > 1`` is a mesh
session: ``compile`` stands up a ``torch.distributed`` world of ``D * P *
M`` rank processes (this process rank 0, the others spawned as worker
localities, over SPMD mode's bring-up), and ``train`` runs the mesh train
step (``core/steps.py``: the phylanx, horovod, zero1 and onebit
strategies; a model axis > 1 splits the dense, moe and zamba families'
layers over each row of M ranks) in lockstep on every rank (``frontend/mesh.py``), with
checkpoints in the reference's global layout and the
``replay``/``replicate`` resilience modes.  ``serve`` on any mesh runs
the wave loop on every rank (``frontend/mesh.rank_serve``: each dp rank
on its rows of every wave, a single stream's cache tiled by sequence as
``decode_rules`` says; it ignores ``Strategy.sequence_parallel``, as the
reference's serve steps take ``decode_rules``, while ``train`` runs it),
and ``serve_stream`` runs the gateway on rank 0 with every other rank
following its command stream (``frontend/mesh.rank_serve_stream``).
What is still missing raises ``NotImplementedError`` naming the ROADMAP
item that brings it: the model axis for the xlstm and encdec families,
for onebit and for sequence parallelism beyond the dense family, and a mesh with SPMD mode, fabric localities or elastic
membership (item 14b), the production meshes and named shapes (item
15).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..configs import get_config
from ..core import steps as steps_lib
from ..core.futures import FuturizedGraph, Lane, Pipeline, block_until_ready
from ..core.resilience import ResilientRunner
from ..core.sharding import init_params
from ..data.pipeline import Prefetcher, stream_for
from ..distrib.collectives import CODECS, RingAllReduce
from ..distrib.runtime import DistributedGraph
from .ddp import DDPEngine
from .futurize import Trace
from .gateway import Gateway, RequestQueue
from .mesh import rank_serve, rank_serve_stream, rank_train

__all__ = ["Plan", "Session"]

#: how long the driver waits for its own join of the SPMD world
_DIST_INIT_TIMEOUT_S = 120.0


def _stack_wave(wave):
    """Host prep of one serve wave (module-level: ships to a worker
    locality by reference when ``plan.localities > 1``)."""
    return np.stack(wave)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Declarative run description: arch + mesh axes + strategy + shapes.

    The fields are those of ``repro.frontend.Plan`` (see its docstring):
    ``data``, ``pod`` and ``model`` are the local mesh's axes, each rank a
    process; the production meshes wait (ROADMAP item 15).

    Fields added by the port:
        device: ``"cuda"`` (the default) or ``"cpu"``.
    """
    arch: str = "qwen3-4b"
    tiny: bool = True
    data: int = 1
    model: int = 1
    pod: int = 1
    mesh: str = "local"                  # local | single | multipod
    strategy: Any = "phylanx"
    batch: int = 8
    seq: int = 64
    seed: int = 0
    shape: Optional[str] = None          # named SHAPES cell (dryrun)
    remat: bool = False
    localities: int = 1                  # processes incl. the driver
    spmd: bool = False
    ddp: bool = False
    grad_codec: str = "fp32"
    ddp_shards: int = 0
    ckpt_dir: str = ""
    elastic: bool = False
    elastic_port: int = 0
    replicas: int = 1
    overrides: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"

    def config(self):
        cfg = get_config(self.arch, tiny=self.tiny)
        over = dict(self.overrides)
        if self.tiny:
            over.setdefault("remat", self.remat)
        return dataclasses.replace(cfg, **over) if over else cfg

    def build_strategy(self) -> steps_lib.Strategy:
        if isinstance(self.strategy, steps_lib.Strategy):
            return self.strategy
        return steps_lib.Strategy(name=self.strategy)

    def compile(self) -> "Session":
        """Build the runnable ``Session`` for this plan.  Use it as a
        context manager so the shutdown barrier always runs."""
        return Session(self)


def _destroy_world():
    """Leave the ``torch.distributed`` world, if this process is in one.
    After a join that never completed (a worker died before it joined),
    give back the name it took instead: the default group's name comes
    from a per-process counter that ``destroy_process_group`` resets, and
    a counter left one ahead would key this process's next world apart
    from its new peers', which start at zero."""
    import torch.distributed as dist
    if not dist.is_available():
        return
    if dist.is_initialized():
        dist.destroy_process_group()
        return
    from torch.distributed import distributed_c10d
    world = getattr(distributed_c10d, "_world", None)
    if world is not None and hasattr(world, "group_count"):
        world.group_count = 0


def _unsupported(plan: Plan) -> Optional[str]:
    n = plan.data * plan.pod * plan.model
    if plan.mesh != "local":
        return (f"the {plan.mesh!r} production mesh (dryrun's, ROADMAP "
                f"item 15)")
    if plan.shape is not None:
        return "named shapes (dryrun, ROADMAP item 15)"
    if n > 1 and plan.spmd:
        return "SPMD mode with mesh axes (ROADMAP item 14b)"
    if n > 1 and (plan.localities > 1 or plan.elastic):
        return ("mesh axes with fabric localities or elastic membership "
                "(ROADMAP item 14b)")
    if plan.model > 1:
        if plan.ddp:
            return "fabric DDP with a model axis (ROADMAP item 14b)"
        return steps_lib.model_axis_refusal(plan.config(),
                                            plan.build_strategy())
    return None


class Session:
    """Compiled form of a ``Plan``: the device, lazily built serve steps,
    and one futurized runtime for every host-side task.  Use as a context
    manager (or call ``close()``) to run the shutdown barrier.

    With ``plan.localities > 1`` (or ``plan.elastic``) the session also
    owns a ``DistributedGraph`` (``self.distributed``): worker localities
    are spawned here and host-side nodes are placed on them; ``close()``
    drains the distributed graph before the local shutdown barrier, so
    worker teardown never strands a promise.

    With ``plan.spmd`` the processes also form a ``torch.distributed``
    world (gloo; rank 0 is this process): the driver's join starts on a
    thread before the workers are spawned, since it completes only when
    every rank has joined, and the coordinator reaches the workers through
    their spawn environment alone; ``close()`` tears the world down, so a
    later session in the same interpreter starts clean.

    Raises:
        ValueError: a plan the reference refuses (``spmd`` with fewer
            than two localities or with ``ddp``, ``elastic`` with
            ``spmd`` or ``ddp``, a bad DDP codec or shard count).
        NotImplementedError: a plan the port does not run yet.
        RuntimeError: a CUDA plan without a GPU.
    """

    def __init__(self, plan: Plan, *, max_workers: int = 4):
        self.device = torch.device(plan.device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"Plan(device={plan.device!r}): the port runs "
                             f"on 'cuda' or 'cpu'")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Plan(device={plan.device!r}) but torch.cuda.is_available() "
                f"is False: the port runs on a CUDA device; pass "
                f"device='cpu' to run its plain versions on the CPU")
        if plan.elastic and (plan.spmd or plan.ddp):
            raise ValueError(
                "Plan(elastic=True) does not compose with spmd or ddp: "
                "their collectives assume a fixed world; elastic "
                "membership is for the task-parallel runtime")
        if plan.spmd and plan.localities < 2:
            raise ValueError("Plan(spmd=True) needs localities >= 2: "
                             "SPMD mode is the multi-process path")
        if plan.ddp and plan.spmd:
            raise ValueError("Plan(ddp=True) and Plan(spmd=True) are "
                             "exclusive multi-process modes: ddp shards "
                             "the batch, spmd mirrors it")
        if plan.ddp and plan.data * plan.pod > 1:
            raise ValueError("ddp=True replaces the in-process dp axes: use "
                             "a mesh with data=pod=1 (model-axis sharding "
                             "is fine)")
        missing = _unsupported(plan)
        if missing is not None:
            raise NotImplementedError(f"the port does not run {missing} yet")
        if plan.ddp:
            if plan.grad_codec not in CODECS:
                raise ValueError(f"unknown grad_codec {plan.grad_codec!r} "
                                 f"(have: {sorted(CODECS)})")
            world = max(plan.localities, 1)
            shards = plan.ddp_shards or world
            if shards % world:
                raise ValueError(f"ddp_shards={shards} must be a multiple "
                                 f"of localities={world}")
            if plan.batch % shards:
                raise ValueError(f"batch={plan.batch} must be divisible by "
                                 f"ddp_shards={shards}")
        self.plan = plan
        #: ``ResilientRunner``'s ``fault_hook`` for the resilience modes of
        #: ``train`` (a module-level callable, on every rank of a mesh): a
        #: test seam, kept out of ``train``'s signature, the reference's
        self._fault_hook = None
        self.cfg = plan.config()
        self.strategy = plan.build_strategy()
        self.runtime = FuturizedGraph(max_workers=max_workers,
                                      name=f"session:{plan.arch}")
        self.distributed = None
        #: rank processes of a mesh session (1: no mesh world); its ranks
        #: are the worker localities (a mesh with localities is refused)
        self.mesh_ranks = plan.data * plan.pod * plan.model
        #: ``serve``'s parameters on a mesh, as a host tree in the
        #: reference's layout (None: drawn from ``plan.seed``): a test
        #: seam, kept out of ``serve``'s signature, the reference's
        self._serve_params = None
        n = max(plan.localities, self.mesh_ranks)
        if n > 1 or plan.elastic:
            # workers get the checkpoint dir at spawn (PHYRAX_CKPT_DIR):
            # each locality creates it and writes its own shards there
            env = {"PHYRAX_CKPT_DIR": plan.ckpt_dir} if plan.ckpt_dir \
                else {}
            init_thread = None
            if plan.spmd or self.mesh_ranks > 1:
                env, init_thread = self._start_distributed(env, n)
            # dial-in joiners adopt the environment spawned workers get
            join_spec = {"env": dict(env)} if plan.elastic else None
            try:
                self.distributed = DistributedGraph(
                    localities=n, graph=self.runtime,
                    worker_env=env or None, name=f"session:{plan.arch}",
                    elastic=plan.elastic, elastic_port=plan.elastic_port,
                    join_spec=join_spec)
                if init_thread is not None:
                    self._join_world(init_thread)
            except BaseException:
                # a failed bring-up must not leave a world (or workers)
                # behind to poison the next session in this interpreter
                if self.distributed is not None:
                    self.distributed.shutdown(wait=False)
                self.runtime.shutdown(wait=False)
                _destroy_world()
                raise
        self._train_step = None
        self._serve_steps: dict[tuple, tuple] = {}
        self._closed = False

    def _start_distributed(self, env: dict, n: int):
        """World bring-up (SPMD mode, and a mesh session's rank
        processes): pick a loopback coordinator, put it in the workers'
        spawn environment, and start the driver's own join (rank 0 of
        ``n``) on a thread: it blocks until every process has joined, and
        the workers are spawned only by the ``DistributedGraph`` made
        next.  This process's ``os.environ`` stays untouched, so a later
        session in the same interpreter cannot inherit a stale
        coordinator."""
        from ..launch.mesh import free_port, maybe_init_distributed
        coord = f"127.0.0.1:{free_port()}"
        env = dict(env)
        env["PHYRAX_DIST_COORDINATOR"] = coord
        env["PHYRAX_DIST_NUM_PROCESSES"] = str(n)
        self._dist_init_error: list = []

        def init():
            try:
                maybe_init_distributed(process_id=0, num_processes=n,
                                       coordinator=coord)
            except BaseException as e:  # noqa: BLE001 - re-raised above
                self._dist_init_error.append(e)

        t = threading.Thread(target=init, daemon=True,
                             name="distributed-init")
        t.start()
        return env, t

    def _join_world(self, init_thread) -> None:
        init_thread.join(timeout=_DIST_INIT_TIMEOUT_S)
        if init_thread.is_alive():
            raise TimeoutError("torch.distributed.init_process_group did "
                               "not complete on the driver")
        if self._dist_init_error:
            raise self._dist_init_error[0]

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        """Run the shutdown barrier: drain distributed tasks, stop worker
        localities, then drain and stop the local runtime; in SPMD mode
        also leave the ``torch.distributed`` world.  Idempotent."""
        if not self._closed:
            self._closed = True
            try:
                if self.distributed is not None:
                    self.distributed.shutdown(wait=True)
                self.runtime.shutdown(wait=True)
            finally:
                if self.plan.spmd or self.mesh_ranks > 1:
                    _destroy_world()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self):
        """The session runtime's ``RuntimeStats``."""
        return self.runtime.stats()

    def lint(self, *, strict_lanes: bool = False):
        """Run the static phylint passes over this session's live graph.

        Snapshots every node the runtime still holds (in flight and
        recently retired) and applies the PHY001-PHY006 rule set
        (DESIGN.md §12).  Works for any locality count: unlike the dryrun
        mirrors in ``analysis.trace_builders``, this sees the
        promise/dispatch pairs a distributed run actually created.

        Returns:
            List of ``analysis.lint.Finding``, empty when clean.
        """
        from ..analysis import lint as lint_mod

        return lint_mod.lint(lint_mod.LintGraph.from_graph(self.runtime),
                             strict_lanes=strict_lanes)

    @property
    def join_address(self) -> Optional[tuple]:
        """``(host, port)`` a ``--join`` dialer should use, or None when
        the session is not elastic."""
        if self.distributed is None or not self.plan.elastic:
            return None
        return tuple(self.distributed.endpoint.address)

    def add_locality(self, timeout: float = 120.0) -> int:
        """Elastic scale-out (DESIGN.md §13): spawn one extra worker
        locality into the *running* session and block until it is a full
        member - peers gossiped, AGAS rebalanced, steal loop armed.  Safe
        to call from a training hook; later steerable host tasks may be
        stolen by (or diverted to) the newcomer.

        Returns:
            The new locality's rank.
        Raises:
            RuntimeError: the session was not compiled from an elastic
                plan.
        """
        if self.distributed is None or not self.plan.elastic:
            raise RuntimeError("add_locality needs Plan(elastic=True)")
        return self.distributed.add_locality(timeout=timeout)

    def kill_locality(self, rank: Optional[int] = None) -> Optional[int]:
        """Failure drill: SIGKILL a worker locality (the highest-ranked
        alive one by default).  Its in-flight tasks re-spawn elsewhere.

        Returns:
            The killed rank, or None when no worker locality is alive.
        """
        if self.distributed is None:
            return None
        alive = self.distributed.group.alive_workers()
        if not alive:
            return None
        rank = alive[-1] if rank is None else rank
        self.distributed.group.kill(rank)
        return rank

    def _stats_json(self, st) -> dict:
        out = st.to_json()
        if self.distributed is not None:
            out["distributed"] = self.distributed.stats()
        return out

    # -- steps --------------------------------------------------------------
    @property
    def train_step(self) -> steps_lib.TrainStep:
        if self._train_step is None:
            self._train_step = steps_lib.make_train_step(
                self.cfg, self.strategy, plan=self.plan)
        return self._train_step

    def _serve_steps_for(self, prompt_len: int, gen_len: int, slots: int):
        key = (prompt_len, gen_len, slots)
        if key not in self._serve_steps:
            cache_len = prompt_len + gen_len
            pre = steps_lib.make_prefill_step(
                self.cfg, {"seq_len": cache_len, "global_batch": slots,
                           "kind": "prefill"})
            dec = steps_lib.make_decode_step(
                self.cfg, {"seq_len": cache_len, "global_batch": slots,
                           "kind": "decode"})
            self._serve_steps[key] = (pre, dec)
        return self._serve_steps[key]

    # -- train --------------------------------------------------------------
    def _check_train(self, resilience, kill_locality_at_step) -> None:
        if self.plan.spmd and resilience != "none":
            raise ValueError("resilience modes are not mirrored by the "
                             "SPMD shadow loop; use resilience='none' "
                             "with Plan(spmd=True)")
        if self.plan.spmd and kill_locality_at_step is not None:
            raise ValueError(
                "kill_locality_at_step is a multi-locality drill: an SPMD "
                "world does not survive losing a process.  Drill SPMD host "
                "loss with fail_at_step + a resume run on a different "
                "process count instead")
        if resilience != "none":
            if self.plan.ddp:
                raise ValueError("resilience modes do not compose with "
                                 "Plan(ddp=True): the ring's abort-on-loss "
                                 "failure model replaces step replay")
            if resilience not in ("replay", "replicate"):
                raise ValueError(f"unknown resilience mode {resilience!r} "
                                 f"(none | replay | replicate)")

    def _stream(self, stream):
        if stream is not None:
            return stream
        return stream_for(self.cfg, batch=self.plan.batch,
                          seq=self.plan.seq, seed=self.plan.seed)

    def train(self, stream=None, *, steps: int = 50, hooks: Any = None,
              ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
              log_every: int = 5, resume: bool = False,
              fail_at_step: Optional[int] = None,
              kill_locality_at_step: Optional[int] = None,
              resilience: str = "none", verbose: bool = True) -> dict:
        """The training loop: stream -> prefetch nodes -> step -> in-flight
        pipeline, on the session runtime.  With ``plan.localities > 1``
        the prefetch *builds* run on worker localities and stream back;
        the device steps stay here, so the losses are the single-process
        run's.

        With ``plan.ddp=True`` each step is a fabric-DDP step instead:
        this process is rank 0 of the gradient ring and trains its own
        shard block, while ``ddp_train`` active messages start the same
        loop (``frontend.ddp.ddp_shadow_train``) on every worker
        locality; gradients go through the plan's codec every step, and
        the result gains ``grad_wire_bytes`` (the exact gradient payload
        bytes this process sent: 0 at one locality) and ``codec_bytes``.
        A failure anywhere poisons the ring (``ddp_abort``), so no
        locality hangs; checkpoints are driver-only, parameters being
        replicated.  The DDP loop logs inline, as the reference's
        ``_train_ddp`` does, so its tree has no ``log:`` nodes.

        With ``plan.spmd=True`` every worker locality runs this loop in
        lockstep (``frontend.spmd.shadow_train``, started by a
        ``spmd_train`` active message), each process building its own
        batches, and every save is written as each process's own
        segments (``checkpoint/spmd.py``): only manifest entries cross the
        wire.  The result then gains ``localities``: each worker's
        ``spmd_done`` report (``step``, ``final_loss``, ``launches``,
        ``diagnostics``).

        Args:
            stream: object with ``batch_at(step) -> dict`` of numpy
                arrays; defaults to the architecture's synthetic stream
                (``stream_for``).
            steps: total step count (absolute, not incremental).
            hooks: any object with optional ``on_step(it, metrics)``,
                ``on_log(it, loss)`` and ``on_checkpoint(step, future)``
                methods.
            ckpt_dir: checkpoint directory (defaults to ``plan.ckpt_dir``;
                empty disables snapshots).  ``(params, opt)`` is saved
                every ``ckpt_every`` steps, each save's write gated on the
                step's retirement, and once more after the last step
                unless the cadence saved it; saves already requested land
                even when the loop fails.  With ``localities > 1`` each
                save is split into locality-owned shards written by their
                owners, and a resume reads the shards on the current
                localities, whatever count wrote them (DESIGN.md §10);
                with ``ddp`` the driver saves alone (the parameters are
                replicated).  The onebit codec's
                error-feedback residual is not part of the state, as in
                the reference: a resumed onebit run restarts it at zero.
            ckpt_every: cadence in steps of the saves.
            resume: restore the latest checkpoint in ``ckpt_dir`` first
                and continue from its step (nothing runs if that is at or
                past ``steps``).
            log_every: cadence in steps of the logged losses.
            fail_at_step: drill seam - raise an injected node failure at
                this step (ignored under ``resume``).
            kill_locality_at_step: drill seam - SIGKILL a worker
                locality at this step.  Plain training survives by task
                re-spawn; a DDP run aborts with ``LocalityLostError``.  A
                no-op with one locality, as in the reference.
            resilience: ``"none"``, ``"replay"`` or ``"replicate"``
                (HPX-style step resilience, ``core.resilience``: the step
                runs as ``fn_nodonate`` from copies of its inputs, which
                doubles the train state's memory; a mesh agrees every
                verdict over its dp group).
            verbose: print progress and the final runtime report.
        Returns:
            dict with ``final_loss``, per-log ``losses``, ``params``,
            ``step`` (the last step run, or the resumed step when nothing
            ran) and ``runtime_stats`` (with ``distributed`` when
            ``localities > 1`` or elastic: dispatch counts, checkpoint
            leaf wire bytes, and ``joined_localities``,
            ``membership_gen``, ``stolen_tasks``, ``migrated_objects``).
        Raises:
            RuntimeError: the injected failure of ``fail_at_step``, or a
                worker's failed DDP loop or SPMD shadow loop.
            ValueError: ``resilience`` or ``kill_locality_at_step`` with
                ``spmd``.
            LocalityLostError: a locality died mid-all-reduce (DDP).
        """
        self._check_train(resilience, kill_locality_at_step)
        if self.mesh_ranks > 1:
            return self._train_mesh(
                stream, steps=steps, hooks=hooks, ckpt_dir=ckpt_dir,
                ckpt_every=ckpt_every, log_every=log_every, resume=resume,
                fail_at_step=fail_at_step, resilience=resilience,
                verbose=verbose)
        plan, runtime, dev = self.plan, self.runtime, self.device
        dist = self.distributed
        if ckpt_dir is None:
            ckpt_dir = plan.ckpt_dir
        stream = self._stream(stream)
        engine = None
        if plan.ddp:
            ring = dist.grad_ring if dist is not None \
                else RingAllReduce(None, 1)
            engine = DDPEngine(plan, ring)
            params, opt = engine.init()
            step_fn = engine.train_step
            # no device: the engine slices its shards from the host batch
            prefetch = Prefetcher(stream, None, graph=runtime)
        else:
            step = self.train_step
            params, opt = step.init(
                torch.Generator(device=dev).manual_seed(plan.seed), dev)
            runner = ResilientRunner(step.fn_nodonate,
                                     fault_hook=self._fault_hook)
            step.copy_stats.update(calls=0, bytes=0, seconds=0.0)

            def step_fn(it, batch, params, opt):
                if resilience == "replay":
                    return runner.replay(params, opt, batch)
                if resilience == "replicate":
                    return runner.replicate(params, opt, batch, n=2)
                return step.fn(params, opt, batch)
            # SPMD mode builds every batch locally on each process
            prefetch = Prefetcher(stream, dev, graph=runtime,
                                  dgraph=None if plan.spmd else dist)
        start = 0
        # DDP checkpoints are the driver's alone: its replica IS the state
        ckpt = (CheckpointManager(ckpt_dir, keep=3, graph=runtime,
                                  dgraph=None if plan.ddp else dist)
                if ckpt_dir else None)
        # the train step's state is saved and restored in the reference's
        # global layout (zero1's and onebit's differ from theirs in memory)
        if engine is None:
            def state(params, opt):
                return params, step.gather_opt(opt)
        else:
            def state(params, opt):
                return params, opt
        if ckpt is not None and resume and ckpt.latest_step() is not None:
            if engine is None:
                start, (params, og) = ckpt.restore(
                    (params, step.global_like()))
                opt = step.shard_opt(og, dev)
            else:
                start, (params, opt) = ckpt.restore((params, opt))
            if verbose:
                print(f"[train] resumed from step {start}")
        if engine is not None and dist is not None:
            dist.ddp_train({"plan": plan, "steps": steps,
                            "ckpt_dir": ckpt_dir, "resume": resume,
                            "stream": stream, "gen": engine.ring.gen})
        if plan.spmd:
            # every worker mirrors this loop in lockstep and writes its
            # own checkpoint segments (DESIGN.md §10)
            dist.spmd_train({"plan": plan, "steps": steps,
                             "ckpt_every": ckpt_every, "ckpt_dir": ckpt_dir,
                             "resume": resume, "stream": stream,
                             "num_threads": torch.get_num_threads()})
        inflight = Pipeline(depth=2)
        logs: list = []        # losses (DDP) or their log: nodes
        t_log = time.time()
        on_step = getattr(hooks, "on_step", None)
        on_log = getattr(hooks, "on_log", None)
        on_ckpt = getattr(hooks, "on_checkpoint", None)

        def _force_and_log(it, m, t_start):
            # Runs on a runtime worker: forcing metrics never stalls dispatch.
            loss = float(m["loss"])
            dt = (time.time() - t_start) / log_every
            if verbose:
                print(f"[train] step {it + 1:5d} loss {loss:8.4f} "
                      f"gnorm {float(m['grad_norm']):8.3f} "
                      f"{dt * 1e3:8.1f} ms/step", flush=True)
            if on_log is not None:
                on_log(it, loss)
            return loss

        metrics = None
        try:
            for it in range(start, steps):
                if kill_locality_at_step is not None \
                        and it == kill_locality_at_step:
                    killed = self.kill_locality()
                    if verbose and killed is not None:
                        print(f"[train] drill: killed locality {killed} "
                              f"at step {it}", flush=True)
                batch = prefetch.get(it)
                if fail_at_step is not None and it == fail_at_step \
                        and not resume:
                    raise RuntimeError(f"injected node failure at step {it}")
                metrics, params, opt = step_fn(it, batch, params, opt)
                inflight.push(it, metrics)
                if on_step is not None:
                    on_step(it, metrics)
                if (it + 1) % log_every == 0:
                    if engine is not None:
                        # DDP logs inline, as the reference's _train_ddp
                        logs.append(_force_and_log(it, metrics, t_log))
                    else:
                        # CHECKPOINT lane: forcing metrics for logs must
                        # never outrank the PREFETCH nodes the loop blocks
                        # on next
                        logs.append(runtime.defer(
                            _force_and_log, it, metrics, t_log,
                            lane=Lane.CHECKPOINT, name=f"log:{it}"))
                    t_log = time.time()
                if ckpt is not None and (it + 1) % ckpt_every == 0:
                    # the write node depends on step retirement: file I/O
                    # starts only after the step's outputs resolve
                    retired = runtime.defer(block_until_ready, metrics,
                                            lane=Lane.CHECKPOINT,
                                            name=f"retire:{it}")
                    fut = ckpt.save(it + 1, state(params, opt),
                                    deps=(retired,), meta={"arch": plan.arch})
                    if on_ckpt is not None:
                        on_ckpt(it + 1, fut)
            inflight.drain()
            # the final snapshot, unless the cadence saved this step or
            # nothing ran
            if ckpt is not None and steps % ckpt_every != 0 \
                    and metrics is not None:
                ckpt.save(steps, state(params, opt),
                          meta={"arch": plan.arch})
        except BaseException:
            if engine is not None and dist is not None:
                # poison the ring everywhere: workers blocked in an
                # all-reduce must abort, not wait out their timeout
                dist.ddp_abort("the driver aborted the DDP run")
            raise
        finally:
            # shutdown barrier, also on the injected-failure path, so a
            # crash never loses a save that was already requested: retire
            # in-flight steps, land every pending checkpoint node; the
            # runtime itself belongs to the session
            inflight.drain()
            prefetch.close()
            if ckpt is not None:
                ckpt.close()
            runtime.barrier()
            if engine is not None:
                engine.ring.deactivate()

        if engine is not None and dist is not None:
            done = dist.wait_ddp_done(timeout=600.0)
            failed = [m for m in done.values() if not m.get("ok")]
            if failed:
                raise RuntimeError(
                    f"DDP train loop failed on locality "
                    f"{failed[0]['rank']}: {failed[0].get('error')}")
        if plan.spmd:
            # the shadows posted every entry this run's saves needed
            # (ckpt.close() waited on the commits); now surface a shadow
            # that FAILED - its saves were aborted
            done = dist.wait_spmd_done(timeout=600.0)
            failed = [m for m in done.values() if not m.get("ok")]
            if failed:
                raise RuntimeError(
                    f"SPMD shadow train loop failed on locality "
                    f"{failed[0]['rank']}: {failed[0].get('error')}")
        losses = logs if engine is not None \
            else [f.result() for f in logs]
        st = runtime.stats()
        final = float(metrics["loss"]) if metrics is not None \
            else float("nan")
        out = {"final_loss": final, "losses": losses, "params": params,
               "step": steps if metrics is not None else start,
               "runtime_stats": self._stats_json(st)}
        if verbose:
            if metrics is None:    # resumed at/after steps: nothing left
                print(f"[train] nothing to do: resumed at step {start} "
                      f">= steps {steps}")
            else:
                print(f"[train] done: final loss {final:.4f} "
                      f"(host tasks {st.completed}, "
                      f"max in-flight {st.max_in_flight}, device {dev})")
        if resilience != "none":
            out["resilience"] = dict(runner.stats,
                                     copies=dict(step.copy_stats))
        if engine is not None:
            out["grad_wire_bytes"] = int(engine.ring.wire_bytes)
            out["codec_bytes"] = engine.codec_bytes
            if dist is not None:
                out["localities"] = {r: {k: m.get(k) for k in (
                    "grad_wire_bytes", "final_loss", "launches")}
                    for r, m in sorted(done.items())}
            if verbose:
                print(f"[train] ddp world {engine.world}, shards "
                      f"{engine.shards}: grad-wire {out['grad_wire_bytes']}B "
                      f"({plan.grad_codec} codec, {engine.codec_bytes}B/"
                      f"locality/exchange)")
        if plan.spmd:
            out["localities"] = {r: {k: m.get(k) for k in (
                "step", "final_loss", "launches", "diagnostics")}
                for r, m in sorted(done.items())}
        if verbose and dist is not None:
            d = out["runtime_stats"]["distributed"]
            print(f"[train] localities: dispatched {d['dispatched']} "
                  f"respawned {d['respawned']} wire {d['bytes_sent']}B out "
                  f"/ {d['bytes_recv']}B in ckpt-leaf-wire "
                  f"{d['ckpt_leaf_wire_bytes']}B")
            if ckpt is not None and ckpt.aborted_saves:
                print(f"[train] WARNING: {ckpt.aborted_saves} SPMD save(s) "
                      f"aborted with a lost writer; the last committed "
                      f"checkpoint is step {ckpt.latest_step()}")
            if plan.elastic:
                print(f"[train] elastic: joined {d['joined_localities']} "
                      f"stolen {d['stolen_tasks']} migrated "
                      f"{d['migrated_objects']} objects (membership gen "
                      f"{d['membership_gen']})")
        return out

    def run_ranks(self, loop, spec: dict, *, driver=None) -> dict:
        """Run ``loop(spec, endpoint=None, driver=None)`` on every rank of
        this mesh session in lockstep: each worker locality through the
        ``spmd_train`` protocol, this process as rank 0 with ``driver``.
        ``loop`` is a module-level function (it ships by reference).

        Returns:
            ``{rank: result}``, rank 0's as ``loop`` returned it, the
            workers' as posted (with ``rank`` and ``ok``).
        Raises:
            RuntimeError: a session without a mesh world, or a worker's
                loop failed (after rank 0's own exception, if it raised:
                the workers raise an injected failure at the same step,
                and after a failure of rank 0 alone they fail at their dp
                group's timeout).
        """
        if self.mesh_ranks <= 1:
            raise RuntimeError("run_ranks needs a mesh session "
                               "(Plan(data=..., model=...) with data * pod "
                               "* model > 1)")
        dist = self.distributed
        dist.spmd_train(dict(spec, loop=loop))
        try:
            mine = loop(spec, driver=driver)
        except BaseException:
            try:
                dist.wait_spmd_done(timeout=30.0)
            except TimeoutError:
                pass
            raise
        done = dist.wait_spmd_done(timeout=600.0)
        failed = [m for m in done.values() if not m.get("ok")]
        if failed:
            raise RuntimeError(f"mesh loop failed on rank "
                               f"{failed[0]['rank']}: "
                               f"{failed[0].get('error')}")
        return {0: mine, **done}

    def _train_mesh(self, stream, *, steps, hooks, ckpt_dir, ckpt_every,
                    log_every, resume, fail_at_step, resilience,
                    verbose) -> dict:
        """``train`` on a mesh session: this process runs
        ``frontend.mesh.rank_train`` as rank 0 (logging, hooks and the
        checkpoint writes), every worker locality the same loop, started
        by a ``spmd_train`` post.  A resume restores the driver's latest
        checkpoint on every rank.  The result gains ``localities`` (each
        worker's report: ``step``, ``final_loss``, ``launches``, ``wire``,
        ``resilience``, ``peak_bytes``) and this rank's ``wire``,
        ``resilience`` and ``peak_bytes``."""
        plan, runtime, dist = self.plan, self.runtime, self.distributed
        if ckpt_dir is None:
            ckpt_dir = plan.ckpt_dir
        stream = self._stream(stream)
        ckpt = (CheckpointManager(ckpt_dir, keep=3, graph=runtime,
                                  spmd=False) if ckpt_dir else None)
        start = (ckpt.latest_step() or 0) if (ckpt is not None and resume) \
            else 0
        if verbose and start:
            print(f"[train] resumed from step {start}")
        spec = {"plan": plan, "steps": steps, "start": start,
                "ckpt_dir": ckpt_dir, "ckpt_every": ckpt_every,
                "fail_at_step": None if resume else fail_at_step,
                "resilience": resilience, "fault_hook": self._fault_hook,
                "stream": stream, "num_threads": torch.get_num_threads()}
        driver = _MeshDriver(runtime, ckpt, hooks, log_every, verbose,
                             plan.arch)
        try:
            done = self.run_ranks(rank_train, spec, driver=driver)
        finally:
            if ckpt is not None:
                ckpt.close()
            runtime.barrier()
        mine = done.pop(0)
        out = {"final_loss": mine["final_loss"], "losses": driver.losses,
               "params": mine["params"],
               "step": steps if steps > start else start,
               "runtime_stats": self._stats_json(runtime.stats()),
               "localities": {r: {k: m.get(k) for k in (
                   "step", "final_loss", "launches", "wire", "resilience",
                   "peak_bytes")} for r, m in sorted(done.items())}}
        for k in ("wire", "resilience", "peak_bytes", "launches"):
            out[k] = mine[k]
        if verbose:
            w = mine["wire"]
            print(f"[train] mesh of {self.mesh_ranks} ranks "
                  f"({self.strategy.name}): final loss "
                  f"{out['final_loss']:.4f}; rank 0 wire {w['bytes']}B in "
                  f"{w['calls']} collectives, {w['wire_s']:.3f}s in gloo, "
                  f"staging {w['staging_s']:.3f}s")
        return out

    # -- serve --------------------------------------------------------------
    def serve(self, requests: int = 8, *, prompt_len: int = 32,
              gen_len: int = 16, slots: int = 4, prompts=None,
              verbose: bool = True) -> dict:
        """Batched prefill + greedy decode with slot refill, as a futurized
        tree: each wave is a ``prefill`` node plus ``gen_len`` chained
        ``decode`` nodes (dependency edges carry the (token, cache) pair),
        while the next wave's host prep runs as a PREFETCH node - its
        stacking on a worker locality when ``plan.localities > 1``, with
        placement and device work staying here.

        Args:
            requests: request count when ``prompts`` is None (otherwise
                ``len(prompts)`` wins).
            prompt_len: tokens per prompt (synthetic prompts only).
            gen_len: decode steps per request.
            slots: decode slots per wave (idle slots are padded).
            prompts: optional list of int32 token arrays.
            verbose: print the throughput summary line.
        Returns:
            dict with the JAX package's keys - ``tokens_per_s``,
            ``requests``, ``tokens``, ``padded_tokens``, the traced node
            ``nodes``/``trace`` and ``runtime_stats`` - plus ``waves``,
            ``generated`` (per wave, the ``[slots, gen_len + 1]`` greedy
            tokens on the CPU, padded slots included) and
            ``first_prefill_logits`` (wave 0's ``[slots, vocab]`` prefill
            logits on the CPU).
        """
        if self.mesh_ranks > 1:
            return self._serve_mesh(requests, prompt_len=prompt_len,
                                    gen_len=gen_len, slots=slots,
                                    prompts=prompts, verbose=verbose)
        plan, runtime, cfg, dev = self.plan, self.runtime, self.cfg, self.device
        pre, dec = self._serve_steps_for(prompt_len, gen_len, slots)
        params = init_params(
            pre.specs, torch.Generator(device=dev).manual_seed(plan.seed), dev)

        if prompts is None:
            rng = np.random.default_rng(plan.seed)
            prompts = [rng.integers(0, cfg.vocab,
                                    prompt_len).astype(np.int32)
                       for _ in range(requests)]
        waiting = list(prompts)
        requests = len(waiting)
        if not waiting:        # nothing to serve: no dummy wave, no tokens
            return {"tokens_per_s": 0.0, "requests": 0, "tokens": 0,
                    "padded_tokens": 0, "nodes": [], "trace": [],
                    "runtime_stats": self.runtime.stats().to_json(),
                    "waves": 0, "generated": [], "first_prefill_logits": None}

        def prepare_wave(wave) -> dict:
            # wave: list of prompt arrays, or the already-stacked ndarray
            # a worker locality streamed back (np.stack handles both)
            toks = torch.from_numpy(np.stack(wave)).to(dev, torch.int64)
            batch = {"tokens": toks}
            if cfg.family == "encdec":
                # the stub audio frontend's frames, as in the reference
                batch["frames"] = torch.zeros(
                    (slots, cfg.enc_frames, cfg.d_model), dtype=cfg.c_dtype,
                    device=dev)
            return batch

        def defer_wave(wave, w: int):
            if self.distributed is not None:
                wave = self.distributed.defer(
                    _stack_wave, wave, lane=Lane.PREFETCH,
                    name=f"stack:{w}")
            return runtime.defer(prepare_wave, wave, lane=Lane.PREFETCH,
                                 name=f"wave:{w}")

        def take_wave() -> tuple[list, int]:
            wave = [waiting.pop() for _ in range(min(slots, len(waiting)))]
            n_real = len(wave)
            while len(wave) < slots:            # pad idle slots
                wave.append(np.zeros(prompt_len, np.int32))
            return wave, n_real

        padded_out = 0
        generated: list[torch.Tensor] = []     # per wave, in wave order
        first_logits: list[torch.Tensor] = []

        def _prefill(batch, *_prev_tail):
            # *_prev_tail: dispatch-order edge from the previous wave's last
            # decode node; its value is unused
            logits, cache = pre.fn(params, batch)
            if not first_logits:
                first_logits.append(logits)
            tok = logits.argmax(-1)[:, None]
            out = torch.empty((slots, gen_len + 1), dtype=torch.int64,
                              device=dev)
            out[:, 0] = tok[:, 0]
            generated.append(out)
            return tok, cache, out

        def _decode(carry, pos):
            tok, cache, out = carry
            logits, cache = dec.fn(params, cache, {"tokens": tok}, pos)
            tok = logits.argmax(-1)[:, None]
            out[:, pos - prompt_len + 1] = tok[:, 0]
            return tok, cache, out

        tracer = Trace(runtime)
        remove = runtime.add_trace_hook(tracer.record)
        done, tokens_out, w = 0, 0, 0
        t0 = time.perf_counter()
        try:
            wave, n_real = take_wave()
            batch_fut = defer_wave(wave, 0)
            tail = None
            while True:
                nxt = None
                if waiting and done + n_real < requests:
                    next_wave, next_real = take_wave()
                    nxt = (defer_wave(next_wave, w + 1), next_real)
                # The wave's futurized tree, built up-front: nothing below
                # waits for the device, so prefill and every decode step
                # stay queued back-to-back on the stream.
                deps = (batch_fut,) if tail is None else (batch_fut, tail)
                carry = runtime.defer(_prefill, *deps, name=f"prefill:w{w}")
                for t in range(gen_len):
                    carry = runtime.defer(_decode, carry, prompt_len + t,
                                          name=f"decode:w{w}:t{t}")
                tail = carry
                # padded idle slots decode too, but their tokens are not
                # throughput: account them separately
                tokens_out += n_real * gen_len
                padded_out += (slots - n_real) * gen_len
                runtime.record_serve(
                    real_tokens=n_real * gen_len,
                    padded_slot_tokens=(slots - n_real) * gen_len)
                done += n_real
                if nxt is None:
                    break
                batch_fut, n_real = nxt
                w += 1
            tail.result()
            if dev.type == "cuda":            # honest timing: retire it all
                torch.cuda.synchronize(dev)
        finally:
            remove()
        dt = time.perf_counter() - t0
        tps = tokens_out / dt
        st = runtime.stats()
        nodes = tracer.names()
        n_decode = sum(n.startswith("decode:") for n in nodes)
        if verbose:
            print(f"[serve] {requests} requests, {tokens_out} tokens in "
                  f"{dt:.2f}s -> {tps:.1f} tok/s (slots={slots}, "
                  f"padded {padded_out}, decode nodes {n_decode}, "
                  f"host tasks {st.completed}, device {dev})")
        return {"tokens_per_s": tps, "requests": requests,
                "tokens": tokens_out, "padded_tokens": padded_out,
                "nodes": nodes, "trace": tracer.signature(),
                "runtime_stats": self._stats_json(st), "waves": w + 1,
                "generated": [g.cpu() for g in generated],
                "first_prefill_logits": first_logits[0].float().cpu()}

    def _serve_mesh(self, requests, *, prompt_len, gen_len, slots, prompts,
                    verbose) -> dict:
        """``serve`` on a mesh: every rank runs ``frontend.mesh.rank_serve``
        on the same requests, each dp rank on its rows; the result is rank
        0's (every row's tokens), with each worker's ``launches``,
        ``wire``, ``peak_bytes``, ``tokens`` and ``cache_shapes`` under
        ``localities``."""
        spec = {"plan": self.plan, "requests": requests,
                "prompt_len": prompt_len, "gen_len": gen_len, "slots": slots,
                "prompts": prompts, "params": self._serve_params,
                "num_threads": torch.get_num_threads()}
        done = self.run_ranks(rank_serve, spec)
        out = done.pop(0)
        out["localities"] = {r: {k: m.get(k) for k in (
            "launches", "wire", "peak_bytes", "tokens", "cache_shapes")}
            for r, m in sorted(done.items())}
        # the session's serve counters, as the one-process loop keeps them
        self.runtime.record_serve(real_tokens=out["tokens"],
                                  padded_slot_tokens=out["padded_tokens"])
        out["runtime_stats"] = self._stats_json(self.runtime.stats())
        if verbose:
            w = out["wire"]
            n_decode = sum(n.startswith("decode:") for n in out["nodes"])
            print(f"[serve] mesh of {self.mesh_ranks} ranks: {out['requests']}"
                  f" requests, {out['tokens']} tokens -> "
                  f"{out['tokens_per_s']:.1f} tok/s (slots={slots}, padded "
                  f"{out['padded_tokens']}, decode nodes {n_decode}); rank 0 "
                  f"wire {w['bytes']}B in {w['calls']} collectives, "
                  f"{w['wire_s']:.3f}s in gloo")
        return out

    # -- serve (gateway) -----------------------------------------------------
    def serve_stream(self, requests: int = 8, *, prompt_len: int = 32,
                     gen_len: int = 16, slots: int = 4,
                     max_inflight: Optional[int] = None,
                     deadline_ms: Optional[float] = None,
                     trace=None, queue=None, page_bytes: int = 1 << 16,
                     replicas: Optional[int] = None,
                     kill_replica_at_round: Optional[tuple] = None,
                     verbose: bool = True) -> dict:
        """The serving gateway (``frontend/gateway.py``): async continuous
        batching with mid-flight arrivals, admission control and the paged
        inference cache, instead of ``serve``'s synchronized waves.

        Each request is a node chain (``stack`` -> ``prefill`` ->
        ``refill``/``decode``/``emit`` -> ``finish`` resolving its
        ``request:{rid}`` promise); prefill runs once at admission and its
        decode state parks in ``core.paging.InferenceCache`` pages on the
        host until a slot frees, so slot refill never recomputes prefill.
        At ``localities > 1`` each replica is homed on a locality (its
        requests' ``stack`` prep runs there) and a replica whose home dies
        is retired, its requests absorbed by the survivors.  On a mesh
        session the gateway runs here, as rank 0, and every other rank
        runs its device bodies on its blocks in the order it sends them
        (``frontend/mesh.rank_serve_stream``); the streams, statuses and
        counters are the reference's on the same mesh.

        Args:
            requests: synthetic request count when neither ``trace`` nor
                ``queue`` is given (all arriving at round 0).
            prompt_len, gen_len, slots: as for ``serve``.
            max_inflight: admission cap on requests holding resources
                (queued + decoding); defaults to ``2 * slots * replicas``.
            deadline_ms: default per-request deadline; a request still
                short of a slot when it lapses expires cleanly.
            trace: deterministic arrival script - a list of dicts with
                optional ``prompt``, ``at_round`` (decode round of
                arrival), ``deadline_ms``, ``cancel_after`` (cancel after
                that many decoded tokens), ``inject``
                (``"poison-prefill"``).
            queue: a live ``gateway.RequestQueue`` fed from other
                threads; the gateway drains it until ``close()``.
            page_bytes: page size of the inference cache pool (shared
                across replicas; each replica owns a named cache on it).
            replicas: model replica count (defaults to ``plan.replicas``);
                each replica gets its own ``slots``-wide decode chain and
                per-request streams are bit-identical to ``replicas=1``.
            kill_replica_at_round: the replica-death drill,
                ``(replica_idx, round)``: that replica dies at that decode
                round and the survivors absorb its requests.
            verbose: print the summary line.
        Returns:
            dict with per-request ``streams``/``handles``, admission
            counts, ``tokens``/``padded_tokens``/``tokens_per_s``, the
            traced ``nodes``/``trace``, ``cache``, ``rounds``, ``epochs``,
            ``replicas``/``replica_assignments`` and ``runtime_stats``
            (including the ``serve``/``serve_replicas`` counters and
            ``request_latency_hist``, and ``distributed`` at
            ``localities > 1``); on a mesh also ``launches``, ``wire``,
            ``commands`` (sent to the other ranks), ``request_bytes`` (one
            request's parked state on this rank) and ``localities`` (each
            other rank's, with its page ``cache`` counters).
        Raises:
            ValueError: an encoder-decoder architecture.
        """
        plan, runtime, cfg, dev = self.plan, self.runtime, self.cfg, self.device
        n_replicas = plan.replicas if replicas is None else int(replicas)
        if cfg.family == "encdec":
            raise ValueError("serve_stream does not support encdec "
                             "architectures (scalar-only decoder position "
                             "embedding); use serve()")
        if queue is None:
            q = RequestQueue()
            entries = trace if trace is not None \
                else [{"at_round": 0} for _ in range(requests)]
            rng = np.random.default_rng(plan.seed)
            for e in entries:
                prompt = e.get("prompt")
                if prompt is None:
                    prompt = rng.integers(0, cfg.vocab,
                                          prompt_len).astype(np.int32)
                q.submit(prompt, at_round=e.get("at_round", 0),
                         deadline_ms=e.get("deadline_ms", deadline_ms),
                         cancel_after=e.get("cancel_after"),
                         inject=e.get("inject"))
            q.close()
        else:
            q = queue

        def run(pre1, dec, params, lockstep=None) -> dict:
            # the gateway over one process's steps, or rank 0's of a mesh
            # (its device bodies sent to the other ranks by ``lockstep``;
            # a mesh's ranks are not localities to home replicas on)
            gw = Gateway(runtime, distributed=None if lockstep is not None
                         else self.distributed, prefill_step=pre1,
                         decode_step=dec, params=params,
                         prompt_len=prompt_len, gen_len=gen_len, slots=slots,
                         device=dev, max_inflight=max_inflight,
                         deadline_ms=deadline_ms, page_bytes=page_bytes,
                         replicas=n_replicas,
                         kill_replica_at_round=kill_replica_at_round,
                         lockstep=lockstep)
            self._gateway = gw      # drill seam: tests call kill_replica()
            tracer = Trace(runtime)
            remove = runtime.add_trace_hook(tracer.record)
            t0 = time.perf_counter()
            try:
                out = gw.run(q)
                if dev.type == "cuda":        # honest timing: retire it all
                    torch.cuda.synchronize(dev)
            finally:
                remove()
            out["seconds"] = time.perf_counter() - t0
            out["nodes"], out["trace"] = tracer.names(), tracer.signature()
            return out

        if self.mesh_ranks > 1:
            spec = {"plan": plan, "prompt_len": prompt_len,
                    "gen_len": gen_len, "slots": slots,
                    "page_bytes": page_bytes, "params": self._serve_params,
                    "num_threads": torch.get_num_threads()}
            done = self.run_ranks(rank_serve_stream, spec, driver=run)
            out = done.pop(0)
            out["localities"] = {r: {k: m.get(k) for k in (
                "launches", "wire", "cache", "commands", "request_bytes")}
                for r, m in sorted(done.items())}
        else:
            pre1 = self._serve_steps_for(prompt_len, gen_len, 1)[0]
            dec = self._serve_steps_for(prompt_len, gen_len, slots)[1]
            params = init_params(
                pre1.specs, torch.Generator(device=dev).manual_seed(
                    plan.seed), dev)
            out = run(pre1, dec, params)
        dt = out.pop("seconds")
        tokens = sum(max(0, len(h.tokens) - 1) for h in out["handles"])
        st = runtime.stats()
        out.update({
            "requests": q.submitted, "tokens": tokens,
            "padded_tokens": st.serve.get("padded_slot_tokens", 0),
            "tokens_per_s": tokens / dt if dt > 0 else 0.0,
            "runtime_stats": self._stats_json(st),
        })
        if verbose:
            rep_note = (f" across {n_replicas} replicas"
                        if n_replicas > 1 else "")
            mesh_note = (f" on a mesh of {self.mesh_ranks} ranks"
                         if self.mesh_ranks > 1 else "")
            print(f"[gateway] {q.submitted} requests{rep_note}{mesh_note} "
                  f"({out['completed']} done, {out['cancelled']} "
                  f"cancelled, {out['expired']} expired, "
                  f"{out['failed']} failed, {out['rejected']} rejected), "
                  f"{tokens} tokens in {dt:.2f}s -> "
                  f"{out['tokens_per_s']:.1f} tok/s over {out['epochs']} "
                  f"epochs (page hits {st.serve.get('page_hits', 0)}/"
                  f"{st.serve.get('refills', 0)} refills, device {dev})")
        return out


class _MeshDriver:
    """Rank 0's side of a mesh run (``frontend.mesh.rank_train``'s
    ``driver``): the logged losses, the hooks, and the checkpoint writes
    on the session runtime, each gated on its step's retirement."""

    def __init__(self, runtime, ckpt, hooks, log_every: int, verbose: bool,
                 arch: str):
        self.runtime, self.ckpt = runtime, ckpt
        self.log_every, self.verbose, self.arch = log_every, verbose, arch
        self.on_step_hook = getattr(hooks, "on_step", None)
        self.on_log = getattr(hooks, "on_log", None)
        self.on_ckpt = getattr(hooks, "on_checkpoint", None)
        self.losses: list = []
        self.t_log = time.time()

    def on_step(self, it: int, metrics) -> None:
        if self.on_step_hook is not None:
            self.on_step_hook(it, metrics)
        if (it + 1) % self.log_every == 0:
            loss = float(metrics["loss"])
            if self.verbose:
                dt = (time.time() - self.t_log) / self.log_every
                print(f"[train] step {it + 1:5d} loss {loss:8.4f} gnorm "
                      f"{float(metrics['grad_norm']):8.3f} "
                      f"{dt * 1e3:8.1f} ms/step", flush=True)
            if self.on_log is not None:
                self.on_log(it, loss)
            self.losses.append(loss)
            self.t_log = time.time()

    def save(self, step: int, state, metrics) -> None:
        retired = self.runtime.defer(block_until_ready, metrics,
                                     lane=Lane.CHECKPOINT,
                                     name=f"retire:{step - 1}")
        fut = self.ckpt.save(step, state, deps=(retired,),
                             meta={"arch": self.arch})
        if self.on_ckpt is not None:
            self.on_ckpt(step, fut)
