"""Plan/Session: the declarative frontend over the futurized runtime.

Counterpart: ``repro/frontend/plan.py`` (``Plan``, and ``Session``'s
``__init__``, ``close``, ``stats``, ``train_step``, ``train`` with
``_train_ddp`` folded into it, ``_serve_steps_for``, ``serve`` and
``serve_stream``).  A
``Plan`` is the *what* of a run, a frozen value that touches no device state;
``plan.compile()`` builds a ``Session`` that owns ONE futurized runtime
(``core/futures.py``) for every host-side task of the session.

``Plan`` has the JAX package's fields plus ``device``, which is ``"cuda"``
unless the caller asks for ``"cpu"``: a CUDA plan on a machine without a
GPU raises, it never carries on on the CPU.  The port trains and serves
on one device, in one process: ``Session.train`` runs the single-device
loop and, with ``ddp=True`` at ``localities=1``, world-1 fabric DDP with
the ``fp32`` or ``onebit`` gradient codec, each with checkpoints and
resume (``checkpoint/``); ``serve_stream`` runs the serving gateway with
every model replica in this process.  Plans that need more (localities,
SPMD, elastic membership, mesh axes) raise ``NotImplementedError`` naming
the ROADMAP item that brings them; so does step resilience (item 14) in
``train``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..configs import get_config
from ..core import steps as steps_lib
from ..core.futures import FuturizedGraph, Lane, Pipeline, block_until_ready
from ..core.sharding import init_params
from ..data.pipeline import Prefetcher, stream_for
from ..distrib.collectives import CODECS, RingAllReduce
from .ddp import DDPEngine
from .futurize import Trace
from .gateway import Gateway, RequestQueue

__all__ = ["Plan", "Session"]


@dataclasses.dataclass(frozen=True)
class Plan:
    """Declarative run description: arch + mesh axes + strategy + shapes.

    The fields are those of ``repro.frontend.Plan`` (see its docstring);
    the port runs the single-device, single-process subset of them.

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


def _unsupported(plan: Plan) -> Optional[str]:
    if plan.localities > 1:
        return "localities > 1 (the multi-locality runtime, ROADMAP item 12)"
    if plan.spmd:
        return "spmd=True (SPMD mode, ROADMAP item 13)"
    if plan.elastic:
        return "elastic=True (elastic membership, ROADMAP item 13)"
    if plan.mesh != "local" or plan.data * plan.model * plan.pod != 1:
        return "mesh axes (mesh-parallel strategies, ROADMAP item 14)"
    if plan.shape is not None:
        return "named shapes (dryrun, ROADMAP item 15)"
    return None


class Session:
    """Compiled form of a ``Plan``: the device, lazily built serve steps,
    and one futurized runtime for every host-side task.  Use as a context
    manager (or call ``close()``) to run the shutdown barrier."""

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
        missing = _unsupported(plan)
        if missing is not None:
            raise NotImplementedError(f"the port does not run {missing} yet")
        if plan.ddp and plan.grad_codec not in CODECS:
            raise ValueError(f"unknown grad_codec {plan.grad_codec!r} "
                             f"(have: {sorted(CODECS)})")
        self.plan = plan
        self.cfg = plan.config()
        self.strategy = plan.build_strategy()
        self.runtime = FuturizedGraph(max_workers=max_workers,
                                      name=f"session:{plan.arch}")
        self._train_step = None
        self._serve_steps: dict[tuple, tuple] = {}
        self._closed = False

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        """Run the shutdown barrier: drain and stop the runtime.
        Idempotent."""
        if not self._closed:
            self._closed = True
            self.runtime.shutdown(wait=True)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self):
        """The session runtime's ``RuntimeStats``."""
        return self.runtime.stats()

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
    def _check_train(self, resilience) -> None:
        if resilience != "none":
            if self.plan.ddp:
                raise ValueError("resilience modes do not compose with "
                                 "Plan(ddp=True): the ring's abort-on-loss "
                                 "failure model replaces step replay")
            raise NotImplementedError(
                f"resilience={resilience!r} (step replay and replication, "
                f"ROADMAP item 14)")

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
        pipeline, on the session runtime.  With ``plan.ddp=True`` each step
        is a world-1 fabric-DDP step instead (this process is rank 0 of a
        world-1 ring and trains every shard): gradients go through the
        plan's codec every step, and the result gains ``grad_wire_bytes``
        (0 at world 1: nothing is posted) and ``codec_bytes``.

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
                even when the loop fails.  The onebit codec's
                error-feedback residual is not part of the state, as in
                the reference: a resumed onebit run restarts it at zero.
            ckpt_every: cadence in steps of the saves.
            resume: restore the latest checkpoint in ``ckpt_dir`` first
                and continue from its step (nothing runs if that is at or
                past ``steps``).
            log_every: cadence in steps of the logged losses.
            fail_at_step: drill seam - raise an injected node failure at
                this step (ignored under ``resume``).
            kill_locality_at_step: drill seam of the multi-locality
                runtime; a no-op with one locality, as in the reference.
            resilience: ``"none"``; other modes raise
                ``NotImplementedError`` (ROADMAP item 14).
            verbose: print progress and the final runtime report.
        Returns:
            dict with ``final_loss``, per-log ``losses``, ``params``,
            ``step`` (the last step run, or the resumed step when nothing
            ran) and ``runtime_stats``.
        Raises:
            RuntimeError: the injected failure of ``fail_at_step``.
        """
        self._check_train(resilience)
        plan, runtime, dev = self.plan, self.runtime, self.device
        if ckpt_dir is None:
            ckpt_dir = plan.ckpt_dir
        stream = self._stream(stream)
        engine = None
        if plan.ddp:
            engine = DDPEngine(plan, RingAllReduce(None, 1))
            params, opt = engine.init()
            step_fn = engine.train_step
            # no device: the engine slices its shards from the host batch
            prefetch = Prefetcher(stream, None, graph=runtime)
        else:
            step = self.train_step
            params, opt = step.init(
                torch.Generator(device=dev).manual_seed(plan.seed), dev)

            def step_fn(it, batch, params, opt):
                return step.fn(params, opt, batch)
            prefetch = Prefetcher(stream, dev, graph=runtime)
        start = 0
        ckpt = (CheckpointManager(ckpt_dir, keep=3, graph=runtime)
                if ckpt_dir else None)
        if ckpt is not None and resume and ckpt.latest_step() is not None:
            start, (params, opt) = ckpt.restore((params, opt))
            if verbose:
                print(f"[train] resumed from step {start}")
        inflight = Pipeline(depth=2)
        log_futs: list = []
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
                batch = prefetch.get(it)
                if fail_at_step is not None and it == fail_at_step \
                        and not resume:
                    raise RuntimeError(f"injected node failure at step {it}")
                metrics, params, opt = step_fn(it, batch, params, opt)
                inflight.push(it, metrics)
                if on_step is not None:
                    on_step(it, metrics)
                if (it + 1) % log_every == 0:
                    # CHECKPOINT lane: forcing metrics for logs must never
                    # outrank the PREFETCH nodes the loop blocks on next
                    log_futs.append(runtime.defer(
                        _force_and_log, it, metrics, t_log,
                        lane=Lane.CHECKPOINT, name=f"log:{it}"))
                    t_log = time.time()
                if ckpt is not None and (it + 1) % ckpt_every == 0:
                    # the write node depends on step retirement: file I/O
                    # starts only after the step's outputs resolve
                    retired = runtime.defer(block_until_ready, metrics,
                                            lane=Lane.CHECKPOINT,
                                            name=f"retire:{it}")
                    fut = ckpt.save(it + 1, (params, opt), deps=(retired,),
                                    meta={"arch": plan.arch})
                    if on_ckpt is not None:
                        on_ckpt(it + 1, fut)
            inflight.drain()
            # the final snapshot, unless the cadence saved this step or
            # nothing ran
            if ckpt is not None and steps % ckpt_every != 0 \
                    and metrics is not None:
                ckpt.save(steps, (params, opt), meta={"arch": plan.arch})
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

        losses = [f.result() for f in log_futs]
        st = runtime.stats()
        final = float(metrics["loss"]) if metrics is not None \
            else float("nan")
        out = {"final_loss": final, "losses": losses, "params": params,
               "step": steps if metrics is not None else start,
               "runtime_stats": st.to_json()}
        if verbose:
            if metrics is None:    # resumed at/after steps: nothing left
                print(f"[train] nothing to do: resumed at step {start} "
                      f">= steps {steps}")
            else:
                print(f"[train] done: final loss {final:.4f} "
                      f"(host tasks {st.completed}, "
                      f"max in-flight {st.max_in_flight}, device {dev})")
        if engine is not None:
            out["grad_wire_bytes"] = int(engine.ring.wire_bytes)
            out["codec_bytes"] = engine.codec_bytes
            if verbose:
                print(f"[train] ddp world {engine.world}, shards "
                      f"{engine.shards}: grad-wire {out['grad_wire_bytes']}B "
                      f"({plan.grad_codec} codec, {engine.codec_bytes}B/"
                      f"locality/exchange)")
        return out

    # -- serve --------------------------------------------------------------
    def serve(self, requests: int = 8, *, prompt_len: int = 32,
              gen_len: int = 16, slots: int = 4, prompts=None,
              verbose: bool = True) -> dict:
        """Batched prefill + greedy decode with slot refill, as a futurized
        tree: each wave is a ``prefill`` node plus ``gen_len`` chained
        ``decode`` nodes (dependency edges carry the (token, cache) pair),
        while the next wave's host prep runs as a PREFETCH node.

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
            toks = torch.from_numpy(np.stack(wave)).to(dev, torch.int64)
            return {"tokens": toks}

        def defer_wave(wave, w: int):
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
                "runtime_stats": st.to_json(), "waves": w + 1,
                "generated": [g.cpu() for g in generated],
                "first_prefill_logits": first_logits[0].float().cpu()}

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
            ``request_latency_hist``).
        Raises:
            ValueError: an encoder-decoder architecture.
        """
        plan, runtime, cfg, dev = self.plan, self.runtime, self.cfg, self.device
        n_replicas = plan.replicas if replicas is None else int(replicas)
        if cfg.family == "encdec":
            raise ValueError("serve_stream does not support encdec "
                             "architectures (scalar-only decoder position "
                             "embedding); use serve()")
        pre1 = self._serve_steps_for(prompt_len, gen_len, 1)[0]
        dec = self._serve_steps_for(prompt_len, gen_len, slots)[1]
        params = init_params(
            pre1.specs, torch.Generator(device=dev).manual_seed(plan.seed), dev)

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

        gw = Gateway(runtime, prefill_step=pre1, decode_step=dec,
                     params=params, prompt_len=prompt_len, gen_len=gen_len,
                     slots=slots, device=dev, max_inflight=max_inflight,
                     deadline_ms=deadline_ms, page_bytes=page_bytes,
                     replicas=n_replicas,
                     kill_replica_at_round=kill_replica_at_round)
        self._gateway = gw          # drill seam: tests call kill_replica()
        tracer = Trace(runtime)
        remove = runtime.add_trace_hook(tracer.record)
        t0 = time.perf_counter()
        try:
            out = gw.run(q)
            if dev.type == "cuda":            # honest timing: retire it all
                torch.cuda.synchronize(dev)
        finally:
            remove()
        dt = time.perf_counter() - t0
        tokens = sum(max(0, len(h.tokens) - 1) for h in out["handles"])
        st = runtime.stats()
        out.update({
            "requests": q.submitted, "tokens": tokens,
            "padded_tokens": st.serve.get("padded_slot_tokens", 0),
            "tokens_per_s": tokens / dt if dt > 0 else 0.0,
            "nodes": tracer.names(), "trace": tracer.signature(),
            "runtime_stats": st.to_json(),
        })
        if verbose:
            rep_note = (f" across {n_replicas} replicas"
                        if n_replicas > 1 else "")
            print(f"[gateway] {q.submitted} requests{rep_note} "
                  f"({out['completed']} done, {out['cancelled']} "
                  f"cancelled, {out['expired']} expired, "
                  f"{out['failed']} failed, {out['rejected']} rejected), "
                  f"{tokens} tokens in {dt:.2f}s -> "
                  f"{out['tokens_per_s']:.1f} tok/s over {out['epochs']} "
                  f"epochs (page hits {st.serve.get('page_hits', 0)}/"
                  f"{st.serve.get('refills', 0)} refills, device {dev})")
        return out
