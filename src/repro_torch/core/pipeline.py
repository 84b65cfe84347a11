"""GPipe-style pipeline parallelism over a stage axis of rank processes
(paper R2).

Counterpart: ``repro/core/pipeline.py`` (``bubble_fraction``,
``gpipe_apply``, ``make_pipeline_fn``).  The model's layer stack is split
into S contiguous stages, one per rank process of a ``stage`` mesh
(``launch.mesh.make_mesh((S,), ("stage",))``).  Microbatches flow through
the reference's static schedule of T = M + S - 1 ticks: stage 0 injects
microbatch t, the last stage records microbatch t - (S - 1), and at every
tick every rank hands its activation to the next stage with
``collectives.pipeline_shift``.  A rank knows its stage, so it calls
``stage_fn`` only on its valid ticks (M calls a pass) and still takes part
in every shift.  The last stage's outputs reach every rank through the
reference's closing broadcast, a sum over the stage group of a one-hot.

The reference runs the ticks as a ``lax.scan`` inside ``shard_map`` and
lets JAX differentiate it.  Here the backward pipeline is the schedule
run in reverse by one autograd function, so that every rank makes the
same collectives in the same order whatever its graph holds: at each tick
from the last, the reverse ``pipeline_shift`` (the transpose of the
forward one) hands each rank the gradient of the activation it sent, and
a rank with a valid tick differentiates its ``stage_fn`` call of that
tick (kept from the forward pass).  The closing broadcast's cotangent
reaches the last stage once: every rank takes the same loss of the
replicated output, and only the last stage reads its gradient, as JAX's
transpose of the one-hot ``psum`` gives.  So every rank must run the
backward pass, as every rank ran the forward.  A stage's parameter
gradients are its own; the input's gradient is summed over the stage
group, as JAX sums a replicated input's cotangent.

Bubble fraction: (S - 1) / (M + S - 1), ``bubble_fraction``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.utils._pytree as pytree

from . import collectives
from .sharding import ShardingRules, local_slices

__all__ = ["bubble_fraction", "gpipe_apply", "make_pipeline_fn"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The idle share of a GPipe schedule: ``(S - 1) / (M + S - 1)``."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


class _Schedule:
    """One pass of the tick schedule on this rank: stage ``sid`` of
    ``n`` over the collectives axis ``axis``, ``m`` microbatches."""

    def __init__(self, stage_fn, treedef, mesh, axis: str, m: int):
        self.stage_fn, self.treedef = stage_fn, treedef
        self.mesh, self.axis, self.m = mesh, axis, m
        self.n = collectives._size(mesh, axis)
        self.sid = collectives._index(mesh, axis)
        self.ticks = m + self.n - 1

    def valid(self, t: int) -> bool:
        return 0 <= t - self.sid < self.m

    def recorded(self, t: int) -> bool:
        return self.sid == self.n - 1 and self.valid(t)

    def forward(self, leaves, x_micro, keep: bool):
        """The last stage's outputs broadcast to every rank; with
        ``keep``, each valid tick's (input, output) graph of ``stage_fn``
        on detached leaves, for ``backward``."""
        params = pytree.tree_unflatten(list(leaves), self.treedef)
        state = torch.zeros_like(x_micro[0])
        outs, saved = [], {}
        for t in range(self.ticks):
            if self.sid == 0 and t < self.m:
                state = x_micro[t]
            if not self.valid(t):
                y = state
            elif keep:
                inp = state.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self.stage_fn(params, inp)
                saved[t] = (inp, y)
                y = y.detach()
            else:
                y = self.stage_fn(params, state)
            if self.recorded(t):
                outs.append(y)
            state = collectives.pipeline_shift(y, self.mesh,
                                               mesh_axis=self.axis)
        out = torch.stack(outs) if outs else torch.zeros_like(x_micro)
        return collectives.all_reduce(out, self.mesh,
                                      mesh_axis=self.axis), saved

    def backward(self, g_out, saved, leaves, want_x: bool):
        """(the input's gradient or None, each leaf's gradient or None):
        the ticks in reverse, every rank shifting at each."""
        grads = [None] * len(leaves)
        wanted = [i for i, p in enumerate(leaves) if p.requires_grad]
        g_x = torch.zeros_like(g_out) if want_x else None
        g_next = torch.zeros_like(g_out[0])      # of the state after T - 1
        for t in reversed(range(self.ticks)):
            injected = self.sid == 0 and t + 1 < self.m
            if injected and g_x is not None:
                g_x[t + 1] += g_next
            g_recv = torch.zeros_like(g_next) if injected else g_next
            g_y = collectives.pipeline_shift(g_recv, self.mesh, reverse=True,
                                             mesh_axis=self.axis)
            if self.recorded(t):
                g_y = g_y + g_out[t - (self.n - 1)]
            if not self.valid(t):
                g_next = g_y
                continue
            inp, y = saved.pop(t)
            got = torch.autograd.grad(y, [inp] + [leaves[i] for i in wanted],
                                      g_y, allow_unused=True)
            g_next = got[0] if got[0] is not None else torch.zeros_like(g_y)
            for i, g in zip(wanted, got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        if self.sid == 0 and g_x is not None:
            g_x[0] += g_next
        if g_x is not None:
            g_x = collectives.all_reduce(g_x, self.mesh, mesh_axis=self.axis)
        return g_x, grads


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x_micro, *leaves):
        det = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        out, saved = sched.forward(det, x_micro.detach(), keep=True)
        ctx.sched, ctx.saved, ctx.det = sched, saved, det
        return out

    @staticmethod
    def backward(ctx, g_out):
        g_x, grads = ctx.sched.backward(g_out.contiguous(), ctx.saved,
                                        ctx.det, ctx.needs_input_grad[1])
        ctx.saved = ctx.det = None
        return (None, g_x, *grads)


def gpipe_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                mesh, *, axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the pipeline on this rank of ``mesh``.

    Args:
        stage_fn: ``stage_fn(params_for_stage, x) -> y``, applied by every
            stage; ``y`` has ``x``'s shape and dtype.
        stage_params: this rank's stage parameters (a tree of tensors).
        x_micro: ``[M, mb, ...]`` microbatched inputs, the same on every
            rank (only stage 0 injects them).
        mesh: a mesh with a stage axis (``make_mesh((S,), ("stage",))``).
        axis: the mesh axis of the stages.
    Returns:
        ``[M, mb, ...]``, the outputs of the last stage, on every rank.
        Differentiable when a leaf or ``x_micro`` requires grad: every
        rank then takes the same loss of it and runs its backward pass.
    """
    leaves, treedef = pytree.tree_flatten(stage_params)
    sched = _Schedule(stage_fn, treedef, mesh,
                      collectives.axis_of(mesh, axis), x_micro.shape[0])
    if torch.is_grad_enabled() and (x_micro.requires_grad or any(
            isinstance(p, torch.Tensor) and p.requires_grad
            for p in leaves)):
        return _GPipe.apply(sched, x_micro, *leaves)
    with torch.no_grad():
        return sched.forward(leaves, x_micro, keep=False)[0]


def make_pipeline_fn(stage_fn: Callable, mesh, *, axis: str = "stage",
                     param_spec=None, out_replicated: bool = True):
    """``fn(stacked_params, x_micro)``: ``gpipe_apply`` on this rank's
    slice of every stacked leaf.

    Each leaf's dims are cut by ``param_spec`` (the parts of the
    reference's ``PartitionSpec``: a mesh axis or None per leading dim;
    default ``(axis,)``, one slice per stage on dim 0) through
    ``sharding.local_slices``, and the slice's dim 0 is dropped, as the
    reference's body takes ``p[0]``.  A leaf may be the global stack (dim
    0 = S) or this rank's own slice (dim 0 = 1, which does not divide and
    stays whole), so that a rank at full width never holds another
    stage's weights.  ``out_replicated`` is the reference's parameter,
    unused there too: the output is always on every rank.
    """
    spec = tuple(param_spec) if param_spec is not None else (axis,)
    rules = ShardingRules({a: a for a in spec if a is not None})

    def mine(p):
        dims = spec[:p.dim()] + (None,) * (p.dim() - len(spec))
        return p[local_slices(mesh, rules, p.shape, dims)][0]

    def fn(stacked_params, x_micro):
        return gpipe_apply(stage_fn, pytree.tree_map(mine, stacked_params),
                           x_micro, mesh, axis=axis)
    return fn
