#!/usr/bin/env python3
"""How far two float32 computations of zamba2-2.7b part by themselves:
the witness for the tolerances with which ``chip_smoke.py`` holds
zamba's training on the card.

    python3 tools/zamba_precision_check.py tiny
    python3 tools/zamba_precision_check.py deep [LAYERS:BATCH ...]

``tiny`` (CPU): tiny zamba2-2.7b trains ``STEPS`` steps of the plain path
(autograd through the plain scan and attention), batch 8 x 64 from seed
0, as ``chip_smoke.py``'s card-against-CPU training does, once in float32
and once in float64 from the same float32 initial parameters, with adamw
and with momentum.  Prints every step's loss and gradient norm and the
largest relative difference of the two precisions.

``deep`` (one NVIDIA GPU): zamba2-2.7b at full width with LAYERS mamba
layers (whole groups of six), random weights from seed 0, one batch of
BATCH x 512 tokens; the loss and every parameter gradient three ways on
the card: through K1 and K2 (forward and backward kernels) in float32,
through their plain versions in float32, and through the plain versions
in float64.  Prints each float32 route's distance from the float64 one:
loss, gradient norm, the whole gradient's relative error and the leaves
with the largest relative error.  Default ``6:2 54:1``.

float64 runs keep the float32 initial parameters and batch, cast
parameters (and the optimizer's state) to float64, compute in float64 and
map ``Tensor.float()`` to the identity on float64 tensors for the
duration, so that the model's float32 upcasts keep float64.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.core.sharding import init_params  # noqa: E402
from repro_torch.data.pipeline import stream_for, to_device  # noqa: E402
from repro_torch.frontend import Plan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba2_chunk_scan_ref  # noqa: E402
from repro_torch.models import attention, ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

ARCH = "zamba2-2.7b"
STEPS = 8
SEQ = 512
KERNELS = (ssm.mamba2_chunk_scan, attention.flash_attention)
PLAIN = (lambda xdt, a, Bm, Cm, chunk=0: mamba2_chunk_scan_ref(xdt, a, Bm, Cm),
         lambda q, k, v, causal=True, window=None, scale=None:
         flash_attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale))


@contextlib.contextmanager
def route(plain: bool, f64: bool):
    """The model's scan and attention through the kernels or their plain
    versions; with ``f64``, ``Tensor.float()`` keeps float64 tensors."""
    to_float = torch.Tensor.float
    ssm.mamba2_chunk_scan, attention.flash_attention = \
        PLAIN if plain else KERNELS
    if f64:
        base._DTYPES["f64"] = torch.float64
        torch.Tensor.float = (lambda t, *a, **k: t if t.dtype == torch.float64
                              else to_float(t, *a, **k))
    try:
        yield
    finally:
        ssm.mamba2_chunk_scan, attention.flash_attention = KERNELS
        torch.Tensor.float = to_float
        base._DTYPES.pop("f64", None)


def to64(tree):
    return pytree.tree_map(
        lambda t: t.detach().double() if t.is_floating_point() else t, tree)


def tiny() -> None:
    for kind in ("adamw", "momentum"):
        oc = optimizers.OptConfig(kind=kind)
        runs = {}
        for f64 in (False, True):
            plan = Plan(arch=ARCH, tiny=True, batch=8, seq=64, device="cpu")
            cfg = plan.config()
            stream = stream_for(cfg, batch=plan.batch, seq=plan.seq)
            with route(True, f64):
                if f64:
                    cfg = dataclasses.replace(cfg, compute_dtype="f64")
                step = steps.make_train_step(cfg, steps.Strategy(opt=oc))
                params, opt = step.init(torch.Generator().manual_seed(0),
                                        "cpu")
                if f64:
                    params, opt = to64(params), to64(opt)
                out = []
                for it in range(STEPS):
                    m, params, opt = step.fn(params, opt, to_device(
                        stream.batch_at(it), "cpu"))
                    out.append((float(m["loss"]), float(m["grad_norm"])))
            runs["float64" if f64 else "float32"] = out
        a, b = runs["float32"], runs["float64"]
        for name, i in (("loss", 0), ("grad norm", 1)):
            diff = [abs(x[i] - y[i]) / abs(y[i]) for x, y in zip(a, b)]
            print(f"tiny {ARCH}, {kind}, {STEPS} steps, {name}: float32 "
                  + " ".join(f"{x[i]:.7f}" for x in a) + "; float64 "
                  + " ".join(f"{y[i]:.7f}" for y in b)
                  + f"; relative difference by step "
                  + " ".join(f"{d:.3g}" for d in diff))


def grads(model, params, batch, plain: bool, f64: bool):
    """(loss, gradients in leaf order on the host, seconds)."""
    with route(plain, f64):
        leaves = pytree.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        t0 = time.perf_counter()
        loss = model.loss(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = [p.grad.cpu() for p in leaves]
        for p in leaves:
            p.grad = None
        return loss.item(), out, secs


def deep(layers: int, batch: int) -> None:
    plan = Plan(arch=ARCH, tiny=False, batch=batch, seq=SEQ,
                overrides={"n_layers": layers, "compute_dtype": "f32"},
                device="cuda")
    cfg = plan.config()
    params = init_params(build_model(cfg).specs(),
                         torch.Generator(device="cuda").manual_seed(0), "cuda")
    data = to_device(stream_for(cfg, batch=batch, seq=SEQ).batch_at(0),
                     "cuda")
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in pytree.tree_flatten_with_path(params)[0]]
    res = {"kernels": grads(build_model(cfg), params, data, False, False),
           "plain": grads(build_model(cfg), params, data, True, False)}
    params = to64(params)
    torch.cuda.empty_cache()
    cfg64 = dataclasses.replace(cfg, compute_dtype="f64")
    res["plain64"] = grads(build_model(cfg64), params, data, True, True)
    del params
    torch.cuda.empty_cache()

    def norm(gs):
        return math.sqrt(sum(float(g.double().square().sum()) for g in gs))
    l64, g64, t64 = res["plain64"]
    print(f"== {layers} layers, batch {batch} x {SEQ}: float64 plain loss "
          f"{l64:.9f}, gradient norm {norm(g64):.7g} ({t64:.1f} s)")
    for name in ("kernels", "plain"):
        loss, g, secs = res[name]
        whole = math.sqrt(sum(float((a.double() - b).square().sum())
                              for a, b in zip(g, g64))) / norm(g64)
        rel = [float((a.double() - b).norm() / max(float(b.norm()), 1e-30))
               for a, b in zip(g, g64)]
        print(f"  float32 {name}: loss {loss:.9f} (relative difference "
              f"{abs(loss - l64) / abs(l64):.3g}), gradient norm "
              f"{norm(g):.7g}, whole gradient's relative error {whole:.3g}, "
              f"median leaf's {sorted(rel)[len(rel) // 2]:.3g} ({secs:.1f} s)")
        for i in sorted(range(len(rel)), key=lambda i: -rel[i])[:3]:
            print(f"    {names[i]}: relative error {rel[i]:.3g} (norm "
                  f"{float(g64[i].norm()):.4g})")
    gk, gp = res["kernels"][1], res["plain"][1]
    whole = math.sqrt(sum(float((a - b).double().square().sum())
                          for a, b in zip(gk, gp))) / norm(gp)
    print(f"  kernels against plain, both float32: whole gradient's relative "
          f"error {whole:.3g}")


def main(argv) -> int:
    if not argv or argv[0] not in ("tiny", "deep"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "tiny":
        tiny()
        return 0
    if not torch.cuda.is_available():
        print("deep needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for spec in argv[1:] or ["6:2", "54:1"]:
        layers, batch = spec.split(":")
        deep(int(layers), int(batch))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
