#!/usr/bin/env python3
"""Time the port's K2 (Mamba-2 chunk scan, forward and backward) and K3b
(1-bit dequantize) kernels of several checkouts on one NVIDIA GPU, like
for like.

    python3 tools/compare_port_kernels.py DIR [DIR ...]

Each DIR is the root of a checkout (this one is ``.``); a directory may
be named twice, as in ``old new new old``, to read the spread.  Each is
run in a process of its own, in the order given, which imports that
checkout's ``repro_torch`` (building its kernels into its own
``build/kernels/``) and times, with ``chip_smoke.py``'s ``timings`` (device
time behind a device-side spin, and host-paced):

- K2 at zamba2-2.7b's prefill shape (bf16, B=4, H=80, L=512, P=N=64) with
  Bm, Cm per head (G = H, the only layout before per-group reads) and,
  where the checkout's wrapper takes it, once per group (G = 1, the
  model's);
- K2's backward (``mamba2_chunk_scan_bwd``) at zamba2-2.7b's train shape
  (bf16, B=8, H=80, G=1, L=512, P=N=64), y's gradient normal;
- K3b at a 32 MB bucket [8192, 1024] and at the training plan's largest
  bucket [379840, 1024].

Inputs come from one seed, so every checkout gets the same ones.  Prints
each checkout's readings and, last, one JSON line of all of them.  Needs
a GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_SHAPE = (4, 80, 512, 64, 64)       # B, H, L, P, N
SCAN_BWD_SHAPE = (8, 80, 512, 64, 64)   # B, H, L, P, N; G = 1
DEQUANT_ROWS = (8192, 379840)


def run_tree(tree: str) -> dict:
    """In this process: time the kernels of the checkout at ``tree``."""
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs            # its timing helpers; imports ours
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import mamba2_scan, onebit
    assert mamba2_scan.__file__.startswith(os.path.abspath(tree))

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, L, P, N = SCAN_SHAPE
    xdt = (0.5 * torch.randn(B, H, L, P, generator=gen,
                             device="cuda")).bfloat16()
    a = -0.1 * torch.randn(B, H, L, generator=gen, device="cuda").abs()
    bc = (0.5 * torch.randn(2, B, 1, L, N, generator=gen,
                            device="cuda")).bfloat16()
    out = {}
    for G in (H, 1):
        Bm, Cm = (t.expand(B, G, L, N).contiguous() for t in bc)
        try:
            mamba2_scan.mamba2_chunk_scan(xdt, a, Bm, Cm, chunk=256)
        except ValueError as e:        # a checkout without per-group reads
            print(f"K2 G={G}: not taken ({e})")
            continue
        t = cs.timings(ms=lambda: mamba2_scan.mamba2_chunk_scan(
            xdt, a, Bm, Cm, chunk=256))
        out[f"k2_G{G}"] = t
        print(f"K2 G={G}: {t['ms']:.4f} ms, host-paced "
              f"{t['ms_host_paced']:.4f} ms")
    B, H, L, P, N = SCAN_BWD_SHAPE
    xdt = (0.5 * torch.randn(B, H, L, P, generator=gen,
                             device="cuda")).bfloat16()
    a = -0.1 * torch.randn(B, H, L, generator=gen, device="cuda").abs()
    Bm, Cm = ((0.5 * torch.randn(B, 1, L, N, generator=gen,
                                 device="cuda")).bfloat16() for _ in "BC")
    dy = torch.randn(B, H, L, P, generator=gen, device="cuda").bfloat16()
    t = cs.timings(ms=lambda: mamba2_scan.mamba2_chunk_scan_bwd(
        xdt, a, Bm, Cm, dy))
    out["k2_bwd_train"] = t
    print(f"K2 backward B={B} G=1: {t['ms']:.4f} ms, host-paced "
          f"{t['ms_host_paced']:.4f} ms")
    del xdt, a, Bm, Cm, dy
    torch.cuda.empty_cache()
    for R in DEQUANT_ROWS:
        packed = torch.randint(-2**31, 2**31 - 1, (R, 32), generator=gen,
                               device="cuda", dtype=torch.int32)
        scale = torch.rand(R, 1, generator=gen, device="cuda")
        t = cs.timings(iters=20 if R < 10**5 else 5,
                       ms=lambda: onebit.onebit_dequantize(packed, scale))
        out[f"k3b_R{R}"] = t
        print(f"K3b [{R}, 1024]: {t['ms']:.4f} ms, host-paced "
              f"{t['ms_host_paced']:.4f} ms")
        del packed, scale
        torch.cuda.empty_cache()
    return out


def main(argv: list) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print("RESULT " + json.dumps(run_tree(argv[2])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for tree in argv[1:]:
        print(f"=== checkout {tree}", flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True)
        lines = proc.stdout.splitlines()
        print("\n".join(ln for ln in lines if not ln.startswith("RESULT ")),
              flush=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        result = [ln for ln in lines if ln.startswith("RESULT ")][-1]
        runs.append({"checkout": tree,
                     "readings": json.loads(result[len("RESULT "):])})
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
