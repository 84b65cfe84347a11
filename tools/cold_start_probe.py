"""Cold-start probe 2: is a fresh process's first step JIT, module loading or else?"""
import json, os, subprocess, sys, time, tempfile
sys.path.insert(0, "src")
CHILD = r'''
import time, sys, json, os; t = time.perf_counter(); sys.path.insert(0, "src")
import torch; t1 = time.perf_counter()
torch.zeros(1, device="cuda"); torch.cuda.synchronize(); t2 = time.perf_counter()
from repro_torch.frontend.plan import Plan
from repro_torch.core import steps
from repro_torch.data.pipeline import stream_for, to_device
plan = Plan(arch="granite-moe-1b-a400m", tiny=False, batch=8, seq=512, device="cuda", overrides={"n_layers": 2})
step = steps.make_train_step(plan.config(), steps.Strategy(), plan=plan)
params, opt = step.init(torch.Generator(device="cuda").manual_seed(0), "cuda"); torch.cuda.synchronize()
b = to_device(stream_for(plan.config(), batch=8, seq=512, seed=0).batch_at(0), "cuda")
t3 = time.perf_counter()
prof = None
if os.environ.get("PROBE_PROFILE"):
    import cProfile, pstats; prof = cProfile.Profile(); prof.enable()
loss, grads = step.grads(params, b); torch.cuda.synchronize(); t4 = time.perf_counter()
params, opt, m = step.apply(grads, opt, params); torch.cuda.synchronize(); t5 = time.perf_counter()
if prof is not None:
    prof.disable(); pstats.Stats(prof).sort_stats("tottime").print_stats(12)
loss, grads = step.grads(params, b); torch.cuda.synchronize(); t6 = time.perf_counter()
print(json.dumps(dict(import_torch=t1-t, cuda_init=t2-t1, grads1=t4-t3, apply1=t5-t4, grads2=t6-t5)))
'''
print(sys.version, flush=True)
import torch
print(torch.__version__, torch.version.cuda, torch.cuda.get_arch_list(), os.environ.get("HOME"), os.environ.get("CUDA_MODULE_LOADING"), flush=True)
from repro_torch.kernels import build
print("build", round(build.build_all(), 1), flush=True)
cache = tempfile.mkdtemp()
for label, extra in (("default", {}), ("default again", {}),
                     ("cache 4GiB", {"CUDA_CACHE_MAXSIZE": str(4 << 30), "CUDA_CACHE_PATH": cache}),
                     ("cache 4GiB again", {"CUDA_CACHE_MAXSIZE": str(4 << 30), "CUDA_CACHE_PATH": cache}),
                     ("eager modules", {"CUDA_MODULE_LOADING": "EAGER"}),
                     ("profiled", {"PROBE_PROFILE": "1"})):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True, env=dict(os.environ, **extra))
    print(f"{label}: wall {time.perf_counter() - t0:.1f}s rc {out.returncode}", flush=True)
    lines = out.stdout.strip().splitlines()
    if label == "profiled":
        print("\n".join(lines[:-1])[-4000:], flush=True)
    print("  ", lines[-1] if lines else out.stderr[-2000:], flush=True)
    subprocess.run(["du", "-sh", cache])
