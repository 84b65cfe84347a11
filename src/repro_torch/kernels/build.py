"""Build the port's hand-written CUDA kernels and load them with ctypes.

No counterpart in ``repro/``: Pallas kernels compile inside ``jax.jit``.
Here every ``repro_torch/csrc/*.cu`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), one shared library per source with a plain C interface,
all sources compiled in parallel.  A library's file name carries a hash of
its source, so an edited source is rebuilt and a built one is reused.
Only sources in the repository are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each fresh build
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> float:
    """Compile every ``csrc/*.cu`` not built yet, one ``nvcc`` per source,
    all started together.  Returns the seconds it took; raises
    ``RuntimeError`` with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    with _lock:
        todo = [(s, _lib_path(s)) for s in sorted(CSRC.glob("*.cu"))]
        todo = [(s, p) for s, p in todo if not p.exists()]
        if not todo:
            return time.perf_counter() - t0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building it first
    if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    path = _lib_path(src)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches.
    Wrappers run on several runtime worker threads at once (the serving
    gateway's prefill nodes), and a bare ``+=`` from two threads can lose
    an update, so every count is taken under one lock."""
    with _count_lock:
        wrapper.launches += 1
