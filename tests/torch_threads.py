"""The thread policy of every process that the port's tests run.

The tier-1 suite runs in 6 pytest workers (``-n 6 --dist loadfile``) on
a machine of 8 cores, and a port test may start a world of 4 rank
processes and a JAX subprocess beside its worker.  Left alone, each
process sizes its thread pools by the machine's cores (torch's intra-op
pool, OpenMP, XLA's Eigen pool), and the suite's processes then ask for
many times the cores they share: a test that takes 26 s alone took
252 s in the suite.  So every process a port test runs gets a stated
number of threads:

* ``WORKER`` torch threads in a pytest worker running a ``test_torch_*``
  file (``apply()``, called by every such file when it is imported);
* ``RANK`` torch and OpenMP threads in each rank process: the ranks of
  ``torch_mesh_world`` and the rank processes of a mesh ``Session``,
  which take their driver's count (``apply(RANK)`` before the session:
  ``Plan``'s ``num_threads``);
* in a JAX subprocess (``jax_env``), ``RANK`` OpenMP threads and XLA's
  default CPU pool.  XLA's thread flags are left alone on purpose: its
  Eigen pool's size sets the order of the reference's float32 sums
  (tiny whisper's gradients moved by 4.0e-4 of 7.0 with
  ``--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1``),
  and the parity tests' tolerances hold the port to the reference's sums
  under that default.

Float32 sums on the CPU may depend on the thread count, so a test that
holds two processes' results bit for bit runs both sides at one count
(``tests/test_torch_spmd.py``'s ``THREADS``).  The JAX package's own
tests keep their defaults.
"""
from __future__ import annotations

import os

WORKER = 2
RANK = 1


def apply(n: int = WORKER) -> None:
    """This process's torch intra-op threads."""
    import torch
    torch.set_num_threads(n)


def jax_env(devices: int, **extra) -> dict:
    """The environment of a JAX subprocess on the CPU with ``devices``
    host devices, under the policy."""
    return dict(os.environ, OMP_NUM_THREADS=str(RANK),
                MKL_NUM_THREADS=str(RANK), JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                **extra)
