"""Data-parallel mesh training (``core/steps.py`` on a mesh of rank
processes, ``core/overlap.py``, ``optim/compression.exchange_onebit``)
against the JAX package's ``make_train_step`` over a host-device mesh.

One port world of 4 gloo ranks on the CPU (``torch_mesh_world``) and one
JAX subprocess with 4 host devices, both module-scoped and run at once;
both start tiny qwen3-4b from the reference's init (``PRNGKey(0)``,
carried by ``bridge``) and train 4 steps at lr 1e-3:

* phylanx, horovod, zero1 and onebit at data=2, zero1 and onebit at
  data=4: each step's loss and gradient norm within 1e-5 relative of the
  reference's (float32).  onebit after its first step within 1e-3: a
  near-zero gradient whose sign differs between the two packages' float32
  sums moves its element by a whole +-scale, and the residual carries it
  on (``tests/test_torch_train.py`` holds world-1 onebit DDP to the same);
* onebit's exchange on the same gradient buckets: every rank's packed
  sign words and scales byte for byte the reference's
  (``quantize_bucket``), and the exchanged mean bit for bit;
* the reference's own checks, on the port alone: phylanx, zero1 and
  horovod agree (``test_phylanx_zero1_horovod_same_math``), and data 1,
  2 and 4 give the same losses (``test_dp_scaling_changes_nothing_
  semantically``, tiny qwen2.5-3b, within 5e-3).
"""
import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.sharding import init_params as jax_init_params
from repro.models.model import build_model as build_jax_model
from repro.optim import compression as jax_compression
from torch_mesh_world import run_world, seeded
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARCH, LR, BATCH, SEQ, STEPS = "qwen3-4b", 1e-3, 8, 16, 4
CASES = [("phylanx", 2), ("horovod", 2), ("zero1", 2), ("onebit", 2),
         ("zero1", 4), ("onebit", 4)]
N_ONEBIT = 2 * jax_compression.ROW * 32      # two 32-word rows of buckets
RTOL, ONEBIT_RTOL = 1e-5, 1e-3

_REF = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.core import steps as S
    from repro.core.compat import shard_map
    from repro.data.pipeline import LMStream
    from repro.launch.mesh import make_local_mesh, make_mesh
    from repro.optim import compression as C
    from repro.optim.optimizers import OptConfig
    spec = json.loads(sys.stdin.read())
    cfg = get_config(spec["arch"], tiny=True)
    shape = {"seq_len": spec["seq"], "global_batch": spec["batch"],
             "kind": "train"}
    out = {}
    for name, ndp in spec["cases"]:
        step = S.make_train_step(
            cfg, make_local_mesh(data=ndp),
            S.Strategy(name=name, opt=OptConfig(lr=spec["lr"])), shape)
        params, opt = step.init(jax.random.PRNGKey(0))
        stream = LMStream(vocab=cfg.vocab, batch=spec["batch"],
                          seq=spec["seq"], seed=0)
        ls, gs = [], []
        for it in range(spec["steps"]):
            b = {k: jax.device_put(v, step.batch_shardings[k])
                 for k, v in stream.batch_at(it).items()}
            m, params, opt = step.fn(params, opt, b)
            ls.append(float(m["loss"]))
            gs.append(float(m["grad_norm"]))
        out[f"{name}@{ndp}"] = {"loss": ls, "grad_norm": gs}
    bufs = np.asarray(spec["bufs"], np.float32)
    n = bufs.shape[1]
    plan = C.make_plan({"g": jax.ShapeDtypeStruct((n,), jnp.float32)}, 2)
    zero = jnp.zeros((n // C.ROW, C.ROW), jnp.float32)
    q = [C.quantize_bucket(jnp.asarray(b), zero) for b in bufs]
    out["words"] = [np.asarray(p).tobytes().hex() for p, _, _ in q]
    out["scales"] = [np.asarray(s).tobytes().hex() for _, s, _ in q]

    def body(g):
        err = [zero for _ in plan.buckets]
        mean, _ = C.exchange_onebit({"g": g[0]}, err, ("data",), plan)
        return mean["g"][None]
    f = shard_map(body, mesh=make_mesh((2,), ("data",)), in_specs=P("data"),
                  out_specs=P("data"), check_vma=False)
    out["mean"] = np.asarray(f(jnp.asarray(bufs)))[0].tobytes().hex()
    print(json.dumps(out))
""")


def _reference(bufs) -> dict:
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    spec = {"arch": ARCH, "lr": LR, "batch": BATCH, "seq": SEQ,
            "steps": STEPS, "cases": CASES, "bufs": bufs.tolist()}
    p = subprocess.run([sys.executable, "-c", _REF], input=json.dumps(spec),
                       env=env, text=True, capture_output=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _port_cases(params, bufs) -> list:
    base = {"arch": ARCH, "lr": LR, "batch": BATCH, "seq": SEQ,
            "stream_seed": 0, "steps": STEPS, "params": params}
    cases = [dict(base, key=f"{n}@{d}", name=n, ndp=d,
                  onebit_bufs=bufs if (n, d) == ("onebit", 2) else None)
             for n, d in CASES]
    # the reference's dp-scaling check: tiny qwen2.5-3b, batch 8 x 16,
    # stream seed 3, the default strategy, at data 1, 2 and 4
    cases += [dict(arch="qwen2.5-3b", lr=3e-4, batch=8, seq=16,
                   stream_seed=3, steps=4, params=None, key=f"scale@{d}",
                   name="phylanx", ndp=d) for d in (1, 2, 4)]
    return cases


@pytest.fixture(scope="module")
def runs():
    """The reference's trajectories and the port's, run at once."""
    bufs = np.stack([seeded(N_ONEBIT, 7 + r) for r in range(2)])
    params = jax.tree.map(np.asarray, jax_init_params(
        build_jax_model(jax_get_config(ARCH, tiny=True)).specs(),
        jax.random.PRNGKey(0)))
    ref: dict = {}
    t = threading.Thread(target=lambda: ref.update(_reference(bufs)))
    t.start()
    try:
        ranks = run_world("trajectories", 4,
                          {"cases": _port_cases(params, bufs)})
    finally:
        t.join()
    port = {}
    for r in ranks:
        for k, v in r.items():
            port.setdefault(k, v)
    return ref, port, ranks


@pytest.mark.parametrize("case", [f"{n}@{d}" for n, d in CASES])
def test_strategy_matches_reference(runs, case):
    ref, port, ranks = runs
    got, want = port[case], ref[case]
    for k in ("loss", "grad_norm"):
        rtol = [RTOL] + [ONEBIT_RTOL if case.startswith("onebit") else RTOL
                         ] * (STEPS - 1)
        for it in range(STEPS):
            np.testing.assert_allclose(got[k][it], want[k][it],
                                       rtol=rtol[it],
                                       err_msg=f"{case} step {it} {k}")
    # every rank of the mesh ends each step with the same metrics
    ndp = int(case.split("@")[1])
    for r in range(ndp):
        assert ranks[r][case]["loss"] == got["loss"]


def test_onebit_step1_payloads_are_the_references_byte_for_byte(runs):
    ref, port, ranks = runs
    for r in range(2):
        packed, scales, mean = ranks[r]["onebit@2"]["bucket0"]
        assert packed.shape[0] == 2            # every origin's payload
        for o in range(2):
            assert packed[o].tobytes().hex() == ref["words"][o]
            assert scales[o].tobytes().hex() == ref["scales"][o]
        assert mean.tobytes().hex() == ref["mean"]


def test_phylanx_zero1_horovod_same_math(runs):
    """The three exact strategies implement the same optimizer step."""
    _, port, _ = runs
    for a, b in (("phylanx@2", "horovod@2"), ("phylanx@2", "zero1@2")):
        diff = max(abs(x - y) for x, y in zip(port[a]["loss"],
                                               port[b]["loss"]))
        assert diff < 1e-5, (a, b, port[a], port[b])
    assert port["phylanx@2"]["loss"] == port["horovod@2"]["loss"]


def test_dp_scaling_changes_nothing_semantically(runs):
    """Same global batch on 1, 2 and 4 data ranks -> same losses."""
    _, port, _ = runs
    base = port["scale@1"]["loss"]
    for d in (2, 4):
        diff = max(abs(a - b) for a, b in zip(base, port[f"scale@{d}"]
                                              ["loss"]))
        assert diff < 5e-3, (d, base, port[f"scale@{d}"])
