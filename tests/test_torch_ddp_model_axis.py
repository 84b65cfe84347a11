"""Fabric DDP beside a model axis (``Plan(ddp=True, model=2)``,
``frontend/ddp.py``) against the JAX package's same plans.

Each locality is a model group of two rank processes (one gloo world a
locality); its model coordinate 0 is the member of the gradient ring and
exchanges the reference's global float32 buckets, gathered over the
group one bucket at a time.  Both packages resume from one checkpoint of
the reference's init (``PRNGKey(0)``, written at step 1 by the JAX
package's ``CheckpointManager``) and train steps 2 and 3 at adamw lr
1e-5; two JAX subprocesses with 4 host devices run the reference's
plans while the port's sessions run:

* tiny qwen3-4b and tiny granite-moe-1b-a400m at localities 1 and 2,
  fp32 and onebit, and tiny zamba2-2.7b in fp32 at one locality: each
  step's loss and gradient norm within ``RTOL`` of the reference's
  (onebit's second step within ``ONEBIT_RTOL``, as the mesh tests hold
  it), ``codec_bytes`` and ``grad_wire_bytes`` exactly the reference's
  (steps x (L - 1) x ``codec_bytes``), and every model rank's loss the
  driver's;
* onebit's first exchange: the driver's global buckets within
  ``BUCKET_TOL`` of the reference's, and the port's K3a on the
  reference's buckets gives the reference's payload (sign words and
  scales) byte for byte;
* fp32 at 2 localities bit-identical to 1 locality, losses and
  parameters;
* a save, an injected failure and a resume in one session continue the
  straight run bit for bit, and the reference's ``CheckpointManager``
  restores the port's checkpoint;
* ``Session.serve`` and ``serve_stream`` at 2 localities serve on the
  driver's model group, their ``stack`` prep on the other locality: one
  locality's tokens and streams;
* a locality killed mid-all-reduce ends in ``LocalityLostError`` with
  every process of both groups reaped;
* zero1 and ``grad_accum > 1`` raise the reference's ``ValueError``s.
"""
import json
import shutil
import subprocess
import sys
import tempfile
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import steps as jax_steps
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.optim.optimizers import OptConfig as JaxOptConfig
from repro_torch.bridge import host_leaves
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import steps
from repro_torch.distrib import LocalityLostError
from repro_torch.distrib import collectives as port_collectives
from repro_torch.frontend import Plan
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import compression
from repro_torch.optim.optimizers import OptConfig
import torch_threads

torch_threads.apply()

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"qwen": "qwen3-4b", "granite": "granite-moe-1b-a400m",
         "zamba": "zamba2-2.7b"}
BATCH, SEQ, START, STEPS, LR = 4, 16, 1, 3, 1e-5
# (family, codec, localities) of the port's runs and of the reference's;
# the reference's fp32 at 2 localities is its 1 locality's, bit for bit
# (its own contract, tests/test_ddp.py)
PORT = [(f, c, n) for f in ("qwen", "granite") for c in ("fp32", "onebit")
        for n in (1, 2)] + [("zamba", "fp32", 1)]
REF = [("qwen", "fp32", 1), ("qwen", "onebit", 1), ("qwen", "onebit", 2),
       ("granite", "fp32", 1), ("granite", "onebit", 1),
       ("zamba", "fp32", 1)]
RTOL, ONEBIT_RTOL = 5e-4, 1e-3
# the first exchange's global buckets, each element within this share of
# its bucket's largest |gradient| (granite's: the model-axis families'
# GRAD_TOL, its routing and embedding sums, tests/test_torch_model_axis_
# families.py)
BUCKET_TOL = {"qwen": 1e-5, "granite": 1e-3}
# the runs that also serve, at each locality count
SERVED = ("qwen", "fp32")
SERVE = dict(requests=3, prompt_len=8, gen_len=3, slots=2)


def _key(f, c, n) -> str:
    return f"{f}:{c}@{n}"


_REF = textwrap.dedent("""
    import json, os, shutil, sys
    import numpy as np
    from repro.core import steps as S
    from repro.distrib import collectives as DC
    from repro.frontend import Plan
    from repro.optim.optimizers import OptConfig

    def main():
        spec = json.loads(sys.stdin.read())
        seen = {}
        encode = DC.OneBitCodec.encode

        def spy(self, bufs):
            out = encode(self, bufs)
            if spec["cur"] not in seen:
                seen[spec["cur"]] = ([np.asarray(b) for b in bufs], out)
            return out
        DC.OneBitCodec.encode = spy
        res = {}
        for f, codec, n in spec["cases"]:
            key = f"{f}:{codec}@{n}"
            spec["cur"] = key
            d = os.path.join(spec["tmp"], "ref-" + key.replace(":", "-")
                             .replace("@", "-"))
            shutil.copytree(spec["seed"][f], d)
            norms = []

            class Hook:
                def on_step(self, it, m):
                    norms.append(float(m["grad_norm"]))
            plan = Plan(arch=spec["archs"][f], batch=spec["batch"],
                        seq=spec["seq"], ddp=True, ddp_shards=2, model=2,
                        grad_codec=codec, localities=n,
                        strategy=S.Strategy(opt=OptConfig(lr=spec["lr"])))
            with plan.compile() as s:
                out = s.train(steps=spec["steps"], ckpt_dir=d,
                              ckpt_every=100, resume=True, log_every=1,
                              hooks=Hook(), verbose=False)
            res[key] = {"loss": out["losses"], "grad_norm": norms,
                        "grad_wire_bytes": out["grad_wire_bytes"],
                        "codec_bytes": out["codec_bytes"]}
            if key in seen:
                bufs, payloads = seen[key]
                path = os.path.join(spec["tmp"], key.replace(":", "-")
                                    .replace("@", "-") + ".npz")
                np.savez(path, **{f"b{i}": b for i, b in enumerate(bufs)},
                         **{f"p{i}": np.frombuffer(p, np.uint8)
                            for i, p in enumerate(payloads)})
                res[key]["first"] = path
        print(json.dumps(res))

    if __name__ == "__main__":
        main()
""")


def _reference(spec) -> dict:
    env = torch_threads.jax_env(4, PYTHONPATH=str(ROOT / "src"))
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(_REF)
    with tempfile.TemporaryFile(mode="w+") as err:
        p = subprocess.run([sys.executable, f.name], input=json.dumps(spec),
                           env=env, text=True, stdout=subprocess.PIPE,
                           stderr=err, timeout=600)
        err.seek(0)
        assert p.returncode == 0, err.read()[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _seed_checkpoint(arch: str, path: Path) -> None:
    """The reference's DDP init, saved at step ``START`` by its own
    ``CheckpointManager``: both packages resume from it."""
    cfg = jax_get_config(arch, tiny=True)
    step = jax_steps.make_ddp_step(
        cfg, jax_local_mesh(), jax_steps.Strategy(opt=JaxOptConfig(lr=LR)),
        {"seq_len": SEQ, "global_batch": BATCH // 2, "kind": "train"})
    with JaxManager(path, async_save=False) as cm:
        cm.save(START, step.init(jax.random.PRNGKey(0)))


def _plan(f: str, codec: str = "fp32", n: int = 1, **kw) -> Plan:
    kw.setdefault("strategy", steps.Strategy(opt=OptConfig(lr=LR)))
    return Plan(arch=ARCHS[f], batch=BATCH, seq=SEQ, ddp=True, ddp_shards=2,
                model=2, grad_codec=codec, localities=n, device="cpu", **kw)


class _Norms:
    def __init__(self):
        self.norms = []

    def on_step(self, it, m):
        self.norms.append(float(m["grad_norm"]))


def _served(s) -> dict:
    """``serve``'s tokens and ``serve_stream``'s streams on session ``s``,
    with the ``stack`` nodes' homes."""
    served = s.serve(verbose=False, **SERVE)
    st = s.serve_stream(verbose=False, **SERVE)
    return {"tokens": [g.tolist() for g in served["generated"]],
            "streams": st["streams"],
            "stacks": [n for n in served["nodes"] + st["nodes"]
                       if n.startswith("stack:")]}


def _port(f, codec, n, seed: Path, d: Path) -> dict:
    shutil.copytree(seed, d)
    hook = _Norms()
    served = None
    with _plan(f, codec, n).compile() as s:
        out = s.train(steps=STEPS, ckpt_dir=str(d), ckpt_every=100,
                      resume=True, log_every=1, hooks=hook, verbose=False)
        if (f, codec) == SERVED:
            served = _served(s)
    return {"loss": out["losses"], "grad_norm": hook.norms, "served": served,
            "grad_wire_bytes": out["grad_wire_bytes"],
            "codec_bytes": out["codec_bytes"], "ranks": out["ranks"],
            "localities": out.get("localities"), "wire": out["wire"],
            "params": [np.array(t) for t in host_leaves(out["params"])[1]],
            "dir": d}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_model_axis")
    seeds = {}
    for f, arch in ARCHS.items():
        seeds[f] = tmp / f"seed-{f}"
        _seed_checkpoint(arch, seeds[f])
    spec = {"archs": ARCHS, "seed": {k: str(v) for k, v in seeds.items()},
            "tmp": str(tmp), "batch": BATCH, "seq": SEQ, "steps": STEPS,
            "lr": LR}
    ref: dict = {}

    def reference(cases):
        try:
            ref.update(_reference(dict(spec, cases=cases)))
        except BaseException as e:  # noqa: BLE001 - raised below
            ref["error"] = e
    # two subprocesses, qwen's cases beside the others
    threads = [threading.Thread(target=reference, args=(cases,))
               for cases in (REF[:3], REF[3:])]
    for t in threads:
        t.start()
    port, first = {}, {}
    encode = port_collectives.OneBitCodec.encode

    def spy(self, bufs):
        bufs = [b.detach().cpu().numpy().copy() for b in bufs]
        out = encode(self, [torch.from_numpy(b) for b in bufs])
        first.setdefault(spy.cur, (bufs, out))
        return out
    port_collectives.OneBitCodec.encode = spy
    try:
        for f, c, n in PORT:
            spy.cur = _key(f, c, n)
            port[spy.cur] = _port(f, c, n, seeds[f],
                                  tmp / f"port-{f}-{c}-{n}")
    finally:
        port_collectives.OneBitCodec.encode = encode
        for t in threads:
            t.join()
    if "error" in ref:
        raise ref["error"]
    return {"ref": ref, "port": port, "first": first, "seeds": seeds,
            "tmp": tmp}


@pytest.mark.parametrize("case", [_key(*c) for c in PORT])
def test_losses_norms_and_wire_match_the_reference(runs, case):
    got = runs["port"][case]
    f, rest = case.split(":")
    codec, n = rest.split("@")
    # the reference's same plan; its fp32 runs are one locality's at any
    # count, and granite's onebit at 2 localities is held by its wire
    want = runs["ref"].get(case) or runs["ref"].get(f"{f}:{codec}@1")
    assert len(got["loss"]) == STEPS - START == len(got["grad_norm"])
    if not (codec == "onebit" and int(n) == 2 and case not in runs["ref"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=RTOL,
                                       err_msg=f"{case} {k}")
            np.testing.assert_allclose(
                got[k][1:], want[k][1:],
                rtol=ONEBIT_RTOL if codec == "onebit" else RTOL,
                err_msg=f"{case} {k}")
    assert got["codec_bytes"] == want["codec_bytes"]
    assert got["grad_wire_bytes"] == \
        (STEPS - START) * (int(n) - 1) * got["codec_bytes"]
    if case in runs["ref"]:
        assert got["grad_wire_bytes"] == want["grad_wire_bytes"]
    # every rank of every model group took the driver's steps
    for r in got["ranks"].values():
        assert r["final_loss"] == got["loss"][-1]
    for r in (got["localities"] or {}).values():
        assert r["final_loss"] == got["loss"][-1]
        assert r["grad_wire_bytes"] == got["grad_wire_bytes"]
    # the model group's traffic is counted on its own axis, not the ring's
    assert got["wire"]["axes"]["model"]["calls"] > 0
    assert got["wire"]["axes"]["dp"]["calls"] == 0


@pytest.mark.parametrize("fam", ["qwen", "granite"])
def test_first_onebit_exchange_is_the_references(runs, fam):
    key = _key(fam, "onebit", 1)
    bufs, payloads = runs["first"][key]
    with np.load(runs["ref"][key]["first"]) as z:
        ref_bufs = [z[f"b{i}"] for i in range(len(bufs))]
        ref_pay = [z[f"p{i}"].tobytes() for i in range(len(bufs))]
    assert len(payloads) == len(ref_pay)
    for i, (b, rb) in enumerate(zip(bufs, ref_bufs)):
        np.testing.assert_allclose(b, rb, rtol=0,
                                   atol=BUCKET_TOL[fam] * float(
                                       np.abs(rb).max()),
                                   err_msg=f"bucket {i}")
        # the port's K3a on the reference's bucket, from a zero residual
        packed, scale, _ = compression.quantize_bucket(
            torch.from_numpy(rb), torch.zeros(rb.size // compression.ROW,
                                              compression.ROW))
        assert packed.numpy().tobytes() + scale.numpy().tobytes() \
            == ref_pay[i], f"bucket {i}"
        assert len(payloads[i]) == len(ref_pay[i])


@pytest.mark.parametrize("fam", ["qwen", "granite"])
def test_fp32_two_localities_bit_identical_to_one(runs, fam):
    one = runs["port"][_key(fam, "fp32", 1)]
    two = runs["port"][_key(fam, "fp32", 2)]
    assert two["loss"] == one["loss"]
    assert two["grad_norm"] == one["grad_norm"]
    for a, b in zip(two["params"], one["params"]):
        np.testing.assert_array_equal(a, b)


def test_serve_and_serve_stream_run_on_the_drivers_model_group(runs):
    """``Session.serve`` and ``serve_stream`` beside fabric DDP serve on the
    driver's model group, as the reference serves on the driver's mesh
    (the other locality's model group stays idle), with their ``stack``
    prep on the other locality: one locality's tokens and streams."""
    one = runs["port"][_key(*SERVED, 1)]["served"]
    two = runs["port"][_key(*SERVED, 2)]["served"]
    assert two["tokens"] == one["tokens"]
    assert two["streams"] == one["streams"]
    assert any(n.endswith("@L1") for n in two["stacks"]), two["stacks"]


def test_save_fail_resume_is_bit_identical_and_the_reference_restores(
        runs):
    """In one 2-locality session: a straight run, then the drill (a save
    at step 2, an injected failure at step 3, a resume): the resumed step
    is the straight run's, loss and parameters."""
    d = runs["tmp"] / "drill"
    kw = dict(steps=STEPS, log_every=1, verbose=False)
    with _plan("qwen", "fp32", 2).compile() as s:
        straight = s.train(**kw)
        straight_params = [np.array(t) for t in
                           host_leaves(straight["params"])[1]]
        with pytest.raises(RuntimeError, match="injected node failure"):
            s.train(ckpt_dir=str(d), ckpt_every=2, fail_at_step=2, **kw)
        out = s.train(ckpt_dir=str(d), ckpt_every=2, resume=True, **kw)
    assert out["losses"] == straight["losses"][2:]
    for a, b in zip(host_leaves(out["params"])[1], straight_params):
        np.testing.assert_array_equal(a, b)
    # the port's model=2 checkpoint is the reference's global layout
    like = jax_steps.make_ddp_step(
        jax_get_config(ARCHS["qwen"], tiny=True), jax_local_mesh(),
        jax_steps.Strategy(opt=JaxOptConfig(lr=LR)),
        {"seq_len": SEQ, "global_batch": BATCH // 2, "kind": "train"}
    ).init(jax.random.PRNGKey(0))
    step, jtree = JaxManager(d, async_save=False).restore(like)
    assert step == STEPS
    ts = steps.make_train_step(get_config(ARCHS["qwen"], tiny=True),
                               steps.Strategy(opt=OptConfig(lr=LR)))
    _, back = CheckpointManager(d, async_save=False, spmd=False).restore(
        (ts.params_like(), ts.global_like()))
    got = jax.tree.leaves(jtree)
    want = host_leaves(back)[1]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)


def _alive(procs) -> list:
    return [p.pid for p in procs if p.is_alive()]


def test_locality_killed_mid_allreduce_is_lost_and_every_process_reaped():
    with _plan("qwen", "fp32", 2).compile() as s:
        procs = list(s.distributed.group.procs.values()) + \
            list(s.ranks.group.procs.values())
        assert len(procs) == 3
        with pytest.raises(LocalityLostError):
            s.train(steps=30, kill_locality_at_step=1, log_every=10,
                    verbose=False)
    for p in procs:
        p.join(timeout=30)
    assert _alive(procs) == []


def test_zero1_and_grad_accum_raise_the_references_value_errors():
    with _plan("qwen", strategy=steps.Strategy(name="zero1")).compile() \
            as s:
        with pytest.raises(ValueError, match="zero1"):
            s.train(steps=1, verbose=False)
    mesh = Mesh(shape={"data": 1, "model": 2},
                coords={"data": 0, "model": 0})
    with pytest.raises(ValueError, match="grad_accum"):
        steps.make_ddp_step(get_config("qwen3-4b", tiny=True),
                            steps.Strategy(grad_accum=2), mesh=mesh)
    with pytest.raises(ValueError, match="in-process dp axes"):
        steps.make_ddp_step(get_config("qwen3-4b", tiny=True),
                            mesh=Mesh(shape={"data": 2, "model": 2}))
