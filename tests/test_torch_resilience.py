"""Step resilience (``core/resilience.py``) and mesh sessions
(``Plan(data=2)``: ``Session.train`` over a world of rank processes)
against the JAX package's.

* the reference's ``tests/test_resilience.py`` cases, on the port's
  ``ResilientRunner`` (replay, replicate with checksum majority, the
  validate fallback, a consensus function, checksums, the straggler
  cadence);
* ``Plan(data=2, strategy=s).compile().train(...)`` for all four
  strategies, with ``resilience`` none, replay and replicate, a NaN
  injected on one rank only: every mode gives the straight run's losses
  bit for bit, the verdict agreed over the dp group (at data=1 too);
* ``python -m repro_torch.launch.train --data 2 --strategy s`` gives
  ``Plan``'s losses, for each strategy;
* a zero1 mesh checkpoint is the reference's global layout: it restores
  in the reference's ``CheckpointManager`` against its
  ``TrainStep.opt_structs()``, and at data=1 in the port, where the run
  continues as the data=2 run does (within 1e-5: another dp degree sums
  in another order);
* the refusals: a model axis, the production meshes, SPMD mode, fabric
  localities or DDP with a dp axis; serving over a mesh runs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import steps as jax_steps
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro_torch import bridge
from repro_torch.core import steps
from repro_torch.core.resilience import (ResilienceError, ResilientRunner,
                                         StragglerPolicy, finite_check,
                                         tree_checksum)
from repro_torch.frontend import Plan
from repro_torch.frontend.plan import _unsupported, mesh_group
from repro_torch.launch import train as train_cli
from torch_mesh_world import NanOnRank, with_fault_hook
import torch_threads

torch_threads.apply()

STRATEGIES = ("phylanx", "horovod", "zero1", "onebit")
STEPS = 3
KW = dict(log_every=1, verbose=False)


# -- the reference's cases -------------------------------------------------------
class Flaky:
    """Injects corruption on the first n calls (the fault_hook seam)."""

    def __init__(self, n_bad: int, kind: str = "nan"):
        self.n_bad, self.calls, self.kind = n_bad, 0, kind

    def __call__(self, out):
        self.calls += 1
        if self.calls <= self.n_bad:
            if self.kind == "nan":
                return {"y": out["y"] * float("nan")}
            return {"y": out["y"] + 1.0}   # silent bit-flip style corruption
        return out


def _step(x):
    return {"y": x * 2.0}


def test_replay_recovers_from_transient_corruption():
    r = ResilientRunner(_step, fault_hook=Flaky(2))
    out = r.replay(torch.ones(3), max_retries=3)
    np.testing.assert_allclose(out["y"].numpy(), 2.0)
    assert r.stats["replays"] == 2


def test_replay_gives_up_on_persistent_corruption():
    r = ResilientRunner(_step, fault_hook=Flaky(100))
    with pytest.raises(ResilienceError):
        r.replay(torch.ones(3), max_retries=2)


def test_replicate_majority_vote_beats_one_silent_corruption():
    r = ResilientRunner(_step, fault_hook=Flaky(1, kind="flip"))
    out = r.replicate(torch.ones(3), n=3)
    np.testing.assert_allclose(out["y"].numpy(), 2.0)


def test_replicate_falls_back_to_validate():
    class EachDifferent:
        calls = 0

        def __call__(self, out):
            self.calls += 1
            if self.calls < 3:
                bad = out["y"] * self.calls
                bad[0] = float("nan")
                return {"y": bad}
            return out
    r = ResilientRunner(_step, fault_hook=EachDifferent())
    out = r.replicate(torch.ones(3), n=3)
    assert finite_check(out)


def test_consensus_function_is_used():
    r = ResilientRunner(_step, consensus=lambda results: results[-1])
    out = r.replicate(torch.ones(3), n=2)
    np.testing.assert_allclose(out["y"].numpy(), 2.0)


def test_checksum_stable_and_sensitive():
    t = {"a": torch.arange(4.0)}
    assert tree_checksum(t) == tree_checksum({"a": torch.arange(4.0)})
    assert tree_checksum(t) != tree_checksum({"a": torch.arange(4.0) + 1e-7})


def test_straggler_policy_no_sync_cadence():
    p = StragglerPolicy(accumulate_local_steps=4)
    assert [p.sync_this_step(i) for i in range(8)] == \
        [False, False, False, True] * 2
    assert StragglerPolicy().sync_this_step(0)


# -- mesh sessions ---------------------------------------------------------------
def _plan(**kw):
    return Plan(batch=4, seq=16, device="cpu", **kw)


@pytest.fixture(scope="module")
def mesh_runs():
    """For each strategy, one ``Plan(data=2)`` session: the straight run,
    then replay and replicate with a NaN on rank 1's first result; and
    one data=1 session doing the same with the NaN on rank 0."""
    torch_threads.apply()
    out = {}
    for name in STRATEGIES:
        with _plan(data=2, strategy=name).compile() as s:
            runs = {"none": s.train(steps=STEPS, **KW)}
            for mode in ("replay", "replicate"):
                with_fault_hook(s, NanOnRank(1))
                runs[mode] = s.train(steps=STEPS, resilience=mode, **KW)
        out[name, 2] = runs
    with _plan().compile() as s:
        runs = {"none": s.train(steps=STEPS, **KW)}
        for mode in ("replay", "replicate"):
            with_fault_hook(s, NanOnRank(0))
            runs[mode] = s.train(steps=STEPS, resilience=mode, **KW)
    out["phylanx", 1] = runs
    return out


@pytest.mark.parametrize("mode", ["replay", "replicate"])
@pytest.mark.parametrize("case", [(s, 2) for s in STRATEGIES]
                         + [("phylanx", 1)], ids=lambda c: f"{c[0]}@{c[1]}")
def test_session_resilience_recovers_a_fault_on_one_rank(mesh_runs, case,
                                                         mode):
    runs = mesh_runs[case]
    straight, got = runs["none"], runs[mode]
    assert len(straight["losses"]) == STEPS
    assert got["losses"] == straight["losses"]
    for a, b in zip(torch.utils._pytree.tree_leaves(got["params"]),
                    torch.utils._pytree.tree_leaves(straight["params"])):
        assert torch.equal(a, b)
    st = got["resilience"]
    if mode == "replay":
        # the first step replayed once, on every rank of the mesh
        assert st["replays"] == 1
        if case[1] == 2:
            assert got["localities"][1]["resilience"]["replays"] == 1
    else:
        assert st["replicas"] == 2 * STEPS
    # the runner's input copies: the train state, once a replica or try
    assert st["copies"]["calls"] == (STEPS + 1 if mode == "replay"
                                     else 2 * STEPS)


@pytest.mark.parametrize("name", STRATEGIES)
def test_train_cli_mesh_gives_the_plans_losses(mesh_runs, name):
    out = train_cli.run(train_cli.parser().parse_args(
        ["--device", "cpu", "--data", "2", "--strategy", name,
         "--steps", str(STEPS), "--batch", "4", "--seq", "16",
         "--log-every", "1"]))
    assert out["losses"] == mesh_runs[name, 2]["none"]["losses"]


def test_zero1_checkpoint_is_the_references_global_layout(tmp_path):
    """Saved by a data=2 zero1 run: restores in the reference's manager
    against its ``TrainStep.opt_structs()`` (whole m and v), and at
    data=1 in the port, where the run goes on as the data=2 run does."""
    d = str(tmp_path / "ck")
    with _plan(data=2, strategy="zero1").compile() as s:
        saved = s.train(steps=4, ckpt_every=2, ckpt_dir=d, **KW)
        longer = s.train(steps=6, **KW)
    shape = {"seq_len": 16, "global_batch": 4, "kind": "train"}
    jstep = jax_steps.make_train_step(
        jax_get_config("qwen3-4b", tiny=True), jax_local_mesh(),
        jax_steps.Strategy(name="zero1"), shape)
    step_no, (jparams, jopt) = JaxManager(d).restore(
        (jstep.param_structs(), jstep.opt_structs()))
    assert step_no == 4 and int(jopt["count"]) == 4
    want = bridge.tree_to_numpy(saved["params"])
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for leaf, sp in zip(jax.tree.leaves(jopt["m"]),
                        jax.tree.leaves(jstep.opt_structs()["m"])):
        assert leaf.shape == sp.shape and np.isfinite(leaf).all()
    assert any(np.abs(np.asarray(x)).sum() > 0
               for x in jax.tree.leaves(jopt["v"]))
    with _plan(strategy="zero1").compile() as s:
        resumed = s.train(steps=6, ckpt_dir=d, ckpt_every=2, resume=True,
                          **KW)
    np.testing.assert_allclose(resumed["losses"], longer["losses"][4:],
                               rtol=1e-5)


def test_bridge_carries_the_references_zero1_state_into_rank_shards():
    """A global zero1 state cut into a one-rank step's layout holds the
    whole leaves, flattened in the reference's leaf order."""
    step = steps.make_train_step(Plan(device="cpu").config(),
                                 steps.Strategy(name="zero1"))
    structs = step.opt_structs()
    rng = np.random.default_rng(0)
    tree = {"count": np.int32(3),
            "m": bridge.tree_to_numpy(torch.utils._pytree.tree_map(
                lambda sp: torch.from_numpy(rng.standard_normal(
                    sp.shape).astype(np.float32)), structs["m"],
                is_leaf=lambda x: hasattr(x, "dims"))),
            "v": bridge.tree_to_numpy(torch.utils._pytree.tree_map(
                lambda sp: torch.zeros(sp.shape), structs["v"],
                is_leaf=lambda x: hasattr(x, "dims")))}
    local = bridge.opt_state_from_numpy(tree, step, "cpu")
    assert int(local["count"]) == 3
    flat = np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree["m"])])
    np.testing.assert_array_equal(
        torch.cat([m for m in local["m"]]).numpy(), flat)
    back = step.gather_opt(local)
    np.testing.assert_array_equal(
        np.concatenate([np.ravel(x) for x in jax.tree.leaves(
            bridge.tree_to_numpy(back["m"]))]), flat)


@pytest.mark.parametrize("kw, exc, match", [
    # the model axis runs every strategy, beside fabric DDP too, and a
    # mesh runs beside SPMD mode, fabric localities and elastic
    # membership (item 14b, part 6: exc None, each with its layout of
    # mesh worlds); the production meshes and a dp axis beside fabric
    # DDP stay refused
    (dict(model=2, strategy="onebit", ddp=True), None, (1, 2)),
    (dict(mesh="single"), NotImplementedError, "item 15"),
    (dict(mesh="multipod"), NotImplementedError, "item 15"),
    (dict(data=2, spmd=True, localities=2), None, (2, 2)),
    (dict(data=2, localities=2), None, (1, 2)),
    (dict(data=2, elastic=True), None, (1, 2)),
    (dict(data=2, ddp=True), ValueError, "replaces the in-process dp axes"),
], ids=["model", "single", "multipod", "spmd", "localities", "elastic",
        "ddp"])
def test_mesh_refusals(kw, exc, match):
    """Each plan raises what it raises; the plans item 14b's part 6 runs
    compile with their layout and take one step under the resilience
    modes the reference lets them have: step replay beside task
    localities and joiners, none in SPMD mode or beside fabric DDP,
    which refuse it with the reference's ``ValueError``."""
    if exc is None:
        plan = _plan(**kw)
        assert _unsupported(plan) is None
        assert mesh_group(plan) == match
        mode = "none" if plan.spmd or plan.ddp else "replay"
        torch_threads.apply(torch_threads.RANK)
        with plan.compile() as s:
            if mode == "none":
                with pytest.raises(ValueError, match="resilience"):
                    s.train(steps=1, resilience="replay", verbose=False)
            out = s.train(steps=1, resilience=mode, log_every=1,
                          verbose=False)
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
        if mode == "replay":
            assert out["resilience"]["replays"] == 0
        return
    with pytest.raises(exc, match=match):
        _plan(**kw).compile()


def test_serving_over_a_mesh_is_refused():
    """Serving over a mesh with data axes is no longer refused (ROADMAP
    item 14b, part 3): at data=2 the single stream, whose cache is tiled
    by sequence over the dp group, and the gateway over the two rank
    processes give one process's tokens.  What stays refused here is
    fabric DDP beside a dp axis."""
    kw = dict(requests=2, prompt_len=4, gen_len=2, slots=1, verbose=False)
    with _plan().compile() as s:
        want = s.serve(**kw)
        want_stream = s.serve_stream(**kw)
    with _plan(data=2).compile() as s:
        got = s.serve(**kw)
        got_stream = s.serve_stream(**kw)
    assert [g.tolist() for g in got["generated"]] == \
        [g.tolist() for g in want["generated"]]
    assert got["localities"][1]["cache_shapes"][0][1] == 3   # 6 / 2
    assert got_stream["streams"] == want_stream["streams"]
    assert got_stream["completed"] == 2
    with pytest.raises(ValueError, match="replaces the in-process dp"):
        steps.make_ddp_step(Plan(device="cpu").config(), steps.Strategy(),
                            mesh=type("M", (), {"shape": {"data": 2,
                                                          "model": 1}})())
