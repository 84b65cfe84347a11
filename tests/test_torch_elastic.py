"""The port's elastic membership (``repro_torch/distrib/runtime.py``,
DESIGN.md §13) over real worker processes: the counterparts of
``tests/test_elastic.py``'s drills, and the dial-in ``--join`` through the
train launcher.

Every drill asserts that the elastic machinery never changes *what* is
computed - the losses stay bit-identical to the static run's - only
*where*.  The backlog steal does not use the reference's wall-clock
backlog (24 naps of 0.1 s racing a join): its tasks wait on a file the
test creates only after the steal it checks has happened.  Everything a
worker runs is a module-level function here, because it crosses the wire
by reference.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from repro_torch.distrib import DistributedGraph, rebalance_plan
from repro_torch.frontend import Plan
from repro_torch.launch import train as train_cli
import torch_threads

torch_threads.apply()

pytestmark = pytest.mark.multiproc

ARCH = "qwen3-4b"
WAIT = 60.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plan(**kw):
    kw.setdefault("arch", ARCH)
    kw.setdefault("batch", 4)
    kw.setdefault("seq", 16)
    return Plan(device="cpu", **kw)


# -- module-level task functions (ship by reference) -------------------------

def ident(i):
    return i


def wait_for_file(path, i, timeout=WAIT):
    """Block until ``path`` exists, then return ``i``: a task whose
    completion the test releases."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.01)
    return i


def _until(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _assert_procs_reaped(pids, timeout=30.0):
    """Every worker pid must be gone soon after close."""
    for pid in pids:
        assert _until(lambda: not _alive(pid), timeout), \
            f"worker pid {pid} still alive after close"


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


class _Churn:
    """Training hook that joins (and optionally kills) localities at fixed
    steps; it drives the driver-side session only."""

    def __init__(self, session, join_at=None, kill_newcomer_at=None,
                 kill_rank_at=None, idle_gap_at=None):
        self.session = session
        self.join_at = join_at
        self.kill_newcomer_at = kill_newcomer_at
        self.kill_rank_at = kill_rank_at or {}   # {step: rank}
        self.idle_gap_at = idle_gap_at
        self.joined_rank = None

    def on_step(self, it, metrics):
        if it == self.idle_gap_at:
            # a device-step-sized stall: the newcomer drains its queue,
            # goes hungry, and the next steerable prefetch build is
            # diverted to it - the deterministic steal window
            time.sleep(0.25)
        if it in self.kill_rank_at:
            # churn both ways in one step: SIGKILL an original member
            # WHILE the join handshake runs
            t = threading.Thread(target=self.session.kill_locality,
                                 args=(self.kill_rank_at[it],))
            t.start()
            self.joined_rank = self.session.add_locality()
            t.join(timeout=WAIT)
            assert not t.is_alive()
            return
        if it == self.join_at:
            self.joined_rank = self.session.add_locality()
        if it == self.kill_newcomer_at:
            self.session.kill_locality(self.joined_rank)


STATIC_STEPS = 12
_STATIC: list = []


def _static_losses(steps):
    """The first ``steps`` losses of the static single-process run (run
    once: a step's loss does not depend on how many steps follow it)."""
    assert steps <= STATIC_STEPS
    if not _STATIC:
        with _plan().compile() as single:
            _STATIC.extend(single.train(steps=STATIC_STEPS, log_every=1,
                                        verbose=False)["losses"])
    return _STATIC[:steps]


def _pids(session):
    return [p.pid for p in session.distributed.group.procs.values()]


# -- join mid-train: the static run's losses, and real steals ---------------

def test_join_mid_train_matches_static_run_and_steals():
    """An elastic session that starts alone and gains a locality at step
    3 gives the static run's losses bit for bit, and the newcomer really
    took work (``stolen_tasks > 0``, builds dispatched to it)."""
    steps = 12
    with _plan(elastic=True).compile() as ses:
        hooks = _Churn(ses, join_at=3, idle_gap_at=7)
        out = ses.train(steps=steps, log_every=1, hooks=hooks, verbose=False)
        dstats = out["runtime_stats"]["distributed"]
        pids = _pids(ses)
    assert hooks.joined_rank == 1
    assert out["losses"] == _static_losses(steps)
    assert dstats["joined_localities"] == 1
    assert dstats["membership_gen"] >= 1
    assert dstats["stolen_tasks"] > 0
    assert dstats["dispatched"].get(1, 0) > 0    # work really landed there
    _assert_procs_reaped(pids)


def test_join_then_kill_newcomer_train_survives():
    """A joiner that dies mid-run costs nothing: its in-flight builds
    re-spawn and the losses are untouched."""
    steps = 10
    with _plan(elastic=True).compile() as ses:
        hooks = _Churn(ses, join_at=2, kill_newcomer_at=6)
        out = ses.train(steps=steps, log_every=1, hooks=hooks, verbose=False)
        dstats = out["runtime_stats"]["distributed"]
        pids = _pids(ses)
    assert out["losses"] == _static_losses(steps)
    assert dstats["joined_localities"] == 1
    assert dstats["alive_workers"] == []         # the kill really landed
    assert dstats["membership_gen"] >= 2         # one join, one loss
    _assert_procs_reaped(pids)


def test_simultaneous_join_and_kill_original_peer():
    """At one step an ORIGINAL worker is SIGKILLed while a newcomer's join
    handshake is in flight: both events land (generation-keyed gossip),
    the newcomer is the only live worker, and the losses are the static
    run's."""
    steps = 10
    with _plan(localities=2, elastic=True).compile() as ses:
        hooks = _Churn(ses, kill_rank_at={4: 1})
        out = ses.train(steps=steps, log_every=1, hooks=hooks, verbose=False)
        dstats = out["runtime_stats"]["distributed"]
        pids = _pids(ses)
    assert hooks.joined_rank == 2
    assert out["losses"] == _static_losses(steps)
    assert dstats["alive_workers"] == [2]        # newcomer in, original out
    assert dstats["membership_gen"] >= 2
    assert dstats["joined_localities"] == 1
    _assert_procs_reaped(pids)


# -- steal modes on a bare DistributedGraph ----------------------------------

def test_backlog_steal_after_join_spares_pinned_tasks(tmp_path):
    """Victim-lease stealing without a wall-clock race: worker 1's two
    threads block on a file and the rest of its steerable tasks queue
    behind them; a joiner leases one of the queued tasks (the file is
    created only after the steal is counted).  Tasks pinned with
    ``locality=`` are never leased: the victim refuses them, and every
    pinned task runs where it was pinned."""
    release, release_pinned = tmp_path / "go", tmp_path / "go-pinned"
    n = 8
    g = DistributedGraph(localities=2, elastic=True, name="backlog")
    try:
        futs = [g.defer(wait_for_file, str(release), i, name=f"p{i}")
                for i in range(n)]
        assert _until(lambda: g.stats()["dispatched"].get(1, 0) == n)
        # worker 1, idle at start-up, may have been handed the first
        # dispatch as a parked thief: count the steals after the join
        stolen0 = g.stats()["stolen_tasks"]
        rank = g.add_locality(timeout=WAIT)
        # every task is already on worker 1: only a lease brings one here
        assert _until(lambda: g.stats()["dispatched"].get(rank, 0) > 0)
        release.touch()
        assert [f.result(timeout=WAIT) for f in futs] == list(range(n))
        s = g.stats()
        leases = s["stolen_tasks"] - stolen0
        assert leases > 0
        # a leased task is dispatched twice: to its victim, then its thief
        assert s["dispatched"][1] + s["dispatched"][rank] == n + leases

        g.stolen_tasks = 0
        before = dict(g.stats()["dispatched"])
        futs = [g.defer(wait_for_file, str(release_pinned), i,
                        name=f"q{i}", locality=1) for i in range(n)]
        assert _until(lambda: g.stats()["dispatched"][1]
                      == before[1] + n)
        # the victim side: a lease on worker 1 finds nothing to claim
        assert g.endpoint.request(1, "steal_lease",
                                  {"thief": rank, "gen": g.group.gen},
                                  timeout=WAIT) == 0
        # the driver side: worker 1 is no victim, so the hungry joiner
        # is parked rather than handed a pinned task
        assert _until(lambda: rank in g._hungry)
        release_pinned.touch()
        assert [f.result(timeout=WAIT) for f in futs] == list(range(n))
        assert g.stolen_tasks == 0
        assert g.stats()["dispatched"].get(rank, 0) \
            == before.get(rank, 0)
    finally:
        g.shutdown()


def test_rebalance_migrates_objects_and_stale_refs_still_resolve():
    """AGAS rebalance at a join: pinned driver objects migrate to the
    newcomer behind forwarding stubs; every stale ``RemoteRef`` held from
    before the join still dereferences to the same value."""
    g = DistributedGraph(localities=1, elastic=True, name="rebalance")
    try:
        refs = [g.defer(ident, i, name=f"m{i}", pin=True).result(timeout=WAIT)
                for i in range(10)]
        assert all(r.owner == 0 for r in refs)
        rank = g.add_locality(timeout=WAIT)
        s = g.stats()
        moved = rebalance_plan(list(range(10)), 0, [rank])[rank]
        assert s["migrated_objects"] == len(moved) == 5
        for i, ref in enumerate(refs):           # stale gids: stub-chased
            assert g.fetch(ref, timeout=WAIT) == i
        audit = g.directory.audit()
        assert audit["migrated"] == 5 and audit["forwarded_fetches"] == 5
        assert g.remote_stats(rank, timeout=WAIT)["directory_objects"] == 5
        # freeing a migrated gid frees the value on its new owner
        g.directory.free(refs[moved[0]])
        assert _until(lambda: g.remote_stats(
            rank, timeout=WAIT)["directory_objects"] == 4)
    finally:
        g.shutdown()


@pytest.mark.parametrize("n, owner, newcomers", [
    (10, 0, [1]), (7, 0, [1, 2]), (2, 1, [2, 3, 4]), (0, 0, [1]),
    (13, 2, [5, 3])])
def test_rebalance_plan_equals_the_reference(n, owner, newcomers):
    """The port's ``rebalance_plan`` is the reference's on the same
    inputs (non-contiguous live indices, as a directory with frees has)."""
    from repro.distrib import rebalance_plan as jax_rebalance_plan

    indices = [3 * i + 1 for i in range(n)][::-1]
    assert rebalance_plan(indices, owner, newcomers) \
        == jax_rebalance_plan(indices, owner, newcomers)


# -- the dial-in join through the train launcher ----------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_join_dials_into_an_elastic_driver(tmp_path):
    """``launch.train --elastic --elastic-port P --expect-joins 1
    --stall-at-step K`` on this process and ``launch.train --join
    127.0.0.1:P`` in another: the dial-in becomes locality 1, takes
    prefetch builds, the losses are the static run's, and the joiner
    exits when the driver's run ends."""
    port, steps = _free_port(), 8
    stats = tmp_path / "stats.json"
    args = train_cli.parser().parse_args([
        "--device", "cpu", "--steps", str(steps), "--batch", "4",
        "--seq", "16", "--log-every", "1", "--elastic", "--elastic-port",
        str(port), "--expect-joins", "1", "--stall-at-step", "4",
        "--stats-out", str(stats)])
    result = {}
    driver = threading.Thread(
        target=lambda: result.update(out=train_cli.run(args)))
    driver.start()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    joiner = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--join",
         f"127.0.0.1:{port}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        driver.join(timeout=180)
        assert not driver.is_alive()
        text, _ = joiner.communicate(timeout=WAIT)
    finally:
        if joiner.poll() is None:
            joiner.kill()
    assert joiner.returncode == 0, text
    assert "served as elastic locality 1" in text
    out = result["out"]
    d = out["runtime_stats"]["distributed"]
    assert out["losses"] == _static_losses(steps)
    assert d["joined_localities"] == 1 and d["dispatched"].get(1, 0) > 0
    import json
    saved = json.loads(stats.read_text())
    assert saved["distributed"]["joined_localities"] == 1
    assert saved["losses"] == out["losses"]
