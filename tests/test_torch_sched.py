"""The port's gang scheduler against the JAX package's
(``veles_tpu/sched/``), on the CPU.

* The job FSM (its table, the moves it refuses, the ``veles_sched_*``
  families each move counts, under JAX's names), ``JobSpec`` (its dict
  read by either package, its argv JAX's but for the module name),
  ``DevicePool``'s best fit over a random sequence against JAX's pool.
* The journal: a journal written by the port's scheduler recovers in
  JAX's, and one written by JAX's in the port's, the same jobs to the
  record, a live gang adopted (same pid) in both directions; the torn
  tail and compaction.
* Scheduling with stub gangs (no step is timed by sleeping: a stub that
  must outlive a tick blocks on a FIFO the test releases, time moves
  through ``tick(now=...)``, and tests poll states): placement and reaping, the
  elastic env of a gang, preemption of an over-share victim, the thrash
  guard, recovery by adoption and the retry budget with its crash loop,
  the flight record of a failed job, a gang's telemetry push (the
  port's and a JAX worker's) federated under ``{job, tenant}``.
* The control endpoint through the CLI: ``submit --wait``, ``status``
  (table and JSON), a bad submit's 400, the 503 with ``Retry-After``
  while the scheduler recovers, and the status push to a local stub (a
  push happens only when a URL is given).
* Preemption and resume of the port's ``worker-demo -a cpu``: the
  preempted job's validation curve equals the uninterrupted run's, every
  value; the research job is stopped (SIGSTOP) once its first generation
  committed, so the preemption lands before it could finish.
* Scheduled genetics equal serial genetics bit for bit in the port, and
  scheduled ensemble members all train.
"""

import errno
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

torch = pytest.importorskip("torch")

from veles_tpu import sched as jax_sched  # noqa: E402
from veles_tpu.sched import job as jax_job  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.genetics import GeneticsOptimizer, Tune  # noqa: E402
from veles_tpu_torch.sched import (DONE, FAILED, PENDING,  # noqa: E402
                                   PREEMPTED, RETRYING, RUNNING,
                                   DevicePool, Job, JobJournal, JobSpec,
                                   ScheduledEnsembleTrainManager,
                                   ScheduledGeneticsOptimizer, Scheduler,
                                   SchedulerControl)
from veles_tpu_torch.sched import job as port_job  # noqa: E402
from veles_tpu_torch.sched.job import InvalidTransition  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_S = 240

#: stub gang members: one that ends at once, one that fails (a third,
#: :func:`_pause`, waits until the test releases it)
QUICK = [sys.executable, "-c", "pass"]
CRASH = [sys.executable, "-c", "import sys; sys.exit(3)"]


def _pause(tmp_path, name):
    """A stub gang member that blocks reading its own FIFO ``tmp_path /
    release-<name>`` until :func:`_release` releases ``name`` (then
    exits 0); the scheduler's SIGKILL ends it too."""
    fifo = str(tmp_path / ("release-" + name))
    if not os.path.exists(fifo):
        os.mkfifo(fifo)
    return [sys.executable, "-c", "open(%r).read()" % fifo]


def _release(tmp_path, name, timeout_s=PROC_S):
    """Release the ``_pause`` member ``name`` whenever its reader opens
    the FIFO, now or later: a thread retries a non-blocking open for
    writing (refused until a reader holds the FIFO open, or waits in its
    open) and closes it at once, so the reader's read ends. Returns the
    thread."""
    fifo = str(tmp_path / ("release-" + name))

    def release():
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if e.errno != errno.ENXIO:   # ENXIO: no reader yet
                    raise
                time.sleep(0.01)
                continue
            os.close(fd)
            return

    thread = threading.Thread(target=release, daemon=True)
    thread.start()
    return thread


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(extra)
    return env


def _poll(predicate, timeout_s=120.0, poll_s=0.02, tick=None):
    """Poll ``predicate`` (ticking ``tick``, a scheduler, before each
    look) until it holds."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if tick is not None:
            tick.tick()
        if predicate():
            return
        time.sleep(poll_s)
    raise AssertionError("condition not reached in %.0f s" % timeout_s)


def _kill(job):
    for proc in job.procs:
        proc.kill()
        proc.wait()


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("VELES_FLIGHT_DIR", str(tmp_path / "flight"))


# -- the FSM and the job ------------------------------------------------------


def test_fsm_table_equals_jax():
    assert port_job.STATES == jax_job.STATES
    assert port_job.TRANSITIONS == jax_job.TRANSITIONS


def test_fsm_full_path_and_refusals():
    job = Job(JobSpec(argv=QUICK, tenant="t0"))
    assert job.state == PENDING and job.runnable and not job.terminal
    with pytest.raises(InvalidTransition):
        job.transition(DONE)
    job.transition(RUNNING)
    job.transition(PREEMPTED)
    job.transition(RUNNING)
    assert job.preempt_resume_s >= 0.0
    job.transition(RETRYING)
    assert job.retries == 1
    job.transition(RUNNING)
    job.transition(DONE)
    for state in (RUNNING, PREEMPTED, FAILED, RETRYING):
        with pytest.raises(InvalidTransition):
            job.transition(state)
    assert [s for _, s in job.history] == [
        PENDING, RUNNING, PREEMPTED, RUNNING, RETRYING, RUNNING, DONE]


def test_metric_families_carry_jax_s_names():
    ours, theirs = port_job._metrics(), jax_job._metrics()
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert (ours[key].name, tuple(ours[key].label_names)) == (
            theirs[key].name, tuple(theirs[key].label_names))


def test_transitions_are_counted():
    from veles_tpu_torch.telemetry.registry import get_registry
    port_job._metrics()
    reg = get_registry()
    trans = reg.get("veles_sched_transitions_total")
    totals = reg.get("veles_sched_jobs_total")
    preempts = reg.get("veles_sched_preemptions_total")
    before = (trans.labels(tenant="metered", to=RUNNING).value,
              totals.labels(tenant="metered", state=DONE).value,
              preempts.labels(tenant="metered").value)
    job = Job(JobSpec(argv=QUICK, tenant="metered"))
    for state in (RUNNING, PREEMPTED, RUNNING, DONE):
        job.transition(state)
    assert (trans.labels(tenant="metered", to=RUNNING).value,
            totals.labels(tenant="metered", state=DONE).value,
            preempts.labels(tenant="metered").value) == (
                before[0] + 2, before[1] + 1, before[2] + 1)


def test_jobspec_argv_is_jax_s_but_the_module():
    kwargs = dict(workflow="wf.py", config="cfg.py",
                  overrides={"root.a.lr": 0.5, "root.b": True},
                  result_file="/tmp/r.json", seed=7,
                  extra_argv=["--dry-run", "exec"])
    got = JobSpec(**kwargs).build_argv(python="PY")
    want = jax_sched.JobSpec(**kwargs).build_argv(python="PY")
    assert got[:3] == ["PY", "-m", "veles_tpu_torch"]
    assert got[3:] == want[3:] == [
        "wf.py", "cfg.py", "root.a.lr=0.5", "root.b=True", "--result-file",
        "/tmp/r.json", "-s", "7", "-v", "warning", "--dry-run", "exec"]
    assert JobSpec(argv=["/bin/true", "x"]).build_argv() == ["/bin/true",
                                                             "x"]


@pytest.mark.parametrize("bad", [
    {}, {"argv": QUICK, "workflow": "wf.py"}, {"argv": QUICK, "qos": "gold"},
    {"argv": QUICK, "world_min": 0}, {"argv": QUICK, "world_min": 3,
                                      "world_max": 2},
    {"argv": QUICK, "max_retries": -1},
    {"argv": QUICK, "retry_backoff_s": -0.5}])
def test_jobspec_refusals_equal_jax(bad):
    with pytest.raises(ValueError):
        JobSpec(**bad)
    with pytest.raises(ValueError):
        jax_sched.JobSpec(**bad)


def test_jobspec_dict_round_trips_through_both_packages():
    spec = JobSpec(workflow="wf.py", tenant="research", qos="interactive",
                   weight=2.0, world_min=2, world_max=4,
                   snapshot_dir="/tmp/snaps", max_retries=3,
                   retry_backoff_s=0.25, env={"A": "1"})
    theirs = jax_sched.JobSpec.from_dict(spec.to_dict())
    assert theirs.to_dict() == spec.to_dict()
    assert JobSpec.from_dict(theirs.to_dict()).to_dict() == spec.to_dict()
    with pytest.raises(ValueError, match="unknown"):
        JobSpec.from_dict({"argv": QUICK, "priority": 9})


def test_job_record_round_trips():
    job = Job(JobSpec(argv=["stub"], tenant="acme", max_retries=2,
                      snapshot_dir="/tmp/snaps"))
    job.transition(RUNNING)
    job.slots, job.granted_world, job.pids = (2, 3), 2, (4242, 4243)
    job.transition(PREEMPTED)
    again = Job.from_record(job.record())
    assert again.record() == job.record()
    theirs = jax_sched.Job.from_record(job.record())
    assert theirs.record() == job.record()
    bad = job.record()
    bad["state"] = "zombie"
    with pytest.raises(ValueError, match="unknown state"):
        Job.from_record(bad)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pool_best_fit_equals_jax(seed):
    """A random sequence of grants and releases: every grant, hole and
    count of the port's pool equals JAX's."""
    rng = random.Random(seed)
    ours, theirs = DevicePool(16), jax_sched.DevicePool(16)
    held = []
    for step in range(200):
        if held and rng.random() < 0.45:
            name = held.pop(rng.randrange(len(held)))
            ours.release(name)
            theirs.release(name)
        else:
            name, want = "j%d" % step, rng.randint(1, 6)
            got = ours.allocate(name, want)
            assert got == theirs.allocate(name, want)
            if got is not None:
                held.append(name)
        assert ours.holes() == theirs.holes()
        assert (ours.free, ours.held) == (theirs.free, theirs.held)


def test_pool_hold_refuses_a_disagreeing_journal():
    pool = DevicePool(8)
    assert pool.hold("job-1", 0, 3) == (0, 1, 2)
    for start, n, message in ((2, 2, "overlaps"), (7, 2, "outside"),
                              (-1, 1, "outside")):
        with pytest.raises(ValueError, match=message):
            pool.hold("job-3", start, n)
    with pytest.raises(ValueError, match="already holds"):
        pool.hold("job-1", 6, 1)


# -- the journal --------------------------------------------------------------


def test_journal_torn_tail_and_compaction(tmp_path):
    journal = JobJournal(str(tmp_path), max_bytes=16)
    journal.append({"ev": "submit", "n": 1})
    journal.append({"ev": "grant", "n": 2})
    with open(journal.journal_path, "a", encoding="utf-8") as f:
        f.write('{"ev": "rea')
    for cls in (JobJournal, jax_sched.JobJournal):
        image, events = cls(str(tmp_path)).replay()
        assert image is None and [e["n"] for e in events] == [1, 2]
    assert journal.should_compact()
    journal.compact({"jobs": [{"id": "job-1"}]})
    for cls in (JobJournal, jax_sched.JobJournal):
        assert cls(str(tmp_path)).replay() == ({"jobs": [{"id": "job-1"}]},
                                               [])
    with open(journal.snapshot_path, "w", encoding="utf-8") as f:
        f.write("{half a json object")
    journal.append({"ev": "submit", "n": 3})
    image, events = JobJournal(str(tmp_path)).replay()
    assert image is None and [e["n"] for e in events] == [3]
    journal.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    """One package's scheduler journals a live gang, a queued job and a
    finished one, then dies; the other package's recovers the same jobs
    to the record and adopts the live gang in place (same pid)."""
    first_cls, second_cls = (Scheduler, jax_sched.Scheduler) \
        if writer == "port" else (jax_sched.Scheduler, Scheduler)
    spec_cls = JobSpec if writer == "port" else jax_sched.JobSpec
    state = str(tmp_path / "state")
    first = first_cls(1, preempt=False, state_dir=state)
    first.recover()
    t0 = time.time()
    live = first.submit(spec_cls(argv=_pause(tmp_path, "live"),
                                 tenant="a"), now=t0)
    queued = first.submit(spec_cls(argv=QUICK, tenant="b"), now=t0)
    first.tick(now=t0)
    assert live.state == RUNNING and queued.state == PENDING
    records = {j.id: j.record() for j in first.jobs()}
    first._journal.close()
    second = second_cls(1, preempt=False, state_dir=state)
    try:
        second.recover()
        got = {j.id: j.record() for j in second.jobs()}
        assert got == records
        survivor = second.get(live.id)
        assert survivor.pids == live.pids
        assert survivor.procs[0].poll() is None
        assert second.pool.holes() == []
    finally:
        _release(tmp_path, "live")
    _poll(lambda: second.get(live.id).state == DONE, tick=second)
    _poll(lambda: second.get(queued.id).terminal, tick=second)
    assert second.get(queued.id).state == DONE
    second.stop()


# -- scheduling with stub gangs -----------------------------------------------


def test_places_runs_and_reaps():
    sched = Scheduler(2, preempt=False)
    job = sched.submit(JobSpec(argv=QUICK, name="noop"))
    sched.tick()
    assert job.state == RUNNING and sched.pool.held == 1
    _poll(lambda: job.terminal, tick=sched)
    assert job.state == DONE and sched.pool.held == 0
    assert sched.stats()["tenants"]["default"]["granted"] == 1
    with pytest.raises(ValueError, match="pool has 2"):
        sched.submit(JobSpec(argv=QUICK, world_min=3, world_max=3))


def test_gang_gets_the_elastic_env(tmp_path):
    marker = (
        "import os; open(%r + '/' + os.environ['VELES_ELASTIC_RANK'],"
        " 'w').write(os.environ['VELES_ELASTIC_WORLD'] + ':' +"
        " os.environ['VELES_ELASTIC_GEN'] + ':' +"
        " os.environ['VELES_ELASTIC_JOB'] + ':' +"
        " os.environ['VELES_ELASTIC_COORD'])" % str(tmp_path))
    sched = Scheduler(3, preempt=False)
    job = sched.submit(JobSpec(argv=[sys.executable, "-c", marker],
                               world_min=2, world_max=3))
    sched.tick()
    assert job.granted_world == 3
    _poll(lambda: job.terminal, tick=sched)
    assert job.state == DONE
    lines = {open(str(tmp_path / r)).read() for r in ("0", "1", "2")}
    assert len(lines) == 1
    world, gen, job_id, coord = lines.pop().split(":", 3)
    assert (world, gen, job_id) == ("3", "1", job.id)
    assert coord.startswith("127.0.0.1:")


def test_preempts_an_over_share_victim_then_resumes_it(tmp_path):
    sched = Scheduler(1, min_run_s=1.0)
    t0 = time.time()
    victim = sched.submit(JobSpec(argv=_pause(tmp_path, "victim"),
                                  tenant="research",
                                  snapshot_dir=str(tmp_path)), now=t0)
    sched.tick(now=t0)
    claimant = sched.submit(JobSpec(argv=_pause(tmp_path, "claimant"),
                                    tenant="prod"), now=t0 + 0.5)
    sched.tick(now=t0 + 0.5)
    # the thrash guard: the victim has not run min_run_s yet
    assert victim.state == RUNNING and claimant.state == PENDING
    sched.tick(now=t0 + 1.5)
    assert victim.state == PREEMPTED and claimant.state == RUNNING
    sched.tick(now=t0 + 3.0)   # a non-preemptible claimant stays
    assert victim.state == PREEMPTED
    # the restarted victim reads its own FIFO, which stays shut
    _release(tmp_path, "claimant")
    _poll(lambda: victim.state == RUNNING, tick=sched)
    assert claimant.state == DONE and victim.grants == 2
    assert victim.preempt_resume_s is not None
    sched.stop(kill=True)
    assert victim.state == FAILED


def test_release_reaches_a_reader_that_opens_late(tmp_path):
    """A member whose interpreter opens its FIFO only after the release
    was given is still released, within the poll limit."""
    argv = _pause(tmp_path, "late")
    releaser = _release(tmp_path, "late")
    time.sleep(0.2)
    assert releaser.is_alive()   # no reader yet: the release waits
    proc = subprocess.Popen(argv)
    try:
        _poll(lambda: proc.poll() is not None)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    releaser.join(PROC_S)
    assert not releaser.is_alive()


def test_never_preempts_its_own_tenant(tmp_path):
    sched = Scheduler(1, min_run_s=0.0)
    first = sched.submit(JobSpec(argv=_pause(tmp_path, "first"),
                                 tenant="a", snapshot_dir=str(tmp_path)))
    sched.tick()
    second = sched.submit(JobSpec(argv=QUICK, tenant="a"))
    sched.tick(now=time.time() + 5)
    assert first.state == RUNNING and second.state == PENDING
    sched.stop(kill=True)


def test_failed_gang_dumps_a_flight_record(monkeypatch):
    from veles_tpu_torch.telemetry import flight
    dumps = []

    class Recorder(object):
        def dump(self, reason, **context):
            dumps.append((reason, context))

    monkeypatch.setattr(flight, "get_recorder", lambda: Recorder())
    sched = Scheduler(1, preempt=False)
    job = sched.submit(JobSpec(argv=CRASH, name="crasher"))
    _poll(lambda: job.terminal, tick=sched)
    assert job.state == FAILED and "rc=3" in job.error
    assert dumps[0][0] == "sched_job_failed"
    assert dumps[0][1]["trace_id"] == job.trace_id


def test_retry_budget_then_crash_loop(monkeypatch):
    from veles_tpu_torch.telemetry import flight
    monkeypatch.setattr(flight, "get_recorder", lambda: type(
        "R", (), {"dump": lambda self, reason, **kw: None})())
    sched = Scheduler(1, preempt=False, crash_loop_k=3,
                      crash_loop_window_s=3600.0)
    job = sched.submit(JobSpec(argv=CRASH, max_retries=5,
                               retry_backoff_s=0.0))
    _poll(lambda: job.terminal, tick=sched)
    # the third failure inside the window trips the crash loop before
    # the budget of five is spent
    assert job.state == FAILED and "crash loop" in job.error
    assert job.retries == 2 and job.grants == 3


def test_recovery_adopts_live_gangs_and_routes_dead_ones(tmp_path,
                                                         monkeypatch):
    from veles_tpu_torch.telemetry import flight
    from veles_tpu_torch.telemetry.registry import get_registry
    dumps = []
    monkeypatch.setattr(flight, "get_recorder", lambda: type(
        "R", (), {"dump": lambda self, reason, **kw: dumps.append(
            (reason, kw))})())
    state = str(tmp_path / "state")
    first = Scheduler(4, preempt=False, state_dir=state)
    first.recover()
    alive = first.submit(JobSpec(argv=_pause(tmp_path, "alive"),
                                 tenant="a"))
    dead_pre = first.submit(JobSpec(argv=_pause(tmp_path, "pre"),
                                    tenant="b",
                                    snapshot_dir=str(tmp_path / "s")))
    dead_retry = first.submit(JobSpec(argv=_pause(tmp_path, "retry"),
                                      tenant="c", max_retries=2,
                                      retry_backoff_s=0.0))
    dead_fail = first.submit(JobSpec(argv=_pause(tmp_path, "fail"),
                                     tenant="d"))
    first.tick()
    for job in (dead_pre, dead_retry, dead_fail):
        _kill(job)
    first._journal.close()
    adopted = get_registry().get("veles_sched_gangs_adopted_total")
    before = adopted.value
    second = Scheduler(4, preempt=False, state_dir=state)
    assert second.recovering
    second.recover()
    assert not second.recovering and adopted.value == before + 1
    jobs = {j.id: j for j in second.jobs()}
    assert jobs[alive.id].state == RUNNING
    assert jobs[alive.id].pids == alive.pids
    assert jobs[dead_pre.id].state == PREEMPTED
    assert jobs[dead_retry.id].state == RETRYING
    assert jobs[dead_fail.id].state == FAILED
    assert dumps[0][0] == "sched_job_failed"
    newcomer = second.submit(JobSpec(argv=QUICK, tenant="e"))
    assert int(newcomer.id.split("-")[1]) > max(
        int(i.split("-")[1]) for i in jobs)
    second.tick()
    assert jobs[dead_pre.id].state == RUNNING
    assert jobs[dead_pre.id].grants == 2
    # the adopted gang alone: the restarted dead_pre stays blocked
    _release(tmp_path, "alive")
    _poll(lambda: jobs[alive.id].state == DONE, tick=second)
    second.stop(kill=True)


def _worker_delta(**gauges):
    """One rank-0 push: what the gang's metrics pusher POSTs."""
    from veles_tpu_torch.telemetry.federation import SnapshotEncoder
    from veles_tpu_torch.telemetry.registry import MetricsRegistry
    reg = MetricsRegistry()
    for name, value in gauges.items():
        reg.gauge("veles_" + name).set(value)
    return SnapshotEncoder(registry=reg).encode()


def test_federates_a_gang_s_telemetry(tmp_path):
    """A gang's pushed registry delta (a JAX worker's push too) reaches
    the scheduler's cluster snapshot under ``{job, tenant}``, the
    ``/jobs.json`` row and the history; a job that ends drops its
    view."""
    from veles_tpu.telemetry.federation import \
        SnapshotEncoder as JaxSnapshotEncoder
    from veles_tpu.telemetry.registry import \
        MetricsRegistry as JaxMetricsRegistry
    from veles_tpu_torch.telemetry.registry import render_snapshot
    from veles_tpu_torch.telemetry.timeseries import get_history
    sched = Scheduler(2, preempt=False)
    ours = sched.submit(JobSpec(argv=_pause(tmp_path, "ours"),
                                tenant="acme"))
    theirs = sched.submit(JobSpec(argv=_pause(tmp_path, "theirs"),
                                  tenant="zeta"))
    sched.tick()
    assert sched.absorb_telemetry(ours.id, _worker_delta(
        train_loss=0.42, train_samples_per_s=100.0, step_mfu=0.71)) == {}
    reg = JaxMetricsRegistry()
    reg.gauge("veles_train_loss").set(0.25)
    sched.absorb_telemetry(theirs.id, JaxSnapshotEncoder(
        registry=reg).encode())
    sched.tick()
    rows = {j["id"]: j for j in sched.jobs_report()["jobs"]}
    assert rows[ours.id]["metrics"]["loss"] == 0.42
    assert rows[ours.id]["metrics"]["mfu"] == 0.71
    assert rows[theirs.id]["metrics"]["loss"] == 0.25
    text = render_snapshot(sched.cluster_snapshot())
    assert ('veles_sched_job_loss{job="%s",tenant="acme"} 0.42'
            % ours.id) in text
    assert ('veles_train_loss{job="%s",tenant="acme"} 0.42'
            % ours.id) in text
    points = [e for e in get_history().query(
        series="veles_sched_job_loss")["series"]
        if e["labels"].get("job") == ours.id]
    assert points and points[0]["points"]
    assert sched.absorb_telemetry("job-nope", _worker_delta(
        train_loss=1.0)) == {}
    sched.stop(kill=True)
    assert ('job="%s"' % ours.id) not in render_snapshot(
        sched.cluster_snapshot())


# -- the control endpoint and the CLI -----------------------------------------


def test_control_endpoint_and_cli_clients(capsys):
    from veles_tpu_torch.sched.cli import sched_main
    sched = Scheduler(1, tick_s=0.02, preempt=False).start()
    control = SchedulerControl(sched).start()
    addr = "127.0.0.1:%d" % control.port
    try:
        bad = urllib.request.Request(
            "http://%s/submit" % addr,
            data=json.dumps({"argv": QUICK, "priority": 9}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=10)
        assert err.value.code == 400
        assert sched_main(["submit", "--addr", addr, "--name", "noop",
                           "--tenant", "cli", "--wait", "--"] + QUICK) == 0
        out = capsys.readouterr().out
        assert "job-" in out and "done" in out
        assert sched_main(["status", "--addr", addr]) == 0
        table = capsys.readouterr().out
        assert "pool: 1 slots" in table and "tenant cli" in table
        assert sched_main(["status", "--addr", addr, "--json"]) == 0
        blob = json.loads(capsys.readouterr().out)
        assert blob["status"]["pool"]["size"] == 1
        assert blob["jobs"][0]["state"] == "done"
        with urllib.request.urlopen("http://%s/metrics" % addr,
                                    timeout=10) as resp:
            assert "veles_sched_jobs_total" in resp.read().decode()
    finally:
        control.stop()
        sched.stop()


def test_control_replies_503_while_recovering(tmp_path):
    sched = Scheduler(1, preempt=False, state_dir=str(tmp_path))
    control = SchedulerControl(sched).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen("http://127.0.0.1:%d/status"
                                   % control.port, timeout=10)
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "1"
        sched.recover()
        with urllib.request.urlopen("http://127.0.0.1:%d/status"
                                    % control.port, timeout=10) as resp:
            assert json.loads(resp.read())["pool"]["size"] == 1
    finally:
        control.stop()
        sched.stop()


def test_status_push_reaches_a_stub_only_when_asked():
    from veles_tpu_torch.sched import cli
    got = []
    arrived = threading.Event()

    class Stub(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            got.append((self.path, json.loads(body)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()
            arrived.set()

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    sched = Scheduler(1, preempt=False)
    sched.submit(JobSpec(argv=QUICK, tenant="push"))
    try:
        cli._push_status("http://127.0.0.1:%d" % server.server_address[1],
                         sched)
        assert arrived.wait(10)
        path, blob = got[0]
        assert path == "/update" and blob["mode"] == "sched"
        assert blob["jobs"][0]["tenant"] == "push"
        assert blob["sched"]["pool"]["size"] == 1
        # a dashboard that is down never stops scheduling
        cli._push_status("http://127.0.0.1:1", sched)
    finally:
        server.shutdown()
        server.server_close()


def test_sched_alert_rules_read_published_families():
    from veles_tpu_torch.telemetry.alerts import DEFAULT_RULES
    names = {m.name for m in port_job._metrics().values()}
    rules = [r for r in DEFAULT_RULES if r.get("metric", "").startswith(
        "veles_sched_")]
    assert len(rules) >= 5
    assert {r["metric"] for r in rules} <= names


# -- the end-to-end legs ------------------------------------------------------


def _demo(out, epochs, samples):
    return [sys.executable, "-m", "veles_tpu_torch.parallel.elastic",
            "worker-demo", "--out", out, "--epochs", str(epochs),
            "--samples", str(samples), "-a", "cpu"]


def _manifest(snaps):
    for dirpath, _, files in os.walk(snaps):
        if "MANIFEST.json" in files:
            return dirpath
    return None


def test_preempted_job_resumes_to_the_uninterrupted_curve(tmp_path):
    """A pool of one slot and two tenants: the research job is preempted
    for the prod job once its first generation committed, then resumes
    from it; its validation curve equals an uninterrupted run's, every
    value. The research gang is stopped (SIGSTOP) as soon as the
    generation appears, so it cannot finish before the preemption; the
    scheduler's SIGKILL ends it."""
    env = _env(VELES_FLIGHT_DIR=str(tmp_path / "flight"))
    base = str(tmp_path / "base.json")
    proc = subprocess.run(_demo(base, 4, 2560), env=env,
                          capture_output=True, timeout=PROC_S)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    snaps, logs = str(tmp_path / "snaps"), str(tmp_path / "logs")
    a_out, b_out = str(tmp_path / "research.json"), str(tmp_path /
                                                        "prod.json")
    sched = Scheduler(1, min_run_s=0.0, log_dir=logs)
    try:
        research = sched.submit(JobSpec(
            argv=_demo(a_out, 4, 2560), tenant="research",
            snapshot_dir=snaps, env=env))
        sched.tick()
        assert research.state == RUNNING
        _poll(lambda: _manifest(snaps) is not None or
              research.procs[0].poll() is not None, timeout_s=PROC_S,
              poll_s=0.005)
        os.killpg(research.pids[0], signal.SIGSTOP)
        assert research.procs[0].poll() is None, "finished too early"
        prod = sched.submit(JobSpec(argv=_demo(b_out, 1, 640),
                                    tenant="prod", env=env))
        sched.tick()
        assert research.state == PREEMPTED and prod.state == RUNNING
        _poll(lambda: research.terminal and prod.terminal,
              timeout_s=PROC_S, tick=sched)
    finally:
        sched.stop(kill=True)
    text = "".join(open(os.path.join(logs, n)).read()
                   for n in sorted(os.listdir(logs)))
    assert (research.state, prod.state) == (DONE, DONE), text[-3000:]
    assert research.preemptions == 1 and prod.preemptions == 0
    assert research.grants == 2
    assert "restored" in text
    with open(a_out) as f, open(base) as g:
        assert json.load(f) == json.load(g)
    with open(b_out) as f:
        assert len(json.load(f)) == 1


GA_WORKFLOW = """
import numpy
from veles_tpu_torch.config import root
from veles_tpu_torch.models.mnist import MnistWorkflow


class TinyProvider(object):
    def __call__(self):
        rng = numpy.random.RandomState(0)
        x = rng.rand(80, 6, 6).astype(numpy.float32)
        y = (x.reshape(80, -1).sum(1) > 18).astype(numpy.int32)
        return x[:60], y[:60], x[60:], y[60:]


def run(load, main):
    load(MnistWorkflow, provider=TinyProvider(), layers=(8,),
         minibatch_size=20, max_epochs=1,
         learning_rate=float(root.gasched.lr))
    main()
"""


@pytest.fixture
def ga_files(tmp_path):
    wf = tmp_path / "ga_workflow.py"
    wf.write_text(GA_WORKFLOW)
    cfg = tmp_path / "ga_config.py"
    cfg.write_text("root.gasched.lr = 0.05\n")
    root.gasched.lr = Tune(0.05, 0.01, 0.5)
    yield str(wf), str(cfg)
    root.__dict__.pop("gasched", None)


def test_scheduled_genetics_equals_serial_bit_for_bit(ga_files):
    """The same seeds, stream and argv; only who runs the fitness jobs
    differs (one warm worker, or three cold scheduler jobs at once):
    the best fitness and its overrides bit for bit, and so is every
    chromosome of every generation."""
    wf, cfg = ga_files
    kwargs = dict(workflow_file=wf, config_file=cfg, generations=2,
                  population_size=3, seed=901, extra_argv=["-a", "cpu"])
    seen = {"serial": [], "scheduled": []}
    serial = GeneticsOptimizer(
        rand=prng.RandomGenerator("ga-parity").seed(5), **kwargs)
    serial.on_generation = lambda pop: seen["serial"].append(
        [(c.codes.tolist(), c.fitness) for c in pop])
    serial_best = serial.run()
    sched = Scheduler(3, tick_s=0.05, preempt=False).start()
    try:
        scheduled = ScheduledGeneticsOptimizer(
            scheduler=sched, job_timeout_s=PROC_S,
            rand=prng.RandomGenerator("ga-parity").seed(5), **kwargs)
        scheduled.on_generation = lambda pop: seen["scheduled"].append(
            [(c.codes.tolist(), c.fitness) for c in pop])
        scheduled_best = scheduled.run()
    finally:
        sched.stop()
    assert seen["scheduled"] == seen["serial"]
    assert scheduled_best.fitness == serial_best.fitness
    assert scheduled.overrides_for(scheduled_best) == \
        serial.overrides_for(serial_best)
    assert {j.spec.tenant for j in sched.jobs()} == {"genetics"}
    assert all(j.state == DONE for j in sched.jobs())
    assert len(sched.jobs()) == 4
    assert len({e["pid"] for e in serial.evaluations}) == 1


def test_scheduled_ensemble_trains_every_member(ga_files, tmp_path):
    wf, cfg = ga_files
    sched = Scheduler(2, tick_s=0.05, preempt=False).start()
    try:
        manager = ScheduledEnsembleTrainManager(
            scheduler=sched, job_timeout_s=PROC_S, workflow_file=wf,
            config_file=cfg, size=2, train_ratio=0.5,
            extra_argv=["-a", "cpu"],
            result_file=str(tmp_path / "ensemble.json"))
        results = manager.run()
    finally:
        sched.stop()
    assert all(isinstance(r, dict) and "n_err" in r for r in results)
    assert {j.spec.tenant for j in sched.jobs()} == {"ensemble"}
    assert [j.spec.argv[3:] for j in sched.jobs()] == [
        manager.model_argv(i, j.spec.argv[j.spec.argv.index(
            "--result-file") + 1]) for i, j in enumerate(sched.jobs())]
    with open(str(tmp_path / "ensemble.json")) as f:
        assert json.load(f)["size"] == 2
