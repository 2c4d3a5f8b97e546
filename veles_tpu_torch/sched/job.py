"""JobSpec and the job FSM of the gang scheduler
(``veles_tpu/sched/job.py``).

A *job* is one training run packed onto the shared device pool: a
workflow invocation (or a raw command) owned by a tenant, wanting an
elastic gang of ``world_min..world_max`` device slots. Its lifecycle
is a small FSM::

    PENDING --> RUNNING --> DONE
                  |  ^ \\       \\-> FAILED
                  v  |  \\------> RETRYING --> FAILED
               PREEMPTED -------/   (budgeted, backoff)

``RUNNING -> PREEMPTED`` is checkpoint + shrink (the gang is killed;
its last complete per-epoch sharded checkpoint is the resume point)
and ``PREEMPTED -> RUNNING`` is a new world restored from that
generation: the elastic tier's restore carries the random streams, so
the resumed loss curve is the uninterrupted run's, bit for bit.
``RUNNING -> RETRYING`` is the failure policy: a gang that exited
nonzero with retry budget left (``JobSpec.max_retries``) re-queues
after a jittered exponential backoff instead of landing in FAILED on
the first strike. Every
transition lands in the ``veles_sched_transitions_total`` counter;
terminal states also count into ``veles_sched_jobs_total``.

Jobs survive scheduler restarts: :meth:`Job.record` /
:meth:`Job.from_record` round-trip the full job through the
write-ahead journal (:mod:`veles_tpu_torch.sched.journal`) without
touching the metric counters: replay must not count twice what the live
scheduler already counted. The metric families keep the JAX package's
names.
"""

import itertools
import sys
import time
import uuid

from veles_tpu_torch.fairshare import DEFAULT_QOS, QOS_MULTIPLIER

#: FSM states (string-valued: they travel through /jobs.json verbatim)
PENDING = "pending"
RUNNING = "running"
PREEMPTED = "preempted"
RETRYING = "retrying"
DONE = "done"
FAILED = "failed"

STATES = (PENDING, RUNNING, PREEMPTED, RETRYING, DONE, FAILED)

#: legal FSM moves; anything else is a scheduler bug, not a runtime
#: condition — transition() raises instead of recording garbage
TRANSITIONS = {
    PENDING: (RUNNING, FAILED),
    RUNNING: (PREEMPTED, RETRYING, DONE, FAILED),
    PREEMPTED: (RUNNING, FAILED),
    RETRYING: (RUNNING, FAILED),
    DONE: (),
    FAILED: (),
}

DEFAULT_TENANT = "default"

_ids = itertools.count(1)


def reserve_job_ids(floor):
    """Advance the job-id mint past ``floor`` (an int) so ids recovered
    from the journal and freshly minted ones never collide."""
    global _ids
    current = next(_ids)
    _ids = itertools.count(max(floor + 1, current))


def _metrics():
    from veles_tpu_torch.telemetry.registry import get_registry
    r = get_registry()
    return {
        "transitions": r.counter(
            "veles_sched_transitions_total",
            "Job FSM transitions", labels=("tenant", "to")),
        "jobs": r.gauge(
            "veles_sched_jobs", "Jobs per FSM state",
            labels=("state",)),
        "jobs_total": r.counter(
            "veles_sched_jobs_total",
            "Jobs reaching a terminal state",
            labels=("tenant", "state")),
        "preemptions": r.counter(
            "veles_sched_preemptions_total",
            "Jobs preempted (checkpoint + shrink)",
            labels=("tenant",)),
        "preempt_resume": r.histogram(
            "veles_sched_preempt_resume_ms",
            "Preemption -> the job is RUNNING again (re-form + "
            "reshard-on-restore)"),
        "devices": r.gauge(
            "veles_sched_pool_devices",
            "Device-slot inventory by state", labels=("state",)),
        "oldest_wait": r.gauge(
            "veles_sched_oldest_pending_s",
            "Age of the oldest PENDING/PREEMPTED job (feeds "
            "job_stuck)"),
        "tenant_wait": r.gauge(
            "veles_sched_tenant_wait_s",
            "Oldest runnable-job wait per tenant (feeds "
            "tenant_starvation)", labels=("tenant",)),
        "queue_wait": r.histogram(
            "veles_sched_queue_wait_s",
            "Submit -> FIRST placement wait (resumes excluded)"),
        "share_fraction": r.gauge(
            "veles_sched_share_fraction",
            "Guaranteed fair share as a fraction of the pool per "
            "tenant (the ledger's decision, not its outcome)",
            labels=("tenant",)),
        # the federated job view: each gang's rank-0 pushes its
        # registry delta to the scheduler; these mirror the live
        # training signal under {job,tenant} so alert rules and the
        # cluster /metrics read it like any local family
        "job_loss": r.gauge(
            "veles_sched_job_loss",
            "Live training loss per job (federated from the gang)",
            labels=("job", "tenant")),
        "job_samples": r.gauge(
            "veles_sched_job_samples_per_s",
            "Live training throughput per job (federated)",
            labels=("job", "tenant")),
        "job_mfu": r.gauge(
            "veles_sched_job_mfu",
            "Live model FLOPs utilization per job (federated)",
            labels=("job", "tenant")),
        "beat_age": r.gauge(
            "veles_sched_beat_age_s",
            "Seconds since the job's last beat-carried telemetry "
            "delta (feeds gang_silent)", labels=("job", "tenant")),
        "loss_age": r.gauge(
            "veles_sched_job_loss_age_s",
            "Seconds since the job's loss last CHANGED (feeds "
            "job_loss_plateau)", labels=("job", "tenant")),
        # durability plane (write-ahead journal + crash recovery)
        "journal_bytes": r.gauge(
            "veles_sched_journal_bytes",
            "Current size of the scheduler's write-ahead journal "
            "(sawtooths at each compaction)"),
        "replays": r.counter(
            "veles_sched_replays_total",
            "Journal replays completed at scheduler start"),
        "adopted": r.counter(
            "veles_sched_gangs_adopted_total",
            "Still-alive gangs re-attached (not killed) after a "
            "scheduler restart"),
        "retries": r.counter(
            "veles_sched_job_retries_total",
            "Failed gangs re-queued under the job's retry budget",
            labels=("tenant",)),
        "recovery_ms": r.histogram(
            "veles_sched_recovery_ms",
            "Restart recovery phase wall time",
            labels=("phase",)),
    }


class InvalidTransition(RuntimeError):
    """The scheduler asked for an FSM move the table forbids."""


class JobSpec(object):
    """What to run, who owns it, and how elastic it is.

    Two command shapes:

    * ``workflow`` (with ``config``, ``overrides``, ``result_file``,
      ``seed`` and ``extra_argv``): a ``python -m veles_tpu_torch`` run whose
      module argv is built EXACTLY like the genetics/ensemble serial
      evaluators build theirs (same ``path=repr(value)`` overrides,
      same flag order), so a scheduled evaluation is bit-identical to
      a serial one;
    * ``argv`` — a raw command executed verbatim (the elastic
      worker-demo, bench workers, anything already on disk).

    ``world_min..world_max`` is the elastic gang range: the scheduler
    grants the largest contiguous slice in range that fits, and a
    resume may be granted a DIFFERENT size — reshard-on-restore makes
    that safe. ``snapshot_dir`` marks the job preemptible: workers get
    it as ``VELES_ELASTIC_SNAPSHOTS`` and cut per-epoch sharded
    checkpoints; a job without one is never chosen as a preemption
    victim (there is nothing to resume it from).
    """

    def __init__(self, name=None, argv=None, workflow=None, config=None,
                 overrides=None, extra_argv=(), result_file=None,
                 seed=None, tenant=DEFAULT_TENANT, qos=DEFAULT_QOS,
                 weight=1.0, world_min=1, world_max=None,
                 snapshot_dir=None, env=None, max_retries=0,
                 retry_backoff_s=1.0):
        if (argv is None) == (workflow is None):
            raise ValueError(
                "exactly one of argv / workflow must be given")
        if qos not in QOS_MULTIPLIER:
            raise ValueError("unknown QoS class %r (one of %s)"
                             % (qos, sorted(QOS_MULTIPLIER)))
        self.name = name or (workflow or argv[0])
        self.argv = list(argv) if argv else None
        self.workflow = workflow
        self.config = config
        self.overrides = dict(overrides or {})
        self.extra_argv = list(extra_argv)
        self.result_file = result_file
        self.seed = seed
        self.tenant = tenant or DEFAULT_TENANT
        self.qos = qos
        self.weight = float(weight)
        self.world_min = int(world_min)
        self.world_max = int(world_max if world_max is not None
                             else world_min)
        if not 1 <= self.world_min <= self.world_max:
            raise ValueError("need 1 <= world_min <= world_max (got "
                             "%d..%d)" % (self.world_min,
                                          self.world_max))
        self.snapshot_dir = snapshot_dir
        self.env = dict(env or {})
        self.max_retries = int(max_retries)
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0 (got %d)"
                             % self.max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0 (got %s)"
                             % self.retry_backoff_s)

    @property
    def preemptible(self):
        return self.snapshot_dir is not None

    def build_argv(self, python=None):
        """The full command for one gang member. The workflow shape
        mirrors ``GeneticsOptimizer._evaluate_subprocess`` /
        ``EnsembleManagerBase._base_argv`` ordering bit-for-bit."""
        if self.argv is not None:
            return list(self.argv)
        argv = [self.workflow]
        if self.config:
            argv.append(self.config)
        argv.extend("%s=%r" % (path, value)
                    for path, value in self.overrides.items())
        if self.result_file:
            argv.extend(["--result-file", self.result_file])
        if self.seed is not None:
            argv.extend(["-s", str(self.seed)])
        argv.extend(["-v", "warning"])
        argv.extend(self.extra_argv)
        return [python or sys.executable, "-m", "veles_tpu_torch"] + argv

    def to_dict(self):
        """JSON body for ``sched submit`` -> the control endpoint."""
        return {
            "name": self.name, "argv": self.argv,
            "workflow": self.workflow, "config": self.config,
            "overrides": self.overrides, "extra_argv": self.extra_argv,
            "result_file": self.result_file, "seed": self.seed,
            "tenant": self.tenant, "qos": self.qos,
            "weight": self.weight, "world_min": self.world_min,
            "world_max": self.world_max,
            "snapshot_dir": self.snapshot_dir, "env": self.env,
            "max_retries": self.max_retries,
            "retry_backoff_s": self.retry_backoff_s,
        }

    @classmethod
    def from_dict(cls, data):
        known = ("name", "argv", "workflow", "config", "overrides",
                 "extra_argv", "result_file", "seed", "tenant", "qos",
                 "weight", "world_min", "world_max", "snapshot_dir",
                 "env", "max_retries", "retry_backoff_s")
        unknown = set(data) - set(known)
        if unknown:
            raise ValueError("unknown JobSpec fields %s"
                             % sorted(unknown))
        return cls(**{k: data[k] for k in known if data.get(k)
                      is not None})


class Job(object):
    """One submitted job: spec + FSM state + grant bookkeeping."""

    def __init__(self, spec, metrics=None, now=None):
        self.id = "job-%d" % next(_ids)
        self.spec = spec
        #: ONE trace id for the job's whole life — every grant's
        #: workers, their spans and flight records, and the
        #: scheduler's own sched_job_failed record correlate under it
        self.trace_id = uuid.uuid4().hex[:16]
        self.state = PENDING
        self.submitted_t = time.time() if now is None else now
        #: when the job last became runnable (PENDING or PREEMPTED) —
        #: the wait-age gauges and starvation alerts key off this
        self.runnable_since = self.submitted_t
        self.started_t = None
        self.finished_t = None
        self.preempted_t = None        # perf_counter at last preempt
        self.preempt_resume_s = None   # last measured preempt->resume
        self.queue_wait_s = None       # submit -> FIRST placement
        #: last federated view of the gang's training signal:
        #: loss / samples_per_s / mfu plus beat_t (last delta) and
        #: loss_t (last loss CHANGE) wall times
        self.live = {}
        self.granted_world = 0
        self.slots = ()
        self.procs = []
        #: last grant's worker pids (== pgids: workers start their own
        #: session) — what the journal records and recovery probes
        self.pids = ()
        self.grants = 0                # ENV_GEN generation counter
        self.preemptions = 0
        self.retries = 0               # failure-policy re-runs used
        self.retry_at = None           # wall time the next run unlocks
        self.failure_times = []        # crash-loop detection window
        self.error = None
        self.history = [(self.submitted_t, PENDING)]
        self._metrics = metrics if metrics is not None else _metrics()

    @property
    def runnable(self):
        return self.state in (PENDING, PREEMPTED, RETRYING)

    def ready(self, now=None):
        """Runnable AND past any retry backoff hold."""
        if not self.runnable:
            return False
        if self.retry_at is None:
            return True
        return (time.time() if now is None else now) >= self.retry_at

    @property
    def terminal(self):
        return self.state in (DONE, FAILED)

    def transition(self, to, now=None):
        """One FSM move; counts the ``veles_sched_*`` families."""
        now = time.time() if now is None else now
        if to not in TRANSITIONS[self.state]:
            raise InvalidTransition(
                "%s: illegal transition %s -> %s" % (self.id,
                                                     self.state, to))
        self.state = to
        self.history.append((now, to))
        self._metrics["transitions"].labels(
            tenant=self.spec.tenant, to=to).inc()
        if to == RUNNING:
            self.retry_at = None
            if self.started_t is None:
                self.started_t = now
                self.queue_wait_s = now - self.submitted_t
                self._metrics["queue_wait"].observe(self.queue_wait_s)
            if self.preempted_t is not None:
                self.preempt_resume_s = \
                    time.perf_counter() - self.preempted_t
                self._metrics["preempt_resume"].observe(
                    self.preempt_resume_s * 1e3)
                self.preempted_t = None
        elif to == PREEMPTED:
            self.preemptions += 1
            self.preempted_t = time.perf_counter()
            self.runnable_since = now
            self._metrics["preemptions"].labels(
                tenant=self.spec.tenant).inc()
        elif to == RETRYING:
            self.retries += 1
            self.runnable_since = now
            self._metrics["retries"].labels(
                tenant=self.spec.tenant).inc()
        if to in (DONE, FAILED):
            self.finished_t = now
            self._metrics["jobs_total"].labels(
                tenant=self.spec.tenant, state=to).inc()
        return self

    def live_view(self, now=None):
        """The federated live-metrics slice of the /jobs.json row:
        loss / throughput / MFU plus the last-beat age."""
        if not self.live:
            return {}
        now = time.time() if now is None else now
        view = {key: self.live[key] for key
                in ("loss", "samples_per_s", "mfu")
                if key in self.live}
        beat_t = self.live.get("beat_t")
        if beat_t is not None:
            view["beat_age_s"] = round(now - beat_t, 3)
        return view

    def to_dict(self):
        """The /jobs.json row."""
        return {
            "id": self.id, "name": self.spec.name,
            "tenant": self.spec.tenant, "qos": self.spec.qos,
            "trace_id": self.trace_id,
            "state": self.state, "world": self.granted_world,
            "world_range": [self.spec.world_min, self.spec.world_max],
            "slots": list(self.slots),
            "submitted_t": self.submitted_t,
            "started_t": self.started_t,
            "finished_t": self.finished_t,
            "queue_wait_s": self.queue_wait_s,
            "preemptions": self.preemptions,
            "retries": self.retries,
            "preempt_resume_s": self.preempt_resume_s,
            "metrics": self.live_view(),
            "error": self.error,
        }

    def record(self):
        """The journal image of this job: everything a restarted
        scheduler needs to rebuild it exactly (upsert semantics — each
        journaled event carries the FULL record, which is what makes
        replay trivially idempotent)."""
        return {
            "id": self.id, "trace_id": self.trace_id,
            "spec": self.spec.to_dict(), "state": self.state,
            "submitted_t": self.submitted_t,
            "runnable_since": self.runnable_since,
            "started_t": self.started_t,
            "finished_t": self.finished_t,
            "queue_wait_s": self.queue_wait_s,
            "preempt_resume_s": self.preempt_resume_s,
            "granted_world": self.granted_world,
            "slots": list(self.slots), "pids": list(self.pids),
            "grants": self.grants, "preemptions": self.preemptions,
            "retries": self.retries, "retry_at": self.retry_at,
            "failure_times": list(self.failure_times),
            "error": self.error,
            "history": [list(h) for h in self.history],
        }

    @classmethod
    def from_record(cls, record, metrics=None):
        """Rebuild a journaled job WITHOUT walking the FSM — replay
        must not re-count transitions/queue-wait/preemptions the live
        scheduler already metered."""
        job = cls.__new__(cls)
        job.id = record["id"]
        job.spec = JobSpec.from_dict(record["spec"])
        job.trace_id = record["trace_id"]
        job.state = record["state"]
        if job.state not in STATES:
            raise ValueError("journaled job %s has unknown state %r"
                             % (job.id, job.state))
        job.submitted_t = record["submitted_t"]
        job.runnable_since = record.get("runnable_since",
                                        job.submitted_t)
        job.started_t = record.get("started_t")
        job.finished_t = record.get("finished_t")
        #: perf_counter spans are meaningless across processes — a
        #: preemption in flight at crash time is re-timed from resume
        job.preempted_t = None
        job.preempt_resume_s = record.get("preempt_resume_s")
        job.queue_wait_s = record.get("queue_wait_s")
        job.live = {}
        job.granted_world = record.get("granted_world", 0)
        job.slots = tuple(record.get("slots") or ())
        job.procs = []
        job.pids = tuple(record.get("pids") or ())
        job.grants = record.get("grants", 0)
        job.preemptions = record.get("preemptions", 0)
        job.retries = record.get("retries", 0)
        job.retry_at = record.get("retry_at")
        job.failure_times = list(record.get("failure_times") or ())
        job.error = record.get("error")
        job.history = [tuple(h) for h in (record.get("history") or ())]
        if not job.history:
            job.history = [(job.submitted_t, PENDING)]
        job._metrics = metrics if metrics is not None else _metrics()
        return job
