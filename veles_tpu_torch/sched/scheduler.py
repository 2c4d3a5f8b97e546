"""The gang scheduler: device pool, weighted-fair quotas, preemption
(``veles_tpu/sched/scheduler.py``).

One :class:`Scheduler` owns a :class:`DevicePool` of N device slots and
packs submitted :class:`~veles_tpu_torch.sched.job.Job` gangs onto it:

* **gang placement** — a job wants ``world_min..world_max`` slots; the
  scheduler grants the LARGEST contiguous slice in range that fits
  (contiguous, as a slice of a mesh is), best-fit among the free holes
  so big holes survive for big gangs;
* **weighted-fair quotas** — per-tenant :class:`ShareAccount` ledgers
  from :mod:`veles_tpu_torch.fairshare`, the SAME math the serving
  AdmissionController meters samples with, here metering device slots:
  a tenant under its guaranteed share always places (slots permitting);
  over-share placement may only borrow headroom no active tenant holds
  a claim on;
* **preemption = checkpoint + shrink** — a preemptible job (one with a
  ``snapshot_dir``) cuts a per-epoch sharded checkpoint through the
  elastic seam (``save_elastic_checkpoint`` riding
  ``snapshotter.save_snapshot_sharded``), so preempting it is the
  ElasticSupervisor kill: SIGKILL the gang's process groups. Resume
  respawns at the newly granted world size with the same snapshot
  directory — ``run_elastic_training`` restores the newest complete
  generation at the granted world size, making the resumed loss curve
  the uninterrupted run's (``tests/test_torch_sched.py``);
* a failed gang re-queues under its retry budget
  (``JobSpec.max_retries`` with jittered exponential backoff and
  crash-loop detection) and dumps a flight record
  (``sched_job_failed``) before the job lands in FAILED.

**Durability**: pass ``state_dir`` and every submit,
transition, grant, preempt and reap is journaled through
:class:`veles_tpu_torch.sched.journal.JobJournal` before the caller sees
the result. A restarting scheduler replays the journal, rebuilds
jobs/accounts/pool holds, then reconciles reality: still-alive gangs
(workers run in their own sessions, so they survive our death) are
*adopted* in place via :class:`_AdoptedProc` — never killed — while
dead gangs route through the preempt-style resume (preemptible) or
the retry policy. PENDING/PREEMPTED jobs rejoin the queue with their
original submit times, so queue-wait accounting and fair-share do not
reset. The control surface answers 503 + Retry-After while replay is
in flight.

:class:`SchedulerControl` is the loopback HTTP surface the CLI talks
to: ``POST /submit`` (a JobSpec dict), ``GET /status``,
``GET /jobs.json`` — plus the ONE-pane-of-glass observability
surface: ``POST /telemetry`` absorbs each gang rank-0's delta-encoded
registry push into a per-job :class:`FederatedRegistry` feed, ``GET
/metrics`` / ``/metrics.json`` serve the cluster view with
``{job,tenant}`` labels, and ``GET /history.json?series=&since=``
serves the bounded time-series store. Every job runs under ONE
minted trace id (``VELES_ELASTIC_TRACE``) for its whole life, so
worker flight records, supervisor spans, and the scheduler's
``sched_job_failed`` record correlate.

On one card the slots are ranks that share it: the scheduler sets no
device visibility per slot (neither does the JAX one), and a gang of
world > 1 runs the elastic tier's backend rule (gloo on one card).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from veles_tpu_torch.fairshare import (DEFAULT_QOS, ShareAccount,
                                 guaranteed_share, reserved_claim)
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.parallel.elastic import (ENV_COORD, ENV_GEN, ENV_JOB,
                                        ENV_RANK, ENV_SNAPSHOTS,
                                        ENV_TENANT, ENV_TRACE,
                                        ENV_WORLD, _free_port)
from veles_tpu_torch.parallel.retry import backoff_delay
from veles_tpu_torch.sched.job import (DONE, FAILED, PENDING, PREEMPTED,
                                 RETRYING, RUNNING, STATES, Job,
                                 _metrics, reserve_job_ids)
from veles_tpu_torch.sched.journal import JobJournal


def _pid_alive(pid):
    """Is ``pid`` still a live process? pidfd when the platform has
    it (no pid-reuse race while the fd is held), signal-0 probe
    otherwise."""
    try:
        opener = os.pidfd_open
    except AttributeError:
        opener = None
    if opener is not None:
        try:
            os.close(opener(pid))
        except ProcessLookupError:
            return False
        except OSError:
            pass            # fall through to the portable probe
        else:
            return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class _AdoptedProc(object):
    """Popen-shaped handle for a gang member spawned by a PREVIOUS
    scheduler process and adopted across a restart.

    The member is NOT our child: init reaps it, so its real exit code
    is unobservable. :meth:`poll` therefore reports ``0`` the moment
    the process is gone — an adopted gang's exit is reaped as success
    by design (a worker that actually failed leaves its own flight
    records, and the job's result file tells the truth). Liveness
    rides a pidfd held open from adoption time when available (immune
    to pid reuse); otherwise the signal-0 probe."""

    def __init__(self, pid):
        self.pid = pid
        self._pidfd = None
        #: death is sticky: once observed dead, stay dead (the pidfd
        #: is consumed by the first observation, and a later signal-0
        #: probe could hit a reused pid — or an unreaped zombie)
        self._dead = False
        try:
            self._pidfd = os.pidfd_open(pid)
        except (AttributeError, OSError):
            pass

    def _alive(self):
        if self._dead:
            return False
        if self._pidfd is not None:
            import select
            # the pidfd becomes readable when the process exits
            ready, _, _ = select.select([self._pidfd], [], [], 0)
            if not ready:
                return True
            os.close(self._pidfd)
            self._pidfd = None
        elif _pid_alive(self.pid):
            return True
        self._dead = True
        return False

    def poll(self):
        return None if self._alive() else 0

    def wait(self, timeout=None):
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while self._alive():
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(
                    "adopted-pid-%d" % self.pid, timeout)
            time.sleep(0.05)
        return 0

    def kill(self):
        try:
            os.kill(self.pid, signal.SIGKILL)
        except OSError:
            pass


class DevicePool(object):
    """Slot inventory: ``size`` device slots, contiguous gang grants.

    Holes are tracked implicitly (the complement of held intervals);
    :meth:`allocate` is best-fit — the SMALLEST hole that still fits
    the gang — so one small job does not fragment the hole a large
    gang is waiting for.
    """

    def __init__(self, size):
        if int(size) < 1:
            raise ValueError("pool size must be > 0 (got %s)" % size)
        self.size = int(size)
        self._held = {}  # job_id -> (start, n)

    @property
    def held(self):
        return sum(n for _, n in self._held.values())

    @property
    def free(self):
        return self.size - self.held

    def holes(self):
        """Free contiguous ``(start, length)`` runs, ascending."""
        taken = sorted(self._held.values())
        holes, cursor = [], 0
        for start, n in taken:
            if start > cursor:
                holes.append((cursor, start - cursor))
            cursor = max(cursor, start + n)
        if cursor < self.size:
            holes.append((cursor, self.size - cursor))
        return holes

    def allocate(self, job_id, want):
        """Grant ``want`` contiguous slots to ``job_id`` (best-fit),
        or return ``None`` when no hole is big enough."""
        if job_id in self._held:
            raise ValueError("%s already holds slots" % job_id)
        best = None
        for start, length in self.holes():
            if length >= want and (best is None or length < best[1]):
                best = (start, length)
        if best is None:
            return None
        self._held[job_id] = (best[0], want)
        return tuple(range(best[0], best[0] + want))

    def hold(self, job_id, start, n):
        """Re-impose a journaled grant verbatim (recovery path): the
        exact ``(start, n)`` interval, validated against the pool
        bounds and every other hold — a collision means the journal
        and reality disagree, which must surface, not silently
        fragment."""
        start, n = int(start), int(n)
        if job_id in self._held:
            raise ValueError("%s already holds slots" % job_id)
        if n < 1 or start < 0 or start + n > self.size:
            raise ValueError(
                "hold [%d, %d) is outside the pool of %d"
                % (start, start + n, self.size))
        for other, (o_start, o_n) in self._held.items():
            if start < o_start + o_n and o_start < start + n:
                raise ValueError(
                    "hold [%d, %d) for %s overlaps %s at [%d, %d)"
                    % (start, start + n, job_id, other, o_start,
                       o_start + o_n))
        self._held[job_id] = (start, n)
        return tuple(range(start, start + n))

    def release(self, job_id):
        self._held.pop(job_id, None)


class Scheduler(Logger):
    """Multi-job gang scheduler over one device pool."""

    def __init__(self, pool_size, tick_s=0.2, preempt=True,
                 min_run_s=1.0, activity_window_s=10.0, python=None,
                 log_dir=None, state_dir=None, crash_loop_k=3,
                 crash_loop_window_s=60.0):
        super(Scheduler, self).__init__()
        self.pool = DevicePool(pool_size)
        self.tick_s = float(tick_s)
        self.preempt_enabled = bool(preempt)
        #: thrash guard: a job must RUN this long before it can be
        #: chosen as a victim — with it, mutual preemption degrades
        #: into round-robin time slices of at least min_run_s, not a
        #: kill storm
        self.min_run_s = float(min_run_s)
        self.activity_window_s = float(activity_window_s)
        self.python = python or sys.executable
        self.log_dir = log_dir
        #: crash-loop tripwire: this many failures inside the window
        #: overrides any remaining retry budget (a gang dying in a
        #: tight loop is a bug, not a transient)
        self.crash_loop_k = int(crash_loop_k)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self._lock = threading.RLock()
        self._jobs = {}        # id -> Job (insertion = submission order)
        self._accounts = {}    # tenant -> ShareAccount
        self._grant_seq = 0
        self._metrics = _metrics()
        self._journal = None
        #: the control surface answers 503 while this is True; set
        #: from construction until recover() finishes so requests
        #: racing the replay never see half-rebuilt state
        self.recovering = False
        if state_dir:
            self._journal = JobJournal(state_dir,
                                       metrics=self._metrics)
            self.recovering = True
        #: per-job federation feeds (sid = job id), fed by POST
        #: /telemetry from each gang's rank-0 metrics pusher; lazy so
        #: a push-less scheduler never mints the federation families
        self._federation = None
        #: set by SchedulerControl: the /telemetry URL spawned gangs
        #: receive as VELES_SCHED_METRICS_URL
        self.metrics_url = None
        self._stop = threading.Event()
        self._thread = None

    # -- submission --------------------------------------------------------

    def submit(self, spec, now=None):
        now = time.time() if now is None else now
        if spec.world_max > self.pool.size:
            raise ValueError(
                "job wants up to %d slots but the pool has %d"
                % (spec.world_max, self.pool.size))
        with self._lock:
            job = Job(spec, metrics=self._metrics, now=now)
            self._jobs[job.id] = job
            account = self._account(spec.tenant, spec)
            account.last_active = now
            self._journal_event("submit", job, now)
            self.info("submitted %s (%s): tenant=%s qos=%s world=%d..%d"
                      "%s", job.id, spec.name, spec.tenant, spec.qos,
                      spec.world_min, spec.world_max,
                      " preemptible" if spec.preemptible else "")
        return job

    # -- durability --------------------------------------------------------

    def _journal_event(self, ev, job, now, **extra):
        """One durable upsert line: the event name is decoration for
        humans; the job's FULL record is the payload (what makes
        replay idempotent). Compacts when the journal is over size."""
        if self._journal is None:
            return
        event = {"ev": ev, "t": now, "grant_seq": self._grant_seq,
                 "job": job.record()}
        account = self._accounts.get(job.spec.tenant)
        if account is not None:
            event["account"] = {
                "tenant": account.name, "weight": account.weight,
                "qos": account.qos,
                "admitted_total": account.admitted_total}
        event.update(extra)
        self._journal.append(event)
        if self._journal.should_compact():
            self._journal.compact(self._image_locked())

    def _image_locked(self):
        """The compacted journal snapshot: full scheduler state."""
        return {
            "grant_seq": self._grant_seq,
            "jobs": [j.record() for j in self._jobs.values()],
            "accounts": {
                a.name: {"tenant": a.name, "weight": a.weight,
                         "qos": a.qos,
                         "admitted_total": a.admitted_total}
                for a in self._accounts.values()},
        }

    def recover(self, now=None):
        """Replay the journal and reconcile against reality. Runs
        once, synchronously, before the tick loop — the control
        surface 503s until it returns."""
        if self._journal is None:
            return self
        now = time.time() if now is None else now
        try:
            with self._lock:
                t0 = time.perf_counter()
                image, events = self._journal.replay()
                self._replay_locked(image, events, now)
                self._metrics["recovery_ms"].labels(
                    phase="replay").observe(
                        (time.perf_counter() - t0) * 1e3)
                self._metrics["replays"].inc()
                self._reconcile_locked(now)
                # fold everything just replayed into one fresh image
                # so the NEXT restart replays a snapshot, not history
                self._journal.compact(self._image_locked())
        finally:
            self.recovering = False
        return self

    def _replay_locked(self, image, events, now):
        records = {}
        accounts = {}
        grant_seq = 0
        if image:
            grant_seq = int(image.get("grant_seq") or 0)
            for record in image.get("jobs") or ():
                if isinstance(record, dict) and "id" in record:
                    records[record["id"]] = record
            for name, info in (image.get("accounts") or {}).items():
                accounts[name] = info
        for event in events:
            record = event.get("job")
            if isinstance(record, dict) and "id" in record:
                # upsert keeps the FIRST-insert position: submission
                # order survives replay, which the fair queue needs
                records[record["id"]] = record
            grant_seq = max(grant_seq,
                            int(event.get("grant_seq") or 0))
            info = event.get("account")
            if isinstance(info, dict) and info.get("tenant"):
                accounts[info["tenant"]] = info
        floor = 0
        for record in records.values():
            try:
                job = Job.from_record(record, metrics=self._metrics)
            except (KeyError, TypeError, ValueError) as e:
                self.warning("dropping unreadable journaled job "
                             "%r: %s", record.get("id"), e)
                continue
            self._jobs[job.id] = job
            suffix = job.id.rsplit("-", 1)[-1]
            if suffix.isdigit():
                floor = max(floor, int(suffix))
        reserve_job_ids(floor)
        self._grant_seq = grant_seq
        for job in self._jobs.values():
            account = self._account(job.spec.tenant, job.spec)
            account.last_active = max(
                account.last_active, job.submitted_t,
                job.started_t or 0.0, job.finished_t or 0.0)
            if job.finished_t is not None:
                account.completions.append(job.finished_t)
            if job.state == RUNNING and job.slots:
                account.outstanding += job.granted_world
                self.pool.hold(job.id, job.slots[0],
                               len(job.slots))
        for name, info in accounts.items():
            account = self._account(name)
            account.weight = float(info.get("weight",
                                            account.weight))
            account.qos = info.get("qos", account.qos)
            account.admitted_total = int(
                info.get("admitted_total", account.admitted_total))
        self.info("journal replay: %d job(s), %d account(s), "
                  "grant_seq=%d", len(self._jobs),
                  len(self._accounts), self._grant_seq)

    def _reconcile_locked(self, now):
        """Journal state vs reality: adopt gangs that survived our
        death, route dead ones through resume/retry."""
        t0 = time.perf_counter()
        running = [j for j in self._jobs.values()
                   if j.state == RUNNING]
        alive = {job.id: bool(job.pids) and
                 all(_pid_alive(pid) for pid in job.pids)
                 for job in running}
        self._metrics["recovery_ms"].labels(phase="probe").observe(
            (time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for job in running:
            if alive[job.id]:
                job.procs = [_AdoptedProc(pid) for pid in job.pids]
                self._metrics["adopted"].inc()
                self._journal_event("adopt", job, now)
                self.info("%s: adopted surviving gang (pids %s)",
                          job.id, list(job.pids))
                continue
            # the gang died while we were down: some members may
            # still linger — take the remains down before re-placing
            for pid in job.pids:
                try:
                    os.killpg(pid, signal.SIGKILL)
                except OSError:
                    pass
            self._release_locked(job, now)
            if job.spec.preemptible:
                job.transition(PREEMPTED, now)
                self._journal_event("recover", job, now)
                self.info("%s: gang died while scheduler was down — "
                          "resuming from checkpoint", job.id)
            else:
                self._fail_or_retry_locked(
                    job, now,
                    "gang died while scheduler was down")
        self._metrics["recovery_ms"].labels(phase="adopt").observe(
            (time.perf_counter() - t0) * 1e3)

    def _account(self, tenant, spec=None):
        account = self._accounts.get(tenant)
        if account is None:
            account = self._accounts[tenant] = ShareAccount(
                tenant, weight=spec.weight if spec else 1.0,
                qos=spec.qos if spec else DEFAULT_QOS)
        elif spec is not None:
            # latest submission's weight/qos wins (one account per
            # tenant; jobs are the granularity specs ride in on)
            account.weight = spec.weight
            account.qos = spec.qos
        return account

    def jobs(self):
        with self._lock:
            return list(self._jobs.values())

    def get(self, job_id):
        with self._lock:
            return self._jobs.get(job_id)

    def wait(self, job_ids, timeout_s=None, poll_s=0.05):
        """Block until every listed job is terminal (DONE/FAILED).
        Returns ``{id: state}``; raises ``TimeoutError`` on timeout.
        Requires a started scheduler (the tick thread does the work)."""
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        ids = list(job_ids)
        while True:
            with self._lock:
                jobs = [self._jobs[i] for i in ids]
                if all(j.terminal for j in jobs):
                    return {j.id: j.state for j in jobs}
            if deadline and time.monotonic() > deadline:
                raise TimeoutError(
                    "jobs still not terminal after %.0fs: %s"
                    % (timeout_s, [j.id for j in jobs
                                   if not j.terminal]))
            time.sleep(poll_s)

    # -- the tick ----------------------------------------------------------

    def tick(self, now=None):
        """One scheduling pass: reap finished gangs, place runnable
        jobs (preempting when fair-share justifies it), publish the
        gauges. The loop calls this; tests drive it directly."""
        now = time.time() if now is None else now
        with self._lock:
            self._reap_locked(now)
            self._schedule_locked(now)
            self._publish_locked(now)

    def _reap_locked(self, now):
        for job in self._jobs.values():
            if job.state != RUNNING:
                continue
            codes = [proc.poll() for proc in job.procs]
            if any(code not in (None, 0) for code in codes):
                # one gang member died: the rest are wedged in (or
                # heading into) a dead collective — take the gang down
                self._kill_gang(job)
                self._release_locked(job, now)
                rc = [c for c in codes if c not in (None, 0)][0]
                self._fail_or_retry_locked(
                    job, now, "worker exited rc=%s" % (rc,),
                    rc=codes)
            elif all(code == 0 for code in codes):
                self._release_locked(job, now)
                job.transition(DONE, now)
                self._journal_event("reap", job, now, rc=0)
                self._drop_job_view_locked(job)
                self.info("%s done (world=%d, %d preemption%s)",
                          job.id, job.granted_world, job.preemptions,
                          "" if job.preemptions == 1 else "s")

    def _fail_or_retry_locked(self, job, now, error, rc=None):
        """The failure policy: re-queue with backoff while retry
        budget remains, UNLESS the gang is crash-looping
        (``crash_loop_k`` failures inside ``crash_loop_window_s``) —
        a tight failure loop is a bug to surface, not a transient to
        absorb. Terminal failures dump the correlated
        ``sched_job_failed`` flight record."""
        job.failure_times.append(now)
        cutoff = now - self.crash_loop_window_s
        job.failure_times = [t for t in job.failure_times
                             if t >= cutoff]
        crash_loop = len(job.failure_times) >= self.crash_loop_k
        if not crash_loop and job.retries < job.spec.max_retries:
            job.error = "%s (retrying %d/%d)" % (
                error, job.retries + 1, job.spec.max_retries)
            job.transition(RETRYING, now)
            job.retry_at = now + backoff_delay(
                job.retries - 1, base_s=job.spec.retry_backoff_s)
            self._journal_event("reap", job, now, rc=rc)
            self.warning("%s: %s — retry %d/%d in %.2fs", job.id,
                         error, job.retries, job.spec.max_retries,
                         job.retry_at - now)
            return
        if crash_loop:
            error = "%s (crash loop: %d failures in %.0fs)" % (
                error, len(job.failure_times),
                self.crash_loop_window_s)
        job.error = error
        job.transition(FAILED, now)
        self._journal_event("reap", job, now, rc=rc)
        self._drop_job_view_locked(job)
        self.warning("%s failed: %s", job.id, job.error)
        from veles_tpu_torch.telemetry.flight import get_recorder
        get_recorder().dump("sched_job_failed", job=job.to_dict(),
                            rc=rc, retries=job.retries,
                            failures=list(job.failure_times),
                            trace_id=job.trace_id)

    def _schedule_locked(self, now):
        # resumes first (a preempted job already earned its slot once),
        # oldest-runnable first within each class; ready() keeps a
        # RETRYING job parked until its backoff hold expires
        runnable = [j for j in self._jobs.values() if j.ready(now)]
        runnable.sort(key=lambda j: (j.state != PREEMPTED,
                                     j.runnable_since))
        for job in runnable:
            if self._try_place_locked(job, now):
                continue
            if self.preempt_enabled and \
                    self._try_preempt_for_locked(job, now):
                self._try_place_locked(job, now)

    def _gate_locked(self, account, want, now):
        """The fair-share admission gate for ``want`` more slots."""
        accounts = self._accounts.values()
        share = guaranteed_share(self.pool.size, account, accounts,
                                 now, self.activity_window_s)
        if account.outstanding + want <= share:
            return True
        reserved = reserved_claim(self.pool.size, account, accounts,
                                  now, self.activity_window_s)
        return want <= self.pool.size - self.pool.held - reserved

    def _try_place_locked(self, job, now):
        account = self._accounts[job.spec.tenant]
        for want in range(min(job.spec.world_max, self.pool.free),
                          job.spec.world_min - 1, -1):
            if not self._gate_locked(account, want, now):
                continue
            slots = self.pool.allocate(job.id, want)
            if slots is None:
                continue
            # account BEFORE the spawn journals its "grant" event, so
            # the journaled ledger matches the grant it rides with
            account.outstanding += want
            account.admitted_total += want
            account.last_active = now
            try:
                self._spawn_locked(job, slots, now)
            except OSError as e:
                account.outstanding -= want
                account.admitted_total -= want
                self.pool.release(job.id)
                job.error = "spawn failed: %s" % e
                job.transition(FAILED, now)
                self._journal_event("spawn_failed", job, now)
                return False
            return True
        return False

    def _try_preempt_for_locked(self, job, now):
        """Preempt ONE victim gang to make room for ``job``, when the
        fair-share ledger justifies it: the claimant tenant is under
        its guaranteed share, the victim's tenant is at-or-over its
        own, and the victim has run at least ``min_run_s`` (the
        thrash guard that turns contention into time slices)."""
        account = self._accounts[job.spec.tenant]
        accounts = self._accounts.values()
        share = guaranteed_share(self.pool.size, account, accounts,
                                 now, self.activity_window_s)
        if account.outstanding + job.spec.world_min > share:
            return False            # not owed anything — wait, don't kill
        victims = []
        for other in self._jobs.values():
            if other.state != RUNNING or not other.spec.preemptible:
                continue
            if other.spec.tenant == job.spec.tenant:
                continue
            if now - other.history[-1][0] < self.min_run_s:
                continue
            v_account = self._accounts[other.spec.tenant]
            v_share = guaranteed_share(self.pool.size, v_account,
                                       accounts, now,
                                       self.activity_window_s)
            if v_account.outstanding < v_share:
                continue            # that tenant is within its guarantee
            victims.append((v_account.outstanding - v_share,
                            other.history[-1][0], other))
        if not victims:
            return False
        # most over-share tenant first; within it, the most recently
        # (re)started gang loses the least completed work
        victims.sort(key=lambda v: (-v[0], -v[1]))
        victim = victims[0][2]
        self.info("preempting %s (tenant %s) for %s (tenant %s) — "
                  "checkpoint + shrink", victim.id, victim.spec.tenant,
                  job.id, job.spec.tenant)
        self._kill_gang(victim)
        self._release_locked(victim, now)
        victim.transition(PREEMPTED, now)
        self._journal_event("preempt", victim, now)
        return True

    # -- gang lifecycle ----------------------------------------------------

    def _spawn_locked(self, job, slots, now):
        world = len(slots)
        self._grant_seq += 1
        job.grants += 1
        coord = None
        if world > 1:
            coord = "127.0.0.1:%d" % _free_port()
        argv = job.spec.build_argv(python=self.python)
        procs = []
        for rank in range(world):
            env = dict(os.environ)
            env.update(job.spec.env)
            env[ENV_GEN] = str(self._grant_seq)
            env[ENV_WORLD] = str(world)
            env[ENV_RANK] = str(rank)
            # trace correlation + the job view: every grant of this
            # job (resumes included) runs under the SAME trace id,
            # and rank 0 pushes its registry deltas back to us
            env[ENV_TRACE] = job.trace_id
            env[ENV_JOB] = job.id
            env[ENV_TENANT] = job.spec.tenant
            if self.metrics_url:
                env["VELES_SCHED_METRICS_URL"] = self.metrics_url
            if coord:
                env[ENV_COORD] = coord
            else:
                env.pop(ENV_COORD, None)
            if job.spec.snapshot_dir:
                env[ENV_SNAPSHOTS] = job.spec.snapshot_dir
            stdout = stderr = None
            logf = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                logf = open(os.path.join(
                    self.log_dir, "%s-g%d-r%d.log"
                    % (job.id, job.grants, rank)), "ab")
                stdout = stderr = logf
            try:
                procs.append(subprocess.Popen(
                    argv, env=env, stdout=stdout, stderr=stderr,
                    start_new_session=True))
            finally:
                if logf is not None:
                    logf.close()   # the child keeps its own dup
        job.slots = slots
        job.granted_world = world
        job.procs = procs
        job.pids = tuple(proc.pid for proc in procs)
        job.transition(RUNNING, now)
        self._journal_event("grant", job, now)
        self.info("%s: granted slots %s (world=%d, grant #%d)",
                  job.id, list(slots), world, job.grants)

    def _kill_gang(self, job):
        """The ElasticSupervisor kill: SIGKILL each member's process
        group (workers run in their own sessions) — per-epoch sharded
        checkpoints make this checkpoint + shrink, not data loss."""
        for proc in job.procs:
            if proc.poll() is not None:
                continue
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                try:
                    proc.kill()
                except OSError:
                    pass
        for proc in job.procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def _release_locked(self, job, now):
        if not job.granted_world:
            return
        account = self._accounts[job.spec.tenant]
        account.outstanding = max(
            0, account.outstanding - job.granted_world)
        account.completions.append(now)
        account.last_active = now
        self.pool.release(job.id)
        job.slots = ()
        job.granted_world = 0
        job.procs = []
        job.pids = ()

    # -- telemetry ---------------------------------------------------------

    #: gang registry families mirrored into the per-job view:
    #: (federated family, Job.live key, _metrics key, mirror family)
    _LIVE_FAMILIES = (
        ("veles_train_loss", "loss", "job_loss",
         "veles_sched_job_loss"),
        ("veles_train_samples_per_s", "samples_per_s",
         "job_samples", "veles_sched_job_samples_per_s"),
        ("veles_step_mfu", "mfu", "job_mfu",
         "veles_sched_job_mfu"),
    )

    def absorb_telemetry(self, job_id, delta):
        """Merge one POST ``/telemetry`` delta (a gang rank-0 push)
        into the job's federation feed; returns the ack hints
        (``{"resync": True}`` asks the pusher for a full snapshot).
        A feed from a job we no longer track is GC'd, not stored."""
        with self._lock:
            job = self._jobs.get(job_id)
            live = job is not None and not job.terminal
            if live and self._federation is None:
                from veles_tpu_torch.telemetry.federation import \
                    FederatedRegistry
                self._federation = FederatedRegistry()
            federation = self._federation
        if not live or federation is None:
            if federation is not None:
                federation.remove_slave(job_id)
            return {}
        # apply OUTSIDE the scheduler lock (the feed has its own),
        # then re-check liveness — the gang may have been reaped
        # while the delta merged
        hints = federation.apply(job_id, delta)
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.terminal:
                federation.remove_slave(job_id)
                return {}
            job.live["beat_t"] = time.time()
        return hints or {}

    def _drop_job_view_locked(self, job):
        """GC a terminal job's federation feed and mirror gauges
        (history keeps its points until retention ages them out)."""
        if self._federation is not None:
            self._federation.remove_slave(job.id)
        job_id = job.id
        for _, _, metric, _ in self._LIVE_FAMILIES:
            self._metrics[metric].remove(job=job_id)
        self._metrics["beat_age"].remove(job=job_id)
        self._metrics["loss_age"].remove(job=job_id)

    def _publish_jobs_locked(self, now):
        """Fold the federation feeds into the per-job mirror gauges
        and the history store — the live half of /jobs.json."""
        if self._federation is None:
            return
        latest = {}
        for sid, tag, name, _, data in self._federation.series_rows():
            if tag != "g":
                continue
            for family, key, _, _ in self._LIVE_FAMILIES:
                if name == family:
                    latest.setdefault(sid, {})[key] = data
        from veles_tpu_torch.telemetry.timeseries import get_history
        history = get_history()
        for job in self._jobs.values():
            if job.terminal:
                continue
            fresh = latest.get(job.id)
            if fresh:
                if "loss" in fresh and \
                        fresh["loss"] != job.live.get("loss"):
                    job.live["loss_t"] = now
                job.live.update(fresh)
            if not job.live:
                continue
            job_id, tenant = job.id, job.spec.tenant
            for _, key, metric, mirror in self._LIVE_FAMILIES:
                value = job.live.get(key)
                if value is None:
                    continue
                self._metrics[metric].labels(
                    job=job_id, tenant=tenant).set(value)
                # only a RUNNING gang appends history: a preempted
                # job's series must show the gap, not a flat line
                if job.state == RUNNING:
                    history.record(
                        mirror, {"job": job_id, "tenant": tenant},
                        value, now=now)
            beat_t = job.live.get("beat_t")
            if beat_t is not None:
                self._metrics["beat_age"].labels(
                    job=job_id, tenant=tenant).set(now - beat_t)
            loss_t = job.live.get("loss_t")
            if loss_t is not None:
                self._metrics["loss_age"].labels(
                    job=job_id, tenant=tenant).set(now - loss_t)

    def _publish_locked(self, now):
        counts = dict.fromkeys(STATES, 0)
        oldest = 0.0
        waits = {}
        for job in self._jobs.values():
            counts[job.state] += 1
            if job.runnable:
                wait = now - job.runnable_since
                oldest = max(oldest, wait)
                tenant = job.spec.tenant
                waits[tenant] = max(waits.get(tenant, 0.0), wait)
        for state, n in counts.items():
            self._metrics["jobs"].labels(state=state).set(n)
        self._metrics["devices"].labels(state="free").set(
            self.pool.free)
        self._metrics["devices"].labels(state="held").set(
            self.pool.held)
        self._metrics["oldest_wait"].set(oldest)
        accounts = self._accounts.values()
        for tenant, account in self._accounts.items():
            self._metrics["tenant_wait"].labels(tenant=tenant).set(
                waits.get(tenant, 0.0))
            share = guaranteed_share(self.pool.size, account,
                                     accounts, now,
                                     self.activity_window_s)
            self._metrics["share_fraction"].labels(
                tenant=tenant).set(share / self.pool.size)
        self._publish_jobs_locked(now)

    def cluster_snapshot(self):
        """The ONE cluster view: the scheduler's own registry
        snapshot with every job feed's series folded in under
        ``{job, tenant}`` labels — the /metrics(.json) body."""
        from veles_tpu_torch.telemetry.registry import get_registry
        with self._lock:
            tenants = {job.id: job.spec.tenant
                       for job in self._jobs.values()}
            federation = self._federation
        snap = get_registry().snapshot()
        if federation is None:
            return snap
        kind_of = {"c": "counters", "g": "gauges", "h": "histograms"}
        for sid, tag, name, labels, data in federation.series_rows():
            bucket = snap[kind_of[tag]]
            family = bucket.get(name)
            if family is None:
                family = bucket[name] = {"help": "", "series": []}
            labels = dict(labels)
            labels["job"] = sid
            tenant = tenants.get(sid)
            if tenant:
                labels["tenant"] = tenant
            if tag == "h":
                entry = dict(data)
                entry["labels"] = labels
            else:
                entry = {"value": data, "labels": labels}
            family["series"].append(entry)
        return snap

    def stats(self, now=None):
        now = time.time() if now is None else now
        with self._lock:
            counts = dict.fromkeys(STATES, 0)
            for job in self._jobs.values():
                counts[job.state] += 1
            return {
                "pool": {"size": self.pool.size,
                         "free": self.pool.free,
                         "held": self.pool.held},
                "jobs": counts,
                "tenants": {
                    a.name: {
                        "weight": a.weight, "qos": a.qos,
                        "held": a.outstanding,
                        "granted": a.admitted_total,
                        "share": round(guaranteed_share(
                            self.pool.size, a, self._accounts.values(),
                            now, self.activity_window_s), 1),
                        "share_fraction": round(guaranteed_share(
                            self.pool.size, a, self._accounts.values(),
                            now, self.activity_window_s)
                            / self.pool.size, 4),
                    } for a in self._accounts.values()},
            }

    def jobs_report(self):
        """The ``/jobs.json`` body (also what a dashboard push
        embeds as its ``jobs`` list)."""
        with self._lock:
            return {"jobs": [job.to_dict()
                             for job in self._jobs.values()]}

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Recover from the journal (when configured), then run the
        tick loop on a daemon thread."""
        self.recover()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sched-tick")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:
                self.exception("scheduler tick failed")

    def stop(self, kill=True):
        """Stop the loop; ``kill`` takes down every running gang (a
        drain would wait for them — the caller owns that choice)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if kill:
            with self._lock:
                now = time.time()
                for job in self._jobs.values():
                    if job.state == RUNNING:
                        self._kill_gang(job)
                        self._release_locked(job, now)
                        job.error = "scheduler stopped"
                        job.transition(FAILED, now)
                        self._journal_event("stop", job, now)
                        self._drop_job_view_locked(job)
        if self._journal is not None:
            self._journal.close()


class _ControlHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        self.server.owner.debug("http: " + fmt, *args)

    def _reply(self, body, code=200, headers=None):
        data = json.dumps(body).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def _recovering(self, scheduler):
        """503 + Retry-After while journal replay is in flight — the
        state a client would read is not rebuilt yet."""
        if not scheduler.recovering:
            return False
        self._reply({"error": "scheduler is recovering, retry"},
                    code=503, headers={"Retry-After": "1"})
        return True

    def _reply_text(self, body, content_type="text/plain"):
        data = body.encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        scheduler = self.server.owner.scheduler
        if self._recovering(scheduler):
            return
        if self.path.startswith("/status"):
            self._reply(scheduler.stats())
        elif self.path.startswith("/jobs.json"):
            self._reply(scheduler.jobs_report())
        elif self.path.startswith("/history.json"):
            query = parse_qs(urlsplit(self.path).query)
            from veles_tpu_torch.telemetry.timeseries import get_history
            try:
                self._reply(get_history().query(
                    series=(query.get("series") or [None])[0],
                    since=(query.get("since") or [None])[0]))
            except (TypeError, ValueError):
                self._reply({"error": "bad since cursor"}, code=400)
        elif self.path.startswith("/metrics.json"):
            self._reply(scheduler.cluster_snapshot())
        elif self.path.startswith("/metrics"):
            from veles_tpu_torch.telemetry.registry import render_snapshot
            self._reply_text(
                render_snapshot(scheduler.cluster_snapshot()),
                content_type="text/plain; version=0.0.4")
        else:
            self._reply({"error": "not found"}, code=404)

    def do_POST(self):
        scheduler = self.server.owner.scheduler
        if self._recovering(scheduler):
            return
        if self.path.startswith("/telemetry"):
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = json.loads(
                    self.rfile.read(length).decode("utf-8"))
                hints = scheduler.absorb_telemetry(
                    str(data.get("job") or ""),
                    data.get("telemetry"))
            except (TypeError, ValueError, KeyError) as e:
                self._reply({"error": str(e) or type(e).__name__},
                            code=400)
                return
            self._reply(hints)
            return
        if not self.path.startswith("/submit"):
            self._reply({"error": "not found"}, code=404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(length).decode("utf-8"))
            from veles_tpu_torch.sched.job import JobSpec
            job = scheduler.submit(JobSpec.from_dict(data))
        except (TypeError, ValueError, KeyError) as e:
            self._reply({"error": str(e) or type(e).__name__},
                        code=400)
            return
        self._reply({"id": job.id, "state": job.state})


class SchedulerControl(Logger):
    """Loopback HTTP control plane for one scheduler: ``POST
    /submit`` + ``POST /telemetry`` (gang metrics pushes), ``GET
    /status``, ``GET /jobs.json``, and the cluster observability
    surface ``GET /metrics`` / ``/metrics.json`` /
    ``/history.json?series=&since=``. Binds loopback by default —
    the submit surface executes commands, so exposing it beyond the
    host is an operator's explicit choice."""

    def __init__(self, scheduler, host="127.0.0.1", port=0):
        super(SchedulerControl, self).__init__()
        self.scheduler = scheduler
        self._server = ThreadingHTTPServer((host, port),
                                           _ControlHandler)
        self._server.owner = self
        self._server.daemon_threads = True
        self.address = self._server.server_address
        # spawned gangs learn where to push their registry deltas
        scheduler.metrics_url = (
            "http://127.0.0.1:%d/telemetry" % self.address[1])
        self._thread = None

    @property
    def port(self):
        return self.address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="sched-control")
        self._thread.start()
        self.info("scheduler control on %s:%d", *self.address)
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
