"""The elastic SPMD tier (``veles_tpu/parallel/elastic.py``).

A world of ``torch.distributed`` ranks (:mod:`~veles_tpu_torch.parallel.
mesh`, one process per rank) dies when any rank is lost: the survivors
wedge in a collective, and a process group cannot re-form at a new world
size in place. This module turns that into a bounded restart, with the
JAX package's parts and protocol:

* :class:`RendezvousServer`: generation-numbered membership for the
  per-host supervisors, newline-delimited JSON over one TCP connection
  each (``join``, ``hb`` with federated telemetry, ``set_coord`` /
  ``coord``, ``worker_exit``, ``leave``). A generation is one agreed
  membership: ``(generation, world_size, rank)`` for each member and the
  world's store address, published by its rank 0. A member's death (its
  connection closing, or heartbeat silence) breaks the generation; the
  survivors re-form after a settle window at the surviving size.
* :class:`ElasticSupervisor`: the per-host process that owns the worker.
  It starts the worker with the generation in ``VELES_ELASTIC_*``,
  watches it and the rendezvous, SIGKILLs the worker's process group on
  a break (a survivor wedged in a gloo collective is killed, never left
  to wait out ``mesh.MESH_TIMEOUT``), and joins the next generation:
  a fresh process is the world's re-formation primitive, as in JAX.
* :func:`run_elastic_training`: the worker's side. It joins the world
  (:func:`init_distributed`, ``launcher.join_world``: the port's one way
  to start a rank), restores the newest complete sharded checkpoint
  generation (``snapshotter.restore_latest``: a generation written at
  world N loads at world M), rewinds the loader to the last closed epoch
  (``decision.prepare_resume``, ``loader.reset_to_epoch_start``) and
  trains a :class:`~veles_tpu_torch.parallel.gspmd.GSPMDTrainer`,
  cutting a sharded generation at every closed epoch through the
  trainer's ``epoch_callback`` (:func:`save_elastic_checkpoint`), and a
  generation-initial one on a fresh start.

The port's trainer keeps the history and ``best_*`` on itself, where the
JAX trainer keeps them on the workflow's decision unit. So the worker
hands the decision's ``epoch_history`` list to the trainer (the same
list: an epoch the trainer closes is in the decision the checkpoint
pickles) and copies ``best_metric`` / ``best_epoch`` each way; the test
hooks read ``len(trainer.epoch_history)`` where JAX reads
``trainer.decision.epoch_history``.

**Determinism.** Every rank derives the same index matrices from the
checkpointed ``prng`` streams and takes its columns of each minibatch;
the loss and metrics are reduced over the gathered batch. A run killed
and restored from its last complete generation at the same grid replays
the lost epoch on the same minibatches and equals the uninterrupted run
bit for bit; at another world size only the gradient sums' order moves.

Telemetry (:func:`_metrics`): ``veles_mesh_generation``,
``veles_spmd_world_size``, ``veles_spmd_participants_lost_total{reason}``
(the port's ``spmd_participant_lost`` alert rule watches it) and
``veles_spmd_recovery_ms{event}`` (``reform``: break to the new
generation formed; ``respawn``: the break seen to the new worker
started; ``restore``: the checkpoint loaded and rewound). A worker that
fails dumps a flight record with its generation, rank, job and trace id.

CLI::

    # the membership service (one per world)
    python -m veles_tpu_torch.parallel.elastic rendezvous --port 4710 \\
        --expected 2

    # one per host: supervise the training process
    python -m veles_tpu_torch.parallel.elastic supervise \\
        --rdzv 10.0.0.1:4710 --snapshots /ckpt/run17 -- \\
        python train_my_world.py

    # the built-in demo worker (on the card; -a cpu for the CPU)
    python -m veles_tpu_torch.parallel.elastic worker-demo --out hist.json
"""

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from veles_tpu_torch.envknob import env_flag, env_knob
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.parallel.retry import retry_with_backoff

#: the env contract between supervisor and worker
ENV_GEN = "VELES_ELASTIC_GEN"
ENV_WORLD = "VELES_ELASTIC_WORLD"
ENV_RANK = "VELES_ELASTIC_RANK"
ENV_COORD = "VELES_ELASTIC_COORD"
ENV_SNAPSHOTS = "VELES_ELASTIC_SNAPSHOTS"
#: the job's identity: one trace id a job, carried into every worker so
#: its spans and flight records correlate under it
ENV_TRACE = "VELES_ELASTIC_TRACE"
ENV_JOB = "VELES_ELASTIC_JOB"
ENV_TENANT = "VELES_ELASTIC_TENANT"
#: test hook ``"<rank>:<epochs_done>"``: that rank's worker SIGKILLs
#: itself at that epoch boundary, before the epoch's generation is cut
ENV_TEST_DIE = "VELES_ELASTIC_TEST_DIE"
#: the same, but the worker raises (and leaves a flight record)
ENV_TEST_FAIL = "VELES_ELASTIC_TEST_FAIL"


def _metrics():
    from veles_tpu_torch.telemetry.registry import get_registry
    r = get_registry()
    return {
        "generation": r.gauge(
            "veles_mesh_generation",
            "Current elastic SPMD mesh generation number"),
        "world": r.gauge(
            "veles_spmd_world_size",
            "World size of the current SPMD generation"),
        "lost": r.counter(
            "veles_spmd_participants_lost_total",
            "SPMD participants lost (worker crash, supervisor death, "
            "heartbeat silence)", labels=("reason",)),
        "recovery": r.histogram(
            "veles_spmd_recovery_ms",
            "SPMD recovery latencies (reform: break -> new generation "
            "formed; respawn: break verdict -> replacement worker "
            "spawned; restore: checkpoint load + rewind)",
            labels=("event",)),
    }


def _free_port(host="127.0.0.1"):
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


# -- the rendezvous service ---------------------------------------------------


class RendezvousServer(Logger):
    """Generation-numbered membership for the elastic supervisors.

    Formation: generation 0 waits for ``expected`` members when given
    (the first world assembles whole); a later one forms with the members
    waiting once their set has been stable for ``settle_s`` (and holds at
    least ``min_workers``): the shrink after a loss and the regrowth when
    a replaced host rejoins. A member whose worker crashed waits for its
    supervisor's next ``join`` (the JAX server sets it waiting at the
    break, so a supervisor about to leave can be formed into the next
    generation and break it again). A member is lost when its connection closes
    (at once) or after ``heartbeat_timeout_s`` of silence; losing one of
    the running generation breaks it. The server itself failing is out of
    scope: run it beside the job, where the job would be restarted from.
    """

    def __init__(self, port=0, host="127.0.0.1", min_workers=1,
                 expected=None, settle_s=1.0, heartbeat_timeout_s=5.0,
                 absorb_joins=False):
        super(RendezvousServer, self).__init__()
        self.min_workers = int(min_workers)
        self.expected = int(expected) if expected else None
        self.settle_s = float(settle_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.absorb_joins = bool(absorb_joins)
        self._lock = threading.RLock()
        self._members = {}  # token -> state dict
        self.generation = 0
        self.phase = "forming"  # forming | running | done
        self.world_size = 0
        self._coords = {}  # generation -> "host:port"
        self._last_change = time.monotonic()
        self._break_at = None
        self.lost_total = 0
        self.last_recovery_s = None
        self._metrics = _metrics()
        #: the members' federated telemetry, made on the first beat that
        #: carries some
        self._federation = None
        self._federation_lock = threading.Lock()
        self._stop = threading.Event()
        self._conns = set()
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.address = self._listener.getsockname()
        self._threads = []

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        for target, name in ((self._accept_loop, "rdzv-accept"),
                             (self._reap_loop, "rdzv-reaper")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        self.info("rendezvous serving on %s:%d (expected=%s "
                  "min_workers=%d settle=%.1fs)", self.address[0],
                  self.address[1], self.expected, self.min_workers,
                  self.settle_s)
        return self

    def stop(self):
        """Stop serving and close every member connection (their serving
        threads end with them)."""
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    # -- connections -------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="rdzv-conn").start()

    def _serve_conn(self, conn):
        member = None
        with self._lock:
            self._conns.add(conn)
        try:
            fin = conn.makefile("rb")
            fout = conn.makefile("wb")
            while not self._stop.is_set():
                line = fin.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except ValueError:
                    break
                member = msg.get("member", member)
                reply = self._handle(msg)
                telemetry = msg.get("telemetry")
                if telemetry is not None and member is not None:
                    # merged outside self._lock: a delta's merge must not
                    # serialize against the membership's dispatch
                    try:
                        reply.update(self._absorb_telemetry(member,
                                                            telemetry))
                    except Exception:  # noqa: BLE001 -- never the beat
                        self.debug("telemetry of %s dropped", member,
                                   exc_info=True)
                with self._lock:
                    # this connection is the member's current lifeline
                    state = self._members.get(member)
                    if state is not None:
                        state["conn_"] = conn
                fout.write(json.dumps(reply).encode() + b"\n")
                fout.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                self._conns.discard(conn)
                state = self._members.get(member)
                # a member that reconnected owns a newer lifeline: this
                # connection's end is stale and evicts nobody
                stale = state is not None and state.get("conn_") is not conn
            if member is not None and not stale and \
                    not self._stop.is_set():
                # a killed supervisor's kernel closes its socket: the fast
                # death detection (heartbeat age is the backstop)
                self._remove_member(member, reason="connection_lost")

    # -- federated telemetry -----------------------------------------------

    def federation(self):
        """The server's :class:`~veles_tpu_torch.telemetry.federation.
        FederatedRegistry` (made on first use)."""
        with self._federation_lock:
            if self._federation is None:
                from veles_tpu_torch.telemetry.federation import \
                    FederatedRegistry
                self._federation = FederatedRegistry()
            return self._federation

    def _absorb_telemetry(self, member, delta):
        """Merge one beat's delta; the reply's hints (``{"resync":
        True}`` after a sequence gap)."""
        hints = self.federation().apply(member, delta)
        with self._lock:
            live = member in self._members
        if not live:
            # reaped between the dispatch and the merge: the feed must
            # not outlive the membership
            self._federation.remove_slave(member)
            return {}
        return hints or {}

    # -- the protocol ------------------------------------------------------

    def _handle(self, msg):
        cmd = msg.get("cmd")
        member = msg.get("member")
        with self._lock:
            state = self._members.get(member)
            if state is not None:
                # every command is a proof of life
                state["last_seen"] = time.monotonic()
            if cmd == "join":
                return self._join(member)
            if cmd == "hb":
                return self._heartbeat(member, msg.get("gen"))
            if cmd == "set_coord":
                self._coords[int(msg["gen"])] = msg["addr"]
                return {"status": "ok"}
            if cmd == "coord":
                gen = int(msg["gen"])
                return {"status": "ok", "addr": self._coords.get(gen),
                        "current_gen": self.generation,
                        "phase": self.phase}
            if cmd == "worker_exit":
                return self._worker_exit(member, msg.get("gen"),
                                         int(msg.get("code", 1)))
            if cmd == "leave":
                self._remove_member(member, reason="leave")
                return {"status": "ok"}
        return {"status": "error", "error": "unknown cmd %r" % cmd}

    def _join(self, member):
        """Register or refresh a member. The caller holds
        ``self._lock``."""
        if self.phase == "done":
            return {"status": "done"}
        state = self._members.get(member)
        if state is None:
            state = self._members[member] = {
                "state": "waiting", "rank": None, "gen": None,
                "last_seen": time.monotonic()}
            self._last_change = time.monotonic()
            self.info("member %s joined (now %d waiting)", member,
                      sum(1 for m in self._members.values()
                          if m["state"] == "waiting"))
            if self.phase == "running" and self.absorb_joins:
                self._break_generation("absorb_join", lost=False)
        state["last_seen"] = time.monotonic()
        if self.phase == "running" and state["gen"] == self.generation:
            return {"status": "assigned", "gen": self.generation,
                    "world": self.world_size, "rank": state["rank"]}
        if state["state"] != "waiting":
            state["state"] = "waiting"
            state["gen"] = None
        self._maybe_form()
        if self.phase == "running" and state["gen"] == self.generation:
            return {"status": "assigned", "gen": self.generation,
                    "world": self.world_size, "rank": state["rank"]}
        return {"status": "wait"}

    def _heartbeat(self, member, gen):
        state = self._members.get(member)
        if self.phase == "done":
            return {"status": "done"}
        if state is None:
            return {"status": "restart"}  # reaped: join from scratch
        state["last_seen"] = time.monotonic()
        if self.phase == "running" and state["gen"] == self.generation \
                and gen == self.generation:
            return {"status": "ok"}
        return {"status": "restart"}

    def _worker_exit(self, member, gen, code):
        state = self._members.get(member)
        if state is None:
            # reaped while its worker died: whatever reaped it is the cause
            return {"status": "restart", "stale": True}
        state["last_seen"] = time.monotonic()
        if gen != self.generation or self.phase != "running":
            # the generation had broken before this worker died: its
            # death is collateral (a peer's loss aborted its collective)
            return {"status": "restart", "stale": True}
        if code == 0:
            state["state"] = "done"
            current = [m for m in self._members.values()
                       if m["gen"] == self.generation]
            if current and all(m["state"] == "done" for m in current):
                self.phase = "done"
                self.info("generation %d complete (world %d)",
                          self.generation, self.world_size)
            return {"status": "done" if self.phase == "done" else "ok"}
        self._break_generation("worker_crash(%s, rc=%s)" % (member, code))
        # the crashed member is formed again only after its supervisor's
        # next join: one leaving with its crash budget spent is never
        # drawn into the next generation first (which the survivors
        # would form at once, whole, and break again at its leave)
        state["state"] = "exited"
        return {"status": "restart"}

    # -- the membership's state machine ------------------------------------

    def _remove_member(self, member, reason):
        with self._lock:
            state = self._members.pop(member, None)
            if state is None:
                return
            self._last_change = time.monotonic()
            in_current = (self.phase == "running" and
                          state["gen"] == self.generation)
            self.info("member %s removed (%s)%s", member, reason,
                      " -- breaking generation %d" % self.generation
                      if in_current else "")
            if in_current:
                self._break_generation("%s(%s)" % (reason, member))
        with self._federation_lock:
            federation = self._federation
        if federation is not None:
            federation.remove_slave(member)

    def _break_generation(self, reason, lost=True):
        """A member of the running generation is gone (or a join is
        absorbed): the next generation forms from the survivors. The
        caller holds ``self._lock``."""
        if self.phase != "running":
            return
        if lost:
            self.lost_total += 1
            self._metrics["lost"].labels(
                reason=reason.split("(")[0]).inc()
        self.warning("generation %d broken: %s -- re-forming at the "
                     "surviving world size", self.generation, reason)
        self.generation += 1
        self.phase = "forming"
        self._break_at = time.monotonic()
        self._last_change = time.monotonic()
        for state in self._members.values():
            state["state"] = "waiting"
            state["gen"] = None
            state["rank"] = None

    def _maybe_form(self):
        if self.phase != "forming":
            return
        waiting = sorted(token for token, m in self._members.items()
                         if m["state"] == "waiting")
        if not waiting:
            return
        now = time.monotonic()
        if self.generation == 0 and self.expected:
            # the first world assembles whole: a slow host must not be
            # raced into a smaller first generation
            if len(waiting) < self.expected:
                return
        else:
            if len(waiting) < self.min_workers:
                return
            full = self.expected is not None and \
                len(waiting) >= self.expected
            if not full and now - self._last_change < self.settle_s:
                return
        for rank, token in enumerate(waiting):
            state = self._members[token]
            state["state"] = "running"
            state["gen"] = self.generation
            state["rank"] = rank
        self.world_size = len(waiting)
        self.phase = "running"
        self._metrics["generation"].set(self.generation)
        self._metrics["world"].set(self.world_size)
        if self._break_at is not None:
            self.last_recovery_s = now - self._break_at
            self._metrics["recovery"].labels(event="reform").observe(
                self.last_recovery_s * 1e3)
            self._break_at = None
        self.info("generation %d formed: world=%d members=%s",
                  self.generation, self.world_size, waiting)

    def _reap_loop(self):
        while not self._stop.is_set():
            time.sleep(0.25)
            with self._lock:
                if self.phase == "done":
                    continue
                now = time.monotonic()
                stale = [token for token, m in self._members.items()
                         if now - m["last_seen"] > self.heartbeat_timeout_s]
            for token in stale:
                self._remove_member(token, reason="heartbeat_timeout")
            with self._lock:
                self._maybe_form()


class RendezvousClient(object):
    """The supervisor's side of the protocol: one persistent
    connection, dialled (and redialled) through the shared jittered
    backoff."""

    def __init__(self, address, member, dial_budget_s=60.0):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self.address = tuple(address)
        self.member = member
        self.dial_budget_s = dial_budget_s
        self._lock = threading.Lock()
        self._sock = None
        self._fin = self._fout = None
        self._closed = False
        self._connect(dial_budget_s)

    def _connect(self, budget_s):
        def attempt():
            sock = socket.create_connection(self.address, timeout=10.0)
            self._sock = sock
            self._fin = sock.makefile("rb")
            self._fout = sock.makefile("wb")

        retry_with_backoff(
            attempt, budget_s, give_up=lambda e: self._closed,
            describe="could not reach the rendezvous at %s:%d"
                     % self.address)

    def _request(self, msg, reconnect_budget_s=10.0):
        msg = dict(msg, member=self.member)

        def attempt():
            if self._sock is None:
                self._connect(reconnect_budget_s)
            try:
                self._fout.write(json.dumps(msg).encode() + b"\n")
                self._fout.flush()
                line = self._fin.readline()
                if not line:
                    raise ConnectionError("rendezvous closed the "
                                          "connection")
                return json.loads(line)
            except (OSError, ValueError) as e:
                self._teardown()
                raise ConnectionError(str(e))

        with self._lock:
            return retry_with_backoff(
                attempt, reconnect_budget_s, base_s=0.1,
                give_up=lambda e: self._closed,
                describe="rendezvous request to %s:%d failed"
                         % self.address)

    def _teardown(self):
        for f in (self._fin, self._fout, self._sock):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        self._sock = self._fin = self._fout = None

    # -- commands ----------------------------------------------------------

    def join_wait(self, poll_s=0.2, timeout_s=None):
        """Block until this member is assigned into a generation: the
        assignment, or None when the whole run completed meanwhile."""
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        while True:
            reply = self._request({"cmd": "join"})
            status = reply.get("status")
            if status == "assigned":
                return reply
            if status == "done":
                return None
            if deadline and time.monotonic() > deadline:
                raise TimeoutError("rendezvous did not form a generation "
                                   "in %.0fs" % timeout_s)
            time.sleep(poll_s)

    def heartbeat(self, gen):
        return self.heartbeat_full(gen).get("status")

    def heartbeat_full(self, gen, telemetry=None):
        """The whole heartbeat reply; ``telemetry`` (a
        ``SnapshotEncoder`` delta) rides the beat, and the reply may
        carry a ``resync`` hint for the encoder."""
        msg = {"cmd": "hb", "gen": gen}
        if telemetry is not None:
            msg["telemetry"] = telemetry
        return self._request(msg)

    def set_coord(self, gen, addr):
        self._request({"cmd": "set_coord", "gen": gen, "addr": addr})

    def get_coord_wait(self, gen, poll_s=0.1, timeout_s=60.0):
        """The generation's store address, or None when the generation
        was superseded (or the wait ran out)."""
        deadline = time.monotonic() + timeout_s
        while True:
            reply = self._request({"cmd": "coord", "gen": gen})
            if reply.get("addr"):
                return reply["addr"]
            if reply.get("current_gen", gen) != gen or \
                    reply.get("phase") == "done":
                return None
            if time.monotonic() > deadline:
                return None
            time.sleep(poll_s)

    def worker_exit(self, gen, code):
        """The whole reply: ``status``, and ``stale`` when the generation
        had broken before this report."""
        return self._request({"cmd": "worker_exit", "gen": gen,
                              "code": code})

    def leave(self):
        try:
            self._request({"cmd": "leave"})
        except ConnectionError:
            pass

    def close(self):
        self._closed = True
        self._teardown()


# -- the per-host supervisor --------------------------------------------------


class ElasticSupervisor(Logger):
    """Owns one SPMD worker process through membership changes.

    Per generation: rendezvous, then (rank 0) publish a fresh store
    address for the world, then start the worker with the membership in
    its env, then watch. A ``restart`` verdict (another member died, or a
    join is absorbed) SIGKILLs the worker's process group -- it is wedged
    in a collective, or about to be -- and joins again; a local worker
    death is reported and counts against ``max_restarts`` (a regroup does
    not). Workers run in a session of their own, so the kill takes all of
    the worker's processes."""

    def __init__(self, rdzv_address, worker_argv, snapshot_dir=None,
                 member=None, max_restarts=3, worker_env=None,
                 poll_s=0.2, coord_host="127.0.0.1",
                 dial_budget_s=60.0, announce=False):
        super(ElasticSupervisor, self).__init__()
        self.rdzv_address = rdzv_address
        self.worker_argv = list(worker_argv)
        self.snapshot_dir = snapshot_dir
        self.member = member or ("%s-%d" % (socket.gethostname(),
                                            os.getpid()))
        self.max_restarts = int(max_restarts)
        self.worker_env = dict(worker_env or {})
        self.poll_s = float(poll_s)
        self.coord_host = coord_host
        self.dial_budget_s = dial_budget_s
        self.announce = announce
        self.worker = None  # the current subprocess.Popen
        self.generation = None
        self._metrics = _metrics()
        self._detect_t = None
        # the job's trace id rides VELES_ELASTIC_TRACE into every worker
        # (the env is copied into each start); this process's spans and
        # records carry it too
        self.trace_id = env_knob(ENV_TRACE)
        if self.trace_id:
            from veles_tpu_torch.telemetry import tracing
            tracing.set_default_trace_id(self.trace_id)
        # telemetry on the heartbeats (VELES_FEDERATION=0 turns it off)
        self._encoder = None
        if env_flag("VELES_FEDERATION", True):
            from veles_tpu_torch.telemetry.federation import SnapshotEncoder
            self._encoder = SnapshotEncoder()

    def _announce(self, name, **fields):
        if not self.announce:
            return
        print("EVENT %s t=%.6f %s"
              % (name, time.time(),
                 " ".join("%s=%s" % kv for kv in sorted(fields.items()))),
              file=sys.stderr, flush=True)

    # -- the worker --------------------------------------------------------

    def _spawn_worker(self, gen, world, rank, coord):
        env = dict(os.environ)
        env.update(self.worker_env)
        env[ENV_GEN] = str(gen)
        env[ENV_WORLD] = str(world)
        env[ENV_RANK] = str(rank)
        if coord:
            env[ENV_COORD] = coord
        else:
            env.pop(ENV_COORD, None)
        if self.snapshot_dir:
            env[ENV_SNAPSHOTS] = self.snapshot_dir
        proc = subprocess.Popen(self.worker_argv, env=env,
                                start_new_session=True)
        if self._detect_t is not None:
            self._metrics["recovery"].labels(event="respawn").observe(
                (time.monotonic() - self._detect_t) * 1e3)
            self._detect_t = None
        self.info("gen %d: spawned worker pid %d (world=%d rank=%d "
                  "coord=%s)", gen, proc.pid, world, rank, coord)
        self._announce("spmd_worker", pid=proc.pid, gen=gen, world=world,
                       rank=rank)
        return proc

    def _kill_worker(self):
        proc = self.worker
        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except OSError:
            try:
                proc.kill()
            except OSError:
                pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass

    # -- the loop ----------------------------------------------------------

    def run(self):
        """Supervise until the world completes (0) or this host gives up
        (its crash budget spent, or the rendezvous lost: 1)."""
        client = RendezvousClient(self.rdzv_address, self.member,
                                  dial_budget_s=self.dial_budget_s)
        crashes = 0
        try:
            while True:
                assignment = client.join_wait()
                if assignment is None:
                    return 0  # the world completed while we waited
                gen = assignment["gen"]
                world = assignment["world"]
                rank = assignment["rank"]
                self.generation = gen
                self._metrics["generation"].set(gen)
                self._announce("spmd_gen", gen=gen, world=world, rank=rank)
                coord = None
                if world > 1:
                    if rank == 0:
                        # a port the OS gives now: a new one each
                        # generation, never the dead world's
                        coord = "%s:%d" % (self.coord_host,
                                           _free_port(self.coord_host))
                        client.set_coord(gen, coord)
                    else:
                        coord = client.get_coord_wait(gen)
                        if coord is None:  # superseded while waiting
                            continue
                self.worker = self._spawn_worker(gen, world, rank, coord)
                verdict = self._watch(client, gen)
                if verdict == "restart":
                    self._detect_t = time.monotonic()
                    self._kill_worker()
                    self._announce("spmd_restart", gen=gen)
                    continue
                if verdict == "done":
                    return 0
                code = self.worker.returncode
                reply = client.worker_exit(gen, code)
                status = reply.get("status")
                if code == 0:
                    if status == "done":
                        return 0
                    # our worker finished, the world has not: ride along
                    # until it completes or a late break pulls us back
                    while status not in ("done", "restart"):
                        time.sleep(self.poll_s)
                        status = client.heartbeat(gen)
                    if status == "done":
                        return 0
                    continue
                if reply.get("stale"):
                    # the generation broke before our worker aborted its
                    # collective: a regroup, not our crash
                    self._detect_t = time.monotonic()
                    self._announce("spmd_restart", gen=gen, collateral=1)
                    continue
                crashes += 1
                self._detect_t = time.monotonic()
                self.warning("gen %d: worker died rc=%s (crash %d/%d)",
                             gen, code, crashes, self.max_restarts)
                self._announce("spmd_worker_died", gen=gen, code=code,
                               crashes=crashes)
                self._dump_death(gen, rank, code, crashes)
                if crashes > self.max_restarts:
                    self.error("crash budget exhausted: leaving the world")
                    client.leave()
                    return 1
        except (ConnectionError, TimeoutError) as e:
            self.error("rendezvous lost: %s", e)
            return 1
        finally:
            self._kill_worker()
            client.close()

    def _dump_death(self, gen, rank, code, crashes):
        """The supervisor's flight record of its worker's death, under the
        job's trace id (worker record -> this -> the scheduler's)."""
        try:
            from veles_tpu_torch.telemetry import flight
            flight.get_recorder().dump(
                "elastic_worker_died", gen=gen, rank=rank, code=code,
                member=self.member, crashes=crashes,
                trace_id=self.trace_id)
        except Exception:  # noqa: BLE001 -- the record never stops recovery
            self.warning("could not write the flight record", exc_info=True)

    def _watch(self, client, gen):
        """Poll the worker and the rendezvous until one moves:
        ``"exited"`` (the worker ended), ``"restart"`` (the generation
        broke elsewhere) or ``"done"``. Each beat carries this process's
        metric delta for the rendezvous's federated view."""
        while True:
            if self.worker.poll() is not None:
                return "exited"
            telemetry = None
            if self._encoder is not None:
                try:
                    telemetry = self._encoder.encode()
                except Exception:  # noqa: BLE001 -- never the beat
                    telemetry = None
            reply = client.heartbeat_full(gen, telemetry=telemetry)
            if reply.get("resync") and self._encoder is not None:
                self._encoder.mark_resync()
            status = reply.get("status")
            if status == "restart":
                return "restart"
            if status == "done":
                return "done"
            time.sleep(self.poll_s)


# -- the worker's side --------------------------------------------------------


class ElasticContext(object):
    """The membership a supervisor handed this worker process."""

    def __init__(self, generation, world_size, rank, coordinator=None,
                 snapshot_dir=None):
        self.generation = int(generation)
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.coordinator = coordinator
        self.snapshot_dir = snapshot_dir

    def __repr__(self):
        return ("ElasticContext(gen=%d, world=%d, rank=%d, coord=%r)"
                % (self.generation, self.world_size, self.rank,
                   self.coordinator))


def worker_context():
    """The :class:`ElasticContext` of the ``VELES_ELASTIC_*`` env, or
    None when no supervisor started this process (standalone training:
    every elastic path is then a no-op)."""
    world = env_knob(ENV_WORLD)
    if not world:
        return None
    return ElasticContext(
        generation=env_knob(ENV_GEN, 0), world_size=world,
        rank=env_knob(ENV_RANK, 0), coordinator=env_knob(ENV_COORD),
        snapshot_dir=env_knob(ENV_SNAPSHOTS))


def init_distributed(ctx, backend="auto", device=None):
    """Join this generation's world (nothing at world size 1) through
    ``launcher.join_world``, whose store dial retries with backoff, so a
    worker started a beat before its world's store listens does not lose
    the race. Returns the ``launcher.World`` (None at world size 1)."""
    from veles_tpu_torch.launcher import join_world
    world = join_world(coordinator=ctx.coordinator,
                       processes=ctx.world_size, process_id=ctx.rank,
                       backend=backend, device=device)
    metrics = _metrics()
    metrics["generation"].set(ctx.generation)
    metrics["world"].set(ctx.world_size)
    return world


def _test_hook(env, ctx, trainer):
    """True when ``env``'s ``"<rank>:<epochs_done>"`` names this rank at
    the epoch boundary just closed."""
    spec = env_knob(env)
    if not spec or ctx is None:
        return False
    rank, _, epochs = spec.partition(":")
    return int(rank) == ctx.rank and int(epochs) == len(
        trainer.epoch_history)


def _test_die_hook(ctx, trainer):
    if _test_hook(ENV_TEST_DIE, ctx, trainer):
        # the epoch just computed is not yet checkpointed: the restart
        # rewinds and replays it
        os.kill(os.getpid(), signal.SIGKILL)


def _test_fail_hook(ctx, trainer):
    if _test_hook(ENV_TEST_FAIL, ctx, trainer):
        # the raising twin: the worker dies through the exception path,
        # which leaves its flight record
        raise RuntimeError("induced worker failure (%s=%s)"
                           % (ENV_TEST_FAIL, env_knob(ENV_TEST_FAIL)))


class _MetricsPusher(object):
    """Rank 0's feed of a scheduler's rollup: the local registry
    delta-encoded and POSTed to ``VELES_SCHED_METRICS_URL`` every
    ``VELES_SCHED_METRICS_S`` seconds. Failures back off (jittered,
    capped) and never stall training; the first push after an outage is
    a full resync, since a restarted scheduler has an empty view."""

    BACKOFF_CAP_S = 10.0

    def __init__(self, url, job, interval_s):
        from veles_tpu_torch.telemetry.federation import SnapshotEncoder
        self.url = url
        self.job = job
        self.interval_s = interval_s
        self._encoder = SnapshotEncoder()
        self._failures = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sched-metrics-push")
        self._thread.start()

    def _push(self):
        import urllib.request
        delta = self._encoder.encode()
        if delta is None:
            return False
        body = json.dumps({"job": self.job,
                           "telemetry": delta}).encode("utf-8")
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            reply = json.loads(resp.read().decode("utf-8"))
        if reply.get("resync"):
            self._encoder.mark_resync()
        return True

    def _loop(self):
        from veles_tpu_torch.parallel.retry import backoff_delay
        wait = self.interval_s
        while not self._stop.wait(wait):
            try:
                pushed = self._push()
            except Exception:  # noqa: BLE001 -- a down scheduler is normal
                self._failures += 1
                wait = backoff_delay(min(self._failures - 1, 16),
                                     base_s=max(self.interval_s, 0.25),
                                     cap_s=self.BACKOFF_CAP_S)
            else:
                if pushed and self._failures:
                    self._failures = 0
                    self._encoder.mark_resync()
                wait = self.interval_s

    def stop(self):
        self._stop.set()
        try:
            # one last push: the final epoch reaches the scheduler
            self._push()
        except Exception:  # noqa: BLE001
            pass
        self._thread.join(timeout=5)


def _start_metrics_pusher(ctx):
    """The pusher, when a ``VELES_SCHED_METRICS_URL`` is set and this is
    rank 0 (or a standalone run)."""
    url = env_knob("VELES_SCHED_METRICS_URL")
    if not url or (ctx is not None and ctx.rank != 0):
        return None
    if not env_flag("VELES_FEDERATION", True):
        return None
    interval_s = env_knob("VELES_SCHED_METRICS_S", 0.5, parse=float,
                          on_error="default")
    return _MetricsPusher(url, env_knob(ENV_JOB, ""), interval_s)


def _sync_decision(trainer, decision):
    """The trainer's ``best_*`` into the workflow's decision (the history
    list is shared)."""
    decision.best_metric = trainer.best_metric
    decision.best_epoch = trainer.best_epoch


def save_elastic_checkpoint(trainer, ctx, params, states, workflow,
                            compression="gz"):
    """Cut one sharded generation of ``workflow`` at a complete step
    boundary: every rank writes its part, the world's barrier orders the
    writes before rank 0 commits the manifest. Returns ``(generation
    directory, bytes this rank pickled, seconds)``."""
    import torch.distributed as dist
    from veles_tpu_torch import snapshotter
    t0 = time.perf_counter()
    _sync_decision(trainer, workflow.decision)
    records = trainer.checkpoint_records(params, states)
    barrier = dist.barrier if ctx.world_size > 1 else None
    grid = getattr(trainer, "grid", None)
    gen_dir, nbytes = snapshotter.save_snapshot_sharded(
        workflow, ctx.snapshot_dir, records, process_index=ctx.rank,
        process_count=ctx.world_size, tag="_g%d" % ctx.generation,
        compression=compression, barrier=barrier, link_tag="",
        manifest_extra={"world_size": ctx.world_size,
                        "generation": ctx.generation,
                        # the source grid, so a restore at another shape
                        # can name the reshard it makes
                        "mesh_axes": None if grid is None else {
                            str(k): int(v) for k, v in grid.shape.items()}})
    return gen_dir, nbytes, time.perf_counter() - t0


def run_elastic_training(build_workflow, device=None, grid=None,
                         trainer_cls=None, trainer_kwargs=None,
                         on_epoch=None, max_epochs=None, backend="auto",
                         compression="gz"):
    """Train under the elastic supervisor: restore, rewind, train with a
    sharded generation at every closed epoch. Returns the epoch history.

    ``build_workflow(device)`` returns the workflow initialized on the
    rank's ``device`` from fixed seeds, so on a fresh start every rank
    holds the same initial state. On a restart the newest complete
    generation is restored instead, whatever world wrote it, the loader
    rewinds to the last closed epoch, and the restored ``prng`` registry
    replays the lost epoch's index matrices. ``backend`` (``auto``,
    ``cuda`` or ``cpu``) and ``device`` (a card index) place the rank as
    ``-a``/``-d`` do; ``grid`` is None (every rank on ``batch``) or a
    ``--gspmd`` spec over the world (``"batch=-1,model=2"``);
    ``compression`` is the generations' codec. Without a supervisor (no
    ``VELES_ELASTIC_*`` env) this is standalone training."""
    log = logging.getLogger("elastic")
    ctx = worker_context()
    trace_id = env_knob(ENV_TRACE)
    if trace_id:
        from veles_tpu_torch.telemetry import tracing
        tracing.set_default_trace_id(trace_id)
    world = init_distributed(ctx, backend, device) if ctx is not None \
        else None
    pusher = _start_metrics_pusher(ctx)
    try:
        return _run_elastic_training(
            log, ctx, build_workflow, _rank_device(backend, device),
            grid, trainer_cls, trainer_kwargs, on_epoch, max_epochs,
            compression)
    except Exception as e:
        try:
            # the worker's link in the incident's chain of records
            from veles_tpu_torch.telemetry import flight
            flight.get_recorder().dump(
                "elastic_worker_failed",
                error="%s: %s" % (type(e).__name__, e),
                generation=ctx.generation if ctx else None,
                rank=ctx.rank if ctx else None,
                job=env_knob(ENV_JOB), trace_id=trace_id)
        except Exception:  # noqa: BLE001 -- the error below is the news
            log.warning("could not write the flight record", exc_info=True)
        raise
    finally:
        if pusher is not None:
            pusher.stop()
        if world is not None:
            from veles_tpu_torch.parallel import mesh
            mesh.shutdown_multihost()


def _rank_device(backend, device):
    """This rank's device: the one the world gave it, else ``-a``/``-d``'s
    (the card unless ``cpu``)."""
    from veles_tpu_torch.launcher import resolve_backend
    from veles_tpu_torch.parallel import mesh
    placed = mesh.world_device()
    return placed if placed is not None else resolve_backend(backend,
                                                             device)


def _run_elastic_training(log, ctx, build_workflow, device, grid,
                          trainer_cls, trainer_kwargs, on_epoch, max_epochs,
                          compression):
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.parallel.gspmd import (GSPMDTrainer, gspmd_mesh,
                                                parse_mesh_spec)
    from veles_tpu_torch.parallel.mesh import world_size
    from veles_tpu_torch.train.runner import trainer_for
    snapdir = ctx.snapshot_dir if ctx is not None else None
    workflow = None
    if snapdir:
        from veles_tpu_torch import snapshotter
        t0 = time.perf_counter()
        try:
            workflow, restored_path = snapshotter.restore_latest(snapdir)
        except FileNotFoundError:
            workflow = None
    fresh = workflow is None
    if fresh:
        workflow = build_workflow(device)
    else:
        workflow.workflow = DummyLauncher()
        workflow.initialize(device=device)
        decision = workflow.decision
        resume_epoch = decision.prepare_resume()
        _metrics()["recovery"].labels(event="restore").observe(
            (time.perf_counter() - t0) * 1e3)
        last = max_epochs if max_epochs is not None else decision.max_epochs
        if resume_epoch is None or (last is not None and
                                    resume_epoch >= last):
            log.info("restored run %s is already complete", restored_path)
            return decision.epoch_history
        workflow.loader.reset_to_epoch_start(resume_epoch)
        log.info("restored %s; resuming from the start of epoch %d at world "
                 "size %d", restored_path, resume_epoch, ctx.world_size)
    sizes = parse_mesh_spec(grid, n=world_size())
    trainer = trainer_for(
        workflow, trainer_cls or GSPMDTrainer,
        grid=gspmd_mesh(sizes["batch"], sizes["model"], device),
        **(trainer_kwargs or {}))
    decision = workflow.decision
    # the port's trainer keeps the decision's record: the same history
    # list, best_* copied in here and out at each checkpoint
    trainer.epoch_history = decision.epoch_history
    trainer.best_metric = decision.best_metric
    trainer.best_epoch = decision.best_epoch
    if snapdir:
        def epoch_callback(tr, params, states):
            if on_epoch is not None:
                on_epoch(tr, params, states)
            _test_fail_hook(ctx, tr)
            _test_die_hook(ctx, tr)
            save_elastic_checkpoint(tr, ctx, params, states, workflow,
                                    compression)

        trainer.epoch_callback = epoch_callback
        if fresh:
            # the generation-initial restart point: a death before the
            # first epoch closes rewinds to the seed state every rank
            # agreed on, not to a re-randomized one
            save_elastic_checkpoint(trainer, ctx, trainer.params,
                                    trainer.states, workflow, compression)
    elif on_epoch is not None:
        trainer.epoch_callback = on_epoch
    try:
        trainer.train(max_epochs=max_epochs if max_epochs is not None
                      else decision.max_epochs,
                      fail_iterations=decision.fail_iterations)
    finally:
        trainer.shutdown()
    _sync_decision(trainer, decision)
    decision.complete <<= True
    gd_for = {id(gd.forward): gd for gd in getattr(workflow, "gds", ())}
    for fwd, state in zip(workflow.forwards, trainer.unit_states()):
        gd = gd_for.get(id(fwd))
        if gd is not None and state:
            gd.opt_state = state
    return decision.epoch_history


# -- CLI ----------------------------------------------------------------------


def _supervise_main(argv):
    import argparse
    worker_argv = None
    if "--" in argv:
        split = argv.index("--")
        worker_argv = argv[split + 1:]
        argv = argv[:split]
    parser = argparse.ArgumentParser(
        prog="veles-elastic supervise",
        description="per-host elastic SPMD supervisor")
    parser.add_argument("--rdzv", required=True, metavar="HOST:PORT",
                        help="rendezvous server address")
    parser.add_argument("--member", default=None,
                        help="stable member token (default host-pid)")
    parser.add_argument("--snapshots", default=None, metavar="DIR",
                        help="sharded checkpoint directory (shared fs)")
    parser.add_argument("--max-restarts", type=int, default=3,
                        help="own-worker crash budget (regroup restarts "
                             "are free)")
    parser.add_argument("--worker-env", action="append", default=[],
                        metavar="K=V", help="extra worker env "
                        "(repeatable)")
    parser.add_argument("--coord-host", default="127.0.0.1",
                        help="address rank 0 publishes for the world's "
                             "store")
    parser.add_argument("--poll-s", type=float, default=0.2)
    args = parser.parse_args(argv)
    if not worker_argv:
        parser.error("worker command required after `--`")
    env = {}
    for item in args.worker_env:
        key, _, value = item.partition("=")
        env[key] = value
    supervisor = ElasticSupervisor(
        args.rdzv, worker_argv, snapshot_dir=args.snapshots,
        member=args.member, max_restarts=args.max_restarts,
        worker_env=env, poll_s=args.poll_s, coord_host=args.coord_host,
        announce=True)
    return supervisor.run()


def _rendezvous_main(argv):
    import argparse
    parser = argparse.ArgumentParser(
        prog="veles-elastic rendezvous",
        description="elastic SPMD rendezvous anchor")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--min-workers", type=int, default=1)
    parser.add_argument("--expected", type=int, default=None)
    parser.add_argument("--settle-s", type=float, default=1.0)
    parser.add_argument("--hb-timeout-s", type=float, default=5.0)
    parser.add_argument("--absorb-joins", action="store_true")
    args = parser.parse_args(argv)
    server = RendezvousServer(
        port=args.port, host=args.host, min_workers=args.min_workers,
        expected=args.expected, settle_s=args.settle_s,
        heartbeat_timeout_s=args.hb_timeout_s,
        absorb_joins=args.absorb_joins).start()
    print("RENDEZVOUS %s:%d" % server.address, flush=True)
    try:
        while server.phase != "done":
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


class _DemoProvider(object):
    """The demo worker's deterministic synthetic digits, the JAX demo's
    bytes (a module-level class: a snapshot may pickle it)."""

    def __init__(self, samples, valid):
        self.samples = samples
        self.valid = valid

    def __call__(self):
        import numpy
        rng = numpy.random.RandomState(5)

        def mk(n):
            return (rng.rand(n, 8, 8).astype(numpy.float32),
                    rng.randint(0, 10, n).astype(numpy.int32))

        tx, ty = mk(self.samples)
        vx, vy = mk(self.valid)
        return tx, ty, vx, vy


def _worker_demo_main(argv):
    """The demo worker: a small seeded ``MnistWorkflow`` (the JAX demo's
    data, widths and rate) through :func:`run_elastic_training`, under a
    supervisor or bare. Writes the per-epoch validation error to
    ``--out`` (JSON) and, with ``--state-out``, each epoch's training
    losses and the final parameters to an ``.npz``."""
    import argparse
    parser = argparse.ArgumentParser(prog="veles-elastic worker-demo")
    parser.add_argument("--out", required=True,
                        help="write the per-epoch validation curve here "
                             "(JSON)")
    parser.add_argument("--samples", type=int, default=640)
    parser.add_argument("--valid", type=int, default=128)
    parser.add_argument("--mb", type=int, default=64)
    parser.add_argument("--layers", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=0.08)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epoch-sleep", type=float, default=0.0,
                        help="sleep per epoch boundary (a window to kill "
                             "into)")
    parser.add_argument("-a", "--backend", default="auto",
                        help="auto or cuda (the card), or cpu")
    parser.add_argument("-d", "--device", default=None,
                        help="the card's index")
    parser.add_argument("--state-out", default=None, metavar="NPZ",
                        help="write the training losses and the final "
                             "parameters here")
    args = parser.parse_args(argv)

    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mnist import MnistWorkflow

    def build(device):
        prng.get().seed(args.seed)
        prng.get("loader").seed(args.seed + 1)
        wf = MnistWorkflow(DummyLauncher(),
                           provider=_DemoProvider(args.samples, args.valid),
                           layers=(args.layers,), minibatch_size=args.mb,
                           learning_rate=args.lr, max_epochs=args.epochs)
        wf.initialize(device=device)
        return wf

    on_epoch = None
    if args.epoch_sleep:
        def on_epoch(trainer, params, states):
            time.sleep(args.epoch_sleep)

    trained = {}

    def keep(trainer, params, states):
        if on_epoch is not None:
            on_epoch(trainer, params, states)
        trained["trainer"] = trainer

    history = run_elastic_training(
        build, device=args.device, backend=args.backend, on_epoch=keep)
    curve = [e["validation"]["normalized"] for e in history]
    _write_atomic(args.out, lambda f: json.dump(curve, f), "w")
    ctx = worker_context()
    if args.state_out and "trainer" in trained and (
            ctx is None or ctx.rank == 0):
        import numpy
        from veles_tpu_torch.convert import params_to_jax
        # the modules hold the whole parameters after training (a
        # sharded layer's gathered by the trainer's unit_states)
        arrays = {"%d.%s" % (i, k): v for i, layer in enumerate(
            params_to_jax(trained["trainer"].forwards))
            for k, v in layer.items()}
        arrays["losses"] = numpy.stack(
            [numpy.asarray(e["train"]["losses"]) for e in history])
        _write_atomic(args.state_out,
                      lambda f: numpy.savez(f, **arrays), "wb")
    print("worker-demo done: %s" % curve, flush=True)
    return 0


def _write_atomic(path, write, mode):
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        write(f)
    os.replace(tmp, path)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "supervise":
        return _supervise_main(rest)
    if cmd == "rendezvous":
        return _rendezvous_main(rest)
    if cmd == "worker-demo":
        return _worker_demo_main(rest)
    print("unknown command %r (supervise | rendezvous | worker-demo)"
          % cmd, file=sys.stderr)
    return 2


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
