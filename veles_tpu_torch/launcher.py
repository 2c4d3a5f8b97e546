"""The launcher (``veles_tpu/launcher.py``): run-mode selection, the
device, and the master/slave control plane.

A :class:`Launcher` runs its workflow in one of three modes:

* **standalone** (neither ``-l`` nor ``-m``): ``initialize`` resolves the
  device (``-a/--backend`` and ``-d/--device``: ``auto``, the default, is
  the CUDA card and raises without one; ``cpu`` is the only way onto the
  CPU), applies ``--test`` (``set_testing``) and initializes the workflow
  on the device; ``run`` runs the workflow's own runner
  (``make_fused_runner``), or else :class:`~veles_tpu_torch.train.
  runner.FusedRunner`, or the eager per-unit scheduler
  (``Workflow.run``) on ``--eager`` and for a graph ``fused_compatible``
  refuses (said in the log). ``run_mode_used`` names the one that ran.
* **master** (``-l HOST:PORT``): holds the weights and does no compute.
  It has no device by design: its workflow is initialized on the host
  (CPU tensors, whatever ``-a`` says), it never stages the dataset and
  never builds or launches a kernel. It serves jobs over the
  :mod:`~veles_tpu_torch.parallel.coordinator` -- segment jobs of
  ``--segment-size`` minibatches when the workflow has the standard
  trainable shape, one-minibatch jobs otherwise -- and merges the
  slaves' deltas. Payloads ride :mod:`~veles_tpu_torch.parallel.wire`:
  out-of-band array chunks through shared memory for a same-host slave,
  zlib frames otherwise; ``--exchange-dtype`` sends parameter deltas
  after the first full push (``bfloat16`` casts them). The exchange is
  measured as ``veles_exchange_bytes_total{slave,direction}``,
  ``veles_exchange_encode_ms{slave}`` and ``veles_exchange_decode_ms
  {slave}``, and every span carries the run's trace id (handed to the
  slaves in the handshake). ``--auto-resume DIR`` snapshots the master
  on every closed epoch and, on a restart, resumes from the newest
  loadable snapshot there, replaying the open epoch from its start.
  ``-n/--nodes`` spawns slaves (``--respawn`` relaunches dead ones).
* **slave** (``-m HOST:PORT``): resolves the card as the standalone
  launcher does (raising without one unless given ``-a cpu``), joins the
  master (``--secret-file`` for the mutual HMAC handshake) and runs its
  jobs: segment jobs through ``train.segment.SegmentExecutor`` (the
  port's ``FusedTrainer``, or an eager replay on ``--eager``),
  one-minibatch jobs through ``Workflow.do_job``. ``--no-pipeline``
  keeps one job in flight (exact sequential SGD); ``--reconnect-s``
  re-handshakes with a restarted master; ``--slave-death-probability``
  makes it die mid-job (chaos). Its per-job times (decode, compute,
  encode, and the wait for each exchange) are in
  :attr:`Launcher.job_log`.

Not in the port yet, and refused with ``NotImplementedError``:
``--gspmd`` (the ``torch.distributed`` tier).
"""

import threading
import time
import uuid

import torch

from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry
from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.parallel import wire
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.telemetry.registry import get_registry

#: the JAX launcher's flags the port refuses, and what they wait for
NOT_PORTED = {
    "gspmd": "--gspmd waits for the port's torch.distributed tier",
}

#: the keyword arguments :class:`Launcher` takes
KWARGS = frozenset([
    "listen_address", "master_address", "backend", "device", "testing",
    "eager", "slave_death_probability", "job_timeout",
    "heartbeat_timeout", "heartbeat_interval", "nodes", "respawn",
    "segment_size", "pipeline", "secret_file", "max_frame_mb",
    "exchange_dtype", "exchange_eps", "auto_resume", "straggler_drop_s",
    "reconnect_s"]) | frozenset(NOT_PORTED)


def _blob_nbytes(blob):
    return blob.nbytes if isinstance(blob, wire.Chunks) else len(blob)


def parse_address(spec, default_host="127.0.0.1", default_port=5000):
    """``host:port`` | ``:port`` | ``port`` -> (host, port); loopback by
    default (binding wide takes an explicit ``-l 0.0.0.0:port``, best
    with ``--secret-file``)."""
    if isinstance(spec, (tuple, list)):
        return tuple(spec)
    spec = str(spec)
    if ":" in spec:
        host, port = spec.rsplit(":", 1)
        return (host or default_host, int(port or default_port))
    if spec.isdigit():
        return (default_host, int(spec))
    return (spec, default_port)


def resolve_backend(backend="auto", device=None):
    """The ``torch.device`` of ``-a/--backend`` and ``-d/--device``."""
    index = int(device) if device not in (None, "") else None
    backend = backend or "auto"
    if backend == "cpu":
        return torch.device("cpu")
    if backend not in ("auto", "cuda"):
        raise ValueError("backend must be auto, cuda or cpu, got %r"
                         % (backend,))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass -a cpu to "
            "run its plain PyTorch versions")
    return torch.device("cuda", index if index is not None else 0)


class Launcher(Logger, metaclass=CommandLineArgumentsRegistry):
    """Owns the mode, the device and the coordinator."""

    def __init__(self, **kwargs):
        super(Launcher, self).__init__()
        unknown = set(kwargs) - KWARGS
        if unknown:
            raise TypeError("unknown Launcher argument(s) %s"
                            % ", ".join(sorted(unknown)))
        for key in NOT_PORTED:
            if kwargs.get(key):
                raise NotImplementedError(NOT_PORTED[key])
        self.listen_address = kwargs.get("listen_address")
        self.master_address = kwargs.get("master_address")
        if self.listen_address and self.master_address:
            raise ValueError("cannot be both master (-l) and slave (-m)")
        self.backend = kwargs.get("backend") or "auto"
        self.device_index = kwargs.get("device")
        self.device = None
        self.testing = kwargs.get("testing", False)
        self.eager = kwargs.get("eager", False)
        self.slave_death_probability = kwargs.get(
            "slave_death_probability") or 0.0
        self.job_timeout = kwargs.get("job_timeout")
        self.heartbeat_timeout = kwargs.get("heartbeat_timeout") or 10.0
        self.heartbeat_interval = kwargs.get("heartbeat_interval") or 2.0
        self.nodes = kwargs.get("nodes")
        self.respawn = kwargs.get("respawn", False)
        #: minibatches a segment job (1: one-minibatch jobs)
        self.segment_size = kwargs.get("segment_size") or 8
        #: slave: prefetch the next job while computing (one job of
        #: weight staleness); False is strict request-reply
        pipeline = kwargs.get("pipeline")
        self.pipeline = True if pipeline is None else bool(pipeline)
        dtype = kwargs.get("exchange_dtype")
        self.exchange_dtype = None if dtype in (None, "none") else dtype
        self.exchange_eps = float(kwargs.get("exchange_eps") or 0.0)
        #: the shared secret: --secret-file, else VELES_TPU_SECRET
        self.secret = None
        secret_file = kwargs.get("secret_file")
        if secret_file:
            with open(secret_file) as fin:
                # an empty file must not become a zero-entropy secret
                self.secret = fin.read().strip() or None
        if self.secret is None:
            self.secret = env_knob("VELES_TPU_SECRET")
        mb = kwargs.get("max_frame_mb")
        self.max_frame = int(mb * 1024 * 1024) if mb else None
        self.auto_resume = kwargs.get("auto_resume") or \
            env_knob("VELES_AUTO_RESUME")
        drop_s = kwargs.get("straggler_drop_s")
        if drop_s is None:
            drop_s = env_knob("VELES_STRAGGLER_DROP_S", parse=float)
        self.straggler_drop_s = None if drop_s in (None, "") \
            else float(drop_s)
        reconnect_s = kwargs.get("reconnect_s")
        if reconnect_s in (None, ""):
            reconnect_s = env_knob("VELES_RECONNECT_S", 30.0, parse=float)
        self.reconnect_s = float(reconnect_s)
        self.id = str(uuid.uuid4())
        self.log_id = self.id[:8]
        self.workflow = None
        self.stopped = False
        self.start_time = None
        #: "fused" / "custom" / "eager" once a standalone run chose, and
        #: "master" or "slave" in those modes
        self.run_mode_used = None
        self.runner = None
        #: slave: one dict a job -- its minibatches (and how many of
        #: them TRAIN), decode, compute and encode ms, the bytes each way
        #: and the client's waits (see ``_run_slave``)
        self.job_log = []
        self._resumed_from = None
        self._resume_complete = False
        self._last_snap_epochs = 0
        self._snapshot_lock = threading.Lock()
        self._server = None
        self._client = None
        self._executor = None
        self._node_launcher = None
        self._flight_listener = None
        self._finished = threading.Event()

    @staticmethod
    def init_parser(parser):
        parser.add_argument(
            "-l", "--listen", dest="listen_address", default=None,
            help="run as MASTER, listening for slaves on HOST:PORT")
        parser.add_argument(
            "-m", "--master", dest="master_address", default=None,
            help="run as SLAVE of the master at HOST:PORT")
        parser.add_argument(
            "--test", dest="testing", action="store_true",
            help="run the workflow in testing (forward-only) mode")
        parser.add_argument(
            "--eager", action="store_true",
            help="run the eager per-unit scheduler instead of the fused "
                 "trainer (a slave replays segment jobs eagerly)")
        parser.add_argument(
            "--gspmd", nargs="?", const="auto", default=None,
            metavar="MESH", help="the GSPMD path (not in the port yet)")
        parser.add_argument(
            "--slave-death-probability", type=float, default=0.0,
            help="chaos: probability a slave dies mid-job")
        parser.add_argument(
            "--job-timeout", type=float, default=None,
            help="master: drop a slave whose job overruns this many "
                 "seconds (adaptive mean+3sigma otherwise)")
        parser.add_argument(
            "-n", "--nodes", default=None,
            help="master: spawn slaves on these hosts over SSH "
                 "(host[,host*N,...]; localhost runs them directly)")
        parser.add_argument(
            "--respawn", action="store_true",
            help="master: relaunch dead slaves with backoff")
        parser.add_argument(
            "--segment-size", type=int, default=8,
            help="minibatches per distributed job (master); 1 is the "
                 "one-minibatch-per-job protocol")
        parser.add_argument(
            "--secret-file", dest="secret_file", default=None,
            help="file holding the shared secret of the master<->slave "
                 "HMAC handshake (VELES_TPU_SECRET env is the fallback)")
        parser.add_argument(
            "--max-frame-mb", dest="max_frame_mb", type=float,
            default=None,
            help="master/slave: raise the per-connection binary frame "
                 "cap (default 256 MB)")
        parser.add_argument(
            "--no-pipeline", dest="pipeline", action="store_false",
            help="slave: strict request-reply instead of prefetching "
                 "the next job while computing")
        parser.add_argument(
            "--exchange-dtype", dest="exchange_dtype", default="none",
            choices=["none", "float32", "bfloat16"],
            help="master: after the first full weight push, send "
                 "per-leaf parameter deltas to each slave; bfloat16 "
                 "also casts them")
        parser.add_argument(
            "--exchange-eps", dest="exchange_eps", type=float,
            default=0.0,
            help="with --exchange-dtype: also skip leaves whose largest "
                 "delta is <= EPS")
        parser.add_argument(
            "--auto-resume", dest="auto_resume", default=None,
            metavar="DIR",
            help="master: snapshot to DIR on every closed epoch and, on "
                 "restart, resume from the newest loadable snapshot "
                 "there (VELES_AUTO_RESUME env is the fallback)")
        parser.add_argument(
            "--straggler-drop-s", dest="straggler_drop_s", type=float,
            default=None,
            help="master: requeue the jobs of (and drop) a slave the "
                 "health scorer has flagged straggler this many seconds")
        parser.add_argument(
            "--reconnect-s", dest="reconnect_s", type=float,
            default=None,
            help="slave: when the master vanishes mid-run, retry the "
                 "handshake with backoff for up to this many seconds "
                 "(default 30, VELES_RECONNECT_S env)")
        parser.add_argument(
            "-a", "--backend", default="auto",
            choices=["auto", "cuda", "cpu"],
            help="where to run: auto (the CUDA card, the default), cuda "
                 "or cpu (the plain PyTorch versions)")
        parser.add_argument(
            "-d", "--device", default=None,
            help="CUDA device index")
        return parser

    # -- mode --------------------------------------------------------------

    @property
    def mode(self):
        if self.listen_address:
            return "master"
        if self.master_address:
            return "slave"
        return "standalone"

    @property
    def is_standalone(self):
        return self.mode == "standalone"

    @property
    def is_master(self):
        return self.mode == "master"

    @property
    def is_slave(self):
        return self.mode == "slave"

    def add_ref(self, workflow):
        self.workflow = workflow

    def del_ref(self, workflow):
        if self.workflow is workflow:
            self.workflow = None

    def on_workflow_finished(self):
        self._finished.set()
        if self._server is not None:
            self._server.no_more_jobs = True

    # -- lifecycle ---------------------------------------------------------

    def initialize(self, **kwargs):
        """Resolve the device (the host on a master), initialize the
        workflow on it and start the mode's services."""
        if self.workflow is None:
            raise RuntimeError("no workflow attached to this launcher")
        self.start_time = time.time()
        if self.is_master:
            # masters do no compute: the weights live on the host
            self.device = torch.device("cpu")
            if self.auto_resume:
                self._try_auto_resume()
        else:
            self.device = resolve_backend(self.backend, self.device_index)
        self.workflow.add_finished_callback(self.on_workflow_finished)
        if self.testing:
            set_testing = getattr(self.workflow, "set_testing", None)
            if set_testing is None:
                raise NotImplementedError(
                    "--test: %s has no set_testing"
                    % type(self.workflow).__name__)
            set_testing(True)
        # read before initialize: the units consume their restored marks
        was_restored = bool(getattr(self.workflow,
                                    "_restored_from_snapshot_", False))
        self.workflow.initialize(device=self.device, **kwargs)
        if self.is_master:
            if was_restored and self._resumed_from is None:
                # any restored master (-w too) rewinds to the last closed
                # epoch: the merge buckets of a partial one are gone
                self._prepare_master_resume(self.workflow)
            self._start_master()
        elif self.is_slave:
            self._connect_slave()
        return self

    def _try_auto_resume(self):
        """Restore the newest loadable snapshot of the auto-resume
        directory (a corrupt newest one falls back to the one before)."""
        from veles_tpu_torch import snapshotter
        t0 = time.perf_counter()
        try:
            restored, path = snapshotter.restore_latest(self.auto_resume)
        except FileNotFoundError as e:
            self.info("auto-resume: %s -- starting fresh", e)
            return
        restored.workflow = self
        self.workflow = restored
        self._resumed_from = path
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        get_registry().histogram(
            "veles_recovery_ms",
            "Fault detection to training progress resumed",
            labels=("event",)).labels(event="restore").observe(elapsed_ms)
        history = getattr(getattr(restored, "decision", None),
                          "epoch_history", [])
        self.info("auto-resumed from %s in %.0f ms (%d epoch(s) closed)",
                  path, elapsed_ms, len(history))
        self._prepare_master_resume(restored)

    def _prepare_master_resume(self, wf):
        """Rewind a restored master to the start of its first open epoch
        (the snapshot's shuffle state replays the same order)."""
        decision = getattr(wf, "decision", None)
        loader = getattr(wf, "loader", None)
        if decision is None or loader is None:
            return
        resume_epoch = decision.prepare_resume()
        if resume_epoch is None:
            self.info("restored run is already complete; nothing to resume")
            self._resume_complete = True
            return
        loader.reset_to_epoch_start(resume_epoch)
        self._last_snap_epochs = len(decision.epoch_history)
        self.info("master resume: replaying epoch %d from its start",
                  resume_epoch)

    def _maybe_master_snapshot(self):
        """One snapshot a closed epoch into the auto-resume directory
        (the master's graph never runs, so no snapshotter unit fires)."""
        decision = getattr(self.workflow, "decision", None)
        if decision is None or \
                len(decision.epoch_history) <= self._last_snap_epochs:
            return
        if not self._snapshot_lock.acquire(blocking=False):
            return  # a sibling result thread is dumping
        try:
            if len(decision.epoch_history) <= self._last_snap_epochs:
                return
            from contextlib import ExitStack
            from veles_tpu_torch.snapshotter import (dump_workflow,
                                                     save_snapshot)
            wf = self.workflow
            with ExitStack() as stack:
                # a sibling result thread may be mid-merge: hold every
                # unit's data lock for the in-memory dump (merges take
                # one unit lock at a time, never the snapshot lock); the
                # compression and the disk write come after
                for unit in wf._distributed_units():
                    stack.enter_context(unit._data_lock_)
                payload = dump_workflow(wf)
            path, nbytes = save_snapshot(wf, self.auto_resume,
                                         payload=payload)
            self._last_snap_epochs = len(decision.epoch_history)
            self.info("master snapshot -> %s (%.1f MiB, %d epoch(s))",
                      path, nbytes / 1048576.0, self._last_snap_epochs)
        except Exception:
            # checkpointing must never kill training
            self.warning("master snapshot failed", exc_info=True)
        finally:
            self._snapshot_lock.release()

    # -- master ------------------------------------------------------------

    def _start_master(self):
        from veles_tpu_torch.parallel.coordinator import (CoordinatorServer,
                                                          NoMoreJobsError)
        from veles_tpu_torch.telemetry import health as health_mod
        from veles_tpu_torch.train.segment import segment_capable
        from veles_tpu_torch.workflow import NoMoreJobs
        workflow = self.workflow
        # the master never runs its graph: lift the initial stop by hand
        workflow.stopped = False
        segments = self.segment_size > 1 and segment_capable(workflow)
        if segments:
            self.info("serving segment jobs (%d minibatches each)",
                      self.segment_size)
        registry = get_registry()
        m_bytes = registry.counter(
            "veles_exchange_bytes_total",
            "Payload bytes exchanged with each slave",
            labels=("slave", "direction"))
        m_encode_ms = registry.histogram(
            "veles_exchange_encode_ms",
            "Master time encoding one job payload", labels=("slave",))
        m_decode_ms = registry.histogram(
            "veles_exchange_decode_ms",
            "Master time decoding one slave update", labels=("slave",))
        scorer = health_mod.get_scorer()

        def job_source(slave):
            try:
                if segments:
                    data = workflow.generate_segment_for_slave(
                        slave, max_minibatches=self.segment_size)
                else:
                    data = workflow.generate_data_for_slave(slave)
            except NoMoreJobs:
                raise NoMoreJobsError()
            if data is None:
                return None
            t0 = time.perf_counter()
            with tracing.span("exchange:encode", slave=slave.id):
                if self.exchange_dtype is not None:
                    # per-slave delta stream: a full push, then deltas (a
                    # reconnected slave starts over with a full push)
                    enc = getattr(slave, "delta_encoder", None)
                    if enc is None:
                        enc = wire.DeltaEncoder(
                            dtype=None if self.exchange_dtype == "float32"
                            else self.exchange_dtype,
                            eps=self.exchange_eps)
                        slave.delta_encoder = enc
                    data = enc.encode(data)
                # same host: out-of-band chunks copied straight into
                # shared memory; other hosts: zlib frames
                blob = wire.encode_chunks(data) if slave.sharedio \
                    else wire.encode(data, compress=True)
            encode_ms = (time.perf_counter() - t0) * 1e3
            m_encode_ms.labels(slave=slave.id).observe(encode_ms)
            # create=False: outside the coordinator's lock, a slave the
            # reaper just removed must not come back
            scorer.observe(slave.id, encode_ms=encode_ms, create=False)
            m_bytes.labels(slave=slave.id, direction="to_slave").inc(
                _blob_nbytes(blob))
            return {"blob": blob}

        def result_sink(data, slave):
            t0 = time.perf_counter()
            with tracing.span("exchange:decode", slave=slave.id):
                payload = wire.decode(data["blob"])
            decode_ms = (time.perf_counter() - t0) * 1e3
            m_decode_ms.labels(slave=slave.id).observe(decode_ms)
            scorer.observe(slave.id, decode_ms=decode_ms, create=False)
            m_bytes.labels(slave=slave.id, direction="from_slave").inc(
                _blob_nbytes(data["blob"]))
            with tracing.span("exchange:merge", slave=slave.id):
                workflow.apply_data_from_slave(payload, slave)
            if self.auto_resume:
                self._maybe_master_snapshot()

        def initial_data_source(slave):
            payload = workflow.generate_initial_data_for_slave(slave)
            loader = getattr(workflow, "loader", None)
            decision = getattr(workflow, "decision", None)
            mid_run = bool(
                getattr(loader, "_global_offset", 0) or
                getattr(loader, "epoch_number", 0) or
                getattr(decision, "epoch_history", None))
            if mid_run:
                # a slave joining a run in progress gets the live state
                payload = {
                    "units": payload,
                    "resync": workflow.generate_resync_for_slave(slave)}
            return wire.encode(payload, compress=not slave.sharedio)

        def on_slave_flight(sid, notice):
            # one correlated cluster record on the master for a slave's
            # flight-recorder trip
            from veles_tpu_torch.telemetry import federation, flight
            reason = str(notice.get("reason") or "unknown")
            self.warning("slave %s flight record (%s): %s", sid, reason,
                         notice.get("path"))
            flight.get_recorder().dump(
                "cluster_" + reason, slave=sid,
                slave_record=notice.get("path"),
                slave_context=notice.get("context"),
                trace_id=notice.get("trace_id") or
                federation.get_federation().run_info.get("trace_id"),
                cluster=federation.cluster_report())

        bind = parse_address(self.listen_address)
        if self.secret is None and bind[0] not in (
                "127.0.0.1", "localhost", "::1"):
            self.warning(
                "master listening on %s WITHOUT a shared secret -- any "
                "peer that can reach the port can submit results; set "
                "--secret-file or VELES_TPU_SECRET", bind[0])
        self._server = CoordinatorServer(
            address=bind, checksum=workflow.checksum,
            job_timeout=self.job_timeout,
            heartbeat_timeout=self.heartbeat_timeout,
            job_source=job_source, result_sink=result_sink,
            on_drop=workflow.drop_slave,
            initial_data_source=initial_data_source, secret=self.secret,
            max_frame=self.max_frame, on_slave_flight=on_slave_flight,
            straggler_drop_s=self.straggler_drop_s)
        if self._resume_complete:
            self._server.no_more_jobs = True
        # every span of this run carries one trace id; the slaves adopt
        # it from the handshake
        tracing.set_default_trace_id(self._server.trace_id)
        self.info("master listening on %s:%d", *self._server.address)
        if self.nodes:
            self._spawn_nodes()

    def _spawn_nodes(self):
        import socket as socket_mod
        import sys
        from veles_tpu_torch.parallel.nodes import (NodeLauncher,
                                                    slave_command_from_argv)
        host, port = self._server.address
        if host in ("127.0.0.1", "::1"):
            self.warning(
                "--nodes with a loopback listen address: remote slaves "
                "cannot reach this master -- pass -l 0.0.0.0:%d (with "
                "--secret-file) for remote nodes", port)
        if host in ("", "0.0.0.0", "::"):
            host = socket_mod.gethostname()
        advertise = (host, port)
        command = slave_command_from_argv(sys.argv[1:], advertise)
        self._node_launcher = NodeLauncher(
            self.nodes, command, master_address=advertise,
            respawn=self.respawn).start()

    def _run_master(self):
        # no compute: wait for the workflow's stop (NoMoreJobs) or stop()
        while not self._finished.wait(0.1):
            if self._server.no_more_jobs and not any(
                    s.current_job or s.applying
                    for s in self._server.snapshot_slaves()):
                self._finished.set()
        # let idle slaves collect their "done" replies and leave cleanly
        deadline = time.time() + 5.0
        while self._server.snapshot_slaves() and time.time() < deadline:
            time.sleep(0.05)

    # -- slave -------------------------------------------------------------

    def _connect_slave(self):
        from veles_tpu_torch.parallel.coordinator import CoordinatorClient
        from veles_tpu_torch.telemetry import flight
        self._client = CoordinatorClient(
            parse_address(self.master_address),
            checksum=self.workflow.checksum,
            power=self.workflow.computing_power,
            death_probability=self.slave_death_probability,
            pipeline=self.pipeline, secret=self.secret,
            max_frame=self.max_frame,
            heartbeat_interval=self.heartbeat_interval,
            reconnect_s=self.reconnect_s)

        def on_reconnect(client):
            # a (possibly restarted) master: adopt its trace id and its
            # initial data / resync, as on a fresh join
            if client.trace_id:
                tracing.set_default_trace_id(client.trace_id)
            if client.initial_data is not None:
                self.workflow.apply_initial_data_from_master(
                    wire.decode(client.initial_data))

        self._client.on_reconnect = on_reconnect
        self._client.connect()
        if self._client.trace_id:
            tracing.set_default_trace_id(self._client.trace_id)
        self.info("connected to master as slave %s", self._client.id)
        client = self._client

        def notify(reason, path, context):
            if not reason.startswith("cluster_"):
                client.notify_flight(reason, path, context)

        self._flight_listener = notify
        flight.get_recorder().add_dump_listener(notify)
        if self._client.initial_data is not None:
            self.workflow.apply_initial_data_from_master(
                wire.decode(self._client.initial_data))

    def _run_slave(self):
        from veles_tpu_torch.train.segment import SegmentExecutor
        workflow = self.workflow
        self._executor = executor = SegmentExecutor(workflow,
                                                    eager=self.eager)
        sharedio = self._client.proto._shm_tx
        # rebuilds --exchange-dtype delta pushes; full pushes pass
        delta = wire.DeltaDecoder()

        def handler(job):
            t0 = time.perf_counter()
            payload = delta.decode(wire.decode(job["blob"]))
            t1 = time.perf_counter()
            if isinstance(payload, dict) and "batches" in payload:
                update = executor.execute(payload)
                batches = payload["batches"]
            else:
                update = workflow.do_job(payload)
                batches = [p for name, p in payload
                           if name == workflow.loader.name]
            t2 = time.perf_counter()
            blob = wire.encode_chunks(update) if sharedio \
                else wire.encode(update, compress=True)
            t3 = time.perf_counter()
            self.job_log.append({
                "batches": len(batches),
                "train_batches": sum(b["class"] == TRAIN for b in batches),
                "decode_ms": (t1 - t0) * 1e3,
                "compute_ms": (t2 - t1) * 1e3, "encode_ms": (t3 - t2) * 1e3,
                "bytes_in": _blob_nbytes(job["blob"]),
                "bytes_out": _blob_nbytes(blob)})
            return {"blob": blob}

        try:
            self._client.serve_forever(handler)
        finally:
            executor.close()
        # the client's waits of each job (one entry a handler call)
        for entry, waits in zip(self.job_log, self._client.job_log):
            entry.update(waits)

    # -- run ---------------------------------------------------------------

    def run(self):
        """Run to completion in the current mode."""
        try:
            if self.is_master:
                self.run_mode_used = "master"
                self._run_master()
            elif self.is_slave:
                self.run_mode_used = "slave"
                self._run_slave()
            else:
                self._run_standalone()
        finally:
            self.stop()
        return self.workflow

    def _run_standalone(self):
        """The workflow's own runner, the standard ``FusedRunner``, or
        the eager scheduler (``--eager``, or a graph the fused path
        refuses)."""
        from veles_tpu_torch.train.runner import FusedRunner, \
            fused_compatible
        workflow = self.workflow
        if self.eager:
            self.info("running the eager per-unit scheduler (--eager)")
            self._run_eager()
            return
        runner = workflow.make_fused_runner()
        if runner is not None:
            self.run_mode_used = "custom"
        else:
            reason = fused_compatible(workflow)
            if reason is not None:
                self.info("fused path unavailable (%s); running eager",
                          reason)
                self._run_eager()
                return
            self.run_mode_used = "fused"
            runner = FusedRunner(workflow)
        self.runner = runner
        runner.run()

    def _run_eager(self):
        self.run_mode_used = "eager"
        self.runner = None
        self.workflow.run()

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        self._finished.set()
        if self._flight_listener is not None:
            from veles_tpu_torch.telemetry import flight
            flight.get_recorder().remove_dump_listener(
                self._flight_listener)
            self._flight_listener = None
        if self._client is not None:
            self._client.close()
        if self._node_launcher is not None:
            self._node_launcher.stop()
        if self._server is not None:
            self._server.stop()

    def __repr__(self):
        return "<Launcher %s mode=%s on %s>" % (self.log_id, self.mode,
                                                self.device)
