"""Host-side coordination service (``veles_tpu/parallel/coordinator.py``):
the master/slave control plane.

The master holds the weights and does no compute; slaves pull jobs,
train and push deltas back. This is the
*control* plane the reference ran over Twisted TCP JSON lines
(``veles/server.py``, ``veles/client.py``, ``network_common.py:132``):

* handshake with workflow **checksum** verification (a slave running a
  different graph is rejected — ``server.py:484-492``);
* slave registry with per-slave FSM (WAIT→WORK→...), ``computing_power``
  load metric, heartbeats with timeout-based **death detection**;
* a generic **job queue** for task farming (genetics chromosomes,
  ensemble members, dataset shards): jobs held by a dead slave are
  **requeued** (``loader/base.py:679-687`` semantics);
* **chaos injection**: ``death_probability`` makes a slave kill itself
  mid-job (the reference's ``--slave-death-probability``,
  ``client.py:303-307``) so elasticity is testable in-process.

Implementation is stdlib sockets + threads (no Twisted): JSON lines,
one reader thread per connection on the master, a single client thread
on the slave. Job payloads must be JSON-serializable.
"""

import collections
import hmac
import json
import os
import secrets
import select
import socket
import threading
import time
import uuid

from veles_tpu_torch import prng
from veles_tpu_torch.envknob import env_flag, env_knob
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.parallel import wire
from veles_tpu_torch.telemetry import federation, health, tracing
from veles_tpu_torch.telemetry.registry import get_registry


def _blob_len(data):
    """bytes or :class:`wire.Chunks` -> payload length."""
    return data.nbytes if isinstance(data, wire.Chunks) else len(data)


#: shm segment names CREATED by this process (Protocol senders, the
#: same-host challenge). An in-process peer (master+slave in one
#: process: tests, the dryrun) that attaches to one of these must NOT
#: deregister it from the resource tracker — register/unregister is a
#: plain set in the tracker, so the receiver's unregister would erase
#: the OWNER's registration and the owner's later unlink would
#: double-unregister, spraying ``KeyError: '/psm_...'`` tracebacks
#: from the tracker process at teardown.
_OWNED_SHM = set()
_OWNED_SHM_LOCK = threading.Lock()


def _own_segment(seg):
    with _OWNED_SHM_LOCK:
        _OWNED_SHM.add(seg._name)
    return seg


def _disown_segment(seg):
    with _OWNED_SHM_LOCK:
        _OWNED_SHM.discard(seg._name)


def _unregister_foreign(seg):
    """Drop the tracker registration CPython adds on every attach —
    the sender owns the segment — unless this very process is the
    sender (in-process peer), whose registration must survive for its
    own unlink."""
    with _OWNED_SHM_LOCK:
        if seg._name in _OWNED_SHM:
            return
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass


def _machine_id():
    """This host's id, which only nominates a peer for the same-host
    challenge: the kernel's boot id where Linux has one (every process
    of the host reads the same), else the node id ``uuid`` derives from
    a network card, which is random in each process of a host that has
    none."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip() or hex(uuid.getnode())
    except OSError:
        return hex(uuid.getnode())


class NoMoreJobsError(Exception):
    """Raised by a ``job_source`` when the workflow ran out of work."""


class Protocol(object):
    """JSON control line + length-prefixed binary frames, with an
    optional same-host shared-memory fast path.

    ``bytes`` values anywhere in a message ride AFTER the JSON line as
    raw frames (8-byte big-endian length prefix) — the reference's
    txzmq streamed pickles the same way (``txzmq/connection.py:283-339``)
    instead of inflating them 33% through base64. The JSON line carries
    ``{"__bin__": i}`` placeholders in traversal order.

    When both peers share a machine (``enable_sharedio()`` after the
    handshake's nonce-proven same-host check), large payloads go
    through ONE sender-owned ``multiprocessing.shared_memory`` segment
    — the socket carries only ``{"__shm__": name, "off": o, "size": n}``.
    The segment is reused across messages and regrown on demand: the
    re-design of the reference's ``txzmq/sharedio.py:44-106`` + the
    IOOverflow regrow (``server.py:156-167``). Safe because a segment
    is never rewritten while the peer still reads it (request↔reply,
    or the bounded-pipeline discipline of the slave protocol where the
    reply to the message that carried a ref arrives before reuse).
    """

    #: blobs below this stay inline (shm setup isn't free)
    SHM_THRESHOLD = 64 * 1024
    #: refuse binary frames beyond this (hostile length prefix) —
    #: 256 MiB default; raise per-instance for genuinely huge models
    MAX_FRAME = 1 << 28
    #: refuse messages whose binary frames sum beyond this: a single
    #: JSON line full of placeholders must not buffer unbounded memory
    #: before any authentication ran
    MAX_MESSAGE = 1 << 30
    #: cap on the JSON control line itself (readline would otherwise
    #: buffer a newline-free stream unboundedly); generous because the
    #: legacy path may inline sub-64KB "blob" strings in the JSON
    MAX_LINE = 1 << 24

    def __init__(self, sock, max_frame=None):
        if max_frame is not None:
            # genuinely huge models (a full VGG-scale parameter pickle
            # is >268 MB) raise the cap per-connection; the message cap
            # scales with it
            self.MAX_FRAME = max_frame
            self.MAX_MESSAGE = max(4 * max_frame, Protocol.MAX_MESSAGE)
            self.MAX_LINE = max(max_frame, Protocol.MAX_LINE)
        self.sock = sock
        if sock.family in (socket.AF_INET, socket.AF_INET6):
            # a message is a line and its frames, then a wait for the
            # reply: Nagle's algorithm against the peer's delayed ACK
            # would hold every small tail ~40 ms
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._file = sock.makefile("rwb")
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()
        self._shm_tx = False
        self._shm_rx = False
        # double-buffered: with the pipelined slave protocol up to TWO
        # of this sender's messages can be unread at the peer, so
        # consecutive sends must not share a segment (send i+2 reuses
        # send i's slot, which the bounded pipeline guarantees is read)
        self._segments = [None, None]
        self._seg_turn = 0
        self.shm_sends = 0
        self.shm_reads = 0
        self.shm_regrows = 0
        #: ms spent copying blobs into shared memory (the sending
        #: thread's, under ``_wlock``) and out of it (the reading
        #: thread's): two counters, so neither thread's add loses the
        #: other's
        self.shm_send_ms = 0.0
        self.shm_read_ms = 0.0

    @property
    def shm_ms(self):
        """ms spent copying blobs into and out of shared memory."""
        return self.shm_send_ms + self.shm_read_ms

    # -- sharedio ----------------------------------------------------------

    def enable_sharedio(self):
        """Opt in after the handshake's same-host proof. Both
        directions: sending offloads blobs, and receiving will
        dereference ``__shm__`` refs — a protocol that never enabled
        sharedio (remote peer, feed sockets) treats such refs as plain
        data, so untrusted input cannot make us attach to arbitrary
        local segments."""
        self._shm_tx = True
        self._shm_rx = True

    def _segment_for(self, size):
        from multiprocessing import shared_memory
        turn = self._seg_turn
        self._seg_turn = (turn + 1) % len(self._segments)
        seg = self._segments[turn]
        if seg is not None and seg.size >= size:
            return seg
        if seg is not None:  # regrow
            seg.close()
            seg.unlink()
            _disown_segment(seg)
            self.shm_regrows += 1
        # 25% slack so payloads whose size oscillates between cycles
        # (delta pushes vs full pushes, varying batch counts) reuse the
        # segment instead of regrowing every other send
        seg = _own_segment(shared_memory.SharedMemory(
            create=True,
            size=max(size + (size >> 2), self.SHM_THRESHOLD)))
        self._segments[turn] = seg
        return seg

    # -- send path ---------------------------------------------------------

    def _pack(self, value, bins, shm_items):
        """Transform a message for the wire: bytes → binary-frame or
        shm markers; legacy big-str ``"blob"`` values → shm (utf-8).
        shm candidates are only *collected* here (two-pass: the segment
        must be sized for ALL of a message's blobs before writing — a
        regrow between writes would unlink bytes an earlier ref still
        points to); the caller fills the placeholder dicts after.

        A user dict that happens to look like one of our markers
        (``{"__bin__": int}`` alone, or containing ``__shm__`` /
        ``__esc__``) is wrapped in ``{"__esc__": ...}`` so the receiver
        never mistakes payload data for a frame/segment reference."""
        if isinstance(value, (bytes, wire.Chunks)):
            # Chunks (scatter/gather array payloads, wire.encode_chunks)
            # behave exactly like bytes on the wire: the shm path
            # memcpys each part straight into the segment and the frame
            # path writes them back-to-back under one length prefix —
            # either way the peer receives one contiguous blob
            if self._shm_tx and _blob_len(value) >= self.SHM_THRESHOLD:
                ref = {}
                shm_items.append((ref, value, "b"))
                return ref
            bins.append(value)
            return {"__bin__": len(bins) - 1}
        if isinstance(value, dict):
            out = {}
            for key, item in value.items():
                if key == "blob" and isinstance(item, str) and \
                        self._shm_tx and len(item) >= self.SHM_THRESHOLD:
                    ref = {}
                    shm_items.append((ref, item.encode("utf-8"), "s"))
                    out[key] = ref
                else:
                    out[key] = self._pack(item, bins, shm_items)
            if self._collides(value):
                return {"__esc__": out}
            return out
        if isinstance(value, (list, tuple)):
            return [self._pack(item, bins, shm_items) for item in value]
        return value

    @staticmethod
    def _collides(value):
        """True if a raw user dict would read back as a wire marker."""
        return ("__shm__" in value or "__esc__" in value or
                ("__bin__" in value and len(value) == 1 and
                 type(value["__bin__"]) is int))

    @staticmethod
    def _is_bin_marker(value):
        return ("__bin__" in value and len(value) == 1 and
                type(value["__bin__"]) is int)

    def send(self, message):
        # pack + write under the write lock: the shared segment must not
        # be overwritten while a previous ref is still in flight
        with self._wlock:
            bins = []
            shm_items = []
            message = self._pack(message, bins, shm_items)
            if shm_items:
                t0 = time.perf_counter()
                # 64-byte-align every blob so OOB array views decoded
                # straight from the segment land cacheline-aligned
                total = 0
                for _, data, _ in shm_items:
                    total += (-total) % 64 + _blob_len(data)
                seg = self._segment_for(total)
                offset = 0
                for ref, data, kind in shm_items:
                    offset += (-offset) % 64
                    size = _blob_len(data)
                    if isinstance(data, wire.Chunks):
                        pos = offset
                        for part in data.parts:
                            seg.buf[pos:pos + len(part)] = part
                            pos += len(part)
                    else:
                        seg.buf[offset:offset + size] = data
                    ref.update({"__shm__": seg.name, "off": offset,
                                "size": size, "kind": kind})
                    offset += size
                    self.shm_sends += 1
                self.shm_send_ms += (time.perf_counter() - t0) * 1e3
            self._file.write((json.dumps(message) + "\n").encode())
            for data in bins:
                self._file.write(_blob_len(data).to_bytes(8, "big"))
                if isinstance(data, wire.Chunks):
                    for part in data.parts:
                        self._file.write(part)
                else:
                    self._file.write(data)
            self._file.flush()

    # -- receive path ------------------------------------------------------

    def _read_exact(self, n):
        data = self._file.read(n)
        if data is None or len(data) != n:
            raise ConnectionError("peer closed mid-frame")
        return data

    @classmethod
    def _count_bins(cls, value):
        if isinstance(value, dict):
            if cls._is_bin_marker(value):
                return 1
            if "__esc__" in value and len(value) == 1 and \
                    isinstance(value["__esc__"], dict):
                # escaped user dict: its top-level shape is data, but
                # its values may hold genuine markers
                return sum(cls._count_bins(v)
                           for v in value["__esc__"].values())
            return sum(cls._count_bins(v) for v in value.values())
        if isinstance(value, list):
            return sum(cls._count_bins(v) for v in value)
        return 0

    def _unpack(self, value, bins):
        if isinstance(value, dict):
            if self._is_bin_marker(value):
                i = value["__bin__"]
                if not 0 <= i < len(bins):
                    raise ConnectionError(
                        "binary frame index %d out of range" % i)
                return bins[i]
            if "__esc__" in value and len(value) == 1 and \
                    isinstance(value["__esc__"], dict):
                return {k: self._unpack(v, bins)
                        for k, v in value["__esc__"].items()}
            if "__shm__" in value and self._shm_rx:
                self.shm_reads += 1
                t0 = time.perf_counter()
                raw = self._read_shm_ref(value)
                self.shm_read_ms += (time.perf_counter() - t0) * 1e3
                return raw
            return {k: self._unpack(v, bins) for k, v in value.items()}
        if isinstance(value, list):
            return [self._unpack(v, bins) for v in value]
        return value

    @staticmethod
    def _read_shm_ref(value):
        from multiprocessing import shared_memory
        try:
            seg = shared_memory.SharedMemory(name=value["__shm__"])
        except (OSError, ValueError) as e:
            raise ConnectionError("stale sharedio ref: %s" % e)
        # CPython's SharedMemory registers every attach with THIS
        # process's resource tracker, which would unlink the sender's
        # live segment when we exit — deregister (unless this process
        # IS the sender: an in-process peer must not erase the owner's
        # registration)
        _unregister_foreign(seg)
        try:
            off = int(value.get("off", 0))
            size = int(value["size"])
            if off < 0 or size < 0 or off + size > seg.size:
                # stale ref after a regrow, or a hostile peer: a silent
                # slice-truncation would hand a corrupt blob to the
                # decoder instead of failing here
                raise ConnectionError(
                    "sharedio ref out of bounds: off=%d size=%d "
                    "segment=%d" % (off, size, seg.size))
            raw = bytes(seg.buf[off:off + size])
        finally:
            seg.close()  # sender owns the segment; never unlink
        return raw.decode("utf-8") if value.get("kind") == "s" else raw

    def recv(self):
        with self._rlock:
            # bounded readline: an unauthenticated peer streaming an
            # endless newline-free "line" must not buffer unbounded
            # memory before json/auth ever run
            line = self._file.readline(self.MAX_LINE + 1)
            if not line:
                raise ConnectionError("peer closed")
            if not line.endswith(b"\n"):
                if len(line) > self.MAX_LINE:
                    raise ConnectionError(
                        "control line exceeds %d bytes" % self.MAX_LINE)
                raise ConnectionError("peer closed mid-line")
            message = json.loads(line)
            bins = []
            total = 0
            for _ in range(self._count_bins(message)):
                n = int.from_bytes(self._read_exact(8), "big")
                if n > self.MAX_FRAME:
                    raise ConnectionError("oversized frame (%d)" % n)
                total += n
                if total > self.MAX_MESSAGE:
                    raise ConnectionError(
                        "message exceeds %d bytes" % self.MAX_MESSAGE)
                bins.append(self._read_exact(n))
        return self._unpack(message, bins)

    def close(self):
        try:
            self._file.close()
            self.sock.close()
        except OSError:
            pass
        for i, seg in enumerate(self._segments):
            if seg is not None:
                try:
                    seg.close()
                    seg.unlink()
                except (OSError, FileNotFoundError):
                    pass
                _disown_segment(seg)
                self._segments[i] = None


def _prove_same_host(proto):
    """Server side of the same-host challenge.

    The client's machine-id is self-reported (a guessable MAC-derived
    value the server also discloses), so it must never gate the shm
    fast path by itself: a remote peer spoofing it could make the
    master attach to arbitrary named local segments. Instead the master
    writes a random nonce into a segment IT owns and asks the peer to
    echo it — readable only by a process on the same machine.
    """
    from multiprocessing import shared_memory
    raw = secrets.token_bytes(32)
    try:
        seg = _own_segment(shared_memory.SharedMemory(create=True,
                                                      size=64))
    except OSError:
        return False
    try:
        seg.buf[:len(raw)] = raw
        proto.send({"shm_challenge": seg.name, "nonce_len": len(raw)})
        answer = proto.recv()
        proof = answer.get("proof") if isinstance(answer, dict) else None
        expected = hmac.new(raw, b"veles-shm-proof",
                            "sha256").hexdigest()
        return isinstance(proof, str) and \
            hmac.compare_digest(proof, expected)
    except (ConnectionError, OSError):
        return False
    finally:
        try:
            seg.close()
            seg.unlink()
        except OSError:
            pass
        _disown_segment(seg)


def _answer_same_host(proto, challenge):
    """Client side: prove we can read the master's nonce segment.

    The answer is an HMAC keyed by the segment's bytes, never the bytes
    themselves — a fake master naming some OTHER process's segment in
    its challenge must not turn this into an arbitrary-shm-read oracle
    (the server would receive only a keyed digest of that segment's
    prefix, not its contents). A peer that cannot attach (different
    machine, or shm unavailable) answers ``None`` and the fast path
    stays off — plain socket framing still works."""
    from multiprocessing import shared_memory
    name = challenge.get("shm_challenge")
    n = int(challenge.get("nonce_len", 0))
    proof = None
    if isinstance(name, str) and 0 < n <= 64:
        try:
            seg = shared_memory.SharedMemory(name=name)
        except (OSError, ValueError):
            seg = None
        if seg is not None:
            _unregister_foreign(seg)
            try:
                raw = bytes(seg.buf[:min(n, seg.size)])
                proof = hmac.new(raw, b"veles-shm-proof",
                                 "sha256").hexdigest()
            finally:
                seg.close()
    return {"cmd": "shm_proof", "proof": proof}


def _peer_closed(sock):
    """Whether the peer of ``sock`` has closed it (EOF or reset), read
    without blocking and without taking a byte off the stream."""
    if sock is None:
        return False
    try:
        # readable now, or it is open with nothing to read; the peek
        # then cannot wait, whatever timeout the socket carries
        if not select.select([sock], [], [], 0)[0]:
            return False
        return sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
    except (BlockingIOError, InterruptedError):
        return False
    except (OSError, ValueError):
        return True  # reset, or already closed on this side


class SlaveDescription(object):
    """Master-side view of one slave (``veles/server.py:494-511``)."""

    def __init__(self, sid, power, mid, pid):
        self.id = sid
        self.power = power
        self.mid = mid
        self.pid = pid
        self.state = "WAIT"
        self.jobs_done = 0
        self.last_seen = time.time()
        #: jobs handed out and not yet resolved, oldest first — the
        #: pipelined slave protocol keeps up to MAX_IN_FLIGHT open
        #: (the reference's balance counter, ``server.py:377-398``)
        self.jobs_in_flight = []
        #: proven same-host (payload codec decisions read this)
        self.sharedio = False
        # True while result_sink is merging this slave's update: the
        # reaper must not drop/requeue mid-merge (double training)
        self.applying = False
        # clean-exit markers: the server replied done=True, or the
        # client announced a voluntary exit ({"cmd": "bye"}) — a
        # connection dying WITHOUT either mid-run is a crash
        self.done_sent = False
        self.said_bye = False
        #: the main connection's socket (the reaper peeks it for EOF)
        self.sock = None

    @property
    def current_job(self):
        return self.jobs_in_flight[0] if self.jobs_in_flight else None


class CoordinatorServer(Logger):
    """Master: accepts slaves, verifies checksum, farms jobs out.

    A slave may hold up to :attr:`MAX_IN_FLIGHT` unresolved jobs — the
    async pipelining of the reference (``client.py:433-437`` overlaps
    the update upload with the next job fetch; the server's balance
    counter ``server.py:377-398`` bounds the run-ahead)."""

    MAX_IN_FLIGHT = 2

    #: overrun floor for a slave's FIRST jobs: they absorb its kernel
    #: compile (segment shapes it has never seen — e.g. the varied
    #: batch counts a mid-epoch resume replays), which the adaptive
    #: mean+3σ of the WARM fleet's job history knows nothing about.
    #: Without the floor, a master restarted onto a warm history drops
    #: every rejoining slave mid-first-compile and the fleet churns.
    WARMUP_JOBS = 2
    WARMUP_TIMEOUT = 180.0

    def __init__(self, address=("127.0.0.1", 0), checksum="",
                 job_timeout=None, heartbeat_timeout=10.0,
                 job_source=None, result_sink=None, on_drop=None,
                 initial_data_source=None, secret=None, max_frame=None,
                 on_slave_flight=None, straggler_drop_s=None):
        super(CoordinatorServer, self).__init__()
        self.checksum = checksum
        self.max_frame = max_frame
        #: reaction layer on the health scorer's detection: a slave the
        #: HealthScorer has held in ``straggler`` state for this many
        #: seconds is dropped and its in-flight jobs requeued to the
        #: healthy fleet (None = detect-and-alert only). The dropped
        #: slave's connection closes on its NEXT request ({"error":
        #: "dropped"}), after which it may rejoin immediately through
        #: the elastic-join path with a clean health slate — pair the
        #: grace with detection long enough that a still-slow
        #: rejoiner is re-flagged rather than flapping the fleet.
        self.straggler_drop_s = straggler_drop_s
        #: shared secret: when set, every connection (jobs AND
        #: heartbeats) must complete a mutual HMAC challenge before any
        #: payload is accepted — the role of nothing in the reference,
        #: which trusted the network (``veles/server.py:484``)
        self.secret = secret.encode() if isinstance(secret, str) else secret
        self.job_timeout = job_timeout
        self.heartbeat_timeout = heartbeat_timeout
        # dynamic mode (master/slave training): when the static queue is
        # empty, jobs come from job_source(slave) and results go to
        # result_sink(data, slave) — the reference's per-slave
        # generate_data_for_slave / apply_data_from_slave dispatch
        # (``server.py:596-611``, ``server.py:401-414``).
        self.job_source = job_source
        self.result_sink = result_sink
        self.on_drop = on_drop
        # optional: payload delivered in the handshake reply so
        # negotiates_on_connect units get the MASTER's state
        # (``workflow.py:587-594`` generate_initial_data_for_slave)
        self.initial_data_source = initial_data_source
        self.no_more_jobs = False
        #: ONE trace id for the whole distributed run, handed to every
        #: slave in the handshake reply so master and slave spans land
        #: on a single correlated timeline (--trace-out)
        self.trace_id = uuid.uuid4().hex[:16]
        registry = get_registry()
        self._m_rtt_ms = registry.histogram(
            "veles_slave_heartbeat_rtt_ms",
            "Heartbeat round-trip as measured by the slave, "
            "aggregated here", labels=("slave",))
        self._m_job_ms = registry.histogram(
            "veles_slave_job_ms",
            "Per-job wall time from hand-out to result", labels=("slave",))
        self._m_source_ms = registry.histogram(
            "veles_job_source_ms",
            "Master time generating one job payload", labels=("slave",))
        self._m_sink_ms = registry.histogram(
            "veles_result_sink_ms",
            "Master time merging one slave update", labels=("slave",))
        self._m_jobs = registry.counter(
            "veles_jobs_total", "Jobs resolved per slave",
            labels=("slave",))
        self._m_drops = registry.counter(
            "veles_slave_drops_total", "Slaves dropped (death/timeout)")
        #: the recovery plane's own series: how many jobs
        #: membership churn forced back onto the queue, how many
        #: slaves (re)joined, and how long the fleet took to make
        #: progress again after a fault
        self._m_requeued = registry.counter(
            "veles_jobs_requeued_total",
            "In-flight jobs requeued after a slave was dropped",
            labels=("reason",))
        self._m_joins = registry.counter(
            "veles_slave_joins_total",
            "Successful slave handshakes", labels=("kind",))
        self._m_recovery_ms = registry.histogram(
            "veles_recovery_ms",
            "Fault detection to training progress resumed",
            labels=("event",))
        #: wall time of the oldest unrecovered requeue (the next
        #: resolved result closes it into veles_recovery_ms)
        self._recovery_mark = None
        self._jobs_handed = False
        self._m_hb_handler_ms = registry.histogram(
            "veles_heartbeat_handler_ms",
            "Master time absorbing one heartbeat's telemetry piggyback")
        self._m_flight_notices = registry.counter(
            "veles_cluster_flight_notices_total",
            "Flight-record notices received from slaves",
            labels=("slave",))
        #: the cluster observability plane: slave snapshot
        #: deltas merge here, the scorer rates slaves against peers,
        #: and on_slave_flight(sid, notice) fires when a slave's
        #: flight recorder trips (the launcher dumps a cluster record)
        self.federation = federation.get_federation()
        self.federation.set_run_info(trace_id=self.trace_id)
        self.health = health.get_scorer()
        self.on_slave_flight = on_slave_flight
        self.slaves = {}
        self.jobs = []                 # pending job payloads
        self.results = []
        self.job_times = []            # history for adaptive timeout
        self._lock = threading.Lock()
        self._results_cv = threading.Condition(self._lock)
        self._done = threading.Event()
        self._listener = self._bind_listener(address)
        self.address = self._listener.getsockname()
        self._threads = []
        self._accepting = True
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="coordinator-accept")
        t.start()
        self._threads.append(t)
        # independent reaper: death detection must not depend on the
        # master happening to sit in wait()
        r = threading.Thread(target=self._reap_loop, daemon=True,
                             name="coordinator-reaper")
        r.start()
        self._threads.append(r)

    @staticmethod
    def _bind_listener(address, retry_s=5.0):
        """Bind, riding out a transient EADDRINUSE on an EXPLICIT
        port: a master restarted onto its advertised address races
        its predecessor's dying sockets for a moment (auto-resume,
        auto-resume). A random port (0) never conflicts and a port held
        by a genuinely different service still fails within
        ``retry_s``."""
        import errno
        address = tuple(address)
        deadline = time.monotonic() + retry_s
        while True:
            try:
                return socket.create_server(address)
            except OSError as e:
                if e.errno != errno.EADDRINUSE or not address[1] or \
                        time.monotonic() >= deadline:
                    raise
            time.sleep(0.25)

    def _reap_loop(self):
        while not self._done.wait(min(self.heartbeat_timeout / 4, 1.0)):
            with self._lock:
                self._reap_dead()
            # periodic cluster scoring even when no heartbeat arrives
            # (a fully-silent fleet must still be re-scored), and the
            # SLO sweep — both internally throttled and lock-free
            # w.r.t. self._lock
            self.health.evaluate()
            try:
                from veles_tpu_torch.telemetry import alerts
                alerts.get_engine().evaluate()
            except Exception:
                self.warning("alert sweep failed", exc_info=True)

    # -- job management ----------------------------------------------------

    def submit(self, *payloads):
        with self._lock:
            self.jobs.extend(payloads)

    def wait(self, n_results, timeout=60.0):
        """Block until ``n_results`` results arrived (or timeout).

        Sleeps on a condition variable notified by the result path (the
        reaper thread handles death detection independently); the 1 s
        wake cap only bounds clock drift, not latency."""
        deadline = time.time() + timeout
        with self._results_cv:
            while len(self.results) < n_results:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError("only %d/%d results" %
                                       (len(self.results), n_results))
                self._results_cv.wait(min(remaining, 1.0))
            return list(self.results)

    def _adaptive_timeout(self):
        """max(mean + 3σ of history, job_timeout) — ``server.py:619-629``."""
        if self.job_timeout is None and len(self.job_times) < 3:
            return None
        if self.job_times:
            import statistics
            mean = statistics.mean(self.job_times)
            sd = statistics.pstdev(self.job_times)
            adaptive = mean + 3 * sd
            return max(adaptive, self.job_timeout or 0.0)
        return self.job_timeout

    def _reap_dead(self):
        """Requeue jobs of slaves that stopped heartbeating/overran,
        plus (with ``straggler_drop_s``) slaves the health scorer has
        held in ``straggler`` state past the grace window."""
        now = time.time()
        timeout = self._adaptive_timeout()
        for sid, slave in list(self.slaves.items()):
            if slave.applying:
                # its result already arrived and is being merged — a
                # drop now would requeue a minibatch that IS trained
                continue
            dead = now - slave.last_seen > self.heartbeat_timeout
            slave_timeout = timeout
            if slave_timeout is not None and \
                    slave.jobs_done < self.WARMUP_JOBS:
                slave_timeout = max(slave_timeout, self.WARMUP_TIMEOUT)
            overrun = (slave_timeout is not None and slave.current_job and
                       now - slave.current_job[1] > slave_timeout)
            if overrun and not dead:
                # a killed slave's job overruns too: when its socket
                # already reads EOF, the handler thread just has not
                # seen it yet, and the drop is a death
                dead = _peer_closed(slave.sock)
            if dead or overrun:
                self._drop_faulted(sid, "dead" if dead else "timeout")
        if self.straggler_drop_s is None:
            return
        for sid, row in self.health.table().items():
            slave = self.slaves.get(sid)
            if slave is None or slave.applying:
                continue
            if row["state"] == "straggler" and \
                    row["state_age_s"] >= self.straggler_drop_s:
                self._drop_faulted(sid, "straggler")

    def _drop_faulted(self, sid, reason):
        """Drop a FAULTED slave (dead/timeout/straggler): counted as a
        drop, its labeled series GC'd, its jobs requeued under
        ``reason``. Clean end-of-run disconnects never come through
        here — they keep their series for the final snapshot."""
        self.warning("dropping slave %s (%s)", sid, reason)
        self._m_drops.inc()
        # a FAULTED slave's labeled series go too (clean disconnects
        # keep theirs — end-of-run snapshots still want them): a
        # churny run replacing slaves for hours must not grow
        # {slave=...} cardinality without bound
        for family in (self._m_rtt_ms, self._m_job_ms,
                       self._m_source_ms, self._m_sink_ms,
                       self._m_jobs, self._m_flight_notices):
            family.remove(slave=sid)
        # the launcher-owned exchange families are slave-labeled too;
        # reach them by name (a static-farming server without a
        # launcher simply has none)
        registry = get_registry()
        for name in ("veles_exchange_bytes_total",
                     "veles_exchange_encode_ms",
                     "veles_exchange_decode_ms"):
            family = registry.get(name)
            if family is not None and "slave" in family.label_names:
                family.remove(slave=sid)
        self.drop_slave(sid, reason=reason)

    def drop_slave(self, sid, reason="disconnect"):
        """Unregister a slave and requeue its in-flight jobs. Caller
        holds ``self._lock`` (the reaper and the serve loop both
        enter here under it)."""
        slave = self.slaves.pop(sid, None)
        if slave is not None:
            # the federated feed and health row describe a LIVE slave:
            # GC them on every drop, clean or not
            self.federation.remove_slave(sid)
            self.health.remove(sid)
            if slave.jobs_in_flight:
                self._m_requeued.labels(reason=reason).inc(
                    len(slave.jobs_in_flight))
                if self._recovery_mark is None:
                    # closed by the next resolved result: the time the
                    # epoch could not make progress because of this
                    # fault (veles_recovery_ms{event="requeue"})
                    self._recovery_mark = time.time()
                if self.on_drop is None:
                    # static job farming: requeue the raw payloads
                    # (oldest first keeps the original order)
                    for payload, _ in reversed(slave.jobs_in_flight):
                        self.jobs.insert(0, payload)
                slave.jobs_in_flight = []
            if self.on_drop is not None:
                # dynamic mode: the workflow owns requeueing (e.g. the
                # Loader moves pending minibatches to failed_minibatches
                # and re-serves them) — re-inserting the stale payload
                # here too would train the minibatch twice
                self.on_drop(slave)

    # -- wire --------------------------------------------------------------

    def _accept_loop(self):
        while self._accepting:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            # reap finished connection threads so long-lived masters
            # with churning slaves don't grow the list unboundedly
            self._threads = [x for x in self._threads if x.is_alive()]
            t = threading.Thread(target=self._serve, args=(sock,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _authenticate(self, proto, hello):
        """Mutual HMAC challenge gating every connection when a shared
        secret is configured.

        The master proves itself FIRST (HMAC over the client's nonce)
        so a slave never answers a rogue master's challenge, then the
        client proves itself over the master's nonce. Without this
        gate, anyone who can reach the port could drive the job/result
        protocol (and pre-restricted-unpickler, execute code)."""
        if self.secret is None:
            return True
        client_nonce = hello.get("nonce")
        if not isinstance(client_nonce, str) or not client_nonce:
            return False
        server_nonce = secrets.token_hex(32)
        proto.send({"auth": server_nonce,
                    "proof": hmac.new(
                        self.secret, ("m" + client_nonce).encode(),
                        "sha256").hexdigest()})
        try:
            answer = proto.recv()
        except (ConnectionError, OSError, json.JSONDecodeError):
            return False
        expected = hmac.new(self.secret, ("s" + server_nonce).encode(),
                            "sha256").hexdigest()
        got = answer.get("proof") if isinstance(answer, dict) else None
        return isinstance(got, str) and hmac.compare_digest(got, expected)

    def _serve(self, sock):
        proto = Protocol(sock, max_frame=self.max_frame)
        sid = None
        try:
            hello = proto.recv()
            if not isinstance(hello, dict) or \
                    hello.get("cmd") not in ("handshake", "hb_attach"):
                proto.send({"error": "expected handshake"})
                return
            if not self._authenticate(proto, hello):
                proto.send({"error": "authentication failed"})
                return
            if hello.get("cmd") == "hb_attach":
                # dedicated heartbeat channel: keeps last_seen fresh even
                # while the main channel is busy executing a long job
                self._serve_heartbeats(proto, hello.get("id"))
                return
            if hello.get("checksum") != self.checksum:
                # reject incompatible workflow topology; the expected
                # value is deliberately NOT echoed (it doubles as a
                # handshake credential for job/result access)
                proto.send({"error": "checksum mismatch"})
                return
            sid = str(uuid.uuid4())[:8]
            with self._lock:
                self.slaves[sid] = SlaveDescription(
                    sid, hello.get("power", 1.0), hello.get("mid"),
                    hello.get("pid"))
                slave_desc = self.slaves[sid]
                slave_desc.sock = sock
            # same machine → job/update blobs ride shared memory, only
            # the refs cross the socket (endpoint-by-locality, the
            # reference's server.py:721-732 inproc/ipc/tcp choice).
            # The self-reported mid only *nominates* the fast path; it
            # is proven with an unforgeable challenge: a random nonce
            # written to a master-owned shm segment that only a genuine
            # same-host peer can read back.
            sharedio = False
            if hello.get("mid") == _machine_id():
                sharedio = _prove_same_host(proto)
            slave_desc.sharedio = sharedio
            reply = {"id": sid, "log_id": sid, "sharedio": sharedio,
                     "mid": _machine_id(), "trace": self.trace_id}
            if self.initial_data_source is not None:
                reply["data"] = self.initial_data_source(slave_desc)
            proto.send(reply)
            # a join after the first job was handed out is an ELASTIC
            # join: the slave entered a run already in progress (and,
            # via initial_data, received the full-push resync)
            self._m_joins.labels(
                kind="mid_run" if self._jobs_handed else "initial").inc()
            if sharedio:
                # only AFTER the handshake reply is on the wire: the
                # client enables its rx side when it parses that reply,
                # so a large initial_data blob must still go inline —
                # enabling tx first would send it as a __shm__ ref the
                # client cannot yet dereference
                proto.enable_sharedio()
            while not self._done.is_set():
                msg = proto.recv()
                reply, stop = self._handle(sid, msg)
                proto.send(reply)
                if stop:
                    return
        except (ConnectionError, json.JSONDecodeError, OSError):
            pass
        finally:
            if sid is not None:
                with self._lock:
                    slave = self.slaves.get(sid)
                    if slave is not None and not slave.said_bye and \
                            not slave.done_sent and \
                            not self._done.is_set():
                        # the connection died mid-run with neither a
                        # goodbye nor a done reply: that is a crash
                        # (SIGKILL'd slave's kernel-closed socket —
                        # the common death, far faster than the
                        # heartbeat reaper; also covers a kill landing
                        # on an IDLE instant), not a clean end-of-run
                        # exit — count it as a death so slave_dead
                        # fires and the series GC runs
                        self._drop_faulted(sid, "dead")
                    else:
                        self.drop_slave(sid)
            proto.close()

    def _handle(self, sid, msg):
        """One request → (reply, stop).

        Registry/queue state changes run under ``_lock``; the callbacks
        into the workflow (``job_source``/``result_sink``) run OUTSIDE
        it — with pod-scale payloads (full weight sets) their
        pickle/merge time would otherwise starve the heartbeat path and
        the reaper would drop live slaves mid-job. The workflow's own
        per-unit data locks (``distributable.py``) protect its state.
        """
        cmd = msg.get("cmd")
        action = None
        with self._lock:
            slave = self.slaves.get(sid)
            if slave is None:
                return {"error": "dropped"}, True
            slave.last_seen = time.time()
            if cmd == "job":
                if len(slave.jobs_in_flight) >= self.MAX_IN_FLIGHT:
                    # run-ahead bound: the pipeline may keep at most
                    # MAX_IN_FLIGHT jobs open (balance counter parity)
                    return {"job": None, "done": False,
                            "backoff": True}, False
                if self.jobs:
                    payload = self.jobs.pop(0)
                    slave.jobs_in_flight.append((payload, time.time()))
                    slave.state = "WORK"
                    self._jobs_handed = True
                    return self._job_reply(payload), False
                if self.job_source is None or self.no_more_jobs:
                    if not slave.jobs_in_flight:
                        slave.state = "IDLE"
                    if self.no_more_jobs:
                        slave.done_sent = True
                    return {"job": None, "done": self.no_more_jobs}, False
                action = "source"
            elif cmd == "result":
                if slave.jobs_in_flight:
                    # results resolve oldest-first (replies are ordered
                    # per connection, so this matches the slave's view)
                    payload, started = slave.jobs_in_flight.pop(0)
                    job_elapsed = time.time() - started
                    self.job_times.append(job_elapsed)
                    self._m_job_ms.labels(slave=sid).observe(
                        job_elapsed * 1e3)
                    self.health.observe(sid, job_ms=job_elapsed * 1e3)
                    if slave.jobs_in_flight:
                        # the prefetched job only STARTS computing now:
                        # restart its clock so the adaptive timeout and
                        # job_times measure compute, not pipeline wait
                        nxt_payload, _ = slave.jobs_in_flight[0]
                        slave.jobs_in_flight[0] = (nxt_payload,
                                                   time.time())
                slave.jobs_done += 1
                self._m_jobs.labels(slave=sid).inc()
                if self._recovery_mark is not None:
                    # first resolved result since a fault requeued
                    # jobs: training is making progress again
                    self._m_recovery_ms.labels(event="requeue").observe(
                        (time.time() - self._recovery_mark) * 1e3)
                    self._recovery_mark = None
                if not slave.jobs_in_flight:
                    slave.state = "WAIT"
                if self.result_sink is None:
                    self.results.append(msg.get("data"))
                    self._results_cv.notify_all()
                    return {"ok": True}, False
                slave.applying = True
                action = "sink"
            elif cmd == "heartbeat":
                slave.power = msg.get("power", slave.power)
                self._record_rtt(sid, msg)
                action = "heartbeat"
            elif cmd == "bye":
                # voluntary exit (max_idle, client shutdown): without
                # this goodbye a slave dying IDLE mid-run would be
                # indistinguishable from one exiting on purpose
                slave.said_bye = True
                return {"ok": True}, True
            else:
                return {"error": "unknown cmd %r" % cmd}, False

        if action == "heartbeat":
            reply = {"ok": True}
            reply.update(self._absorb_telemetry(sid, msg))
            return reply, False

        if action == "source":
            payload = None
            t0 = time.perf_counter()
            try:
                payload = self.job_source(slave)
            except NoMoreJobsError:
                self.no_more_jobs = True
            source_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                if payload is not None and sid in self.slaves:
                    # recorded under the liveness check: job_source
                    # ran outside _lock, and observing after a reap
                    # would re-mint the just-GC'd labeled child
                    self._m_source_ms.labels(slave=sid).observe(
                        source_ms)
                if sid not in self.slaves:
                    # the reaper dropped this slave while the job was
                    # being generated: the workflow registered the
                    # payload as pending for it — run the drop path once
                    # more so that registration is requeued, not lost
                    if payload is not None and self.on_drop is not None:
                        self.on_drop(slave)
                    return {"error": "dropped"}, True
                if payload is not None:
                    slave.jobs_in_flight.append((payload, time.time()))
                    slave.state = "WORK"
                    self._jobs_handed = True
                    return self._job_reply(payload), False
                if not slave.jobs_in_flight:
                    slave.state = "IDLE"
                if self.no_more_jobs:
                    slave.done_sent = True
                return {"job": None, "done": self.no_more_jobs}, False
        # action == "sink"
        t0 = time.perf_counter()
        try:
            self.result_sink(msg.get("data"), slave)
        finally:
            elapsed = time.perf_counter() - t0
            self._m_sink_ms.labels(slave=sid).observe(elapsed * 1e3)
            if tracing.enabled():
                # the master half of the exchange span: the slave half
                # (exchange:job) carries the same span_id
                trace = msg.get("trace") or {}
                tracing.add_complete(
                    "exchange:result", t0, elapsed, slave=sid,
                    trace_id=trace.get("trace_id", self.trace_id),
                    span_id=trace.get("span_id"))
            with self._lock:
                slave.applying = False
        return {"ok": True}, False

    def _job_reply(self, payload):
        """Job replies carry the run's trace id plus a per-job span id
        the slave echoes on its result — the correlation handle for
        the exchange legs."""
        return {"job": payload,
                "trace": {"trace_id": self.trace_id,
                          "span_id": uuid.uuid4().hex[:8]}}

    def _record_rtt(self, sid, msg):
        rtt = msg.get("rtt_ms")
        if isinstance(rtt, (int, float)):
            self._m_rtt_ms.labels(slave=sid).observe(float(rtt))
            self.health.observe(sid, rtt_ms=float(rtt), beat=True)
        else:
            self.health.observe(sid, beat=True)

    def _absorb_telemetry(self, sid, msg):
        """The master half of the heartbeat piggyback (runs OUTSIDE
        ``_lock``): merge the registry delta, surface flight notices,
        re-score the fleet. Returns ack hints for the reply (e.g.
        ``{"resync": True}``)."""
        t0 = time.perf_counter()
        hints = {}
        delta = msg.get("telemetry")
        if isinstance(delta, dict):
            try:
                hints = self.federation.apply(sid, delta) or {}
            except Exception:
                self.warning("federation merge failed for slave %s",
                             sid, exc_info=True)
        if isinstance(delta, dict):
            # re-check liveness AFTER the merge: this runs outside
            # _lock, so the reaper (or a clean disconnect) may have
            # dropped the slave between the handler's liveness check
            # and apply() — which would re-create the just-GC'd feed
            # as a permanent phantom
            with self._lock:
                alive = sid in self.slaves
            if not alive:
                self.federation.remove_slave(sid)
                self.health.remove(sid)
                hints = {}
        notices = msg.get("flight")
        if isinstance(notices, list):
            for notice in notices[:8]:
                if not isinstance(notice, dict):
                    continue
                reason = str(notice.get("reason") or "")
                if reason.startswith("cluster_"):
                    # never re-federate a cluster record (an in-process
                    # master+slave test shares ONE recorder — this is
                    # the recursion guard)
                    continue
                self._m_flight_notices.labels(slave=sid).inc()
                if self.on_slave_flight is not None:
                    try:
                        self.on_slave_flight(sid, notice)
                    except Exception:
                        self.warning("on_slave_flight failed for %s",
                                     sid, exc_info=True)
        self.health.evaluate()
        self._m_hb_handler_ms.observe((time.perf_counter() - t0) * 1e3)
        return hints

    def snapshot_slaves(self):
        """Consistent copy of the slave registry for outside readers."""
        with self._lock:
            return list(self.slaves.values())

    def _serve_heartbeats(self, proto, sid):
        proto.send({"ok": sid in self.slaves})
        while not self._done.is_set():
            msg = proto.recv()
            with self._lock:
                slave = self.slaves.get(sid)
                if slave is None:
                    reply, stop = {"error": "dropped"}, True
                else:
                    slave.last_seen = time.time()
                    slave.power = msg.get("power", slave.power)
                    self._record_rtt(sid, msg)
                    reply, stop = {"ok": True}, False
            if not stop:
                # federation merge / flight fan-out / health scoring
                # run OUTSIDE the registry lock so a big delta can
                # never starve the job path or the reaper
                reply.update(self._absorb_telemetry(sid, msg))
            proto.send(reply)
            if stop:
                return

    def stop(self):
        self._accepting = False
        self._done.set()
        try:
            self._listener.close()
        except OSError:
            pass


class CoordinatorClient(Logger):
    """Slave: pulls jobs, executes a callback, pushes results."""

    def __init__(self, address, checksum="", power=1.0,
                 death_probability=0.0, rand="chaos",
                 heartbeat_interval=2.0, pipeline=True, secret=None,
                 max_frame=None, federate=None, reconnect_s=None,
                 connect_retry_s=None):
        super(CoordinatorClient, self).__init__()
        self.address = tuple(address)
        self.checksum = checksum
        #: auto-resume support: when the master vanishes
        #: MID-RUN, retry a full re-handshake for up to this many
        #: seconds (exponential backoff with jitter) instead of giving
        #: up — the window a restarted master needs to restore from
        #: its latest snapshot and re-bind. 0/None = die like before.
        if reconnect_s is None:
            reconnect_s = env_knob("VELES_RECONNECT_S", 0.0,
                                   parse=float)
        self.reconnect_s = reconnect_s
        #: same budget for the INITIAL connect: a slave started before
        #: its master must not die on ConnectionRefused
        if connect_retry_s is None:
            connect_retry_s = env_knob("VELES_CONNECT_RETRY_S", 0.0,
                                       parse=float)
        self.connect_retry_s = connect_retry_s
        #: backoff shape: base * 2^n, each sleep jittered to 50-150%
        #: so a whole fleet reconnecting to a restarted master does
        #: not dial in lockstep
        self.backoff_base_s = env_knob("VELES_RECONNECT_BASE_S", 0.25,
                                       parse=float)
        #: called with this client after every successful MID-RUN
        #: reconnect (the launcher re-applies the master's initial
        #: data / resync state through it)
        self.on_reconnect = None
        self.reconnects = 0
        self._closed = False
        self.secret = secret.encode() if isinstance(secret, str) else secret
        self.max_frame = max_frame
        self.power = power
        self.death_probability = death_probability
        self.heartbeat_interval = heartbeat_interval
        #: piggyback delta-encoded registry snapshots on heartbeats so
        #: the master can serve ONE federated /metrics for the cluster
        #: (VELES_FEDERATION=0 turns the piggyback off fleet-wide)
        if federate is None:
            federate = env_flag("VELES_FEDERATION", True)
        self.federate = federate
        self._snapshot_encoder = None
        #: flight-record notices queued for the next beat (bounded: an
        #: incident storm must not balloon the heartbeat message)
        self._flight_notices = collections.deque(maxlen=16)
        self._hb_wake = threading.Event()
        #: prefetch the next job while the current one computes.
        #: Overlap costs one job of weight staleness (async SGD — the
        #: reference's balance-2 protocol had the same property);
        #: False = strict request→reply, bit-exact with standalone
        self.pipeline = pipeline
        self._rand = prng.get(rand)
        self.id = None
        #: the master's run-wide trace id (handshake reply); spans on
        #: this slave adopt it so --trace-out dumps from master and
        #: slave processes merge into one correlated timeline
        self.trace_id = None
        self.jobs_done = 0
        #: one dict a handler call: ``wait_ms`` (the job's request to
        #: its reply, or the read of a prefetched reply), ``result_ms``
        #: (the result's send to its ack) and ``shm_ms`` (shared-memory
        #: copies over the job's exchange)
        self.job_log = []
        self._hb_stop = threading.Event()

    def _answer_auth(self, proto, reply, my_nonce):
        """Verify the master's proof over OUR nonce, then answer its
        challenge — mutual authentication, master-first (see
        ``CoordinatorServer._authenticate``)."""
        if not (isinstance(reply, dict) and "auth" in reply):
            if self.secret is not None:
                # fail closed: a slave configured with a secret must
                # never downgrade to an unauthenticated master (a rogue
                # process on the master's port would otherwise feed us
                # jobs with zero authentication)
                raise ConnectionError(
                    "master did not authenticate (reply: %s)"
                    % (reply.get("error", "no auth challenge")
                       if isinstance(reply, dict) else "malformed"))
            return reply
        if self.secret is None:
            raise ConnectionError(
                "master requires a shared secret (--secret-file)")
        expected = hmac.new(self.secret, ("m" + my_nonce).encode(),
                            "sha256").hexdigest()
        if not (isinstance(reply.get("proof"), str) and
                hmac.compare_digest(reply["proof"], expected)):
            raise ConnectionError("master failed mutual authentication")
        proto.send({"cmd": "auth", "proof": hmac.new(
            self.secret, ("s" + str(reply["auth"])).encode(),
            "sha256").hexdigest()})
        return proto.recv()

    def _retry_with_backoff(self, budget_s, attempt_fn):
        """Run ``attempt_fn`` until it succeeds, retrying socket-level
        failures with exponential backoff inside a bounded budget —
        the shared :func:`veles_tpu_torch.parallel.retry.retry_with_backoff`
        shape (base * 2^n capped at 10 s, 50-150% jitter), used for
        both the initial dial (:meth:`_dial`) and the mid-run
        re-handshake (:meth:`reconnect`). Raises
        :class:`ConnectionError` when the budget is exhausted (or the
        client was closed)."""
        from veles_tpu_torch.parallel.retry import retry_with_backoff
        return retry_with_backoff(
            attempt_fn, budget_s, base_s=self.backoff_base_s,
            give_up=lambda e: self._closed,
            describe="could not reach master at %s:%d" % (
                self.address[0], self.address[1]))

    def _dial(self, budget_s):
        """TCP connect with backoff inside a bounded budget. Only
        SOCKET-level failures retry — protocol rejections (checksum,
        auth) happen after the dial and propagate immediately."""
        return self._retry_with_backoff(
            budget_s,
            lambda: socket.create_connection(self.address, timeout=10.0))

    def connect(self, retry_s=None):
        sock = self._dial(self.connect_retry_s if retry_s is None
                          else retry_s)
        self.proto = Protocol(sock, max_frame=self.max_frame)
        nonce = secrets.token_hex(32)
        self.proto.send({"cmd": "handshake", "checksum": self.checksum,
                         "power": self.power, "nonce": nonce,
                         "mid": _machine_id(), "pid": os.getpid()})
        reply = self._answer_auth(self.proto, self.proto.recv(), nonce)
        if isinstance(reply, dict) and "shm_challenge" in reply:
            # master asks for proof we really share its machine (see
            # _prove_same_host); answer and read the actual handshake
            # reply that follows
            self.proto.send(_answer_same_host(self.proto, reply))
            reply = self.proto.recv()
        if "error" in reply:
            raise ConnectionError(reply["error"])
        self.id = reply["id"]
        self.trace_id = reply.get("trace")
        self.initial_data = reply.get("data")
        if reply.get("sharedio"):
            # same machine as the master, proven by the nonce exchange:
            # updates ride shared memory
            self.proto.enable_sharedio()
        # dedicated heartbeat channel so long handler() runs don't get
        # this slave declared dead mid-job
        hb_sock = socket.create_connection(self.address, timeout=10.0)
        self._hb_proto = Protocol(hb_sock, max_frame=self.max_frame)
        hb_nonce = secrets.token_hex(32)
        self._hb_proto.send({"cmd": "hb_attach", "id": self.id,
                             "nonce": hb_nonce})
        self._answer_auth(self._hb_proto, self._hb_proto.recv(), hb_nonce)
        if self.federate:
            from veles_tpu_torch.telemetry.federation import SnapshotEncoder
            self._snapshot_encoder = SnapshotEncoder()
        # the proto is passed BY VALUE into the loop: after a mid-run
        # reconnect the old thread keeps beating its own (now dead)
        # channel and exits on its ConnectionError, while the new
        # thread owns the new channel — two threads must never share
        # one protocol object
        t = threading.Thread(target=self._hb_loop,
                             args=(self._hb_proto,), daemon=True,
                             name="slave-heartbeat-%s" % self.id)
        t.start()
        return self

    def reconnect(self):
        """Full re-handshake after the master vanished mid-run: tear
        down both channels, then redial with backoff for up to
        ``reconnect_s`` seconds. The restored/restarted master assigns
        a NEW slave id; jobs lost with the old master are requeued by
        its recovery plane, never replayed from here. Returns True on
        success."""
        if not self.reconnect_s or self._closed:
            return False
        self.warning("master at %s:%d lost mid-run; retrying for up "
                     "to %.0fs", self.address[0], self.address[1],
                     self.reconnect_s)

        def attempt():
            for proto in (getattr(self, "proto", None),
                          getattr(self, "_hb_proto", None)):
                if proto is not None:
                    proto.close()
            # single-shot dial (retry_s=0): the WHOLE handshake is the
            # retried unit, because a dying master can accept the TCP
            # connect and even answer the main handshake before its
            # listener closes — the failure can land anywhere in the
            # sequence, not just the dial
            self.connect(retry_s=0)

        try:
            self._retry_with_backoff(self.reconnect_s, attempt)
        except (ConnectionError, OSError) as e:
            self.warning("reconnect failed: %s", e)
            return False
        self.reconnects += 1
        self.info("reconnected to master as slave %s", self.id)
        if self.on_reconnect is not None:
            try:
                self.on_reconnect(self)
            except Exception:
                self.warning("on_reconnect callback failed",
                             exc_info=True)
        return True

    def notify_flight(self, reason, path=None, context=None):
        """Queue a flight-record notice for the next heartbeat and
        wake the beat loop so the master learns promptly (the
        FlightRecorder dump-listener hook calls this)."""
        notice = {"reason": str(reason), "path": path,
                  "t": time.time(), "trace_id": self.trace_id}
        if isinstance(context, dict):
            # the notice rides a JSON control line: stringify anything
            # a detector stuffed in that json.dumps would choke on
            notice["context"] = {
                str(k): v if isinstance(v, (int, float, str, bool,
                                            type(None))) else str(v)
                for k, v in context.items()}
        self._flight_notices.append(notice)
        self._hb_wake.set()

    def _hb_loop(self, proto):
        # each beat reports the round-trip the PREVIOUS beat measured;
        # the master aggregates them per slave (heartbeat RTT series).
        # A beat also carries the registry snapshot
        # delta and any queued flight notices (notify_flight wakes the
        # loop early so incident news never waits a full interval).
        rtt_ms = None
        while True:
            self._hb_wake.wait(self.heartbeat_interval)
            self._hb_wake.clear()
            if self._hb_stop.is_set():
                return
            msg = {"cmd": "heartbeat", "power": self.power,
                   "rtt_ms": rtt_ms}
            if self._snapshot_encoder is not None:
                try:  # telemetry must never kill the beat
                    delta = self._snapshot_encoder.encode()
                except Exception:
                    delta = None
                if delta is not None:
                    msg["telemetry"] = delta
            notices = []
            while self._flight_notices:
                try:
                    notices.append(self._flight_notices.popleft())
                except IndexError:
                    break
            if notices:
                msg["flight"] = notices
            try:
                t0 = time.perf_counter()
                proto.send(msg)
                reply = proto.recv()
                rtt_ms = (time.perf_counter() - t0) * 1e3
            except (ConnectionError, OSError, ValueError):
                # ValueError: close() raced this beat mid-send ("write
                # to closed file" from the buffered pair) — same
                # meaning as the connection dropping
                return
            if isinstance(reply, dict) and reply.get("resync") and \
                    self._snapshot_encoder is not None:
                # the master saw a sequence gap: its view may hold
                # stale series — push everything next beat
                self._snapshot_encoder.mark_resync()

    def serve_forever(self, handler, idle_sleep=0.05, max_idle=None,
                      pipeline=None):
        """Pull/execute/push until the queue stays empty (or forever).

        With ``pipeline`` (default) the next-job request goes out
        BEFORE the current job is computed, so the master's job
        generation and this slave's compute overlap — the reference's
        async protocol (``client.py:433-437``), bounded by the
        server's MAX_IN_FLIGHT. The prefetched job reply is READ
        before the result is written: with multi-MB payloads, writing
        the result while the server is still blocked writing the job
        reply would fill both TCP buffers and deadlock both peers
        (write-write deadlock) — draining first guarantees the server
        is free to read."""
        if pipeline is None:
            pipeline = self.pipeline
        idle = 0
        pending_job = None
        wait_ms = 0.0
        while True:
            shm_start = self.proto.shm_ms
            if pending_job is not None:
                job, job_trace = pending_job
                pending_job = None
            else:
                try:
                    t0 = time.perf_counter()
                    self.proto.send({"cmd": "job"})
                    reply = self.proto.recv()
                    wait_ms = (time.perf_counter() - t0) * 1e3
                except (ConnectionError, OSError):
                    # master went away mid-run: with a reconnect
                    # budget, re-handshake (a restarted master may be
                    # restoring from its snapshot right now) and keep
                    # serving; otherwise nothing more for this slave
                    if not self.reconnect():
                        return self.jobs_done
                    idle = 0
                    continue
                if reply.get("job") is None:
                    if reply.get("done"):
                        return self.jobs_done
                    idle += 1
                    if max_idle is not None and idle >= max_idle:
                        # voluntary exit: say goodbye so the master
                        # records a clean disconnect, not a death
                        self._say_goodbye()
                        return self.jobs_done
                    time.sleep(idle_sleep)
                    continue
                job = reply["job"]
                job_trace = reply.get("trace")
            idle = 0
            if self.death_probability and \
                    self._rand.rand() < self.death_probability:
                # chaos: die mid-job without reporting (--slave-death-
                # probability parity) — the master must requeue
                self.proto.close()
                raise RuntimeError("chaos death")
            prefetched = False
            if pipeline:
                try:
                    self.proto.send({"cmd": "job"})
                    prefetched = True
                except (ConnectionError, OSError):
                    prefetched = False
            entry = {"wait_ms": wait_ms}
            self.job_log.append(entry)
            trace = job_trace if isinstance(job_trace, dict) else {}
            # the slave half of the exchange span: job execution under
            # the master's trace id, labeled with the job's span id
            with tracing.request_span("exchange:job",
                                      trace_id=trace.get("trace_id",
                                                         self.trace_id),
                                      span_id=trace.get("span_id"),
                                      slave=self.id):
                result = handler(job)
            try:
                t0 = time.perf_counter()
                if prefetched:
                    # drain the job reply BEFORE writing the result:
                    # see the write-write deadlock note above
                    next_reply = self.proto.recv()
                t1 = time.perf_counter()
                wait_ms = (t1 - t0) * 1e3
                self.proto.send({"cmd": "result", "data": result,
                                 "trace": job_trace})
                self.proto.recv()  # result ack
                entry["result_ms"] = (time.perf_counter() - t1) * 1e3
                entry["shm_ms"] = self.proto.shm_ms - shm_start
            except (ConnectionError, OSError):
                # master shut down while we were computing — either a
                # normal end-of-run (the result is lost, but the
                # master only closes once it has all it needs) or a
                # crash: with a reconnect budget, rejoin — the result
                # is discarded, the restored master requeues the job
                # itself (exactly-once stays with the master's
                # accounting, never with a stale slave-side replay)
                if not self.reconnect():
                    return self.jobs_done
                pending_job = None
                idle = 0
                continue
            self.jobs_done += 1
            if prefetched:
                nxt = next_reply.get("job")
                if nxt is None and next_reply.get("done"):
                    return self.jobs_done
                pending_job = None if nxt is None else \
                    (nxt, next_reply.get("trace"))

    def heartbeat(self):
        self.proto.send({"cmd": "heartbeat", "power": self.power})
        self.proto.recv()

    def _say_goodbye(self):
        """Best-effort voluntary-exit notice ({"cmd": "bye"}): lets
        the master classify this disconnect as clean instead of a
        death (which would count a drop and GC the series)."""
        try:
            self.proto.send({"cmd": "bye"})
            self.proto.recv()
        except Exception:
            pass  # the master may already be gone; exiting anyway

    def close(self):
        was_closed = self._closed
        self._closed = True  # no reconnect attempts past this point
        self._hb_stop.set()
        self._hb_wake.set()  # unblock a beat loop mid-wait
        if not was_closed:
            # send-only (no recv: a racing serve thread owns the read
            # side) — tells the master this teardown is deliberate
            try:
                self.proto.send({"cmd": "bye"})
            except Exception:
                pass
        self.proto.close()
        if hasattr(self, "_hb_proto"):
            self._hb_proto.close()
