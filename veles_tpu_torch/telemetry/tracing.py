"""Span tracing with Chrome trace-event export (the port's copy of
``veles_tpu/telemetry/tracing.py``).

``span(name, **attrs)`` wraps any host-side region; events land in a
bounded ring (:class:`TraceBuffer`) as *complete* trace events
(``"ph": "X"``) that :meth:`TraceBuffer.to_chrome` renders as JSON
loadable in Perfetto / ``chrome://tracing``. Timestamps are wall-clock
microseconds derived from a ``perf_counter`` offset captured at import,
so records from different processes align on one timeline.

Telemetry must be near-free when idle: when tracing is disabled,
``span()`` returns a shared no-op context manager (one function call,
no allocation); enabled, a span costs a ``perf_counter`` pair and a
deque append, no lock.

A span times the host. CUDA work is asynchronous, so a span around
work that returns before the card finishes measures only its issue:
the instrumented sites end their spans where the path already waits
for the card (a host read of a sweep's losses, a served batch's copy
to the host) and never synchronize for the sake of a span.

Trace identity: every event carries a ``trace_id`` resolved from (in
order) an explicit argument, the calling thread's context
(:func:`trace_context` -- how a client-supplied ``X-Request-Id``
reaches the spans under it), or the process-wide default
(:func:`set_default_trace_id`).
"""

import collections
import contextlib
import json
import os
import threading
import time

_WALL_EPOCH = time.time()
_PERF_EPOCH = time.perf_counter()


def _to_us(perf_time):
    """perf_counter() value -> wall-clock microseconds."""
    return (_WALL_EPOCH + (perf_time - _PERF_EPOCH)) * 1e6


class TraceBuffer(object):
    """Bounded ring of Chrome trace events."""

    def __init__(self, maxlen=131072):
        self._events = collections.deque(maxlen=maxlen)
        self._pid = os.getpid()

    def __len__(self):
        return len(self._events)

    def add_complete(self, name, start_perf, duration_s, trace_id=None,
                     **args):
        """Record one finished region ('X' event). ``start_perf`` is the
        ``perf_counter()`` value at region entry."""
        if trace_id is None:
            trace_id = get_trace_id()
        if trace_id is not None:
            args["trace_id"] = trace_id
        self._events.append({
            "name": name,
            "ph": "X",
            "ts": _to_us(start_perf),
            "dur": duration_s * 1e6,
            "pid": self._pid,
            "tid": threading.get_ident(),
            "args": args,
        })

    def add_instant(self, name, trace_id=None, **args):
        if trace_id is None:
            trace_id = get_trace_id()
        if trace_id is not None:
            args["trace_id"] = trace_id
        self._events.append({
            "name": name,
            "ph": "i",
            "ts": _to_us(time.perf_counter()),
            "s": "t",
            "pid": self._pid,
            "tid": threading.get_ident(),
            "args": args,
        })

    def events(self):
        return list(self._events)

    def clear(self):
        self._events.clear()

    def to_chrome(self, process_name=None):
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        events = self.events()
        if process_name:
            events.insert(0, {
                "name": "process_name", "ph": "M", "pid": self._pid,
                "tid": 0, "args": {"name": process_name}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path, process_name=None):
        """Write (or merge-append into) a trace file.

        If ``path`` already holds a valid trace (another process of the
        same run exited first — a slave before its master), the events
        merge so the file stays one Perfetto-loadable timeline. The
        read-merge-write cycle runs under an exclusive ``flock`` on a
        sidecar lock file: a master and its slaves routinely exit
        within milliseconds of each other, and an unlocked merge would
        let the second writer clobber the first's events."""
        trace = self.to_chrome(process_name=process_name)
        try:
            import fcntl
            lock = open(path + ".lock", "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
        except (ImportError, OSError):
            lock = None
        try:
            try:
                with open(path) as fin:
                    existing = json.load(fin)
                trace["traceEvents"] = (list(existing["traceEvents"]) +
                                        trace["traceEvents"])
            except (OSError, ValueError, KeyError, TypeError):
                pass
            # write-to-temp + rename: a reader (or a crashing writer)
            # never observes a half-written file
            tmp = "%s.%d.tmp" % (path, os.getpid())
            with open(tmp, "w") as fout:
                json.dump(trace, fout)
            os.replace(tmp, path)
        finally:
            if lock is not None:
                lock.close()
        return len(trace["traceEvents"])


_default_buffer = TraceBuffer()
_buffer = _default_buffer
_enabled = False
_default_trace_id = None
_tls = threading.local()


def get_buffer():
    return _buffer


def enable(buffer=None):
    """Turn span recording on (optionally into a caller-owned buffer)."""
    global _buffer, _enabled
    if buffer is not None:
        _buffer = buffer
    _enabled = True
    return _buffer


def disable():
    """Turn recording off and drop any caller-owned buffer installed by
    ``enable(buffer=...)`` — a later bare ``enable()`` must not keep
    writing into (and dumping) a stale test-owned ring."""
    global _enabled, _buffer
    _enabled = False
    _buffer = _default_buffer


def enabled():
    return _enabled


# -- trace identity --------------------------------------------------------


def set_default_trace_id(trace_id):
    """Process-wide default (a distributed run's shared id)."""
    global _default_trace_id
    _default_trace_id = trace_id


def get_trace_id():
    """The calling thread's trace id: context override, else default."""
    tid = getattr(_tls, "trace_id", None)
    return tid if tid is not None else _default_trace_id


@contextlib.contextmanager
def trace_context(trace_id):
    """Pin ``trace_id`` onto this thread for the duration (request
    handling, one coordinator job). None = no-op."""
    if trace_id is None:
        yield
        return
    prev = getattr(_tls, "trace_id", None)
    _tls.trace_id = trace_id
    try:
        yield
    finally:
        _tls.trace_id = prev


# -- spans ------------------------------------------------------------------


class _NoopSpan(object):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span(object):
    __slots__ = ("name", "args", "_start")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        duration = time.perf_counter() - self._start
        _buffer.add_complete(self.name, self._start, duration,
                             **self.args)
        return False


def span(name, **attrs):
    """Context manager timing a region; no-op singleton when disabled."""
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


def add_complete(name, start_perf, duration_s, **args):
    """Record an already-timed region (the hot-path form: the caller
    holds the perf_counter pair anyway, so no context manager needs to
    be allocated). No-op when disabled."""
    if _enabled:
        _buffer.add_complete(name, start_perf, duration_s, **args)


def trace_id_from_request(headers, rid=None):
    """THE request-id → trace-id rule, shared by every HTTP surface:
    an ``X-Request-Id`` header wins, else the request body's ``"id"``
    echo value (stringified), else None."""
    trace_id = headers.get("X-Request-Id") if headers is not None else None
    if trace_id is None and rid is not None:
        trace_id = str(rid)
    return trace_id


@contextlib.contextmanager
def request_span(name, trace_id=None, **attrs):
    """One HTTP/RPC request: pins ``trace_id`` (e.g. a client-supplied
    ``X-Request-Id``) onto the thread and opens a span, so every span
    recorded while handling the request shares the id."""
    if not _enabled:
        yield
        return
    with trace_context(trace_id):
        with span(name, **attrs):
            yield
