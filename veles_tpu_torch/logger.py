"""Logging mixin + structured event tracing (the port's copy of
``veles_tpu/logger.py``).

Every object gets a named logger through the :class:`Logger` mixin,
console output is colorized, all logging can be duplicated to a
rotating file, and ``event()`` emits structured, timestamped trace
records as JSON lines to the sinks that are active (none by default).
"""

import json
import logging
import logging.handlers
import os
import sys
import threading
import time


class ColorFormatter(logging.Formatter):
    """ANSI-colored console formatter (tty only)."""

    COLORS = {
        logging.DEBUG: "\033[37m",
        logging.INFO: "\033[92m",
        logging.WARNING: "\033[93m",
        logging.ERROR: "\033[91m",
        logging.CRITICAL: "\033[1;91m",
    }
    RESET = "\033[0m"

    def __init__(self, colored=None):
        super(ColorFormatter, self).__init__(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S")
        if colored is None:
            colored = sys.stderr.isatty()
        self.colored = colored

    def format(self, record):
        text = super(ColorFormatter, self).format(record)
        if self.colored:
            color = self.COLORS.get(record.levelno, "")
            if color:
                return color + text + self.RESET
        return text


_setup_lock = threading.Lock()
_setup_done = False


def setup_logging(level=logging.INFO):
    global _setup_done
    with _setup_lock:
        if _setup_done:
            logging.getLogger().setLevel(level)
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColorFormatter())
        logging.getLogger().addHandler(handler)
        logging.getLogger().setLevel(level)
        _setup_done = True


def redirect_all_logging_to_file(path, max_bytes=1 << 24, backups=9):
    """Duplicate root logging into a rotating file (``logger.py:187-207``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    handler = logging.handlers.RotatingFileHandler(
        path, maxBytes=max_bytes, backupCount=backups)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.getLogger().addHandler(handler)
    return handler


class EventWriter(object):
    """Structured event sink: JSON lines with session/thread identity."""

    def __init__(self, path, session_id=None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._file = open(path, "a", buffering=1)
        self._lock = threading.Lock()
        self.session_id = session_id or "%d.%d" % (os.getpid(),
                                                   int(time.time()))

    def write(self, record):
        with self._lock:
            self._file.write(json.dumps(record, default=str) + "\n")

    def close(self):
        with self._lock:
            self._file.close()


_event_writer = None
_event_sinks = []


def duplicate_events_to_file(path, session_id=None):
    """Activate the structured event stream (replaces Mongo duplication)."""
    global _event_writer
    _event_writer = EventWriter(path, session_id)
    return _event_writer


def add_event_sink(sink):
    """Register an additional event consumer (``sink.write(record)``;
    needs a ``session_id``)."""
    _event_sinks.append(sink)
    return sink


def remove_event_sink(sink):
    try:
        _event_sinks.remove(sink)
    except ValueError:
        pass


def events_active():
    return _event_writer is not None or bool(_event_sinks)


class Logger(object):
    """Mixin giving any object a named logger + event tracing.

    Mirrors ``veles/logger.py:59`` in capability: ``self.info/debug/...``
    helpers, a per-instance ``logger`` named after the class (optionally a
    custom ``logger_name``), and :meth:`event` for begin/end/single trace
    records keyed by instance id.
    """

    def __init__(self, **kwargs):
        logger_name = kwargs.pop("logger_name", type(self).__name__)
        super(Logger, self).__init__()
        self._logger_ = logging.getLogger(logger_name)

    @property
    def logger(self):
        return self._logger_

    @logger.setter
    def logger(self, value):
        self._logger_ = value

    def change_logger_name(self, name):
        self._logger_ = logging.getLogger(name)

    # pickling: loggers carry locks; store only the name. This helper is
    # THE one place encoding that rule — Pickleable delegates here.
    def pickle_logger_state(self, state):
        state["_logger_"] = self._logger_.name
        return state

    def __getstate__(self):
        state = getattr(super(Logger, self), "__getstate__", dict)()
        if not isinstance(state, dict):  # pragma: no cover
            state = self.__dict__.copy()
        return self.pickle_logger_state(dict(state))

    def __setstate__(self, state):
        name = state.pop("_logger_", type(self).__name__)
        parent_setstate = getattr(super(Logger, self), "__setstate__", None)
        if parent_setstate is not None:
            parent_setstate(state)
        else:
            self.__dict__.update(state)
        self._logger_ = logging.getLogger(
            name if isinstance(name, str) else type(self).__name__)

    def msg_changed(self, *args):  # pragma: no cover - debug aid
        pass

    def debug(self, msg, *args, **kwargs):
        self._logger_.debug(msg, *args, **kwargs)

    def info(self, msg, *args, **kwargs):
        self._logger_.info(msg, *args, **kwargs)

    def warning(self, msg, *args, **kwargs):
        self._logger_.warning(msg, *args, **kwargs)

    def error(self, msg, *args, **kwargs):
        self._logger_.error(msg, *args, **kwargs)

    def exception(self, msg="", *args, **kwargs):
        self._logger_.exception(msg, *args, **kwargs)

    def critical(self, msg, *args, **kwargs):
        self._logger_.critical(msg, *args, **kwargs)

    def event(self, name, etype, **attrs):
        """Emit a structured trace event.

        ``etype`` is "begin" | "end" | "single" — the contract of
        ``veles/logger.py:264-289``; no-op unless a sink is active.
        """
        if _event_writer is None and not _event_sinks:
            return
        if etype not in ("begin", "end", "single"):
            raise ValueError("bad event type %r" % etype)
        record = {
            "instance": "%s@%x" % (type(self).__name__, id(self)),
            "name": name,
            "type": etype,
            "time": time.time(),
            "thread": threading.current_thread().name,
        }
        record.update(attrs)
        # each consumer gets ITS session identity — the dashboard
        # filters its timeline by the launcher's log_id while the file
        # stream keeps the pid.time session
        if _event_writer is not None:
            _event_writer.write(dict(
                record, session=_event_writer.session_id))
        for sink in _event_sinks:
            sink.write(dict(record, session=sink.session_id))
