"""The fan-out of plot snapshots (``veles_tpu/graphics_server.py``).

Plotter units pickle themselves (stripped of the graph) and the server
sends the pickle to every subscriber; any number of rendering clients
(:mod:`veles_tpu_torch.graphics_client`) subscribe, from this machine or
another. The JAX package publishes on a ZeroMQ PUB socket; the port has
no pyzmq and keeps PUB's semantics over one TCP listener:

* the listener binds 127.0.0.1 on a free port; ``endpoints["tcp"]`` is
  ``tcp://127.0.0.1:<port>``;
* each subscriber is one connection, and each message on it is the
  coordinator's framing (:class:`veles_tpu_torch.parallel.coordinator.
  Protocol`): a JSON line and its length-prefixed binary frames, here
  ``[topic, zlib(pickle(plotter))]`` with the topic ``b"graphics"`` for
  a snapshot and ``b"end"`` (and an empty payload) when the server
  stops;
* a slow subscriber never blocks the training thread: :meth:`enqueue`
  pickles once, then appends to each subscriber's bounded queue
  (:data:`QUEUE_DEPTH` snapshots) and returns; a queue that is
  full drops its oldest snapshot and counts the drop; a thread for each
  subscriber writes its queue to the socket;
* as with PUB, a subscriber receives the snapshots enqueued after it
  connected (:meth:`wait_for_subscribers` holds a run until its
  renderers are there).
"""

import collections
import os
import pickle
import socket
import subprocess
import sys
import threading
import zlib

from veles_tpu_torch.logger import Logger

TOPIC = b"graphics"
TOPIC_END = b"end"
#: the snapshots a slow subscriber may have queued before the oldest is
#: dropped
QUEUE_DEPTH = 16


class _Subscriber(object):
    """One connection: its bounded queue and the thread that drains it."""

    def __init__(self, server, sock, depth):
        from veles_tpu_torch.parallel.coordinator import Protocol
        self.server = server
        self.proto = Protocol(sock)
        self.sock = sock
        self.queue = collections.deque()
        self.depth = depth
        self.cond = threading.Condition()
        self.sent = 0
        self.dropped = 0
        self.closed = False
        self.thread = threading.Thread(target=self._drain, daemon=True,
                                       name="graphics-subscriber")
        self.thread.start()

    def put(self, topic, payload):
        with self.cond:
            if self.closed:
                return
            if len(self.queue) >= self.depth:
                self.queue.popleft()
                self.dropped += 1
            self.queue.append((topic, payload))
            self.cond.notify()

    def _drain(self):
        while True:
            with self.cond:
                while not self.queue and not self.closed:
                    self.cond.wait()
                if not self.queue:
                    break
                topic, payload = self.queue.popleft()
            try:
                self.proto.send({"frames": [topic, payload]})
            except OSError:
                break
            if topic == TOPIC_END:
                break
            with self.cond:
                self.sent += 1
        with self.cond:
            self.closed = True
            self.queue.clear()
        self.server._forget(self)
        try:
            self.sock.close()
        except OSError:
            pass

    def close(self, timeout=None):
        """Let the thread send what is queued (``end`` included), then
        join it."""
        with self.cond:
            self.closed = True
            self.cond.notify()
        self.thread.join(timeout)


class GraphicsServer(Logger):
    """Sends pickled plotter snapshots to every subscriber.

    The most recently constructed server is reachable as
    ``GraphicsServer.current``: plotter units use it implicitly, as the
    JAX package's do."""

    current = None

    def __init__(self, queue_depth=QUEUE_DEPTH, **kwargs):
        super(GraphicsServer, self).__init__(**kwargs)
        self.queue_depth = queue_depth
        self._listener = socket.create_server(("127.0.0.1", 0))
        port = self._listener.getsockname()[1]
        self.endpoints = {"tcp": "tcp://127.0.0.1:%d" % port}
        self._lock = threading.Condition()
        self._subscribers = []
        self._gone = []
        #: snapshots enqueued, and the compressed bytes of each of the
        #: last 1024 as (plotter name, bytes)
        self.enqueued = 0
        self.snapshot_bytes = collections.deque(maxlen=1024)
        self.stopped = False
        self._acceptor = threading.Thread(target=self._accept, daemon=True,
                                          name="graphics-accept")
        self._acceptor.start()
        GraphicsServer.current = self
        self.debug("graphics server on %s", self.endpoints["tcp"])

    def _accept(self):
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self.stopped:
                    sock.close()
                    return
                self._subscribers.append(
                    _Subscriber(self, sock, self.queue_depth))
                self._lock.notify_all()

    def _forget(self, subscriber):
        with self._lock:
            if subscriber in self._subscribers:
                self._subscribers.remove(subscriber)
                self._gone.append(subscriber)

    @property
    def subscribers(self):
        with self._lock:
            return len(self._subscribers)

    def wait_for_subscribers(self, count, timeout=None):
        """Block until ``count`` subscribers are connected; False when
        ``timeout`` seconds passed first."""
        with self._lock:
            return self._lock.wait_for(
                lambda: len(self._subscribers) >= count, timeout)

    def stats(self):
        """Snapshots enqueued, and sent and dropped summed over every
        subscriber so far (the ``end`` message not counted)."""
        with self._lock:
            every = self._subscribers + self._gone
        return {"enqueued": self.enqueued,
                "sent": sum(s.sent for s in every),
                "dropped": sum(s.dropped for s in every),
                "subscribers": len(every)}

    def enqueue(self, plotter):
        """Pickle (stripped) one plotter snapshot and queue it for every
        subscriber; never waits on a socket."""
        if self.stopped:
            return
        plotter.stripped_pickle = True
        try:
            payload = zlib.compress(pickle.dumps(plotter, protocol=4), 1)
        finally:
            plotter.stripped_pickle = False
        with self._lock:
            subscribers = list(self._subscribers)
            self.enqueued += 1
            self.snapshot_bytes.append((plotter.name, len(payload)))
        for subscriber in subscribers:
            subscriber.put(TOPIC, payload)

    def launch_client(self, mode="png", out=None):
        """Start a rendering client process against this server."""
        argv = [sys.executable, "-m", "veles_tpu_torch.graphics_client",
                "--endpoint", self.endpoints["tcp"], "--mode", mode]
        if out:
            argv += ["--out", out]
        env = dict(os.environ)
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [package_root] + env.get("PYTHONPATH", "").split(os.pathsep))
        # the renderer needs no card
        env["CUDA_VISIBLE_DEVICES"] = ""
        return subprocess.Popen(argv, env=env)

    def stop(self, timeout=5.0):
        """Send ``end`` to every subscriber after what they have queued,
        and close the listener."""
        with self._lock:
            if self.stopped:
                return
            self.stopped = True
            subscribers = list(self._subscribers)
        for subscriber in subscribers:
            subscriber.put(TOPIC_END, b"")
        for subscriber in subscribers:
            subscriber.close(timeout)
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        self._acceptor.join(timeout)
        if GraphicsServer.current is self:
            GraphicsServer.current = None


class Subscription(object):
    """A subscriber's end of the connection (what a rendering client or
    a test holds): a thread reads each message into a queue, and
    :meth:`get` takes the next ``(topic, payload)``, ``None`` when
    ``timeout`` seconds pass first. A connection that closes reads as
    ``(TOPIC_END, b"")``."""

    def __init__(self, endpoint, timeout=10.0):
        import queue
        from veles_tpu_torch.parallel.coordinator import Protocol
        host, _, port = endpoint.rpartition("//")[2].rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=timeout)
        sock.settimeout(None)
        self._proto = Protocol(sock)
        self._queue = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name="graphics-subscription")
        self._reader.start()

    def _read(self):
        while True:
            try:
                topic, payload = self._proto.recv()["frames"]
            except (ConnectionError, OSError, ValueError):
                self._queue.put((TOPIC_END, b""))
                return
            self._queue.put((bytes(topic), bytes(payload)))
            if topic == TOPIC_END:
                return

    def get(self, timeout=None):
        import queue
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self):
        try:
            self._proto.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._proto.close()
        self._reader.join(5.0)
