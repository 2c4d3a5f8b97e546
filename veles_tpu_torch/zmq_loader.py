"""The workflow-as-a-service feed (``veles_tpu/zmq_loader.py``).

A JSON-lines TCP endpoint that producers push samples into, in front of
the queue-fed loader: the framing of the coordinator's control plane
(:class:`veles_tpu_torch.parallel.coordinator.Protocol`). A producer
connects and sends one JSON object a line, ``{"data": [...]}``, and reads
``{"ok": true}`` for each; a malformed line or a sample of the wrong
shape gets ``{"error": ...}`` and the connection stays open;
``{"cmd": "finish"}`` ends the stream, and with it the workflow.
"""

import json
import socket
import threading

import numpy

from veles_tpu_torch.loader.interactive import QueueFedLoader


class SocketFedLoader(QueueFedLoader):
    """Queue-fed loader with a TCP JSON-lines producer endpoint
    (``endpoint``: the (host, port) it listens on; port 0 picks one,
    read back from ``address`` after ``initialize()``)."""

    def __init__(self, endpoint=("127.0.0.1", 0), **kwargs):
        super(SocketFedLoader, self).__init__(**kwargs)
        self.endpoint = tuple(endpoint)
        self.address = None

    def load_data(self):
        super(SocketFedLoader, self).load_data()
        self._listener_ = socket.create_server(tuple(self.endpoint))
        self.address = self._listener_.getsockname()
        self._accepting_ = True
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="%s-accept" % self.name).start()
        self.info("feed endpoint on %s:%d", *self.address)

    def _accept_loop(self):
        while self._accepting_:
            try:
                sock, _ = self._listener_.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock,),
                             daemon=True).start()

    def _serve(self, sock):
        from veles_tpu_torch.parallel.coordinator import Protocol
        proto = Protocol(sock)
        with sock:
            while True:
                try:
                    msg = proto.recv()
                except ConnectionError:
                    return
                except json.JSONDecodeError:
                    proto.send({"error": "bad json"})
                    continue
                if isinstance(msg, dict) and msg.get("cmd") == "finish":
                    self.finish()
                    proto.send({"ok": True, "finished": True})
                    return
                try:
                    # refused here, while the producer still reads the
                    # ack: once fed, a wrong size would stop the
                    # workflow's loop in fill_minibatch
                    sample = numpy.asarray(msg["data"], numpy.float32)
                    sample = sample.reshape(self.feed_shape)
                except (TypeError, KeyError, IndexError, ValueError) as exc:
                    proto.send({"error": str(exc) or type(exc).__name__})
                    continue
                self.feed(sample)
                proto.send({"ok": True})

    def stop_serving(self):
        self._accepting_ = False
        try:
            self._listener_.close()
        except OSError:
            pass
