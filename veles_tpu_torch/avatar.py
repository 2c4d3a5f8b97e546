"""Avatar units (``veles_tpu/avatar.py``).

Mirror a chosen set of attributes of a source unit: the way one
workflow's state is shown to another, in this process or across a
process boundary.

In-process, :class:`Avatar` is an attribute snapshot barrier: each run
copies the source's attributes, so the units downstream see the values
of a well-defined point of the graph, whatever the source does to them
later. A tensor is copied, never aliased: the optimizer updates the
parameters in place, and a mirror holding a reference would silently
track the live weights. The copy (``Tensor.clone``) is taken on the
source's device and, on the card, on the current stream, so it is
ordered after the step's work that wrote the values; a numpy array is
copied; anything else deep-copied.

Across processes :class:`AvatarServer` serves an Avatar's snapshot over
the coordinator's framing (``parallel/coordinator.py`` ``Protocol``) and
restricted codec (``parallel/wire.py``: numpy arrays and primitives
only, so a peer cannot make the client build arbitrary objects). Each
snapshot is copied to the host and encoded once, at ``publish()``, then
answered to any number of pulls, so a card pays one device-to-host copy
per Avatar run, not per request (uncompressed, unlike the JAX
server's: zlib takes seconds on an fc7 to save a few percent of bytes
that cross loopback). :class:`RemoteAvatar` is the unit a
client workflow links into its graph: each run pulls the newest
snapshot and exposes its attributes, arrays as CPU tensors. The codec
and the framing are the JAX package's, so either package's
``RemoteAvatar`` pulls from the other's server.
"""

import copy
import socket
import threading
import time

import numpy
import torch

from veles_tpu_torch.parallel import wire
from veles_tpu_torch.units import Unit

#: hosts a server may bind without the warning that pulls carry no auth
_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _mirror(value):
    """A copy of ``value`` that shares no memory with it."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    if isinstance(value, numpy.ndarray):
        return numpy.array(value, copy=True)
    return copy.deepcopy(value)


def _host(value):
    """``value`` as the wire carries it: a tensor as a numpy array (a
    bfloat16 one as its 16-bit patterns), the rest as it is."""
    if not isinstance(value, torch.Tensor):
        return value
    host = value.detach().cpu().contiguous()
    if host.dtype == torch.bfloat16:
        return wire.BFloat16Bits(
            host.view(torch.int16).numpy().view(numpy.uint16))
    return host.numpy()


class Avatar(Unit):
    """Copies ``attrs`` from ``source`` onto itself on every run."""

    def __init__(self, workflow, **kwargs):
        self.attrs = tuple(kwargs.pop("attrs", ()))
        source = kwargs.pop("source", None)
        super(Avatar, self).__init__(workflow, **kwargs)
        self.source = source
        self.demand("source")

    def clone(self):
        for attr in self.attrs:
            setattr(self, attr, _mirror(getattr(self.source, attr)))

    def initialize(self, **kwargs):
        self.clone()
        self._notify_cloned()

    def run(self):
        self.clone()
        self._notify_cloned()

    def _notify_cloned(self):
        # an AvatarServer hooks here to publish every snapshot; the hook
        # is a bound method of the live server (a socket, locks), so its
        # name ends in "_": it never rides the unit's pickle
        hook = getattr(self, "on_cloned_", None)
        if hook is not None:
            hook()


class AvatarServer(object):
    """Serves an Avatar's snapshot to :class:`RemoteAvatar` pullers.

    A threaded accept loop: each connection speaks ``Protocol`` frames,
    and every ``{"req": "pull"}`` is answered ``{"rev": n, "attrs":
    {name: <wire blob>}}``. ``rev`` rises by one per publish.
    ``publish_ms`` and ``published_bytes`` are the last publish's host
    time (the device-to-host copies and the encode) and encoded bytes.
    """

    def __init__(self, avatar, host="127.0.0.1", port=0):
        if host not in _LOOPBACK:
            # pulls carry no auth (unlike the coordinator's handshake):
            # whoever reaches the port can pull the model
            import logging
            logging.getLogger("AvatarServer").warning(
                "binding to non-loopback %s: avatar pulls are "
                "UNAUTHENTICATED; tunnel over SSH or keep on loopback",
                host)
        self.avatar = avatar
        self._lock = threading.Lock()
        self._encoded = {}
        self._rev = 0
        self.publish_ms = 0.0
        self.published_bytes = 0
        self._done = threading.Event()
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self.publish()
        # serve the snapshot published at link time even before run()
        avatar.on_cloned_ = self.publish
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="avatar-server")
        self._thread.start()

    @property
    def rev(self):
        return self._rev

    def publish(self):
        """Copy the avatar's current values to the host and encode them."""
        t = time.perf_counter()
        # uncompressed: pulls come over loopback, where zlib costs more
        # time (seconds for an fc7) than the bytes it saves
        encoded = {attr: wire.encode(_host(getattr(self.avatar, attr,
                                                   None)), compress=False)
                   for attr in self.avatar.attrs}
        with self._lock:
            self._encoded = encoded
            self._rev += 1
        self.publish_ms = 1e3 * (time.perf_counter() - t)
        self.published_bytes = sum(len(b) for b in encoded.values())

    def _accept_loop(self):
        from veles_tpu_torch.parallel.coordinator import Protocol
        while not self._done.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, daemon=True,
                             args=(Protocol(sock),)).start()

    def _serve(self, proto):
        try:
            while not self._done.is_set():
                msg = proto.recv()
                if not isinstance(msg, dict) or msg.get("req") != "pull":
                    proto.send({"error": "unknown request"})
                    continue
                # snapshot under the lock, send outside it: a client that
                # stops reading stalls its own connection, never publish()
                # on the training thread
                with self._lock:
                    reply = {"rev": self._rev, "attrs": dict(self._encoded)}
                proto.send(reply)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            proto.close()

    def stop(self):
        self._done.set()
        try:
            self._listener.close()
        except OSError:
            pass


class RemoteAvatar(Unit):
    """Client-side mirror: pulls a served Avatar's snapshot each run.

    ``address`` is the server's (host, port). Arrays arrive as CPU
    tensors of their own memory (a bfloat16 leaf as its float32
    widening), other values as they are; ``rev`` is the snapshot's
    revision, for staleness checks."""

    def __init__(self, workflow, **kwargs):
        self.attrs = tuple(kwargs.pop("attrs", ()))
        address = kwargs.pop("address", None)
        super(RemoteAvatar, self).__init__(workflow, **kwargs)
        self.address = address
        self.rev = -1
        self.demand("address")

    def init_unpickled(self):
        super(RemoteAvatar, self).init_unpickled()
        self._proto_ = None

    def _connect(self):
        from veles_tpu_torch.parallel.coordinator import Protocol
        if self._proto_ is None:
            self._proto_ = Protocol(
                socket.create_connection(tuple(self.address), timeout=30))
        return self._proto_

    def pull(self):
        proto = self._connect()
        proto.send({"req": "pull"})
        reply = proto.recv()
        if "error" in reply:
            raise RuntimeError("avatar pull failed: %s" % reply["error"])
        for attr, blob in reply["attrs"].items():
            if self.attrs and attr not in self.attrs:
                continue
            value = wire.decode(blob)  # restricted: numpy and primitives
            if isinstance(value, numpy.ndarray):
                value = torch.from_numpy(numpy.array(value))
            setattr(self, attr, value)
        self.rev = reply["rev"]

    def initialize(self, **kwargs):
        self.pull()

    def run(self):
        self.pull()

    def close(self):
        if getattr(self, "_proto_", None) is not None:
            self._proto_.close()
            self._proto_ = None
