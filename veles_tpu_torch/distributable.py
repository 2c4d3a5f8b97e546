"""Pickleable base and the distribution hooks (``veles_tpu/distributable.py``).

:class:`Pickleable` defines the snapshot contract: any attribute whose
name ends with ``_`` is transient (locks, modules, staged device
copies) and is recreated by ``init_unpickled()`` after unpickling.

Tensors never enter a snapshot as tensors: every ``torch.Tensor`` in a
unit's state (at the top level, or inside dicts, lists and tuples) is
pickled as a :class:`HostTensor` -- its values as a numpy array (a
bfloat16 tensor as its 16-bit patterns), or only its shape and dtype
for a tensor on the ``meta`` device -- and comes back as a CPU tensor,
so a snapshot taken on the card loads on the CPU and the reverse.

:class:`Distributable` is the five-method protocol the master/slave
runtime drives (:mod:`veles_tpu_torch.parallel.coordinator`): no-ops
here, overridden by the units that carry distributed state (the loader,
the decision, the gradient units), with the thread-safe ``*_locked``
entry points the master's connection threads call.
"""

import threading

import numpy
import torch

from veles_tpu_torch.logger import Logger

#: seconds to wait on a unit's data lock before warning about a possible
#: deadlock (``veles_tpu/distributable.py``)
DEADLOCK_TIME = 4.0


class HostTensor(object):
    """A tensor as pickled: numpy values (or a shape alone for ``meta``)
    and the dtype's name."""

    def __init__(self, tensor):
        self.dtype = str(tensor.dtype).replace("torch.", "")
        self.shape = tuple(tensor.shape)
        if tensor.device.type == "meta":
            self.values = None
            return
        host = tensor.detach().cpu().contiguous()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        self.values = host.numpy()

    def tensor(self):
        dtype = getattr(torch, self.dtype)
        if self.values is None:
            return torch.empty(self.shape, dtype=dtype, device="meta")
        out = torch.from_numpy(numpy.array(self.values))
        return out.view(dtype) if dtype == torch.bfloat16 else out


def to_host(value):
    """``value`` with every tensor in it (through dicts, lists and tuples)
    as a :class:`HostTensor`."""
    if isinstance(value, torch.Tensor):
        return HostTensor(value)
    if isinstance(value, dict) and type(value) is dict:
        return {k: to_host(v) for k, v in value.items()}
    if type(value) in (list, tuple):
        return type(value)(to_host(v) for v in value)
    return value


def from_host(value):
    """Inverse of :func:`to_host`: CPU (or meta) tensors again."""
    if isinstance(value, HostTensor):
        return value.tensor()
    if isinstance(value, dict) and type(value) is dict:
        return {k: from_host(v) for k, v in value.items()}
    if type(value) in (list, tuple):
        return type(value)(from_host(v) for v in value)
    return value


class Pickleable(Logger):
    """Base class with the ``*_``-is-transient pickling convention.
    The tensors named in :attr:`SHAPE_ONLY_STATE` (the eager
    scheduler's per-minibatch buffers) are pickled as their shape and
    dtype alone."""

    SHAPE_ONLY_STATE = ()

    def __init__(self, **kwargs):
        super(Pickleable, self).__init__(**kwargs)
        self._method_storage = {}
        self.init_unpickled()

    def init_unpickled(self):
        """(Re)create transient state; called from ctor and unpickling."""
        self.stripped_pickle_ = False

    def __getstate__(self):
        state = {}
        for name, value in self.__dict__.items():
            if name.endswith("_") and not (name.startswith("__") and
                                           name.endswith("__")):
                continue
            if callable(value) and getattr(value, "__self__", None) is self:
                continue  # bound methods re-bind on init_unpickled
            if name in self.SHAPE_ONLY_STATE and \
                    isinstance(value, torch.Tensor):
                value = value.to("meta")
            state[name] = to_host(value)
        return self.pickle_logger_state(state)

    def __setstate__(self, state):
        super(Pickleable, self).__setstate__(
            {k: from_host(v) for k, v in state.items()})
        self.init_unpickled()
        from veles_tpu_torch.mutable import ensure_descriptors
        ensure_descriptors(self)  # cross-process snapshot restore

    @property
    def stripped_pickle(self):
        """True while pickling for the wire (drop bulk payloads)."""
        return getattr(self, "stripped_pickle_", False)

    @stripped_pickle.setter
    def stripped_pickle(self, value):
        self.stripped_pickle_ = bool(value)


class IDistributable(object):
    """Marker and documentation of the distribution protocol
    (``veles_tpu/distributable.py``):

    * ``generate_data_for_master()``: the payload a slave sends its
      master after a job;
    * ``generate_data_for_slave(slave)``: the job a master sends a slave;
    * ``apply_data_from_master(data)``: a slave applies a job;
    * ``apply_data_from_slave(data, slave)``: the master merges an update;
    * ``drop_slave(slave)``: requeue the work a dead slave held.
    """


class Distributable(Pickleable):
    """The master/slave data protocol: ``has_data_for_slave`` and the
    five methods the runtime drives (``generate_data_for_master``,
    ``generate_data_for_slave``, ``apply_data_from_master``,
    ``apply_data_from_slave``, ``drop_slave``), no-ops by default, and
    their ``*_locked`` entry points under the unit's data lock."""

    def __init__(self, **kwargs):
        super(Distributable, self).__init__(**kwargs)
        self.negotiates_on_connect = False

    def init_unpickled(self):
        super(Distributable, self).init_unpickled()
        self._data_lock_ = threading.Lock()
        self._data_event_ = threading.Event()
        self._data_event_.set()

    @property
    def has_data_for_slave(self):
        return self._data_event_.is_set()

    @has_data_for_slave.setter
    def has_data_for_slave(self, value):
        if value:
            self._data_event_.set()
        else:
            self._data_event_.clear()

    def generate_data_for_master(self):
        return None

    def generate_data_for_slave(self, slave=None):
        return None

    def apply_data_from_master(self, data):
        pass

    def apply_data_from_slave(self, data, slave=None):
        pass

    def drop_slave(self, slave=None):
        pass

    def _locked(self, fn, *args):
        if not self._data_lock_.acquire(timeout=DEADLOCK_TIME):
            self.warning("possible deadlock in %s.%s",
                         type(self).__name__, fn.__name__)
            self._data_lock_.acquire()
        try:
            return fn(*args)
        finally:
            self._data_lock_.release()

    # -- thread-safe entry points of the master's connection threads --------

    def generate_data_for_slave_locked(self, slave=None):
        return self._locked(self.generate_data_for_slave, slave)

    def apply_data_from_slave_locked(self, data, slave=None):
        return self._locked(self.apply_data_from_slave, data, slave)


class TriviallyDistributable(Distributable):
    """Units with no distributed state at all."""
