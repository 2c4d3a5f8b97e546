"""The rank grid and the multi-process runtime (``veles_tpu/parallel/
mesh.py``).

The JAX package drives every device from one process: a ``Mesh`` names
the devices' axes and ``jit`` inserts the collectives. PyTorch has no
single controller, so the port's SPMD tier runs one process per rank
over ``torch.distributed``, each rank with one device, and writes every
collective out (:mod:`veles_tpu_torch.parallel.collectives`). A
:class:`RankGrid` takes the mesh's place: the world's ranks laid out
row-major over named axes, with the JAX package's names (``data``,
``model``, ``pipe``, ``seq``, ``expert``; ``batch`` x ``model`` for
``--gspmd``), one ``dist.new_group`` per line of ranks along each axis.
A grid of one rank needs no process group: every collective over it is
the identity.

:func:`named_sharding` gives a tensor's placement over a grid: a
:class:`Sharding` whose ``spec`` names, per dimension, the axis that
splits it (``None``: whole), the ``PartitionSpec`` of the JAX package.

:func:`init_multihost` joins this process to a world of
``num_processes`` ranks at a coordinator: ``HOST:PORT`` (a TCP store,
served by rank 0) or ``file://PATH`` (a file store on a shared file
system). The store dial runs through
:func:`veles_tpu_torch.parallel.retry.retry_with_backoff`
(``VELES_MESH_INIT_RETRY_S``, 60 s by default); the process group itself
is made once, with the timeout :data:`MESH_TIMEOUT`, so a dead peer
fails a run instead of hanging it. The same spec twice is a
no-op; another spec raises until :func:`shutdown_multihost`.

The backend follows one rule, which the log states (:func:`choose_backend`):
``nccl`` when every rank has a card of its own, ``gloo`` on the CPU, and
``gloo`` with CUDA tensors when ranks share a card (NCCL refuses two
ranks on one GPU). A failed NCCL init raises; it is never retried on
gloo. Each rank's card is ``-d`` when given, else its index among the
ranks of its host modulo the host's cards; the ranks learn their hosts
from the store before the process group exists.
"""

import datetime
import logging
import math
import socket
import time

import torch
import torch.distributed as dist

from veles_tpu_torch.envknob import env_knob

_log = logging.getLogger("mesh")

#: the timeout of every rendezvous store and process group: a collective
#: that waits this long on a dead peer fails the run
MESH_TIMEOUT = datetime.timedelta(seconds=300)


class Axis(object):
    """One axis of a grid as this rank sees it: its ``size``, this
    rank's ``index`` along it, the world ranks of the line through this
    rank (``ranks``) and their process ``group`` (None on one rank)."""

    def __init__(self, name, size, index, ranks, group, backend):
        self.name, self.size, self.index = name, size, index
        self.ranks, self.group, self.backend = tuple(ranks), group, backend

    def __repr__(self):
        return "<Axis %s %d/%d>" % (self.name, self.index, self.size)


class RankGrid(object):
    """The world's ranks over named axes, row-major (the last axis
    varies fastest), as ``numpy.reshape`` lays a JAX mesh's devices."""

    def __init__(self, names, sizes, rank, backend, device):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.size = math.prod(sizes)
        self.rank = rank
        self.backend = backend
        #: this rank's device
        self.device = torch.device(device)
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        self.coords = {n: (rank // s) % z
                       for n, s, z in zip(names, strides, sizes)}
        self._axes = {}
        for i, name in enumerate(names):
            # every rank makes every group of every axis, in one order:
            # new_group is collective over the world
            lines = {}
            for r in range(self.size):
                key = tuple((r // s) % z for j, (s, z) in
                            enumerate(zip(strides, sizes)) if j != i)
                lines.setdefault(key, []).append(r)
            mine = None
            for key in sorted(lines):
                ranks = lines[key]
                group = None
                if sizes[i] > 1:
                    group = dist.new_group(ranks)
                if rank in ranks:
                    mine = (ranks, group)
            self._axes[name] = Axis(name, sizes[i], self.coords[name],
                                    mine[0], mine[1], backend)

    def axis(self, name):
        """The :class:`Axis` ``name``; a grid without it raises."""
        if name not in self._axes:
            raise ValueError("grid %r has no %r axis" % (self.shape, name))
        return self._axes[name]

    def __repr__(self):
        return "<RankGrid %s rank %d on %s (%s)>" % (
            self.shape, self.rank, self.device, self.backend)


def world_size():
    """Ranks of the live world (1 standalone)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank():
    """This process's rank (0 standalone)."""
    return dist.get_rank() if dist.is_initialized() else 0


def infer_sizes(axes, n):
    """(names, sizes) of ``axes`` (dict or (name, size) pairs) over
    ``n`` ranks, one ``-1`` size inferred; the JAX package's errors."""
    if isinstance(axes, dict):
        axes = list(axes.items())
    names = [a[0] for a in axes]
    sizes = [int(a[1]) for a in axes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one inferred (-1) axis")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError("cannot infer axis: %d %% %d" % (n, known))
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError("mesh %r needs %d devices, have %d" %
                         (dict(zip(names, sizes)), math.prod(sizes), n))
    return names, sizes


def build_mesh(axes=None, device=None):
    """The :class:`RankGrid` of ``axes`` over the live world (one rank
    standalone), on ``device`` (default: the device
    :func:`init_multihost` chose, else the CPU). Default: every rank on
    the ``data`` axis. Collective over the world: every rank calls it
    with the same axes."""
    n = world_size()
    if axes is None:
        axes = {"data": n}
    names, sizes = infer_sizes(axes, n)
    spec = _MULTIHOST["spec"]
    backend = _MULTIHOST["backend"] if spec is not None else None
    if device is None:
        device = _MULTIHOST["device"] if spec is not None else "cpu"
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    return RankGrid(names, sizes, world_rank(), backend or "none", device)


class Sharding(object):
    """A tensor's placement over a grid: ``spec[d]`` is the axis name
    that splits dimension d, or None (trailing dimensions: whole)."""

    def __init__(self, grid, spec):
        self.grid = grid
        self.spec = tuple(spec)
        for name in self.spec:
            if name is not None:
                grid.axis(name)

    def local_slice(self, value, pad=False):
        """This rank's block of the whole tensor ``value``: each split
        dimension cut in ``size`` equal parts, this rank's kept. With
        ``pad`` a dimension that does not divide is cut in parts of
        ``ceil(n / size)`` and the short last ones padded with zeros."""
        for d, name in enumerate(self.spec):
            if name is None:
                continue
            axis = self.grid.axis(name)
            n = value.shape[d]
            if n % axis.size and not pad:
                raise ValueError("dimension %d of %s does not divide over "
                                 "the %r axis (%d)" % (
                                     d, tuple(value.shape), name, axis.size))
            part = -(-n // axis.size)
            lo = min(axis.index * part, n)
            block = value.narrow(d, lo, min(part, n - lo))
            if block.shape[d] < part:
                shape = list(block.shape)
                shape[d] = part - block.shape[d]
                block = torch.cat([block, block.new_zeros(shape)], d)
            value = block
        return value

    def __eq__(self, other):
        return (isinstance(other, Sharding) and other.grid is self.grid and
                _trim(other.spec) == _trim(self.spec))

    def __hash__(self):
        return hash(_trim(self.spec))

    def __repr__(self):
        return "Sharding(%s)" % (self.spec,)


def _trim(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def named_sharding(grid, *spec):
    """Shorthand for ``Sharding(grid, spec)``."""
    return Sharding(grid, spec)


def replicated(grid):
    return named_sharding(grid)


# -- the multi-process runtime -----------------------------------------------

#: this process's one world: its spec, backend, device, the rule's
#: reason, and its rendezvous store (held: rank 0's TCP store serves the
#: other ranks for the world's life)
_MULTIHOST = {"spec": None, "backend": None, "device": None, "store": None}


def multihost_initialized():
    """True when this process is a rank of a live world."""
    return _MULTIHOST["spec"] is not None or dist.is_initialized()


def choose_backend(device, ranks_per_card):
    """(backend, reason) by the tier's rule: gloo on the CPU; NCCL when
    every rank has a card of its own; gloo with CUDA tensors when ranks
    share a card, which NCCL refuses."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", "ranks on the CPU"
    if ranks_per_card > 1:
        return "gloo", ("%d ranks share %s: NCCL refuses two ranks on one "
                        "GPU" % (ranks_per_card, device))
    return "nccl", "every rank has a card of its own"


def _store(coordinator, n, rank, timeout):
    """The rendezvous store: ``file://PATH`` or ``HOST:PORT`` (rank 0
    serves it)."""
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], n)
    host, _, port = coordinator.rpartition(":")
    return dist.TCPStore(host or "127.0.0.1", int(port), n, rank == 0,
                         timeout=timeout, wait_for_workers=False)


def _place_ranks(store, n, rank, backend_hint, device_index):
    """This rank's device and the ranks sharing its card, from every
    rank's (host, card) published in the store."""
    host = socket.gethostname()
    if backend_hint == "cpu":
        device = torch.device("cpu")
        key = "%s/cpu" % host
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass -a cpu to "
                "run its plain PyTorch versions")
        store.set("veles/host/%d" % rank, host)
        hosts = [store.get("veles/host/%d" % r).decode() for r in range(n)]
        local = sum(1 for r in range(rank) if hosts[r] == host)
        index = int(device_index) if device_index not in (None, "") \
            else local % torch.cuda.device_count()
        device = torch.device("cuda", index)
        key = "%s/%d" % (host, index)
    store.set("veles/card/%d" % rank, key)
    cards = [store.get("veles/card/%d" % r).decode() for r in range(n)]
    return device, cards.count(key)


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, retry_budget_s=None, backend="auto",
                   device=None):
    """Join this process to a world of ``num_processes`` ranks as rank
    ``process_id`` at ``coordinator_address`` (see the module
    docstring); ``backend`` ``cpu`` keeps the ranks on the CPU,
    ``auto``/``cuda`` put them on cards, ``device`` a card index. False
    (nothing to join) for one process."""
    if num_processes in (None, 1):
        return False
    if process_id is None:
        raise ValueError("a world of %s processes needs this process's id"
                         % num_processes)
    spec = (coordinator_address, int(num_processes), int(process_id))
    if _MULTIHOST["spec"] is not None:
        if _MULTIHOST["spec"] == spec:
            _log.debug("init_multihost: already initialized as %r", spec)
            return True
        raise RuntimeError(
            "torch.distributed is already initialized as %r; re-forming "
            "the world as %r needs a fresh process or an explicit "
            "shutdown_multihost() first" % (_MULTIHOST["spec"], spec))
    if dist.is_initialized():
        _log.warning("init_multihost: torch.distributed was initialized "
                     "outside init_multihost; leaving it as it is")
        _MULTIHOST.update(spec=spec, backend=dist.get_backend(),
                          device=torch.device(device or "cpu"))
        return True
    if not coordinator_address:
        raise ValueError("a world of %d processes needs a coordinator "
                         "address" % spec[1])
    if retry_budget_s is None:
        retry_budget_s = env_knob("VELES_MESH_INIT_RETRY_S", 60.0,
                                  parse=float)
    from veles_tpu_torch.parallel.retry import retry_with_backoff
    store = retry_with_backoff(
        lambda: _store(coordinator_address, spec[1], spec[2],
                       MESH_TIMEOUT),
        retry_budget_s,
        retry_on=(RuntimeError, OSError, ConnectionError, TimeoutError),
        describe="could not reach the rendezvous store at %s (world=%s "
                 "rank=%s)" % spec)
    init_world(store, spec[1], spec[2], backend, device, spec)
    return True


def init_world(store, num_processes, process_id, backend="auto",
               device=None, spec=None):
    """Form the world over a rendezvous ``store``: place the rank, pick
    the backend by the rule, make the process group (with the timeout)
    and check it with one all_reduce. Returns the seconds the join
    took."""
    t0 = time.perf_counter()
    n, rank = int(num_processes), int(process_id)
    dev, sharing = _place_ranks(store, n, rank, backend, device)
    chosen, reason = choose_backend(dev, sharing)
    _log.info("rank %d of %d on %s: backend %s (%s)", rank, n, dev, chosen,
              reason)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if chosen == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(chosen, store=store, rank=rank, world_size=n,
                            timeout=MESH_TIMEOUT, **kwargs)
    check = torch.ones(1, device=dev)
    dist.all_reduce(check)
    if int(check.item()) != n:
        raise RuntimeError("the world's check all_reduce gave %s, not %d"
                           % (check.item(), n))
    _MULTIHOST.update(spec=spec or (None, n, rank), backend=chosen,
                      device=dev, store=store, reason=reason)
    return time.perf_counter() - t0


def world_device():
    """The device :func:`init_multihost` gave this rank (None
    standalone)."""
    return _MULTIHOST["device"] if _MULTIHOST["spec"] is not None else None


def backend_reason():
    """(backend, the rule's reason) of the live world, or None."""
    if _MULTIHOST["spec"] is None:
        return None
    return _MULTIHOST["backend"], _MULTIHOST.get("reason")


def shutdown_multihost():
    """Destroy the world this process joined. True when there was one;
    a fresh :func:`init_multihost` spec is accepted after it."""
    if _MULTIHOST["spec"] is None and not dist.is_initialized():
        return False
    if dist.is_initialized():
        dist.destroy_process_group()
    _MULTIHOST.update(spec=None, backend=None, device=None, store=None,
                      reason=None)
    return True


def is_rank_zero():
    """True standalone and on rank 0 of a world: the one rank that writes
    snapshots and result files."""
    return world_rank() == 0

