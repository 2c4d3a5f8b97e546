"""Out-of-core model state (``veles_tpu/train/offload.py``): the
parameters and solver state live on the host, pinned, and each step
walks contiguous layer groups through a staging ring.

* :class:`OffloadPlan` packs the forward chain greedily into groups whose
  host bytes (parameters plus the solver's state, :func:`model_layer_
  bytes`) stay under :func:`group_budget_bytes` (``VELES_OFFLOAD_GROUP_MB``,
  else the device budget over the ring's ``depth + 2`` groups); a layer
  larger than the budget is a group of its own.
* :class:`OffloadEngine` runs a training step as the JAX engine does:
  forward through groups ``0..G-2`` without a graph, keeping each
  group's input; then from the head group down, each group's forward
  again with the graph (rematerialized from its saved input), the
  gradients of its parameters and input by ``torch.autograd.grad`` given
  the gradient handed down from the group above, the solver's update of
  the group's device copies in place, and the copy back into the host
  masters. A layer runs on the staged copies through
  ``torch.func.functional_call``, so the kernels' autograd Functions run
  unchanged and no module's registered parameters are replaced for
  longer than the call. Dropout draws by absolute layer index, so the
  rematerialized masks are the first ones.
* Transfers: worker threads of a :class:`~veles_tpu_torch.loader.
  prefetch.PrefetchPipeline` upload group k+1 on the ring's copy stream
  while group k computes; the writeback of an updated group is a
  ``non_blocking`` copy into the pinned masters on a second stream,
  after an event recorded behind the update. Group g's upload for
  minibatch b waits (condition variable) until the step thread enqueued
  its writeback of minibatch b-1, and its copy waits on that
  writeback's event. ``VELES_OFFLOAD_DEPTH=0`` runs every upload inline
  on the step thread.

The readings are attributes -- ``wait_s`` (the step thread's wait for
uploads), ``h2d_ms`` / ``d2h_ms`` (host ms to enqueue a transfer),
``overlap`` (1 - wait / wall of the last segment, by phase) and, on the
card, ``transfers`` ((start, end, bytes, direction) events of the last
segment) -- and, as in the JAX engine, telemetry: the
``veles_offload_h2d_ms`` / ``veles_offload_d2h_ms`` /
``veles_offload_wait_ms`` histograms, the
``veles_offload_compute_overlap_fraction{phase}`` gauge, each transfer an
``offload:h2d`` / ``offload:d2h`` span with its ``group`` and a sample of
the cost-book row ``offload:h2d/g<k>`` / ``offload:d2h/g<k>`` (the
group's bytes, no FLOPs). The transfer times are host times: the time
to enqueue the copy on its stream.
"""

import threading
import time
import weakref

import torch
from torch import nn

from veles_tpu_torch.convert import layer_params
from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.loader import prefetch
from veles_tpu_torch.telemetry import profiler, tracing
from veles_tpu_torch.telemetry.registry import get_registry

#: live engines (weak): :func:`shutdown_all` closes any a crashed run
#: left behind
_live_lock = threading.Lock()
_live = weakref.WeakSet()


def h2d_histogram():
    return get_registry().histogram(
        "veles_offload_h2d_ms",
        "Host->device upload time per offloaded layer group")


def d2h_histogram():
    return get_registry().histogram(
        "veles_offload_d2h_ms",
        "Device->host writeback time per offloaded layer group")


def wait_histogram():
    return get_registry().histogram(
        "veles_offload_wait_ms",
        "Step-thread wait for the next staged layer group")


def overlap_gauge():
    return get_registry().gauge(
        "veles_offload_compute_overlap_fraction",
        "1 - transfer wait / wall of the last offloaded segment",
        labels=("phase",))


def offload_depth():
    """``VELES_OFFLOAD_DEPTH`` staged groups ahead (default 2; 0 = every
    upload inline)."""
    return max(0, env_knob("VELES_OFFLOAD_DEPTH", 2, parse=int,
                           on_error="default"))


def offload_workers():
    """``VELES_OFFLOAD_WORKERS`` upload threads (default 2)."""
    return max(1, env_knob("VELES_OFFLOAD_WORKERS", 2, parse=int,
                           on_error="default"))


def transfer_throttle_s():
    """The per-upload sleep of ``VELES_OFFLOAD_THROTTLE_MS`` (a slow
    interconnect for overlap checks; 0 in production)."""
    return max(0.0, env_knob("VELES_OFFLOAD_THROTTLE_MS", 0.0,
                             parse=float, on_error="default")) / 1e3


def group_budget_bytes(device=None, depth=None):
    """Target bytes per layer group: ``VELES_OFFLOAD_GROUP_MB``, else the
    device budget over ``depth + 2`` groups, else 256 MB."""
    mb = env_knob("VELES_OFFLOAD_GROUP_MB", parse=float,
                  on_error="default")
    if mb is not None and mb > 0:
        return mb * 1e6
    depth = offload_depth() if depth is None else depth
    budget = prefetch.device_budget_bytes(device)
    if budget:
        return budget / (max(1, depth) + 2)
    return 256e6


def plan_offload(model_bytes, device=None, force=None):
    """``"offloaded"`` or ``"resident"`` for model state of
    ``model_bytes``; ``force`` (or ``VELES_OFFLOAD``) overrides the
    budget, as :func:`prefetch.plan_residency`."""
    if force is None:
        env = env_knob("VELES_OFFLOAD")
        if env in ("1", "force", "on", "yes", "true"):
            force = True
        elif env in ("0", "off", "no", "false"):
            force = False
    if force is not None:
        return "offloaded" if force else "resident"
    budget = prefetch.device_budget_bytes(device)
    if budget is not None and model_bytes > budget:
        return "offloaded"
    return "resident"


#: solver-state bytes per parameter byte (a planning estimate)
_STATE_FACTORS = {"sgd": 1.0, "adagrad": 1.0, "adadelta": 2.0,
                  "adam": 2.0}


def model_layer_bytes(forwards, solvers):
    """Per-layer host bytes: parameters plus the estimated state of the
    layer's solver (None: no state)."""
    out = []
    for module, solver in zip(forwards, solvers):
        nbytes = sum(p.numel() * p.element_size()
                     for p in layer_params(module).values())
        if nbytes and solver is not None:
            factor = _STATE_FACTORS.get(getattr(solver, "name", None), 1.0)
            nbytes = int(nbytes * (1.0 + factor))
        out.append(nbytes)
    return out


class OffloadPlan(object):
    """Contiguous layer groups ``[(lo, hi)]`` packed greedily under the
    per-group budget (a group holds at least one layer)."""

    def __init__(self, groups, group_bytes):
        self.groups = list(groups)
        self.group_bytes = list(group_bytes)

    @property
    def n_groups(self):
        return len(self.groups)

    @property
    def total_bytes(self):
        return sum(self.group_bytes)

    @classmethod
    def build(cls, layer_bytes, budget):
        groups, sizes = [], []
        lo, acc = 0, 0
        for i, nbytes in enumerate(layer_bytes):
            if i > lo and acc + nbytes > budget:
                groups.append((lo, i))
                sizes.append(acc)
                lo, acc = i, 0
            acc += nbytes
        groups.append((lo, len(layer_bytes)))
        sizes.append(acc)
        return cls(groups, sizes)


def host_copy(tensor, pin):
    """``tensor`` on the host (pinned when ``pin``); a host tensor that
    is already so is returned as it is. Failing to pin raises."""
    if tensor.device.type == "cpu" and (not pin or tensor.is_pinned()):
        return tensor
    out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=pin)
    out.copy_(tensor)
    if pin and not out.is_pinned():
        raise RuntimeError("could not pin %d host bytes"
                           % (out.numel() * out.element_size()))
    return out


def host_tree(state, pin):
    """A solver state dict with every tensor as :func:`host_copy`."""
    if isinstance(state, dict):
        return {k: host_tree(v, pin) for k, v in state.items()}
    return host_copy(state.detach(), pin)


class _Walk(nn.Module):
    """Layers ``[lo, hi)`` of a trainer's chain as one module, so that
    ``functional_call`` runs them on a group's staged parameters
    (``layers.<j>.<name>``)."""

    def __init__(self, trainer, lo, hi):
        super(_Walk, self).__init__()
        self.layers = nn.ModuleList(trainer.forwards[lo:hi])
        self._range = (trainer, lo, hi)

    def forward(self, x, train, batch_index, seed, aux, valid):
        trainer, lo, hi = self._range
        return trainer._forward_range(x, lo, hi, train, batch_index, seed,
                                      aux, valid)


def _named(params_group):
    """``{"layers.<j>.<name>": tensor}`` of a group's staged layers."""
    return {"layers.%d.%s" % (j, k): t
            for j, layer in enumerate(params_group)
            for k, t in layer.items()}


class OffloadEngine(object):
    """Drives one trainer's offloaded execution over the host masters
    (the trainer's ``params`` and ``states``, updated in place by the
    writebacks)."""

    def __init__(self, trainer, plan, depth=None, workers=None):
        self.trainer = trainer
        self.plan = plan
        self.depth = offload_depth() if depth is None else max(0, depth)
        self.workers = (offload_workers() if workers is None
                        else max(1, workers))
        self.device = trainer.device
        self.cuda = self.device.type == "cuda"
        #: cumulative step-thread wait for uploads (s)
        self.wait_s = 0.0
        #: host ms to enqueue each upload / writeback of the last segment
        self.h2d_ms = []
        self.d2h_ms = []
        #: 1 - wait / wall of the last segment, by phase
        self.overlap = {}
        #: (start event, end event, bytes, "h2d" or "d2h") of the last
        #: segment's transfers (the card only)
        self.transfers = []
        self._ring = prefetch.StagingRing(max(1, self.depth) + 2,
                                          self.device, reuse=False)
        self._d2h = None
        #: each group's last writeback event: every segment's uploads
        #: follow it, and a segment ends with the masters complete
        self._written = {g: None for g in range(plan.n_groups)}
        self._walks = [_Walk(trainer, lo, hi) for lo, hi in plan.groups]
        self._active_pipe = None
        self._h2d_hist = h2d_histogram()
        self._d2h_hist = d2h_histogram()
        self._wait_hist = wait_histogram()
        self._overlap = overlap_gauge()
        self._book = profiler.get_cost_book()
        for g, nbytes in enumerate(plan.group_bytes):
            # transfer rows: bytes and observed ms give GB/s per group
            self._book.note_cost("offload:h2d/g%d" % g, 0.0, float(nbytes))
            self._book.note_cost("offload:d2h/g%d" % g, 0.0, float(nbytes))
        with _live_lock:
            _live.add(self)

    # -- the pieces of a walk -----------------------------------------------

    def _masters(self, g, with_states):
        """The host masters of group g: its layers' parameter dicts
        (and solver states)."""
        lo, hi = self.plan.groups[g]
        params = tuple({k: p.data for k, p in
                        self.trainer.params[i].items()}
                       for i in range(lo, hi))
        if not with_states:
            return (params,)
        return (params, tuple(self.trainer.states[i]
                              for i in range(lo, hi)))

    def _call(self, g, params_group, x, *args):
        return torch.func.functional_call(
            self._walks[g], _named(params_group), (x,) + args)

    def _upload_pipeline(self, schedule, name, gate=None):
        """The upload side: a pipeline over ``schedule`` = [(kind, b,
        g)] staging group g's masters (with the solver states for a
        backward task "B"). ``gate`` = (cond, versions, events, abort):
        task (b, g) waits until the writeback of g for minibatch b-1 was
        enqueued, and its copy follows that writeback's event."""
        ring = self._ring
        throttle = transfer_throttle_s()
        h2d_ms = self.h2d_ms

        def produce(i):
            kind, b, g = schedule[i]
            after = ()
            if gate is not None:
                cond, versions, events, abort = gate
                with cond:
                    while versions[g] < b and not abort[0]:
                        cond.wait(0.1)
                    if abort[0]:
                        raise RuntimeError(
                            "offload upload aborted at task %d" % i)
                    after = (events[g],)
            t0 = time.perf_counter()
            if throttle:
                time.sleep(throttle)
            staged = ring.place(self._masters(g, kind == "B"), after=after)
            elapsed = time.perf_counter() - t0
            h2d_ms.append(elapsed * 1e3)
            self._h2d_hist.observe(elapsed * 1e3)
            self._book.observe_ms("offload:h2d/g%d" % g, elapsed)
            tracing.add_complete("offload:h2d", t0, elapsed, group=g,
                                 batch=b, phase=kind)
            if staged.ready is not None:
                self.transfers.append((staged.started, staged.ready,
                                       _tree_bytes(staged.tree), "h2d"))
            return staged

        return prefetch.PrefetchPipeline(
            produce, len(schedule), depth=self.depth,
            workers=self.workers, name=name, wait_hist=self._wait_hist,
            fill_phase=None)

    def _writeback(self, g, staged, b, gate):
        """Copy the updated group back into its host masters (a
        ``non_blocking`` copy on the writeback stream, after the update)
        and let the uploads of minibatch b+1 of group g go."""
        cond, versions, events, _ = gate
        t0 = time.perf_counter()
        masters = prefetch._leaves(self._masters(g, True))
        leaves = prefetch._leaves(staged.tree)
        event = None
        if self.cuda:
            if self._d2h is None:
                self._d2h = torch.cuda.Stream(self.device)
            stream = self._d2h
            stream.wait_stream(torch.cuda.current_stream(self.device))
            start = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record(stream)
                self._copy_back(g, masters, leaves)
                for leaf in leaves:
                    leaf.record_stream(stream)
                event = torch.cuda.Event(enable_timing=True)
                event.record(stream)
            self.transfers.append((start, event, _tree_bytes(staged.tree),
                                   "d2h"))
            self._ring.release(staged, stream=stream)
        else:
            self._copy_back(g, masters, leaves)
            self._ring.release(staged)
        elapsed = time.perf_counter() - t0
        self.d2h_ms.append(elapsed * 1e3)
        self._d2h_hist.observe(elapsed * 1e3)
        self._book.observe_ms("offload:d2h/g%d" % g, elapsed)
        tracing.add_complete("offload:d2h", t0, elapsed, group=g, batch=b)
        with cond:
            events[g] = event
            versions[g] = b + 1
            cond.notify_all()

    def _copy_back(self, g, masters, leaves):
        """Group g's device copies into its host masters (``non_blocking``
        on the card, on the current stream)."""
        with torch.no_grad():
            for master, leaf in zip(masters, leaves):
                master.copy_(leaf.detach(), non_blocking=self.cuda)

    def _update(self, g, params_group, states_group, grads):
        """The solver over the group's staged layers in order, with
        ``grads`` (one tensor a parameter, in the group's order)."""
        trainer = self.trainer
        lo, _ = self.plan.groups[g]
        pos = 0
        for j, params in enumerate(params_group):
            n = len(params)
            if n:
                trainer.solver.update(
                    params, dict(zip(params, grads[pos:pos + n])),
                    states_group[j], trainer.hypers[lo + j])
            pos += n

    # -- segment sweeps -----------------------------------------------------

    def _start(self, schedule, name, gate=None):
        self.h2d_ms, self.d2h_ms, self.transfers = [], [], []
        pipe = self._upload_pipeline(schedule, name, gate)
        self._active_pipe = pipe
        self._ring.reopen()
        pipe.start()
        return pipe

    def _finish(self, pipe, phase, start):
        pipe.close()
        self._active_pipe = None
        self.wait_s += pipe.wait_s
        wall = time.perf_counter() - start
        if wall > 0:
            self.overlap[phase] = max(0.0, 1.0 - pipe.wait_s / wall)
            self._overlap.labels(phase=phase).set(self.overlap[phase])

    def train_segment(self, idx, first, seed, out):
        """One training sweep over the index matrix ``idx`` (numpy),
        group-walked; batch indices from ``first``. Appends each batch's
        loss, metric and gradient norm to the lists of ``out``."""
        trainer = self.trainer
        n_groups = self.plan.n_groups
        head = n_groups - 1
        schedule = []
        for b in range(idx.shape[0]):
            schedule += [("F", b, g) for g in range(head)]
            schedule += [("B", b, g) for g in range(head, -1, -1)]
        cond = threading.Condition()
        gate = (cond, {g: 0 for g in range(n_groups)}, self._written,
                [False])
        rows = torch.from_numpy(idx).to(self.device)
        start = time.perf_counter()
        pipe = self._start(schedule, "offload-train", gate)
        try:
            with trainer.policy.backends():
                for b in range(idx.shape[0]):
                    self._train_batch(pipe, rows[b], first + b, seed, gate,
                                      b, out)
        finally:
            with cond:
                gate[3][0] = True
                cond.notify_all()
            self._finish(pipe, "train", start)
            # host readers (snapshots, pull_params) see whole masters
            for event in self._written.values():
                if event is not None:
                    event.synchronize()

    def _train_batch(self, pipe, row, batch_index, seed, gate, b, out):
        trainer = self.trainer
        n_groups = self.plan.n_groups
        head = n_groups - 1
        x, truth, valid = trainer.loader.gather(row)
        inputs = [x]
        with torch.no_grad():
            for g in range(head):
                staged = pipe.get()[0]
                (params_group,) = staged.wait()
                inputs.append(self._call(g, params_group, inputs[g], True,
                                         batch_index, seed, None, valid))
                self._ring.release(staged)
        cot = None
        norms = [None] * n_groups
        for g in range(head, -1, -1):
            staged = pipe.get()[0]
            params_group, states_group = staged.wait()
            leaves = [p for layer in params_group for p in layer.values()]
            for p in leaves:
                p.requires_grad_(True)
            x_in = inputs[g]
            if g:
                x_in = x_in.detach().requires_grad_(True)
            aux = []
            out_g = self._call(g, params_group, x_in, True, batch_index,
                               seed, aux, valid)
            wrt = leaves + ([x_in] if g else [])
            if g == head:
                grad_loss, report, metric = trainer._loss(out_g, truth,
                                                          valid)
                for term in aux:
                    grad_loss = grad_loss + term
                grads = torch.autograd.grad(grad_loss, wrt) if wrt else []
            elif wrt:
                outputs, seeds = [out_g], [cot]
                if aux:
                    total = aux[0]
                    for term in aux[1:]:
                        total = total + term
                    outputs.append(total)
                    seeds.append(torch.ones_like(total))
                grads = torch.autograd.grad(outputs, wrt, seeds)
            else:
                grads = []
            del out_g
            if g:
                cot = grads[-1]
            grads = grads[:len(leaves)]
            norms[g] = list(torch._foreach_norm(grads)) if grads else []
            self._update(g, params_group, states_group, grads)
            del grads
            self._writeback(g, staged, b, gate)
            del params_group, states_group, leaves, staged
        out[0].append(report)
        out[1].append(metric)
        per_tensor = [n for part in norms for n in part]
        trainer.batch_norm = torch.linalg.vector_norm(torch.stack(
            per_tensor))
        out[2].append(trainer.batch_norm)

    def eval_segment(self, idx, out):
        """Forward-only sweep over ``idx`` through every group: report
        losses and metrics appended to ``out`` = [losses, metrics,
        confusion], the confusion counts summed into its third item."""
        from veles_tpu_torch.nn.evaluator import batch_confusion
        trainer = self.trainer
        n_groups = self.plan.n_groups
        schedule = [("F", b, g) for b in range(idx.shape[0])
                    for g in range(n_groups)]
        rows = torch.from_numpy(idx).to(self.device)
        start = time.perf_counter()
        # read-only masters: no version to wait for, only the copies
        # follow the last writebacks
        gate = (threading.Condition(),
                {g: idx.shape[0] for g in range(n_groups)}, self._written,
                [False])
        pipe = self._start(schedule, "offload-eval", gate)
        try:
            with torch.no_grad(), trainer.policy.backends():
                for b in range(idx.shape[0]):
                    x, truth, valid = trainer.loader.gather(rows[b])
                    for g in range(n_groups):
                        staged = pipe.get()[0]
                        (params_group,) = staged.wait()
                        x = self._call(g, params_group, x, False, 0, 0,
                                       None, valid)
                        self._ring.release(staged)
                    _, report, metric = trainer._loss(x, truth, valid)
                    out[0].append(report)
                    out[1].append(metric)
                    if trainer.loss_kind == "softmax":
                        counts = batch_confusion(x, truth, valid)
                        out[2] = counts if out[2] is None \
                            else out[2] + counts
        finally:
            self._finish(pipe, "eval", start)

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        """Join any live upload pipeline and drop the staged groups.
        Idempotent."""
        pipe = self._active_pipe
        if pipe is not None:
            pipe.close()
            self._active_pipe = None
        self._ring.clear()


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size()
               for t in prefetch._leaves(tree))


def shutdown_all():
    """Close every live engine: no upload thread outlives a run."""
    with _live_lock:
        engines = list(_live)
    for engine in engines:
        engine.close()
