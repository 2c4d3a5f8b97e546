"""The training driver: the port's ``FusedTrainer.run_epoch``, epoch
after epoch, on a trainer that ``models.build.build_training`` builds,
the call the port's runner and CLI make.

A mix of this driver states ``policy`` (``float32`` or ``bfloat16``),
``residency`` (``resident``: the dataset on the card; ``streamed``: in
host memory, through the prefetch pipeline and the staging ring) and
``minibatch`` (null: the configuration's).

Set-up (:func:`setup`):

1. seeds the port's random streams from the run's seed (dropout masks:
   ``default``; the loader's shuffles: ``loader``);
2. makes the dataset and the initial weights on the device
   (:mod:`portbench.inputs`) and hands them to the port: the data
   through a full-batch loader of the port (:class:`SeededLoader`), the
   weights through ``build_training(params=...)``;
3. runs the start of each epoch of :data:`SETUP_STEPS`: its evaluation
   sweep and its first training steps, recorded (:class:`Recorder`),
   the rest of its training sweep cut; the loader then moves on to the
   next epoch as a resumed run does (``reset_to_epoch_start``), which
   reshuffles. Epoch 0 trains in the dataset's order, epoch 1 in its
   first shuffle's order and on its own dropout seed, so the comparison
   sees both. This builds every kernel and warms every shape the
   window runs.

The window (:func:`window`) then runs whole epochs, from the first
after set-up's, until ``seconds`` have passed, and ends at a
``torch.cuda.synchronize()``. A traced run also times each training
step by CUDA events and each training sweep by the host clock, and then
profiles whole epochs after the window for at least
:data:`PROFILE_MIN_S` (:mod:`portbench.devtrace`).

After the window the program's state is freed and the plain reference
(:mod:`portbench.reference.model`) repeats set-up's recorded steps from
the same inputs (:func:`compare`).
"""

import collections
import json
import os
import tempfile
import time

import numpy
import torch

from portbench import checks, costs, devtrace, inputs
from portbench.reference import model as reference
from portbench.reference import philox, shuffle

_MASK = 0xFFFFFFFF
#: the training steps set-up runs and records at the start of each of
#: its epochs (epoch 0, epoch 1); the reference repeats them all
SETUP_STEPS = (1, 3)
#: the least seconds of whole epochs a traced run profiles
PROFILE_MIN_S = 1.0


def _port():
    """The port's modules the driver uses (imported at first use)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.build import build_training
    return prng, TRAIN, FullBatchLoader, build_training


def seeded_loader_class():
    """A full-batch loader of the port over tensors the benchmark made:
    classes ``[0, n_valid, n_train]``, no normalization."""
    _, _, FullBatchLoader, _ = _port()

    class SeededLoader(FullBatchLoader):
        def __init__(self, data, labels, n_valid, n_train, **kwargs):
            super(SeededLoader, self).__init__(**kwargs)
            self._made = (data, labels, n_valid, n_train)

        def load_dataset(self):
            data, labels, n_valid, n_train = self._made
            self.original_data, self.original_labels = data, labels
            self.class_lengths = [0, n_valid, n_train]

    return SeededLoader


def minibatch(cell):
    return int(cell.traffic.get("minibatch") or cell.config["minibatch"])


def sync(device):
    """Wait for ``device``'s queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell, seed, device, phases):
    """The trainer of ``cell`` from ``seed``, with its dataset and
    weights made on ``device``; ``phases`` gets the seconds of making
    the inputs and of ``build_training``."""
    t0 = time.perf_counter()
    prng, _, _, build_training = _port()
    prng.get("default").seed(inputs.sub_seed(seed, "dropout") & _MASK)
    prng.get("loader").seed(inputs.sub_seed(seed, "shuffle") & _MASK)
    config, traffic = cell.config, cell.traffic
    streamed = traffic["residency"] == "streamed"
    data, labels = inputs.make_data(config, seed, device, host=streamed)
    weights = inputs.make_weights(config, seed, device)
    params = [{k: v.cpu().numpy() for k, v in layer.items()}
              for layer in weights]
    del weights
    spec = config["data"]
    loader = seeded_loader_class()(data, labels, spec["n_valid"],
                                   spec["n_train"],
                                   minibatch_size=minibatch(cell))
    hp = config["training"]
    sync(device)
    t1 = time.perf_counter()
    trainer = build_training(
        config["layers"], tuple(config["sample_shape"]), loader,
        learning_rate=hp["learning_rate"], weights_decay=hp["weights_decay"],
        momentum=hp["momentum"], solver=hp["solver"], loss=hp["loss"],
        params=params, policy=traffic["policy"], device=device,
        stream=streamed)
    sync(device)
    phases["inputs_s"] = t1 - t0
    phases["build_training_s"] = time.perf_counter() - t1
    return trainer


def _jax_layout(tensor):
    t = tensor.detach().float()
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


class Enough(Exception):
    """Raised by :class:`Recorder` once an epoch's recorded training
    steps are done: it cuts that epoch's training sweep."""


class Recorder(object):
    """Records, while inside, what the comparison needs of set-up's
    epochs: each evaluation sweep's losses; each training step's loss
    and the rows and labels it gathered; the solver's velocity after the
    first training step (the gradient as the solver took it: ``-v /
    lr``) and the parameters after the last; all on the host,
    parameters in the JAX layout. :meth:`epoch` starts an epoch of
    ``steps`` training steps, after which :class:`Enough` is raised."""

    def __init__(self, trainer, total):
        self.trainer = trainer
        self.total = total
        self.stop = None
        self.done = 0
        self.losses = []
        self.rows = []
        self.eval_losses = []
        self.grad = {}
        self.params = {}

    def epoch(self, steps):
        self.stop, self.done = steps, 0

    def __enter__(self):
        trainer = self.trainer
        original, evaluate = trainer.train_batch, trainer.eval_class
        lrs = {}
        for i, hp in enumerate(trainer.hypers):
            for k in trainer.params[i]:
                overrides = hp.get("lr_overrides") or {}
                lrs[(i, k)] = overrides.get(k) or hp["learning_rate"]

        def train_batch(indices, batch_index, seed, data_args=None):
            x, truth, _ = trainer._gather(indices, data_args)
            self.rows.append((x.to("cpu", copy=True),
                              truth.to("cpu", copy=True)))
            report, metric = original(indices, batch_index, seed, data_args)
            self.losses.append(float(report))
            if len(self.losses) == 1:
                for i, state in enumerate(trainer.states):
                    for k, v in (state.get("velocity") or {}).items():
                        self.grad[(i, k)] = (-_jax_layout(v) /
                                             lrs[(i, k)]).cpu()
            if len(self.losses) == self.total:
                for i, layer in enumerate(trainer.params):
                    for k, p in layer.items():
                        self.params[(i, k)] = _jax_layout(p).to(
                            "cpu", copy=True)
            self.done += 1
            if self.done == self.stop:
                raise Enough()
            return report, metric

        def eval_class(klass, skip=0):
            losses, metrics, confusion = evaluate(klass, skip)
            self.eval_losses.append([float(v) for v in losses.float()])
            return losses, metrics, confusion

        trainer.train_batch = train_batch
        trainer.eval_class = eval_class
        return self

    def __exit__(self, *exc):
        del self.trainer.train_batch
        del self.trainer.eval_class

    def side(self):
        """What :func:`portbench.checks.numbers` compares."""
        return {"losses": self.losses, "eval_losses": self.eval_losses,
                "grad": self.grad, "params": self.params, "rows": self.rows}


class Instruments(object):
    """A traced run's timing of the trainer: CUDA events around each
    ``train_batch``, the host clock around each training sweep (from
    ``train_class`` to the end of the trainer's read of its losses), and
    ``record_function`` ranges around the sweeps for the profiler."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.steps = []
        self.sweeps = []

    def __enter__(self):
        from torch.profiler import record_function
        trainer = self.trainer
        _, TRAIN, _, _ = _port()
        batch, train_class = trainer.train_batch, trainer.train_class
        summarize, eval_class = trainer._summarize, trainer.eval_class
        start = []

        def timed_batch(*args):
            if trainer.device.type != "cuda":
                return batch(*args)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = batch(*args)
            end.record()
            self.steps.append((begin, end))
            return out

        def timed_train_class(*args):
            start.append(time.perf_counter())
            with record_function("portbench.train_sweep"):
                return train_class(*args)

        def timed_summarize(losses, metrics, klass):
            out = summarize(losses, metrics, klass)
            if klass == TRAIN:
                self.sweeps.append(time.perf_counter() - start.pop())
            return out

        def ranged_eval_class(*args):
            with record_function("portbench.eval_sweep"):
                return eval_class(*args)

        trainer.train_batch = timed_batch
        trainer.train_class = timed_train_class
        trainer._summarize = timed_summarize
        trainer.eval_class = ranged_eval_class
        return self

    def __exit__(self, *exc):
        for name in ("train_batch", "train_class", "_summarize",
                     "eval_class"):
            delattr(self.trainer, name)


def run_epochs(trainer, seconds):
    """Whole epochs until ``seconds`` have passed, then a synchronize:
    (wall seconds, [per epoch: wall_s, samples, steps, losses])."""
    epochs = []
    t0 = time.perf_counter()
    while True:
        e0 = time.perf_counter()
        stats = trainer.run_epoch()
        e1 = time.perf_counter()
        train = stats["train"]
        epochs.append({"wall_s": e1 - e0, "samples": train["samples"],
                       "steps": len(train["losses"]),
                       "losses": train["losses"]})
        if e1 - t0 >= seconds:
            break
    sync(trainer.device)
    return time.perf_counter() - t0, epochs


def _hand_counters():
    from veles_tpu_torch.ops.gemm import linear_act
    from veles_tpu_torch.ops.lrn import lrn_backward, lrn_forward
    from veles_tpu_torch.ops.random import uniform_fill
    from veles_tpu_torch.ops.reduce import column_sum
    return {"K1": linear_act, "K3": lrn_forward, "K4": lrn_backward,
            "K6": column_sum, "K7": uniform_fill}


def profile_epochs(trainer, min_seconds):
    """Whole epochs under ``torch.profiler`` until ``min_seconds`` have
    passed: (the trace's summary, the hand kernels' launches in it by
    key, the epochs' training steps)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    counters = _hand_counters()
    before = {k: collections.Counter(fn.launches_by_form)
              for k, fn in counters.items()}
    steps = 0
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("portbench.profiled"):
            t0 = time.perf_counter()
            while True:
                stats = trainer.run_epoch()
                steps += len(stats["train"]["losses"])
                if time.perf_counter() - t0 >= min_seconds:
                    break
            sync(trainer.device)
    launches = {k: collections.Counter(fn.launches_by_form) - before[k]
                for k, fn in counters.items()}
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = devtrace.summarize(path)
    finally:
        os.remove(path)
    return summary, launches, steps


class Run(object):
    """What the metrics' readers read (see ``metrics/``)."""

    def __init__(self, flops_per_sample, peak_flops):
        self.flops_per_sample = flops_per_sample
        self.peak_flops = peak_flops
        self.window_s = None
        self.epochs = []
        self.attempted = 0
        self.failed = 0
        self.streaming = False
        self.input_wait_s = 0.0
        #: traced runs: device ms of each training step of the window,
        #: each epoch's training-sweep seconds, the profile's summary,
        #: its hand-kernel launches and training steps
        self.step_ms = None
        self.sweep_s = None
        self.profile = None
        self.launches = None
        self.profiled_steps = 0

    @property
    def samples(self):
        return sum(e["samples"] for e in self.epochs)

    @property
    def steps(self):
        return sum(e["steps"] for e in self.epochs)

    def kernel_shares(self):
        """{kernel: (least s, measured s, bound)} of the hand kernels in
        the profiled epochs; empty without a profile."""
        if not self.profile:
            return {}
        out = {}
        for kid, launches in sorted(self.launches.items()):
            measured = self.profile["hand"].get(kid, 0.0)
            if not launches or measured <= 0:
                continue
            least, bounds = 0.0, collections.Counter()
            for key, count in launches.items():
                seconds, by = costs.kernel_bound_s(kid, key)
                least += count * seconds
                bounds[by] += count
            out[kid] = (least, measured, bounds.most_common(1)[0][0])
        return out

    def report(self):
        """Lines a run prints on standard output before its result."""
        shares = self.kernel_shares()
        if not shares:
            return []
        return ["portbench kernels: " + json.dumps({
            kid: {"least_s": least, "measured_s": measured, "bound": by,
                  "roofline_pct": 100.0 * least / measured}
            for kid, (least, measured, by) in shares.items()})]

    def summary(self):
        """One line of the window for standard error."""
        walls = ", ".join("%.3f" % e["wall_s"] for e in self.epochs)
        return "window %.3f s over %d epochs (%s s), %d steps" % (
            self.window_s, len(self.epochs), walls, self.attempted)


class State(object):
    """A run between set-up and the comparison."""

    def __init__(self, cell, seed, device, trainer, recorder):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.trainer = trainer
        self.recorder = recorder


def _setup_epochs(trainer, recorder):
    """The start of each epoch of :data:`SETUP_STEPS`, recorded; the
    loader left at the start of the epoch after them."""
    loader = trainer.loader
    with recorder:
        for epoch, steps in enumerate(SETUP_STEPS):
            loader.reset_to_epoch_start(epoch)
            recorder.epoch(steps)
            try:
                trainer.run_epoch()
            except Enough:
                pass
    loader.reset_to_epoch_start(len(SETUP_STEPS))


def setup(cell, seed, device, phases, fault=None):
    """The trainer of ``cell`` built from ``seed`` (with ``fault``, a
    name of :data:`FAULTS`, planted), its set-up epochs run and
    recorded."""
    trainer = build(cell, seed, device, phases)
    if fault:
        plant(trainer, fault)
    t0 = time.perf_counter()
    recorder = Recorder(trainer, sum(SETUP_STEPS))
    _setup_epochs(trainer, recorder)
    sync(device)
    phases["setup_epochs_s"] = time.perf_counter() - t0
    return State(cell, seed, device, trainer, recorder)


def window(state, seconds, traced):
    """The measured window: whole epochs for ``seconds``; with
    ``traced``, timed and then profiled."""
    trainer, config = state.trainer, state.cell.config
    run = Run(costs.train_flops_per_sample(
        config["layers"], config["sample_shape"]),
        costs.peak_flops(state.cell.traffic["policy"]))
    run.streaming = trainer.streaming
    wait0 = trainer.input_wait_s
    if traced:
        with Instruments(trainer) as inst:
            run.window_s, run.epochs = run_epochs(trainer, seconds)
            n_steps, n_sweeps = len(inst.steps), len(inst.sweeps)
            run.input_wait_s = trainer.input_wait_s - wait0
            run.profile, run.launches, run.profiled_steps = profile_epochs(
                trainer, PROFILE_MIN_S)
        run.step_ms = [b.elapsed_time(e) for b, e in inst.steps[:n_steps]]
        run.sweep_s = inst.sweeps[:n_sweeps]
    else:
        run.window_s, run.epochs = run_epochs(trainer, seconds)
        run.input_wait_s = trainer.input_wait_s - wait0
    losses = numpy.concatenate([e["losses"] for e in run.epochs])
    run.attempted = int(losses.size)
    run.failed = int((~numpy.isfinite(losses)).sum())
    return run


def release(state):
    """Stop the trainer and free its device memory."""
    state.trainer.shutdown()
    state.trainer = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(cell, seed, device, precision):
    """The plain reference's run of set-up's epochs of ``cell`` from
    ``seed``, in ``precision`` (a name of ``reference.PRECISIONS``):
    each epoch's evaluation batches (the validation class in the
    dataset's order) and its first training steps, in the order of the
    loader's shuffles worked out again (:mod:`portbench.reference.
    shuffle`) and on the epoch's dropout seed."""
    config, mb = cell.config, minibatch(cell)
    spec = config["data"]
    n_valid = spec["n_valid"]
    orders = shuffle.train_orders(inputs.sub_seed(seed, "shuffle"),
                                  n_valid, spec["n_train"],
                                  len(SETUP_STEPS))
    dropout = inputs.sub_seed(seed, "dropout")
    weights = inputs.make_weights(config, seed, device)
    epochs = []
    for epoch, steps in enumerate(SETUP_STEPS):
        order = orders[epoch]
        epochs.append({
            "eval": [inputs.data_rows(config, seed,
                                      list(range(r, min(r + mb, n_valid))),
                                      device)
                     for r in range(0, n_valid, mb)],
            "train": [inputs.data_rows(
                config, seed, order[j * mb:(j + 1) * mb].tolist(), device)
                for j in range(steps)],
            "dropout_seed": philox.epoch_seed(dropout, epoch)})
    out = reference.train_epochs(config, reference.PRECISIONS[precision],
                                 weights, epochs)
    out["weights"] = {(i, k): v for i, layer in enumerate(weights)
                      for k, v in layer.items()}
    out["batches"] = [b for e in epochs for b in e["train"]]
    return out


def compare(state, leaves=None):
    """The numbers compared for ``correct`` (see :mod:`portbench.
    checks`): set-up's recorded epochs against the reference's."""
    precision, _ = reference.POLICY_PRECISION[state.cell.traffic["policy"]]
    ref = reference_steps(state.cell, state.seed, state.device, precision)
    return checks.numbers(state.recorder.side(), ref, leaves)


def _leaves(gaps):
    return {kind: {"%d.%s" % key: value for key, value in by.items()}
            for kind, by in gaps.items()}


class _Still(object):
    """A solver that leaves the state unchanged (a planted fault)."""

    @staticmethod
    def init(params):
        return {}

    @staticmethod
    def update(params, grads, state, hp):
        pass


#: the timed path broken underneath, one way a name: the faults the
#: comparison has to catch
FAULTS = ("unchanged", "half_batch", "rows_shifted", "unshuffled",
          "seed_stuck")


def plant(trainer, fault):
    """Break ``trainer`` by ``fault`` (a name of :data:`FAULTS`):

    * ``unchanged``: the step returns the model's state unchanged;
    * ``half_batch``: the loss takes half of the batch, its mean over
      those rows;
    * ``rows_shifted``: the rows a step gets are shifted by one sample
      where they are produced (the streamed pipeline's host gather, or
      the resident gather);
    * ``unshuffled``: the loader's shuffle leaves the order as it is;
    * ``seed_stuck``: every training sweep draws the first epoch's
      dropout seed."""
    if fault == "unchanged":
        trainer.solvers = [_Still] * len(trainer.solvers)
    elif fault == "half_batch":
        loss = trainer._loss_and_metrics

        def half(out, truth, valid):
            n = out.shape[0] // 2
            return loss(out[:n], truth[:n], valid[:n])

        trainer._loss_and_metrics = half
    elif fault == "rows_shifted":
        loader = trainer.loader
        if trainer.streaming:
            fill = loader.fill_indices
            loader.fill_indices = lambda indices, kind=None, out=None: fill(
                numpy.roll(indices, 1), kind, out)
        else:
            gather = loader.gather_from
            loader.gather_from = lambda data_args, indices: gather(
                data_args, torch.roll(indices, 1))
    elif fault == "unshuffled":
        trainer.loader.shuffle = lambda: None
    elif fault == "seed_stuck":
        first = trainer._dropout_seed()
        trainer._dropout_seed = lambda: first
    else:
        raise ValueError("no fault %r (have %s)" % (fault, FAULTS))


def first_steps(cell, seed, device, fault=None):
    """Set-up's recorded epochs of a freshly built trainer, which is
    then freed (no window)."""
    state = setup(cell, seed, device, {}, fault)
    release(state)
    return state


def readings(cell, device, seeds, control_seeds, faults, fault_seeds, emit):
    """The readings of the numbers of :mod:`portbench.checks`: sound
    runs on ``seeds`` (the lower readings), the control (the reference
    one precision down in the program's place) on ``control_seeds`` and
    each of ``faults`` on ``fault_seeds`` (the upper readings); each
    reading goes to ``emit`` as a dict, with each leaf's gaps of the
    first gradient and of the change (``leaves``)."""
    precision, control = reference.POLICY_PRECISION[cell.traffic["policy"]]
    for seed in seeds:
        t0 = time.perf_counter()
        state = first_steps(cell, seed, device)
        gaps = {}
        numbers = compare(state, gaps)
        emit({"kind": "program", "seed": seed, "numbers": numbers,
              "losses": state.recorder.losses, "leaves": _leaves(gaps),
              "seconds": time.perf_counter() - t0})
    for seed in control_seeds:
        ref = reference_steps(cell, seed, device, precision)
        low = reference_steps(cell, seed, device, control)
        gaps = {}
        emit({"kind": "control", "precision": control, "seed": seed,
              "numbers": checks.numbers(low, ref, gaps),
              "leaves": _leaves(gaps)})
    for fault in faults:
        for seed in fault_seeds:
            emit({"kind": "fault", "fault": fault, "seed": seed,
                  "numbers": compare(first_steps(cell, seed, device,
                                                 fault))})
