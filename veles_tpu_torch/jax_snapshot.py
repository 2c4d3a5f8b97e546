"""Reading a snapshot of the JAX package without importing it.

A JAX snapshot is a pickle of ``veles_tpu`` objects -- the workflow and
its units, ``memory.Array``, ``mutable.Bool``, ``prng.RandomGenerator``,
``jax.Array`` solver state -- and may name classes of the user's
workflow file (a provider), which imports ``veles_tpu``. So the reader
is an unpickler whose ``find_class``

* resolves numpy's array and dtype constructors, a few builtins and
  ``collections`` from modules already loaded, and nothing else;
* maps every other class (``veles_tpu.*``, ``jax.*``, the user's) to an
  inert :class:`Record` that keeps its constructor arguments and its
  pickled state;
* never imports a module: neither ``sys.modules`` nor the user's file
  is touched.

:func:`load` then builds the port's workflow from the records: the
layer descriptors from each forward record's class (the inverse of
``standard_workflow.LAYER_TYPES``) and attributes; the weights, bias,
``up`` and ``down`` from the records' arrays (JAX layout, loaded by
``convert.params_from_jax`` at ``initialize()``); each gradient
record's solver state (``convert.solver_state_from_jax``, likewise);
the decision's ``epoch_history``, ``best_*``, ``complete`` and
``epoch_stats``; the loader's epoch position, permutation, class
lengths and (normalized) data; and the registry's streams, the JAX key
counter becoming the Philox seed chain's counter.

Workflow classes read: ``StandardWorkflow`` and its subclasses (the JAX
package's, and a user's class with the same graph), ``MnistWorkflow``
and ``KohonenWorkflow`` (its codebook, its trainer's schedule and
``time``, its counter's ``complete``), with their ``SnapshotterToFile``
and ``SnapshotterToDB`` units. Each gradient unit keeps its own solver,
so a workflow whose layers use different solvers comes over as it is.
A loader's requeued minibatches (``failed_minibatches``, the payloads of
a master's lost slaves) come over and are served first, as in JAX. Any
other class, and any other unit in the graph, raises.

The JAX ``KohonenWorkflow`` keeps its epoch limit in the closure of its
counter's class, which a pickle does not carry; the reader takes the
counter record's ``epochs`` where it has one, else the JAX constructor's
default (:data:`KOHONEN_EPOCHS`).
"""

import io
import pickle
import pickletools
import sys

import numpy
import torch

from veles_tpu_torch import prng

#: module -> names the reader resolves (from ``sys.modules`` only)
_ALLOWED = {
    "builtins": {"set", "frozenset", "complex", "slice", "range",
                 "bytearray", "bytes", "dict", "list", "tuple", "int",
                 "float", "bool", "str", "object"},
    "collections": {"OrderedDict", "defaultdict", "deque"},
    "copyreg": {"_reconstructor"},
    "numpy": {"dtype", "ndarray"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.numeric": {"_frombuffer"},
    "numpy.core.numeric": {"_frombuffer"},
}

#: the JAX package's StandardWorkflow classes
STANDARD_CLASSES = {
    "veles_tpu.standard_workflow": {"StandardWorkflow"},
    "veles_tpu.models.alexnet": {"AlexNetWorkflow"},
    "veles_tpu.models.cifar": {"CifarWorkflow"},
    "veles_tpu.models.mnist_ae": {"MnistAEWorkflow"},
    "veles_tpu.models.samples": {"WineWorkflow", "KanjiWorkflow",
                                 "ChannelsWorkflow", "SequenceWorkflow",
                                 "LinesWorkflow"},
}

#: the JAX ``KohonenWorkflow``'s default epoch limit
KOHONEN_EPOCHS = 10

#: JAX forward unit class -> (descriptor type, {attribute: parameter})
_SHAPE = {"output_sample_shape": "output_sample_shape",
          "activation_name": "activation"}
_CONV = {"n_kernels": "n_kernels", "kx": "kx", "ky": "ky",
         "sliding": "sliding", "padding": "padding"}
_POOL = {"kx": "kx", "ky": "ky", "sliding": "sliding"}
FORWARDS = {
    "All2All": ("all2all", _SHAPE),
    "All2AllTanh": ("all2all_tanh", _SHAPE),
    "All2AllRELU": ("all2all_relu", _SHAPE),
    "All2AllStrictRELU": ("all2all_str", _SHAPE),
    "All2AllSigmoid": ("all2all_sigmoid", _SHAPE),
    "All2AllSoftmax": ("softmax", _SHAPE),
    "Conv": ("conv", dict(_CONV, space_to_depth="space_to_depth",
                          activation_name="activation")),
    "ConvTanh": ("conv_tanh", dict(_CONV, space_to_depth="space_to_depth")),
    "ConvRELU": ("conv_relu", dict(_CONV, space_to_depth="space_to_depth")),
    "ConvStrictRELU": ("conv_str", dict(_CONV,
                                        space_to_depth="space_to_depth")),
    "ConvSigmoid": ("conv_sigmoid",
                    dict(_CONV, space_to_depth="space_to_depth")),
    "Deconv": ("deconv", _CONV),
    "MaxPooling": ("max_pooling", _POOL),
    "MaxAbsPooling": ("maxabs_pooling", _POOL),
    "AvgPooling": ("avg_pooling", _POOL),
    "Depooling": ("depooling", _POOL),
    "LRNormalizerForward": ("norm", {"k": "k", "alpha": "alpha",
                                     "beta": "beta", "n": "n"}),
    "DropoutForward": ("dropout", {"dropout_ratio": "dropout_ratio"}),
    "ActivationUnit": ("activation", {"activation_name": "activation"}),
    "MultiHeadAttentionForward": ("attention", {
        "heads": "heads", "causal": "causal", "residual": "residual"}),
    "MoEForward": ("moe", {
        "n_experts": "n_experts", "hidden": "hidden",
        "capacity_factor": "capacity_factor", "residual": "residual",
        "aux_loss_weight": "aux_loss_weight"}),
}

#: forward record attributes every unit carries (descriptor keys)
_COMMON = {"include_bias": "include_bias", "rand_name": "rand",
           "name": "name"}


class Record(object):
    """An object of a class the reader does not load: ``module`` and
    ``qualname`` of its class, ``args`` it was built with, its pickled
    ``state``."""

    module = qualname = None

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        obj.state = None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def get(self, name, default=None):
        """An attribute of the pickled state."""
        state = self.state
        if isinstance(state, tuple) and len(state) == 2:
            state = state[0]
        if isinstance(state, dict):
            return state.get(name, default)
        return default

    def __repr__(self):
        return "<Record %s.%s>" % (self.module, self.qualname)


class _RecordUnpickler(pickle.Unpickler):
    def __init__(self, fileobj):
        super(_RecordUnpickler, self).__init__(fileobj)
        self._classes = {}

    def find_class(self, module, name):
        if name in _ALLOWED.get(module, ()):
            loaded = sys.modules.get(module)
            if loaded is not None:
                return getattr(loaded, name)
        key = (module, name)
        cls = self._classes.get(key)
        if cls is None:
            cls = type(name, (Record,), {"module": module,
                                         "qualname": name})
            self._classes[key] = cls
        return cls

    def persistent_load(self, pid):
        return None


def is_jax_snapshot(payload):
    """True when the first class of either package that a pickle names
    comes from the JAX package (``veles_tpu``), False when it comes from
    the port (``veles_tpu_torch``); classes of other modules (a user's
    workflow file) are passed over. Reads the opcodes only."""
    memo, stack = {}, []
    for opcode, arg, _ in pickletools.genops(payload):
        name = opcode.name
        if name in ("GLOBAL", "STACK_GLOBAL"):
            module = arg.split(" ", 1)[0] if name == "GLOBAL" else \
                (stack[-2] if len(stack) > 1 else "")
            top = str(module).split(".")[0]
            if top in ("veles_tpu", "veles_tpu_torch"):
                return top == "veles_tpu"
        elif name == "MEMOIZE":
            memo[len(memo)] = stack[-1] if stack else None
        elif name in ("BINPUT", "LONG_BINPUT", "PUT"):
            memo[arg] = stack[-1] if stack else None
        elif name in ("BINGET", "LONG_BINGET", "GET"):
            stack.append(memo.get(arg))
        elif isinstance(arg, str):
            stack.append(arg)
        else:
            stack.append(None)
    return False


#: numpy's array reconstructors (what a ``jax.Array`` pickles through)
_RECONSTRUCT = tuple(
    getattr(sys.modules[m], "_reconstruct")
    for m in ("numpy._core.multiarray", "numpy.core.multiarray")
    if m in sys.modules and hasattr(sys.modules[m], "_reconstruct"))


def array_of(value):
    """The numpy array a record holds: an ``Array``'s ``mem``, a
    ``jax.Array``'s reconstructed values, or the array itself."""
    if value is None or isinstance(value, numpy.ndarray):
        return value
    if isinstance(value, numpy.generic):
        return numpy.asarray(value)
    if isinstance(value, Record):
        if value.qualname == "Array":
            return value.get("mem")
        if value.qualname == "_reconstruct_array":
            # jax.Array: (numpy's _reconstruct, its args, the array's
            # pickled state, the abstract value's)
            fun, args, array_state = value.args[:3]
            if fun in _RECONSTRUCT:
                array = fun(*args)
                array.__setstate__(array_state)
                return array
        for item in tuple(value.args) + (value.state,):
            found = _find_array(item)
            if found is not None:
                return found
    raise ValueError("no array in %r" % (value,))


def _find_array(item):
    if isinstance(item, numpy.ndarray):
        return item
    if isinstance(item, (tuple, list)):
        for x in item:
            found = _find_array(x)
            if found is not None:
                return found
    return None


def _bool(record):
    """A literal ``Bool`` record's value."""
    if isinstance(record, Record) and record.qualname == "Bool":
        return bool(record.get("value"))
    return bool(record)


def _tree(value):
    """A solver state record (dicts of ``jax.Array`` records) as numpy."""
    if isinstance(value, dict):
        return {k: _tree(v) for k, v in value.items()}
    return array_of(value)


def load(payload):
    """The port's workflow from a JAX snapshot's bytes, the ``prng``
    registry restored from it."""
    blob = _RecordUnpickler(io.BytesIO(payload)).load()
    if not isinstance(blob, dict) or "workflow" not in blob:
        raise pickle.UnpicklingError(
            "not a veles snapshot stream (missing workflow header)")
    workflow = translate(blob["workflow"])
    for key, gen in (blob.get("random") or {}).items():
        prng.get(key).restore_state((gen.get("numpy_state"),
                                     int(gen.get("jax_counter", 0)),
                                     gen.get("seed_value")))
    return workflow


def _is_standard(record):
    names = STANDARD_CLASSES.get(record.module)
    if names is not None:
        return record.qualname in names
    if record.module.split(".")[0] == "veles_tpu":
        return False
    # a user's subclass: the standard graph's parts are all there
    return all(record.get(k) is not None for k in (
        "repeater", "loader", "forwards", "evaluator", "decision", "gds"))


def translate(record):
    """A JAX workflow record -> the port's workflow (not initialized)."""
    from veles_tpu_torch.snapshotter import mark_restored
    if not isinstance(record, Record):
        raise pickle.UnpicklingError("the snapshot holds no workflow")
    if record.module == "veles_tpu.models.mnist_ae" and \
            record.qualname == "KohonenWorkflow":
        _check_covered(record, ("loader", "trainer", "forward", "counter"))
        workflow = _kohonen_workflow(record)
        _copy_loader(workflow.loader, record.get("loader"))
        _copy_snapshotters(workflow, record, workflow.counter)
    else:
        workflow = _trainable_workflow(record)
        _copy_snapshotters(workflow, record, workflow.decision)
    mark_restored(workflow)
    return workflow


def _check_covered(record, names, units=()):
    """Raise on a unit of the record's graph that is none of its
    attributes ``names``, of ``units``, of its plumbing or a
    snapshotter."""
    covered = {id(u) for u in list(units) + [record.get(n) for n in names + (
        "repeater", "start_point", "end_point")]}
    for unit in record.get("_units") or ():
        if id(unit) not in covered and unit.qualname not in _SNAPSHOTTERS:
            raise NotImplementedError(
                "unit %s (%s.%s) of the JAX snapshot has no port yet"
                % (unit.get("name"), unit.module, unit.qualname))


def _trainable_workflow(record):
    forwards = list(record.get("forwards") or ())
    gds = {id(gd.get("forward")): gd for gd in record.get("gds") or ()}
    decision = record.get("decision")
    loader_rec = record.get("loader")
    evaluator = record.get("evaluator")
    _check_covered(record, ("decision", "loader", "evaluator"),
                   forwards + list(record.get("gds") or ()))
    if record.module == "veles_tpu.models.mnist" and \
            record.qualname == "MnistWorkflow":
        workflow = _mnist_workflow(record, forwards, gds, decision,
                                   loader_rec)
    elif _is_standard(record):
        workflow = _standard_workflow(record, forwards, gds, decision,
                                      loader_rec, evaluator)
    else:
        raise NotImplementedError(
            "%s.%s: the port reads snapshots of StandardWorkflow, its "
            "subclasses, MnistWorkflow and KohonenWorkflow; it has no "
            "counterpart of this workflow class"
            % (record.module, record.qualname))
    _copy_loader(workflow.loader, loader_rec)
    _copy_decision(workflow.decision, decision)
    for key in ("n_err", "loss", "rmse", "confusion_matrix", "testing"):
        if evaluator.get(key) is not None:
            setattr(workflow.evaluator, key, evaluator.get(key))
    port_gds = {id(gd.forward): gd for gd in workflow.gds}
    for fwd_rec, fwd in zip(forwards, workflow.forwards):
        params = {}
        for key in ("weights", "bias", "up", "down"):
            value = fwd_rec.get(key)
            if value is not None and array_of(value) is not None:
                params[key] = array_of(value)
        if params and fwd.has_weights:
            fwd._params = params
        if hasattr(fwd, "testing") and fwd_rec.get("testing") is not None:
            fwd.testing = bool(fwd_rec.get("testing"))
        gd_rec = gds.get(id(fwd_rec))
        if gd_rec is None:
            continue
        gd = port_gds[id(fwd)]
        gd.solver_name = gd_rec.get("solver_name", "sgd")
        gd._solver_hp = dict(gd_rec.get("_solver_hp") or {})
        state = gd_rec.get("opt_state")
        if state:
            gd._solver_state = _tree(state)
    return workflow


def _kohonen_workflow(record):
    """The port's ``KohonenWorkflow`` from the JAX one's record: the
    trainer's grid, schedule, ``time`` and codebook, the counter's limit
    and ``complete`` (the loader is copied by the caller)."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.mnist_ae import KohonenWorkflow
    trainer, counter = record.get("trainer"), record.get("counter")
    loader_rec = record.get("loader")
    workflow = KohonenWorkflow(
        DummyLauncher(), loader_factory=lambda wf: FullBatchLoader(
            workflow=wf, minibatch_size=loader_rec.get("max_minibatch_size"),
            name=loader_rec.get("name")),
        sx=trainer.get("sx"), sy=trainer.get("sy"),
        epochs=counter.get("epochs", KOHONEN_EPOCHS),
        name=record.get("name"))
    unit = workflow.trainer
    unit.sigma0 = float(trainer.get("sigma0"))
    unit.learning_rate = float(trainer.get("learning_rate"))
    unit.decay = float(trainer.get("decay"))
    unit.rand_name = trainer.get("rand_name", "default")
    unit.time = int(trainer.get("time", 0))
    weights = array_of(trainer.get("weights"))
    if weights is not None:
        unit.weights = torch.from_numpy(numpy.array(weights,
                                                    numpy.float32))
    workflow.counter.complete.value = _bool(counter.get("complete"))
    return workflow


def _layer_descriptor(fwd_rec):
    entry = FORWARDS.get(fwd_rec.qualname)
    if entry is None or not fwd_rec.module.startswith("veles_tpu.nn."):
        raise NotImplementedError(
            "forward unit %s.%s of the JAX snapshot has no port"
            % (fwd_rec.module, fwd_rec.qualname))
    ltype, attrs = entry
    descr = {"type": ltype}
    for attr, key in dict(attrs, **_COMMON).items():
        value = fwd_rec.get(attr)
        if value is not None:
            descr[key] = value
    return descr


def _hypers(gd_rec):
    return {"learning_rate": gd_rec.get("learning_rate", 0.01),
            "weights_decay": gd_rec.get("weights_decay", 0.0),
            "momentum": gd_rec.get("gradient_moment", 0.0)}


def _standard_workflow(record, forwards, gds, decision, loader_rec,
                       evaluator):
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,
                                                  FullBatchLoaderMSE)
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    layers = []
    for fwd_rec in forwards:
        descr = _layer_descriptor(fwd_rec)
        gd_rec = gds.get(id(fwd_rec))
        if gd_rec is not None:
            descr.update(_hypers(gd_rec))
        layers.append(descr)
    mse = evaluator.qualname == "EvaluatorMSE"
    loader_cls = FullBatchLoaderMSE if mse else FullBatchLoader
    loader = loader_cls(minibatch_size=loader_rec.get("max_minibatch_size"),
                        name=loader_rec.get("name"))
    return StandardWorkflow(
        DummyLauncher(), loader=loader, layers=layers,
        loss="mse" if mse else "softmax",
        max_epochs=decision.get("max_epochs"),
        fail_iterations=decision.get("fail_iterations", 100),
        name=record.get("name"))


def _mnist_workflow(record, forwards, gds, decision, loader_rec):
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mnist import MnistWorkflow
    gd_rec = gds.get(id(forwards[-1]))
    hyper = _hypers(gd_rec)
    return MnistWorkflow(
        DummyLauncher(),
        layers=tuple(int(numpy.prod(f.get("output_sample_shape")))
                     for f in forwards[:-1]),
        minibatch_size=loader_rec.get("max_minibatch_size"),
        learning_rate=hyper["learning_rate"],
        weights_decay=hyper["weights_decay"], momentum=hyper["momentum"],
        max_epochs=decision.get("max_epochs"),
        fail_iterations=decision.get("fail_iterations", 100),
        name=record.get("name"))


def _copy_loader(loader, rec):
    data = array_of(rec.get("original_data"))
    if data is None:
        raise ValueError("the JAX snapshot's loader holds no dataset")
    loader.original_data = torch.from_numpy(numpy.array(data,
                                                        numpy.float32))
    labels = rec.get("original_labels")
    if labels is not None and array_of(labels) is not None:
        loader.original_labels = torch.from_numpy(
            numpy.array(array_of(labels), numpy.int32))
    targets = rec.get("original_targets")
    if targets is not None and array_of(targets) is not None:
        loader.original_targets = torch.from_numpy(
            numpy.array(array_of(targets), numpy.float32))
    loader.normalization_type = "none"
    loader.class_lengths = [int(n) for n in rec.get("class_lengths")]
    loader.max_minibatch_size = int(rec.get("max_minibatch_size"))
    loader.shuffled_indices = numpy.array(
        array_of(rec.get("shuffled_indices")), numpy.int32)
    for key in ("epoch_number", "_global_offset", "minibatch_class",
                "minibatch_offset", "minibatch_size", "samples_served"):
        setattr(loader, key, int(rec.get(key, 0)))
    shuffle_limit = rec.get("shuffle_limit")
    if shuffle_limit is not None:
        loader.shuffle_limit = shuffle_limit
    loader.rand_name = rec.get("rand_name", "loader")
    loader.failed_minibatches = [
        dict(job, indices=numpy.array(array_of(job["indices"]), numpy.int32),
             **{k: _bool(job[k]) for k in ("last", "train_ended",
                                           "epoch_ended") if k in job})
        for job in rec.get("failed_minibatches") or ()]
    for key in ("epoch_ended", "last_minibatch", "train_ended"):
        getattr(loader, key).value = _bool(rec.get(key))


def _copy_decision(decision, rec):
    decision.epoch_history = list(rec.get("epoch_history") or [])
    decision.best_metric = float(rec.get("best_metric", numpy.inf))
    decision.best_epoch = int(rec.get("best_epoch", -1))
    decision.testing = bool(rec.get("testing", False))
    decision.epoch_stats = [dict(s) for s in rec.get("epoch_stats")]
    for key in ("complete", "improved", "gd_skip"):
        getattr(decision, key).value = _bool(rec.get(key))


#: the JAX snapshotter units a snapshot carries over
_SNAPSHOTTERS = ("SnapshotterToFile", "SnapshotterToDB")


def _copy_snapshotters(workflow, record, after):
    """The record's ``SnapshotterToFile`` and ``SnapshotterToDB`` units
    with their settings, wired as a training workflow wires one: after
    the unit ``after`` (the decision, or a SOM's epoch counter), skipped
    until the epoch ends."""
    from veles_tpu_torch import snapshotter
    for unit in record.get("_units") or ():
        if unit.qualname not in _SNAPSHOTTERS:
            continue
        target = ({"directory": unit.get("directory")}
                  if unit.qualname == "SnapshotterToFile" else
                  {"database": unit.get("database")})
        snap = getattr(snapshotter, unit.qualname)(
            workflow, prefix=unit.get("prefix", "wf"),
            interval=unit.get("interval", 1),
            time_interval=unit.get("time_interval", 15.0),
            compression=unit.get("compression", "gz"),
            name=unit.get("name"), **target)
        snap.link_from(after)
        snap.gate_skip = ~workflow.loader.epoch_ended
