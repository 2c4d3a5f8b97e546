"""Full-batch loaders: the whole dataset on the device
(``veles_tpu/loader/fullbatch.py``, with the gather of
``veles_tpu/ops/gather.py``).

A subclass fills ``original_data`` (a CPU tensor, samples first) and
``original_labels`` (int32) in :meth:`FullBatchLoader.load_dataset`.
Before staging, the data pass through the loader's normalizer
(``normalization_type`` and ``normalization_parameters``, the registry of
:mod:`veles_tpu_torch.normalization`), analyzed on the TRAIN segment
only -- the layout is [test, validation, train] -- and applied in numpy,
so the normalized bytes are the JAX package's. :meth:`FullBatchLoader.
stage` copies the dataset to the device once (a transient copy: a
snapshot holds the host dataset, already normalized, and a restored
loader stages it again); every minibatch is then gathered there by
index (:func:`gather_minibatch`), so the host never touches sample data
in the training loop. The eager loop (:meth:`FullBatchLoader.
fill_minibatch`) gathers from the same staged copy, so neither path
holds a second copy of the dataset on the device. A run that streams
the dataset instead (``train/step.py``, out of core) reads the host
copy through :meth:`FullBatchLoader.host_backing` and
:meth:`FullBatchLoader.fill_indices` from the prefetch workers and
drops any staged copy (:meth:`FullBatchLoader.release_staged`).

* :class:`ProviderLoader` reads ``(train_x, train_y, valid_x, valid_y)``
  from a provider callable, validation before training, flat
  ``(n, features)`` with ``flatten`` or else NHWC (a 3-D dataset gains a
  singleton channel), or, with ``sequence``, (n, seq, dim) token
  sequences kept 3-D;
* :class:`TabularLoader` is a ProviderLoader normalized by
  ``mean_disp`` unless told otherwise (``veles_tpu/models/samples.py``);
* :class:`FullBatchLoaderMSE` adds per-sample regression targets
  (``original_targets``), staged beside the data and gathered with it:
  the truth of the MSE loss.
"""

import numpy
import torch

from veles_tpu_torch.loader.base import VALIDATION, Loader
from veles_tpu_torch.loader.prefetch import gather_rows
from veles_tpu_torch.normalization import NormalizerRegistry
from veles_tpu_torch.ops.gather import gather_minibatch


class FullBatchLoader(Loader):
    """Whole dataset on the device; minibatches gathered there."""

    #: what :meth:`gather` returns beside the data
    TRUTH = "labels"

    def __init__(self, normalization_type="none",
                 normalization_parameters=None, **kwargs):
        super(FullBatchLoader, self).__init__(**kwargs)
        self.normalization_type = normalization_type
        self.normalization_parameters = dict(normalization_parameters or {})
        self.normalizer = None
        self.original_data = None
        self.original_labels = None

    def init_unpickled(self):
        super(FullBatchLoader, self).init_unpickled()
        self._staged_ = None

    def load_dataset(self):
        """Fill ``original_data``, ``original_labels`` and
        ``class_lengths``."""
        raise NotImplementedError

    def load_class_files(self, paths, reader, kind="data"):
        """Assemble the dataset from per-class files: ``paths`` =
        (test, validation, train), None for an absent class;
        ``reader(path) -> (data, labels or None)``. Labels must match
        their data's length, and every class file carries them or none
        does (the pickle and HDF5 loaders)."""
        data_parts, label_parts = [], []
        for klass, path in enumerate(paths):
            if path is None:
                continue
            data, labels = reader(path)
            self.class_lengths[klass] = len(data)
            data_parts.append(data)
            if labels is not None:
                if len(labels) != len(data):
                    raise ValueError("%s: %d labels for %d samples in %s" % (
                        type(self).__name__, len(labels), len(data), path))
                label_parts.append(labels)
        if not data_parts:
            raise ValueError("%s: no %s paths given"
                             % (type(self).__name__, kind))
        if label_parts and len(label_parts) != len(data_parts):
            raise ValueError("%s: %d of %d class files carry labels -- need "
                             "all or none" % (type(self).__name__,
                                              len(label_parts),
                                              len(data_parts)))
        self.original_data = torch.from_numpy(numpy.ascontiguousarray(
            numpy.concatenate(data_parts)))
        if label_parts:
            self.original_labels = torch.from_numpy(
                numpy.concatenate(label_parts))

    def load_data(self):
        if self.original_data is None:
            self.load_dataset()
            self._normalize_data()
        if self.original_data is None or self.truth() is None:
            raise ValueError("%s.load_dataset left the data or the %s empty"
                             % (type(self).__name__, self.TRUTH))

    def _normalize_data(self):
        """The normalizer analyzed on the TRAIN segment and applied to
        every sample, in numpy float32."""
        self.normalizer = NormalizerRegistry.make(
            self.normalization_type, **self.normalization_parameters)
        if self.normalizer.is_identity:
            return
        data = self.original_data.numpy().astype(numpy.float32)
        self.normalizer.analyze(data[self.class_end_offsets[VALIDATION]:])
        self.original_data = torch.from_numpy(numpy.ascontiguousarray(
            self.normalizer.normalize(data), numpy.float32))

    def truth(self):
        """The per-sample truth of the loss: the labels."""
        return self.original_labels

    def sample_shape(self):
        return tuple(self.original_data.shape[1:])

    def stage(self, device):
        """Copy the dataset and its truth to ``device`` once (a repeat is
        free)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._staged_ is None or self._staged_[0].device != device:
            self._staged_ = (self.original_data.to(device),
                             self.truth().to(device))
        return self._staged_

    def release_staged(self):
        """Drop the staged device copy (a streamed run must not keep it
        resident beside its staging ring)."""
        self._staged_ = None

    def host_backing(self, kind=None):
        """``(data, truth)``: the host tensors the dataset streams from.
        ``kind`` (``labels`` or ``targets``) must be this loader's
        truth."""
        if kind is not None and kind != self.TRUTH:
            raise ValueError("%s has no host-resident %s"
                             % (type(self).__name__, kind))
        return self.original_data, self.truth()

    def fill_indices(self, indices, kind=None, out=None):
        data, truth = self.host_backing(kind)
        return gather_rows(data, truth, indices, out=out)

    def gather(self, indices):
        """(data, labels, valid) of one minibatch from the staged copy;
        ``indices`` an integer tensor on its device. A padded slot (index
        below 0) has a zero row, label -1 and valid False."""
        if self._staged_ is None:
            raise RuntimeError("stage() the dataset on a device first")
        return self.gather_from(self._staged_, indices)

    def gather_from(self, data_args, indices):
        """:meth:`gather` from ``data_args`` = (data, truth) on the
        indices' device: the staged copy, or a streamed shard with its
        local indices."""
        data, labels = data_args
        rows, picked = gather_minibatch(data, indices, labels)
        return rows, picked, indices >= 0

    def fill_minibatch(self):
        """The eager minibatch: data and truth of ``minibatch_indices``
        gathered from the staged copy (staged on first use)."""
        self.stage(self.device_)
        data, truth, _ = self.gather(self.minibatch_indices)
        self.minibatch_data = data
        setattr(self, "minibatch_" + self.TRUTH, truth)


class ProviderLoader(FullBatchLoader):
    """Full batch over a provider callable returning ``(train_x, train_y,
    valid_x, valid_y)``: classes ``[0, valid, train]``, float32 samples,
    int32 labels."""

    def __init__(self, provider=None, flatten=False, sequence=False,
                 **kwargs):
        super(ProviderLoader, self).__init__(**kwargs)
        self.provider = provider
        self.flatten = flatten
        #: 3-D samples are (seq, dim) token sequences: no NHWC channel
        self.sequence = sequence

    def __getstate__(self):
        # the data travel with the snapshot: the provider (often a class
        # of the user's workflow file) stays behind
        state = super(ProviderLoader, self).__getstate__()
        if self.original_data is not None:
            state["provider"] = None
        return state

    def load_dataset(self):
        train_x, train_y, valid_x, valid_y = self.provider()
        data = numpy.concatenate([valid_x, train_x], axis=0).astype(
            numpy.float32)
        labels = numpy.concatenate([valid_y, train_y], axis=0).astype(
            numpy.int32)
        if self.flatten:
            data = data.reshape(len(data), -1)
        elif data.ndim == 3 and not self.sequence:
            data = data[..., None]  # NHWC single channel
        self.original_data = torch.from_numpy(numpy.ascontiguousarray(data))
        self.original_labels = torch.from_numpy(labels)
        self.class_lengths = [0, len(valid_x), len(train_x)]


class TabularLoader(ProviderLoader):
    """A :class:`ProviderLoader` over any (tx, ty, vx, vy) provider,
    ``mean_disp``-normalized by default (the wine sample's recipe)."""

    def __init__(self, provider=None, **kwargs):
        kwargs.setdefault("normalization_type", "mean_disp")
        super(TabularLoader, self).__init__(provider=provider, **kwargs)


class FullBatchLoaderMSE(FullBatchLoader):
    """Adds per-sample regression targets: ``original_targets``, a float32
    CPU tensor, samples first, staged and gathered beside the data (a
    padded slot gets a zero row)."""

    TRUTH = "targets"
    SHAPE_ONLY_STATE = FullBatchLoader.SHAPE_ONLY_STATE + (
        "minibatch_targets",)

    def __init__(self, **kwargs):
        super(FullBatchLoaderMSE, self).__init__(**kwargs)
        self.original_targets = None
        self.minibatch_targets = None

    def initialize(self, device=None, **kwargs):
        super(FullBatchLoaderMSE, self).initialize(device=device, **kwargs)
        self.minibatch_targets = torch.empty(
            (self.max_minibatch_size,) + tuple(
                self.original_targets.shape[1:]), device="meta")
        return self

    def truth(self):
        return self.original_targets

    def gather_from(self, data_args, indices):
        """(data, targets, valid) of one minibatch."""
        data, targets = data_args
        rows, _ = gather_minibatch(data, indices)
        picked, _ = gather_minibatch(targets, indices)
        return rows, picked, indices >= 0
