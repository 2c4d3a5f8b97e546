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
holds a second copy of the dataset on the device.

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

    def gather(self, indices):
        """(data, labels, valid) of one minibatch from the staged copy;
        ``indices`` an integer tensor on its device. A padded slot (index
        below 0) has a zero row, label -1 and valid False."""
        if self._staged_ is None:
            raise RuntimeError("stage() the dataset on a device first")
        data, labels = self._staged_
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

    def gather(self, indices):
        """(data, targets, valid) of one minibatch."""
        if self._staged_ is None:
            raise RuntimeError("stage() the dataset on a device first")
        data, targets = self._staged_
        rows, _ = gather_minibatch(data, indices)
        picked, _ = gather_minibatch(targets, indices)
        return rows, picked, indices >= 0
