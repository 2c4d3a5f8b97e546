"""Full-batch loaders: the whole dataset on the device
(``veles_tpu/loader/fullbatch.py``, with the gather of
``veles_tpu/ops/gather.py``).

A subclass fills ``original_data`` (a CPU tensor, samples first) and
``original_labels`` (int32) in :meth:`FullBatchLoader.load_dataset`.
:meth:`FullBatchLoader.stage` copies both to the device once; every
minibatch is then gathered there by index (:func:`gather_minibatch`),
so the host never touches sample data in the training loop.
"""

import torch

from veles_tpu_torch.loader.base import Loader
from veles_tpu_torch.ops.gather import gather_minibatch


class FullBatchLoader(Loader):
    """Whole dataset on the device; minibatches gathered there."""

    def __init__(self, **kwargs):
        super(FullBatchLoader, self).__init__(**kwargs)
        self.original_data = None
        self.original_labels = None
        self._staged = None

    def load_dataset(self):
        """Fill ``original_data``, ``original_labels`` and
        ``class_lengths``."""
        raise NotImplementedError

    def load_data(self):
        if self.original_data is None:
            self.load_dataset()
        if self.original_data is None or self.original_labels is None:
            raise ValueError("%s.load_dataset left the data or the labels "
                             "empty" % type(self).__name__)

    def stage(self, device):
        """Copy the dataset to ``device`` once (a repeat is free)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._staged is None or self._staged[0].device != device:
            self._staged = (self.original_data.to(device),
                            self.original_labels.to(device))
        return self._staged

    def gather(self, indices):
        """(data, labels, valid) of one minibatch from the staged copy;
        ``indices`` an integer tensor on its device. A padded slot (index
        below 0) has a zero row, label -1 and valid False."""
        if self._staged is None:
            raise RuntimeError("stage() the dataset on a device first")
        data, labels = self._staged
        rows, picked = gather_minibatch(data, indices, labels)
        return rows, picked, indices >= 0
