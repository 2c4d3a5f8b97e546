"""Pickled-arrays loader (``veles_tpu/loader/pickles.py``).

Each class file is a pickle of ``(data, labels)`` numpy arrays (or of
``data`` alone, which the port's softmax loaders refuse: they need
labels); samples become float32, labels int32.
"""

import pickle

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class PicklesLoader(FullBatchLoader):
    """``test_path`` / ``validation_path`` / ``train_path`` pickles as a
    full batch."""

    def __init__(self, test_path=None, validation_path=None,
                 train_path=None, **kwargs):
        super(PicklesLoader, self).__init__(**kwargs)
        self.test_path = test_path
        self.validation_path = validation_path
        self.train_path = train_path

    @staticmethod
    def _read(path):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if isinstance(blob, tuple) and len(blob) == 2:
            data, labels = blob
            return (numpy.asarray(data, numpy.float32),
                    numpy.asarray(labels, numpy.int32))
        return numpy.asarray(blob, numpy.float32), None

    def load_dataset(self):
        self.load_class_files(
            (self.test_path, self.validation_path, self.train_path),
            self._read, kind="pickle")
