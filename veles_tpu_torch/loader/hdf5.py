"""HDF5 dataset loader (``veles_tpu/loader/hdf5.py``).

Each class (test, validation, train) comes from one ``.h5`` file with a
``data`` dataset (N x sample shape) and a ``labels`` dataset (N,),
read once at initialization. ``h5py`` is imported only when a file is
read.
"""

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class HDF5Loader(FullBatchLoader):
    """``test_path`` / ``validation_path`` / ``train_path`` HDF5 files as
    a full batch."""

    DATA_DATASET = "data"
    LABELS_DATASET = "labels"

    def __init__(self, test_path=None, validation_path=None,
                 train_path=None, **kwargs):
        super(HDF5Loader, self).__init__(**kwargs)
        self.test_path = test_path
        self.validation_path = validation_path
        self.train_path = train_path

    def _read(self, path):
        try:
            import h5py
        except ImportError:
            raise ImportError("HDF5Loader needs h5py; it is not installed")
        with h5py.File(path, "r") as f:
            data = numpy.asarray(f[self.DATA_DATASET], numpy.float32)
            labels = None
            if self.LABELS_DATASET in f:
                labels = numpy.asarray(f[self.LABELS_DATASET], numpy.int32)
        return data, labels

    def load_dataset(self):
        self.load_class_files(
            (self.test_path, self.validation_path, self.train_path),
            self._read, kind="HDF5")
