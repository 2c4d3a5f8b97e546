"""Audio file loaders (``veles_tpu/loader/sound.py``).

WAV files of any PCM width decode through ``scipy.io.wavfile``; FLAC,
OGG and AIFF through the optional ``soundfile`` package when it is
installed. Samples become float32 in [-1, 1], mixed down to mono and
cut or zero-padded to ``samples`` frames, so the batch stacks; labels
are parent directory names, as the image loaders take them.
"""

import os

import numpy
import torch

from veles_tpu_torch.loader.file_scanner import LabeledFileScanner
from veles_tpu_torch.loader.fullbatch import FullBatchLoader

#: extensions decoded without optional packages
WAV_EXTENSIONS = (".wav", ".wave")
#: extensions that need the optional ``soundfile`` package
SOUNDFILE_EXTENSIONS = (".flac", ".ogg", ".aiff", ".aif")


def decode_sound(path):
    """(float32 mono samples in [-1, 1], sample rate) of one file."""
    ext = os.path.splitext(path)[1].lower()
    if ext in WAV_EXTENSIONS:
        from scipy.io import wavfile
        rate, data = wavfile.read(path)
        if data.dtype.kind == "i":
            data = data.astype(numpy.float32) / numpy.iinfo(data.dtype).max
        elif data.dtype.kind == "u":  # 8-bit WAV: offset binary
            info = numpy.iinfo(data.dtype)
            data = (data.astype(numpy.float32) - (info.max + 1) / 2) \
                / ((info.max + 1) / 2)
        else:
            data = data.astype(numpy.float32)
    elif ext in SOUNDFILE_EXTENSIONS:
        try:
            import soundfile
        except ImportError:
            raise ImportError(
                "decoding %s needs the optional 'soundfile' package "
                "(only PCM WAV is supported without it)" % path)
        data, rate = soundfile.read(path, dtype="float32")
    else:
        raise ValueError("unsupported audio format: %s" % path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return numpy.ascontiguousarray(data, numpy.float32), int(rate)


class SndFileLoader(FullBatchLoader):
    """Directory trees of audio files as a full batch; labels from
    parent directory names. ``samples`` frames a sample (None: the
    first file's length); every file must share the first's rate."""

    def __init__(self, test_paths=(), validation_paths=(), train_paths=(),
                 samples=None, ignored_dirs=(), filename_re=None,
                 **kwargs):
        super(SndFileLoader, self).__init__(**kwargs)
        self.test_paths = tuple(test_paths)
        self.validation_paths = tuple(validation_paths)
        self.train_paths = tuple(train_paths)
        self.samples = samples
        self.ignored_dirs = ignored_dirs
        self.filename_re = filename_re
        self.labels_mapping = {}
        self.sample_rate = None

    def _scan_class(self, paths):
        scanner = LabeledFileScanner(
            WAV_EXTENSIONS + SOUNDFILE_EXTENSIONS,
            ignored_dirs=self.ignored_dirs, filename_re=self.filename_re)
        found = []
        for base in paths:
            found.extend(scanner.scan(base))
        return found

    def _fit(self, data):
        if len(data) >= self.samples:
            return data[:self.samples]
        out = numpy.zeros(self.samples, numpy.float32)
        out[:len(data)] = data
        return out

    def load_dataset(self):
        per_class = [self._scan_class(p) for p in
                     (self.test_paths, self.validation_paths,
                      self.train_paths)]
        if not any(per_class):
            raise ValueError("%s found no audio files" % type(self).__name__)
        names = sorted({label for pairs in per_class for _, label in pairs})
        self.labels_mapping = {name: i for i, name in enumerate(names)}
        data, labels = [], []
        for klass, pairs in enumerate(per_class):
            for path, label in pairs:
                sound, rate = decode_sound(path)
                if self.sample_rate is None:
                    self.sample_rate = rate
                elif rate != self.sample_rate:
                    raise ValueError(
                        "%s: %s has rate %d, expected %d (resample the "
                        "dataset first)" % (type(self).__name__, path,
                                            rate, self.sample_rate))
                if self.samples is None:
                    self.samples = len(sound)
                data.append(self._fit(sound))
                labels.append(self.labels_mapping[label])
            self.class_lengths[klass] = len(pairs)
        self.original_data = torch.from_numpy(numpy.stack(data))
        self.original_labels = torch.from_numpy(
            numpy.asarray(labels, numpy.int32))

    @property
    def n_classes(self):
        return len(self.labels_mapping)
