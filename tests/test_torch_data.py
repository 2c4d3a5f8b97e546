"""The port's data path against the JAX package's, on the CPU.

Normalizers, the procedural datasets, the MNIST, CIFAR and autoencoder
loaders and the file readers of ``veles_tpu_torch`` are held against
their JAX counterparts on the same inputs. Everything here is numpy on
both sides, so the tolerance is none: the bytes are equal.
"""

import gzip
import os
import pickle
import struct
import subprocess
import sys

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import datasets as jax_datasets  # noqa: E402
from veles_tpu.dummy import DummyWorkflow  # noqa: E402
from veles_tpu.loader.fullbatch import \
    ProviderLoader as JaxProviderLoader  # noqa: E402
from veles_tpu.models import cifar as jax_cifar  # noqa: E402
from veles_tpu.models import mnist as jax_mnist  # noqa: E402
from veles_tpu.models import mnist_ae as jax_mnist_ae  # noqa: E402
from veles_tpu_torch import datasets  # noqa: E402
from veles_tpu_torch.loader.fullbatch import ProviderLoader  # noqa: E402
from veles_tpu_torch.models.cifar import CifarLoader  # noqa: E402
from veles_tpu_torch.models.mnist import (MnistLoader,  # noqa: E402
                                          mnist_idx_provider, read_idx)
from veles_tpu_torch.models.mnist_ae import AutoencoderLoader  # noqa: E402
from veles_tpu_torch.normalization import NormalizerRegistry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes_equal(ours, theirs):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = numpy.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    numpy.testing.assert_array_equal(
        numpy.ascontiguousarray(ours).view(numpy.uint8),
        numpy.ascontiguousarray(theirs).view(numpy.uint8))


def _provider(n_train=30, n_valid=10, shape=(6, 5), seed=3, scale=255.0):
    rng = numpy.random.RandomState(seed)
    data = (rng.rand(n_train + n_valid, *shape) * scale).astype(
        numpy.float32)
    # a constant feature: the normalizers' zero-span branches
    data.reshape(len(data), -1)[:, 0] = 7.0
    labels = rng.randint(0, 10, n_train + n_valid).astype(numpy.int32)
    cached = (data[:n_train], labels[:n_train], data[n_train:],
              labels[n_train:])
    return lambda: cached


NORMALIZERS = [
    ("none", {}),
    ("linear", {}),
    ("linear", {"interval": (0.0, 1.0)}),
    ("mean_disp", {}),
    ("external_mean", {"mean_source": numpy.linspace(
        0, 100, 30, dtype=numpy.float32).reshape(6, 5, 1), "scale": 0.5}),
    ("range_linear", {}),
    ("exp", {}),
    ("pointwise", {}),
]


@pytest.mark.parametrize("name,params", NORMALIZERS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(NORMALIZERS)])
def test_normalizers_match_jax_on_the_train_segment(name, params):
    """A loader's normalizer, analyzed on its TRAIN segment only and
    applied to every sample, gives the JAX loader's bytes; the
    validation samples do not enter the analysis (changing them moves
    no training sample)."""
    provider = _provider()
    theirs = JaxProviderLoader(
        DummyWorkflow(), provider=provider, normalization_type=name,
        normalization_parameters=params)
    theirs.load_data()
    ours = ProviderLoader(provider=provider, normalization_type=name,
                          normalization_parameters=params).initialize()
    _bytes_equal(ours.original_data, theirs.original_data.mem)
    _bytes_equal(ours.original_labels, theirs.original_labels.mem)
    assert ours.class_lengths == list(theirs.class_lengths) == [0, 10, 30]
    assert type(ours.normalizer).__name__ == \
        type(theirs.normalizer).__name__
    train_x, train_y, valid_x, valid_y = provider()
    shifted = ProviderLoader(
        provider=lambda: (train_x, train_y, valid_x + 1000.0, valid_y),
        normalization_type=name,
        normalization_parameters=params).initialize()
    numpy.testing.assert_array_equal(shifted.original_data[10:].numpy(),
                                     ours.original_data[10:].numpy())


def test_normalizer_registry_has_the_jax_keys():
    from veles_tpu.normalization import \
        NormalizerRegistry as JaxNormalizerRegistry
    assert sorted(NormalizerRegistry.normalizers) == sorted(
        JaxNormalizerRegistry.normalizers)
    with pytest.raises(ValueError):
        NormalizerRegistry.make("zscore")


@pytest.mark.parametrize("kind,args", [
    ("golden_digits", (40, 12)), ("golden_digits", (7, 3, 11)),
    ("golden_objects", (40, 12)), ("golden_objects", (5, 5, 4))])
def test_golden_datasets_are_byte_equal(kind, args):
    ours = getattr(datasets, kind)(*args)()
    theirs = getattr(jax_datasets, kind)(*args)()
    for a, b in zip(ours, theirs):
        _bytes_equal(a, b)


@pytest.mark.parametrize("flatten", [True, False], ids=["flat", "nhwc"])
def test_mnist_loader_matches_jax(flatten):
    provider = datasets.golden_digits(24, 8, seed=5)
    theirs = jax_mnist.MnistLoader(DummyWorkflow(), provider=provider,
                                   flatten=flatten)
    theirs.load_data()
    ours = MnistLoader(provider=provider, flatten=flatten).initialize()
    assert ours.normalization_type == theirs.normalization_type == "linear"
    assert tuple(ours.original_data.shape) == (
        (32, 784) if flatten else (32, 28, 28, 1))
    _bytes_equal(ours.original_data, theirs.original_data.mem)
    _bytes_equal(ours.original_labels, theirs.original_labels.mem)
    assert ours.class_lengths == list(theirs.class_lengths) == [0, 8, 24]


@pytest.mark.parametrize("source", ["provider", "synthetic", "pickles"])
def test_cifar_loader_matches_jax(source, tmp_path):
    if source == "provider":
        kwargs = {"provider": datasets.golden_objects(20, 6, seed=9)}
    elif source == "synthetic":
        kwargs = {"synthetic_samples": 25, "seed": 4}
    else:
        _write_cifar(tmp_path)
        kwargs = {"directory": str(tmp_path)}
    theirs = jax_cifar.CifarLoader(DummyWorkflow(), **kwargs)
    theirs.load_data()
    ours = CifarLoader(**kwargs).initialize()
    assert ours.normalization_type == theirs.normalization_type == \
        "mean_disp"
    _bytes_equal(ours.original_data, theirs.original_data.mem)
    _bytes_equal(ours.original_labels, theirs.original_labels.mem)
    assert ours.class_lengths == list(theirs.class_lengths)


def _write_cifar(directory, per_batch=4):
    """Five training pickles and a test pickle in the CIFAR-10 python
    layout (uint8 rows of 3x32x32 channel planes, integer labels)."""
    rng = numpy.random.RandomState(12)
    names = ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]
    for name in names:
        batch = {b"data": rng.randint(0, 256, (per_batch, 3072)).astype(
            numpy.uint8), b"labels": list(rng.randint(0, 10, per_batch))}
        with open(os.path.join(str(directory), name), "wb") as f:
            pickle.dump(batch, f)
    return names


def test_cifar_pickles_read_channels_last(tmp_path):
    """The reader turns each row's three 32x32 planes into NHWC."""
    _write_cifar(tmp_path)
    loader = CifarLoader(directory=str(tmp_path),
                         normalization_type="none").initialize()
    with open(os.path.join(str(tmp_path), "test_batch"), "rb") as f:
        raw = pickle.load(f, encoding="bytes")
    first = raw[b"data"][0]
    numpy.testing.assert_array_equal(
        loader.original_data[0, 3, 5].numpy(),
        [first[0 * 1024 + 3 * 32 + 5], first[1 * 1024 + 3 * 32 + 5],
         first[2 * 1024 + 3 * 32 + 5]])
    assert loader.class_lengths == [0, 4, 20]


def test_autoencoder_loader_targets_are_the_normalized_data():
    provider = datasets.golden_digits(20, 6, seed=8)
    theirs = jax_mnist_ae.AutoencoderLoader(DummyWorkflow(),
                                            provider=provider)
    theirs.load_data()
    ours = AutoencoderLoader(provider=provider).initialize()
    _bytes_equal(ours.original_data, theirs.original_data.mem)
    _bytes_equal(ours.original_targets, theirs.original_targets.mem)
    assert ours.class_lengths == list(theirs.class_lengths) == [0, 6, 20]
    assert ours.original_targets.data_ptr() != \
        ours.original_data.data_ptr()
    # targets gathered beside the data, a padded slot a zero row
    ours.stage("cpu")
    rows, targets, valid = ours.gather(torch.tensor([3, -1, 0]))
    numpy.testing.assert_array_equal(targets.numpy(), rows.numpy())
    assert not bool(targets[1].any()) and valid.tolist() == [
        True, False, True]


def _write_idx(path, array, gz):
    header = struct.pack(">I", 0x0800 | array.ndim) + b"".join(
        struct.pack(">I", d) for d in array.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(header + array.astype(numpy.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_read_idx_and_the_idx_provider_match_jax(gz, tmp_path):
    rng = numpy.random.RandomState(1)
    arrays = {"train-images-idx3-ubyte": rng.randint(0, 256, (6, 28, 28)),
              "train-labels-idx1-ubyte": rng.randint(0, 10, 6),
              "t10k-images-idx3-ubyte": rng.randint(0, 256, (3, 28, 28)),
              "t10k-labels-idx1-ubyte": rng.randint(0, 10, 3)}
    for stem, array in arrays.items():
        path = str(tmp_path / (stem + (".gz" if gz else "")))
        _write_idx(path, array, gz)
        got = read_idx(path)
        assert got.dtype == numpy.uint8
        numpy.testing.assert_array_equal(got, array)
        numpy.testing.assert_array_equal(got, jax_mnist.read_idx(path))
    ours = mnist_idx_provider(str(tmp_path))()
    theirs = jax_mnist.mnist_idx_provider(str(tmp_path))()
    for a, b in zip(ours, theirs):
        numpy.testing.assert_array_equal(a, b)
    loader = MnistLoader(provider=mnist_idx_provider(str(tmp_path)))
    assert loader.initialize().class_lengths == [0, 3, 6]
    with pytest.raises(FileNotFoundError):
        mnist_idx_provider(str(tmp_path / "absent"))()


def test_datasets_and_normalization_import_no_jax():
    """The port's copies of the two jax-free modules stand alone."""
    code = ("import sys\n"
            "import veles_tpu_torch.datasets, veles_tpu_torch.normalization\n"
            "veles_tpu_torch.datasets.golden_digits(3, 1)()\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k.split('.')[0] == 'veles_tpu')\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
