"""The port's file-backed loaders against the JAX package's, on the CPU.

Each loader reads the same files in both packages and must give the
same bytes: the samples (float32), the labels (int32), the class
lengths and the label mapping. The files: an image tree rendered by
``generate_channels_dataset`` (both packages render the same PNG
bytes), pickles, HDF5 files, PCM WAVs of three widths. The augmenter
draws its crops, flips and rotations from the ``prng`` stream ``loader``
seeded alike on both sides. A minibatch recording written by either
package's ``MinibatchesSaver`` replays in the other's
``MinibatchesLoader``, and a dataset cache written by either is read by
the other. ``InputJoiner`` and ``MeanDispNormalizer`` are held to the
JAX units' outputs (float32, exactly: the same operations), and
``ChannelsWorkflow`` trains two fused epochs against the JAX workflow's
fused trainer (losses within 1e-5, parameters within 1e-6, the
tolerances of ``tests/test_torch_train.py``). The queue-fed loaders
(``QueueFedLoader``, ``InteractiveLoader``, ``SocketFedLoader``) take
the same feeds as the JAX package's and hold the same rows (exactly),
valid counts and classes; their EOF handling and the socket's acks are
the same.
"""

import os
import pickle

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyWorkflow  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402

pytest.importorskip("PIL")


def _seed(value=1):
    jax_prng.get("loader").seed(value)
    prng.get("loader").seed(value)


def _jax_loaded(cls, **kwargs):
    loader = cls(DummyWorkflow(), **kwargs)
    loader.initialize(device=Device(backend="cpu"))
    return loader


def _port_loaded(cls, **kwargs):
    return cls(**kwargs).initialize()


def _assert_same_dataset(port, jax_loader, truth="labels"):
    assert list(port.class_lengths) == list(jax_loader.class_lengths)
    got = port.original_data
    want = numpy.ascontiguousarray(jax_loader.original_data.map_read())
    assert str(got.dtype) == "torch." + str(want.dtype)
    assert tuple(got.shape) == want.shape
    numpy.testing.assert_array_equal(
        got.contiguous().view(torch.uint8).numpy(), want.view(numpy.uint8))
    mine = getattr(port, "original_" + truth)
    theirs = getattr(jax_loader, "original_" + truth).map_read()
    numpy.testing.assert_array_equal(mine.numpy(), numpy.asarray(theirs))


@pytest.fixture(scope="module")
def channels(tmp_path_factory):
    """A small channel-logo tree rendered by the JAX package."""
    from veles_tpu.models.samples import generate_channels_dataset
    base = tmp_path_factory.mktemp("channels")
    train, valid = generate_channels_dataset(str(base), n_channels=4,
                                             per_class=8, side=16)
    return base, train, valid


def test_channels_dataset_renders_the_jax_files(channels, tmp_path):
    from veles_tpu_torch.models.samples import generate_channels_dataset
    base, _, _ = channels
    generate_channels_dataset(str(tmp_path), n_channels=4, per_class=8,
                              side=16)
    theirs = sorted(os.path.relpath(os.path.join(d, f), base)
                    for d, _, fs in os.walk(base) for f in fs)
    mine = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                  for d, _, fs in os.walk(tmp_path) for f in fs)
    assert mine == theirs and len(mine) == 4 * (8 + 2)
    for rel in mine:
        with open(os.path.join(base, rel), "rb") as a, \
                open(os.path.join(tmp_path, rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("augment", [
    {}, {"mirror": True}, {"mirror": "random"},
    {"scale": 1.5, "crop": (16, 16), "crop_number": 2,
     "rotations": (0.0, 0.3)},
    {"crop": (0.75, 0.75), "size": (20, 20)},
], ids=["plain", "mirror", "random_mirror", "scale_crop_rotate",
        "fraction_crop"])
def test_file_image_loader_bytes(channels, augment):
    from veles_tpu.loader.image import FileImageLoader as JaxLoader
    from veles_tpu_torch.loader.image import FileImageLoader
    _, train, valid = channels
    kwargs = dict(train_paths=tuple(train), validation_paths=tuple(valid),
                  minibatch_size=8, **augment)
    _seed(7)
    want = _jax_loaded(JaxLoader, **kwargs)
    got = _port_loaded(FileImageLoader, **kwargs)
    _assert_same_dataset(got, want)
    assert got.labels_mapping == want.labels_mapping
    # the loader stream advanced alike (the shuffle that follows agrees)
    assert prng.get("loader").randint(1 << 30) == \
        jax_prng.get("loader").randint(1 << 30)


def test_auto_label_and_mse_image_loaders(channels):
    from veles_tpu.loader.image import AutoLabelFileImageLoader as JaxAuto
    from veles_tpu.loader.image import ImageLoaderMSE as JaxMSE
    from veles_tpu_torch.loader.image import (AutoLabelFileImageLoader,
                                              ImageLoaderMSE)
    _, train, valid = channels
    kwargs = dict(train_paths=tuple(train), minibatch_size=8,
                  label_regexp=r"frame00(\d)")
    _seed(3)
    want = _jax_loaded(JaxAuto, **kwargs)
    got = _port_loaded(AutoLabelFileImageLoader, **kwargs)
    _assert_same_dataset(got, want)
    assert got.labels_mapping == want.labels_mapping
    kwargs = dict(train_paths=tuple(train), validation_paths=tuple(valid),
                  crop=(12, 12), crop_number=2, mirror=True,
                  minibatch_size=8)
    _seed(9)
    want = _jax_loaded(JaxMSE, **kwargs)
    got = _port_loaded(ImageLoaderMSE, **kwargs)
    _assert_same_dataset(got, want, truth="targets")


def test_image_augmenter_draws_as_jax():
    from veles_tpu.loader.image import ImageAugmenter as JaxAugmenter
    from veles_tpu_torch.loader.image import ImageAugmenter
    img = numpy.random.RandomState(0).rand(24, 20, 3).astype(numpy.float32)
    kwargs = dict(crop=(0.5, 0.6), crop_number=3, scale=(30, 26),
                  rotations=(0.0, -0.4), mirror="random")
    _seed(42)
    want = JaxAugmenter(**kwargs).expand(img, train=True)
    got = ImageAugmenter(**kwargs).expand(img, train=True)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        numpy.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="does not fit"):
        ImageAugmenter(crop=(64, 64)).expand(img, train=False)


def _pickle(path, n, seed, labels=True):
    rng = numpy.random.RandomState(seed)
    data = rng.rand(n, 3, 4).astype(numpy.float64)
    with open(path, "wb") as f:
        pickle.dump((data, rng.randint(0, 5, n)) if labels else data, f)
    return str(path)


def test_pickles_loader_bytes(tmp_path):
    from veles_tpu.loader.pickles import PicklesLoader as JaxLoader
    from veles_tpu_torch.loader.pickles import PicklesLoader
    kwargs = dict(train_path=_pickle(tmp_path / "t.pickle", 20, 0),
                  validation_path=_pickle(tmp_path / "v.pickle", 6, 1),
                  test_path=_pickle(tmp_path / "x.pickle", 4, 2),
                  minibatch_size=5)
    _assert_same_dataset(_port_loaded(PicklesLoader, **kwargs),
                         _jax_loaded(JaxLoader, **kwargs))
    kwargs["validation_path"] = _pickle(tmp_path / "u.pickle", 6, 1,
                                        labels=False)
    with pytest.raises(ValueError, match="all or none"):
        _port_loaded(PicklesLoader, **kwargs)


def test_hdf5_loader_bytes(tmp_path):
    h5py = pytest.importorskip("h5py")
    from veles_tpu.loader.hdf5 import HDF5Loader as JaxLoader
    from veles_tpu_torch.loader.hdf5 import HDF5Loader
    rng = numpy.random.RandomState(0)
    paths = {}
    for key, n in (("train_path", 30), ("validation_path", 10)):
        path = str(tmp_path / (key + ".h5"))
        with h5py.File(path, "w") as f:
            f["data"] = rng.rand(n, 5, 2)
            f["labels"] = rng.randint(0, 3, n)
        paths[key] = path
    _assert_same_dataset(_port_loaded(HDF5Loader, minibatch_size=8, **paths),
                         _jax_loaded(JaxLoader, minibatch_size=8, **paths))


def test_sound_loader_bytes(tmp_path):
    from scipy.io import wavfile
    from veles_tpu.loader.sound import SndFileLoader as JaxLoader
    from veles_tpu_torch.loader.sound import SndFileLoader
    rate = 8000
    t = numpy.arange(1600) / rate
    files = (("train/beep/a.wav", 440, numpy.int16, False),
             ("train/beep/b.wav", 440, numpy.uint8, False),
             ("train/boop/c.wav", 220, numpy.int32, True),
             ("valid/boop/d.wav", 220, numpy.int16, False))
    for rel, freq, dtype, stereo in files:
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        wave = numpy.sin(2 * numpy.pi * freq * t)
        if dtype == numpy.uint8:
            pcm = ((wave * 120) + 128).astype(numpy.uint8)
        else:
            pcm = (wave * 0.9 * numpy.iinfo(dtype).max).astype(dtype)
        if stereo:
            pcm = numpy.stack([pcm, pcm // 2], axis=1)
        wavfile.write(str(path), rate, pcm)
    kwargs = dict(train_paths=(str(tmp_path / "train"),),
                  validation_paths=(str(tmp_path / "valid"),),
                  samples=1200, minibatch_size=2)
    got = _port_loaded(SndFileLoader, **kwargs)
    _assert_same_dataset(got, _jax_loaded(JaxLoader, **kwargs))
    assert got.sample_rate == rate and got.n_classes == 2


def _record(package, source_path, rec):
    """One epoch of a pickles loader recorded by ``package``'s saver."""
    if package == "jax":
        from veles_tpu.loader.pickles import PicklesLoader
        from veles_tpu.loader.saver import MinibatchesSaver
        wf = DummyWorkflow()
        source = PicklesLoader(wf, train_path=source_path,
                               minibatch_size=4, shuffle_limit=0)
        source.initialize(device=Device(backend="cpu"))
    else:
        from veles_tpu_torch.dummy import DummyWorkflow as PortWorkflow
        from veles_tpu_torch.loader.pickles import PicklesLoader
        from veles_tpu_torch.loader.saver import MinibatchesSaver
        wf = PortWorkflow()
        source = PicklesLoader(workflow=wf, train_path=source_path,
                               minibatch_size=4, shuffle_limit=0)
        source.initialize(device="cpu")
    saver = MinibatchesSaver(wf, file_name=rec)
    saver.link_attrs(source, "minibatch_data", "minibatch_labels",
                     "minibatch_size", "minibatch_class",
                     "last_minibatch", "epoch_ended", "class_lengths",
                     "max_minibatch_size")
    saver.initialize()
    for _ in range(3):
        source.run()
        saver.run()
    saver.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_minibatch_recordings_cross_both_ways(tmp_path, writer):
    from veles_tpu.loader.saver import MinibatchesLoader as JaxReplay
    from veles_tpu_torch.loader.saver import MinibatchesLoader
    source = _pickle(tmp_path / "train.pickle", 10, 3)
    rec = str(tmp_path / ("%s.vtpu" % writer))
    _seed(5)
    _record(writer, source, rec)
    with open(rec, "rb") as f:
        assert f.read(8) == b"VTPUMB1\x00"
    port = _port_loaded(MinibatchesLoader, file_name=rec, minibatch_size=4,
                        shuffle_limit=0)
    jax_replay = JaxReplay(DummyWorkflow(), file_name=rec, minibatch_size=4,
                           shuffle_limit=0)
    jax_replay.initialize(device=Device(backend="cpu"))
    assert port.class_lengths == jax_replay.class_lengths == [0, 0, 10]
    numpy.testing.assert_array_equal(port.original_data.numpy(),
                                     jax_replay._data_cache_)
    numpy.testing.assert_array_equal(port.original_labels.numpy(),
                                     jax_replay._labels_cache_)
    with open(source, "rb") as f:
        data, labels = pickle.load(f)
    # the served order: the first epoch is unshuffled (shuffle_limit 0)
    numpy.testing.assert_array_equal(port.original_data.numpy(),
                                     data.astype(numpy.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dataset_cache_crosses_both_ways(tmp_path, monkeypatch, writer,
                                         dtype):
    """A ``SyntheticImageLoader`` cache written by either package is read
    by the other: same directory, same hash, same bytes."""
    from veles_tpu.config import root as jax_root
    from veles_tpu.models.alexnet import \
        SyntheticImageLoader as JaxSynthetic
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader import dataset_cache
    from veles_tpu_torch.models.alexnet import SyntheticImageLoader
    monkeypatch.setitem(jax_root.common.dirs.__dict__, "cache",
                        str(tmp_path))
    monkeypatch.setitem(root.common.dirs.__dict__, "cache", str(tmp_path))
    monkeypatch.setenv("VELES_DATASET_CACHE", "rw")
    kwargs = dict(n_train=12, n_valid=4, side=9, n_classes=5,
                  dtype=dtype, minibatch_size=4)
    if writer == "jax":
        _jax_loaded(JaxSynthetic, **kwargs)
    else:
        _port_loaded(SyntheticImageLoader, **kwargs)
    (entry,) = os.listdir(tmp_path / "datasets")
    assert entry.startswith("synthetic-image-")

    def refuse():
        raise AssertionError("the cache was not read")
    monkeypatch.setattr(SyntheticImageLoader, "_generate",
                        lambda self: refuse())
    got = _port_loaded(SyntheticImageLoader, **kwargs)
    want = _jax_loaded(JaxSynthetic, **kwargs)
    _assert_same_dataset(got, want)
    assert dataset_cache.config_hash({"a": 1}) == \
        __import__("veles_tpu.loader.dataset_cache",
                   fromlist=["x"]).config_hash({"a": 1})


def test_input_joiner_and_mean_disp_normalizer_match_jax():
    from veles_tpu.input_joiner import InputJoiner as JaxJoiner
    from veles_tpu.mean_disp_normalizer import \
        MeanDispNormalizer as JaxNormalizer
    from veles_tpu.memory import Array
    from veles_tpu_torch.dummy import DummyWorkflow as PortWorkflow
    from veles_tpu_torch.input_joiner import InputJoiner
    from veles_tpu_torch.mean_disp_normalizer import MeanDispNormalizer
    rng = numpy.random.RandomState(0)
    inputs = [rng.rand(3, 4).astype(numpy.float32),
              rng.rand(3, 2, 2).astype(numpy.float32),
              rng.rand(3, 1).astype(numpy.float32)]
    jax_unit = JaxJoiner(DummyWorkflow(), num_inputs=3)
    unit = InputJoiner(PortWorkflow(), num_inputs=3)
    for i, x in enumerate(inputs):
        setattr(jax_unit, "input_%d" % i, Array(x))
        setattr(unit, "input_%d" % i, torch.from_numpy(x))
    jax_unit.initialize(device=Device(backend="cpu"))
    unit.initialize(device="cpu")
    assert tuple(unit.output.shape) == (3, 9)
    jax_unit.run()
    unit.run()
    numpy.testing.assert_array_equal(unit.output.numpy(),
                                     jax_unit.output.map_read())
    x = rng.rand(5, 3).astype(numpy.float32) * 10
    mean = x.mean(axis=0)
    rdisp = (1.0 / (x.max(axis=0) - x.min(axis=0))).astype(numpy.float32)
    jax_unit = JaxNormalizer(DummyWorkflow())
    unit = MeanDispNormalizer(PortWorkflow())
    jax_unit.input, jax_unit.mean, jax_unit.rdisp = (
        Array(x), Array(mean), Array(rdisp))
    unit.input, unit.mean, unit.rdisp = x, mean, rdisp
    jax_unit.initialize(device=Device(backend="cpu"))
    unit.initialize(device="cpu")
    jax_unit.run()
    unit.run()
    numpy.testing.assert_array_equal(unit.output.numpy(),
                                     jax_unit.output.map_read())


def test_channels_workflow_two_epochs_match_jax(channels):
    """Two fused epochs of ``ChannelsWorkflow`` on the rendered tree:
    the port's ``FusedRunner`` against the JAX ``FusedTrainer`` from the
    same initial weights (``-s`` alike on both sides)."""
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    from veles_tpu.models.samples import ChannelsWorkflow as JaxChannels
    from veles_tpu.train import FusedTrainer as JaxTrainer
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.samples import ChannelsWorkflow
    from veles_tpu_torch.train.runner import FusedRunner
    from test_torch_eager import _seed_both
    from test_torch_workflow import _jax_weights, _port_weights
    _, train, valid = channels
    kwargs = dict(train_paths=train, validation_paths=valid, n_classes=4,
                  minibatch_size=10, size=(16, 16), max_epochs=2)
    _seed_both()
    jax_wf = JaxChannels(JaxLauncher(), **kwargs)
    jax_wf.initialize(device=Device(backend="cpu"))
    port_wf = ChannelsWorkflow(DummyLauncher(), **kwargs)
    port_wf.initialize(device="cpu")
    for g, w in zip(_port_weights(port_wf), _jax_weights(jax_wf)):
        for k in w:
            numpy.testing.assert_array_equal(g[k], w[k])
    JaxTrainer(jax_wf).train()
    FusedRunner(port_wf).run()
    got = port_wf.decision.epoch_history
    want = jax_wf.decision.epoch_history
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for klass in ("validation", "train"):
            assert g[klass]["samples"] == w[klass]["samples"]
            assert abs(g[klass]["normalized"] - w[klass]["normalized"]) \
                <= 1e-5
    for g, w in zip(_port_weights(port_wf), _jax_weights(jax_wf)):
        for k in w:
            numpy.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)


# -- the queue-fed loaders (``tests/test_loaders.py``'s cases) ---------------


def _fed_pair(kind, **kwargs):
    """The JAX loader and the port's of ``kind`` (``interactive``,
    ``queue`` or ``socket``), each initialized on the CPU."""
    from veles_tpu.loader.interactive import (InteractiveLoader as JaxIL,
                                              QueueFedLoader as JaxQ)
    from veles_tpu.zmq_loader import SocketFedLoader as JaxS
    from veles_tpu_torch.dummy import DummyWorkflow as PortWorkflow
    from veles_tpu_torch.loader.interactive import (InteractiveLoader,
                                                    QueueFedLoader)
    from veles_tpu_torch.zmq_loader import SocketFedLoader
    jax_cls, port_cls = {"interactive": (JaxIL, InteractiveLoader),
                         "queue": (JaxQ, QueueFedLoader),
                         "socket": (JaxS, SocketFedLoader)}[kind]
    jax_wf, port_wf = DummyWorkflow(), PortWorkflow()
    jax_loader = jax_cls(jax_wf, **kwargs)
    jax_loader.initialize(device=None)
    port_loader = port_cls(workflow=port_wf, **kwargs)
    port_loader.initialize(device="cpu")
    return jax_loader, port_loader


def _same_fill(jax_loader, port_loader):
    """Both loaders hold the same minibatch: rows (float32, exactly),
    valid count and class."""
    got = port_loader.minibatch_data.numpy()
    want = numpy.asarray(jax_loader.minibatch_data.mem)
    assert got.dtype == want.dtype and got.shape == want.shape
    numpy.testing.assert_array_equal(got, want)
    assert port_loader.minibatch_size == jax_loader.minibatch_size
    assert port_loader.minibatch_class == jax_loader.minibatch_class
    return got


def test_interactive_loader_feeds():
    from veles_tpu_torch.loader.base import TEST
    jax_loader, port_loader = _fed_pair("interactive", sample_shape=(3,))
    for loader in (jax_loader, port_loader):
        loader.feed([1.0, 2.0, 3.0])
        loader.run()
    got = _same_fill(jax_loader, port_loader)
    assert numpy.allclose(got[0], [1, 2, 3])
    assert port_loader.minibatch_class == TEST


def test_queue_fed_loader_batches_queued_samples():
    """One fill drains what is queued (up to the cap), zeroes the rest
    and carries the valid count in ``minibatch_size``."""
    jax_loader, port_loader = _fed_pair("queue", sample_shape=(3,),
                                        minibatch_size=4)
    assert tuple(port_loader.minibatch_data.shape) == (4, 3)
    # dirty buffers make the zeroed rows meaningful
    jax_loader.minibatch_data.mem[...] = 7.0
    port_loader.minibatch_data.fill_(7.0)
    for loader in (jax_loader, port_loader):
        for i in range(3):
            loader.feed([float(i)] * 3)
        loader.run()
    got = _same_fill(jax_loader, port_loader)
    assert port_loader.minibatch_size == 3
    assert numpy.allclose(got[3], 0.0)


def test_queue_fed_loader_caps_at_minibatch_size():
    jax_loader, port_loader = _fed_pair("queue", sample_shape=(2,),
                                        minibatch_size=2)
    for loader in (jax_loader, port_loader):
        for i in range(5):
            loader.feed([float(i)] * 2)
    for first in (0.0, 2.0):
        for loader in (jax_loader, port_loader):
            loader.run()
        got = _same_fill(jax_loader, port_loader)
        assert port_loader.minibatch_size == 2
        assert numpy.allclose(got[0], first)
        assert numpy.allclose(got[1], first + 1.0)


def test_queue_fed_loader_eof_mid_drain_serves_batch_then_stops():
    """An EOF met while draining ends the stream after the batch
    collected so far is served: no fed sample is dropped."""
    jax_loader, port_loader = _fed_pair("queue", sample_shape=(2,),
                                        minibatch_size=4)
    for loader in (jax_loader, port_loader):
        loader.feed([1.0, 1.0])
        loader.feed([2.0, 2.0])
        loader.finish()
        loader.run()
    got = _same_fill(jax_loader, port_loader)
    assert port_loader.minibatch_size == 2
    assert numpy.allclose(got[1], 2.0)
    for loader in (jax_loader, port_loader):
        stopped = []
        loader.workflow.stop = lambda stopped=stopped: stopped.append(True)
        loader.run()  # the requeued EOF stops the workflow now
        assert stopped and loader.minibatch_size == 0


def _exchange(address, lines):
    """The replies of one producer connection to ``lines`` (bytes)."""
    import json as json_mod
    import socket
    replies = []
    with socket.create_connection(address, timeout=5) as sock:
        f = sock.makefile("rwb")
        for line in lines:
            f.write(line + b"\n")
            f.flush()
            replies.append(json_mod.loads(f.readline()))
    return replies


def test_socket_fed_loader():
    jax_loader, port_loader = _fed_pair("socket", sample_shape=(2,))
    try:
        acks = [_exchange(loader.address, [b'{"data": [4.0, 5.0]}'])
                for loader in (jax_loader, port_loader)]
        assert acks[0] == acks[1] == [{"ok": True}]
        for loader in (jax_loader, port_loader):
            loader.run()
        got = _same_fill(jax_loader, port_loader)
        assert numpy.allclose(got[0], [4, 5])
    finally:
        for loader in (jax_loader, port_loader):
            loader.stop_serving()


def test_socket_fed_loader_bad_items_get_error_replies():
    """A bad item gets an error ack and the connection survives; the
    acks are the JAX loader's; ``finish`` ends the stream."""
    jax_loader, port_loader = _fed_pair("socket", sample_shape=(2,))
    lines = [b'{"cmd": "ping"}', b'{"data": [[1], [2, 3]]}',
             b'not json at all', b'{"data": [1, 2, 3]}',
             b'{"data": [7.0, 8.0]}']
    try:
        acks = [_exchange(loader.address, lines)
                for loader in (jax_loader, port_loader)]
        assert acks[0] == acks[1]
        assert all("error" in reply for reply in acks[1][:4])
        assert acks[1][4] == {"ok": True}
        for loader in (jax_loader, port_loader):
            loader.run()
        got = _same_fill(jax_loader, port_loader)
        assert numpy.allclose(got[0], [7, 8])
        finishes = [_exchange(loader.address, [b'{"cmd": "finish"}'])
                    for loader in (jax_loader, port_loader)]
        assert finishes[0] == finishes[1] == [{"ok": True,
                                               "finished": True}]
        stopped = []
        port_loader.workflow.stop = lambda: stopped.append(True)
        port_loader.run()
        assert stopped and port_loader.minibatch_size == 0
    finally:
        for loader in (jax_loader, port_loader):
            loader.stop_serving()
