"""The sample set beyond the BASELINE configs (``veles_tpu/models/
samples.py``): wine, lines, kanji and the sequence models.

The providers draw the JAX package's bytes from the same seeds:
:class:`WineProvider` (13-feature tabular, 3 classes),
:class:`LinesProvider` (oriented strokes, 4 classes, NHWC),
:class:`KanjiProvider` (100 classes of digit-glyph pairs, drawn with
``datasets._render``) and :class:`SequenceProvider` (needle-token
sequences: one position of a (seq, dim) noise block carries one of
``n_classes`` key patterns, the label says which).

Each sample function returns a :class:`Sample` -- its layer list, the
per-sample input shape, its loader and its training defaults (the
keyword arguments of ``models.build.build_training``) -- as the JAX
package's ``WineWorkflow``, ``LinesWorkflow``, ``KanjiWorkflow`` and
``SequenceWorkflow`` set them up. :func:`sequence` puts a ``moe``
layer between the two attention layers with ``moe=True``;
:func:`sequence_bench` gives ``scripts/bench_all.py``'s ``attention``
and ``moe`` configurations. A provider may be any callable returning
``(train_x, train_y, valid_x, valid_y)``; :func:`sequence` reads the
sample shape from its ``sample_shape``.

The workflow classes are the JAX package's, defined in its order
(``WineWorkflow``, ``KanjiWorkflow``, ``ChannelsWorkflow``,
``SequenceWorkflow``, ``LinesWorkflow``), so ``python -m veles_tpu_torch``
on this file trains the class the JAX CLI picks on the JAX file
(``WineWorkflow``): each a ``StandardWorkflow`` of the layers above over
a :class:`~veles_tpu_torch.loader.fullbatch.TabularLoader` of its
provider (the default one when none is given), with the training
defaults above unless the keywords say otherwise.

The ``channels`` sample reads image trees from disk:
:func:`generate_channels_dataset` renders synthetic TV-channel logos
into per-channel directories (Pillow), the JAX package's bytes from the
same seed, and :class:`ChannelsWorkflow` trains on them through
:class:`~veles_tpu_torch.loader.image.FileImageLoader`.
"""

import collections

import numpy

from veles_tpu_torch.loader.fullbatch import TabularLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow

#: what a sample function returns
Sample = collections.namedtuple("Sample",
                                "layers sample_shape loader training")


class WineProvider(object):
    """Tabular 13-feature, 3-class mixture dataset (UCI wine's shape):
    class-conditional Gaussians with overlapping covariance."""

    def __init__(self, n_train=400, n_valid=100, seed=11):
        self.n_train = n_train
        self.n_valid = n_valid
        self.seed = seed

    def __call__(self):
        rng = numpy.random.RandomState(self.seed)
        total = self.n_train + self.n_valid
        labels = rng.randint(0, 3, total).astype(numpy.int32)
        centers = rng.randn(3, 13).astype(numpy.float32) * 1.5
        mix = rng.randn(13, 13).astype(numpy.float32) * 0.4
        data = centers[labels] + rng.randn(total, 13).astype(
            numpy.float32) @ mix
        return (data[:self.n_train], labels[:self.n_train],
                data[self.n_train:], labels[self.n_train:])


class LinesProvider(object):
    """Oriented-stroke images, 4 classes (horizontal, vertical and the
    two diagonals), NHWC with one channel."""

    def __init__(self, n_train=800, n_valid=200, side=16, seed=5):
        self.n_train = n_train
        self.n_valid = n_valid
        self.side = side
        self.seed = seed

    def _draw(self, rng, klass):
        side = self.side
        img = rng.rand(side, side).astype(numpy.float32) * 0.25
        c = rng.randint(side // 4, 3 * side // 4)
        span = numpy.arange(side)
        if klass == 0:                      # horizontal
            img[c, :] += 1.0
        elif klass == 1:                    # vertical
            img[:, c] += 1.0
        elif klass == 2:                    # main diagonal
            off = rng.randint(-side // 4, side // 4)
            idx = numpy.clip(span + off, 0, side - 1)
            img[span, idx] += 1.0
        else:                               # anti-diagonal
            off = rng.randint(-side // 4, side // 4)
            idx = numpy.clip(side - 1 - span + off, 0, side - 1)
            img[span, idx] += 1.0
        return numpy.clip(img, 0.0, 1.0)

    def __call__(self):
        rng = numpy.random.RandomState(self.seed)
        total = self.n_train + self.n_valid
        labels = rng.randint(0, 4, total).astype(numpy.int32)
        data = numpy.stack([self._draw(rng, int(k)) for k in labels])
        data = data[..., None]  # NHWC
        return (data[:self.n_train], labels[:self.n_train],
                data[self.n_train:], labels[self.n_train:])


class KanjiProvider(object):
    """100 classes: each an ordered pair of digit glyphs side by side,
    warped per sample by the golden-digit renderer, (24, 48) images."""

    def __init__(self, n_train=4000, n_valid=800, seed=17):
        self.n_train = n_train
        self.n_valid = n_valid
        self.seed = seed

    def __call__(self):
        from veles_tpu_torch.datasets import _render
        rng = numpy.random.RandomState(self.seed)
        total = self.n_train + self.n_valid
        labels = rng.randint(0, 100, total).astype(numpy.int32)
        data = numpy.zeros((total, 24, 48), numpy.float32)
        for i, lbl in enumerate(labels):
            data[i, :, :24] = _render(int(lbl) // 10, rng, size=24)
            data[i, :, 24:] = _render(int(lbl) % 10, rng, size=24)
        return (data[:self.n_train], labels[:self.n_train],
                data[self.n_train:], labels[self.n_train:])


class SequenceProvider(object):
    """Needle-token sequence classification: (seq, dim) blocks of noise
    tokens with one position carrying one of ``n_classes`` patterns."""

    def __init__(self, n_train=1600, n_valid=320, seq=16, dim=16,
                 n_classes=8, seed=23):
        self.args = (n_train, n_valid, seq, dim, n_classes, seed)

    @property
    def sample_shape(self):
        return tuple(self.args[2:4])

    def __call__(self):
        n_train, n_valid, seq, dim, n_classes, seed = self.args
        rng = numpy.random.RandomState(seed)
        patterns = rng.randn(n_classes, dim).astype(numpy.float32) * 2.0

        def make(n):
            x = rng.randn(n, seq, dim).astype(numpy.float32) * 0.3
            y = rng.randint(0, n_classes, n).astype(numpy.int32)
            pos = rng.randint(0, seq, n)
            x[numpy.arange(n), pos] = patterns[y] + \
                rng.randn(n, dim).astype(numpy.float32) * 0.2
            return x, y

        tx, ty = make(n_train)
        vx, vy = make(n_valid)
        return tx, ty, vx, vy


#: ``WineWorkflow``: 13 -> 10 tanh -> 3 softmax
WINE_LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 10},
    {"type": "softmax", "output_sample_shape": 3},
]
WINE_TRAINING = {"learning_rate": 0.1, "loss": "softmax"}

#: ``LinesWorkflow``: a small conv net over 16x16 strokes
LINES_LAYERS = [
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "ky": 3},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_relu", "output_sample_shape": 32},
    {"type": "softmax", "output_sample_shape": 4},
]
LINES_TRAINING = {"learning_rate": 0.05, "loss": "softmax"}

#: ``KanjiWorkflow``: a conv net over glyph pairs, 100 classes, momentum
#: 0.9 with the rate scaled down
KANJI_LAYERS = [
    {"type": "conv_relu", "n_kernels": 16, "kx": 5, "ky": 5},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "conv_relu", "n_kernels": 32, "kx": 3, "ky": 3},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_relu", "output_sample_shape": 128},
    {"type": "softmax", "output_sample_shape": 100},
]
KANJI_TRAINING = {"learning_rate": 0.04, "momentum": 0.9,
                  "loss": "softmax"}

#: ``SequenceWorkflow``'s training defaults
SEQUENCE_TRAINING = {"learning_rate": 0.1, "loss": "softmax"}


def sequence_layers(heads=4, n_classes=8, moe=False, n_experts=4):
    """``SequenceWorkflow``'s layers: attention, (moe,) attention, both
    attention layers non-causal, then the softmax head."""
    layers = [{"type": "attention", "heads": heads, "causal": False}]
    if moe:
        layers.append({"type": "moe", "n_experts": n_experts})
    layers += [{"type": "attention", "heads": heads, "causal": False},
               {"type": "softmax", "output_sample_shape": n_classes}]
    return layers


def wine(provider=None):
    """``WineWorkflow``: batches of 50, ``mean_disp`` inputs."""
    return Sample(WINE_LAYERS, (13,), TabularLoader(
        provider=provider or WineProvider(), minibatch_size=50),
        dict(WINE_TRAINING))


def lines(provider=None):
    """``LinesWorkflow``: batches of 50, raw inputs."""
    provider = provider or LinesProvider()
    return Sample(LINES_LAYERS, (provider.side, provider.side, 1),
                  TabularLoader(provider=provider, minibatch_size=50,
                                normalization_type="none"),
                  dict(LINES_TRAINING))


def kanji(provider=None):
    """``KanjiWorkflow``: 20000 + 2000 samples by default, batches of
    100, raw inputs."""
    return Sample(KANJI_LAYERS, (24, 48, 1), TabularLoader(
        provider=provider or KanjiProvider(n_train=20000, n_valid=2000),
        minibatch_size=100, normalization_type="none"),
        dict(KANJI_TRAINING))


def sequence(provider=None, minibatch_size=80, heads=4, n_classes=8,
             moe=False, n_experts=4):
    provider = provider or SequenceProvider(n_classes=n_classes)
    return Sample(sequence_layers(heads, n_classes, moe, n_experts),
                  provider.sample_shape, TabularLoader(
                      provider=provider, minibatch_size=minibatch_size,
                      sequence=True, normalization_type="none"),
                  dict(SEQUENCE_TRAINING))


def sequence_bench_provider(moe=False):
    """The data of ``scripts/bench_all.py``'s ``attention`` ((256, 256)
    samples) or ``moe`` ((128, 256)) configuration: 4096 + 256."""
    return SequenceProvider(n_train=4096, n_valid=256,
                            seq=128 if moe else 256, dim=256)


def sequence_bench(moe=False, provider=None):
    """``scripts/bench_all.py``'s ``attention`` (2 attention layers of
    8 heads) or ``moe`` (attention, 8 experts, attention) configuration
    at batch 64, over ``provider`` (default
    :func:`sequence_bench_provider`'s)."""
    return sequence(provider or sequence_bench_provider(moe),
                    minibatch_size=64, heads=8, moe=moe, n_experts=8)


def _tabular(provider, minibatch_size, **kwargs):
    """A loader factory: a :class:`TabularLoader` of ``provider`` on the
    workflow it is called with."""
    return lambda wf: TabularLoader(workflow=wf, provider=provider,
                                    minibatch_size=minibatch_size, **kwargs)


def _with_defaults(kwargs, training):
    for key, value in training.items():
        kwargs.setdefault(key, value)
    return kwargs


class WineWorkflow(StandardWorkflow):
    """13 -> 10 tanh -> 3 softmax over ``mean_disp`` inputs, batches of
    50."""

    hide_from_registry = True

    def __init__(self, workflow=None, provider=None, minibatch_size=50,
                 **kwargs):
        super(WineWorkflow, self).__init__(
            workflow, loader=_tabular(provider or WineProvider(),
                                      minibatch_size),
            layers=WINE_LAYERS, **_with_defaults(kwargs, WINE_TRAINING))


class KanjiWorkflow(StandardWorkflow):
    """The conv net over glyph pairs, 100 classes, raw inputs, batches of
    100; 20000 + 2000 samples by default."""

    hide_from_registry = True

    def __init__(self, workflow=None, provider=None, minibatch_size=100,
                 **kwargs):
        provider = provider or KanjiProvider(n_train=20000, n_valid=2000)
        super(KanjiWorkflow, self).__init__(
            workflow, loader=_tabular(provider, minibatch_size,
                                      normalization_type="none"),
            layers=KANJI_LAYERS, **_with_defaults(kwargs, KANJI_TRAINING))


def generate_channels_dataset(directory, n_channels=6, per_class=30,
                              side=32, seed=21):
    """Render synthetic TV-channel logos into ``<directory>/{train,
    validation}/<channel-name>/*.png``: a geometric emblem a channel
    (bars, disc, frame, checker, stripes, cross) with position jitter and
    background noise. Returns the (train_paths, validation_paths) roots
    for :class:`~veles_tpu_torch.loader.image.FileImageLoader`."""
    import os

    from PIL import Image

    rng = numpy.random.RandomState(seed)
    names = ["channel%02d" % i for i in range(n_channels)]

    def emblem(klass, jitter):
        img = (rng.rand(side, side, 3) * 60).astype(numpy.uint8)
        yy, xx = numpy.mgrid[0:side, 0:side]
        cy, cx = side // 2 + jitter[0], side // 2 + jitter[1]
        color = numpy.zeros(3, numpy.uint8)
        color[klass % 3] = 230
        color[(klass + 1) % 3] = 120 if klass >= 3 else 0
        kind = klass % 6
        edge = numpy.minimum.reduce([yy, xx, side - 1 - yy, side - 1 - xx])
        if kind == 0:
            mask = (xx // 4) % 2 == 0
        elif kind == 1:
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < (side // 3) ** 2
        elif kind == 2:
            border = side // 5
            mask = (edge > border) & (edge < 2 * border)
        elif kind == 3:
            mask = ((yy // 4) + (xx // 4)) % 2 == 0
        elif kind == 4:
            mask = (yy // 4) % 2 == 0
        else:
            mask = (abs(yy - cy) < 3) | (abs(xx - cx) < 3)
        img[mask] = color
        return img

    splits = {"train": per_class, "validation": max(per_class // 4, 2)}
    for split, count in splits.items():
        for klass, name in enumerate(names):
            d = os.path.join(directory, split, name)
            os.makedirs(d, exist_ok=True)
            for i in range(count):
                jitter = rng.randint(-3, 4, size=2)
                Image.fromarray(emblem(klass, jitter)).save(
                    os.path.join(d, "frame%03d.png" % i))
    return ([os.path.join(directory, "train")],
            [os.path.join(directory, "validation")])


#: ``ChannelsWorkflow``'s conv net over 32x32 logos
CHANNELS_LAYERS = [
    {"type": "conv_relu", "n_kernels": 12, "kx": 5, "ky": 5},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "conv_relu", "n_kernels": 24, "kx": 3, "ky": 3},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_relu", "output_sample_shape": 64},
]


class ChannelsWorkflow(StandardWorkflow):
    """The ``channels`` sample: a conv net over channel-logo directory
    trees, loaded by :class:`~veles_tpu_torch.loader.image.
    FileImageLoader` (scan, decode, resize, ``linear`` normalization;
    labels from directory names)."""

    hide_from_registry = True

    def __init__(self, workflow=None, train_paths=(),
                 validation_paths=(), n_classes=6, minibatch_size=30,
                 size=(32, 32), **kwargs):
        from veles_tpu_torch.loader.image import FileImageLoader
        kwargs.setdefault("learning_rate", 0.05)
        kwargs.setdefault("loss", "softmax")
        loader_kwargs = {
            "train_paths": tuple(train_paths),
            "validation_paths": tuple(validation_paths),
            "size": size, "minibatch_size": minibatch_size,
            "normalization_type": "linear"}
        super(ChannelsWorkflow, self).__init__(
            workflow,
            loader=lambda w: FileImageLoader(workflow=w, **loader_kwargs),
            layers=CHANNELS_LAYERS + [
                {"type": "softmax", "output_sample_shape": n_classes}],
            **kwargs)


class SequenceWorkflow(StandardWorkflow):
    """The attention stack over token sequences (:func:`sequence_layers`:
    ``heads`` heads, a ``moe`` layer of ``n_experts`` between the two
    attention layers with ``moe=True``, ``n_classes`` classes), raw
    (seq, dim) inputs, batches of 80."""

    hide_from_registry = True

    def __init__(self, workflow=None, provider=None, minibatch_size=80,
                 heads=4, n_classes=8, moe=False, n_experts=4, **kwargs):
        provider = provider or SequenceProvider(n_classes=n_classes)
        super(SequenceWorkflow, self).__init__(
            workflow, loader=_tabular(provider, minibatch_size,
                                      sequence=True,
                                      normalization_type="none"),
            layers=sequence_layers(heads, n_classes, moe, n_experts),
            **_with_defaults(kwargs, SEQUENCE_TRAINING))


class LinesWorkflow(StandardWorkflow):
    """The small conv net over oriented strokes, raw inputs, batches of
    50."""

    hide_from_registry = True

    def __init__(self, workflow=None, provider=None, minibatch_size=50,
                 **kwargs):
        super(LinesWorkflow, self).__init__(
            workflow, loader=_tabular(provider or LinesProvider(),
                                      minibatch_size,
                                      normalization_type="none"),
            layers=LINES_LAYERS, **_with_defaults(kwargs, LINES_TRAINING))
