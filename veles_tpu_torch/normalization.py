"""Input normalizers of the full-batch loaders
(``veles_tpu/normalization.py``).

A copy of the JAX package's registry, which imports no JAX: each
normalizer has pickleable state, an ``analyze(train_data)`` pass and
``normalize``/``denormalize`` transforms, and registers under a string
key (a loader's ``normalization_type``). The arithmetic is numpy's, as
there, so the normalized bytes are the JAX package's.
"""

import numpy


class NormalizerRegistry(type):
    normalizers = {}

    def __init__(cls, name, bases, namespace):
        super(NormalizerRegistry, cls).__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping:
            NormalizerRegistry.normalizers[mapping] = cls

    @staticmethod
    def make(name, **kwargs):
        try:
            cls = NormalizerRegistry.normalizers[name]
        except KeyError:
            raise ValueError("unknown normalization %r (have %s)" %
                             (name, sorted(NormalizerRegistry.normalizers)))
        return cls(**kwargs)


class NormalizerBase(object, metaclass=NormalizerRegistry):
    MAPPING = None
    is_identity = False

    def __init__(self, **kwargs):
        self.state = {}

    def analyze(self, data):
        pass

    def normalize(self, data):
        raise NotImplementedError

    def denormalize(self, data):
        raise NotImplementedError

    def __getstate__(self):
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)


class NoneNormalizer(NormalizerBase):
    """Identity."""

    MAPPING = "none"
    is_identity = True

    def normalize(self, data):
        return data

    def denormalize(self, data):
        return data


class LinearNormalizer(NormalizerBase):
    """Scale to [interval.min, interval.max] from observed min/max."""

    MAPPING = "linear"

    def __init__(self, interval=(-1.0, 1.0), **kwargs):
        super(LinearNormalizer, self).__init__(**kwargs)
        self.interval = tuple(interval)

    def analyze(self, data):
        flat = data.reshape(len(data), -1)
        self.state["dmin"] = flat.min(axis=0)
        self.state["dmax"] = flat.max(axis=0)

    def _coeffs(self):
        dmin, dmax = self.state["dmin"], self.state["dmax"]
        span = numpy.where(dmax > dmin, dmax - dmin, 1.0)
        lo, hi = self.interval
        return dmin, span, lo, hi

    def normalize(self, data):
        shape = data.shape
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        dmin, span, lo, hi = self._coeffs()
        return (lo + (flat - dmin) / span * (hi - lo)).reshape(shape)

    def denormalize(self, data):
        shape = data.shape
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        dmin, span, lo, hi = self._coeffs()
        return ((flat - lo) / (hi - lo) * span + dmin).reshape(shape)


class MeanDispersionNormalizer(NormalizerBase):
    """(x - mean) / (max - min) per feature (``normalization.py:284``)."""

    MAPPING = "mean_disp"

    def analyze(self, data):
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        self.state["mean"] = flat.mean(axis=0)
        spread = flat.max(axis=0) - flat.min(axis=0)
        self.state["rdisp"] = numpy.where(
            spread > 0, 1.0 / numpy.maximum(spread, 1e-12), 1.0
        ).astype(numpy.float32)

    def normalize(self, data):
        shape = data.shape
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        return ((flat - self.state["mean"]) * self.state["rdisp"]
                ).reshape(shape)

    def denormalize(self, data):
        shape = data.shape
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        return (flat / self.state["rdisp"] + self.state["mean"]
                ).reshape(shape)


class ExternalMeanNormalizer(NormalizerBase):
    """Subtract an externally supplied mean array (file or ndarray)."""

    MAPPING = "external_mean"

    def __init__(self, mean_source=None, scale=1.0, **kwargs):
        super(ExternalMeanNormalizer, self).__init__(**kwargs)
        if isinstance(mean_source, str):
            mean_source = numpy.load(mean_source)
        if mean_source is None:
            raise ValueError("external_mean needs mean_source")
        self.mean = numpy.asarray(mean_source, numpy.float32)
        self.scale = scale

    def normalize(self, data):
        return (data.astype(numpy.float32) - self.mean) * self.scale

    def denormalize(self, data):
        return data / self.scale + self.mean


class RangeLinearNormalizer(NormalizerBase):
    """Fixed a-priori range scale (e.g. uint8 images: /127.5 - 1)."""

    MAPPING = "range_linear"

    def __init__(self, source_range=(0.0, 255.0), target_range=(-1.0, 1.0),
                 **kwargs):
        super(RangeLinearNormalizer, self).__init__(**kwargs)
        self.source_range = tuple(source_range)
        self.target_range = tuple(target_range)

    def normalize(self, data):
        s0, s1 = self.source_range
        t0, t1 = self.target_range
        return ((data.astype(numpy.float32) - s0) / (s1 - s0) *
                (t1 - t0) + t0)

    def denormalize(self, data):
        s0, s1 = self.source_range
        t0, t1 = self.target_range
        return (data - t0) / (t1 - t0) * (s1 - s0) + s0


class ExpNormalizer(NormalizerBase):
    """sigmoid-ish exponential squashing (``normalization.py`` exp)."""

    MAPPING = "exp"

    def normalize(self, data):
        return 1.0 / (1.0 + numpy.exp(-data.astype(numpy.float32))) * 2 - 1

    def denormalize(self, data):
        p = (data + 1.0) / 2.0
        p = numpy.clip(p, 1e-7, 1 - 1e-7)
        return numpy.log(p / (1 - p))


class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map learned from data (``pointwise``)."""

    MAPPING = "pointwise"

    def analyze(self, data):
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        dmin, dmax = flat.min(axis=0), flat.max(axis=0)
        span = numpy.where(dmax > dmin, dmax - dmin, 1.0)
        self.state["mul"] = (2.0 / span).astype(numpy.float32)
        self.state["add"] = (-1.0 - dmin * 2.0 / span).astype(numpy.float32)

    def normalize(self, data):
        shape = data.shape
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        return (flat * self.state["mul"] + self.state["add"]).reshape(shape)

    def denormalize(self, data):
        shape = data.shape
        flat = data.reshape(len(data), -1).astype(numpy.float32)
        return ((flat - self.state["add"]) / self.state["mul"]
                ).reshape(shape)
