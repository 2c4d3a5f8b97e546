"""Image loaders: directory trees decoded into the full batch
(``veles_tpu/loader/image.py``).

Images are decoded once at initialization (Pillow, imported when a
loader reads a file) into the loader's host dataset, which is staged on
the device or streamed from the host as the trainer plans. Augmentation
is materialized at load time by :class:`ImageAugmenter` from the port's
``prng`` streams, so a seed gives the JAX package's crops, flips and
rotations; scaling and rotation are the same ``scipy.ndimage`` calls.
"""

import os
import re

import numpy
import torch

from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.loader.file_scanner import LabeledFileScanner
from veles_tpu_torch.loader.fullbatch import FullBatchLoader, \
    FullBatchLoaderMSE

#: file extensions the image scanners accept
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif",
                    ".tiff", ".webp")


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            "image loaders need Pillow (PIL); it is not installed")
    return Image


def decode_image(path, size=None, color="RGB"):
    """One image file as a float32 HWC array in [0, 1], resized
    (bilinear) to ``size`` = (H, W) when given."""
    Image = _pil()
    with Image.open(path) as img:
        img = img.convert(color)
        if size is not None:
            img = img.resize((size[1], size[0]), Image.BILINEAR)
        arr = numpy.asarray(img, dtype=numpy.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class ImageAugmenter(object):
    """Load-time augmentation: every TRAIN image becomes
    ``len(rotations) x mirror factor x crop_number`` variants, the
    evaluation classes the deterministic centre variant.

    * ``scale``: a ratio (``scipy.ndimage.zoom``, order 1) or (h, w);
    * ``crop``: (h, w) ints or fractions of the scaled shape, random in
      TRAIN and centred otherwise; ``crop_number`` crops a variant;
    * ``mirror``: False, True (each variant also flipped) or
      ``"random"`` (each flips with p = 0.5);
    * ``rotations``: radians (``scipy.ndimage.rotate``, order 1).

    The draws come from the ``prng`` stream ``rand``."""

    def __init__(self, crop=None, crop_number=1, scale=1.0,
                 rotations=(0.0,), mirror=False, rand="loader"):
        if mirror not in (False, True, "random"):
            raise ValueError("mirror must be False, True or 'random'")
        self.crop = tuple(crop) if crop is not None else None
        self.crop_number = int(crop_number)
        self.scale = scale
        self.rotations = tuple(rotations)
        self.mirror = mirror
        self.rand_name = rand

    @classmethod
    def pop_from_kwargs(cls, kwargs):
        """From (and consuming) a loader's keyword arguments."""
        augmenter = kwargs.pop("augmenter", None)
        if augmenter is not None:
            return augmenter
        return cls(crop=kwargs.pop("crop", None),
                   crop_number=kwargs.pop("crop_number", 1),
                   scale=kwargs.pop("scale", 1.0),
                   rotations=kwargs.pop("rotations", (0.0,)),
                   mirror=kwargs.pop("mirror", False))

    def _rng(self):
        from veles_tpu_torch import prng
        return prng.get(self.rand_name)

    def _scaled(self, img):
        if self.scale == 1.0:
            return img
        from scipy import ndimage
        if isinstance(self.scale, tuple):
            zoom = (self.scale[0] / img.shape[0],
                    self.scale[1] / img.shape[1], 1.0)
        else:
            zoom = (self.scale, self.scale, 1.0)
        return ndimage.zoom(img, zoom, order=1).astype(numpy.float32)

    def _crop_shape(self, shape):
        if self.crop is None:
            return None
        cs = tuple(int(c if isinstance(c, int) else round(c * s))
                   for c, s in zip(self.crop, shape[:2]))
        if cs[0] > shape[0] or cs[1] > shape[1] or min(cs) < 1:
            raise ValueError("crop %s does not fit the scaled image shape "
                             "%s" % (cs, tuple(shape[:2])))
        return cs

    @staticmethod
    def _rotated(img, rot):
        if not rot:
            return img
        from scipy import ndimage
        return ndimage.rotate(img, rot * 180.0 / numpy.pi, order=1,
                              reshape=False, mode="constant",
                              cval=0.0).astype(numpy.float32)

    def _variant_params(self, shape, train):
        """``[(rot, flip, oy, ox)]`` of one image of (scaled) ``shape``,
        drawn apart from the pixel work so an input and its target share
        them."""
        cs = self._crop_shape(shape)
        if not train:
            if cs is None:
                return [(0.0, False, 0, 0)], cs
            return [(0.0, False, (shape[0] - cs[0]) // 2,
                     (shape[1] - cs[1]) // 2)], cs
        rng = self._rng()
        params = []
        for rot in self.rotations:
            if self.mirror is True:
                flips = (False, True)
            elif self.mirror == "random":
                flips = (bool(rng.randint(2)),)
            else:
                flips = (False,)
            for flip in flips:
                if cs is None:
                    params.append((rot, flip, 0, 0))
                    continue
                max_oy = shape[0] - cs[0]
                max_ox = shape[1] - cs[1]
                for _ in range(self.crop_number):
                    oy = rng.randint(max_oy + 1) if max_oy > 0 else 0
                    ox = rng.randint(max_ox + 1) if max_ox > 0 else 0
                    params.append((rot, flip, oy, ox))
        return params, cs

    def _apply_variant(self, img, rot, flip, oy, ox, cs):
        out = self._rotated(img, rot)
        if flip:
            out = out[:, ::-1]
        if cs is not None:
            out = out[oy:oy + cs[0], ox:ox + cs[1]]
        return numpy.ascontiguousarray(out)

    def expand(self, img, train):
        """One decoded image -> its list of variants."""
        img = self._scaled(img)
        params, cs = self._variant_params(img.shape, train)
        return [self._apply_variant(img, *p, cs) for p in params]

    def expand_pair(self, img, target, train):
        """An input and its target image with the same variants."""
        img = self._scaled(img)
        target = self._scaled(target)
        params, cs = self._variant_params(img.shape, train)
        return ([self._apply_variant(img, *p, cs) for p in params],
                [self._apply_variant(target, *p, cs) for p in params])


class ImageScanner(LabeledFileScanner):
    """The image extensions; labels from parent directory names."""

    def __init__(self, ignored_dirs=(), filename_re=None):
        super(ImageScanner, self).__init__(
            IMAGE_EXTENSIONS, ignored_dirs=ignored_dirs,
            filename_re=filename_re)


def _stacked(arrays):
    return torch.from_numpy(numpy.ascontiguousarray(
        numpy.stack(arrays).astype(numpy.float32)))


class FileImageLoader(FullBatchLoader):
    """Test, validation and train directory trees as a full batch;
    labels from directory names, numbered in sorted order
    (``labels_mapping``)."""

    def __init__(self, test_paths=(), validation_paths=(), train_paths=(),
                 size=None, color_space="RGB", filename_re=None,
                 ignored_dirs=(), **kwargs):
        self.augmenter = ImageAugmenter.pop_from_kwargs(kwargs)
        super(FileImageLoader, self).__init__(**kwargs)
        self.test_paths = tuple(test_paths)
        self.validation_paths = tuple(validation_paths)
        self.train_paths = tuple(train_paths)
        self.size = size
        self.color_space = color_space
        self.filename_re = filename_re
        self.ignored_dirs = ignored_dirs
        self.labels_mapping = {}

    def _scan_class(self, paths):
        scanner = ImageScanner(self.ignored_dirs, self.filename_re)
        pairs = []
        for base in paths:
            pairs.extend(scanner.scan(base))
        return pairs

    def load_dataset(self):
        per_class = [self._scan_class(p) for p in
                     (self.test_paths, self.validation_paths,
                      self.train_paths)]
        names = sorted({label for pairs in per_class for _, label in pairs})
        self.labels_mapping = {name: i for i, name in enumerate(names)}
        if not any(per_class):
            raise ValueError("%s found no images" % type(self).__name__)
        if self.size is None:
            first = next(p for pairs in per_class for p, _ in pairs)
            self.size = decode_image(first, color=self.color_space
                                     ).shape[:2]
        data, labels = [], []
        for klass, pairs in enumerate(per_class):
            count = 0
            for path, label in pairs:
                img = decode_image(path, self.size, self.color_space)
                for variant in self.augmenter.expand(
                        img, train=klass == TRAIN):
                    data.append(variant)
                    labels.append(self.labels_mapping[label])
                    count += 1
            self.class_lengths[klass] = count
        self.original_data = _stacked(data)
        self.original_labels = torch.from_numpy(
            numpy.asarray(labels, numpy.int32))

    @property
    def n_classes(self):
        return len(self.labels_mapping)


class AutoLabelFileImageLoader(FileImageLoader):
    """Labels from the file name's first ``label_regexp`` group; files
    that do not match are skipped."""

    def __init__(self, label_regexp, **kwargs):
        super(AutoLabelFileImageLoader, self).__init__(**kwargs)
        self.label_regexp = re.compile(label_regexp)

    def _scan_class(self, paths):
        pairs = super(AutoLabelFileImageLoader, self)._scan_class(paths)
        relabeled = []
        for path, _ in pairs:
            match = self.label_regexp.search(os.path.basename(path))
            if match is not None:
                relabeled.append((path, match.group(1)))
        return relabeled


class ImageLoaderMSE(FullBatchLoaderMSE):
    """Image-to-image regression: the targets are images too, matched to
    the inputs by index (``target_paths``), or the inputs themselves
    without them."""

    def __init__(self, test_paths=(), validation_paths=(), train_paths=(),
                 target_paths=(), size=None, color_space="RGB", **kwargs):
        self.augmenter = ImageAugmenter.pop_from_kwargs(kwargs)
        super(ImageLoaderMSE, self).__init__(**kwargs)
        self.test_paths = tuple(test_paths)
        self.validation_paths = tuple(validation_paths)
        self.train_paths = tuple(train_paths)
        self.target_paths = tuple(target_paths)
        self.size = size
        self.color_space = color_space

    def load_dataset(self):
        scanner = ImageScanner()
        target_pool = []
        for base in self.target_paths:
            target_pool.extend(scanner.scan(base))
        per_class = []
        for paths in (self.test_paths, self.validation_paths,
                      self.train_paths):
            pairs = []
            for base in paths:
                pairs.extend(scanner.scan(base))
            per_class.append(pairs)
        total = sum(len(pairs) for pairs in per_class)
        if target_pool and len(target_pool) != total:
            raise ValueError("%s: %d target images for %d inputs -- the "
                             "index pairing needs equal counts" % (
                                 type(self).__name__, len(target_pool),
                                 total))
        data, targets = [], []
        index = 0
        for klass, pairs in enumerate(per_class):
            if pairs and self.size is None:
                self.size = decode_image(
                    pairs[0][0], color=self.color_space).shape[:2]
            count = 0
            for path, _ in pairs:
                img = decode_image(path, self.size, self.color_space)
                tgt = decode_image(target_pool[index][0], self.size,
                                   self.color_space) if target_pool else img
                index += 1
                imgs, tgts = self.augmenter.expand_pair(
                    img, tgt, train=klass == TRAIN)
                data.extend(imgs)
                targets.extend(tgts)
                count += len(imgs)
            self.class_lengths[klass] = count
        self.original_data = _stacked(data)
        self.original_targets = _stacked(targets)
