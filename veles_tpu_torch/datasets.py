"""Deterministic procedural datasets (``veles_tpu/datasets.py``).

A copy of the JAX package's module, which imports no JAX, so the same
seed gives the same bytes in both packages:

* :class:`golden_digits` -- MNIST-shaped handwritten-digit analog,
  28x28 float32 images in [0, 1] and int32 labels 0-9, each sample an
  upscaled 5x7 glyph under a random affine warp, stroke-thickness
  variants, noise and speckle;
* :class:`golden_objects` -- CIFAR-shaped analog, 32x32x3 procedural
  shapes of 10 classes on random backgrounds, hues random per sample.

Both are providers: calling one yields ``(train_x, train_y, valid_x,
valid_y)`` (the contract of ``loader.fullbatch.ProviderLoader``), cached
after the first call. :func:`_render` uses ``scipy.ndimage`` (imported
when a digit is drawn), as the JAX package's does: its zoom, filter and
affine warp are what the bytes are made of.
"""

import numpy

#: 5×7 glyph bitmaps (one string row per scanline, '#' = ink)
_GLYPHS = {
    0: ["#####", "#...#", "#...#", "#...#", "#...#", "#...#", "#####"],
    1: ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."],
    2: ["#####", "....#", "....#", "#####", "#....", "#....", "#####"],
    3: ["#####", "....#", "....#", ".####", "....#", "....#", "#####"],
    4: ["#...#", "#...#", "#...#", "#####", "....#", "....#", "....#"],
    5: ["#####", "#....", "#....", "#####", "....#", "....#", "#####"],
    6: ["#####", "#....", "#....", "#####", "#...#", "#...#", "#####"],
    7: ["#####", "....#", "...#.", "..#..", "..#..", ".#...", ".#..."],
    8: ["#####", "#...#", "#...#", "#####", "#...#", "#...#", "#####"],
    9: ["#####", "#...#", "#...#", "#####", "....#", "....#", "#####"],
}


def _base_glyph(digit):
    rows = _GLYPHS[digit]
    img = numpy.array([[1.0 if c == "#" else 0.0 for c in row]
                       for row in rows], numpy.float32)
    return img


def _render(digit, rng, size=28):
    """One sample: upscaled glyph -> random affine -> noise."""
    from scipy import ndimage
    glyph = _base_glyph(digit)
    # stroke-thickness variant: optional dilation of the 5x7 mask
    if rng.rand() < 0.4:
        glyph = ndimage.grey_dilation(glyph, size=(1, 2))
    # upscale to ~20x14 with smoothing (soft strokes)
    scale_y = (14.0 + rng.uniform(-2, 3)) / glyph.shape[0]
    scale_x = (10.0 + rng.uniform(-2, 3)) / glyph.shape[1]
    big = ndimage.zoom(glyph, (scale_y, scale_x), order=1)
    big = ndimage.gaussian_filter(big, rng.uniform(0.4, 0.9))
    # paste centered on the canvas
    canvas = numpy.zeros((size, size), numpy.float32)
    oy = (size - big.shape[0]) // 2
    ox = (size - big.shape[1]) // 2
    canvas[oy:oy + big.shape[0], ox:ox + big.shape[1]] = big
    # random affine about the center: rotation, shear, translation
    theta = rng.uniform(-0.30, 0.30)          # ±17°
    shear = rng.uniform(-0.25, 0.25)
    c, s = numpy.cos(theta), numpy.sin(theta)
    mat = numpy.array([[c, -s + shear], [s, c]], numpy.float32)
    center = numpy.array([size / 2, size / 2])
    offset = center - mat @ center + rng.uniform(-2.5, 2.5, size=2)
    warped = ndimage.affine_transform(canvas, mat, offset=offset,
                                      order=1, mode="constant")
    # amplitude jitter + additive noise + salt speckle
    warped *= rng.uniform(0.7, 1.0)
    warped += rng.normal(0.0, 0.08, warped.shape).astype(numpy.float32)
    n_speckle = rng.randint(0, 6)
    if n_speckle:
        ys = rng.randint(0, size, n_speckle)
        xs = rng.randint(0, size, n_speckle)
        warped[ys, xs] = rng.uniform(0.5, 1.0, n_speckle)
    return numpy.clip(warped, 0.0, 1.0).astype(numpy.float32)


class golden_digits(object):
    """MNIST-shaped provider: calling it yields ``(train_x, train_y,
    valid_x, valid_y)``, deterministic from ``seed``, rendered once and
    cached (~0.4 ms a sample of scipy warps)."""

    def __init__(self, n_train=12000, n_valid=2000, seed=2026, size=28):
        self.n_train = n_train
        self.n_valid = n_valid
        self.seed = seed
        self.size = size
        self._cache_ = None

    def __call__(self):
        if self._cache_ is None:
            rng = numpy.random.RandomState(self.seed)
            total = self.n_train + self.n_valid
            labels = rng.randint(0, 10, total).astype(numpy.int32)
            images = numpy.stack([_render(int(lbl), rng, self.size)
                                  for lbl in labels])
            self._cache_ = (images[:self.n_train],
                            labels[:self.n_train],
                            images[self.n_train:],
                            labels[self.n_train:])
        return self._cache_

    def __getstate__(self):
        # the cache regenerates deterministically: never pickle it
        state = dict(self.__dict__)
        state["_cache_"] = None
        return state


def _render_object(klass, rng, size=32):
    """One 32x32x3 'golden objects' sample: a procedural SHAPE on a
    random background. Hues are random PER SAMPLE (never per class), so
    color carries no class signal — the classifier must read shape,
    which is what keeps the analog non-trivial for a convnet and
    hopeless for color-histogram shortcuts."""
    yy, xx = numpy.mgrid[0:size, 0:size].astype(numpy.float32)
    cy = size / 2 + rng.uniform(-4, 4)
    cx = size / 2 + rng.uniform(-4, 4)
    r = rng.uniform(6, 10)
    dy, dx = yy - cy, xx - cx
    theta = rng.uniform(0, numpy.pi)
    ry = dy * numpy.cos(theta) - dx * numpy.sin(theta)
    rx = dy * numpy.sin(theta) + dx * numpy.cos(theta)
    if klass == 0:      # disc
        mask = (dy ** 2 + dx ** 2) < r ** 2
    elif klass == 1:    # filled square (rotated)
        mask = numpy.maximum(abs(ry), abs(rx)) < r * 0.8
    elif klass == 2:    # triangle
        mask = (ry > -r * 0.6) & (abs(rx) < (r * 0.8 - ry) * 0.6)
    elif klass == 3:    # ring
        d2 = dy ** 2 + dx ** 2
        mask = (d2 < r ** 2) & (d2 > (r * 0.55) ** 2)
    elif klass == 4:    # cross
        mask = ((abs(ry) < r * 0.3) | (abs(rx) < r * 0.3)) & \
            (numpy.maximum(abs(ry), abs(rx)) < r)
    elif klass == 5:    # stripes along the rotated axis
        mask = (numpy.sin(ry * numpy.pi / rng.uniform(2.5, 4.0)) > 0) & \
            ((dy ** 2 + dx ** 2) < (r * 1.3) ** 2)
    elif klass == 6:    # checkerboard patch
        mask = ((numpy.sin(ry * 1.1) > 0) ^ (numpy.sin(rx * 1.1) > 0)) & \
            (numpy.maximum(abs(ry), abs(rx)) < r)
    elif klass == 7:    # two discs
        off = r * 0.75
        mask = ((dy - off) ** 2 + (dx) ** 2 < (r * 0.55) ** 2) | \
            ((dy + off) ** 2 + (dx) ** 2 < (r * 0.55) ** 2)
    elif klass == 8:    # hollow square frame
        m = numpy.maximum(abs(ry), abs(rx))
        mask = (m < r * 0.9) & (m > r * 0.5)
    else:               # crescent: disc minus shifted disc
        d2 = dy ** 2 + dx ** 2
        mask = (d2 < r ** 2) & \
            ((dy - r * 0.5) ** 2 + (dx - r * 0.3) ** 2 > (r * 0.85) ** 2)
    fg = rng.uniform(0.2, 1.0, 3).astype(numpy.float32)
    bg = rng.uniform(0.0, 0.8, 3).astype(numpy.float32)
    # guarantee some figure/ground contrast or the shape can vanish
    while float(numpy.abs(fg - bg).max()) < 0.3:
        fg = rng.uniform(0.2, 1.0, 3).astype(numpy.float32)
        bg = rng.uniform(0.0, 0.8, 3).astype(numpy.float32)
    img = numpy.where(mask[..., None], fg, bg).astype(numpy.float32)
    # distractor bar (never class-informative: same for all classes)
    if rng.rand() < 0.5:
        y0 = rng.randint(0, size - 3)
        img[y0:y0 + 2, :, :] = rng.uniform(0, 1, 3)
    img += rng.normal(0, 0.18, img.shape).astype(numpy.float32)
    return numpy.clip(img, 0.0, 1.0)


class golden_objects(object):
    """CIFAR-shaped provider: 10 procedural shape classes at 32x32x3,
    deterministic from ``seed``; the contract and the cache of
    :class:`golden_digits`."""

    def __init__(self, n_train=10000, n_valid=2000, seed=2027, size=32):
        self.n_train = n_train
        self.n_valid = n_valid
        self.seed = seed
        self.size = size
        self._cache_ = None

    def __call__(self):
        if self._cache_ is None:
            rng = numpy.random.RandomState(self.seed)
            total = self.n_train + self.n_valid
            labels = rng.randint(0, 10, total).astype(numpy.int32)
            images = numpy.stack([_render_object(int(lbl), rng, self.size)
                                  for lbl in labels])
            self._cache_ = (images[:self.n_train],
                            labels[:self.n_train],
                            images[self.n_train:],
                            labels[self.n_train:])
        return self._cache_

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_cache_"] = None
        return state
