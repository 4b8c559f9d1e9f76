"""Inputs made from the seed: images, labels, request order and arrivals.

Image ``j`` of a run is the ``size``-row window starting at row ``j`` of
one noise buffer of ``n + size - 1`` rows of ``size x 3`` bytes, so that
``n`` distinct images cost ``n`` rows of memory and a read is a view.  The
reference recomputes any image from ``(seed, j)`` without the program, and
:func:`identify` maps a delivered image back to its ``j``.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per ``(seed, stream)`` (any whole seed)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


class Images:
    """``n`` distinct uint8 ``[size, size, 3]`` images of one seed."""

    def __init__(self, seed: int, n: int, size: int):
        self.n, self.size = int(n), int(size)
        rows = self.n + self.size - 1
        self.buf = rng(seed, 0).integers(
            0, 256, (rows, self.size, 3), dtype=np.uint8)
        self._index = None

    def __getitem__(self, j: int) -> np.ndarray:
        j = int(j)
        if not 0 <= j < self.n:
            raise IndexError(f"image {j} outside [0, {self.n})")
        return self.buf[j:j + self.size]

    def batch(self, idx) -> np.ndarray:
        return np.stack([self[j] for j in idx])

    def identify(self, image: np.ndarray) -> int:
        """The ``j`` whose image equals ``image`` bit for bit, or -1."""
        if self._index is None:
            keys = self.buf[:self.n].reshape(self.n, -1)[:, :32]
            self._index = {k.tobytes(): j for j, k in enumerate(keys)}
        j = self._index.get(np.ascontiguousarray(image).reshape(-1)[
            :32].tobytes(), -1)
        if j >= 0 and not np.array_equal(self[j], image):
            return -1
        return j


class Reader:
    """A pipeline reader (``reader(path, rng) -> uint8 [S, S, 3]``) over
    :class:`Images`: the path is the image's index as text.  It ignores the
    augmentation generator, as the port's ``SyntheticReader`` does."""

    def __init__(self, images: Images):
        self.images = images
        self.crop = images.size

    def __call__(self, path, rng_=None) -> np.ndarray:
        return self.images[int(path)]


def labels(seed: int, n: int, n_known: int, negative_share: float
           ) -> np.ndarray:
    """int32 labels: ``-1`` (a negative, the entropic loss's uniform
    target) with probability ``negative_share``, else a known class drawn
    uniformly from ``[0, n_known)``."""
    g = rng(seed, 1)
    known = g.integers(0, n_known, n).astype(np.int32)
    return np.where(g.random(n) < negative_share, -1, known).astype(np.int32)


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Send times (seconds from the start) of a Poisson process at
    ``rate`` over ``seconds``: the gaps are drawn once from a fixed stream,
    so every seed offers the same gaps, the same count and the same span,
    and the seed only permutes them."""
    n = int(round(rate * seconds))
    gaps = rng(0, 2).exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()
    order = rng(seed, 2).permutation(n)
    return np.cumsum(gaps[order]) - gaps[order][0]
