"""Host-side image decode + augmentation with torchvision-parity semantics.

Counterpart of :mod:`openset_imagenet_tpu.transforms`; the same pixels
for the same ``(seed, epoch, index)``.  The reference composes
torchvision transforms (reference ``train.py:259-268``):

* train: ``Resize(256) -> RandomCrop(224) -> RandomHorizontalFlip(0.5) -> ToTensor``
* eval:  ``Resize(256) -> CenterCrop(224) -> ToTensor``

with no mean/std normalization: pixels stay in ``[0, 1]``.  Everything
variable-shaped happens here on the host and yields fixed-shape ``uint8
[H, W, 3]`` arrays; the ``/255`` conversion happens on the device in the
train step.

Randomness is counter-based: each sample's crop/flip draws come from a
Philox stream keyed by ``(seed, epoch, sample_index)``, reproducible under
any worker-thread scheduling.  PIL is imported only inside the decode and
resize functions, so the numpy part runs where PIL is not installed.
"""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np


# -- decode + geometric ops ---------------------------------------------------

def decode_image(path_or_bytes):
    """Open a JPEG (path or raw bytes) as an RGB PIL image (reference
    ``dataset.py:46-48``)."""
    from PIL import Image

    if isinstance(path_or_bytes, (bytes, bytearray)):
        img = Image.open(io.BytesIO(path_or_bytes))
    else:
        img = Image.open(path_or_bytes)
    return img.convert("RGB")


def resized_geometry(w: int, h: int, size: int):
    """(rw, rh) after :func:`resize_shorter_side`: the shorter side becomes
    ``size`` and the long side truncates, as torchvision's ``Resize``."""
    if w <= h:
        return size, max(1, int(size * h / w))
    return max(1, int(size * w / h)), size


def resize_shorter_side(img, size: int = 256):
    """Aspect-preserving bilinear resize (antialiased, as PIL's resize
    always is) so the shorter side equals ``size``; no-op if it does."""
    from PIL import Image

    w, h = img.size
    if min(w, h) == size:
        return img
    return img.resize(resized_geometry(w, h, size), Image.BILINEAR)


def center_crop_offset(extent: int, size: int) -> int:
    """torchvision's center-crop offset ``int(round((extent-size)/2.0))``,
    with Python's half-to-even rounding."""
    d = max(0, int(extent) - int(size))
    k = d // 2
    if d % 2 and k % 2:  # x.5 rounds to the even neighbour
        k += 1
    return k


def center_crop(arr: np.ndarray, size: int = 224) -> np.ndarray:
    """Center crop of an ``[H, W, C]`` array (pads if smaller, like tv)."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        arr = _pad_to(arr, size)
        h, w = arr.shape[:2]
    top = center_crop_offset(h, size)
    left = center_crop_offset(w, size)
    return arr[top:top + size, left:left + size]


def random_crop(arr: np.ndarray, size: int, rng: np.random.Generator
                ) -> np.ndarray:
    """Uniform random crop (torchvision ``RandomCrop`` semantics)."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        arr = _pad_to(arr, size)
        h, w = arr.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return arr[top:top + size, left:left + size]


def _pad_to(arr: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad an image so both spatial dims are >= ``size``."""
    h, w = arr.shape[:2]
    ph, pw = max(0, size - h), max(0, size - w)
    if not (ph or pw):
        return arr
    return np.pad(arr, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2),
                        (0, 0)))


# -- whole-sample transforms --------------------------------------------------

def philox(seed: int, epoch: int, index: int, stream: int
           ) -> np.random.Generator:
    """Counter-based RNG keyed by (seed, epoch, index, stream), packed into
    numpy Philox's 2x64-bit key."""
    k0 = (np.uint64(seed & 0xFFFFFFFF) << np.uint64(32)) | np.uint64(
        epoch & 0xFFFFFFFF)
    k1 = (np.uint64(index & 0x3FFFFFFFFFFFFFFF) << np.uint64(2)) | np.uint64(
        stream & 0x3)
    return np.random.Generator(np.random.Philox(key=np.array([k0, k1])))


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Per-sample augmentation RNG: reproducible under any threading."""
    return philox(seed, epoch, index, 0)


def _rgb(img, resize: int) -> np.ndarray:
    arr = np.asarray(resize_shorter_side(img, resize), dtype=np.uint8)
    if arr.ndim == 2:  # grayscale safety (convert("RGB") normally prevents)
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def train_transform(img, rng: np.random.Generator, crop: int = 224,
                    resize: int = 256) -> np.ndarray:
    """Resize(256) -> RandomCrop(224) -> HFlip(0.5); returns uint8 HWC."""
    arr = random_crop(_rgb(img, resize), crop, rng)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr)


def eval_transform(img, crop: int = 224, resize: int = 256) -> np.ndarray:
    """Resize(256) -> CenterCrop(224); returns uint8 HWC."""
    return np.ascontiguousarray(center_crop(_rgb(img, resize), crop))


def synthetic_image(index: int, size: Tuple[int, int] = (256, 256),
                    seed: int = 0) -> np.ndarray:
    """Deterministic uint8 noise image for tests and benchmarks."""
    rng = philox(seed, 0, index, 1)
    return rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
