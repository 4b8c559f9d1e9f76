"""ctypes binding and build step for the native JPEG data path.

Counterpart of :mod:`openset_imagenet_tpu.native.jpeg` over the same C
ABI of ``native/osijpeg.cpp`` (fused libjpeg decode -> shorter-side
resize -> crop -> flip), built from that source as it is.  The library is
compiled at first use with ``g++ -O3 -march=native -shared -fPIC ...
-ljpeg`` (the JAX loader's flags, so both decode the same pixels) into
``build/native/libosijpeg_<hash>.so`` of the checkout, keyed by the
source's hash, under a per-process temporary name and then renamed.
Without a toolchain or libjpeg :func:`native_available` is False and the
worker's ``data.reader: auto`` reads with PIL, as the JAX package does.

:class:`NativeReader` takes one image a call; :class:`NativeBatchReader`
a whole batch in one call on the library's thread pool, which releases
the GIL; :func:`decode_batch_mem` decodes in-memory blobs the same way
for the serving daemon.  Both readers draw their crop offsets and flip from each sample's rng as
the JAX readers do, and replay an image the native decoder rejects
through PIL with the same geometry.  The native decoder stops reading
once the crop window is filled, so a JPEG damaged only below that window
decodes cleanly where PIL raises (JAX ``native/jpeg.py:8-21``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "osijpeg.cpp"
_BUILD_DIR = _REPO / "build" / "native"
_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libosijpeg_{digest}.so"


def _build_library(lib_path: Path) -> None:
    # A process-unique temporary name and an atomic rename: processes
    # that build at once never load a half-written library.
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           str(_SRC), "-o", str(tmp), "-ljpeg"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)


def load_library():
    """Load (building if needed) the native library; None if it cannot
    be built or loaded."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib_path = _library_path()
            if not lib_path.exists():
                _build_library(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            lib.osi_decode_resize_crop.restype = ctypes.c_int
            lib.osi_decode_resize_crop.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.osi_jpeg_size.restype = ctypes.c_int
            lib.osi_jpeg_size.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.osi_decode_batch.restype = ctypes.c_int
            lib.osi_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.osi_decode_batch_mem.restype = ctypes.c_int
            lib.osi_decode_batch_mem.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as exc:
            _lib_error = str(exc)  # no g++, no libjpeg, or no loader
            _lib = None
        return _lib


def native_available() -> bool:
    return load_library() is not None


def decode_resize_crop(data: bytes, resize: int, crop: int,
                       top: int = -1, left: int = -1,
                       flip: bool = False) -> Optional[np.ndarray]:
    """Fused decode; returns ``uint8 [crop, crop, 3]`` or None on failure."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((crop, crop, 3), np.uint8)
    rc = lib.osi_decode_resize_crop(
        data, len(data), resize, crop, top, left, int(flip),
        out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def jpeg_size(data: bytes):
    """(width, height) of a JPEG, or None."""
    lib = load_library()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.osi_jpeg_size(data, len(data), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def pil_replay(source, resize: int, crop: int, top=None, left=None,
               utop: float = -1.0, uleft: float = -1.0,
               flip: bool = False) -> np.ndarray:
    """PIL decode with the native path's crop geometry.

    ``top``/``left`` are integer offsets in resized coordinates (None:
    from the fractional ``utop``/``uleft`` draws; both negative: center
    crop), as JAX ``native/jpeg.py:129-156``.
    """
    from .. import transforms as Tr

    arr = np.asarray(Tr.resize_shorter_side(Tr.decode_image(source),
                                            resize), dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = Tr._pad_to(arr, crop)
    h, w = arr.shape[:2]
    if top is None:
        top = (int(utop * (max(h - crop, 0) + 1)) if utop >= 0
               else Tr.center_crop_offset(h, crop))
    if left is None:
        left = (int(uleft * (max(w - crop, 0) + 1)) if uleft >= 0
                else Tr.center_crop_offset(w, crop))
    top = min(max(int(top), 0), max(h - crop, 0))
    left = min(max(int(left), 0), max(w - crop, 0))
    arr = arr[top:top + crop, left:left + crop]
    if flip:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr)


def decode_batch(paths, utop=None, uleft=None, flips=None, resize=256,
                 crop=224, threads: Optional[int] = None):
    """Decode ``paths`` into one ``uint8 [N, crop, crop, 3]`` batch on the
    library's thread pool; returns ``(images, ok)``, ``ok[i]`` False for
    an image a fallback must decode, or ``(None, None)`` without the
    library.  ``utop``/``uleft`` are fractional crop positions in
    ``[0, 1)`` (negative or None: center), ``flips`` booleans."""
    lib = load_library()
    if lib is None:
        return None, None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    out = np.empty((n, crop, crop, 3), np.uint8)
    ok = np.zeros(n, np.uint8)

    def floats(arr):
        a = (np.full(n, -1.0, np.float32) if arr is None
             else np.asarray(arr, np.float32))
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    ut, ut_p = floats(utop)
    ul, ul_p = floats(uleft)
    fl = (np.zeros(n, np.uint8) if flips is None
          else np.asarray(flips, np.uint8))
    if threads is None:
        threads = min(n, os.cpu_count() or 1)
    lib.osi_decode_batch(
        c_paths, n, ut_p, ul_p,
        fl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        resize, crop, int(threads),
        out.ctypes.data_as(ctypes.c_void_p),
        ok.ctypes.data_as(ctypes.c_void_p))
    return out, ok.astype(bool)


def decode_batch_mem(blobs, resize=256, crop=224,
                     threads: Optional[int] = None):
    """Decode in-memory JPEG ``blobs`` into one ``uint8 [N, crop, crop, 3]``
    center-cropped batch on the library's thread pool, which releases the
    GIL for the whole batch: the serving daemon's bulk decode.

    Returns ``(images, ok)``, ``ok[i]`` False for a blob the native decoder
    rejects (the caller replays it through :func:`pil_replay`), or
    ``(None, None)`` without the library.
    """
    lib = load_library()
    if lib is None:
        return None, None
    n = len(blobs)
    blobs = [bytes(b) for b in blobs]  # kept alive across the C call
    c_bufs = (ctypes.c_char_p * n)(*blobs)
    c_lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    out = np.empty((n, crop, crop, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    if threads is None:
        threads = min(n, os.cpu_count() or 1)
    lib.osi_decode_batch_mem(
        c_bufs, c_lens, n, None, None, None, resize, crop, int(threads),
        out.ctypes.data_as(ctypes.c_void_p),
        ok.ctypes.data_as(ctypes.c_void_p))
    return out, ok.astype(bool)


class NativeBatchReader:
    """Whole-batch reader: one call on the library's thread pool.

    For training each sample draws ``(u_top, u_left, u_flip)`` as three
    ``rng.random()`` values from its own stream; eval (rng None) takes
    center crops.  Images the decoder rejects are replayed through PIL
    with the same geometry.
    """

    def __init__(self, crop: int = 224, resize: int = 256,
                 threads: Optional[int] = None):
        if crop > resize:
            raise ValueError(f"crop {crop} exceeds shorter-side resize "
                             f"{resize}")
        self.crop = crop
        self.resize = resize
        self.threads = threads

    def read_batch(self, paths, rngs) -> np.ndarray:
        n = len(paths)
        # Below 1.0: a float32 draw rounded up to 1.0 would map one past
        # the last crop offset.
        max_u = np.nextafter(np.float32(1.0), np.float32(0.0))
        utop = np.full(n, -1.0, np.float32)
        uleft = np.full(n, -1.0, np.float32)
        flips = np.zeros(n, np.uint8)
        for i, rng in enumerate(rngs):
            if rng is not None:
                utop[i] = min(np.float32(rng.random()), max_u)
                uleft[i] = min(np.float32(rng.random()), max_u)
                flips[i] = rng.random() < 0.5
        images, ok = decode_batch(paths, utop, uleft, flips, self.resize,
                                  self.crop, self.threads)
        if images is None:  # no library: every image through PIL
            images = np.empty((n, self.crop, self.crop, 3), np.uint8)
            ok = np.zeros(n, bool)
        for i in np.nonzero(~ok)[0]:
            images[i] = pil_replay(paths[i], self.resize, self.crop,
                                   utop=float(utop[i]),
                                   uleft=float(uleft[i]),
                                   flip=bool(flips[i]))
        return images


class NativeReader:
    """Per-image reader: the native fused path, PIL for what it rejects.

    ``PILReader`` semantics: ``rng=None`` is a center crop (eval);
    otherwise a random crop and a flip with probability 0.5, drawn in
    the host transforms' order (offsets first, then the coin).
    """

    def __init__(self, crop: int = 224, resize: int = 256):
        if crop > resize:
            raise ValueError(f"crop {crop} exceeds shorter-side resize "
                             f"{resize}")
        self.crop = crop
        self.resize = resize
        from ..pipeline import PILReader
        self._fallback = PILReader(crop=crop, resize=resize)

    def __call__(self, path, rng) -> np.ndarray:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return self._fallback(path, rng)
        if rng is None:
            out = decode_resize_crop(data, self.resize, self.crop)
            return out if out is not None else self._fallback(path, rng)
        size = jpeg_size(data)
        if size is None:
            return self._fallback(path, rng)
        from .. import transforms as Tr
        rw, rh = Tr.resized_geometry(*size, self.resize)
        top = int(rng.integers(0, max(rh - self.crop, 0) + 1))
        left = int(rng.integers(0, max(rw - self.crop, 0) + 1))
        flip = bool(rng.random() < 0.5)
        out = decode_resize_crop(data, self.resize, self.crop, top, left,
                                 flip)
        if out is not None:
            return out
        # The draws are spent: replay the same crop and flip through PIL.
        return pil_replay(data, self.resize, self.crop, top=top, left=left,
                          flip=flip)
