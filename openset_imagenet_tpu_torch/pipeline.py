"""Input pipeline: threaded host decode into statically shaped numpy batches.

Counterpart of :mod:`openset_imagenet_tpu.pipeline` for one process: the
same batches, bit for bit, for the same seed and epoch.

* **Threaded decode pool** -- JPEG decode and the geometric transforms
  release the GIL inside PIL's C core, so threads saturate host CPUs
  without pickling.
* **Static shapes** -- every batch is padded to exactly ``batch_size`` and
  carries a ``mask``; the ragged tail is padded *last* (index -1, mask 0),
  so a batch-norm window over its leading rows sees only valid samples.
  Pad rows recycle real images, so train-mode statistics never see zero
  frames.
* **uint8 host batches** -- images stay uint8 ``[B, H, W, 3]`` numpy; the
  train step copies them to the device with ``non_blocking=True`` and
  scales them there.  With ``pin_memory=True`` (a CUDA target) each batch
  is written into page-locked buffers, so that copy is asynchronous.
* **Bounded lookahead** -- a producer thread keeps ``prefetch`` batches in
  flight ahead of the consumer.

The shuffle is a ``(seed, epoch)``-keyed permutation, reproducible across
runs and resumes.  Multi-process slicing is not ported yet.
"""

from __future__ import annotations

import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np

from . import tracing
from . import transforms as T


class Batch(NamedTuple):
    """One host batch: uint8 images, int32 labels, float32 validity mask."""

    images: np.ndarray  # [B, H, W, 3] uint8
    labels: np.ndarray  # [B] int32
    mask: np.ndarray    # [B] float32; 0.0 rows are padding


class PILReader:
    """Default sample reader: JPEG file -> transformed uint8 crop.

    ``rng=None`` selects the eval transform (center crop); otherwise the
    train transform (random crop + flip) driven by the given generator.
    """

    def __init__(self, crop: int = 224, resize: int = 256):
        if crop > resize:
            raise ValueError(f"crop {crop} exceeds shorter-side resize "
                             f"{resize}; the crop window must fit the "
                             "resized image")
        self.crop = crop
        self.resize = resize

    def __call__(self, path, rng) -> np.ndarray:
        img = T.decode_image(path)
        if rng is None:
            return T.eval_transform(img, self.crop, self.resize)
        return T.train_transform(img, rng, self.crop, self.resize)


class SyntheticReader:
    """Deterministic noise reader for tests and device-throughput runs."""

    def __init__(self, crop: int = 224, seed: int = 0):
        self.crop = crop
        self.seed = seed
        self._cache = {}

    def __call__(self, path, rng) -> np.ndarray:
        # crc32 is stable across processes (built-in hash is not); a small
        # pool keeps the read cost near zero.
        key = zlib.crc32(str(path).encode()) % 64
        if key not in self._cache:
            self._cache[key] = T.synthetic_image(
                key, size=(self.crop, self.crop), seed=self.seed)
        return self._cache[key]


class InputPipeline:
    """Iterable over statically shaped, masked numpy batches.

    Args:
        paths: array/list of absolute sample paths (or arbitrary tokens for
            synthetic readers).
        labels: int array of the same length.
        batch_size: batch size (padded, never ragged).
        is_training: shuffle each epoch + random augmentation when True.
        seed: base seed for shuffle/augmentation streams.
        num_workers: decode threads.
        reader: ``reader(path, rng_or_None) -> uint8 [H, W, 3]``, or an
            object with ``read_batch(paths, rngs) -> uint8 [N, H, W, 3]``
            (batch mode: one decode call per batch, the padding still
            last).
        prefetch: batches kept in flight ahead of the consumer.
        drop_remainder: drop the ragged last batch instead of padding it.
        pin_memory: write batches into page-locked (pinned) memory, for
            asynchronous copies to a CUDA device.
        process_index / process_count: multi-process loading is not
            ported yet; ``process_count`` must be 1.
    """

    def __init__(self, paths, labels, batch_size: int, is_training: bool,
                 seed: int = 42, num_workers: int = 16,
                 reader: Optional[Callable] = None, prefetch: int = 2,
                 drop_remainder: bool = False, pin_memory: bool = False,
                 process_index: int = 0, process_count: int = 1):
        if int(process_count) != 1 or int(process_index) != 0:
            raise NotImplementedError(
                "multi-process input slicing is not ported yet (ROADMAP "
                "Queue 1 item 8)")
        self.paths = np.asarray(paths, dtype=object)
        self.labels = np.asarray(labels, dtype=np.int32)
        if len(self.paths) != len(self.labels):
            raise ValueError("paths and labels length mismatch")
        self.batch_size = int(batch_size)
        self.is_training = bool(is_training)
        self.seed = int(seed)
        self.num_workers = int(num_workers)
        self.reader = reader if reader is not None else PILReader()
        self.prefetch = max(1, int(prefetch))
        self.drop_remainder = bool(drop_remainder)
        self.pin_memory = bool(pin_memory)
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                        thread_name_prefix="osi-decode")

    @property
    def num_samples(self) -> int:
        return len(self.paths)

    def __len__(self) -> int:
        """Batches per epoch."""
        n = self.num_samples
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    # -- epoch iteration ----------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.paths)
        if self.is_training:
            return T.philox(self.seed, epoch, 0, 2).permutation(n)
        return np.arange(n)

    def _batch_indices(self, order: np.ndarray, batch_idx: int) -> np.ndarray:
        """Sample indices of batch ``batch_idx``, padded last with -1."""
        lo = batch_idx * self.batch_size
        idxs = order[lo:lo + self.batch_size]
        if len(idxs) < self.batch_size:
            pad = self.batch_size - len(idxs)
            idxs = np.concatenate([idxs, np.full(pad, -1, idxs.dtype)])
        return idxs

    def _load(self, index: int, epoch: int) -> np.ndarray:
        rng = (T.sample_rng(self.seed, epoch, int(index))
               if self.is_training else None)
        return self.reader(self.paths[index], rng)

    def _load_batch(self, idxs: np.ndarray, epoch: int) -> Batch:
        """Whole-batch load through a ``read_batch`` reader (one call that
        releases the GIL)."""
        real = idxs[idxs >= 0]
        rngs = [T.sample_rng(self.seed, epoch, int(i))
                if self.is_training else None for i in real]
        images = self.reader.read_batch([self.paths[i] for i in real], rngs)
        return self._assemble(idxs, images)

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Batch]:
        """Yield the batches of one epoch, decoded ahead by the pool.

        ``start_batch`` skips the first k batches without decoding them;
        order and augmentation are pure functions of ``(seed, epoch,
        index)``, so the suffix equals that of a full iteration.
        """
        order = self._epoch_order(epoch)
        nb = len(self)
        start_batch = int(start_batch)
        if not 0 <= start_batch <= nb:
            raise ValueError(f"start_batch {start_batch} outside the "
                             f"epoch's [0, {nb}] batch range")
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        batch_mode = hasattr(self.reader, "read_batch")

        def submit(batch_idx):
            idxs = self._batch_indices(order, batch_idx)
            if batch_mode:
                # One future per batch; the reader's own thread pool
                # spreads the images.
                return idxs, self._pool.submit(self._load_batch, idxs, epoch)
            return idxs, [self._pool.submit(self._load, i, epoch)
                          for i in idxs if i >= 0]

        def produce():
            try:
                window = []  # up to prefetch+1 batches of futures in flight
                b = submitted = start_batch
                while b < nb and not stop.is_set():
                    while submitted < min(nb, b + self.prefetch + 1):
                        window.append(submit(submitted))
                        submitted += 1
                    idxs, futs = window.pop(0)
                    with tracing.span("pipeline.assemble", key=b):
                        batch = (futs.result() if batch_mode else
                                 self._assemble(idxs,
                                                [f.result() for f in futs]))
                    with tracing.span("pipeline.put", key=b):
                        out_q.put(batch)
                    b += 1
                out_q.put(None)
            except BaseException as exc:  # surface worker errors to consumer
                out_q.put(exc)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="osi-pipeline")
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while producer.is_alive():  # drain so the producer can exit
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    producer.join(timeout=0.1)

    # -- batch assembly -----------------------------------------------------
    def _empty(self, shape, dtype) -> np.ndarray:
        if not self.pin_memory:
            return np.empty(shape, dtype)
        import torch

        pinned = torch.empty(shape, dtype=torch.from_numpy(
            np.empty(0, dtype)).dtype, pin_memory=True)
        return pinned.numpy()

    def _assemble(self, idxs: np.ndarray, imgs) -> Batch:
        """Rows (``-1`` = pad) and the decoded non-pad images, in order ->
        a statically shaped, masked batch."""
        real = idxs >= 0
        n_real = int(real.sum())
        rows = len(idxs)
        if n_real:
            shape = imgs[0].shape
        else:
            crop = int(getattr(self.reader, "crop", 224))
            shape = (crop, crop, 3)
        images = self._empty((rows, *shape), np.uint8)
        labels = self._empty((rows,), np.int32)
        mask = self._empty((rows,), np.float32)
        if n_real == rows:
            np.stack(imgs, out=images)
            labels[:] = self.labels[idxs]
            mask[:] = 1.0
        else:
            labels[:] = 0
            mask[:] = 0.0
            images[:] = 0
            if n_real:
                decoded = np.stack(imgs)
                pos = np.nonzero(real)[0]
                images[pos] = decoded
                labels[pos] = self.labels[idxs[real]]
                mask[pos] = 1.0
                # Pad rows recycle REAL images (mask stays 0): losses
                # ignore them exactly, and train-mode batch-norm
                # statistics see natural pixels instead of zero frames.
                pad_pos = np.nonzero(~real)[0]
                images[pad_pos] = decoded[np.arange(len(pad_pos)) % n_real]
        return Batch(images=images, labels=labels, mask=mask)

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)


def pipeline_from_dataset(dataset, batch_size: int, is_training: bool,
                          **kwargs) -> InputPipeline:
    """Build a pipeline from an :class:`~.dataset.ImagenetDataset` index,
    joining its relative paths with its ``imagenet_path`` root (reference
    ``dataset.py:46``)."""
    root = dataset.imagenet_path
    paths = [str(root / p) for p in dataset.paths]
    return InputPipeline(paths, dataset.labels, batch_size, is_training,
                         **kwargs)
