"""CSV-driven ImageNet dataset index with open-set label surgery.

Counterpart of :mod:`openset_imagenet_tpu.dataset` (numpy and csv only;
the same index, label bookkeeping and surgery).  Parity with the reference
dataset layer (``dataset.py:10-86``): a protocol
CSV lists ``relative_jpeg_path,int_label`` rows where labels are ``0..N-1``
for known classes, ``-1`` for negatives (known unknowns) and ``-2`` for
unknowns (test only).  The three loss regimes each need different label
surgery before training:

* ``garbage``  — ``replace_negative_label()``: ``-1`` becomes the extra
  background class ``label_count - 1`` (reference ``dataset.py:60-68``).
* ``softmax``  — ``remove_negative_label()``: rows with label < 0 are dropped
  from the *training* set only (reference ``dataset.py:70-74``).
* ``entropic`` — no surgery; the loss consumes negative labels natively.

Unlike the reference (a torch ``Dataset`` holding a pandas frame and doing
per-item JPEG decode), this class is a pure *index* over two flat numpy
arrays: it owns the path/label arrays and the label bookkeeping, while
decoding and batching live in the input pipeline (:mod:`.pipeline`),
which consumes the arrays wholesale.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


class ImagenetDataset:
    """Index over a protocol CSV: relative JPEG paths plus integer labels."""

    def __init__(self, csv_file, imagenet_path, transform=None):
        """Args mirror reference ``dataset.py:13-27``.

        Args:
            csv_file: path to a ``p{P}_{split}.csv`` protocol file
                (no header; columns: path, label).
            imagenet_path: root of the ILSVRC2012 tree the paths are
                relative to.
            transform: optional host-side transform (see
                :mod:`.transforms`); stored for the pipeline to use.
        """
        paths, labels = [], []
        with open(csv_file, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                paths.append(row[0])
                labels.append(int(row[1]))
        self._paths = np.asarray(paths, dtype=object)
        self._labels = np.asarray(labels, dtype=np.int32)
        self.imagenet_path = Path(imagenet_path)
        self.transform = transform
        self.unique_classes = np.unique(self._labels)
        self.label_count = len(self.unique_classes)

    def __len__(self) -> int:
        return len(self._labels)

    # -- array accessors used by the input pipeline ------------------------
    @property
    def paths(self) -> np.ndarray:
        """Relative JPEG paths as a numpy object array."""
        return self._paths

    @property
    def labels(self) -> np.ndarray:
        """Labels as an int32 numpy array."""
        return self._labels

    def absolute_path(self, index: int) -> Path:
        return self.imagenet_path / str(self._paths[index])

    # -- label surgery (parity with reference dataset.py:56-86) ------------
    def has_negatives(self) -> bool:
        """True if the dataset contains negative (-1) samples."""
        return -1 in self.unique_classes

    def replace_negative_label(self) -> None:
        """Replace label ``-1`` with ``label_count - 1`` (garbage regime).

        Parity: reference ``dataset.py:60-68`` — the biggest label is
        ``label_count - 1`` since ``-1`` is part of the unique label set;
        ``label_count`` itself is intentionally unchanged.
        """
        biggest_label = self.label_count - 1
        self._labels = np.where(self._labels == -1, biggest_label,
                                self._labels).astype(np.int32)
        self.unique_classes[self.unique_classes == -1] = biggest_label
        self.unique_classes.sort()

    def remove_negative_label(self) -> None:
        """Drop all rows with label < 0 (softmax training regime).

        Parity: reference ``dataset.py:70-74``.
        """
        keep = self._labels >= 0
        self._paths = self._paths[keep]
        self._labels = self._labels[keep]
        self.unique_classes = np.unique(self._labels)
        self.label_count = len(self.unique_classes)

    def calculate_class_weights(self) -> np.ndarray:
        """Balanced class weights ``len(ds) / (count_c * label_count)``.

        Parity: reference ``dataset.py:77-86`` (weights ordered by
        ascending class label, as the pandas groupby there produces).
        """
        _, counts = np.unique(self._labels, return_counts=True)
        return (len(self._labels) /
                (counts * self.label_count)).astype(np.float32)
