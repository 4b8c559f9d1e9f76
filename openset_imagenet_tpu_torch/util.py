"""Analysis helpers: score archives, split composition, histograms.

Counterpart of :mod:`openset_imagenet_tpu.util` (reference ``util.py``):
re-exports the config layer (``NameSpace`` / ``load_yaml``) and the OSCR
computation, and holds :class:`SplitTable`, :func:`dataset_info`,
:func:`read_array_list`, :func:`get_best_arrays` and
:func:`get_histogram`.  The plotting helpers live in :mod:`.plots` and
resolve here lazily, so matplotlib is imported only when one is used.
The JAX module's XLA compile-cache helpers have no counterpart here:
the port's compile cache is ``torch.compile``'s (ROADMAP Queue 1 item
5).
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from .config import NameSpace, load_yaml  # noqa: F401  (parity re-export)
from .ops.oscr import calculate_oscr, ccr_at_fpr  # noqa: F401


def __getattr__(name):
    # The plotting helpers (reference util.py hosts them beside the
    # analysis code) import matplotlib, so they resolve on first use.
    if name in ("plot_oscr", "plot_single_oscr"):
        from . import plots
        return getattr(plots, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class SplitTable:
    """Tiny column/row table standing in for the reference's DataFrame.

    Supports the access patterns the analysis surface actually uses —
    ``table["col"]`` (column as list), ``table.rows`` (list of dicts),
    ``len``, iteration over rows, and a readable ``str`` — without a
    pandas dependency in the package.
    """

    def __init__(self, columns, rows):
        self.columns = list(columns)
        self.rows = [dict(zip(self.columns, r)) for r in rows]

    def __getitem__(self, column):
        return [row[column] for row in self.rows]

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def __str__(self):
        widths = [max(len(str(c)), *(len(self._fmt(r[c]))
                                     for r in self.rows))
                  for c in self.columns] if self.rows else \
                 [len(str(c)) for c in self.columns]
        head = "  ".join(c.rjust(w) for c, w in zip(self.columns, widths))
        body = "\n".join(
            "  ".join(self._fmt(r[c]).rjust(w)
                      for c, w in zip(self.columns, widths))
            for r in self.rows)
        return head + ("\n" + body if body else "")

    @staticmethod
    def _fmt(v):
        return f"{v:.2f}" if isinstance(v, float) else str(v)


def dataset_info(protocol_data_dir):
    """Table with per-split known/negative/unknown composition.

    Parity: reference ``util.py:38-66`` (reads ``train.csv``,
    ``validation.csv``, ``test.csv`` in the given directory; same
    columns).  Returns a :class:`SplitTable` instead of a DataFrame.
    """
    import csv

    data_dir = Path(protocol_data_dir)
    files = {"train": data_dir / "train.csv",
             "val": data_dir / "validation.csv",
             "test": data_dir / "test.csv"}
    data = []
    for split, path in files.items():
        with open(path, newline="") as f:
            labels = [int(row[1]) for row in csv.reader(f) if row]
        size = len(labels)
        kn_size = sum(1 for l in labels if l >= 0)
        kn_unk_size = sum(1 for l in labels if l == -1)
        unk_unk_size = sum(1 for l in labels if l == -2)
        data.append((split, len(set(labels)), size,
                     kn_size, 100 * kn_size / size,
                     kn_unk_size, 100 * kn_unk_size / size,
                     unk_unk_size, 100 * unk_unk_size / size))
    return SplitTable([
        "split", "classes", "size", "kn size", "kn (%)", "kn_unk size",
        "kn_unk (%)", "unk_unk size", "unk_unk (%)"], data)


def read_array_list(file_names):
    """Load saved ``.npz`` score archives into a dict keyed by name.

    Parity: reference ``util.py:69-87`` — accepts either a dict
    (``key -> path``) or a list of paths (key derived from the file name with
    the trailing 8 characters stripped).
    """
    arrays = defaultdict(dict)
    if isinstance(file_names, dict):
        for key, file in file_names.items():
            arrays[key] = np.load(file)
    else:
        for file in file_names:
            file = str(file)
            name = file.split("/")[-1][:-8]
            arrays[name] = np.load(file)
    return arrays


def get_best_arrays(files_dict):
    """Map ``*_curr_*`` score paths to their ``*_best_*`` counterparts.

    Parity: reference ``util.py:231-240``.
    """
    best_paths = dict()
    for name, path in files_dict.items():
        best_paths[name] = Path(str(path).replace("_curr_", "_best_"))
    return best_paths


def get_histogram(array, unk_label=-1, metric="score", bins=100,
                  drop_bg=False, log_space=False, geomspace_limits=(1, 1e2)):
    """Histograms of known vs unknown scores or feature norms.

    Parity: reference ``util.py:202-228``: for ``metric='score'`` knowns use
    the true-class score and unknowns the max score; for ``metric='norm'``
    both use the L2 feature norm.  ``drop_bg`` removes the background column
    for garbage models first.
    """
    score = array["scores"]
    if drop_bg:
        score = score[:, :-1]
    gt = array["gt"].astype(np.int64)
    features = array["features"]
    norms = np.linalg.norm(features, axis=1)
    kn = gt >= 0
    unk = gt == unk_label
    if metric == "score":
        kn_metric = score[kn, gt[kn]]
        unk_metric = np.amax(score[unk], axis=1)
    elif metric == "norm":
        kn_metric = norms[kn]
        unk_metric = norms[unk]
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if log_space:
        lower, upper = geomspace_limits
        bins = np.geomspace(lower, upper, num=bins)
    kn_hist, kn_edges = np.histogram(kn_metric, bins=bins)
    unk_hist, unk_edges = np.histogram(unk_metric, bins=bins)
    return kn_hist, kn_edges, unk_hist, unk_edges
