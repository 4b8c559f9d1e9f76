"""Open-Set Classification Rate (OSCR) on the host and on the device.

Counterpart of :mod:`openset_imagenet_tpu.ops.oscr`.  The reference
(``util.py:90-122``) sweeps every unique true-class score τ but the
largest and computes

* ``CCR(τ)``: the fraction of known samples that are correctly classified
  AND whose true-class score exceeds τ;
* ``FPR(τ)``: the fraction of unknown samples (label == ``unk_label``)
  whose max score exceeds τ.

:func:`calculate_oscr` gives the same values in O(N log N) with sort and
``searchsorted`` (the count of elements strictly greater than τ);
:func:`calculate_oscr_reference` is the reference's O(U·N) loop;
:func:`calculate_oscr_torch` is the static-shape form that runs on the
device its tensors are on.  :func:`threshold_at_fpr` and
:func:`ccr_at_fpr` are host numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def calculate_oscr(gt: np.ndarray, scores: np.ndarray,
                   unk_label: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """CCR/FPR pairs over all unique true-class score thresholds.

    Args:
        gt: ``[N]`` integer labels (``>= 0`` known; ``-1`` negative /
            ``-2`` unknown).
        scores: ``[N, C]`` float score matrix.  For garbage models the
            caller drops the background column first (reference
            ``util.py:186-188``).
        unk_label: which label counts as "unknown" for the FPR axis.

    Returns:
        ``(ccr, fpr)`` float arrays of identical length.
    """
    gt = np.asarray(gt).astype(int)
    scores = np.asarray(scores)
    kn = gt >= 0
    unk = gt == unk_label

    total_kn = np.sum(kn)
    total_unk = np.sum(unk)

    pred_class = np.argmax(scores, axis=1)
    max_score = np.max(scores, axis=1)
    target_score = scores[kn][range(int(kn.sum())), gt[kn]]

    taus = np.unique(target_score)[:-1]
    if taus.size == 0:
        return np.array([]), np.array([])

    # Count(x > tau) == len(x) - searchsorted(sorted(x), tau, side="right").
    correct_scores = np.sort(target_score[pred_class[kn] == gt[kn]])
    unk_max_scores = np.sort(max_score[unk])

    ccr = (correct_scores.size
           - np.searchsorted(correct_scores, taus, side="right")) / total_kn
    # Deliberate divergence: with zero unknowns the reference divides 0/0
    # into NaN (util.py:118); FPR is defined as 0 here instead.
    fpr = (unk_max_scores.size
           - np.searchsorted(unk_max_scores, taus, side="right")) / max(total_unk, 1)
    return ccr.astype(float), fpr.astype(float)


def calculate_oscr_reference(gt, scores, unk_label=-1):
    """Direct O(U·N) transcription of the reference loop, for golden tests."""
    gt = np.asarray(gt).astype(int)
    scores = np.asarray(scores)
    kn = gt >= 0
    unk = gt == unk_label
    total_kn = np.sum(kn)
    total_unk = np.sum(unk)
    ccr, fpr = [], []
    pred_class = np.argmax(scores, axis=1)
    max_score = np.max(scores, axis=1)
    target_score = scores[kn][range(int(kn.sum())), gt[kn]]
    for tau in np.unique(target_score)[:-1]:
        ccr.append(((pred_class[kn] == gt[kn]) & (target_score > tau)).sum()
                   / total_kn)
        fpr.append((unk & (max_score > tau)).sum() / total_unk)
    return np.array(ccr), np.array(fpr)


def calculate_oscr_torch(gt, scores, unk_label: int = -1,
                         num_thresholds: int = 0):
    """OSCR on the device of ``scores``, with static shapes.

    The counterpart of JAX ``calculate_oscr_jax`` (``oscr.py:87-141``):
    instead of the data-dependent ``unique`` threshold set it sweeps every
    sorted true-class score (``num_thresholds=0``: a length-N vector whose
    non-known rows are +inf padding, duplicates kept) or
    ``num_thresholds`` evenly spaced quantiles of the known rows' sorted
    scores.  CCR and FPR at a threshold equal :func:`calculate_oscr`'s at
    the same τ; duplicated thresholds repeat curve points.  With its
    inputs on the device, nothing here waits for the device.

    Returns ``(ccr, fpr, taus)`` tensors on the device of ``scores``
    (float32 rates; ``taus`` in the dtype of ``scores``).
    """
    scores = torch.as_tensor(scores)
    gt = torch.as_tensor(gt, device=scores.device).to(torch.int32)
    kn = gt >= 0
    unk = gt == unk_label
    n_kn_rows = kn.sum()
    n_unk = unk.sum()
    total_kn = n_kn_rows.clamp(min=1)
    total_unk = n_unk.clamp(min=1)

    num_classes = scores.shape[-1]
    safe = gt.clamp(0, num_classes - 1).long()
    target_score = torch.gather(scores, 1, safe[:, None])[:, 0]
    # argmax takes the first of tied maxima, as numpy and XLA do.
    pred_ok = (scores.argmax(dim=-1) == gt) & kn
    max_score = scores.max(dim=-1).values
    inf = float("inf")

    # Threshold set: sorted known true-class scores; the non-known rows
    # are pushed to +inf, so they never enter the finite prefix.
    taus_all = torch.where(kn, target_score, inf).sort().values
    if num_thresholds and num_thresholds > 0:
        # Quantiles over the finite prefix only (its length is data
        # dependent): fractions of [0, n_kn_rows - 1].  The fractions are
        # jnp.linspace's float32 ones, iota / (num - 1) correctly rounded
        # (formed in numpy: torch on CUDA multiplies by the reciprocal of
        # a host scalar), and torch.round rounds half to even as
        # jnp.round does, so the indices are the JAX function's.
        k = int(num_thresholds)
        frac = np.arange(k, dtype=np.float32)
        if k > 1:
            frac /= np.float32(k - 1)
        frac = torch.from_numpy(frac).to(scores.device, non_blocking=True)
        idx = torch.round(frac * (n_kn_rows - 1).clamp(min=0))
        taus = taus_all[idx.long()]
    else:
        taus = taus_all

    correct = torch.where(pred_ok, target_score, inf).sort().values
    unk_max = torch.where(unk, max_score, inf).sort().values
    n_correct = pred_ok.sum()

    # Clamp the counts to the finite prefix: at tau == +inf (the padding)
    # right=True would also count the +inf padding entries and drive the
    # counts negative.
    cs = torch.minimum(torch.searchsorted(correct, taus, right=True),
                       n_correct)
    us = torch.minimum(torch.searchsorted(unk_max, taus, right=True), n_unk)
    ccr = (n_correct - cs).to(torch.float32) / total_kn
    fpr = (n_unk - us).to(torch.float32) / total_unk
    return ccr, fpr, taus


def threshold_at_fpr(unknown_measures: np.ndarray,
                     fpr_target: float) -> float:
    """Smallest accept-threshold whose false-positive rate on unknowns is
    ``<= fpr_target``.

    Serving extension (no reference counterpart): operationalizes the
    evaluation's CCR@FPR view (reference ``script/plot_all.py:352-353``)
    for deployment -- the returned threshold plugs into
    :class:`~openset_imagenet_tpu_torch.inference.OpenSetPredictor`, whose
    convention is *accept iff measure >= threshold*.
    ``unknown_measures`` are the rejection measures of known-to-be-unknown
    validation samples (max-softmax over the known region, or
    ``||feature|| * max-softmax`` in objectosphere mode).

    The smallest qualifying threshold (up to one float32 ulp) is
    returned, so known-class acceptance (CCR) is maximal at the chosen
    operating point.  Ties are handled exactly: the count of unknowns
    ``>= threshold`` is ``<= floor(fpr_target * n)`` whether the
    comparison happens in float32 (the predictor's measure dtype) or
    float64.
    """
    u = np.sort(np.asarray(unknown_measures, dtype=np.float64))
    n = u.size
    if n == 0:
        raise ValueError("no unknown samples to calibrate on")
    if np.isnan(u).any():
        # np.sort puts NaN last, so it would BECOME the threshold at
        # small targets -- and 'measure < NaN' is always False in the
        # predictor, silently disabling rejection entirely.
        raise ValueError("unknown_measures contain NaN — calibration "
                         "would silently accept everything")
    if not 0.0 <= fpr_target <= 1.0:
        raise ValueError(f"fpr_target must be in [0, 1], got {fpr_target}")
    # Unknowns allowed above the threshold: largest k with k/n <= target.
    # One float64 ulp of headroom before floor() so 0.29*100 ==
    # 28.999999999999996 still yields k=29, not 28.
    k = int(np.floor(np.nextafter(fpr_target * n, np.inf)))
    if k >= n:
        return 0.0                       # accept everything
    # Any threshold <= u[n-k-1] accepts >= k+1 unknowns; just above it
    # accepts exactly count(u > u[n-k-1]) <= k (ties fall below).  One
    # float32 ulp above is strictly greater than the float64 value AND
    # representable in float32, so the guarantee survives the
    # predictor's float32 comparison.
    return float(np.nextafter(np.float32(u[n - k - 1]), np.float32(np.inf)))


def ccr_at_fpr(ccr: np.ndarray, fpr: np.ndarray, query: float,
               max_rel_error: float = 0.10):
    """CCR at the FPR value nearest to ``query``.

    The nearest-FPR lookup of the reference LaTeX table
    (``script/plot_all.py:344-387``): ``None`` when the nearest FPR
    deviates from the query by >= ``max_rel_error`` (the table prints
    "---").
    """
    fpr = np.asarray(fpr)
    if fpr.size == 0:
        return None
    idx = int(np.abs(fpr - query).argmin())
    error = abs(fpr[idx] - query) / query
    if round(100 * error, 1) >= 100 * max_rel_error:
        return None
    return float(np.asarray(ccr)[idx])
