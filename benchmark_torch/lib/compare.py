"""The numbers that decide ``correct``, each against a limit of its own.

Training (the first three steps of the window's own call and feed, held
against the family's ``train_steps``, :mod:`.families`):

* ``loss_gap``: the widest ``|loss - ref| / |ref|`` over the three steps.
* ``loss1_gap``: the same for the first step alone, the forward from the
  seeded weights.  Adam's first updates move nearly every element by the
  learning rate whatever its gradient's size, so a rounding that flips
  the sign of a near-zero gradient moves the later losses; the first
  step's loss has no such noise.
* ``grad_gap``: the worst leaf's ``|norm(g) - norm(g_ref)|`` over the
  larger of the reference leaf's norm and the median leaf's, for the first
  step's gradient as Adam holds it (``exp_avg / (1 - beta1)``).
* ``logits_diff``: ``norm(z - z_ref) / norm(z_ref)`` of the first step's
  logits (the train step's own forward, read by a hook on the model).
  Gaps of losses and of norms hardly see rounding that is random from
  element to element, as a lower precision's is: the float8 control
  fails none of them on every seed, and it fails this one.
* ``change_gap``: the same for each leaf's change after the third step,
  over the leaves whose first reference gradient is at least a thousandth
  of the median leaf's (below that a leaf moves under Adam by round-off
  alone).
* ``feed_errors``: rows of those three batches that are not the seeded
  image and label of a distinct index (limit 0).

Answers (prediction and serving; a sample drawn from the seed, held
against the family's ``eval_logits``):

* ``score_gap``: the widest ``|score - p_ref| / p_ref``, where ``p_ref`` is
  the reference's softmax probability of the returned class.  A class
  other than the one whose probability the program returned reads far
  off, as does a wrong probability.  (The widest gap of the returned
  class's reference logit below the best one is not compared: the
  float8 control often returns the same classes, so that number has no
  upper reading.)
* ``missing``: answers due in the window that never came or say nothing
  (limit 0).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import numpy as np


def _worst(prog: Dict[str, float], ref: Dict[str, float], names,
           floor: float) -> Tuple[float, str]:
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, at = gap, n
    return worst, at


def train_numbers(prog, ref) -> Tuple[dict, dict]:
    """``(numbers, where)``: the training numbers and the leaf each gap of
    norms was worst at.  ``prog`` and ``ref`` are ``(losses, first
    logits, first gradient norms by leaf, change norms by leaf)``, as
    a family's ``train_steps`` returns them; the program's logits are
    moved to the reference's device."""
    prog_losses, prog_logits, prog_g1, prog_change = prog
    ref_losses, ref_logits, ref_g1, ref_change = ref
    gaps = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p)
            else math.inf for p, r in zip(prog_losses, ref_losses)]
    z = prog_logits.to(ref_logits.device, ref_logits.dtype)
    logits_diff = float((z - ref_logits).norm()) / max(
        float(ref_logits.norm()), 1e-30)
    if not math.isfinite(logits_diff):
        logits_diff = math.inf
    names = sorted(ref_g1)
    med_g = statistics.median(ref_g1[n] for n in names)
    grad_gap, grad_at = _worst(prog_g1, ref_g1, names, med_g)
    moving = [n for n in names if ref_g1[n] >= 1e-3 * med_g]
    med_c = statistics.median(ref_change[n] for n in moving)
    change_gap, change_at = _worst(prog_change, ref_change, moving, med_c)
    return ({"loss_gap": max(gaps), "loss1_gap": gaps[0],
             "logits_diff": logits_diff, "grad_gap": grad_gap,
             "change_gap": change_gap},
            {"grad_gap": grad_at, "change_gap": change_at,
             "excluded_leaves": sorted(set(names) - set(moving))})


def answer_numbers(classes, scores, ref_logits) -> dict:
    """``score_gap`` of returned ``classes`` and ``scores`` against the
    reference's float32 logits, row by row."""
    ref = np.asarray(ref_logits, dtype=np.float64)
    classes = np.asarray(classes, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    if (classes < 0).any() or (classes >= ref.shape[1]).any():
        return {"score_gap": math.inf}
    rows = np.arange(len(ref))
    shifted = ref - ref.max(axis=1, keepdims=True)
    p = np.exp(shifted) / np.exp(shifted).sum(axis=1, keepdims=True)
    p_cls = p[rows, classes]
    return {"score_gap": float((np.abs(scores - p_cls) / p_cls).max())}


def judge(numbers: dict, limits: dict) -> Tuple[bool, dict]:
    """``(correct, checks)``: every number at or under its limit (a number
    without a limit, or not finite, is not correct); ``checks`` maps each
    name to ``{"value", "limit"}``."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        value = float(value)
        good = (limit is not None and math.isfinite(value)
                and value <= float(limit))
        ok = ok and good
        checks[name] = {"value": value if math.isfinite(value) else
                        str(value), "limit": limit}
    return ok, checks
