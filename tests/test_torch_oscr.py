"""The port's OSCR and AUCs against the JAX package's (CPU).

* numpy ``calculate_oscr`` and ``calculate_oscr_reference``: bit-equal to
  the JAX ones over the seeds and cases of ``tests/test_oscr.py``
  (random labels with ``unk_label`` -1 and -2, duplicated scores, perfect
  separation, zero unknowns, the garbage column dropped).
* ``calculate_oscr_torch`` against ``calculate_oscr_jax`` on the same
  float32 inputs: ccr, fpr and taus equal at ``num_thresholds`` 0, 8 and
  16, including the +inf padding case of ``tests/test_oscr.py`` and
  scores rounded through bfloat16 (ties in the scores and in argmax);
  and at every numpy threshold the device values equal the numpy ones.
* ``threshold_at_fpr``, ``ccr_at_fpr`` and the two AUCs equal the JAX
  ones.
"""

import jax
import numpy as np
import pytest
import torch

from openset_imagenet_tpu.ops import metrics as jmetrics
from openset_imagenet_tpu.ops import oscr as joscr
from openset_imagenet_tpu_torch.ops import metrics as pmetrics
from openset_imagenet_tpu_torch.ops import oscr as poscr


def _scores(rng, n, c):
    z = rng.normal(size=(n, c))
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _bf16(x):
    """float32 values on the bfloat16 grid: many ties."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16() \
        .float().numpy()


def _cases():
    """(name, gt, scores, unk_label) over tests/test_oscr.py's inputs."""
    out = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        scores = _scores(rng, 300, 10)
        gt = rng.integers(-2, 10, size=300)
        for unk in (-1, -2):
            out.append((f"random{seed}_{unk}", gt, scores, unk))
    gt = np.array([0, 1, 0, 1, -1, -1, -2])
    scores = np.array([[0.9, 0.1], [0.2, 0.8], [0.9, 0.1], [0.8, 0.2],
                       [0.6, 0.4], [0.4, 0.6], [0.9, 0.1]])
    out += [("duplicates_-1", gt, scores, -1),
            ("duplicates_-2", gt, scores, -2)]
    out.append(("perfect", np.array([0, 1, -1, -1]),
                np.array([[0.99, 0.01], [0.05, 0.95], [0.51, 0.49],
                          [0.5, 0.5]]), -1))
    rng = np.random.default_rng(0)
    out.append(("zero_unknowns", rng.integers(0, 5, 64),
                rng.dirichlet(np.ones(5), 64), -2))
    rng = np.random.default_rng(5)
    scores = _scores(rng, 100, 6)
    gt = rng.integers(-2, 5, size=100)
    out += [("garbage_full", gt, scores, -1),
            ("garbage_dropped", gt, scores[:, :-1], -1)]
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_numpy_oscr_bit_equal_to_jax(case):
    _, gt, scores, unk = case
    for port, ref in ((poscr.calculate_oscr, joscr.calculate_oscr),
                      (poscr.calculate_oscr_reference,
                       joscr.calculate_oscr_reference)):
        got, want = port(gt, scores, unk), ref(gt, scores, unk)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _device_cases():
    out = []
    for name, gt, scores, unk in CASES:
        out.append((name, gt, np.asarray(scores, np.float32), unk))
    # The padding case of tests/test_oscr.py:115.
    gt = np.array([0, 1, 2, 3, 4, -1, -1, 0, 1, 2, -1, 3], np.int32)
    scores = np.random.default_rng(7).dirichlet(np.ones(5), size=len(gt))
    out.append(("padding", gt, scores.astype(np.float32), -1))
    rng = np.random.default_rng(11)
    gt = rng.integers(-2, 12, 500)
    out.append(("bf16_ties", gt, _bf16(rng.dirichlet(np.ones(12), 500)),
                -2))
    return out


DEVICE_CASES = _device_cases()


@pytest.mark.parametrize("num_thresholds", [0, 8, 16])
@pytest.mark.parametrize("case", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_device_oscr_equals_jax(case, num_thresholds):
    _, gt, scores, unk = case
    want = [np.asarray(a) for a in joscr.calculate_oscr_jax(
        gt, scores, unk_label=unk, num_thresholds=num_thresholds)]
    got = [t.numpy() for t in poscr.calculate_oscr_torch(
        torch.from_numpy(np.asarray(gt)), torch.from_numpy(scores),
        unk_label=unk, num_thresholds=num_thresholds)]
    for name, g, w in zip(("ccr", "fpr", "taus"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_device_oscr_jitted_jax_and_numpy_thresholds():
    """The jitted JAX function gives the same, and at every numpy
    threshold τ the device ccr and fpr equal the numpy ones."""
    rng = np.random.default_rng(12)
    gt = rng.integers(-2, 9, 2000)
    scores = _bf16(rng.dirichlet(np.ones(9) * 0.3, 2000))
    ccr, fpr, taus = (t.numpy() for t in poscr.calculate_oscr_torch(
        gt, torch.from_numpy(scores), unk_label=-1))
    f = jax.jit(lambda g, s: joscr.calculate_oscr_jax(g, s, unk_label=-1))
    for g, w in zip((ccr, fpr, taus), f(gt, scores)):
        np.testing.assert_array_equal(g, np.asarray(w))
    ccr_np, fpr_np = poscr.calculate_oscr(gt, scores, unk_label=-1)
    kn = gt >= 0
    ref_taus = np.unique(scores[kn, gt[kn]])[:-1]
    # The last position of each threshold in the sorted sweep.
    at = np.searchsorted(taus, ref_taus, side="right") - 1
    np.testing.assert_array_equal(taus[at], ref_taus)
    np.testing.assert_allclose(ccr[at], ccr_np, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fpr[at], fpr_np, rtol=0, atol=1e-6)


@pytest.mark.parametrize("target", [0.0, 0.01, 0.1, 0.25, 0.29, 0.5, 1.0])
def test_threshold_at_fpr_equals_jax(target):
    rng = np.random.default_rng(3)
    for u in (rng.uniform(0, 1, 501).astype(np.float32),
              np.array([0.3, 0.7, 0.7, 0.7]),
              np.linspace(0.1, 1.0, 100)):
        assert poscr.threshold_at_fpr(u, target) == \
            joscr.threshold_at_fpr(u, target)
    for bad in (np.array([]), np.array([0.1, np.nan])):
        with pytest.raises(ValueError):
            poscr.threshold_at_fpr(bad, target)


def test_ccr_at_fpr_equals_jax():
    rng = np.random.default_rng(4)
    gt = rng.integers(-2, 6, 400)
    ccr, fpr = poscr.calculate_oscr(gt, _scores(rng, 400, 6), unk_label=-2)
    for q in (1e-3, 1e-2, 3e-3, 0.05, 0.1, 0.5, 1.0):
        assert poscr.ccr_at_fpr(ccr, fpr, q) == joscr.ccr_at_fpr(ccr, fpr, q)
    assert poscr.ccr_at_fpr([], [], 0.1) is None


def test_auc_scores_equal_jax():
    rng = np.random.default_rng(6)
    gt = rng.integers(-1, 4, 300)
    scores = _scores(rng, 300, 4)
    assert pmetrics.auc_score_binary(gt, scores) == \
        jmetrics.auc_score_binary(gt, scores)
    known = gt >= 0
    assert pmetrics.auc_score_multiclass(gt[known], scores[known]) == \
        jmetrics.auc_score_multiclass(gt[known], scores[known])
