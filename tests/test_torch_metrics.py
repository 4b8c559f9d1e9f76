"""PyTorch port confidence metrics against the JAX package (CPU).

Same numpy inputs through ``openset_imagenet_tpu.ops.metrics`` and its
port; rtol 1e-6 (float32 sums in another order), counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu.ops import metrics as jm
from openset_imagenet_tpu_torch.ops import metrics as pm


def make_scores(b=48, c=12, seed=0, garbage=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, c)).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    low = 0 if garbage else -2
    labels = rng.integers(low, c, b).astype(np.int32)
    mask = (rng.random(b) > 0.25).astype(np.float32)
    return logits, scores.astype(np.float32), labels, mask


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
@pytest.mark.parametrize("masked", [False, True])
def test_confidence_sums_match_jax(loss, masked):
    _, scores, labels, mask = make_scores(garbage=loss == "garbage",
                                          seed=int(masked))
    regime = pm.loss_regime_params(loss, scores.shape[1])
    assert regime == jm.loss_regime_params(loss, scores.shape[1])
    got = pm.confidence_sums(torch.from_numpy(scores),
                             torch.from_numpy(labels),
                             sample_mask=torch.from_numpy(mask)
                             if masked else None, **regime)
    ref = jm.confidence_sums(jnp.asarray(scores), jnp.asarray(labels),
                             sample_mask=jnp.asarray(mask) if masked
                             else None, **regime)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
    assert float(got[1]) == float(ref[1]) and float(got[3]) == float(ref[3])


@pytest.mark.parametrize("case", ["mixed", "no_unknowns", "no_knowns"])
def test_confidence_matches_jax(case):
    _, scores, labels, _ = make_scores(seed=3)
    if case == "no_unknowns":
        labels = np.abs(labels)
    if case == "no_knowns":
        labels = -np.ones_like(labels)
    kw = dict(offset=1.0 / scores.shape[1], unknown_class=-1)
    got = pm.confidence(scores, labels, **kw)
    ref = jm.confidence(scores, labels, **kw)
    assert got[1] == ref[1] and got[3] == ref[3]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6)


@pytest.mark.parametrize("loss,n", [("garbage", 5), ("entropic", 116),
                                    ("softmax", 1000)])
def test_loss_regime_params_match_jax(loss, n):
    assert pm.loss_regime_params(loss, n) == jm.loss_regime_params(loss, n)


@pytest.mark.parametrize("threshold", [0.0, 0.5, 2.0, 1e9])
def test_predict_objectosphere_matches_jax(threshold):
    logits, _, _, _ = make_scores(seed=5)
    features = np.random.default_rng(6).normal(
        size=(logits.shape[0], 7)).astype(np.float32)
    got = pm.predict_objectosphere(torch.from_numpy(logits),
                                   torch.from_numpy(features), threshold)
    ref = np.asarray(jm.predict_objectosphere(logits, features, threshold))
    np.testing.assert_array_equal(got[:, 0].numpy(), ref[:, 0])
    np.testing.assert_allclose(got[:, 1].numpy(), ref[:, 1], rtol=1e-6)


def test_metric_aliases_re_export_the_port_metrics():
    """``openset_imagenet_tpu_torch.metrics`` has the six names of JAX's
    ``openset_imagenet_tpu.metrics``, each the port's ``ops.metrics``
    function."""
    from openset_imagenet_tpu import metrics as jaliases
    from openset_imagenet_tpu_torch import metrics as aliases

    names = sorted(n for n in vars(jaliases) if not n.startswith("_"))
    assert len(names) == 6
    assert sorted(n for n in vars(aliases) if not n.startswith("_")) == names
    for name in names:
        assert getattr(aliases, name) is getattr(pm, name)
