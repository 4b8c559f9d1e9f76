"""PyTorch port losses against the JAX package (CPU).

The port's plain losses (``ops.losses``) and its fused wrappers
(``ops.fused_loss``, which run their kernels' plain versions on CPU
tensors) are held against JAX's ``ops.losses`` and its Pallas kernels in
interpreter mode, on the same numpy inputs.  Tolerance: rtol 1e-5 on the
mean (float32 sums in another order); row counts exact, the garbage
loss's summed class weights within rtol 1e-6.  Gradients (the K2 / K4
plain versions behind the autograd Functions) against ``jax.grad`` of the
JAX fused losses: rtol 1e-4, atol 1e-6, as ``tests/test_fused_loss.py``;
masked rows exactly zero; ``gradcheck`` in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu.ops import fused_loss as jfl
from openset_imagenet_tpu.ops import losses as jl
from openset_imagenet_tpu_torch.ops import fused_loss as pfl
from openset_imagenet_tpu_torch.ops import losses as plosses


def make_batch(b=16, c=116, seed=0, label_low=-1):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, c)) * 3).astype(np.float32)
    labels = rng.integers(label_low, c, b).astype(np.int32)
    mask = (rng.random(b) > 0.2).astype(np.float32)
    weights = rng.uniform(0.2, 2.0, c).astype(np.float32)
    return logits, labels, mask, weights


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _check(got, ref, loss="entropic"):
    (gm, gc), (rm, rc) = got, ref
    if loss == "garbage":
        assert float(gc) == pytest.approx(float(rc), rel=1e-6, abs=0)
    else:
        assert float(gc) == float(rc)
    np.testing.assert_allclose(float(gm), float(rm), rtol=1e-5, atol=1e-7)


def _port_all(loss, logits, labels, mask, weights, w):
    """(plain, fused-wrapper) results of the port for one regime."""
    lg, lb, mk, wt = _t(logits, labels, mask, weights)
    if loss == "entropic":
        return (plosses.entropic_openset_loss(lg, lb, w, mk),
                pfl.entropic_openset_loss_fused(lg, lb, mk, w))
    if loss == "softmax":
        return (plosses.softmax_loss(lg, lb, mk),
                pfl.softmax_loss_fused(lg, lb, mk))
    return (plosses.garbage_loss(lg, lb, wt, mk),
            pfl.garbage_loss_fused(lg, lb, wt, mk))


def _jax_all(loss, logits, labels, mask, weights, w):
    lg, lb, mk = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)
    wt = jnp.asarray(weights)
    if loss == "entropic":
        return (jl.entropic_openset_loss(lg, lb, w, mk),
                jfl.entropic_openset_loss_fused(lg, lb, mk, w))
    if loss == "softmax":
        return (jl.softmax_loss(lg, lb, mk),
                jfl.softmax_loss_fused(lg, lb, mk))
    return (jl.garbage_loss(lg, lb, wt, mk),
            jfl.garbage_loss_fused(lg, lb, wt, mk))


@pytest.mark.parametrize("c", [8, 116, 128, 1000])
@pytest.mark.parametrize("loss,w", [("entropic", 1.0), ("entropic", 0.5),
                                    ("softmax", 1.0), ("garbage", 1.0)])
def test_losses_match_jax(loss, w, c):
    batch = make_batch(c=c, seed=c, label_low=0 if loss == "garbage" else -1)
    port_plain, port_fused = _port_all(loss, *batch, w)
    jax_plain, jax_fused = _jax_all(loss, *batch, w)
    _check(port_plain, jax_plain, loss)
    _check(port_fused, jax_fused, loss)
    _check(port_fused, port_plain, loss)


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
@pytest.mark.parametrize("case", ["all_negative", "all_masked",
                                  "masked_tail", "multiblock"])
def test_edge_batches_match_jax(loss, case):
    b = 600 if case == "multiblock" else 64
    logits, labels, mask, weights = make_batch(b=b, c=117, seed=7)
    if loss == "garbage":
        labels = np.abs(labels)
    if case == "all_negative" and loss != "garbage":
        labels = -np.ones_like(labels)
    if case == "all_masked":
        mask = np.zeros_like(mask)
    if case == "masked_tail":
        mask = (np.arange(b) < 37).astype(np.float32)
    port_plain, port_fused = _port_all(loss, logits, labels, mask, weights,
                                       0.5)
    jax_plain, jax_fused = _jax_all(loss, logits, labels, mask, weights, 0.5)
    _check(port_plain, jax_plain, loss)
    _check(port_fused, jax_fused, loss)


def test_masked_rows_contribute_nothing():
    logits, labels, _, _ = make_batch(b=8, c=16)
    lg, lb = _t(logits, labels)
    mask = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.float32)
    head = pfl.entropic_openset_loss_fused(lg[:4], lb[:4], torch.ones(4))
    masked = pfl.entropic_openset_loss_fused(lg, lb, mask)
    assert float(masked[1]) == 4
    np.testing.assert_allclose(float(masked[0]), float(head[0]), rtol=1e-6)


def test_cpu_tensors_never_launch_kernels():
    logits, labels, mask, weights = make_batch(c=116)
    before = dict(pfl.LAUNCHES)
    _port_all("entropic", logits, labels, mask, weights, 1.0)
    _port_all("softmax", logits, labels, mask, weights, 1.0)
    _port_all("garbage", logits, np.abs(labels), mask, weights, 1.0)
    assert pfl.LAUNCHES == before


def test_kernel_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    logits, labels, mask, weights = make_batch(c=116)
    lg, lb, mk = _t(logits, labels, mask)
    for got, ref in ((pfl.entropic_sums(lg, lb, mk, 0.5),
                      pfl.entropic_sums_plain(lg, lb, mk, 0.5)),
                     (pfl.ce_sums(lg, lb, mk), pfl.ce_sums_plain(lg, lb, mk))):
        assert [float(v) for v in got] == [float(v) for v in ref]
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pfl.entropic_sums(meta, torch.zeros(4, dtype=torch.int32,
                                            device="meta"),
                          torch.ones(4, device="meta"), 1.0)


def test_average_meter_matches_jax():
    from openset_imagenet_tpu.ops.losses import AverageMeter as JMeter

    ours, ref = plosses.AverageMeter(), JMeter()
    for val, n in [(1.5, 4), (0.5, 2), (3.0, 0)]:
        ours.update(val, n)
        ref.update(val, n)
    assert (ours.val, ours.sum, ours.count, ours.avg) == \
        (ref.val, ref.sum, ref.count, ref.avg)
    assert repr(ours) == repr(ref)


def _port_loss(loss, lg, lb, mk, wt, w):
    if loss == "entropic":
        return pfl.entropic_openset_loss_fused(lg, lb, mk, w)
    if loss == "softmax":
        return pfl.softmax_loss_fused(lg, lb, mk)
    return pfl.garbage_loss_fused(lg, lb, wt, mk)


def _grads(loss, logits, labels, mask, weights, w, g=0.37):
    """(port autograd, jax.grad) of ``g * mean`` with respect to logits."""
    lg, lb, mk, wt = _t(logits, labels, mask, weights)
    lg.requires_grad_()
    (got,) = torch.autograd.grad(g * _port_loss(loss, lg, lb, mk, wt, w)[0],
                                 lg)
    jlb, jmk, jwt = jnp.asarray(labels), jnp.asarray(mask), \
        jnp.asarray(weights)
    jfn = {"entropic": lambda x: jfl.entropic_openset_loss_fused(
               x, jlb, jmk, w)[0],
           "softmax": lambda x: jfl.softmax_loss_fused(x, jlb, jmk)[0],
           "garbage": lambda x: jfl.garbage_loss_fused(x, jlb, jwt, jmk)[0]}
    ref = jax.grad(lambda x: g * jfn[loss](x))(jnp.asarray(logits))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("c", [8, 116, 1000])
@pytest.mark.parametrize("loss,w", [("entropic", 1.0), ("entropic", 0.5),
                                    ("softmax", 1.0), ("garbage", 1.0)])
def test_gradients_match_jax(loss, w, c):
    batch = make_batch(b=16, c=c, seed=c + 1,
                       label_low=0 if loss == "garbage" else -1)
    got, ref = _grads(loss, *batch, w)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    masked = batch[2] == 0
    assert masked.any() and np.all(got[masked] == 0)


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
@pytest.mark.parametrize("case", ["all_negative", "all_masked",
                                  "masked_tail"])
def test_edge_gradients_match_jax(loss, case):
    logits, labels, mask, weights = make_batch(b=64, c=117, seed=9)
    if loss == "garbage":
        labels = np.abs(labels)
    if case == "all_negative" and loss != "garbage":
        labels = -np.ones_like(labels)
    if case == "all_masked":
        mask = np.zeros_like(mask)
    if case == "masked_tail":
        mask = (np.arange(64) < 37).astype(np.float32)
    got, ref = _grads(loss, logits, labels, mask, weights, 0.5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert np.all(got[mask == 0] == 0)


@pytest.mark.parametrize("g", [1.0, 0.37])
@pytest.mark.parametrize("case", ["p1", "all_masked", "all_negative",
                                  "ragged"])
def test_entropic_plain_mean_and_grad_match_jax_vjp(case, g):
    """K1's and K2's plain versions as the kernels now compute them: the
    forward with its mean, and the gradient from the cotangent and the
    count, against the JAX fused loss and its custom VJP."""
    b = 300 if case == "ragged" else 64   # 300: two 256-row JAX blocks
    logits, labels, mask, _ = make_batch(b=b, c=116, seed=11)
    if case == "all_masked":
        mask = np.zeros_like(mask)
    if case == "all_negative":
        labels = -np.ones_like(labels)
    lg, lb, mk = _t(logits, labels, mask)
    loss_sum, count, mean = pfl.entropic_fwd_plain(lg, lb, mk, 0.5)
    assert torch.equal(mean, loss_sum / count.clamp(min=1.0))
    (jmean, jcount), vjp = jax.vjp(
        lambda x: jfl.entropic_openset_loss_fused(
            x, jnp.asarray(labels), jnp.asarray(mask), 0.5),
        jnp.asarray(logits))
    _check((mean, count), (jmean, jcount))
    if case == "all_masked":
        assert float(count) == 0 and float(mean) == 0
    (ref,) = vjp((jnp.float32(g), jnp.float32(0)))
    got = pfl.entropic_grad_plain(lg, lb, mk, torch.tensor(g), count, 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)
    assert np.all(got.numpy()[mask == 0] == 0)
    # The CPU wrappers and the autograd Function go through these plain
    # versions: the same bits.
    assert all(torch.equal(a, b) for a, b in zip(
        pfl.entropic_fwd(lg, lb, mk, 0.5), (loss_sum, count, mean)))
    x = lg.clone().requires_grad_()
    fused_mean, _ = pfl.entropic_openset_loss_fused(x, lb, mk, 0.5)
    (auto,) = torch.autograd.grad(fused_mean, x, torch.tensor(g))
    assert torch.equal(fused_mean.detach(), mean) and torch.equal(auto, got)


@pytest.mark.parametrize("g", [1.0, 0.37])
@pytest.mark.parametrize("case", ["softmax", "garbage", "all_zero_weights",
                                  "all_ignored", "ragged"])
def test_weighted_ce_plain_mean_and_grad_match_jax_vjp(case, g):
    """K3's and K4's plain versions as the kernels now compute them: the
    forward with its mean over ``max(wsum, 1e-12)``, and the gradient from
    the cotangent and the weight sum, against the JAX ``_weighted_ce_fused``
    and its custom VJP, behind the softmax and the garbage loss."""
    b = 300 if case == "ragged" else 64   # 300: two 256-row JAX blocks
    logits, labels, mask, weights = make_batch(b=b, c=117, seed=13)
    garbage = case in ("garbage", "ragged")
    if garbage:
        labels = np.abs(labels)
    if case == "all_zero_weights":   # every weight 0: the 1e-12 floor
        mask = np.zeros_like(mask)
    if case == "all_ignored":
        labels = -np.ones_like(labels)
    lg, lb, mk, wt = _t(logits, labels, mask, weights)
    row_w = (wt[lb.long().clamp(0, 116)] * mk if garbage
             else (lb >= 0).float() * mk)
    jrow = (jnp.asarray(weights)[jnp.clip(jnp.asarray(labels), 0, 116)]
            * jnp.asarray(mask) if garbage
            else (jnp.asarray(labels) >= 0).astype(jnp.float32)
            * jnp.asarray(mask))
    np.testing.assert_array_equal(row_w.numpy(), np.asarray(jrow))
    loss_sum, wsum, mean = pfl.ce_fwd_plain(lg, lb, row_w)
    assert torch.equal(mean, loss_sum / wsum.clamp(min=1e-12))
    (jmean, jwsum), vjp = jax.vjp(
        lambda x: jfl._weighted_ce_fused(x, jnp.asarray(labels), jrow),
        jnp.asarray(logits))
    _check((mean, wsum), (jmean, jwsum), "garbage")
    if case in ("all_zero_weights", "all_ignored"):
        assert float(wsum) == 0 and float(mean) == 0
    (ref,) = vjp((jnp.float32(g), jnp.float32(0)))
    got = pfl.ce_grad_plain(lg, lb, row_w, torch.tensor(g), wsum)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)
    assert np.all(got.numpy()[row_w.numpy() == 0] == 0)
    # A ready scale given as g with a weight sum of 1: the same bits.
    assert torch.equal(pfl.ce_grad_plain(
        lg, lb, row_w, torch.tensor(g) / wsum.clamp(min=1e-12),
        torch.tensor(1.0)), got)
    # The CPU wrappers and the autograd Function go through these plain
    # versions: the same bits.
    assert all(torch.equal(a, b) for a, b in zip(
        pfl.ce_fwd(lg, lb, row_w), (loss_sum, wsum, mean)))
    x = lg.clone().requires_grad_()
    fused_mean, _ = (pfl.garbage_loss_fused(x, lb, wt, mk) if garbage
                     else pfl.softmax_loss_fused(x, lb, mk))
    (auto,) = torch.autograd.grad(fused_mean, x, torch.tensor(g))
    assert torch.equal(fused_mean.detach(), mean) and torch.equal(auto, got)


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
def test_plain_backward_gradcheck(loss):
    logits, labels, mask, weights = make_batch(b=6, c=5, seed=3,
                                               label_low=-1)
    if loss == "garbage":
        labels = np.abs(labels)
    lg = torch.from_numpy(logits.astype(np.float64)).requires_grad_()
    lb, mk, wt = _t(labels, mask, weights)
    assert torch.autograd.gradcheck(
        lambda x: _port_loss(loss, x, lb, mk, wt, 0.5)[0], (lg,))


def test_no_gradient_to_count_labels_mask_or_weights():
    logits, labels, mask, weights = make_batch(b=8, c=16, label_low=0)
    lg, lb, mk, wt = _t(logits, labels, mask, weights)
    lg.requires_grad_()
    mk.requires_grad_()
    wt.requires_grad_()
    for loss in ("entropic", "softmax", "garbage"):
        mean, count = _port_loss(loss, lg, lb, mk, wt, 1.0)
        assert not count.requires_grad
        g_mask, g_w = torch.autograd.grad(mean, (mk, wt), allow_unused=True)
        assert g_mask is None and g_w is None
    before = dict(pfl.LAUNCHES)
    mean, _ = pfl.entropic_openset_loss_fused(lg, lb, mk.detach(), 1.0)
    mean.backward()
    assert pfl.LAUNCHES == before
