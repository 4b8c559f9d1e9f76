"""The port's Triton loss kernels against their plain versions, on the GPU.

Marked ``cuda``: skipped where there is no CUDA device or no Triton.  On a
GPU host run ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest imports
jax, which the GPU host need not have).  Tolerance: rtol 1e-5 on the sums
(another summation order than torch's reductions), counts exact; the
gradients (K2, K4) within rtol 1e-5, atol 1e-8, masked rows exactly 0.
"""

import importlib.util

import numpy as np
import pytest
import torch

from openset_imagenet_tpu_torch.ops import fused_loss as fl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if importlib.util.find_spec("triton") is None:
        pytest.skip("no triton")
    return torch.device("cuda")


def _batch(device, b, c, seed=0, low=-1):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(low, c, b).astype(np.int32)
                              ).to(device)
    mask = torch.from_numpy((rng.random(b) > 0.2).astype(np.float32)
                            ).to(device)
    return logits, labels, mask


def _close(got, ref):
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-6)


@pytest.mark.parametrize("b,c", [(64, 116), (256, 116), (256, 117),
                                 (1000, 1000), (5, 8), (4099, 3)])
@pytest.mark.parametrize("w", [1.0, 0.5])
def test_entropic_kernel_matches_plain(cuda, b, c, w):
    logits, labels, mask = _batch(cuda, b, c, seed=b + c)
    before = fl.LAUNCHES["entropic_fwd"]
    got = fl.entropic_sums(logits, labels, mask, w)
    assert fl.LAUNCHES["entropic_fwd"] == before + 1
    _close(got, fl.entropic_sums_plain(logits, labels, mask, w))


@pytest.mark.parametrize("b,c", [(64, 116), (256, 117), (1000, 1000),
                                 (4099, 3)])
def test_ce_kernel_matches_plain(cuda, b, c):
    logits, labels, mask = _batch(cuda, b, c, seed=b)
    weights = mask * torch.rand(b, device=cuda) + 0.1 * mask
    before = fl.LAUNCHES["ce_fwd"]
    got = fl.ce_sums(logits, labels.long(), weights)
    assert fl.LAUNCHES["ce_fwd"] == before + 1
    _close(got, fl.ce_sums_plain(logits, labels.long(), weights))


def test_two_launches_give_the_same_bits(cuda):
    logits, labels, mask = _batch(cuda, 1000, 1000)
    a = torch.stack(fl.entropic_sums(logits, labels, mask, 1.0))
    b = torch.stack(fl.entropic_sums(logits, labels, mask, 1.0))
    assert torch.equal(a, b)
    a = torch.stack(fl.ce_sums(logits, labels, mask))
    b = torch.stack(fl.ce_sums(logits, labels, mask))
    assert torch.equal(a, b)


def test_kernel_refuses_what_it_does_not_take(cuda):
    logits, labels, mask = _batch(cuda, 16, 10)
    with pytest.raises(TypeError, match="float32"):
        fl.ce_sums(logits.half(), labels, mask)
    with pytest.raises(TypeError, match="int32 or int64"):
        fl.ce_sums(logits, labels.float(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        fl.ce_sums(logits.t().contiguous().t(), labels, mask)
    with pytest.raises(ValueError, match="classes"):
        wide = torch.zeros(2, fl.MAX_CLASSES + 1, device=cuda)
        fl.ce_sums(wide, labels[:2], mask[:2])
    with pytest.raises(ValueError, match="scale"):
        fl.ce_grad(logits, labels, mask, torch.ones(1, device=cuda).double())


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
def test_public_losses_on_cuda_match_cpu(cuda, loss):
    logits, labels, mask = _batch(cuda, 256, 117, low=0 if loss == "garbage"
                                  else -1)
    weights = torch.rand(117, device=cuda) + 0.5
    fn = {"entropic": lambda *a: fl.entropic_openset_loss_fused(
              a[0], a[1], a[2], 0.5),
          "softmax": lambda *a: fl.softmax_loss_fused(a[0], a[1], a[2]),
          "garbage": lambda *a: fl.garbage_loss_fused(a[0], a[1], a[3],
                                                      a[2])}[loss]
    got = fn(logits, labels, mask, weights)
    ref = fn(logits.cpu(), labels.cpu(), mask.cpu(), weights.cpu())
    _close(got, ref)


def _scale(device, value=0.0123):
    return torch.tensor(value, dtype=torch.float32, device=device)


@pytest.mark.parametrize("b,c", [(256, 116), (64, 116), (64, 117),
                                 (1000, 1000), (5, 8), (4099, 3)])
@pytest.mark.parametrize("w", [1.0, 0.5])
def test_entropic_grad_kernel_matches_plain(cuda, b, c, w):
    logits, labels, mask = _batch(cuda, b, c, seed=b + c)
    before = fl.LAUNCHES["entropic_bwd"]
    got = fl.entropic_grad(logits, labels, mask, _scale(cuda), w)
    assert fl.LAUNCHES["entropic_bwd"] == before + 1
    again = fl.entropic_grad(logits, labels, mask, _scale(cuda), w)
    ref = fl.entropic_grad_plain(logits, labels, mask, _scale(cuda), w)
    assert got.dtype == logits.dtype and got.shape == logits.shape
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-8)
    assert torch.equal(got, again)
    assert bool((got[mask == 0] == 0).all())


@pytest.mark.parametrize("b,c", [(64, 116), (64, 117), (256, 117),
                                 (1000, 1000), (4099, 3)])
def test_ce_grad_kernel_matches_plain(cuda, b, c):
    logits, labels, mask = _batch(cuda, b, c, seed=b)
    weights = mask * torch.rand(b, device=cuda) + 0.1 * mask
    before = fl.LAUNCHES["ce_bwd"]
    got = fl.ce_grad(logits, labels.long(), weights, _scale(cuda))
    assert fl.LAUNCHES["ce_bwd"] == before + 1
    ref = fl.ce_grad_plain(logits, labels.long(), weights, _scale(cuda))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-8)
    assert bool((got[weights == 0] == 0).all())


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
def test_autograd_through_kernels_matches_cpu(cuda, loss):
    logits, labels, mask = _batch(cuda, 256, 117, low=0 if loss == "garbage"
                                  else -1)
    weights = torch.rand(117, device=cuda) + 0.5
    fn = {"entropic": lambda *a: fl.entropic_openset_loss_fused(
              a[0], a[1], a[2], 0.5),
          "softmax": lambda *a: fl.softmax_loss_fused(a[0], a[1], a[2]),
          "garbage": lambda *a: fl.garbage_loss_fused(a[0], a[1], a[3],
                                                      a[2])}[loss]
    grads = []
    for device in (cuda, torch.device("cpu")):
        lg = logits.to(device).requires_grad_()
        mean, _ = fn(lg, labels.to(device), mask.to(device),
                     weights.to(device))
        (g,) = torch.autograd.grad(0.37 * mean, lg)
        grads.append(g.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-8)


def test_train_step_on_cuda_goes_through_the_kernels(cuda):
    import numpy as np

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace

    model = engine.build_model(NameSpace({"model": {
        "variant": "tiny50", "bn_stats_rows": 4}}), 8).to(cuda)
    state = engine.create_state(model, engine.build_optimizer(
        NameSpace({"lr": 1e-3}), 1))
    step = engine.make_train_step(engine.make_loss_fn("entropic",
                                                      fused="auto"))
    rng = np.random.default_rng(0)
    before = dict(fl.LAUNCHES)
    state, m = step(state, rng.integers(0, 256, (8, 32, 32, 3), np.uint8),
                    rng.integers(-1, 8, 8).astype(np.int32),
                    np.ones(8, np.float32))
    assert fl.LAUNCHES["entropic_fwd"] == before["entropic_fwd"] + 1
    assert fl.LAUNCHES["entropic_bwd"] == before["entropic_bwd"] + 1
    assert np.isfinite(float(m["loss_sum"])) and float(m["count"]) == 8
