"""The port's kernels against their plain versions, on the GPU.

The Triton loss kernels (K1-K4), the CUDA C++ fused-bottleneck site (K5)
and split tail site (K6), both built with ``nvcc`` at first use, the
Triton streaming probes (K7), and the CUDA C++ int8 convolution of the
quantized serving graph (``int8_conv``, bit-equal to its plain version at
every resnet50 shape, ragged and grouped shapes and extreme operands; 52
launches a resnet50 int8 forward, whose output equals the same forward
through the plain version), and the Triton batch-norm kernels
(``ops/batch_norm.py``: the apply bit-equal to its plain version, the
statistics and backward against theirs, the model's train step and eval
forward against the written-out batch-norm, their launches and
refusals).  Marked ``cuda``: skipped where there is no
CUDA device (or, for the Triton kernels, no Triton).  On a
GPU host run ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest imports
jax, which the GPU host need not have).  Tolerance: rtol 1e-5 on the sums
(another summation order than torch's reductions), counts exact; the
gradients (K2, K4) within rtol 1e-5, atol 1e-8, masked rows exactly 0.
K1 and K3 are one launch per call and give the same bits over launches
and graph replays; K1's and K3's means and K2's and K4's in-kernel scales
have the bits of torch's division.
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


def _one_launch(kernel, cuda, b, c):
    """``(call, plain)`` of the one-launch forward ``kernel`` on a batch."""
    logits, labels, mask = _batch(cuda, b, c, seed=c)
    if kernel == "ce_fwd":
        weights = mask * torch.rand(b, device=cuda) + 0.1 * mask
        return (lambda: fl.ce_sums(logits, labels, weights),
                lambda: fl.ce_sums_plain(logits, labels, weights))
    return (lambda: fl.entropic_fwd(logits, labels, mask, 0.5),
            lambda: fl.entropic_fwd_plain(logits, labels, mask, 0.5))


def _kernel_names(fn, calls):
    """Device kernels ``calls`` calls of ``fn`` launch (torch.profiler).
    A window can miss its first launch, so each opens with a marker kernel
    (``torch.cuda._sleep``, left out of the names); and a window can come
    back empty, so the fullest of three counts (a window never holds a
    kernel that did not run)."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        window = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        names = max(names, window, key=len)
    return names


@pytest.mark.parametrize("kernel,b,c", [
    ("ce_fwd", 64, 117), ("ce_fwd", 256, 117), ("ce_fwd", 1000, 1000),
    ("ce_fwd", 4099, 3), ("entropic_fwd", 64, 116),
    ("entropic_fwd", 256, 116), ("entropic_fwd", 1000, 1000),
    ("entropic_fwd", 4099, 3)])
def test_ce_is_one_launch_with_the_same_bits_every_time(cuda, kernel, b, c):
    """K3 and K1: one kernel per call, the same bits over 50 launches and
    over a CUDA-graph replay of 20 calls, and the ticket counter back at
    0."""
    call, plain = _one_launch(kernel, cuda, b, c)
    first = torch.stack(call())
    _close(first, plain())
    for _ in range(50):
        assert torch.equal(torch.stack(call()), first)
    kernels = _kernel_names(call, 10)
    assert len(kernels) == 10, kernels
    assert all(f"{kernel}_once" in k for k in kernels), kernels
    # Warm the capture stream's ticket counter up before the capture.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    counters = len(fl._TICKETS)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph, stream=side):
        for _ in range(20):
            outs.append(call())
    assert len(fl._TICKETS) == counters   # nothing allocated in the graph
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(torch.stack(o), first) for o in outs)
    assert all(int(t.item()) == 0 for t in fl._TICKETS.values())


def _entropic_case(cuda, case):
    b, c = {"p1": (64, 116), "train": (256, 116), "ragged": (1000, 1000),
            "narrow": (4099, 3)}.get(case, (64, 116))
    logits, labels, mask = _batch(cuda, b, c, seed=b + c + 1)
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    if case == "all_negative":
        labels = -torch.ones_like(labels)
    return logits, labels, mask


ENTROPIC_CASES = ["p1", "train", "ragged", "narrow", "all_masked",
                  "all_negative"]


@pytest.mark.parametrize("case", ENTROPIC_CASES)
def test_entropic_mean_is_bit_equal_to_torch_division(cuda, case):
    """K1's in-kernel mean has the bits of ``sum / count.clamp(min=1)``."""
    logits, labels, mask = _entropic_case(cuda, case)
    loss_sum, count, mean = fl.entropic_fwd(logits, labels, mask, 0.5)
    assert torch.equal(mean, loss_sum / count.clamp(min=1.0))
    ref = fl.entropic_fwd_plain(logits, labels, mask, 0.5)
    _close((loss_sum, count), ref)
    np.testing.assert_allclose(float(mean), float(ref[2]), rtol=1e-5,
                               atol=1e-6)
    if case == "all_masked":
        assert float(count) == 0 and float(mean) == 0


@pytest.mark.parametrize("case", ENTROPIC_CASES)
def test_entropic_grad_in_kernel_scale_is_bit_equal(cuda, case):
    """K2 given (g, count) has the bits of K2 given the scale torch
    computes from them, ``g / count.clamp(min=1)``, and a count of 1."""
    logits, labels, mask = _entropic_case(cuda, case)
    g = torch.tensor(0.37, device=cuda)
    count = fl.entropic_sums(logits, labels, mask, 0.5)[1]
    got = fl.entropic_grad(logits, labels, mask, g, count, 0.5)
    given = fl.entropic_grad(logits, labels, mask, g / count.clamp(min=1.0),
                             torch.ones((), device=cuda), 0.5)
    assert torch.equal(got, given)
    ref = fl.entropic_grad_plain(logits, labels, mask, g, count, 0.5)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-8)
    assert bool((got[mask == 0] == 0).all())


def test_entropic_loss_is_one_launch_each_way(cuda):
    """The public entropic loss: forward + ``torch.autograd.grad`` launch
    K1 then K2 and nothing else; the forward under ``inference_mode`` (the
    eval step) launches K1 alone."""
    logits, labels, mask = _batch(cuda, 256, 116, seed=3)
    logits.requires_grad_()
    cotangent = torch.tensor(0.37, device=cuda)
    grads = []

    def train():
        mean, _ = fl.entropic_openset_loss_fused(logits, labels, mask, 0.5)
        grads.append(torch.autograd.grad(mean, logits, cotangent)[0])

    def evaluate():
        with torch.inference_mode():
            fl.entropic_openset_loss_fused(logits, labels, mask, 0.5)

    kernels = _kernel_names(train, 1)
    assert len(kernels) == 2, kernels
    assert "entropic_fwd_once" in kernels[0] and "entropic_bwd" in \
        kernels[1], kernels
    kernels = _kernel_names(evaluate, 1)
    assert len(kernels) == 1 and "entropic_fwd_once" in kernels[0], kernels
    count = fl.entropic_sums(logits.detach(), labels, mask, 0.5)[1]
    ref = fl.entropic_grad_plain(logits.detach(), labels, mask, cotangent,
                                 count, 0.5)
    torch.testing.assert_close(grads[-1], ref, rtol=1e-5, atol=1e-8)


def _ce_case(cuda, case):
    """A softmax or garbage batch and its row weights, as the public
    losses form them."""
    b, c = {"softmax": (64, 116), "garbage": (64, 117),
            "train": (256, 117), "ragged": (1000, 1000),
            "narrow": (4099, 3)}.get(case, (64, 117))
    low = -1 if case in ("softmax", "all_ignored") else 0
    logits, labels, mask = _batch(cuda, b, c, seed=b + c + 2, low=low)
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    if case == "all_ignored":
        labels = -torch.ones_like(labels)
    if case in ("softmax", "all_ignored"):
        return logits, labels, (labels >= 0).float() * mask
    class_w = torch.rand(c, device=cuda) + 0.2
    return logits, labels, class_w[labels.long().clamp(0, c - 1)] * mask


CE_CASES = ["softmax", "garbage", "train", "ragged", "narrow", "all_masked",
            "all_ignored"]


@pytest.mark.parametrize("case", CE_CASES)
def test_ce_mean_is_bit_equal_to_torch_division(cuda, case):
    """K3's in-kernel mean has the bits of ``sum / wsum.clamp(min=1e-12)``."""
    logits, labels, rows = _ce_case(cuda, case)
    loss_sum, wsum, mean = fl.ce_fwd(logits, labels, rows)
    assert torch.equal(mean, loss_sum / wsum.clamp(min=1e-12))
    ref = fl.ce_fwd_plain(logits, labels, rows)
    _close((loss_sum, wsum), ref)
    np.testing.assert_allclose(float(mean), float(ref[2]), rtol=1e-5,
                               atol=1e-6)
    if case in ("all_masked", "all_ignored"):
        assert float(wsum) == 0 and float(mean) == 0


@pytest.mark.parametrize("case", CE_CASES)
def test_ce_grad_in_kernel_scale_is_bit_equal(cuda, case):
    """K4 given (g, wsum) has the bits of K4 given the scale torch computes
    from them, ``g / wsum.clamp(min=1e-12)``, and a weight sum of 1."""
    logits, labels, rows = _ce_case(cuda, case)
    g = torch.tensor(0.37, device=cuda)
    wsum = fl.ce_sums(logits, labels, rows)[1]
    got = fl.ce_grad(logits, labels, rows, g, wsum)
    given = fl.ce_grad(logits, labels, rows, g / wsum.clamp(min=1e-12),
                       torch.ones((), device=cuda))
    assert torch.equal(got, given)
    ref = fl.ce_grad_plain(logits, labels, rows, g, wsum)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-8)
    assert bool((got[rows == 0] == 0).all())


@pytest.mark.parametrize("loss", ["softmax", "garbage"])
def test_weighted_ce_is_one_launch_each_way(cuda, loss):
    """The public softmax and garbage losses: forward + ``autograd.grad``
    launch K3 then K4 beside the row weights' own elementwise kernels,
    which run before the loss (formed as the JAX package forms them, and
    counted apart here); the forward under ``inference_mode`` launches the
    row weights' kernels and K3."""
    c = 116 if loss == "softmax" else 117
    logits, labels, mask = _batch(cuda, 64, c, seed=4,
                                  low=-1 if loss == "softmax" else 0)
    class_w = torch.rand(c, device=cuda) + 0.2
    logits.requires_grad_()
    cotangent = torch.tensor(0.37, device=cuda)
    fn = (lambda: fl.softmax_loss_fused(logits, labels, mask)
          if loss == "softmax"
          else fl.garbage_loss_fused(logits, labels, class_w, mask))
    grads = []

    def train():
        mean, _ = fn()
        grads.append(torch.autograd.grad(mean, logits, cotangent)[0])

    def evaluate():
        with torch.inference_mode():
            fn()

    kernels = _kernel_names(train, 1)
    loss_kernels = [k for k in kernels if "ce_fwd_once" in k or "ce_bwd" in k]
    assert len(loss_kernels) == 2 and "ce_fwd_once" in loss_kernels[0] and \
        "ce_bwd" in loss_kernels[1], kernels
    # Nothing after K3 but K4: the mean and the scale are the kernels' own.
    assert kernels[kernels.index(loss_kernels[0]) + 1:] == \
        loss_kernels[1:], kernels
    eval_kernels = _kernel_names(evaluate, 1)
    assert "ce_fwd_once" in eval_kernels[-1], eval_kernels
    assert sum("ce_" in k for k in eval_kernels) == 1, eval_kernels
    # The row weights' own kernels, the same count each way.
    assert len(kernels) - 2 == len(eval_kernels) - 1, (kernels, eval_kernels)
    rows = ((labels >= 0).float() * mask if loss == "softmax" else
            class_w[labels.long()] * mask)
    wsum = rows.sum()
    ref = fl.ce_grad_plain(logits.detach(), labels, rows, cotangent, wsum)
    torch.testing.assert_close(grads[-1], ref, rtol=1e-5, atol=1e-8)


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
    with pytest.raises(ValueError, match="g must be"):
        fl.ce_grad(logits, labels, mask, torch.ones(1, device=cuda).double(),
                   torch.ones(1, device=cuda))


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
    one = torch.ones((), device=cuda)   # the scale given as g / 1
    before = fl.LAUNCHES["entropic_bwd"]
    got = fl.entropic_grad(logits, labels, mask, _scale(cuda), one, w)
    assert fl.LAUNCHES["entropic_bwd"] == before + 1
    again = fl.entropic_grad(logits, labels, mask, _scale(cuda), one, w)
    ref = fl.entropic_grad_plain(logits, labels, mask, _scale(cuda), one, w)
    assert got.dtype == logits.dtype and got.shape == logits.shape
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-8)
    assert torch.equal(got, again)
    assert bool((got[mask == 0] == 0).all())


@pytest.mark.parametrize("b,c", [(64, 116), (64, 117), (256, 117),
                                 (1000, 1000), (4099, 3)])
def test_ce_grad_kernel_matches_plain(cuda, b, c):
    logits, labels, mask = _batch(cuda, b, c, seed=b)
    weights = mask * torch.rand(b, device=cuda) + 0.1 * mask
    one = torch.ones((), device=cuda)   # the scale given as g / 1
    before = fl.LAUNCHES["ce_bwd"]
    got = fl.ce_grad(logits, labels.long(), weights, _scale(cuda), one)
    assert fl.LAUNCHES["ce_bwd"] == before + 1
    ref = fl.ce_grad_plain(logits, labels.long(), weights, _scale(cuda), one)
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
        "variant": "tiny50", "bn_stats_rows": 4}}), 8)   # on the card
    assert next(model.parameters()).device.type == "cuda"
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


# -- K5: the fused bottleneck's pointwise backward site (CUDA C++) ----------
#
# Held to its plain version on the card: gp exactly; dW and the channel
# sums within rtol 1e-4 in norm (the same bf16 operands, another summation
# order); dx within rtol 2e-2, atol 1e-2 in bf16 and 1e-5 in f32 (the JAX
# package's kernel-vs-reference bound, tests/test_fused_block.py:65-69).

K5_FORMS = {"tail": (True, True, False, True),      # in_act, mask, ds, gp
            "head_ds": (False, False, True, False),
            "head": (False, False, False, False)}


@pytest.fixture
def cuda_k5():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k5_args(device, m, ci, co, dtype, form, seed=0):
    in_act, has_mask, has_ds, emit_gp = K5_FORMS[form]
    rng = np.random.default_rng(seed)
    t = lambda a, dt=dtype: torch.from_numpy(
        np.asarray(a, np.float32)).to(device=device, dtype=dt)
    args = [t(rng.standard_normal((m, co))), t(rng.standard_normal((m, co))),
            (torch.from_numpy(rng.integers(0, 2, (m, co)).astype(np.int8))
             .to(device) if has_mask else None),
            t(rng.standard_normal((m, ci))),
            t(rng.standard_normal((m, ci))) if has_ds else None,
            t(rng.standard_normal((ci, co)) * 0.3),
            t(rng.standard_normal(co), torch.float32),
            t(rng.standard_normal(co), torch.float32),
            t(rng.standard_normal(ci), torch.float32) if in_act else None,
            t(rng.standard_normal(ci), torch.float32) if in_act else None]
    return args, dict(in_act=in_act, emit_gp=emit_gp)


def _k5_close(got, ref, dtype):
    dx, gp, dw, so, si = got
    rdx, rgp, rdw, rso, rsi = ref
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert (gp is None) == (rgp is None)
    if gp is not None:
        assert torch.equal(gp, rgp)
    for a, b in [(dw, rdw), *zip(so, rso), *zip(si, rsi)]:
        if b is None:
            assert a is None
            continue
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-6
    tol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("shape", [(512, 16, 24), (300, 64, 256),
                                   (1000, 72, 40), (4096, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", sorted(K5_FORMS))
def test_k5_kernel_matches_plain(cuda_k5, form, dtype, shape):
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    args, kw = _k5_args(cuda_k5, *shape, dtype, form)
    before = fbb.LAUNCHES["fused_block_bwd"]
    got = fbb.bwd_site(*args, **kw)
    assert fbb.LAUNCHES["fused_block_bwd"] == before + 1
    again = fbb.bwd_site(*args, **kw)
    torch.cuda.synchronize()
    _k5_close(got, fbb.bwd_site_plain(*args, **kw), dtype)
    flat = lambda out: [t for t in (out[0], out[1], out[2], *out[3], *out[4])
                        if t is not None]
    for a, b in zip(flat(got), flat(again)):
        assert torch.equal(a, b)   # the same bits on a second launch


# Every pointwise site of resnet50 at 224 px, batch 256: (M, ci, co, form).
# The M = 802,816 sites take the fused route, the rest the tiled one.
RESNET50_SITES = [
    (802816, 64, 256, "tail"), (802816, 64, 64, "head"),
    (802816, 256, 64, "head_ds"), (802816, 256, 128, "head"),
    (200704, 128, 512, "tail"), (200704, 512, 128, "head_ds"),
    (200704, 512, 256, "head"), (50176, 256, 1024, "tail"),
    (50176, 1024, 256, "head_ds"), (50176, 1024, 512, "head"),
    (12544, 512, 2048, "tail"), (12544, 2048, 512, "head_ds")]


def _k5_device_args(device, m, ci, co, dtype, form, seed):
    """Site inputs drawn on the card (numpy is slow at 200 M values)."""
    in_act, has_mask, has_ds, emit_gp = K5_FORMS[form]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *s, dt=dtype, scale=1.0: (torch.randn(
        *s, generator=gen, device=device) * scale).to(dt)
    mask = (torch.randint(0, 2, (m, co), generator=gen, device=device)
            .to(torch.int8) if has_mask else None)
    args = [draw(m, co), draw(m, co), mask, draw(m, ci),
            draw(m, ci) if has_ds else None, draw(ci, co, scale=0.05),
            draw(co, dt=torch.float32), draw(co, dt=torch.float32),
            draw(ci, dt=torch.float32) if in_act else None,
            draw(ci, dt=torch.float32) if in_act else None]
    return args, dict(in_act=in_act, emit_gp=emit_gp)


def _k5_same_bits_and_close(fbb, args, kw, dtype):
    got = fbb.bwd_site(*args, **kw)
    again = fbb.bwd_site(*args, **kw)
    torch.cuda.synchronize()
    _k5_close(got, fbb.bwd_site_plain(*args, **kw), dtype)
    flat = lambda out: [t for t in (out[0], out[1], out[2], *out[3], *out[4])
                        if t is not None]
    for a, b in zip(flat(got), flat(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("site", RESNET50_SITES)
def test_k5_at_every_resnet50_site(cuda_k5, site):
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    m, ci, co, form = site
    args, kw = _k5_device_args(cuda_k5, m, ci, co, torch.bfloat16, form,
                               seed=m + ci + co)
    in_act, has_mask, has_ds, _ = K5_FORMS[form]
    route = fbb._plan(m, ci, co, torch.bfloat16, in_act, has_mask, has_ds,
                      True, fbb._sm_count(cuda_k5.index or 0))[0]
    assert route == ("fused" if m == 802816 else "tiled")
    _k5_same_bits_and_close(fbb, args, kw, torch.bfloat16)


# Ragged M on the fused and tiled routes, ragged channels on the generic.
@pytest.mark.parametrize("shape,form", [
    ((4099, 64, 256), "tail"), ((1003, 256, 64), "head_ds"),
    ((12544 + 77, 512, 2048), "tail"), ((1003, 72, 40), "head_ds")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_ragged_sites(cuda_k5, shape, form, dtype):
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    args, kw = _k5_device_args(cuda_k5, *shape, dtype, form, seed=sum(shape))
    _k5_same_bits_and_close(fbb, args, kw, dtype)


def test_k5_refuses_what_it_does_not_take(cuda_k5):
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    args, kw = _k5_args(cuda_k5, 64, 16, 32, torch.bfloat16, "tail")
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="z is on cpu"):
        fbb.bwd_site(*bad, **kw)
    bad = [a.half() if a is not None and a.dtype == torch.bfloat16 else a
           for a in args]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fbb.bwd_site(*bad, **kw)
    bad = list(args)
    bad[3] = args[3].t().contiguous().t()
    with pytest.raises(ValueError, match="row-major"):
        fbb.bwd_site(*bad, **kw)
    bad = list(args)
    bad[2] = args[2].bool()
    with pytest.raises(TypeError, match="mask must be torch.int8"):
        fbb.bwd_site(*bad, **kw)
    with pytest.raises(ValueError, match=r"w must be \(16, 32\)"):
        bad = list(args)
        bad[5] = args[5].t().contiguous()
        fbb.bwd_site(*bad, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("downsample,stride", [(False, 1), (True, 2)])
def test_block_autograd_kernel_matches_plain_site(cuda_k5, dtype, downsample,
                                                  stride):
    from openset_imagenet_tpu_torch.experimental import fused_block as fb

    rng = np.random.default_rng(5)
    f, cin = 16, (32 if downsample else 64)
    t = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(cuda_k5)
    args = dict(x0=t(4, cin, 14, 14).to(dtype).contiguous(
                    memory_format=torch.channels_last),
                w1=t(f, cin, 1, 1, scale=0.2), w2=t(f, f, 3, 3, scale=0.1),
                w3=t(4 * f, f, 1, 1, scale=0.2), mul1=t(f), add1=t(f),
                mul2=t(f), add2=t(f), mul3=t(4 * f), add3=t(4 * f))
    if downsample:
        args.update(wd=t(4 * f, cin, 1, 1, scale=0.2), muld=t(4 * f),
                    addd=t(4 * f))
    for v in args.values():
        v.requires_grad_()
    torch.backends.cudnn.deterministic = True
    grads = []
    for use_kernel in (None, False):
        out = fb.bottleneck_fused(**args, stride=stride,
                                  use_kernel=use_kernel)
        r = torch.ones_like(out).float() * 0.01
        grads.append(torch.autograd.grad((out.float() * r).sum(),
                                         list(args.values())))
    torch.backends.cudnn.deterministic = False
    bound = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip(args, *grads):
        diff = float((a.float() - b.float()).norm())
        assert diff <= bound * float(b.float().norm()) + 1e-6, name


def test_fused_train_step_on_cuda_goes_through_k5(cuda_k5):
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    model = engine.build_model(NameSpace({"model": {
        "variant": "tiny50", "bn_stats_rows": 4, "fused_blocks": True,
        "boundary_mask": True}}), 8).to(memory_format=torch.channels_last)
    state = engine.create_state(model, engine.build_optimizer(
        NameSpace({"lr": 1e-3}), 1))
    step = engine.make_train_step(engine.make_loss_fn("entropic"))
    rng = np.random.default_rng(0)
    before = fbb.LAUNCHES["fused_block_bwd"]
    state, m = step(state, rng.integers(0, 256, (8, 48, 48, 3), np.uint8),
                    rng.integers(-1, 8, 8).astype(np.int32),
                    np.ones(8, np.float32))
    assert fbb.LAUNCHES["fused_block_bwd"] == before + 2 * 4
    assert np.isfinite(float(m["loss_sum"]))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


# -- the worker on the card ---------------------------------------------------

def _worker_cfg(tmp_path, **over):
    """A tiny entropic run: 21 train rows at batch 8 (a 5-row tail), 14
    val rows, the synthetic reader, 32 px."""
    from openset_imagenet_tpu_torch.config import NameSpace

    rng = np.random.default_rng(0)
    for split, n in (("train", 21), ("val", 14)):
        labels = np.concatenate([np.arange(-1, 3),
                                 rng.integers(-1, 3, n - 4)])
        with open(tmp_path / f"p1_{split}.csv", "w") as f:
            f.writelines(f"n0/{split}_{i}.JPEG,{label}\n"
                         for i, label in enumerate(labels))
    cfg = {"name": "entropic", "log_name": "training.log",
           "data": {"imagenet_path": str(tmp_path),
                    "train_file": str(tmp_path / "p{}_train.csv"),
                    "val_file": str(tmp_path / "p{}_val.csv"),
                    "reader": "synthetic", "image_size": 32},
           "seed": 1, "batch_size": 8, "epochs": 2, "workers": 2,
           "loss": {"type": "entropic"}, "opt": {"type": "adam", "lr": 1e-3},
           "model": {"variant": "tiny", "bn_stats_rows": 4}, "protocol": 1,
           "output_directory": tmp_path / "out", **over}
    return NameSpace(cfg)


def test_worker_defaults_to_the_card(cuda, tmp_path):
    from openset_imagenet_tpu_torch import train as engine

    info = engine.worker(_worker_cfg(tmp_path, max_steps=1))
    assert info["device_ids"] == [torch.cuda.current_device()]
    assert info["stopped_mid_epoch"] == 1
    info = engine.worker(_worker_cfg(tmp_path, max_steps=1, gpu=0))
    assert info["device_ids"] == [0]


def test_tiny_worker_run_on_the_card(cuda, tmp_path):
    from openset_imagenet_tpu_torch import checkpoint
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.events import read_scalars

    cfg = _worker_cfg(tmp_path, opt={"type": "adam", "lr": 1e-3,
                                     "ema": 0.9, "accumulate_steps": 2})
    before = dict(fl.LAUNCHES)
    info = engine.worker(cfg)
    assert info["last_epoch"] == 1 and info["n_classes"] == 3
    assert np.isfinite(info["best_score"])
    # Three steps (the tail through its own window) and a validation of
    # two batches an epoch: K1 on every step and eval batch, K2 on every
    # train step.
    assert fl.LAUNCHES["entropic_fwd"] - before["entropic_fwd"] == 10
    assert fl.LAUNCHES["entropic_bwd"] - before["entropic_bwd"] == 6
    meta = checkpoint.read_metadata(cfg.output_directory /
                                    "entropic_curr.pth")
    assert (meta["epoch"], meta["step"]) == (2, 6)
    assert all(len(v) == 2 for v in read_scalars(
        cfg.output_directory).values())


# -- K6: the split tail-site backward (CUDA C++) ------------------------------
#
# Held to its plain version (the split's dataflow): gp exactly; dW and the
# four channel sums within 1e-4 in norm; dx within rtol 2e-2, atol 1e-2 in
# bf16 and rtol 1e-5, atol 1e-5 of its largest value in f32.  Against K5's
# unified site: gp exactly, dx within 8e-2 (bf16, the JAX test's bound) or
# 1e-5, dW and the sums within the same bounds in norm.


def _k6_args(device, m, ci, co, dtype, seed=0):
    args, _ = _k5_args(device, m, ci, co, dtype, "tail", seed)
    g, z, mask, x, _, w, mul_o, add_o, mul_i, add_i = args
    return [g, z, mask, x, w, mul_o, mul_i, add_i], add_o


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("shape", [(512, 16, 24), (300, 64, 256),
                                   (1000, 72, 40), (1003, 37, 21),
                                   (4096, 256, 64), (3000, 512, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_kernel_matches_plain_and_k5(cuda_k5, dtype, shape):
    _k6_matches_plain_and_k5(cuda_k5, dtype, shape)


# The four resnet50 tail widths (ci, co) at a reduced, ragged M.
@pytest.mark.parametrize("ci,co", [(64, 256), (128, 512), (256, 1024),
                                   (512, 2048)])
def test_k6_tensor_core_route_at_every_resnet50_tail_width(cuda_k5, ci, co):
    from openset_imagenet_tpu_torch.experimental import split_site as ss
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    m = 4096 + 77
    assert ss._plan(m, ci, co, torch.bfloat16, True,
                    fbb._sm_count(cuda_k5.index or 0)).route == \
        "tensor_cores"
    _k6_matches_plain_and_k5(cuda_k5, torch.bfloat16, (m, ci, co))


def _k6_matches_plain_and_k5(cuda_k5, dtype, shape):
    from openset_imagenet_tpu_torch.experimental import split_site as ss
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    args, add_o = _k6_args(cuda_k5, *shape, dtype)
    before = ss.LAUNCHES["split_site"]
    got = ss.tail_site_split(*args)
    assert ss.LAUNCHES["split_site"] == before + 1
    again = ss.tail_site_split(*args)
    torch.cuda.synchronize()
    flat = lambda out: [out[0], out[1], out[2], *out[3], *out[4]]
    for a, b in zip(flat(got), flat(again)):
        assert torch.equal(a, b)   # the same bits on a second launch
    dx, gp, dw, so, si = got
    rdx, rgp, rdw, rso, rsi = ss.tail_site_split_plain(*args)
    assert dx.dtype == gp.dtype == dtype and dw.dtype == torch.float32
    assert torch.equal(gp, rgp)
    for a, b in [(dw, rdw), *zip(so, rso), *zip(si, rsi)]:
        assert _rel_norm(a, b) <= 1e-4
    # In f32, atol 1e-5 of the largest |dx|: a 2048-deep f32 product summed
    # in another order than cuBLAS's is off by ~1e-6 of its terms, which
    # is more than 1e-5 of an entry that the sum cancels to near zero.
    tol = ((2e-2, 1e-2) if dtype == torch.bfloat16
           else (1e-5, 1e-5 * float(rdx.abs().max())))
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol[0],
                               atol=tol[1])
    g, z, mask, x, w, mul_o, mul_i, add_i = args
    udx, ugp, udw, uso, usi = fbb.bwd_site(g, z, mask, x, None, w, mul_o,
                                           add_o, mul_i, add_i, in_act=True,
                                           emit_gp=True)
    assert torch.equal(gp, ugp)
    tol = 8e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dx.float(), udx.float(), rtol=tol, atol=tol)
    for a, b in [(dw, udw), *zip(so, uso), *zip(si, usi)]:
        assert _rel_norm(a, b) <= tol


def test_k6_refuses_what_it_does_not_take(cuda_k5):
    from openset_imagenet_tpu_torch.experimental import split_site as ss

    args, _ = _k6_args(cuda_k5, 64, 16, 32, torch.bfloat16)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="z is on cpu"):
        ss.tail_site_split(*bad)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ss.tail_site_split(*[a.half() if a.dtype == torch.bfloat16 else a
                             for a in args])
    with pytest.raises(TypeError, match="out_dtype"):
        ss.tail_site_split(*args, out_dtype=torch.float32)
    bad = list(args)
    bad[3] = args[3].t().contiguous().t()
    with pytest.raises(ValueError, match="row-major"):
        ss.tail_site_split(*bad)


# -- K7: the streaming probes (Triton) ----------------------------------------


@pytest.mark.parametrize("shape", [(8, 3136, 256), (3, 1001, 256),
                                   (1, 7, 3)])
@pytest.mark.parametrize("probe", ["axpy", "relu_mask"])
def test_k7_kernel_matches_plain_bit_for_bit(cuda, probe, shape):
    from openset_imagenet_tpu_torch.ops import stream_probe as sp

    gen = torch.Generator(device=cuda).manual_seed(len(shape) + shape[1])
    a, b = (torch.randn(*shape, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    before = sp.LAUNCHES[f"stream_{probe}"]
    got = getattr(sp, probe)(a, b)
    assert sp.LAUNCHES[f"stream_{probe}"] == before + 1
    assert torch.equal(got, getattr(sp, f"{probe}_plain")(a, b))


def _every_bf16(device):
    return torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).reshape(1, 256, 256).to(device)


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


def test_k7_axpy_over_every_bf16_is_torch_add(cuda):
    """All 65,536 bf16 patterns of x: the kernel has the plain version's
    and ``torch.add(x, b)``'s bits wherever x is not NaN, NaN where it
    is."""
    from openset_imagenet_tpu_torch.ops import stream_probe as sp

    x = _every_bf16(cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    b = torch.randn(x.shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = sp.axpy(x, b)
    nan = torch.isnan(x)
    for ref in (sp.axpy_plain(x, b), torch.add(x, b)):
        assert _same_bits(got[~nan], ref[~nan])
    assert bool(torch.isnan(got[nan]).all())


def test_k7_relu_mask_over_every_bf16_mask(cuda):
    """All 65,536 bf16 patterns of the mask: the plain version's bits
    everywhere; ``threshold_backward``'s except on the 254 NaN masks,
    where the kernel gives 0."""
    from openset_imagenet_tpu_torch.ops import stream_probe as sp

    m = _every_bf16(cuda)
    gen = torch.Generator(device=cuda).manual_seed(13)
    g = torch.randn(m.shape, generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.where(g == 0, torch.ones_like(g), g)
    got = sp.relu_mask(g, m)
    assert _same_bits(got, sp.relu_mask_plain(g, m))
    differs = got.view(torch.int16) != torch.ops.aten.threshold_backward(
        g, m, 0).view(torch.int16)
    assert torch.equal(differs, torch.isnan(m))
    assert bool((got[differs] == 0).all())


@pytest.mark.parametrize("probe", ["axpy", "relu_mask"])
def test_k7_odd_size_and_offset_view(cuda, probe):
    """4097 elements, and views whose data pointers are 2 bytes past a
    16-byte boundary (storage offset 1): the plain version's bits."""
    from openset_imagenet_tpu_torch.ops import stream_probe as sp

    gen = torch.Generator(device=cuda).manual_seed(14)
    a, b = (torch.randn(3 * 4097 + 1, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    for x, y in ((a[:4097], b[:4097]), (a[1:], b[1:]),
                 (a[1:4098], b[1:4098])):
        assert x.is_contiguous() and (x.numel() == 4097
                                      or x.data_ptr() % 16 == 2)
        assert _same_bits(getattr(sp, probe)(x, y),
                          getattr(sp, f"{probe}_plain")(x, y))


@pytest.mark.parametrize("hint", ["none", "evict_first", "stream"])
@pytest.mark.parametrize("probe", ["axpy", "relu_mask"])
def test_k7_every_sweep_tile_and_grid_matches_plain(cuda, probe, hint):
    """Every tile and grid of the launch sweep, at a size where the
    persistent grids walk several tiles a program and end in a ragged
    tile: the plain version's bits."""
    from openset_imagenet_tpu_torch.ops import stream_probe as sp
    from openset_imagenet_tpu_torch.tools import bench_stream as tool

    n = 3 * 132 * 16384 + 4097
    gen = torch.Generator(device=cuda).manual_seed(15)
    a, b = (torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    want = getattr(sp, f"{probe}_plain")(a, b)
    for tile in tool.LAUNCH_SWEEP["tile"]:
        for waves in tool.LAUNCH_SWEEP["waves"]:
            launch = sp.Launch(tile, 4, waves, hint)
            got = getattr(sp, probe)(a, b, launch=launch)
            assert _same_bits(got, want), launch


def test_k7_refuses_what_it_does_not_take(cuda):
    from openset_imagenet_tpu_torch.ops import stream_probe as sp

    x = torch.zeros(2, 8, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        sp.axpy(x.float(), x.float())
    with pytest.raises(ValueError, match="one shape"):
        sp.relu_mask(x, x[:1])
    with pytest.raises(ValueError, match="operands on"):
        sp.axpy(x, x.cpu())


# -- extraction and OSCR on the card ------------------------------------------


@pytest.mark.parametrize("num_thresholds", [0, 1000])
def test_device_oscr_on_the_card_matches_numpy(cuda, num_thresholds):
    """``calculate_oscr_torch`` on CUDA tensors: the CPU run's bits, and at
    every numpy threshold the numpy ccr and fpr within 1e-6 (scores
    rounded through bfloat16, so scores and argmax tie)."""
    from openset_imagenet_tpu_torch.ops import oscr

    rng = np.random.default_rng(9)
    n, c = 5000, 117
    gt = rng.integers(-2, c, n)
    scores = torch.from_numpy(rng.dirichlet(np.ones(c) * 0.2, n).astype(
        np.float32)).bfloat16().float()
    got = [t.cpu() for t in oscr.calculate_oscr_torch(
        torch.from_numpy(gt).to(cuda), scores.to(cuda), unk_label=-1,
        num_thresholds=num_thresholds)]
    want = oscr.calculate_oscr_torch(gt, scores, unk_label=-1,
                                     num_thresholds=num_thresholds)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ccr, fpr, taus = (t.numpy() for t in got)
    ccr_np, fpr_np = oscr.calculate_oscr(gt, scores.numpy(), unk_label=-1)
    kn = gt >= 0
    ref_taus = np.unique(scores.numpy()[kn, gt[kn]])[:-1]
    found = np.isin(taus, ref_taus)
    idx = np.searchsorted(ref_taus, taus[found])
    np.testing.assert_allclose(ccr[found], ccr_np[idx], rtol=0, atol=1e-6)
    np.testing.assert_allclose(fpr[found], fpr_np[idx], rtol=0, atol=1e-6)
    assert found.sum() >= min(len(ref_taus), num_thresholds or n) // 2


def test_get_arrays_on_the_card_matches_the_cpu(cuda):
    """``get_arrays`` of a tiny bf16 model on the card against the same
    model on the CPU: labels equal and float32, the masked rows dropped,
    scores within 2e-2 and logits and features within 2e-2 of their
    largest value (cuDNN and the CPU round bf16 convolutions apart)."""
    import types

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace

    cfg = NameSpace({"model": {"variant": "tiny"}})
    cpu = engine.build_model(cfg, 5, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    card = engine.build_model(cfg, 5, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    batches = []
    for i in range(3):
        mask = np.ones(16, np.float32)
        if i == 2:
            mask[11:] = 0
        batches.append(types.SimpleNamespace(
            images=rng.integers(0, 256, (16, 32, 32, 3), np.uint8),
            labels=rng.integers(-2, 5, 16).astype(np.int32), mask=mask))
    pipe = types.SimpleNamespace(epoch=lambda e: iter(batches))
    got = engine.get_arrays(card, pipe)
    want = engine.get_arrays(cpu, pipe)
    assert got[0].dtype == np.float32 and got[0].shape == (43,)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * np.abs(w).max())
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=2e-2)


# -- prediction paths and the daemon on the card --------------------------------


@pytest.fixture
def tiny_ckpt(tmp_path):
    """A tiny float32 two-head ResNet with random weights, saved as a
    reference-layout ``.pth`` (no arch metadata: load with
    ``variant="tiny"``)."""
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.checkpoint import save_checkpoint
    from openset_imagenet_tpu_torch.config import NameSpace

    model = engine.build_model(NameSpace({"model": {"variant": "tiny"}}), 5,
                               dtype=torch.float32, device="cpu",
                               generator=torch.Generator().manual_seed(4))
    path = tmp_path / "tiny.pth"
    save_checkpoint(path, model, epoch=0, best_score=0.0)
    return path


def _f32_predictors(path, monkeypatch, device):
    from openset_imagenet_tpu_torch import inference
    from openset_imagenet_tpu_torch import train as engine

    monkeypatch.setattr(inference, "build_model",
                        lambda cfg, n, **kw: engine.build_model(
                            cfg, n, dtype=torch.float32, **kw))
    return (inference.OpenSetPredictor(path, variant="tiny", image_size=32,
                                       device=device),
            inference.OpenSetPredictor(path, variant="tiny", image_size=32,
                                       device="cpu"))


def test_predictor_on_the_card_matches_the_cpu(cuda, tiny_ckpt, monkeypatch):
    """float32 without TF32: the card's scores and features within 1e-4
    of the CPU predictor's on the same synthetic pixels, the classes equal
    away from near-ties; both modes, a threshold."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    card, cpu = _f32_predictors(tiny_ckpt, monkeypatch, cuda)
    images = np.random.default_rng(6).integers(0, 256, (13, 32, 32, 3),
                                               np.uint8)
    for mode in ("softmax", "objectosphere"):
        for p in (card, cpu):
            p.mode, p.threshold = mode, 0.0
        got = card.predict(images, return_arrays=True)
        want = cpu.predict(images, return_arrays=True)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[2]).max())
        top2 = np.sort(want[3], -1)[:, -2:]
        for i in np.nonzero(got[0] != want[0])[0]:
            assert top2[i, 1] - top2[i, 0] < 1e-4
    assert card.bucket_warm(13) and not card.bucket_warm(17)


def test_predict_stream_on_the_card_is_bitwise_per_chunk_predict(
        cuda, tiny_ckpt, tmp_path):
    """The pipelined stream on the card (pinned staging, asynchronous
    copies) gives the bits of per-chunk ``predict``, in input order."""
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor
    from openset_imagenet_tpu_torch.pipeline import SyntheticReader

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pred = OpenSetPredictor(tiny_ckpt, variant="tiny", image_size=32,
                                device=cuda,
                                reader=SyntheticReader(crop=32, seed=0))
        paths = [f"img_{i}.jpg" for i in range(21)]
        got = list(pred.predict_stream(paths, batch_size=8,
                                       return_arrays=True))
        assert [g[0] for g in got] == [paths[i:i + 8] for i in (0, 8, 16)]
        for chunk, *results in got:
            for g, w in zip(results, pred.predict(chunk,
                                                  return_arrays=True)):
                np.testing.assert_array_equal(g, w)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_daemon_round_trip_on_the_card(cuda, tiny_ckpt):
    """``PredictionServer`` around a predictor on the card, with a decode
    of raw pixel bodies: a single request and a JSON batch equal the
    predictor's answer for the same pixels at the same bucket."""
    import base64
    import json
    import urllib.request

    from openset_imagenet_tpu_torch.inference import OpenSetPredictor
    from openset_imagenet_tpu_torch.serve import PredictionServer

    class RawServer(PredictionServer):
        def decode(self, blobs):
            return [np.frombuffer(b, np.uint8).reshape(32, 32, 3)
                    for b in blobs]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pred = OpenSetPredictor(tiny_ckpt, variant="tiny", image_size=32,
                            device=cuda)
    # The window gathers the JSON batch's five images into one forward.
    srv = RawServer(("127.0.0.1", 0), pred, max_batch=8,
                    window_ms=50.0).start()
    try:
        host, port = srv.server_address[:2]
        images = np.random.default_rng(3).integers(0, 256, (5, 32, 32, 3),
                                                   np.uint8)

        def post(body, ctype):
            req = urllib.request.Request(
                f"http://{host}:{port}/v1/predict?features=1", data=body,
                method="POST", headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        one = post(images[0].tobytes(), "application/octet-stream")
        cls, score = pred.predict(images[:1])
        assert one["prediction"] == int(cls[0])
        assert one["score"] == float(score[0])
        batch = post(json.dumps({"images": [
            base64.b64encode(im.tobytes()).decode() for im in images]}
        ).encode(), "application/json")["results"]
        cls, score, feats = pred.predict(images, return_features=True)
        assert [r["prediction"] for r in batch] == [int(c) for c in cls]
        assert [r["score"] for r in batch] == [float(s) for s in score]
        assert len(batch[0]["features"]) == 5
    finally:
        srv.close()
        torch.backends.cudnn.deterministic = deterministic


# -- int8_conv: the quantized serving graph's convolution ----------------------

def _i8_operands(device, b, h, cin, cout, k, groups, seed=0, extreme=False):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (b, h, h, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (cout, k, k, cin // groups)).astype(np.int8)
    if extreme:  # the largest sums, and channels that are all zero
        q[...] = 127
        w[...] = -127
        q[..., ::5] = 0
        w[::3] = 0
    scale = (rng.random(cout) * 1e-4 + 1e-6).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(q), t(w), t(scale), t(bias)


def _i8_same(device, b, h, cin, cout, k, stride, groups=1, seed=0,
             dtype=torch.bfloat16, extreme=False):
    from openset_imagenet_tpu_torch.ops import int8_conv as ic

    q, w, scale, bias = _i8_operands(device, b, h, cin, cout, k, groups,
                                     seed, extreme)
    pad = 1 if k == 3 else 0
    before = ic.LAUNCHES["int8_conv"]
    got = ic.int8_conv(q, w, scale, bias, stride, pad, groups, dtype)
    torch.cuda.synchronize()
    assert ic.LAUNCHES["int8_conv"] == before + 1
    want = ic.int8_conv_plain(q, w, scale, bias, stride, pad, groups, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.fixture
def cuda_i8():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _resnet50_shapes():
    from openset_imagenet_tpu_torch.ops.int8_conv import resnet50_shapes

    return sorted(resnet50_shapes(224))


@pytest.mark.parametrize("shape", _resnet50_shapes())
def test_int8_conv_at_every_resnet50_shape(cuda_i8, shape):
    h, cin, cout, k, stride = shape
    _i8_same(cuda_i8, 2, h, cin, cout, k, stride, seed=h + cin + cout)


@pytest.mark.parametrize("b,h,cin,cout,k,stride,groups", [
    (3, 13, 64, 64, 3, 1, 1), (1, 7, 128, 72, 1, 1, 1),
    (5, 9, 64, 256, 3, 2, 1),
    (2, 56, 128, 128, 3, 1, 32), (2, 56, 256, 256, 3, 2, 32),
    (2, 14, 1024, 1024, 3, 2, 32), (2, 8, 16, 16, 3, 1, 4),
    (2, 9, 6, 10, 3, 2, 2), (2, 11, 96, 40, 1, 1, 1)])
def test_int8_conv_ragged_and_grouped(cuda_i8, b, h, cin, cout, k, stride,
                                      groups):
    _i8_same(cuda_i8, b, h, cin, cout, k, stride, groups, seed=b * h)


@pytest.mark.parametrize("shape", [(56, 64, 64, 3, 1), (7, 2048, 512, 1, 1),
                                   (14, 1024, 2048, 1, 2)])
def test_int8_conv_extreme_operands_and_float32(cuda_i8, shape):
    h, cin, cout, k, stride = shape
    _i8_same(cuda_i8, 2, h, cin, cout, k, stride, extreme=True)
    _i8_same(cuda_i8, 2, h, cin, cout, k, stride, dtype=torch.float32)


def test_int8_conv_refuses_what_it_does_not_take(cuda_i8):
    from openset_imagenet_tpu_torch.ops import int8_conv as ic

    q, w, scale, bias = _i8_operands(cuda_i8, 2, 8, 64, 64, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ic.int8_conv(q.permute(0, 2, 1, 3), w, scale, bias, 1, 1)
    with pytest.raises(TypeError, match="int8"):
        ic.int8_conv(q.float(), w, scale, bias, 1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        ic.int8_conv(q, w, scale, bias, 1, 1, groups=2)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ic.int8_conv(q, w, scale, bias, 1, 1, dtype=torch.float16)


def test_int8_resnet50_forward_goes_through_the_kernel(cuda_i8,
                                                       monkeypatch):
    """A resnet50 at 224 px, folded and quantized on the card: one int8
    forward launches int8_conv 52 times, and gives the bits of the same
    forward with every conv through the plain version."""
    from openset_imagenet_tpu_torch import optimize
    from openset_imagenet_tpu_torch.models import quant
    from openset_imagenet_tpu_torch.models.resnet import build_resnet
    from openset_imagenet_tpu_torch.ops import int8_conv as ic

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = build_resnet("resnet50", fc_layer_dim=16, out_features=16,
                             device=cuda_i8)
        images = np.random.default_rng(5).integers(0, 256,
                                                   (4, 224, 224, 3),
                                                   np.uint8)
        qmodel = optimize.quantize_inference(model, [images])
        qmodel = qmodel.to(memory_format=torch.channels_last)
        x = torch.from_numpy(images[:2]).to(cuda_i8).float() / 255
        ic.LAUNCHES["int8_conv"] = 0
        with torch.inference_mode():
            logits, feats = qmodel(x)
            torch.cuda.synchronize()
            assert ic.LAUNCHES["int8_conv"] == 52
            monkeypatch.setattr(quant, "int8_conv", ic.int8_conv_plain)
            plain_logits, plain_feats = qmodel(x)
        assert torch.isfinite(logits).all()
        assert torch.equal(logits, plain_logits)
        assert torch.equal(feats, plain_feats)
    finally:
        torch.backends.cudnn.deterministic = deterministic


# -- the batch-norm kernels (ops/batch_norm.py, Triton) ----------------------
#
# The apply bit-equal to its plain version given the same statistics, in
# both forms, layouts and in bfloat16, float16 and float32; the statistics
# and running statistics within float32 rounding (another summation order,
# rtol 1e-5); the backward against bn_grad_plain (dx bit-equal outside the
# window, within 1e-3 in norm inside it in bfloat16, the share rounding
# differently where its sums differ in the last bit; dweight and dbias
# within 1e-5 in norm) and against autograd of the written-out path; every
# launch twice with the same bits.

BN_SHAPES = [(8, 64, 14, 14), (7, 48, 5, 3), (4, 200, 6, 6), (3, 2048, 7, 7),
             (2, 8, 9, 9)]


def _bn_same(a, b):
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(view), b.view(view)))


def _bn_case(device, shape, dtype, layout, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    draw = lambda scale, shift: (torch.randn(*shape, generator=gen,
                                             device=device) * scale + shift
                                 ).to(dtype).contiguous(memory_format=fmt)
    vec = lambda lo, hi: torch.rand(c, generator=gen, device=device) * (
        hi - lo) + lo
    return (draw(2.0, 0.5), draw(1.0, 0.0), vec(0.5, 1.5), vec(-0.1, 0.1),
            vec(-0.1, 0.1), vec(0.5, 1.5))


@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("ghost", [True, False])
def test_bn_apply_is_bit_equal_to_plain(cuda, shape, dtype, layout, ghost):
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, _, w, b, mean, var = _bn_case(cuda, shape, dtype, layout)
    before = bnk.LAUNCHES["bn_apply"]
    y = bnk.bn_apply(x, mean, var, w, b, 1e-5, ghost)
    assert bnk.LAUNCHES["bn_apply"] == before + 1
    assert y.stride() == x.stride()
    assert _bn_same(y, bnk.bn_apply_plain(x, mean, var, w, b, 1e-5, ghost))
    assert _bn_same(y, bnk.bn_apply(x, mean, var, w, b, 1e-5, ghost))


@pytest.mark.parametrize("shape", BN_SHAPES + [(256, 64, 56, 56)])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("rows", [1, 3, 0])
def test_bn_stats_match_plain(cuda, shape, layout, rows):
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, _, _, _, rm, rv = _bn_case(cuda, shape, torch.bfloat16, layout)
    window = min(rows, shape[0]) or shape[0]
    got_rm, got_rv, ref_rm, ref_rv = rm.clone(), rv.clone(), rm.clone(), \
        rv.clone()
    got = bnk.bn_stats(x, window, got_rm, got_rv, 0.9)
    ref = bnk.bn_stats_plain(x, window, ref_rm, ref_rv, 0.9)
    torch.testing.assert_close(got[:2], ref[:2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_rm, ref_rm, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got_rv, ref_rv, rtol=1e-5, atol=1e-7)
    again = bnk.bn_stats(x, window, rm.clone(), rv.clone(), 0.9)
    assert torch.equal(got, again)


def _bn_rel(a, b):
    return float((a.float() - b.float()).norm()
                 / max(float(b.float().norm()), 1e-30))


@pytest.mark.parametrize("shape", BN_SHAPES + [(256, 256, 28, 28)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("rows", [0, 1, 3, 1000])
def test_bn_backward_matches_plain(cuda, shape, dtype, layout, rows):
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, g, w, _, rm, rv = _bn_case(cuda, shape, dtype, layout, seed=rows)
    window = min(rows, shape[0]) or shape[0]
    stats = bnk.bn_stats_plain(x, window, rm, rv, 0.9)
    ghost = rows > 0
    before = dict(bnk.LAUNCHES)
    got = bnk.bn_backward(g, x, w, stats, window, ghost, 1e-5)
    assert bnk.LAUNCHES["bn_bwd"] == before["bn_bwd"] + 1
    assert bnk.LAUNCHES["bn_fix"] == before["bn_fix"] + 1
    ref = bnk.bn_grad_plain(g, x, w, stats, window, ghost, 1e-5)
    assert got[0].stride() == x.stride()
    assert _bn_same(got[0][window:], ref[0][window:])
    assert _bn_rel(got[0][:window], ref[0][:window]) <= (
        1e-3 if dtype == torch.bfloat16 else 1e-5)
    for a, r in zip(got[1:], ref[1:]):
        assert _bn_rel(a, r) <= 1e-5
    again = bnk.bn_backward(g, x, w, stats, window, ghost, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # Without a window (eval): the direct term alone, bit for bit.
    got = bnk.bn_backward(g, x, w, stats[:2].contiguous(), 0, ghost, 1e-5)
    ref = bnk.bn_grad_plain(g, x, w, stats[:2], 0, ghost, 1e-5)
    assert _bn_same(got[0], ref[0])
    assert _bn_rel(got[1], ref[1]) <= 1e-5


@pytest.mark.parametrize("rows", [0, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training", [True, False])
def test_bn_module_on_the_card_against_the_written_out_path(
        cuda, rows, dtype, training):
    """The module through the kernels against ``use_kernel=False``: the
    output bit-equal in eval (and given the statistics, above), the
    running statistics within float32 rounding, gradients by the CPU
    tests' bounds (the ghost form's bfloat16 sums in autograd)."""
    from openset_imagenet_tpu_torch.models.norm import BatchNorm
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, g, w, b, rm, rv = _bn_case(cuda, (8, 64, 14, 14), dtype,
                                  "channels_last", seed=9)
    out = []
    for use_kernel in (True, False):
        bn = BatchNorm(64, stats_rows=rows, device=cuda).train(training)
        with torch.no_grad():
            for p, v in ((bn.weight, w), (bn.bias, b), (bn.running_mean, rm),
                         (bn.running_var, rv)):
                p.copy_(v)
        bn.use_kernel = use_kernel
        before = dict(bnk.LAUNCHES)
        xg = x.clone().requires_grad_()
        y = bn(xg)
        torch.autograd.backward(y, g)
        launched = {k: bnk.LAUNCHES[k] - before[k] for k in before}
        out.append((y, bn.running_mean.clone(), bn.running_var.clone(),
                    xg.grad, bn.weight.grad, bn.bias.grad, launched))
    got, ref = out
    assert got[6] == {"bn_stats": int(training), "bn_apply": 1,
                      "bn_bwd": 1, "bn_fix": int(training)}
    assert not any(ref[6].values())
    if not training:
        assert _bn_same(got[0], ref[0])
    assert _bn_rel(got[0], ref[0]) <= (4e-3 if dtype == torch.bfloat16
                                       else 1e-5)
    for a, r in zip(got[1:3], ref[1:3]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-7)
    bound = (1e-2, 5e-2, 5e-2) if rows and dtype == torch.bfloat16 else \
        (1e-4, 1e-4, 1e-4)
    for a, r, t in zip(got[3:6], ref[3:6], bound):
        assert float((a.float() - r.float()).abs().max()) <= t * float(
            r.float().abs().max())


def _bn_model_step(model, images, labels, use_kernel):
    """Loss, logits and every parameter's gradient of one training
    forward and backward, the batch-norms through the kernels (True, on
    CUDA tensors) or written out (False)."""
    from openset_imagenet_tpu_torch.models.norm import BatchNorm
    from openset_imagenet_tpu_torch.ops import fused_loss

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.use_kernel = use_kernel
    model.train()
    model.zero_grad(set_to_none=True)
    logits, _ = model(images)
    loss, _ = fused_loss.entropic_openset_loss_fused(
        logits, labels, torch.ones_like(labels, dtype=torch.float32))
    loss.backward()
    return loss.detach(), logits.detach(), {
        n: p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("variant,size,batch,ghost,dtype,bound,exact", [
    ("tiny50", 32, 8, 2, torch.float32, 1e-4, True),
    ("resnet50", 224, 256, 64, torch.bfloat16, 2e-2, False),
    ("resnet50", 112, 16, 16, torch.bfloat16, 2e-2, True)])
def test_bn_model_train_step_against_the_written_out_path(
        cuda, variant, size, batch, ghost, dtype, bound, exact):
    """One training step's gradients through the kernels against the
    written-out batch-norm, from one state (cuDNN deterministic, no TF32).

    Every parameter's gradient within ``bound`` relative in norm of the
    written-out path's (resnet50 at chip_smoke.py phase 5's
    configuration, batch 256, 224 px, a window of 64 images, by its
    model-level rule, 2e-2).  With ``exact``, the same step also runs in
    float64 on the CPU, written out, and each kernel gradient is no
    further from that witness than the written-out path's by more than
    ``bound``, and within ``bound`` of the written-out path's or nearer
    the witness.  tiny50 in float32 takes the second arm: the written-out
    path forms ``dweight`` as ``inv * (sum g x - mean * sum g)``, which
    cancels in float32 (the kernels sum ``g * (x - mean)``).  resnet50 at
    112 px and a window of 16 images in bfloat16 lies ~0.2 from the
    witness on both paths, the stem's gradients amplifying the forward's
    roundings.  The loss within 1e-2; two kernel steps bitwise equal; one
    launch of each kernel per batch-norm."""
    import copy

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.models.norm import BatchNorm
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    model = engine.build_model(NameSpace({"model": {
        "variant": variant, "bn_stats_rows": ghost}}), 116, dtype=dtype).to(
        memory_format=torch.channels_last)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.random((batch, size, size, 3)).astype(
        np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(-1, 116, batch).astype(
        np.int32)).to(cuda)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        state = copy.deepcopy(model.state_dict())
        before = dict(bnk.LAUNCHES)
        k1 = _bn_model_step(model, images, labels, True)
        assert {k: bnk.LAUNCHES[k] - before[k] for k in before} == {
            k: n_bn for k in before}
        model.load_state_dict(state)
        k2 = _bn_model_step(model, images, labels, True)
        model.load_state_dict(state)
        plain = _bn_model_step(model, images, labels, False)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    witness = {}
    if exact:
        ref = engine.build_model(NameSpace({"model": {
            "variant": variant, "bn_stats_rows": ghost}}), 116,
            dtype=torch.float64, device="cpu")
        ref.load_state_dict(state)
        witness = _bn_model_step(ref, images.cpu(), labels.cpu(), False)[2]
    assert torch.equal(k1[1], k2[1])
    assert all(torch.equal(k1[2][n], k2[2][n]) for n in k1[2])
    assert abs(float(k1[0]) - float(plain[0])) <= 1e-2 * abs(float(plain[0]))
    for name, grad in plain[2].items():
        gap = _bn_rel(k1[2][name], grad)
        if not exact:
            assert gap <= bound, (name, gap)
            continue
        got = _bn_rel(k1[2][name].cpu(), witness[name])
        ref = _bn_rel(grad.cpu(), witness[name])
        assert gap <= bound or got < ref, (name, gap, got, ref)
        assert got <= ref + bound, (name, gap, got, ref)


def test_bn_eval_forward_is_bit_equal_and_one_launch_a_norm(cuda):
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.models.norm import BatchNorm
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    model = engine.build_model(NameSpace({"model": {
        "variant": "resnet50", "bn_stats_rows": 4}}), 8).to(
        memory_format=torch.channels_last)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in norms:   # running statistics away from (0, 1)
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=gen) + 0.5)
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (16, 112, 112, 3), np.uint8)).to(cuda)
    step = engine.make_forward_step()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = []
        for use_kernel in (True, False):
            for m in norms:
                m.use_kernel = use_kernel
            before = dict(bnk.LAUNCHES)
            outs.append(step(model, images))
            launched = {k: bnk.LAUNCHES[k] - before[k] for k in before}
            assert launched == ({"bn_stats": 0, "bn_apply": len(norms),
                                 "bn_bwd": 0, "bn_fix": 0}
                                if use_kernel else
                                dict.fromkeys(before, 0))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_bn_predict_chunk_goes_through_the_apply_kernel(cuda, tiny_ckpt):
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor
    from openset_imagenet_tpu_torch.models.norm import BatchNorm
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    pred = OpenSetPredictor(tiny_ckpt, variant="tiny", image_size=32,
                            device=cuda)
    n_bn = sum(isinstance(m, BatchNorm) for m in pred.model.modules())
    images = np.random.default_rng(2).integers(0, 256, (9, 32, 32, 3),
                                               np.uint8)
    before = dict(bnk.LAUNCHES)
    pred.predict(images)
    assert {k: bnk.LAUNCHES[k] - before[k] for k in before} == {
        "bn_stats": 0, "bn_apply": n_bn, "bn_bwd": 0, "bn_fix": 0}


def test_bn_kernels_refuse_what_they_do_not_take(cuda):
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, g, w, b, rm, rv = _bn_case(cuda, (4, 16, 6, 6), torch.bfloat16,
                                  "channels_last")
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        bnk.bn_apply(x.double(), rm, rv, w, b, 1e-5, True)
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        bnk.bn_apply(x.permute(0, 1, 3, 2), rm, rv, w, b, 1e-5, True)
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        bnk.bn_stats(x[:, ::2], 2, rm[:8].clone(), rv[:8].clone(), 0.9)
    with pytest.raises(ValueError, match="float32"):
        bnk.bn_apply(x, rm.double(), rv, w, b, 1e-5, False)
    with pytest.raises(ValueError, match="on cuda"):
        bnk.bn_apply(x, rm.cpu(), rv, w, b, 1e-5, False)
    stats = bnk.bn_stats(x, 2, rm.clone(), rv.clone(), 0.9)
    with pytest.raises(ValueError, match="does not match"):
        bnk.bn_backward(g.float(), x, w, stats, 2, True, 1e-5)
    with pytest.raises(ValueError, match="stats must be"):
        bnk.bn_backward(g, x, w, stats[:2], 2, True, 1e-5)
    # An expanded output gradient (stride 0) is taken as it is.
    ones = torch.ones((), dtype=x.dtype, device=cuda).expand(x.shape)
    got = bnk.bn_backward(ones, x, w, stats, 2, True, 1e-5)
    ref = bnk.bn_grad_plain(ones, x, w, stats, 2, True, 1e-5)
    assert _bn_same(got[0][2:], ref[0][2:])



def test_swin_train_step_against_the_float32_reference(cuda):
    """A bf16 train step of a tiny Swin on the card (32 px, embedding 32,
    depths (2, 2), heads (2, 4), window 4: stage 1 shifted, stage 2 one
    window; the masked attention through ``F.scaled_dot_product_attention``,
    the loss through K1 and K2) against the benchmark's float32 reference
    on the card (TF32 off): the logits within 2 % of their norm (the CPU
    tests' bf16 rule, ``tests/test_torch_swin.py``), the loss within 1e-3,
    every leaf's gradient within 10 % of the larger of its norm and the
    median leaf's; ``COUNTS``: the attention path ran in all four
    blocks."""
    import statistics

    from benchmark_torch.lib import family_swin as ref
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.models import swin

    cfg = {"image_size": 32, "patch_size": 4, "embed_dim": 32,
           "depths": [2, 2], "num_heads": [2, 4], "window_size": 4,
           "mlp_ratio": 4, "fc_layer_dim": 6, "n_classes": 6}
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(-1, 6, 16)
    w0 = ref.make_weights(cfg, 5, cuda)
    model = engine.build_model(
        NameSpace({"model": {"arch": "swin", "variant": "tiny_swin"}}), 6,
        device=cuda)
    model.load_state_dict(w0, strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    before = swin.COUNTS["attention_calls"]
    loss_fn = engine.make_loss_fn("entropic", fused="auto")
    logits, _ = model(torch.from_numpy(images).to(cuda).float() / 255.0)
    assert swin.COUNTS["attention_calls"] - before == 4
    loss, _ = loss_fn(logits, torch.from_numpy(labels).to(cuda),
                      torch.ones(16, device=cuda))
    loss.backward()
    params = {n: w0[n].clone().requires_grad_() for n in ref.param_names(cfg)}
    with ref.exact_float32():
        ref_loss, grads, ref_logits = ref.loss_and_grads(
            params, images, labels, cfg, block=8)
    assert float((logits - ref_logits).norm() / ref_logits.norm()) < 0.02
    assert abs(float(loss.detach()) - ref_loss) < 1e-3 * abs(ref_loss)
    named = dict(model.named_parameters())
    median = statistics.median(float(g.norm()) for g in grads.values())
    for name, g in grads.items():
        gap = float((named[name].grad - g).norm())
        assert gap < 0.1 * max(float(g.norm()), median), name
