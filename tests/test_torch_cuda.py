"""The port's kernels against their plain versions, on the GPU, over the
shapes whose launch plans differ.  The checks of a kernel against its
plain version are written once, in ``tests/cuda_checks.py``;
``chip_smoke.py`` runs each of them once at the main path's shapes.

The Triton loss kernels (K1-K4), the CUDA C++ fused-bottleneck site (K5)
and split tail site (K6), both built with ``nvcc`` at first use, the
Triton streaming probes (K7), and the CUDA C++ int8 convolution of the
quantized serving graph (``int8_conv``, bit-equal to its plain version at
every resnet50 shape, ragged and grouped shapes and extreme operands, in
bfloat16 and float32 out; 52 launches a resnet50 int8 forward, whose
output equals the same forward through the plain version), and the
Triton batch-norm kernels
(``ops/batch_norm.py``: the apply bit-equal to its plain version, the
statistics and backward against theirs, the model's train step and eval
forward against the written-out batch-norm, their launches and
refusals), and the Swin's window-attention kernels
(``ops/window_attention.py``: output, qkv and table gradients against
the plain version at Swin-B's four stage shapes, launches, bit-equal
backwards, peak memory, refusals), and the Swin's LayerNorm and residual
junction (``ops/layer_norm.py``: h bit-equal, n, dh and the float32
weight and bias gradients against the plain version at every distinct
Swin-B shape, launches, the same bits twice, refusals).  Marked ``cuda``: skipped where there is no
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

import cuda_checks as cc
from openset_imagenet_tpu_torch.ops import _triton
from openset_imagenet_tpu_torch.ops import fused_loss as fl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if importlib.util.find_spec("triton") is None:
        pytest.skip("no triton")
    return torch.device("cuda")


@pytest.mark.parametrize("b,c", [(64, 116), (256, 116), (256, 117),
                                 (1000, 1000), (5, 8), (4099, 3)])
@pytest.mark.parametrize("w", [1.0, 0.5])
def test_entropic_kernel_matches_plain(cuda, b, c, w):
    cc.entropic_fwd(cuda, b, c, w)


@pytest.mark.parametrize("b,c", [(64, 116), (64, 117), (256, 117),
                                 (1000, 1000), (4099, 3)])
def test_ce_kernel_matches_plain(cuda, b, c):
    cc.ce_fwd(cuda, b, c)


def test_two_launches_give_the_same_bits(cuda):
    logits, labels, mask = cc.batch(cuda, 1000, 1000)
    a = torch.stack(fl.entropic_sums(logits, labels, mask, 1.0))
    b = torch.stack(fl.entropic_sums(logits, labels, mask, 1.0))
    assert torch.equal(a, b)
    a = torch.stack(fl.ce_sums(logits, labels, mask))
    b = torch.stack(fl.ce_sums(logits, labels, mask))
    assert torch.equal(a, b)


def _one_launch(kernel, cuda, b, c):
    """``(call, plain)`` of the one-launch forward ``kernel`` on a batch."""
    logits, labels, mask = cc.batch(cuda, b, c, seed=c)
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
    cc.close(first, plain())
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
    counters = len(_triton._TICKETS)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph, stream=side):
        for _ in range(20):
            outs.append(call())
    assert len(_triton._TICKETS) == counters   # nothing allocated in the graph
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(torch.stack(o), first) for o in outs)
    assert all(bool((t == 0).all()) for t in _triton._TICKETS.values())


def _entropic_case(cuda, case):
    b, c = {"p1": (64, 116), "train": (256, 116), "ragged": (1000, 1000),
            "narrow": (4099, 3)}.get(case, (64, 116))
    logits, labels, mask = cc.batch(cuda, b, c, seed=b + c + 1)
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
    cc.close((loss_sum, count), ref)
    assert float(count) == float(ref[1])   # a count of 0/1 rows, exact
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
    logits, labels, mask = cc.batch(cuda, 256, 116, seed=3)
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
    logits, labels, mask = cc.batch(cuda, b, c, seed=b + c + 2, low=low)
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
    cc.close((loss_sum, wsum), ref)
    if case in ("softmax", "all_ignored"):   # 0/1 row weights: a count
        assert float(wsum) == float(ref[1])
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
    logits, labels, mask = cc.batch(cuda, 64, c, seed=4,
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
    logits, labels, mask = cc.batch(cuda, 16, 10)
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
    logits, labels, mask = cc.batch(cuda, 256, 117, low=0 if loss == "garbage"
                                  else -1)
    weights = torch.rand(117, device=cuda) + 0.5
    fn = {"entropic": lambda *a: fl.entropic_openset_loss_fused(
              a[0], a[1], a[2], 0.5),
          "softmax": lambda *a: fl.softmax_loss_fused(a[0], a[1], a[2]),
          "garbage": lambda *a: fl.garbage_loss_fused(a[0], a[1], a[3],
                                                      a[2])}[loss]
    got = fn(logits, labels, mask, weights)
    ref = fn(logits.cpu(), labels.cpu(), mask.cpu(), weights.cpu())
    cc.close(got, ref)


@pytest.mark.parametrize("b,c", [(256, 116), (64, 116), (64, 117),
                                 (1000, 1000), (5, 8), (4099, 3)])
@pytest.mark.parametrize("w", [1.0, 0.5])
def test_entropic_grad_kernel_matches_plain(cuda, b, c, w):
    cc.entropic_bwd(cuda, b, c, w)


@pytest.mark.parametrize("b,c", [(64, 116), (64, 117), (256, 117),
                                 (1000, 1000), (4099, 3)])
def test_ce_grad_kernel_matches_plain(cuda, b, c):
    cc.ce_bwd(cuda, b, c)


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
def test_autograd_through_kernels_matches_cpu(cuda, loss):
    logits, labels, mask = cc.batch(cuda, 256, 117, low=0 if loss == "garbage"
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

@pytest.fixture
def cuda_k5():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(512, 16, 24), (300, 64, 256),
                                   (1000, 72, 40), (4096, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", sorted(cc.K5_FORMS))
def test_k5_kernel_matches_plain(cuda_k5, form, dtype, shape):
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    args, kw = cc.k5_args(cuda_k5, *shape, dtype, form)
    before = fbb.LAUNCHES["fused_block_bwd"]
    cc.k5_same_bits_and_close(args, kw, dtype)
    assert fbb.LAUNCHES["fused_block_bwd"] == before + 2


# Each in bfloat16, and stage 4's three sites in float32 too (the generic
# route).
@pytest.mark.parametrize("site,dtype", [
    *((site, torch.bfloat16) for site in cc.RESNET50_SITES),
    *((site, torch.float32) for site in cc.RESNET50_SITES[-3:])])
def test_k5_at_every_resnet50_site(cuda_k5, site, dtype):
    cc.k5_site(cuda_k5, site, dtype)


# Ragged M on the fused and tiled routes, ragged channels on the generic.
@pytest.mark.parametrize("shape,form", [
    ((4099, 64, 256), "tail"), ((1003, 256, 64), "head_ds"),
    ((12544 + 77, 512, 2048), "tail"), ((1003, 72, 40), "head_ds")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_ragged_sites(cuda_k5, shape, form, dtype):
    args, kw = cc.k5_device_args(cuda_k5, *shape, dtype, form,
                                 seed=sum(shape))
    cc.k5_same_bits_and_close(args, kw, dtype)


def test_k5_refuses_what_it_does_not_take(cuda_k5):
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    args, kw = cc.k5_args(cuda_k5, 64, 16, 32, torch.bfloat16, "tail")
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
# bf16, and in f32 rtol 1e-5 and atol 1e-5 on operands drawn on the card,
# 1e-5 of its largest value on numpy's (cuda_checks.k6 gives why).
# Against K5's unified site: gp exactly, dx within 8e-2 (bf16, the JAX
# test's bound) or 1e-5, dW and the sums within the same bounds in norm.


# Numpy's operands (the weight x 0.3) at reduced and ragged shapes; the
# card's (x 0.05, the main path's scale) at stage 4's tail, its ragged M
# and ragged channels, where f32 dx is held at atol 1e-5.
@pytest.mark.parametrize("m,ci,co,draw", [
    (512, 16, 24, "numpy"), (300, 64, 256, "numpy"), (1000, 72, 40, "numpy"),
    (1003, 37, 21, "numpy"), (4096, 256, 64, "numpy"),
    (3000, 512, 2048, "numpy"), (12544, 512, 2048, "card"),
    (12544 + 77, 512, 2048, "card"), (1003, 37, 21, "card")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_kernel_matches_plain_and_k5(cuda_k5, dtype, m, ci, co, draw):
    cc.k6(cuda_k5, dtype, (m, ci, co), on_card=draw == "card")


# The four resnet50 tail widths (ci, co) at a reduced, ragged M, and at
# their M at 224 px, batch 256, where each block walks several row tiles.
@pytest.mark.parametrize("m,ci,co", [
    (4096 + 77, 64, 256), (4096 + 77, 128, 512), (4096 + 77, 256, 1024),
    (4096 + 77, 512, 2048), (802816, 64, 256), (200704, 128, 512),
    (50176, 256, 1024), (12544, 512, 2048)])
def test_k6_tensor_core_route_at_every_resnet50_tail_width(cuda_k5, m, ci,
                                                           co):
    from openset_imagenet_tpu_torch.experimental import split_site as ss
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    assert ss._plan(m, ci, co, torch.bfloat16, True,
                    fbb._sm_count(cuda_k5.index or 0)).route == \
        "tensor_cores"
    # Drawn on the card beyond 2**24 values (numpy is slow at 200 M).
    cc.k6(cuda_k5, torch.bfloat16, (m, ci, co), on_card=m * co > 2 ** 24)


def test_k6_refuses_what_it_does_not_take(cuda_k5):
    from openset_imagenet_tpu_torch.experimental import split_site as ss

    args, _ = cc.k6_args(cuda_k5, 64, 16, 32, torch.bfloat16)
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
    cc.k7(cuda, probe, shape)


def _every_bf16(device):
    return torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).reshape(1, 256, 256).to(device)


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
        assert cc.same_bits(got[~nan], ref[~nan])
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
    assert cc.same_bits(got, sp.relu_mask_plain(g, m))
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
        assert cc.same_bits(getattr(sp, probe)(x, y),
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
            assert cc.same_bits(got, want), launch


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

@pytest.fixture
def cuda_i8():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _resnet50_shapes():
    from openset_imagenet_tpu_torch.ops.int8_conv import resnet50_shapes

    return sorted(resnet50_shapes(224))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("shape", _resnet50_shapes())
def test_int8_conv_at_every_resnet50_shape(cuda_i8, shape, extreme, dtype):
    cc.int8_at(cuda_i8, shape, extreme, dtype, batch=2)


# Ragged M and channel counts, and grouped convs: resnext50_32x4d's four
# stages (4, 8, 16 and 32 channels a group) and two narrower ones.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("b,h,cin,cout,k,stride,groups", [
    (3, 13, 64, 64, 3, 1, 1), (1, 7, 128, 72, 1, 1, 1),
    (5, 9, 64, 256, 3, 2, 1),
    (2, 56, 128, 128, 3, 1, 32), (2, 56, 256, 256, 3, 2, 32),
    (2, 28, 256, 256, 3, 1, 32), (2, 28, 512, 512, 3, 2, 32),
    (2, 14, 512, 512, 3, 1, 32), (2, 14, 1024, 1024, 3, 2, 32),
    (2, 7, 1024, 1024, 3, 1, 32), (2, 8, 16, 16, 3, 1, 4),
    (2, 9, 6, 10, 3, 2, 2), (2, 11, 96, 40, 1, 1, 1)])
def test_int8_conv_ragged_and_grouped(cuda_i8, b, h, cin, cout, k, stride,
                                      groups, extreme, dtype):
    cc.i8_same(cuda_i8, b, h, cin, cout, k, stride, groups, seed=b * h,
             dtype=dtype, extreme=extreme)


@pytest.mark.parametrize("shape", [(56, 64, 64, 3, 1), (7, 2048, 512, 1, 1),
                                   (14, 1024, 2048, 1, 2)])
def test_int8_conv_extreme_operands_and_float32(cuda_i8, shape):
    h, cin, cout, k, stride = shape
    cc.i8_same(cuda_i8, 2, h, cin, cout, k, stride, extreme=True)
    cc.i8_same(cuda_i8, 2, h, cin, cout, k, stride, dtype=torch.float32)


def test_int8_conv_refuses_what_it_does_not_take(cuda_i8):
    from openset_imagenet_tpu_torch.ops import int8_conv as ic

    q, w, scale, bias = cc.i8_operands(cuda_i8, 2, 8, 64, 64, 3, 1)
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
            # The shape table the per-shape tests take holds those 52.
            assert sum(ic.resnet50_shapes(224).values()) == 52
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
LAYOUTS = ["channels_last", "contiguous"]
# The twelve distinct shapes of a resnet50's 53 batch-norms at 224 px,
# batch 256, each with a launch plan of its own, in the train cells' form:
# bfloat16, channels-last, a statistics window of 64 images.
RESNET50_BN = [(256, 64, 112, 112), (256, 64, 56, 56), (256, 256, 56, 56),
               (256, 128, 56, 56), (256, 128, 28, 28), (256, 512, 28, 28),
               (256, 256, 28, 28), (256, 256, 14, 14), (256, 1024, 14, 14),
               (256, 512, 14, 14), (256, 512, 7, 7), (256, 2048, 7, 7)]


@pytest.mark.parametrize("shape,dtype,layout", [
    *((shape, dtype, layout) for shape in BN_SHAPES
      for dtype in (torch.bfloat16, torch.float16, torch.float32)
      for layout in LAYOUTS),
    *((shape, torch.bfloat16, "channels_last") for shape in RESNET50_BN)])
@pytest.mark.parametrize("ghost", [True, False])
def test_bn_apply_is_bit_equal_to_plain(cuda, shape, dtype, layout, ghost):
    cc.bn_apply(cuda, shape, dtype, layout, ghost)


@pytest.mark.parametrize("shape,layout,rows", [
    *((shape, layout, rows) for shape in BN_SHAPES + [(256, 64, 56, 56)]
      for layout in LAYOUTS for rows in (1, 3, 0)),
    *((shape, "channels_last", 64) for shape in RESNET50_BN)])
def test_bn_stats_match_plain(cuda, shape, layout, rows):
    cc.bn_stats(cuda, shape, layout, rows)


@pytest.mark.parametrize("shape,dtype,layout,rows", [
    *((shape, dtype, layout, rows)
      for shape in BN_SHAPES + [(256, 256, 28, 28)]
      for dtype in (torch.bfloat16, torch.float32) for layout in LAYOUTS
      for rows in (0, 1, 3, 1000)),
    *((shape, torch.bfloat16, "channels_last", 64) for shape in RESNET50_BN)])
def test_bn_backward_matches_plain(cuda, shape, dtype, layout, rows):
    cc.bn_backward(cuda, shape, dtype, layout, rows)


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

    x, g, w, b, rm, rv = cc.bn_case(cuda, (8, 64, 14, 14), dtype,
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
        assert cc.bn_same(got[0], ref[0])
    assert cc.bn_rel(got[0], ref[0]) <= (4e-3 if dtype == torch.bfloat16
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
    written-out path's (resnet50 at the train cells' configuration: batch
    256, 224 px, a window of 64 images; 2e-2).  With ``exact``, the same
    step also runs in float64 on the CPU, written out, and each kernel
    gradient is no further from that witness than the written-out path's
    by more than ``bound``, and within ``bound`` of the written-out path's
    or nearer the witness.  tiny50 in float32 takes the second arm: the
    written-out path forms ``dweight`` as ``inv * (sum g x - mean * sum
    g)``, which cancels in float32 (the kernels sum ``g * (x - mean)``).  resnet50 at
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
        gap = cc.bn_rel(k1[2][name], grad)
        if not exact:
            assert gap <= bound, (name, gap)
            continue
        got = cc.bn_rel(k1[2][name].cpu(), witness[name])
        ref = cc.bn_rel(grad.cpu(), witness[name])
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
    assert len(norms) == 53
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

    x, g, w, b, rm, rv = cc.bn_case(cuda, (4, 16, 6, 6), torch.bfloat16,
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
    assert cc.bn_same(got[0][2:], ref[0][2:])



def test_swin_train_step_against_the_float32_reference(cuda):
    """A bf16 train step of a tiny Swin on the card (32 px, embedding 32,
    depths (2, 2), heads (2, 4), window 4: stage 1 shifted, stage 2 one
    window; the attention through the window-attention kernels, the loss
    through K1 and K2) against the benchmark's float32 reference
    on the card (TF32 off): the logits within 2 % of their norm (the CPU
    tests' bf16 rule, ``tests/test_torch_swin.py``), the loss within 1e-3,
    every leaf's gradient within 10 % of the larger of its norm and the
    median leaf's; the window-attention forward launched in all four
    blocks."""
    import statistics

    from benchmark_torch.lib import family_swin as ref
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.ops import window_attention as wak

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
    before = wak.LAUNCHES["win_attn_fwd"]
    loss_fn = engine.make_loss_fn("entropic", fused="auto")
    logits, _ = model(torch.from_numpy(images).to(cuda).float() / 255.0)
    assert wak.LAUNCHES["win_attn_fwd"] - before == 4
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


# -- the window attention (ops/window_attention.py, Triton) ------------------
# Kernel against plain on the card at Swin-B's four stage shapes (map side,
# channels, heads; windows of 7, the table's window 7), batch 4, and in
# bf16 at batch 256, the train cell's (whose runs of windows end in a
# clipped run at stages 1 and 2).
# Tolerances, relative in norm: float32 1e-5 (the same float32 function,
# sums in another order and the card's exp; read 2.5e-7); bf16 output
# 1e-3 (the one rounding of P and of the output can fall the other way
# where the two float32 values differ in their last bits: one bf16 step,
# 2**-8, for a few elements; read 6e-5); bf16 dqkv 1e-2 (the kernel
# rounds dS to bf16 for the dq and dk products, 2**-9 an element, where
# autograd of the plain version keeps float32; read 2.1e-3); the table's
# gradient 1e-5 in both dtypes (float32 sums of the same float32 dS over
# every window, in another order; read 3.1e-7).  Readings on an NVIDIA H100
# 80GB HBM3.

@pytest.mark.parametrize("dtype,batch", [(torch.bfloat16, 4),
                                         (torch.float32, 4),
                                         (torch.bfloat16, 256)])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", range(4))
def test_window_attention_kernel_matches_plain(cuda, stage, shift, dtype,
                                               batch):
    if shift and stage == 3:
        pytest.skip("stage 4's map is one window: never shifted")
    cc.window_attention(cuda, stage, shift, dtype, batch)


def test_window_attention_backward_is_bit_equal_twice(cuda):
    from openset_imagenet_tpu_torch.ops import window_attention as wak

    qkv, table, grad = cc.wa_case(cuda, 8, 56, 128, 4, torch.bfloat16, 1)
    first = cc.wa_grads(wak.window_attention, qkv, table, grad, 3)
    again = cc.wa_grads(wak.window_attention, qkv, table, grad, 3)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_window_attention_holds_no_window_by_window_tensor(cuda):
    """Peak memory over one stage-1 call at batch 64 (16 MB a [B, H, W, C]
    bf16 tensor): the forward allocates its output and the log-sum-exp;
    the backward the qkv gradient, the table's, and each program's
    49 x 49 float32 scratch and table rows (264 programs: 2.8 MB).  Margin 4 MB: the allocator's rounding and the autograd
    engine's small buffers (the backward read 1.0 MB over its own
    tensors on an H100).  Scores or weights of every window ([4096, 4, 49, 49]) would
    take 79 MB in bf16, 157 MB in float32."""
    from openset_imagenet_tpu_torch.ops import window_attention as wak

    qkv, table, grad = cc.wa_case(cuda, 64, 56, 128, 4, torch.bfloat16, 2)
    qkv.requires_grad_()
    table.requires_grad_()
    windows, heads, n = 64 * 64, 4, 49
    margin = 4 * 2 ** 20
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = wak.window_attention(qkv, table, 7, 3)
    torch.cuda.synchronize()
    lse = windows * heads * n * 4
    assert torch.cuda.max_memory_allocated() - base <= (
        out.numel() * 2 + lse + margin)
    plan = wak._plan(windows, heads, n, 7)
    scratch = plan.bwd_grid * heads * (n * n + plan.block_r) * 4
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out.backward(grad)
    torch.cuda.synchronize()
    assert scratch < 3e6
    assert torch.cuda.max_memory_allocated() - base <= (
        qkv.numel() * 2 + table.numel() * 4 + scratch + margin)


def test_window_attention_launches_once_a_block_each_way(cuda):
    """A tiny_swin train step launches one forward and one backward a
    block (four blocks); its forward under ``torch.inference_mode``, as
    ``OpenSetPredictor`` runs it, one forward a block and the output of
    the forward with a gradient."""
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.ops import window_attention as wak

    model = engine.build_model(
        NameSpace({"model": {"arch": "swin", "variant": "tiny_swin"}}), 6,
        device=cuda).train()
    x = torch.rand(8, 32, 32, 3, device=cuda)
    before = dict(wak.LAUNCHES)
    logits, _ = model(x)
    logits.float().sum().backward()
    assert wak.LAUNCHES == {"win_attn_fwd": before["win_attn_fwd"] + 4,
                            "win_attn_bwd": before["win_attn_bwd"] + 4}
    with torch.inference_mode():
        again, _ = model(x)
    assert wak.LAUNCHES["win_attn_fwd"] == before["win_attn_fwd"] + 8
    assert wak.LAUNCHES["win_attn_bwd"] == before["win_attn_bwd"] + 4
    assert torch.equal(again, logits.detach())


def test_window_attention_refuses_what_it_does_not_take(cuda):
    from openset_imagenet_tpu_torch.ops import window_attention as wak

    qkv, table, _ = cc.wa_case(cuda, 2, 14, 128, 4, torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        wak.window_attention(qkv.double(), table, 7, 3)
    big = torch.zeros(1, 9, 9, 3 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 64 tokens"):
        wak.window_attention(big, torch.zeros(289, 4, device=cuda), 9, 0)
    with pytest.raises(ValueError, match="power of two"):
        wak.window_attention(qkv[..., :3 * 96].contiguous(),
                             table[:, :4], 7, 3)
    with pytest.raises(ValueError, match="contiguous qkv"):
        wak.window_attention(qkv.transpose(1, 2), table, 7, 3)
    with pytest.raises(ValueError, match="contiguous float32"):
        wak.window_attention(qkv, table.double(), 7, 3)


# -- the LayerNorm and residual junction (ops/layer_norm.py, Triton) ---------
# Kernel against plain on the card at every distinct (rows, C, form) of
# Swin-B at batch 256 (cuda_checks.LN_SITES), in bf16 and float32, with
# the bounds and reasons of cuda_checks.layer_norm; the final LayerNorm's
# junction, whose h has no other gradient; widths that are not powers of
# two or not multiples of 16, and a launch of one program.

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("site", cc.LN_SITES, ids=str)
def test_layer_norm_kernel_matches_plain(cuda, site, dtype):
    cc.layer_norm(cuda, site, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_final_junction_without_a_gradient_of_h(cuda, dtype):
    cc.layer_norm(cuda, (12544, 1024, True), dtype, grad_h=False)


@pytest.mark.parametrize("site", [(3, 96, True), (1000, 7, False),
                                  (777, 2048, True), (1, 128, True),
                                  (4099, 384, False)], ids=str)
def test_layer_norm_ragged_shapes(cuda, site):
    cc.layer_norm(cuda, site, torch.bfloat16)


def test_layer_norm_refuses_what_it_does_not_take(cuda):
    from openset_imagenet_tpu_torch.ops import layer_norm as lnk

    x, y, b, w, beta, _, _ = cc.ln_case(cuda, 64, 128, torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        lnk.layer_norm(x.double(), w, beta, 1e-5)
    strided = x.view(8, 8, 128).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous tensors"):
        lnk.add_layer_norm(strided, strided, b, w, beta, 1e-5)
    wide = torch.zeros(4, 4096, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 2048"):
        lnk.layer_norm(wide, torch.ones(4096, device=cuda),
                       torch.zeros(4096, device=cuda), 1e-5)
    with pytest.raises(ValueError, match="contiguous float32"):
        lnk.add_layer_norm(x, y, b.half(), w, beta, 1e-5)
    with pytest.raises(ValueError, match="contiguous float32"):
        lnk.layer_norm(x, w.cpu(), beta, 1e-5)


def test_swin_step_runs_every_layer_norm_through_the_kernels(cuda):
    """A tiny_swin forward and backward on the card: 4 LayerNorms alone and
    7 fused with their junction, one launch each way, and no other
    LayerNorm kernel (profiler names); under ``torch.inference_mode`` the
    forwards alone, with the same logits."""
    from torch.profiler import ProfilerActivity, profile

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.ops import layer_norm as lnk

    model = engine.build_model(
        NameSpace({"model": {"arch": "swin", "variant": "tiny_swin"}}), 6,
        device=cuda).train()
    x = torch.rand(8, 32, 32, 3, device=cuda)
    before = dict(lnk.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, _ = model(x)
        logits.float().sum().backward()
        torch.cuda.synchronize()
    step = {k: lnk.LAUNCHES[k] - before[k] for k in before}
    assert step == {"ln_fwd": 4, "ln_add_fwd": 7, "ln_bwd": 4,
                    "ln_add_bwd": 7}
    names = {e.name for e in prof.events() if any(
        f in e.name.lower() for f in ("layer_norm", "layernorm",
                                      "gammabeta"))}
    assert names == {"osi_layer_norm_fwd", "osi_layer_norm_bwd"}, names
    with torch.inference_mode():
        again, _ = model(x)
    assert lnk.LAUNCHES["ln_add_fwd"] == before["ln_add_fwd"] + 14
    assert lnk.LAUNCHES["ln_add_bwd"] == before["ln_add_bwd"] + 7
    assert torch.equal(again, logits.detach())
