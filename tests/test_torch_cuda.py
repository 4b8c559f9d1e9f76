"""The port's kernels against their plain versions, on the GPU.

The Triton loss kernels (K1-K4), the CUDA C++ fused-bottleneck site (K5)
and split tail site (K6), both built with ``nvcc`` at first use, and the
Triton streaming probes (K7).  Marked ``cuda``: skipped where there is no
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


def test_k7_refuses_what_it_does_not_take(cuda):
    from openset_imagenet_tpu_torch.ops import stream_probe as sp

    x = torch.zeros(2, 8, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        sp.axpy(x.float(), x.float())
    with pytest.raises(ValueError, match="one shape"):
        sp.relu_mask(x, x[:1])
    with pytest.raises(ValueError, match="operands on"):
        sp.axpy(x, x.cpu())
