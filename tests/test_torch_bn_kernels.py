"""The batch-norm kernels' plain versions and launch plan (CPU).

``ops/batch_norm.py`` runs the port's batch-norm on CUDA tensors as
Triton kernels; these tests hold the formulas those kernels compute
(their plain versions, ``bn_stats_plain``, ``bn_apply_plain`` and
``bn_grad_plain``) and the plan of their launches on the host:

* ``bn_grad_plain`` against autograd of the written-out math of
  ``models/norm.py``: in float64 to 1e-10 (the same function), in
  bfloat16 against the module itself, within the ghost form's bounds of
  ``tests/test_torch_norm.py`` (1e-2 of the largest input gradient, 5e-2
  of the largest scale and bias gradient: autograd of that form sums
  bfloat16 products into bfloat16, the formula sums in float32) and at
  least as close to the float64 truth as autograd is (``dx`` within its
  bfloat16 rounding of it), for both forms,
  windows of 0 (flax), 1, some and every image, ragged ``N*H*W``, and a
  variance at the clamp (``d == 0`` and ``d < 0``);
* ``_plan`` covers every row and channel exactly once in each launch;
* the module's routing: CPU tensors take the written-out math, and
  ``batch_norm`` (the kernels' autograd Function) refuses them;
* the layout and stride checks of the kernel wrappers.
"""

import numpy as np
import pytest
import torch

from openset_imagenet_tpu_torch.models.norm import BatchNorm
from openset_imagenet_tpu_torch.ops import batch_norm as bnk

EPS = 1e-5


def _f(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _written_out(x, w, b, rm, rv, rows, training):
    """``BatchNorm.forward`` of ``models/norm.py`` with ``.float()`` as a
    promotion to at least float32, so it runs in float64 too."""
    c = lambda t: t.view(1, -1, 1, 1)
    if training:
        xs = _f(x if rows <= 0 else x[:rows])
        mean = xs.mean(dim=(0, 2, 3))
        mean2 = xs.square().mean(dim=(0, 2, 3))
        var = torch.maximum(mean2 - mean.square(), mean2.new_zeros(()))
    else:
        mean, var = rm, rv
    if rows > 0:
        inv = torch.reciprocal(torch.sqrt(var + EPS))
        mul, add = inv * w, b - mean * inv * w
        return x * c(mul.to(x.dtype)) + c(add.to(x.dtype))
    mul = torch.rsqrt(var + EPS) * w
    return ((_f(x) - c(mean)) * c(mul) + c(b)).to(x.dtype)


def _inputs(seed, shape, dtype, clamp=None):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = torch.from_numpy(rng.normal(size=shape) * 2 + 0.5).to(dtype)
    if clamp is not None:
        x[:, 0] = 0.5            # d == 0 exactly in every window
        x[:, 1] = clamp          # d < 0 in the window (see _negative_d)
    g = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c))
    b = torch.from_numpy(rng.normal(size=c) * 0.1)
    return x, g, w, b


def _autograd(x, g, w, b, rows, training=True, module=False):
    """``(dx, dw, db)`` of the written-out math by autograd: the module
    itself (float32 parameters) or :func:`_written_out` in ``x``'s
    precision."""
    x = x.clone().requires_grad_()
    if module:
        bn = BatchNorm(x.shape[1], stats_rows=rows).train(training)
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        y = bn(x)
        params = (bn.weight, bn.bias)
    else:
        wp, bp = (w.to(_f(x).dtype).clone().requires_grad_(),
                  b.to(_f(x).dtype).clone().requires_grad_())
        rm = torch.zeros(x.shape[1], dtype=wp.dtype)
        y = _written_out(x, wp, bp, rm, rm + 1, rows, training)
        params = (wp, bp)
    torch.autograd.backward(y, g)
    return x.grad, params[0].grad, params[1].grad


def _plain(x, g, w, b, rows, training=True):
    """``(dx, dw, db)`` by ``bn_grad_plain`` from ``bn_stats_plain``."""
    n = x.shape[0]
    window = (min(rows, n) if rows > 0 else n) if training else 0
    dt = _f(x).dtype
    zeros = torch.zeros(x.shape[1], dtype=dt)
    if training:
        stats = bnk.bn_stats_plain(x, window, zeros.clone(), zeros + 1, 0.9)
    else:
        stats = torch.stack([zeros, zeros + 1])
    return bnk.bn_grad_plain(g, x, w.to(dt), stats, window, rows > 0, EPS)


def _rel(a, b):
    return float((_f(a) - _f(b)).norm() / max(float(_f(b).norm()), 1e-30))


SHAPES = [(8, 6, 5, 5), (7, 5, 3, 7)]        # M = 200 and a ragged 147
WINDOWS = [0, 1, 3, 100]                      # flax, 1, some, every image


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rows", WINDOWS)
def test_grad_plain_is_autograd_of_the_written_out_math_float64(shape, rows):
    x, g, w, b = _inputs(rows + shape[0], shape, torch.float64)
    got = _plain(x, g, w, b, rows)
    ref = _autograd(x, g, w, b, rows)
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-12, msg=name)


@pytest.mark.parametrize("rows", [0, 3])
def test_grad_plain_in_eval_float64(rows):
    x, g, w, b = _inputs(11, SHAPES[1], torch.float64)
    got = _plain(x, g, w, b, rows, training=False)
    ref = _autograd(x, g, w, b, rows, training=False)
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-12, msg=name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rows", WINDOWS)
def test_grad_plain_against_the_module_bfloat16(shape, rows):
    x, g, w, b = _inputs(rows + 50, shape, torch.bfloat16)
    got = _plain(x, g, w.float(), b.float(), rows)
    ref = _autograd(x, g, w.float(), b.float(), rows, module=True)
    truth = _autograd(x.double(), g.double(), w, b, rows)
    # Outside the window dx is round(g * mul) in both, bit for bit.
    if 0 < rows < shape[0]:
        assert torch.equal(got[0][rows:], ref[0][rows:])
    tol = (1e-2, 5e-2, 5e-2) if rows else (1e-5, 1e-5, 1e-5)
    for name, a, r, t, bound in zip(("dx", "dw", "db"), got, ref, truth,
                                    tol):
        assert float((_f(a) - _f(r)).abs().max()) <= \
            bound * float(_f(r).abs().max()), name
        # Summing in float32 is no further from the float64 truth; dx,
        # rounded to bfloat16 in both, is within that rounding of it.
        slack = 2.0 ** -8 if name == "dx" else 1e-6
        assert _rel(a, t) <= max(_rel(r, t) * 1.01, slack) + 1e-6, (
            name, _rel(a, t), _rel(r, t))


def _negative_d(rows, shape):
    """A constant whose fast variance over ``rows`` images of ``shape``
    rounds below zero in float32."""
    n = rows * shape[2] * shape[3]
    for v in np.linspace(0.1, 3.0, 400, dtype=np.float32):
        xs = torch.full((n,), float(v), dtype=torch.float32)
        if float(xs.square().mean() - xs.mean().square()) < 0:
            return float(v)
    raise AssertionError("no constant rounds the variance below zero")


@pytest.mark.parametrize("rows", [0, 3])
def test_grad_plain_at_the_variance_clamp(rows):
    shape = SHAPES[0]
    window = rows or shape[0]
    x, g, w, b = _inputs(7, shape, torch.float32,
                         clamp=_negative_d(window, shape))
    stats = bnk.bn_stats_plain(x, window, torch.zeros(6), torch.ones(6),
                               0.9)
    assert float(stats[2, 0]) == 0 and float(stats[2, 1]) < 0
    got = _plain(x, g, w.float(), b.float(), rows)
    ref = _autograd(x, g, w.float(), b.float(), rows, module=True)
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        torch.testing.assert_close(a, r, rtol=2e-5, atol=2e-5 * float(
            r.abs().max()), msg=name)


# -- the launch plan ----------------------------------------------------------

def _resnet50_shapes(batch=256):
    """``(M, C)`` of the 53 batch-norms of a resnet50 at 224 px."""
    shapes = [(batch * 112 * 112, 64)]
    cin, hw = 64, 56
    for stage, blocks in enumerate((3, 4, 6, 3)):
        width = 64 * 2 ** stage
        for j in range(blocks):
            out_hw = hw // 2 if stage > 0 and j == 0 else hw
            shapes += [(batch * hw * hw, width),
                       (batch * out_hw * out_hw, width),
                       (batch * out_hw * out_hw, width * 4)]
            if j == 0:
                shapes.append((batch * out_hw * out_hw, width * 4))
            hw = out_hw
        cin = width * 4
    assert len(shapes) == 53 and cin == 2048
    return shapes


def _partitions(launch, rows, c):
    """True when the launch's tiles cover ``[0, rows) x [0, c)`` exactly
    once: per channel tile, the row ranges in order, end to end."""
    by_col = {}
    for pm, pc, r0, r1, c0, c1 in bnk._tiles(launch, rows, c):
        assert 0 <= pm < launch.grid_m and r1 > r0
        by_col.setdefault((c0, c1), []).append((r0, r1))
    cols = sorted(by_col)
    assert cols[0][0] == 0 and cols[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    for ranges in by_col.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    return True


@pytest.mark.parametrize("m,c,r", [
    (49, 2048, 49), (147, 5, 21), (3000, 200, 1000), (200, 2049, 3),
    (1, 8, 1), (4096, 64, 0), (802816 * 4, 64, 802816)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", bnk.LAYOUTS)
def test_plan_covers_every_row_and_channel_once(m, c, r, dtype, layout):
    plan = bnk._plan(m, c, r, dtype, layout)
    for name in ("apply", "bwd"):
        assert _partitions(getattr(plan, name), m, c), name
    if r == 0:
        assert plan.stats is None and plan.fix is None
    else:
        for name in ("stats", "fix"):
            assert _partitions(getattr(plan, name), r, c), name
    if m * c <= 1 << 16:     # and element by element
        seen = np.zeros((m, c), np.int64)
        for launch, rows in ((plan.apply, m), (plan.bwd, m)):
            seen[:] = 0
            for _, _, r0, r1, c0, c1 in bnk._tiles(launch, rows, c):
                seen[r0:r1, c0:c1] += 1
            assert (seen == 1).all()


def test_plan_at_every_resnet50_shape():
    for m, c in _resnet50_shapes():
        plan = bnk._plan(m, c, m // 4, torch.bfloat16, "channels_last")
        for name, rows in (("stats", m // 4), ("apply", m), ("bwd", m),
                           ("fix", m // 4)):
            launch = getattr(plan, name)
            assert _partitions(launch, rows, c), (m, c, name)
            assert launch.block_c == min(c, 128)
            assert launch.grid_m * launch.grid_c <= 8 * bnk.SMS


# -- routing and the wrappers' checks -----------------------------------------

def test_cpu_tensors_take_the_written_out_math(monkeypatch):
    from openset_imagenet_tpu_torch.models import norm

    def refuse(*a, **k):
        raise AssertionError("the kernel path ran on a CPU tensor")

    monkeypatch.setattr(norm, "batch_norm", refuse)
    before = dict(bnk.LAUNCHES)
    bn = BatchNorm(6, stats_rows=3).train()
    bn(torch.randn(4, 6, 3, 3).requires_grad_()).sum().backward()
    bn.eval()(torch.randn(4, 6, 3, 3))
    assert bnk.LAUNCHES == before


def test_the_kernels_function_refuses_cpu_tensors():
    bn = BatchNorm(6, stats_rows=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bnk.batch_norm(torch.randn(4, 6, 3, 3), bn.weight, bn.bias,
                       bn.running_mean, bn.running_var, training=True,
                       stats_rows=3, eps=EPS, momentum=0.9)


def test_layout_and_stride_checks():
    x = torch.randn(2, 8, 4, 5)
    assert bnk._layout(x) == "contiguous"
    assert bnk._strides(x) == (160, 1, 20)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert bnk._layout(cl) == "channels_last"
    assert bnk._strides(cl) == (160, 8, 1)
    # An expanded gradient flattens H and W too (stride 0).
    assert bnk._strides(torch.ones(()).expand(2, 8, 4, 5)) == (0, 0, 0)
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        bnk._layout(x.permute(0, 1, 3, 2))
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        bnk._layout(x[:, ::2])
    with pytest.raises(ValueError, match="non-empty"):
        bnk._layout(torch.randn(8, 4, 5))
    with pytest.raises(ValueError, match="H and W of one stride"):
        bnk._strides(x.permute(0, 1, 3, 2))
    with pytest.raises(ValueError, match="float32"):
        bnk._check_vector("weight", torch.ones(8, dtype=torch.float64), 8, x)
    with pytest.raises(ValueError, match=r"\[8\]"):
        bnk._check_vector("weight", torch.ones(7), 8, x)
    with pytest.raises(ValueError, match="unknown layout"):
        bnk._plan(10, 8, 0, torch.float32, "nhwc")
