"""Each of the port's kernels against its plain version on the card: the
checks that ``tests/test_torch_cuda.py`` parametrises over many shapes and
``chip_smoke.py`` runs once each at the main path's shapes
(:data:`MAIN_PATH`), written once here.

A check takes the device first, builds its inputs (numpy from a seed, or
drawn on the card where numpy is slow), calls the kernel and its plain
version, and raises ``AssertionError`` where they differ by more than the
bound it states.  Needs a CUDA device; Triton and ``nvcc`` are imported
or run only inside the kernels' launches.
"""

import numpy as np
import torch
import torch.nn.functional as F

from openset_imagenet_tpu_torch.ops import fused_loss as fl


# -- the loss kernels, K1-K4 ---------------------------------------------------

def batch(device, b, c, seed=0, low=-1):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(low, c, b).astype(np.int32)
                              ).to(device)
    mask = torch.from_numpy((rng.random(b) > 0.2).astype(np.float32)
                            ).to(device)
    return logits, labels, mask


def close(got, ref):
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-6)


def scale(device, value=0.0123):
    return torch.tensor(value, dtype=torch.float32, device=device)


def entropic_fwd(device, b, c, w):
    """K1: one launch, its sums within ``close`` of the plain version's;
    at ``w`` 1 its mean within rtol 1e-5 of ``F.cross_entropy``'s."""
    logits, labels, mask = batch(device, b, c, seed=b + c)
    before = fl.LAUNCHES["entropic_fwd"]
    got = fl.entropic_sums(logits, labels, mask, w)
    assert fl.LAUNCHES["entropic_fwd"] == before + 1
    close(got, fl.entropic_sums_plain(logits, labels, mask, w))
    if w == 1.0:
        # At unk_weight 1 the mean is one library call's: the cross-entropy
        # of the kept rows against the target matrix (one-hot for a known
        # row, 1/C for a negative one).
        keep = mask > 0
        targets = torch.where(
            labels[:, None] >= 0, F.one_hot(labels.long().clamp(min=0),
                                            c).float(),
            torch.full((b, c), 1.0 / c, device=device))
        torch.testing.assert_close(
            fl.entropic_fwd(logits, labels, mask, w)[2],
            F.cross_entropy(logits[keep], targets[keep]), rtol=1e-5, atol=0)


def ce_fwd(device, b, c):
    """K3: one launch, its sums within ``close`` of the plain version's."""
    logits, labels, mask = batch(device, b, c, seed=b)
    weights = mask * torch.rand(b, device=device) + 0.1 * mask
    before = fl.LAUNCHES["ce_fwd"]
    got = fl.ce_sums(logits, labels.long(), weights)
    assert fl.LAUNCHES["ce_fwd"] == before + 1
    close(got, fl.ce_sums_plain(logits, labels.long(), weights))


def entropic_bwd(device, b, c, w):
    """K2: one launch, the logits' dtype and shape, within rtol 1e-5, atol
    1e-8 of the plain version, the same bits twice, masked rows 0."""
    logits, labels, mask = batch(device, b, c, seed=b + c)
    one = torch.ones((), device=device)   # the scale given as g / 1
    before = fl.LAUNCHES["entropic_bwd"]
    got = fl.entropic_grad(logits, labels, mask, scale(device), one, w)
    assert fl.LAUNCHES["entropic_bwd"] == before + 1
    again = fl.entropic_grad(logits, labels, mask, scale(device), one, w)
    ref = fl.entropic_grad_plain(logits, labels, mask, scale(device), one, w)
    assert got.dtype == logits.dtype and got.shape == logits.shape
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-8)
    assert torch.equal(got, again)
    assert bool((got[mask == 0] == 0).all())


def ce_bwd(device, b, c):
    """K4: as K2, rows of weight 0 exactly 0."""
    logits, labels, mask = batch(device, b, c, seed=b)
    weights = mask * torch.rand(b, device=device) + 0.1 * mask
    one = torch.ones((), device=device)   # the scale given as g / 1
    call = lambda: fl.ce_grad(logits, labels.long(), weights, scale(device),
                              one)
    before = fl.LAUNCHES["ce_bwd"]
    got = call()
    assert fl.LAUNCHES["ce_bwd"] == before + 1
    ref = fl.ce_grad_plain(logits, labels.long(), weights, scale(device),
                           one)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-8)
    assert torch.equal(call(), got)
    assert bool((got[weights == 0] == 0).all())


# -- K5, the fused-bottleneck site, and K6, the split tail site (CUDA C++) ----

K5_FORMS = {"tail": (True, True, False, True),      # in_act, mask, ds, gp
            "head_ds": (False, False, True, False),
            "head": (False, False, False, False)}
# Every pointwise site of resnet50 at 224 px, batch 256: (M, ci, co, form).
# The M = 802,816 sites take the fused route, the rest the tiled one.
RESNET50_SITES = [
    (802816, 64, 256, "tail"), (802816, 64, 64, "head"),
    (802816, 256, 64, "head_ds"), (802816, 256, 128, "head"),
    (200704, 128, 512, "tail"), (200704, 512, 128, "head_ds"),
    (200704, 512, 256, "head"), (50176, 256, 1024, "tail"),
    (50176, 1024, 256, "head_ds"), (50176, 1024, 512, "head"),
    (12544, 512, 2048, "tail"), (12544, 2048, 512, "head_ds")]


def k5_args(device, m, ci, co, dtype, form, seed=0):
    """Site inputs from numpy (the weight x 0.3)."""
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


def k5_device_args(device, m, ci, co, dtype, form, seed):
    """Site inputs drawn on the card (numpy is slow at 200 M values; the
    weight x 0.05)."""
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


def k5_close(got, ref, dtype):
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
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())
    tol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol[0],
                               atol=tol[1])


def k5_same_bits_and_close(args, kw, dtype):
    """K5 twice with the same bits, within ``k5_close`` of the plain
    version."""
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    got = fbb.bwd_site(*args, **kw)
    again = fbb.bwd_site(*args, **kw)
    torch.cuda.synchronize()
    k5_close(got, fbb.bwd_site_plain(*args, **kw), dtype)
    flat = lambda out: [t for t in (out[0], out[1], out[2], *out[3], *out[4])
                        if t is not None]
    for a, b in zip(flat(got), flat(again)):
        assert torch.equal(a, b)


def k5_site(device, site, dtype):
    """K5 at a resnet50 site, on the route its plan gives there (generic in
    float32; in bfloat16 fused at M = 802,816, tiled below)."""
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    m, ci, co, form = site
    args, kw = k5_device_args(device, m, ci, co, dtype, form,
                              seed=m + ci + co)
    in_act, has_mask, has_ds, _ = K5_FORMS[form]
    route = fbb._plan(m, ci, co, dtype, in_act, has_mask, has_ds,
                      True, fbb._sm_count(device.index or 0))[0]
    assert route == ("generic" if dtype == torch.float32 else
                     "fused" if m == 802816 else "tiled")
    before = fbb.LAUNCHES["fused_block_bwd"]
    k5_same_bits_and_close(args, kw, dtype)
    assert fbb.LAUNCHES["fused_block_bwd"] == before + 2


def k6_args(device, m, ci, co, dtype, seed=0, on_card=False):
    draw = k5_device_args if on_card else k5_args
    args, _ = draw(device, m, ci, co, dtype, "tail", seed)
    g, z, mask, x, _, w, mul_o, add_o, mul_i, add_i = args
    return [g, z, mask, x, w, mul_o, mul_i, add_i], add_o


def rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def k6(device, dtype, shape, on_card=False):
    """K6 twice with the same bits; gp exact, dW and the channel sums within
    1e-4 in norm of the plain version, dx by the bound below; and against
    K5's unified site: gp exact, dx within 8e-2 (bf16, the JAX test's
    bound) or 1e-5, dW and the sums within the same bounds in norm."""
    from openset_imagenet_tpu_torch.experimental import split_site as ss
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb

    args, add_o = k6_args(device, *shape, dtype, on_card=on_card)
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
        assert rel_norm(a, b) <= 1e-4
    # In f32 on the card's draw (the weight x 0.05), atol 1e-5; on numpy's
    # (x 0.3), atol 1e-5 of the largest |dx|: a 2048-deep f32 product
    # summed in another order than cuBLAS's is off by ~1e-6 of its terms,
    # which is more than 1e-5 of an entry that the sum cancels to near 0.
    # The absolute bound is not one for every shape: on the card's draw at
    # [3000, 512, 2048] one entry of 1,536,000 was 1.76e-5 off on an H100.
    # The card tests hold it at stage 4's tail, its ragged M and ragged
    # channels.
    tol = ((2e-2, 1e-2) if dtype == torch.bfloat16 else
           (1e-5, 1e-5) if on_card else
           (1e-5, 1e-5 * float(rdx.abs().max())))
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
        assert rel_norm(a, b) <= tol


# -- K7, the streaming probes (Triton) -----------------------------------------

def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


def k7(device, probe, shape):
    """One launch, the plain version's bits, and the same bits again."""
    from openset_imagenet_tpu_torch.ops import stream_probe as sp

    gen = torch.Generator(device=device).manual_seed(len(shape) + shape[1])
    a, b = (torch.randn(*shape, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    before = sp.LAUNCHES[f"stream_{probe}"]
    got = getattr(sp, probe)(a, b)
    assert sp.LAUNCHES[f"stream_{probe}"] == before + 1
    assert torch.equal(got, getattr(sp, f"{probe}_plain")(a, b))
    assert same_bits(getattr(sp, probe)(a, b), got)   # a second launch


# -- int8_conv, the quantized serving graph's convolution (CUDA C++) ---------

def i8_operands(device, b, h, cin, cout, k, groups, seed=0, extreme=False):
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


def i8_same(device, b, h, cin, cout, k, stride, groups=1, seed=0,
            dtype=torch.bfloat16, extreme=False):
    """One launch, bit-equal to the plain version."""
    from openset_imagenet_tpu_torch.ops import int8_conv as ic

    q, w, scale, bias = i8_operands(device, b, h, cin, cout, k, groups,
                                    seed, extreme)
    pad = 1 if k == 3 else 0
    before = ic.LAUNCHES["int8_conv"]
    got = ic.int8_conv(q, w, scale, bias, stride, pad, groups, dtype)
    torch.cuda.synchronize()
    assert ic.LAUNCHES["int8_conv"] == before + 1
    want = ic.int8_conv_plain(q, w, scale, bias, stride, pad, groups, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def im2col(q, k, stride, padding):
    """``[M, k*k*C]`` rows of an NHWC int8 tensor in the kernel's (tap,
    channel) order: a view for a 1x1 stride-1 conv, else a copy."""
    if k == 1 and stride == 1:
        return q.view(-1, q.shape[-1])
    qp = F.pad(q, (0, 0, padding, padding, padding, padding))
    cols = qp.unfold(1, k, stride).unfold(2, k, stride)
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * q.shape[-1])


def int8_at(device, shape, extreme, dtype, batch):
    """``i8_same`` at a resnet50 shape ``(H, Cin, Cout, k, stride)``; and
    cuBLASLt's int8 GEMM over an explicit im2col gives the plain version's
    int32 sums (the weight's [Cout, K] rows as the column-major [K, Cout]
    operand)."""
    from openset_imagenet_tpu_torch.ops import int8_conv as ic

    h, cin, cout, k, stride = shape
    seed = h + cin + cout
    i8_same(device, batch, h, cin, cout, k, stride, seed=seed, dtype=dtype,
            extreme=extreme)
    q, w, _, _ = i8_operands(device, batch, h, cin, cout, k, 1, seed,
                             extreme)
    pad = 1 if k == 3 else 0
    acc = ic.int8_conv_acc_plain(q, w, stride, pad, 1)
    assert torch.equal(torch._int_mm(im2col(q, k, stride, pad),
                                     w.view(cout, -1).t()),
                       acc.view(-1, cout))


# -- the batch-norm kernels (Triton) -------------------------------------------

def bn_same(a, b):
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(view), b.view(view)))


def bn_case(device, shape, dtype, layout, seed=0):
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


def bn_rel(a, b):
    return float((a.float() - b.float()).norm()
                 / max(float(b.float().norm()), 1e-30))


def bn_apply(device, shape, dtype, layout, ghost):
    """One launch in the input's layout, bit-equal to the plain version,
    and the same bits again."""
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, _, w, b, mean, var = bn_case(device, shape, dtype, layout)
    before = bnk.LAUNCHES["bn_apply"]
    y = bnk.bn_apply(x, mean, var, w, b, 1e-5, ghost)
    assert bnk.LAUNCHES["bn_apply"] == before + 1
    assert y.stride() == x.stride()
    assert bn_same(y, bnk.bn_apply_plain(x, mean, var, w, b, 1e-5, ghost))
    assert bn_same(y, bnk.bn_apply(x, mean, var, w, b, 1e-5, ghost))


def bn_stats(device, shape, layout, rows):
    """The statistics of the first ``rows`` images (0: all) and the running
    ones within rtol 1e-5 of the plain version's; the same bits again."""
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, _, _, _, rm, rv = bn_case(device, shape, torch.bfloat16, layout)
    window = min(rows, shape[0]) or shape[0]
    got_rm, got_rv, ref_rm, ref_rv = rm.clone(), rv.clone(), rm.clone(), \
        rv.clone()
    before = bnk.LAUNCHES["bn_stats"]
    got = bnk.bn_stats(x, window, got_rm, got_rv, 0.9)
    assert bnk.LAUNCHES["bn_stats"] == before + 1
    ref = bnk.bn_stats_plain(x, window, ref_rm, ref_rv, 0.9)
    torch.testing.assert_close(got[:2], ref[:2], rtol=1e-5, atol=1e-6)
    if rows == 64:
        # The train cells' window, whose means and variances lie far from
        # 0: each within 1e-5 of its size alone.  (A window of a few rows
        # can have a mean near 0, which float32 sums in another order miss
        # by more than 1e-5 of it.)
        rel = (got[:2] - ref[:2]).abs() / ref[:2].abs().clamp(min=1e-6)
        assert float(rel.max()) <= 1e-5
    torch.testing.assert_close(got_rm, ref_rm, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got_rv, ref_rv, rtol=1e-5, atol=1e-7)
    again = bnk.bn_stats(x, window, rm.clone(), rv.clone(), 0.9)
    assert torch.equal(got, again)


def bn_backward(device, shape, dtype, layout, rows):
    """One launch of each backward kernel; dx bit-equal outside the window
    and within 1e-3 (bf16) or 1e-5 in norm inside it, dweight and dbias
    1e-5; the same bits again; without a window, the direct term bit for
    bit."""
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk

    x, g, w, _, rm, rv = bn_case(device, shape, dtype, layout, seed=rows)
    window = min(rows, shape[0]) or shape[0]
    stats = bnk.bn_stats_plain(x, window, rm, rv, 0.9)
    ghost = rows > 0
    before = dict(bnk.LAUNCHES)
    got = bnk.bn_backward(g, x, w, stats, window, ghost, 1e-5)
    assert bnk.LAUNCHES["bn_bwd"] == before["bn_bwd"] + 1
    assert bnk.LAUNCHES["bn_fix"] == before["bn_fix"] + 1
    ref = bnk.bn_grad_plain(g, x, w, stats, window, ghost, 1e-5)
    assert got[0].stride() == x.stride()
    assert bn_same(got[0][window:], ref[0][window:])
    assert bn_rel(got[0][:window], ref[0][:window]) <= (
        1e-3 if dtype == torch.bfloat16 else 1e-5)
    for a, r in zip(got[1:], ref[1:]):
        assert bn_rel(a, r) <= 1e-5
    again = bnk.bn_backward(g, x, w, stats, window, ghost, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # Without a window (eval): the direct term alone, bit for bit.
    got = bnk.bn_backward(g, x, w, stats[:2].contiguous(), 0, ghost, 1e-5)
    ref = bnk.bn_grad_plain(g, x, w, stats[:2], 0, ghost, 1e-5)
    assert bn_same(got[0], ref[0])
    assert bn_rel(got[1], ref[1]) <= 1e-5


# -- the Swin's window attention (Triton) -------------------------------------

# Swin-B's stages: (side of the map, channels, heads).  Bounds on out,
# dqkv and dtable, relative in norm, by dtype (their reasons and readings
# beside test_window_attention_kernel_matches_plain).
WA_STAGES = [(56, 128, 4), (28, 256, 8), (14, 512, 16), (7, 1024, 32)]
WA_TOL = {torch.float32: (1e-5, 1e-5, 1e-5),
          torch.bfloat16: (1e-3, 1e-2, 1e-5)}


def wa_case(device, b, side, c, heads, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, side, side, 3 * c, generator=gen)
    table = torch.randn(169, heads, generator=gen)
    grad = torch.randn(b, side, side, c, generator=gen)
    return (qkv.to(device, dtype), table.to(device), grad.to(device, dtype))


def wa_grads(fn, qkv, table, grad, shift):
    qkv = qkv.clone().requires_grad_()
    table = table.clone().requires_grad_()
    out = fn(qkv, table, 7, shift)
    out.backward(grad)
    return out.detach(), qkv.grad, table.grad


def window_attention(device, stage, shift, dtype, batch):
    """One launch each way; the output and both gradients the same bits on
    a second run, and within ``WA_TOL`` of the plain version."""
    from openset_imagenet_tpu_torch.ops import window_attention as wak

    side, c, heads = WA_STAGES[stage]
    qkv, table, grad = wa_case(device, batch, side, c, heads, dtype,
                               seed=stage)
    before = dict(wak.LAUNCHES)
    got = wa_grads(wak.window_attention, qkv, table, grad, shift)
    assert wak.LAUNCHES == {"win_attn_fwd": before["win_attn_fwd"] + 1,
                            "win_attn_bwd": before["win_attn_bwd"] + 1}
    again = wa_grads(wak.window_attention, qkv, table, grad, shift)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = wa_grads(wak.window_attention_plain, qkv, table, grad, shift)
    for name, a, b, tol in zip(("out", "dqkv", "dtable"), got, want,
                               WA_TOL[dtype]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bn_rel(a, b) <= tol, (name, bn_rel(a, b))


# -- the Swin's LayerNorm and residual junction (Triton) ----------------------

# Swin-B's distinct LayerNorms at 224 px and batch 256: (rows, C, fused
# with the junction).  Fused: each stage's junctions (the final
# LayerNorm's too, at stage 4's shape); alone: the patch embedding's and
# each stage's first norm1 at the stage's shape, patch merging's at 4C.
LN_SITES = [(802816, 128, True), (200704, 256, True), (50176, 512, True),
            (12544, 1024, True), (802816, 128, False), (200704, 256, False),
            (50176, 512, False), (12544, 1024, False), (200704, 512, False),
            (50176, 1024, False), (12544, 2048, False)]


def ln_case(device, rows, c, dtype, seed=0):
    """``x``, ``y``, the float32 ``b``, weight and bias, and the output
    gradients of ``n`` and ``h``, drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(seed + rows + c)
    draw = lambda *s, scale=1.0, shift=0.0: torch.randn(
        *s, generator=gen, device=device) * scale + shift
    return (draw(rows, c, scale=2.0, shift=0.5).to(dtype),
            draw(rows, c).to(dtype), draw(c, scale=0.1),
            draw(c, scale=0.3, shift=1.0), draw(c, scale=0.1),
            draw(rows, c).to(dtype), draw(rows, c).to(dtype))


def ln_run(x, y, b, w, beta, gn, gh):
    """``(h, n, dx, dy, db, dweight, dbias)`` through the kernels (``y``
    None: the LayerNorm alone; ``gh`` None: no gradient of ``h``)."""
    from openset_imagenet_tpu_torch.ops import layer_norm as lnk

    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (x, y, b, w, beta)]
    x, y, b, w, beta = leaves
    if y is None:
        h, n = x, lnk.layer_norm(x, w, beta, 1e-5)
        n.backward(gn)
    else:
        h, n = lnk.add_layer_norm(x, y, b, w, beta, 1e-5)
        torch.autograd.backward([n, h] if gh is not None else [n],
                                [gn, gh] if gh is not None else [gn])
    return [h.detach(), n.detach()] + [None if t is None else t.grad
                                       for t in leaves]


def layer_norm(device, site, dtype, grad_h=True):
    """One launch each way; ``h`` bit-equal to the written-out add, ``n``
    within one bfloat16 step (2**-7 of the larger, 1e-5 absolute where the
    row cancels to near 0) of ``F.layer_norm``'s, ``dh`` within 1e-3
    (bfloat16) or 1e-5 (float32) in norm of the plain formula's, the
    weight and bias gradients within 1e-5 in norm, the ``b`` gradient the
    float32 sum of the ``dh`` written within 1e-6 in norm (sums in another
    order; against the plain version's ``dh`` it would inherit the few
    elements where the two ``dh`` round apart: 1.28e-5 at the final
    junction in bfloat16 on an H100); every output the same bits on a
    second run."""
    from openset_imagenet_tpu_torch.ops import layer_norm as lnk

    rows, c, add = site
    x, y, b, w, beta, gn, gh = ln_case(device, rows, c, dtype)
    if not add:
        y = b = gh = None
    elif not grad_h:
        gh = None
    form = "ln_add" if add else "ln"
    before = dict(lnk.LAUNCHES)
    got = ln_run(x, y, b, w, beta, gn, gh)
    assert lnk.LAUNCHES[f"{form}_fwd"] == before[f"{form}_fwd"] + 1
    assert lnk.LAUNCHES[f"{form}_bwd"] == before[f"{form}_bwd"] + 1
    again = ln_run(x, y, b, w, beta, gn, gh)
    for a, r in zip(got, again):
        assert (a is None) == (r is None)
        assert a is None or torch.equal(a, r)
    h, n, dx, dy, db, dw, dbeta = got
    ph, pn, mean, rstd = lnk.layer_norm_plain(x, w, beta, 1e-5, y, b)
    assert torch.equal(h, ph)
    step = torch.maximum(n.float().abs(), pn.float().abs()) * 2 ** -7
    worst = float(((n.float() - pn.float()).abs() - step).max())
    assert worst <= 1e-5, ("n", worst)
    want = lnk.layer_norm_grad_plain(gn, gh, ph, mean, rstd, w, add)
    assert bn_rel(dx, want[0]) <= (1e-3 if dtype == torch.bfloat16
                                   else 1e-5), ("dh", bn_rel(dx, want[0]))
    if add:
        assert torch.equal(dx, dy)
        assert db.dtype == torch.float32
        assert bn_rel(db, dx.float().sum(0)) <= 1e-6, (
            "db", bn_rel(db, dx.float().sum(0)))
    for name, a, r in (("dweight", dw, want[1]), ("dbias", dbeta, want[2])):
        assert a.dtype == torch.float32 and bn_rel(a, r) <= 1e-5, (
            name, bn_rel(a, r))


# -- the main path --------------------------------------------------------------

# Each kernel at its main path's shape, in the cells' dtype: (kernel,
# check, its arguments after the device).  The loss kernels as the
# entropic cells ([256, 116]) and the garbage loss at batch 64 ([64, 117])
# take them, K5 and K6 at resnet50's stage-1 tail at batch 256, K7 at the
# bench tool's [8, 3136, 256], int8_conv at resnet50's stage-1 3x3 conv at
# batch 256, batch-norm at a resnet50 map at batch 256 with a window of 64
# images, the window attention at Swin-B's four stages at batch 256, the
# LayerNorm fused at Swin-B's stages 1 and 3 and alone at patch merging's
# 2,048 channels, at batch 256.
MAIN_PATH = [
    ("entropic_fwd", entropic_fwd, (256, 116, 1.0)),
    ("entropic_bwd", entropic_bwd, (256, 116, 1.0)),
    ("ce_fwd", ce_fwd, (64, 117)),
    ("ce_bwd", ce_bwd, (64, 117)),
    ("fused_block_bwd", k5_site, (RESNET50_SITES[0], torch.bfloat16)),
    ("split_site", k6, (torch.bfloat16, (802816, 64, 256), True)),
    ("stream_axpy", k7, ("axpy", (8, 3136, 256))),
    ("stream_relu_mask", k7, ("relu_mask", (8, 3136, 256))),
    ("int8_conv", int8_at, ((56, 64, 64, 3, 1), False, torch.bfloat16,
                            256)),
    ("bn_stats", bn_stats, ((256, 256, 56, 56), "channels_last", 64)),
    ("bn_apply", bn_apply, ((256, 256, 56, 56), torch.bfloat16,
                            "channels_last", True)),
    ("bn_backward", bn_backward, ((256, 256, 56, 56), torch.bfloat16,
                                  "channels_last", 64)),
    *(("window_attention", window_attention,
       (stage, 0 if stage == 3 else 3, torch.bfloat16, 256))
      for stage in range(4)),
    *(("layer_norm", layer_norm, (LN_SITES[i], torch.bfloat16))
      for i in (0, 2, 10)),
]
