"""The Swin's window attention (``ops/window_attention.py``) on the CPU.

The op's plain version is held against the written-out path it replaces
in ``models/swin.py``'s earlier form: ``torch.roll`` by ``-shift``,
``window_partition``, q, k and v split by head, the bias gathered by
``relative_position_index`` plus ``region_mask``, a float softmax, the
product with v, ``window_reverse`` and the reverse roll.  In float32 the
output and the gradients of ``qkv`` and of the bias table agree to 1e-5
of their norms (the two differ only in the order of float32 sums: the
scale after the product, the softmax as ``exp(s - logsumexp(s))``); in
float64 to 1e-12.  Cases: shifted and unshifted windows of 4 on an 8x8
map, windows of 7 on a 14x14 map shifted by 3, a map equal to its window,
a window smaller than the table's, a map that is not square.

Also: the token index map the kernels address against
``window_partition(torch.roll(x, ...))``, the bias index and region rule
against ``relative_position_index`` and ``region_mask``, the bf16
rounding points (P rounded before PV, scores not rounded, the output
rounded once), the CPU route (the plain version, no launch), the
refusals every device shares, and the kernels' launch plan (every window
in exactly one program's run).
"""

import pytest
import torch

from openset_imagenet_tpu_torch.models import swin
from openset_imagenet_tpu_torch.ops import window_attention as wa

# (batch, H, W, ws, shift, heads, head size, table window)
CASES = [
    (2, 8, 8, 4, 0, 2, 16, 4),
    (2, 8, 8, 4, 2, 2, 16, 4),
    (2, 14, 14, 7, 3, 2, 16, 7),
    (2, 14, 14, 7, 0, 3, 8, 7),
    (3, 4, 4, 4, 0, 2, 16, 4),       # the map is one window
    (1, 7, 7, 7, 0, 4, 8, 7),
    (2, 12, 12, 6, 3, 2, 16, 7),     # a window smaller than the table's
    (2, 8, 12, 4, 2, 2, 16, 4),      # not square
]


def _case(case, dtype, seed=0):
    b, h, w, ws, shift, heads, hd, table_ws = case
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, h, w, 3 * heads * hd, generator=gen).to(dtype)
    table = torch.randn((2 * table_ws - 1) ** 2, heads, generator=gen)
    grad = torch.randn(b, h, w, heads * hd, generator=gen).to(dtype)
    return qkv, table.to(torch.promote_types(dtype, torch.float32)), grad


def _written_out(qkv, table, ws, shift, round_p=False):
    """The path the op replaces, in ``qkv``'s dtype (at least float32 for
    the scores and the softmax)."""
    b, h, w, c3 = qkv.shape
    c, heads = c3 // 3, table.shape[1]
    n, hd = ws * ws, c // heads
    table_ws = (int(table.shape[0] ** 0.5) + 1) // 2
    f32 = torch.promote_types(qkv.dtype, torch.float32)
    y = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    win = swin.window_partition(y, ws)
    bw = win.shape[0]
    q, k, v = win.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).to(
        f32).unbind(0)
    index = swin.relative_position_index(ws, table_ws)
    bias = table[index].view(n, n, heads).permute(2, 0, 1).to(f32)
    s = (q * hd ** -0.5) @ k.transpose(-1, -2) + bias
    if shift:
        region = swin.region_mask(h, w, ws, shift).to(f32)
        nw = region.shape[0]
        s = (s.view(bw // nw, nw, heads, n, n) + region[None, :, None]
             ).view(bw, heads, n, n)
    p = torch.softmax(s, -1)
    if round_p:
        p = p.to(qkv.dtype).to(f32)
    out = (p @ v).to(qkv.dtype).transpose(1, 2).reshape(bw, n, c)
    out = swin.window_reverse(out, ws, h, w)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _grads(fn, qkv, table, grad, ws, shift):
    qkv = qkv.clone().requires_grad_()
    table = table.clone().requires_grad_()
    out = fn(qkv, table, ws, shift)
    out.backward(grad)
    return out.detach(), qkv.grad, table.grad


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_written_out_path(case, dtype, tol):
    qkv, table, grad = _case(case, dtype)
    ws, shift = case[3], case[4]
    got = _grads(wa.window_attention_plain, qkv, table, grad, ws, shift)
    want = _grads(_written_out, qkv, table, grad, ws, shift)
    for name, a, b in zip(("out", "dqkv", "dtable"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) < tol, (name, _rel(a, b))


@pytest.mark.parametrize("case", CASES)
def test_token_index_is_the_roll_and_the_partition(case):
    b, h, w, ws, shift = case[:5]
    x = torch.randn(b, h, w, 5)
    want = swin.window_partition(torch.roll(x, (-shift, -shift), (1, 2)), ws)
    index = wa.token_index(h, w, ws, shift)
    assert index.shape == ((h // ws) * (w // ws), ws * ws)
    got = x.reshape(b, h * w, 5)[:, index.view(-1)].reshape(-1, ws * ws, 5)
    assert torch.equal(got, want)
    assert torch.equal(index.view(-1).sort().values, torch.arange(h * w))


@pytest.mark.parametrize("case", CASES)
def test_bias_index_and_regions_are_the_official_ones(case):
    _, h, w, ws, shift, _, _, table_ws = case
    assert torch.equal(wa.bias_index(ws, table_ws).view(-1),
                       swin.relative_position_index(ws, table_ws))
    if shift:
        ids = wa.region_ids(h, w, ws, shift)
        mask = torch.where(ids[:, :, None] != ids[:, None, :], wa.MASKED, 0.0)
        assert torch.equal(mask, swin.region_mask(h, w, ws, shift))


@pytest.mark.parametrize("case", [CASES[1], CASES[2]])
def test_bf16_rounding_points(case):
    """bf16: P rounded before the PV product and the output rounded once,
    bit for bit; the scores are not rounded (rounding them, or leaving P
    unrounded, gives other bits)."""
    qkv, table, _ = _case(case, torch.bfloat16, seed=4)
    ws, shift = case[3], case[4]
    got = wa.window_attention_plain(qkv, table, ws, shift)
    assert got.dtype == torch.bfloat16
    # The plain version's own gathers, with its rounding points written out.
    b, h, w, c3 = qkv.shape
    heads, n = table.shape[1], ws * ws
    hd = c3 // 3 // heads
    index = wa.token_index(h, w, ws, shift)
    nw = index.shape[0]
    t = qkv.reshape(b, h * w, 3, heads, hd)[:, index.view(-1)]
    q, k, v = t.view(b, nw, n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5).float(
        ).unbind(0)
    bias = table[wa.bias_index(ws, case[7]).view(-1)].view(
        n, n, heads).permute(2, 0, 1)
    ids = wa.region_ids(h, w, ws, shift)
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + bias + torch.where(
        ids[:, :, None] != ids[:, None, :], wa.MASKED, 0.0)[:, None]

    def finish(p):
        out = (p @ v).to(torch.bfloat16).permute(0, 1, 3, 2, 4).reshape(
            b, nw * n, heads * hd)
        return out[:, torch.argsort(index.view(-1))].view(b, h, w, -1)

    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    assert torch.equal(got, finish(p.bfloat16().float()))
    assert not torch.equal(got, finish(p))
    s16 = s.bfloat16().float()
    p16 = torch.exp(s16 - torch.logsumexp(s16, -1, keepdim=True))
    assert not torch.equal(got, finish(p16.bfloat16().float()))
    # Within bf16's rounding of the written-out path that rounds P alike.
    want = _written_out(qkv, table, ws, shift, round_p=True)
    assert _rel(got.float(), want.float()) < 1e-2


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    qkv, table, _ = _case(CASES[1], torch.float32)
    before = dict(wa.LAUNCHES)
    got = wa.window_attention(qkv, table, 4, 2)
    assert wa.LAUNCHES == before
    assert torch.equal(got, wa.window_attention_plain(qkv, table, 4, 2))


def test_refuses_what_no_device_takes():
    qkv, table, _ = _case(CASES[1], torch.float32)
    for args, match in (((qkv[..., :-1], table, 4, 2), r"\[B, H, W, 3C\]"),
                        ((qkv[0], table, 4, 2), r"\[B, H, W, 3C\]"),
                        ((qkv, table[:-1], 4, 2), "bias table"),
                        ((qkv, table[:, :1].repeat(1, 3), 4, 2), "heads"),
                        ((qkv, table, 3, 1), "windows"),
                        ((qkv, table, 4, 4), "shifted by 4"),
                        ((qkv, table, 8, 0), "table of window 4")):
        with pytest.raises(ValueError, match=match):
            wa.window_attention(*args)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wa.window_attention(qkv.to("meta"), table.to("meta"), 4, 2)


# Swin-B's four stages at batch 256 (windows, heads, tokens), tiny_swin's
# two at batch 8, and small batches.
PLANS = [(16384, 4, 49), (4096, 8, 49), (1024, 16, 49), (256, 32, 49),
         (32, 2, 16), (8, 4, 16), (1, 1, 49), (7, 3, 49)]


@pytest.mark.parametrize("n_win,heads,n", PLANS)
def test_plan_walks_every_window_once(n_win, heads, n):
    plan = wa._plan(n_win, heads, n, 7)
    assert plan.block_n >= n and plan.block_n & (plan.block_n - 1) == 0
    assert plan.block_n >= 16 and plan.block_r == 256
    for per, grid, cap in ((plan.fwd_per, plan.fwd_grid, wa._FWD_PROGRAMS),
                           (plan.bwd_per, plan.bwd_grid, wa._BWD_PROGRAMS)):
        runs = [range(g * per, min(g * per + per, n_win))
                for g in range(grid)]
        assert all(len(r) > 0 for r in runs)
        assert sorted(w for r in runs for w in r) == list(range(n_win))
        assert grid * heads <= max(cap, heads)
