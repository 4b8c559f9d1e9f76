"""The Swin's LayerNorm and residual junction (``ops/layer_norm.py``) on
the CPU, through its plain versions.

* The forward against the written-out path it replaces, ``x + (y +
  b.to(dtype))`` then ``F.layer_norm`` with the weight and bias cast to
  the dtype: ``h`` and ``n`` bit-equal, in float32 and bfloat16, fused and
  standalone.
* The backward's formula (``layer_norm_grad_plain``, what the kernel
  computes) through the autograd node against autograd of the written-out
  path, with the gradient of ``h`` present (``h`` is the next junction's
  residual) and absent (the final LayerNorm's, and every standalone one):
  the gradients of ``x``, ``y``, ``b``, the weight and the bias within
  1e-6 of their norm in float32 (sums in another order), 1e-12 in
  float64.
* The model's sites, counted through wrappers: 7 fused and 4 standalone in
  ``tiny_swin``, 45 and 8 in Swin-B (on ``meta``), and Swin-B's distinct
  ``(tokens, C, form)`` against the card checks' list; the ``state_dict``
  names unchanged; ``Dense.product`` the forward without the bias.
* The launch plans cover every row once; what the wrappers refuse.
"""

import math

import pytest
import torch
import torch.nn.functional as F

import cuda_checks as cc
from benchmark_torch.lib import family_swin as ref
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.models import swin
from openset_imagenet_tpu_torch.models.resnet import Dense
from openset_imagenet_tpu_torch.ops import layer_norm as lnk

EPS = swin.LN_EPSILON


def _case(dtype, shape=(3, 5, 7, 64), seed=0):
    """``x``, ``y``, the float32 ``b``, weight and bias, and the output
    gradients of ``n`` and ``h``."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    draw = lambda *s, scale=1.0, shift=0.0: torch.randn(
        *s, generator=gen) * scale + shift
    x = draw(*shape, scale=2.0, shift=0.5).to(dtype)
    y = draw(*shape).to(dtype)
    vec = [draw(c, scale=0.1), draw(c, scale=0.3, shift=1.0),
           draw(c, scale=0.1)]
    return x, y, *vec, draw(*shape).to(dtype), draw(*shape).to(dtype)


def _written_out(x, y, b, w, beta):
    h = x if y is None else x + (y + b.to(y.dtype))
    n = F.layer_norm(h, (h.shape[-1],), w.to(h.dtype), beta.to(h.dtype), EPS)
    return h, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("add", [True, False])
def test_plain_forward_is_the_written_out_path(dtype, add):
    x, y, b, w, beta, _, _ = _case(dtype)
    want_h, want_n = _written_out(x, y if add else None, b, w, beta)
    got = lnk.layer_norm_plain(x, w, beta, EPS, *((y, b) if add else ()))
    assert torch.equal(got[0], want_h) and got[0].dtype == dtype
    assert torch.equal(got[1], want_n) and got[1].dtype == dtype
    if add:
        h, n = lnk.add_layer_norm(x, y, b, w, beta, EPS)
        assert torch.equal(h, want_h) and torch.equal(n, want_n)
    else:
        assert torch.equal(lnk.layer_norm(x, w, beta, EPS), want_n)
    var, mean = torch.var_mean(want_h.float(), dim=-1, unbiased=False)
    assert got[2].dtype == got[3].dtype == torch.float32
    assert torch.equal(got[2], mean)
    assert torch.equal(got[3], torch.rsqrt(var + EPS))


def _grads(fn, x, y, b, w, beta, gn, gh, add):
    """Gradients of ``sum(n * gn) (+ sum(h * gh))`` in ``x``, ``y``, ``b``,
    the weight and the bias."""
    leaves = [t.clone().requires_grad_() for t in (x, y, b, w, beta)]
    x, y, b, w, beta = leaves
    if add:
        h, n = fn(x, y, b, w, beta)
    else:
        h, n = None, fn(x, None, None, w, beta)
    loss = (n.float() * gn.float()).sum()
    if gh is not None:
        loss = loss + (h.float() * gh.float()).sum()
    loss.backward()
    return [t.grad for t in (leaves if add else (x, w, beta))]


def _op(x, y, b, w, beta):
    if y is None:
        return lnk.layer_norm(x, w, beta, EPS)
    return lnk.add_layer_norm(x, y, b, w, beta, EPS)


def _reference(x, y, b, w, beta):
    h, n = _written_out(x, y, b, w, beta)
    return n if y is None else (h, n)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("form", ["add, grad_h", "add", "alone"])
def test_plain_backward_matches_autograd_of_the_written_out_path(dtype, tol,
                                                                 form):
    add = form != "alone"
    x, y, b, w, beta, gn, gh = _case(dtype, seed=1)
    gh = gh if form == "add, grad_h" else None
    got = _grads(_op, x, y, b, w, beta, gn, gh, add)
    want = _grads(_reference, x, y, b, w, beta, gn, gh, add)
    for name, a, r in zip(("x", "y", "b", "weight", "bias") if add else
                          ("x", "weight", "bias"), got, want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert float((a - r).norm() / r.norm()) <= tol, name


def test_plain_backward_in_bfloat16_is_the_float64_gradient_rounded():
    """In bfloat16 the junction's gradients against float64 autograd of the
    same rounded values: ``dh`` the LayerNorm's gradient rounded once,
    added to ``h``'s other gradient and rounded again, within 1e-4 in norm
    (a flip of one element in 6,720 reads 5e-5; reads 0); the weight,
    bias and ``b`` gradients float32 sums within 1e-6.  (Autograd of the
    written-out path on the CPU rounds inner terms of the LayerNorm's
    gradient to bfloat16 and reads 1.6e-3 off ``dh``; its sums are
    bfloat16.)"""
    x, y, b, w, beta, gn, gh = _case(torch.bfloat16, seed=2)
    got = _grads(_op, x, y, b, w, beta, gn, gh, True)
    assert torch.equal(got[0], got[1])   # dx and dy: the one dh
    dt = torch.bfloat16
    h = (x + (y + b.to(dt))).double().requires_grad_()
    w64, beta64 = w.to(dt).double().requires_grad_(), beta.to(dt).double(
        ).requires_grad_()
    n = F.layer_norm(h, (h.shape[-1],), w64, beta64, EPS)
    (n * gn.double()).sum().backward()
    dh = (h.grad.to(dt).double() + gh.double()).to(dt)
    assert float((got[0].double() - dh.double()).norm()
                 / dh.double().norm()) <= 1e-4
    rows = tuple(range(dh.dim() - 1))
    for a, r in ((got[2], dh.double().sum(dim=rows)), (got[3], w64.grad),
                 (got[4], beta64.grad)):
        assert a.dtype == torch.float32
        assert float((a.double() - r).norm() / r.norm()) <= 1e-6


def test_undefined_gradient_of_n_passes_h_through():
    x, y, b, w, beta, _, gh = _case(torch.float32, seed=3)
    x.requires_grad_()
    h, _ = lnk.add_layer_norm(x, y, b, w, beta, EPS)
    h.backward(gh)
    assert torch.equal(x.grad, gh)


def _count(monkeypatch, real=True):
    """Wrap the model's two LayerNorm entry points; each call's
    ``(tokens, C, form)``."""
    sites = []

    def alone(x, weight, bias, eps):
        sites.append((x.numel() // x.shape[-1], x.shape[-1], "ln"))
        if real:
            return lnk.layer_norm(x, weight, bias, eps)
        return torch.empty_like(x)

    def fused(x, y, y_bias, weight, bias, eps):
        sites.append((x.numel() // x.shape[-1], x.shape[-1], "ln_add"))
        if real:
            return lnk.add_layer_norm(x, y, y_bias, weight, bias, eps)
        return torch.empty_like(x), torch.empty_like(x)

    monkeypatch.setattr(swin, "layer_norm", alone)
    monkeypatch.setattr(swin, "add_layer_norm", fused)
    return sites


def _forms(sites):
    return (sum(form == "ln_add" for _, _, form in sites),
            sum(form == "ln" for _, _, form in sites))


def test_tiny_swin_train_step_sites(monkeypatch):
    """A tiny_swin train step: 7 junctions fused with their LayerNorm (the
    four ``norm2``, the second block's ``norm1`` of each stage, the final
    LayerNorm) and 4 alone (the patch embedding's, each stage's first
    ``norm1``, patch merging's), one call each."""
    import numpy as np

    sites = _count(monkeypatch)
    model = engine.build_model(NameSpace({"model": {
        "arch": "swin", "variant": "tiny_swin"}}), 6, device="cpu").train()
    step = engine.make_train_step(engine.make_loss_fn("entropic"))
    tx = engine.build_optimizer(NameSpace({"type": "adam", "lr": 1e-3}),
                                steps_per_epoch=1)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    step(engine.create_state(model, tx), images, rng.integers(-1, 6, 4),
         np.ones(4, np.float32))
    assert _forms(sites) == (7, 4)
    assert all(p.grad is not None for p in model.parameters())


def _meta_swin_b_sites(monkeypatch, batch):
    sites = _count(monkeypatch, real=False)
    monkeypatch.setattr(swin, "window_attention",
                        lambda qkv, table, ws, shift: qkv[..., :qkv.shape[-1]
                                                          // 3])
    model = swin.build_swin("swin_b", fc_layer_dim=116, out_features=116,
                            device="meta")
    model(torch.empty(batch, 224, 224, 3, device="meta"))
    return sites


def test_swin_b_sites_on_meta(monkeypatch):
    """Swin-B's 53 LayerNorms: 45 fused (24 ``norm2``, 20 ``norm1`` of the
    blocks after a stage's first, the final one), 8 alone; at batch 256
    its distinct shapes are the card checks' (``cuda_checks.LN_SITES``)."""
    sites = _meta_swin_b_sites(monkeypatch, 2)
    assert _forms(sites) == (45, 8)
    sites = _meta_swin_b_sites(monkeypatch, 256)
    assert sorted(set(sites)) == sorted(
        (rows, c, "ln_add" if add else "ln") for rows, c, add in cc.LN_SITES)


def test_state_dict_names_unchanged():
    cfg = {"image_size": 224, "patch_size": 4, "embed_dim": 128,
           "depths": [2, 2, 18, 2], "num_heads": [4, 8, 16, 32],
           "window_size": 7, "mlp_ratio": 4, "fc_layer_dim": 116,
           "n_classes": 116}
    model = swin.build_swin("swin_b", fc_layer_dim=116, out_features=116,
                            device="meta")
    names = set(model.state_dict())
    assert names == {name for name, _, _ in ref.spec(cfg)}
    assert {"patch_embed.norm.weight", "layers.0.blocks.0.norm1.bias",
            "layers.2.blocks.17.norm2.weight", "layers.2.downsample.norm.bias",
            "layers.3.blocks.1.attn.proj.bias",
            "layers.3.blocks.1.mlp.fc2.bias", "norm.weight"} <= names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_product_is_forward_without_the_bias(dtype):
    gen = torch.Generator().manual_seed(4)
    dense = Dense(16, 8)
    with torch.no_grad():
        dense.weight.copy_(torch.randn(8, 16, generator=gen))
        dense.bias.copy_(torch.randn(8, generator=gen))
    x = torch.randn(5, 16, generator=gen).to(dtype)
    y = dense.product(x)
    assert torch.equal(dense(x), y + dense.bias.to(dtype))


@pytest.mark.parametrize("rows,c,add", cc.LN_SITES + [(5, 96, True),
                                                      (1, 2048, False),
                                                      (3, 7, True)])
def test_plans_cover_every_row_once(rows, c, add):
    plan = lnk._plan(rows, c)
    for launch in plan:
        assert launch.block_c >= c and launch.block_c == 1 << (
            launch.block_c.bit_length() - 1)
        per = launch.tiles * launch.block_m
        assert (launch.grid - 1) * per < rows <= launch.grid * per
    for launch, settings in zip(plan, (lnk._FWD, lnk._BWD)):
        assert launch.block_m * launch.block_c <= max(settings["elems"],
                                                      launch.block_c)
        assert launch.grid <= settings["programs"]
        assert launch.warps == settings["warps"]
    groups = math.ceil(plan.bwd.grid / lnk._GROUP)
    assert groups + 1 <= 64   # the ticket array's smallest size


def test_wrappers_refuse_what_they_do_not_take():
    x, y, b, w, beta, _, _ = _case(torch.float32)
    with pytest.raises(ValueError, match="differ"):
        lnk.add_layer_norm(x, y[:1], b, w, beta, EPS)
    with pytest.raises(ValueError, match="differ"):
        lnk.add_layer_norm(x, y.double(), b, w, beta, EPS)
    with pytest.raises(ValueError, match="non-empty"):
        lnk.layer_norm(x[:0], w, beta, EPS)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lnk.layer_norm(x.to("meta"), w.to("meta"), beta.to("meta"), EPS)
