"""The two-head Swin Transformer family (:mod:`.families`): its plain
float32 reference, seeded weights and FLOP count, in plain ``torch``.  It
imports no module of the program.

The architecture is Swin (Liu et al., arXiv 2103.14030, section 3 and
Table 1; the official ``models/swin_transformer.py``) with the open-set
recipe's two heads: patch embedding (a ``patch_size`` convolution with
bias, LayerNorm); stages of pre-LayerNorm blocks, window attention with a
relative-position bias table and, in odd blocks, a cyclic shift by half a
window with the region mask (-100) of the official code, where the map is
larger than the window (else the window is the map and nothing shifts);
an MLP with exact GELU; patch merging (2x2 neighbours, LayerNorm, a linear
without bias) between stages; a final LayerNorm, the mean over tokens,
``fc`` (the features, with bias) and ``logits`` (no bias).  Stochastic
depth and dropout are left out, as in the program.  The configuration
gives the widths: ``patch_size``, ``embed_dim``, ``depths``,
``num_heads``, ``window_size``, ``mlp_ratio``.

Everything is float32 with TF32 off; attention is written out (scores,
bias, mask, softmax, product).  ``quant="fp8"`` is the control: every
linear layer's and the patch convolution's input and kernel in float8
e4m3, their gradients in e5m2.  The loss is the entropic loss of
:func:`.reference.entropic_rows` over the batch, taken in blocks of rows
(exact: no layer couples rows), then Adam.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .reference import _rounder, _to_input, entropic_rows, exact_float32

LN_EPS = 1e-5
MASKED = -100.0
control_quant = "fp8"


def model_options(cfg: dict) -> dict:
    return {"arch": "swin", "variant": cfg["variant"]}


def _stages(cfg: dict):
    """``(stage, depth, heads, width, map side, window)`` of each stage;
    the window is the map where the map is no larger (the official
    rule)."""
    side = int(cfg["image_size"]) // int(cfg["patch_size"])
    dim, window = int(cfg["embed_dim"]), int(cfg["window_size"])
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        yield i, int(depth), int(heads), dim, side, min(window, side)
        dim, side = 2 * dim, side // 2


def spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter, in the program's
    names."""
    p, c = int(cfg["patch_size"]), int(cfg["embed_dim"])
    ratio = float(cfg["mlp_ratio"])
    out = [("patch_embed.proj.weight", (c, 3, p, p), "conv"),
           ("patch_embed.proj.bias", (c,), "bias"),
           ("patch_embed.norm.weight", (c,), "ln_weight"),
           ("patch_embed.norm.bias", (c,), "ln_bias")]
    last = len(cfg["depths"]) - 1
    for i, depth, heads, d, _, ws in _stages(cfg):
        hidden = int(d * ratio)
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            out += [(f"{b}.norm1.weight", (d,), "ln_weight"),
                    (f"{b}.norm1.bias", (d,), "ln_bias"),
                    (f"{b}.attn.relative_position_bias_table",
                     ((2 * ws - 1) ** 2, heads), "trunc"),
                    (f"{b}.attn.qkv.weight", (3 * d, d), "trunc"),
                    (f"{b}.attn.qkv.bias", (3 * d,), "bias"),
                    (f"{b}.attn.proj.weight", (d, d), "trunc"),
                    (f"{b}.attn.proj.bias", (d,), "bias"),
                    (f"{b}.norm2.weight", (d,), "ln_weight"),
                    (f"{b}.norm2.bias", (d,), "ln_bias"),
                    (f"{b}.mlp.fc1.weight", (hidden, d), "trunc"),
                    (f"{b}.mlp.fc1.bias", (hidden,), "bias"),
                    (f"{b}.mlp.fc2.weight", (d, hidden), "trunc"),
                    (f"{b}.mlp.fc2.bias", (d,), "bias")]
        if i < last:
            m = f"layers.{i}.downsample"
            out += [(f"{m}.norm.weight", (4 * d,), "ln_weight"),
                    (f"{m}.norm.bias", (4 * d,), "ln_bias"),
                    (f"{m}.reduction.weight", (2 * d, 4 * d), "trunc")]
    final = int(cfg["embed_dim"]) * 2 ** last
    fc = int(cfg["fc_layer_dim"])
    out += [("norm.weight", (final,), "ln_weight"),
            ("norm.bias", (final,), "ln_bias"),
            ("fc.weight", (fc, final), "dense"),
            ("fc.bias", (fc,), "bias"),
            ("logits.weight", (int(cfg["n_classes"]), fc), "dense")]
    return out


def param_names(cfg: dict) -> List[str]:
    return [n for n, _, _ in spec(cfg)]


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights, drawn on ``device`` in one call.

    Every block linear, the merging reductions and the bias tables
    N(0, 0.02) truncated at two standard deviations (the official
    initialisation); LayerNorm scales 1 + N(0, 0.01) and biases
    N(0, 0.01); every linear bias, the patch convolution's and the
    features head's N(0, 0.01); the patch convolution N(0, 1 / fan-in)
    and the two heads N(0, 1 / fan-in), as the ResNet family draws its
    dense layers.  (N(m, v): mean m, variance v.)
    """
    items = spec(cfg)
    sizes = [math.prod(shape) for _, shape, _ in items]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    lo = float(torch.special.ndtr(torch.tensor(-2.0)))
    out = {}
    for (name, shape, kind), part in zip(items, flat.split(sizes)):
        z = part.view(shape)
        if kind == "trunc":
            # A normal draw carried through its CDF onto [-2, 2].
            u = lo + (1.0 - 2.0 * lo) * torch.special.ndtr(z)
            out[name] = 0.02 * torch.special.ndtri(u)
        elif kind == "conv":
            out[name] = z * math.sqrt(1.0 / math.prod(shape[1:]))
        elif kind == "dense":
            out[name] = z * math.sqrt(1.0 / shape[1])
        elif kind == "ln_weight":
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def _partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _reverse(t: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    c = t.shape[-1]
    t = t.reshape(-1, h // ws, w // ws, ws, ws, c)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def _relative_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def _shift_mask(side: int, ws: int, shift: int) -> torch.Tensor:
    """``[nW, N, N]``: 0 within a region of the shifted map, -100
    across."""
    img = torch.zeros(1, side, side, 1)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = _partition(img, ws).view(-1, ws * ws)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASKED)


def forward(w: dict, x: torch.Tensor, cfg: dict,
            quant: Optional[str] = None):
    """``x``: float32 ``[B, H, W, 3]`` in [0, 1] -> ``(logits,
    features)``."""
    q = _rounder(quant)
    device = x.device

    def linear(h, name, bias=True):
        y = F.linear(q(h), q(w[f"{name}.weight"]))
        return y + w[f"{name}.bias"] if bias else y

    def norm(h, name):
        return F.layer_norm(h, (h.shape[-1],), w[f"{name}.weight"],
                            w[f"{name}.bias"], LN_EPS)

    p = int(cfg["patch_size"])
    h = F.conv2d(q(x.permute(0, 3, 1, 2)), q(w["patch_embed.proj.weight"]),
                 w["patch_embed.proj.bias"], stride=p)
    h = norm(h.permute(0, 2, 3, 1), "patch_embed.norm")
    window = int(cfg["window_size"])
    last = len(cfg["depths"]) - 1
    for i, depth, heads, d, side, ws in _stages(cfg):
        n = ws * ws
        index = _relative_index(ws).to(device)
        for j in range(depth):
            blk = f"layers.{i}.blocks.{j}"
            shift = ws // 2 if j % 2 == 1 and side > window else 0
            s = norm(h, f"{blk}.norm1")
            if shift:
                s = torch.roll(s, shifts=(-shift, -shift), dims=(1, 2))
            t = _partition(s, ws)
            bw = t.shape[0]
            qkv = linear(t, f"{blk}.attn.qkv").reshape(
                bw, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            scores = (qkv[0] * (d // heads) ** -0.5) @ qkv[1].transpose(-2,
                                                                        -1)
            table = w[f"{blk}.attn.relative_position_bias_table"]
            scores = scores + table[index.reshape(-1)].reshape(
                n, n, heads).permute(2, 0, 1).unsqueeze(0)
            if shift:
                mask = _shift_mask(side, ws, shift).to(device)
                nw = mask.shape[0]
                scores = (scores.view(bw // nw, nw, heads, n, n)
                          + mask.unsqueeze(1).unsqueeze(0)).view(
                              bw, heads, n, n)
            a = (torch.softmax(scores, dim=-1) @ qkv[2]).transpose(1, 2)
            a = linear(a.reshape(bw, n, d), f"{blk}.attn.proj")
            s = _reverse(a, ws, side, side)
            if shift:
                s = torch.roll(s, shifts=(shift, shift), dims=(1, 2))
            h = h + s
            m = norm(h, f"{blk}.norm2")
            h = h + linear(F.gelu(linear(m, f"{blk}.mlp.fc1")),
                           f"{blk}.mlp.fc2")
        if i < last:
            h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2],
                           h[:, 0::2, 1::2], h[:, 1::2, 1::2]], dim=-1)
            h = linear(norm(h, f"layers.{i}.downsample.norm"),
                       f"layers.{i}.downsample.reduction", bias=False)
    pooled = norm(h, "norm").mean(dim=(1, 2))
    features = linear(pooled, "fc")
    return linear(features, "logits", bias=False), features


def loss_and_grads(params: dict, images_u8, labels, cfg: dict, block: int,
                   quant: Optional[str] = None):
    """Mean entropic loss of one batch, its gradients and its logits,
    in blocks of ``block`` rows (no layer couples rows, so the blocks'
    gradients add up to the batch's)."""
    names = list(params)
    device = params[names[0]].device
    b = len(labels)
    y = torch.as_tensor(labels).to(device)
    grads = [torch.zeros_like(params[n]) for n in names]
    total, logits_all = 0.0, []
    for lo in range(0, b, block):
        hi = min(b, lo + block)
        logits, _ = forward(params, _to_input(images_u8[lo:hi], device),
                            cfg, quant)
        part = entropic_rows(logits, y[lo:hi]).sum() / b
        for acc, g in zip(grads, torch.autograd.grad(
                part, [params[n] for n in names])):
            acc.add_(g)
        total += float(part.detach())
        logits_all.append(logits.detach())
        del logits, part
    return total, dict(zip(names, grads)), torch.cat(logits_all)


def train_steps(w0: dict, batches, cfg: dict, steps: int = 3,
                quant: Optional[str] = None, block: int = 64):
    """``steps`` Adam steps from ``w0`` on ``batches`` (a list of
    ``(uint8 images, int labels)``): ``(losses, first_logits,
    first_grad_norms, change_norms)``, as :func:`.reference.train_steps`
    returns them."""
    lr = float(cfg["lr"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = param_names(cfg)
    params = {n: w0[n].clone().requires_grad_() for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, g1, logits1 = [], None, None
    with exact_float32():
        for t in range(1, steps + 1):
            images, labels = batches[t - 1]
            loss, grads, logits = loss_and_grads(params, images, labels, cfg,
                                                 block, quant)
            losses.append(loss)
            if t == 1:
                g1 = {n: float(grads[n].norm()) for n in names}
                logits1 = logits
            # Adam (torch.optim.Adam's update, without weight decay).
            with torch.no_grad():
                for n in names:
                    g = grads[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    params[n].sub_(lr * (m[n] / (1 - b1 ** t)) / (
                        (v[n] / (1 - b2 ** t)).sqrt() + eps))
            del grads
    with torch.no_grad():
        change = {n: float((params[n] - w0[n]).norm()) for n in names}
    return losses, logits1, g1, change


@torch.no_grad()
def eval_logits(w: dict, images_u8, cfg: dict, quant: Optional[str] = None,
                block: int = 64) -> torch.Tensor:
    """Float32 logits of uint8 images, in blocks of rows."""
    device = w["logits.weight"].device
    with exact_float32():
        return torch.cat([forward(w, _to_input(images_u8[lo:lo + block],
                                               device), cfg, quant)[0]
                          for lo in range(0, len(images_u8), block)])


def calibrate_running_stats(w: dict, images_u8, cfg: dict) -> dict:
    """The identity: a Swin keeps no running statistics."""
    return w


def _macs(cfg: dict) -> Tuple[int, int]:
    """``(all, attention)`` multiply-adds of one image's forward: the
    patch convolution, every block's qkv, projection, MLP and attention
    products (QK^T and PV), the merging reductions and both heads
    (LayerNorm, GELU, softmax and the residual adds are not counted)."""
    p, c = int(cfg["patch_size"]), int(cfg["embed_dim"])
    ratio = float(cfg["mlp_ratio"])
    side0 = int(cfg["image_size"]) // p
    total = side0 * side0 * c * 3 * p * p
    attention = 0
    last = len(cfg["depths"]) - 1
    for i, depth, _, d, side, ws in _stages(cfg):
        tokens = side * side
        hidden = int(d * ratio)
        products = 2 * tokens * ws * ws * d  # QK^T and PV
        attention += depth * products
        total += depth * (tokens * d * (3 * d + d + 2 * hidden) + products)
        if i < last:
            total += (tokens // 4) * 4 * d * 2 * d
    fc = int(cfg["fc_layer_dim"])
    total += c * 2 ** last * fc + fc * int(cfg["n_classes"])
    return total, attention


def forward_flops(cfg: dict) -> float:
    return 2.0 * _macs(cfg)[0]


def train_flops(cfg: dict) -> float:
    """A training image: the forward and the backward's two products a
    layer, 3x the forward."""
    return 3.0 * forward_flops(cfg)


def attention_flops(cfg: dict) -> float:
    """The QK^T and PV products of one image's forward."""
    return 2.0 * _macs(cfg)[1]
