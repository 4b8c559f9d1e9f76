"""The plain float32 reference of the two-head ResNet, its entropic loss
and Adam, in plain ``torch``.  It imports no module of the program.

The architecture follows He et al. (arXiv 1512.03385, Table 1) as the
open-set reference trains it (a ``fc`` features head, then a ``logits``
head without bias): stem 7x7/2 (padding 3), batch-norm, ReLU, max-pool
3/2 (padding 1); v1.5 bottlenecks (the stride on the 3x3 conv, inner
width ``filters * base_width / 64 * groups``, a strided 1x1 conv and
batch-norm on the shortcut where the shape changes); mean pool; ``fc``;
``logits``.  Weights are a flat name -> tensor map whose names are the
reference checkpoint's, so the program's ``state_dict`` takes it as is.

Batch-norm in training takes the mean and biased variance of the first
``window`` rows (ghost batch-norm; 0: all rows), and gradients flow
through those statistics; in eval it uses the running statistics.
Everything is float32 with TF32 off.  ``quant="fp8"`` is the control: the
same computation with every conv and dense input and kernel rounded to
float8 e4m3 (per-tensor scale) and their gradients to e5m2, the precision
below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import flops

EPS = 1e-5
LAST_SCALE = 0.1  # the last batch-norm scale of a bottleneck, seeded


def _bn_names(prefix: str) -> List[Tuple[str, str]]:
    return [(f"{prefix}.weight", "bn_weight"), (f"{prefix}.bias", "bn_bias"),
            (f"{prefix}.running_mean", "running_mean"),
            (f"{prefix}.running_var", "running_var")]


def spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter and buffer."""
    out = []
    bn_of = {"resnet_base.conv1": "resnet_base.bn1"}
    for c in flops.convs(cfg):
        out.append((f"{c.name}.weight",
                    (c.cout, c.cin // c.groups, c.k, c.k), "conv"))
        if c.name.endswith("downsample.0"):
            bn = c.name[:-1] + "1"
        else:
            bn = bn_of.get(c.name, c.name.replace(".conv", ".bn"))
        out.extend((n, (c.cout,), kind) for n, kind in _bn_names(bn))
    fc, final = int(cfg["fc_layer_dim"]), flops.final_channels(cfg)
    out.append(("resnet_base.fc.weight", (fc, final), "dense"))
    out.append(("resnet_base.fc.bias", (fc,), "dense_bias"))
    out.append(("logits.weight", (int(cfg["n_classes"]), fc), "dense"))
    return out


def param_names(cfg: dict) -> List[str]:
    return [n for n, _, kind in spec(cfg)
            if kind not in ("running_mean", "running_var")]


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights, drawn on ``device`` in one call.

    Conv kernels N(0, 2 / fan-out) (He, as the port initialises them);
    dense kernels N(0, 1 / fan-in); batch-norm scales 1 + N(0, 0.01) and
    biases N(0, 0.01), except the last batch-norm of each bottleneck,
    whose scale is 0.1 (1 + N(0, 0.01)); the features head's bias
    N(0, 0.01); running mean 0 and variance 1.

    The last scale is small as in the zero-gamma initialisation that the
    port and the JAX package use (Goyal et al., arXiv 1706.02677), so that
    a residual branch adds little to its block; unlike zero it lets every
    branch carry a gradient from the first step.  With scale 1 the seeded
    network is chaotic: a rounding at the input grows by about 1.1x a
    layer, and bf16 logits lose all agreement with float32 ones.
    """
    items = spec(cfg)
    sizes = [math.prod(shape) for _, shape, _ in items]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for (name, shape, kind), part in zip(items, flat.split(sizes)):
        z = part.view(shape)
        if kind == "conv":
            out[name] = z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "dense":
            out[name] = z * math.sqrt(1.0 / shape[1])
        elif kind == "bn_weight":
            scale = LAST_SCALE if name.endswith("bn3.weight") else 1.0
            out[name] = scale * (1.0 + 0.1 * z)
        elif kind in ("bn_bias", "dense_bias"):
            out[name] = 0.1 * z
        elif kind == "running_mean":
            out[name] = torch.zeros_like(z)
        else:
            out[name] = torch.ones_like(z)
    return out


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convs inside (a float32 product may
    otherwise run in TF32 on the card)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _fp8(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, fmax / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Round to e4m3 going forward and the gradient to e5m2 going back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def _rounder(quant: Optional[str]):
    if quant is None:
        return lambda t: t
    if quant == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown reference precision {quant!r}")


def forward(w: dict, x: torch.Tensor, cfg: dict, train: bool = False,
            window: int = 0, stats: Optional[dict] = None,
            stats_out: Optional[dict] = None, quant: Optional[str] = None):
    """``x``: float32 ``[B, H, W, 3]`` in [0, 1] -> ``(logits, features)``.

    In training, each batch-norm takes its statistics from ``stats[name]``
    when given, else from the first ``window`` rows (0: all), and records
    them in ``stats_out``.
    """
    q = _rounder(quant)

    def conv(h, name, stride=1, pad=0, groups=1):
        return F.conv2d(q(h), q(w[f"{name}.weight"]), None, stride, pad, 1,
                        groups)

    def bn(h, name):
        if not train:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        elif stats is not None:
            mean, var = stats[name]
        else:
            src = h if window <= 0 else h[:window]
            mean = src.mean(dim=(0, 2, 3))
            var = (src - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            if stats_out is not None:
                stats_out[name] = (mean, var)
        inv = torch.rsqrt(var + EPS) * w[f"{name}.weight"]
        return ((h - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
                + w[f"{name}.bias"].view(1, -1, 1, 1))

    groups = int(cfg.get("groups", 1))
    h = x.permute(0, 3, 1, 2)
    h = F.relu(bn(conv(h, "resnet_base.conv1", 2, 3), "resnet_base.bn1"))
    h = F.max_pool2d(h, 3, 2, 1)
    width = int(cfg.get("width", 64))
    cin = width
    for i, count in enumerate(cfg["stage_sizes"]):
        expand = width * 2 ** i * 4
        for j in range(count):
            p = f"resnet_base.layer{i + 1}.{j}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(bn(conv(h, f"{p}.conv1"), f"{p}.bn1"))
            y = F.relu(bn(conv(y, f"{p}.conv2", stride, 1, groups),
                          f"{p}.bn2"))
            y = bn(conv(y, f"{p}.conv3"), f"{p}.bn3")
            if stride != 1 or cin != expand:
                h = bn(conv(h, f"{p}.downsample.0", stride),
                       f"{p}.downsample.1")
            h = F.relu(y + h)
            cin = expand
    pooled = h.mean(dim=(2, 3))
    features = (F.linear(q(pooled), q(w["resnet_base.fc.weight"]))
                + w["resnet_base.fc.bias"])
    logits = F.linear(q(features), q(w["logits.weight"]))
    return logits, features


def entropic_rows(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Per-row entropic open-set loss: cross-entropy against the one-hot
    target of a known label (>= 0) or the uniform target of a negative
    (-1)."""
    c = logits.shape[-1]
    log_p = torch.log_softmax(logits, dim=-1)
    known = labels >= 0
    target = F.one_hot(labels.clamp(min=0).long(), c).float()
    target = torch.where(known[:, None], target,
                         torch.full_like(target, 1.0 / c))
    return -(target * log_p).sum(-1)


def _to_input(images_u8, device) -> torch.Tensor:
    t = torch.as_tensor(images_u8).to(device)
    return t.float() / 255.0


def loss_and_grads(params: dict, images_u8, labels, cfg: dict, window: int,
                   block: int, quant: Optional[str] = None):
    """Mean entropic loss of one batch, its gradients and its logits,
    computed in blocks of rows: the first ``window`` rows first (their
    graph gives every batch-norm's statistics), then the rest in blocks of
    ``block`` against those statistics, whose gradients are carried back
    into the first block's graph at the end."""
    names = list(params)
    device = params[names[0]].device
    b = len(labels)
    if window <= 0:
        window = b
    y = torch.as_tensor(labels).to(device)
    stats: dict = {}
    logits0, _ = forward(params, _to_input(images_u8[:window], device), cfg,
                         train=True, window=0, stats_out=stats, quant=quant)
    loss0 = entropic_rows(logits0, y[:window]).sum() / b
    keys = list(stats)
    leaves = {k: (stats[k][0].detach().requires_grad_(),
                  stats[k][1].detach().requires_grad_()) for k in keys}
    leaf_list = [t for k in keys for t in leaves[k]]
    grads = [torch.zeros_like(params[n]) for n in names]
    dstats = [torch.zeros_like(t) for t in leaf_list]
    total = loss0.detach()
    logits_all = [logits0.detach()]
    for lo in range(window, b, block):
        hi = min(b, lo + block)
        logits, _ = forward(params, _to_input(images_u8[lo:hi], device),
                            cfg, train=True, stats=leaves, quant=quant)
        part = entropic_rows(logits, y[lo:hi]).sum() / b
        got = torch.autograd.grad(part, [params[n] for n in names]
                                  + leaf_list, allow_unused=True)
        for acc, g in zip(grads + dstats, got):
            if g is not None:
                acc.add_(g)
        total = total + part.detach()
        logits_all.append(logits.detach())
        del logits, part, got
    outs = [loss0] + [t for k in keys for t in stats[k]]
    got = torch.autograd.grad(outs, [params[n] for n in names],
                              grad_outputs=[torch.ones_like(loss0)] + dstats,
                              allow_unused=True)
    for acc, g in zip(grads, got):
        if g is not None:
            acc.add_(g)
    return total, dict(zip(names, grads)), torch.cat(logits_all)


def train_steps(w0: dict, batches, cfg: dict, steps: int = 3,
                quant: Optional[str] = None, block: int = 64):
    """``steps`` Adam steps from ``w0`` on ``batches`` (a list of
    ``(uint8 images, int labels)``), as the configuration trains.

    Returns ``(losses, first_logits, first_grad_norms, change_norms)``:
    each step's loss, the first step's logits and the norm of each leaf's
    gradient there, and the norm of each leaf's change after the last
    step.
    """
    lr = float(cfg["lr"])
    b1, b2, eps = (float(v) for v in cfg.get("betas_eps",
                                              (0.9, 0.999, 1e-8)))
    names = param_names(cfg)
    params = {n: w0[n].clone().requires_grad_() for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, g1, logits1 = [], None, None
    with exact_float32():
        for t in range(1, steps + 1):
            images, labels = batches[t - 1]
            loss, grads, logits = loss_and_grads(
                params, images, labels, cfg, int(cfg["bn_stats_rows"]),
                block, quant)
            losses.append(float(loss))
            if t == 1:
                g1 = {n: float(grads[n].norm()) for n in names}
                logits1 = logits
            with torch.no_grad():
                for n in names:
                    g = grads[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[n] / (1 - b1 ** t)
                    vhat = v[n] / (1 - b2 ** t)
                    params[n].sub_(lr * mhat / (vhat.sqrt() + eps))
            del grads
    with torch.no_grad():
        change = {n: float((params[n] - w0[n]).norm()) for n in names}
    return losses, logits1, g1, change


@torch.no_grad()
def eval_logits(w: dict, images_u8, cfg: dict, quant: Optional[str] = None,
                block: int = 128) -> torch.Tensor:
    """Eval-mode float32 logits of uint8 images, in blocks of rows."""
    device = w["logits.weight"].device
    out = []
    with exact_float32():
        for lo in range(0, len(images_u8), block):
            logits, _ = forward(w, _to_input(images_u8[lo:lo + block],
                                             device), cfg, quant=quant)
            out.append(logits)
    return torch.cat(out)


@torch.no_grad()
def calibrate_running_stats(w: dict, images_u8, cfg: dict) -> dict:
    """``w`` with every batch-norm's running mean and variance set to the
    statistics of ``images_u8`` (a training-mode forward over all rows),
    so that an eval-mode forward of seeded weights keeps its activations
    in range, as a trained model's running statistics do."""
    stats: dict = {}
    with exact_float32():
        forward(w, _to_input(images_u8, w["logits.weight"].device), cfg,
                train=True, window=0, stats_out=stats)
    out = dict(w)
    for name, (mean, var) in stats.items():
        out[f"{name}.running_mean"] = mean.clone()
        out[f"{name}.running_var"] = var.clone()
    return out
