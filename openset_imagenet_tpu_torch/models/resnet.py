"""Two-head ResNet family in PyTorch.

Counterpart of :mod:`openset_imagenet_tpu.models.resnet`: a ResNet backbone
whose last fully-connected layer is ``fc`` (``2048 -> fc_layer_dim``, the
deep features) followed by a ``logits`` head; ``forward`` returns
``(logits, features)`` as float32.

The arithmetic follows the JAX model, not torchvision, where the two
differ:

* Public layout is NHWC (``[B, H, W, 3]`` float images), as in the JAX
  package; inside, the batch is permuted to NCHW, which for an NHWC tensor
  is already the ``channels_last`` memory format.
* The input, the conv and dense kernels and every activation are cast to
  the compute dtype (bfloat16 by default) exactly where flax casts them;
  parameters stay float32.  ``torch.autocast`` is not used: it rounds in
  other places.  Dense layers add their bias after the matmul has been
  rounded, as flax does.
* Stem 7x7/2 with padding (3, 3); max-pool 3/2 with padding (1, 1);
  v1.5 bottleneck with the stride on the 3x3 conv; every 3x3 conv pads
  (1, 1) (never flax "SAME"); the downsample is a strided 1x1 conv + BN;
  the mean pool is over H and W.
* Batch-norm uses the rounding form the JAX model picks from
  ``bn_stats_rows`` (see :mod:`.norm`): running statistics in eval mode,
  batch (or ghost) statistics in training mode, so ``model.train()`` is
  the JAX ``train=True``.
* ``folded`` is the inference graph of :mod:`..optimize`: every conv has
  a bias (the absorbed batch-norm), added in the compute dtype after the
  conv has been rounded, as flax adds it, and the norm slots are the
  identity.  ``quantized`` also makes the block convs (``conv1`` ...
  ``conv3``, ``downsample.0``) :class:`.quant.QuantConv`; the stem and
  both dense heads stay in the compute dtype.

``state_dict`` keys are the reference torch layout (``resnet_base.conv1
.weight`` ... ``resnet_base.fc.*``, ``logits.*``), so reference checkpoints
and ``openset_imagenet_tpu.convert.save_reference_checkpoint`` files load
directly.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm


class Conv(nn.Module):
    """OIHW float32 kernel, computed in the input's dtype; with ``bias``
    (the folded graph) a float32 bias added after the conv's rounding, in
    the input's dtype (flax's ``conv -> round -> + bias``; a bias given to
    ``F.conv2d`` would be added before the rounding)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(
            cout, cin // groups, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding, 1, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).view(1, -1, 1, 1)
        return y


def _identity_norm(features: int, device=None) -> nn.Module:
    """Norm slot of the folded graph (JAX ``_identity_norm``): the
    batch-norm lives in the preceding conv's kernel and bias."""
    del features, device
    return nn.Identity()


class Dense(nn.Module):
    """``[out, in]`` float32 kernel; matmul rounded, then bias added."""

    def __init__(self, cin: int, cout: int, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The rounded product alone, for a caller that adds the bias
        itself (the Swin's residual junctions)."""
        return F.linear(x, self.weight.to(x.dtype))


def _add_relu(y: torch.Tensor, residual: torch.Tensor,
              boundary_mask: bool) -> torch.Tensor:
    """The block boundary ``relu(y + residual)``; with ``boundary_mask``
    its backward reads an int8 gate (``masked_add_relu``)."""
    if boundary_mask:
        from ..experimental.fused_block import masked_add_relu

        return masked_add_relu(y, residual)
    return F.relu(y + residual)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (expansion 1) for resnet18/34 and tiny."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, norm,
                 groups: int = 1, base_width: int = 64,
                 boundary_mask: bool = False, conv=Conv, device=None):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("groups/base_width require Bottleneck variants "
                             "(resnext*/wide_resnet*)")
        self.boundary_mask = boundary_mask
        self.conv1 = conv(cin, filters, 3, stride, 1, device=device)
        self.bn1 = norm(filters, device=device)
        self.conv2 = conv(filters, filters, 3, 1, 1, device=device)
        self.bn2 = norm(filters, device=device)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                conv(cin, filters, 1, stride, device=device),
                norm(filters, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return _add_relu(y, residual, self.boundary_mask)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck 1x1 -> 3x3(stride, groups) -> 1x1, expansion 4.

    Inner width ``int(filters * base_width / 64) * groups`` as in
    torchvision (ResNeXt: groups=32; Wide-ResNet: base_width=128).

    ``fused`` runs the block as :func:`..experimental.fused_block.
    bottleneck_fused` (the JAX ``Bottleneck._fused_call``, ``models/
    resnet.py:249-306`` there) with the same parameters and buffers.  In
    training a ghost pre-pass over the first ``bn1.stats_rows`` rows takes
    every batch-norm's statistics (plain autograd, the only route by which
    gradients reach them) and :meth:`..norm.BatchNorm.fold` turns them into
    ``(mul, add)``; in eval the running statistics are folded.
    ``use_kernel`` is the fused backward's K5 route (None: by device;
    False: the plain site).  ``conv`` builds the four convs (the folded
    graph's biased :class:`Conv`, the quantized graph's ``QuantConv``).
    """

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, norm,
                 groups: int = 1, base_width: int = 64,
                 boundary_mask: bool = False, fused: bool = False,
                 conv=Conv, device=None):
        super().__init__()
        if fused and (groups != 1 or base_width != 64):
            raise ValueError("fused_blocks supports only the standard "
                             "bottleneck (groups=1, base_width=64)")
        self.stride = stride
        self.boundary_mask = boundary_mask
        self.fused = fused
        self.use_kernel = None
        width = int(filters * (base_width / 64.0)) * groups
        out = filters * 4
        self.conv1 = conv(cin, width, 1, device=device)
        self.bn1 = norm(width, device=device)
        self.conv2 = conv(width, width, 3, stride, 1, groups, device=device)
        self.bn2 = norm(width, device=device)
        self.conv3 = conv(width, out, 1, device=device)
        self.bn3 = norm(out, device=device)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                conv(cin, out, 1, stride, device=device),
                norm(out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return self._fused_forward(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return _add_relu(y, residual, self.boundary_mask)

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..experimental.fused_block import (_affine, _conv3x3, _pw,
                                                bottleneck_fused, ghost_stats)

        dt, s = x.dtype, self.stride
        w1, w2, w3 = self.conv1.weight, self.conv2.weight, self.conv3.weight
        bn1, bn2, bn3 = self.bn1, self.bn2, self.bn3
        wd = muld = addd = None
        if self.downsample is not None:
            wd, bnd = self.downsample[0].weight, self.downsample[1]
        if self.training:
            rows = bn1.stats_rows
            if rows <= 0:
                raise ValueError(
                    "fused bottleneck training requires ghost BN "
                    "(model.bn_stats_rows > 0); full-batch statistics "
                    "would double the forward pass")
            # Ghost pre-pass on the leading rows, folding each batch-norm
            # as soon as its statistics exist (rows are independent, so
            # these are the full forward's leading-row values, up to the
            # summation order a conv picks for this batch size).
            xs = x[:rows]
            z1s = _pw(xs, w1.to(dt))
            mul1, add1 = bn1.fold(*ghost_stats(z1s))
            z2s = _conv3x3(torch.relu(_affine(z1s, mul1, add1)), w2.to(dt), s)
            mul2, add2 = bn2.fold(*ghost_stats(z2s))
            z3s = _pw(torch.relu(_affine(z2s, mul2, add2)), w3.to(dt))
            mul3, add3 = bn3.fold(*ghost_stats(z3s))
            if wd is not None:
                zds = _pw(xs[:, :, ::s, ::s], wd.to(dt))
                muld, addd = bnd.fold(*ghost_stats(zds))
        else:
            mul1, add1 = bn1.fold()
            mul2, add2 = bn2.fold()
            mul3, add3 = bn3.fold()
            if wd is not None:
                muld, addd = bnd.fold()
        return bottleneck_fused(x, w1, w2, w3, mul1, add1, mul2, add2, mul3,
                                add3, wd, muld, addd, stride=s,
                                use_kernel=self.use_kernel)


class ResNetBase(nn.Module):
    """Backbone with the reference's attribute names (``conv1`` ... ``fc``)."""

    def __init__(self, block, stage_sizes: Sequence[int], width: int,
                 groups: int, base_width: int, fc_layer_dim: int, norm,
                 stem_bias: bool = False, device=None, **block_kw):
        super().__init__()
        self.conv1 = Conv(3, width, 7, 2, 3, bias=stem_bias, device=device)
        self.bn1 = norm(width, device=device)
        cin = width
        for i, count in enumerate(stage_sizes):
            blocks = []
            for j in range(count):
                filters = width * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, filters, stride, norm, groups,
                                    base_width, device=device, **block_kw))
                cin = filters * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = Dense(cin, fc_layer_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


# ROADMAP Queue 1 items that bring each deferred JAX model option.
_DEFERRED = {
    "remat": "item 9 (experimental knobs)",
}


class ResNet50(nn.Module):
    """Two-head ResNet: ``forward(images) -> (logits, features)``.

    Args mirror the JAX ``ResNet50``: ``fc_layer_dim`` (features head),
    ``out_features`` (logits head), ``logit_bias``, ``dtype`` (compute
    dtype), ``stage_sizes``/``block``/``width``/``groups``/``base_width``
    (variant geometry) and ``bn_stats_rows`` (the batch-norm statistics
    window in training mode, 0 for the whole batch; it also selects the
    rounding form).

    ``space_to_depth`` stores the same ``[7, 7, 3, F]`` stem kernel as the
    JAX model's ``SpaceToDepthStem`` and computes the identical arithmetic,
    so it is run here as the plain 7x7/2 conv.  ``dot_1x1`` is the same
    math as the 1x1 conv and runs as the conv.  ``boundary_mask`` saves
    every block boundary's ReLU gate as int8; ``fused_blocks`` runs each
    Bottleneck as the fused-backward block (training needs
    ``bn_stats_rows > 0``; Bottleneck variants with ``groups == 1`` and
    ``base_width == 64`` only).  ``folded`` is the inference graph with
    every batch-norm absorbed into a biased conv (weights from
    :func:`..optimize.fold_inference`; eval only), ``quantized`` (needs
    ``folded``) its int8 form (weights from :func:`..optimize.
    quantize_inference`); both raise the JAX model's ``ValueError`` where
    it refuses them.  ``remat`` is not ported yet and raises
    ``NotImplementedError``.  ``config`` keeps the constructor's
    arguments, for :func:`..optimize.fold_model`.
    """

    def __init__(self, fc_layer_dim: int = 1000, out_features: int = 1000,
                 logit_bias: bool = True, dtype: torch.dtype = torch.bfloat16,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), block=None,
                 width: int = 64, groups: int = 1, base_width: int = 64,
                 bn_stats_rows: int = 0, space_to_depth: bool = False,
                 dot_1x1: bool = False, remat=False,
                 fused_blocks: bool = False, boundary_mask: bool = False,
                 folded: bool = False, quantized: bool = False,
                 device=None):
        super().__init__()
        if remat not in (False, None, "none"):
            raise NotImplementedError(
                f"model option remat={remat!r} is not ported yet "
                f"(ROADMAP Queue 1 {_DEFERRED['remat']})")
        block = block or Bottleneck
        self.config = dict(
            fc_layer_dim=fc_layer_dim, out_features=out_features,
            logit_bias=logit_bias, dtype=dtype, stage_sizes=stage_sizes,
            block=block, width=width, groups=groups, base_width=base_width,
            bn_stats_rows=bn_stats_rows, space_to_depth=space_to_depth,
            dot_1x1=dot_1x1, remat=remat, fused_blocks=fused_blocks,
            boundary_mask=boundary_mask, folded=folded, quantized=quantized)
        # The JAX model's refusals, with its messages (JAX models/
        # resnet.py:449-460 and, for dot_1x1, the Bottleneck's :323-325).
        if quantized and not folded:
            raise ValueError("quantized inference requires the folded "
                             "graph (optimize.quantize_model sets both)")
        if folded and (fused_blocks or boundary_mask):
            raise ValueError("folded inference is not supported with "
                             "fused_blocks/boundary_mask (training "
                             "experiments)")
        if folded and dot_1x1 and block is Bottleneck:
            raise ValueError("folded inference is not supported with "
                             "dot_1x1 (Conv1x1 carries no bias slot)")
        block_kw = {"boundary_mask": bool(boundary_mask)}
        if fused_blocks:
            if block is not Bottleneck:
                raise ValueError("fused_blocks requires Bottleneck variants"
                                 " (resnet50/101/152)")
            block_kw["fused"] = True
        self.dtype = dtype
        self.bn_stats_rows = int(bn_stats_rows)
        self.fused_blocks = bool(fused_blocks)
        self.folded = bool(folded)
        self.quantized = bool(quantized)
        if quantized:
            from .quant import QuantConv

            block_kw["conv"] = functools.partial(QuantConv, dtype=dtype)
        elif folded:
            block_kw["conv"] = functools.partial(Conv, bias=True)
        norm = (_identity_norm if folded else
                functools.partial(BatchNorm, stats_rows=self.bn_stats_rows))
        self.resnet_base = ResNetBase(
            block, stage_sizes, width, groups, base_width, fc_layer_dim,
            norm, stem_bias=self.folded, device=device, **block_kw)
        self.logits = Dense(fc_layer_dim, out_features, bias=logit_bias,
                            device=device)

    def forward(self, images: torch.Tensor):
        """``images``: float ``[B, H, W, 3]`` -> float32 (logits, features)."""
        if self.folded and self.training:
            raise ValueError("a folded model is inference-only "
                             "(batch-norm was absorbed into the convs; "
                             "there are no statistics to train)")
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        features = self.resnet_base(x)
        logits = self.logits(features)
        return logits.float(), features.float()

    @contextlib.contextmanager
    def stats_window(self, rows: int):
        """Run the same parameters with batch-norm window ``rows``.

        The port's ``model.clone(bn_stats_rows=rows).apply``: inside the
        block every batch-norm takes its statistics from the first
        ``rows`` rows (0: all rows), in the rounding form that window
        selects, exactly as a model built with ``bn_stats_rows=rows``.
        """
        norms = [m for m in self.modules() if isinstance(m, BatchNorm)]
        for m in norms:
            m.stats_rows = int(rows)
        try:
            yield self
        finally:
            for m in norms:
                m.stats_rows = self.bn_stats_rows


_VARIANTS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block=BasicBlock),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block=BasicBlock),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block=Bottleneck),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block=Bottleneck),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block=Bottleneck),
    "resnext50_32x4d": dict(stage_sizes=(3, 4, 6, 3), block=Bottleneck,
                            groups=32, base_width=4),
    "resnext101_32x8d": dict(stage_sizes=(3, 4, 23, 3), block=Bottleneck,
                             groups=32, base_width=8),
    "wide_resnet50_2": dict(stage_sizes=(3, 4, 6, 3), block=Bottleneck,
                            base_width=128),
    "wide_resnet101_2": dict(stage_sizes=(3, 4, 23, 3), block=Bottleneck,
                             base_width=128),
    "tiny": dict(stage_sizes=(1, 1, 1, 1), block=BasicBlock, width=8),
    "tiny50": dict(stage_sizes=(1, 1, 1, 1), block=Bottleneck, width=8),
    "tinyx": dict(stage_sizes=(1, 1, 1, 1), block=Bottleneck, width=8,
                  groups=4, base_width=32),
}


def _trunc_normal(shape, std: float, generator) -> torch.Tensor:
    """N(0, std) truncated at two standard deviations (inverse-CDF draw)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + (1.0 - 2.0 * lo) * u
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (z * std).float()


@torch.no_grad()
def init_weights(model: ResNet50, generator: torch.Generator) -> ResNet50:
    """Initialise like the JAX model, drawing from ``generator`` (CPU).

    Conv kernels: variance-scaling 2.0, fan-out, truncated normal.  Dense
    kernels: U(+-sqrt(1/fan_in)); biases zero.  Batch-norm scale one (zero
    for the last norm of every block), bias zero, running mean zero,
    running variance one; a folded conv's bias zero, a ``QuantConv``'s
    placeholders left as they are.  The draws differ from
    ``jax.random``'s; tests that compare the two packages share weights
    through :mod:`..convert`.
    """
    for module in model.modules():
        if isinstance(module, Conv):
            w = module.weight
            fan_out = w.shape[0] * w.shape[2] * w.shape[3]
            std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
            w.copy_(_trunc_normal(w.shape, std, generator))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, Dense):
            limit = math.sqrt(1.0 / module.weight.shape[1])
            u = torch.rand(module.weight.shape, generator=generator)
            module.weight.copy_((2.0 * u - 1.0) * limit)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    for module in model.modules():
        if isinstance(module, Bottleneck) and isinstance(module.bn3,
                                                         BatchNorm):
            module.bn3.weight.zero_()
        elif isinstance(module, BasicBlock) and isinstance(module.bn2,
                                                           BatchNorm):
            module.bn2.weight.zero_()
    return model


def build_resnet(variant: str = "resnet50", *, fc_layer_dim: int,
                 out_features: int, logit_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, bn_stats_rows: int = 0,
                 space_to_depth: bool = False, remat=False,
                 dot_1x1: bool = False, fused_blocks: bool = False,
                 boundary_mask: bool = False, folded: bool = False,
                 quantized: bool = False, device=None,
                 generator: Optional[torch.Generator] = None) -> ResNet50:
    """Construct a two-head ResNet by variant name, in eval mode.

    Weights are drawn by :func:`init_weights` from ``generator`` (seed 0
    when ``None``); on the ``meta`` device nothing is drawn.
    """
    if variant not in _VARIANTS:
        raise ValueError(
            f"unknown variant {variant!r}; choose from {sorted(_VARIANTS)}")
    model = ResNet50(fc_layer_dim=fc_layer_dim, out_features=out_features,
                     logit_bias=logit_bias, dtype=dtype,
                     bn_stats_rows=bn_stats_rows,
                     space_to_depth=space_to_depth, remat=remat,
                     dot_1x1=dot_1x1, fused_blocks=fused_blocks,
                     boundary_mask=boundary_mask, folded=folded,
                     quantized=quantized, device=device,
                     **_VARIANTS[variant])
    if torch.device(device or "cpu").type != "meta":
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(model, generator)
    return model.eval()
