"""Two-head Swin Transformer in PyTorch (Liu et al., arXiv 2103.14030).

The backbone of the paper's official code (``models/swin_transformer.py``
of github.com/microsoft/Swin-Transformer) with the open-set recipe's two
heads: a ``fc`` layer (final channels -> ``fc_layer_dim``, the deep
features) and a ``logits`` layer without bias; ``forward`` returns
``(logits, features)`` as float32, as :class:`.resnet.ResNet50` does.

* Patch embedding: a 4x4/4 convolution (3 -> ``embed_dim``, with bias),
  then LayerNorm.  Tokens are kept as ``[B, H, W, C]``.
* Stages of blocks at ``embed_dim * 2**i`` channels.  A block is
  ``x + attn(norm1(x))`` then ``x + mlp(norm2(x))``: multi-head attention
  inside non-overlapping windows of ``window_size**2`` tokens (W-MSA) in
  even blocks, and after a cyclic shift by ``window_size // 2``
  (``torch.roll``) in odd blocks (SW-MSA), where a region mask (-100,
  the official value) keeps tokens wrapped from opposite edges from
  attending to each other.  Where a stage's map is no larger than the
  window, the window is the map and nothing shifts (the official rule).
  Each window adds a learned relative-position bias, gathered from a
  ``[(2 * window_size - 1)**2, heads]`` table; the scale is
  ``head_dim ** -0.5``; the MLP is ``fc1 -> GELU (erf) -> fc2`` at
  ``mlp_ratio`` times the width.
* Patch merging between stages: the 2x2 neighbours concatenated (the
  official order), LayerNorm, a linear ``4C -> 2C`` without bias.
* A final LayerNorm, the mean over tokens, ``fc``, ``logits``.

Stochastic depth and dropout are not built (each draws a mask a sample).

The dtype policy is the ResNet's: parameters stay float32; the input and
every kernel are cast to the compute dtype (bfloat16 by default) with
explicit casts, not ``torch.autocast``; a dense bias is added after the
product has been rounded.  LayerNorm takes its statistics in float32 and
rounds its output to the compute dtype.  Attention runs through
``F.scaled_dot_product_attention`` with the bias and the region mask as
one additive mask in the compute dtype, padded in its last dimension to a
multiple of 8 and sliced back, so that the memory-efficient kernel takes
it without a copy; an unshifted block's mask is broadcast over the
windows.  The relative-position index and the region mask depend on the
map's size alone and are derived at the first forward at a size, one set
a device, so a model built on ``meta`` and filled by ``load_state_dict``
holds no uninitialised buffer.

``state_dict`` names follow the official code (``patch_embed.proj.*``,
``patch_embed.norm.*``, ``layers.{i}.blocks.{j}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}.*``,
``layers.{i}.downsample.{norm, reduction}.*``, ``norm.*``), and the heads
are ``fc.*`` and ``logits.*``.

``COUNTS`` counts the window-attention calls and the windows they took;
each block's attention (roll, partition, mask, attention, merge, reverse
roll) is the device span ``swin.attention`` (:mod:`..tracing`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from .resnet import Conv, Dense, _trunc_normal

LN_EPSILON = 1e-5
MASKED = -100.0  # the official region mask's value
COUNTS = {"attention_calls": 0, "windows": 0}


class LayerNorm(nn.Module):
    """LayerNorm over the last dimension with float32 ``weight`` and
    ``bias`` cast to the input's dtype; the statistics are taken in
    float32 (torch's kernels accumulate a bfloat16 input in float32) and
    the output is rounded to the input's dtype."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight.shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), LN_EPSILON)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B * nW, ws * ws, C]``, windows row-major
    within each image."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    c = windows.shape[-1]
    x = windows.view(-1, h // ws, w // ws, ws, ws, c).permute(
        0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def relative_position_index(ws: int, table_ws: int) -> torch.Tensor:
    """``[ws**2 * ws**2]`` rows of a ``(2 * table_ws - 1)**2`` table: the
    official index, for a window no larger than the table's."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (table_ws - 1)
    return (rel[..., 0] * (2 * table_ws - 1) + rel[..., 1]).reshape(-1)


def region_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """``[nW, ws**2, ws**2]`` float32: 0 between tokens of one region of
    the shifted map, :data:`MASKED` between regions (the official
    ``attn_mask``)."""
    img = torch.zeros(1, h, w, 1)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for i, (hs, wsl) in enumerate((a, b) for a in cuts for b in cuts):
        img[:, hs, wsl, :] = i
    ids = window_partition(img, ws).squeeze(-1)
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, MASKED, 0.0)


def _aligned(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` as a slice of a copy padded to a multiple of 8 in its
    last dimension (what the memory-efficient attention kernel needs of a
    mask's strides)."""
    n = mask.shape[-1]
    return F.pad(mask, (0, -n % 8))[..., :n]


class WindowAttention(nn.Module):
    """Multi-head attention inside windows, with the relative-position
    bias (``relative_position_bias_table``) and an optional region mask."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 device=None):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window_size - 1) ** 2, num_heads, device=device))
        self.qkv = Dense(dim, 3 * dim, device=device)
        self.proj = Dense(dim, dim, device=device)

    def forward(self, x: torch.Tensor, index: torch.Tensor,
                region: Optional[torch.Tensor]) -> torch.Tensor:
        """``x``: ``[B * nW, N, C]`` windows; ``index``: the bias table's
        row of every token pair (``[N * N]``); ``region``: ``[nW, N, N]``
        float32 or None."""
        bw, n, c = x.shape
        heads = self.num_heads
        COUNTS["attention_calls"] += 1
        COUNTS["windows"] += bw
        q, k, v = self.qkv(x).view(bw, n, 3, heads, c // heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        bias = self.relative_position_bias_table[index].view(
            n, n, heads).permute(2, 0, 1)
        if region is None:
            mask = _aligned(bias.to(x.dtype)).unsqueeze(0)
        else:
            nw = region.shape[0]
            mask = (region[:, None] + bias[None]).to(x.dtype)
            mask = F.pad(mask, (0, -n % 8)).expand(
                bw // nw, -1, -1, -1, -1).reshape(bw, heads, n, -1)[..., :n]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device)
        self.fc2 = Dense(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-LayerNorm block; ``shifted`` blocks shift by half a window
    where the map is larger than the window."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shifted: bool, mlp_ratio: float, device=None):
        super().__init__()
        self.window_size, self.shifted = window_size, shifted
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, window_size, num_heads,
                                    device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self._constants: dict = {}

    def geometry(self, h: int, w: int, device):
        """``(window, shift, index, region)`` of an ``h x w`` map: the
        official rule (a map no larger than the window is one unshifted
        window), the bias table's index and the region mask (None
        unshifted), kept for each size and device."""
        key = (h, w, torch.device(device))
        got = self._constants.get(key)
        if got is None:
            got = self._constants[key] = self._derive(h, w, device)
        return got

    def _derive(self, h: int, w: int, device):
        # Ordinary tensors even under inference_mode (a first forward in
        # OpenSetPredictor), so that later training can save them.
        with torch.inference_mode(False):
            ws = self.window_size
            shift = ws // 2 if self.shifted else 0
            if min(h, w) <= ws:
                ws, shift = min(h, w), 0
            if h % ws or w % ws:
                raise ValueError(f"a {h}x{w} token map does not divide "
                                 f"into {ws}x{ws} windows")
            index = relative_position_index(ws, self.window_size)
            region = region_mask(h, w, ws, shift) if shift else None
            return (ws, shift, index.to(device),
                    None if region is None else region.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift, index, region = self.geometry(h, w, x.device)
        y = self.norm1(x)
        with tracing.span("swin.attention", device=x.device):
            if shift:
                y = torch.roll(y, (-shift, -shift), (1, 2))
            y = self.attn(window_partition(y, ws), index, region)
            y = window_reverse(y, ws, h, w)
            if shift:
                y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours -> LayerNorm(4C) -> linear 4C -> 2C, no bias."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"patch merging needs an even map, got "
                             f"{x.shape[1]}x{x.shape[2]}")
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, downsample: bool,
                 device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, j % 2 == 1, mlp_ratio,
                      device=device) for j in range(depth))
        self.downsample = PatchMerging(dim, device=device) if downsample \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, device=None):
        super().__init__()
        self.proj = Conv(3, dim, patch, patch, bias=True, device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images -> ``[B, H / patch, W / patch, dim]`` tokens."""
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class Swin(nn.Module):
    """Two-head Swin: ``forward(images) -> (logits, features)``.

    ``embed_dim``, ``depths``, ``num_heads``, ``window_size``,
    ``mlp_ratio`` and ``patch_size`` are the backbone's geometry;
    ``fc_layer_dim`` (features head), ``out_features`` (logits head),
    ``logit_bias`` and ``dtype`` (compute dtype) as for the ResNet.  Any
    image size whose token maps divide into windows runs.
    """

    def __init__(self, fc_layer_dim: int = 1000, out_features: int = 1000,
                 logit_bias: bool = True, dtype: torch.dtype = torch.bfloat16,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 patch_size: int = 4, variant: str = "swin_b", device=None):
        super().__init__()
        if len(depths) != len(num_heads):
            raise ValueError("depths and num_heads name the same stages")
        self.variant, self.dtype = variant, dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, device=device)
        last = len(depths) - 1
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2 ** i, depth, heads, window_size,
                      mlp_ratio, i < last, device=device)
            for i, (depth, heads) in enumerate(zip(depths, num_heads)))
        final = embed_dim * 2 ** last
        self.norm = LayerNorm(final, device=device)
        self.fc = Dense(final, fc_layer_dim, device=device)
        self.logits = Dense(fc_layer_dim, out_features, bias=logit_bias,
                            device=device)

    def forward(self, images: torch.Tensor):
        """``images``: float ``[B, H, W, 3]`` -> float32 (logits,
        features)."""
        x = self.patch_embed(images.permute(0, 3, 1, 2).to(self.dtype))
        for stage in self.layers:
            x = stage(x)
        features = self.fc(self.norm(x).mean(dim=(1, 2)))
        logits = self.logits(features)
        return logits.float(), features.float()


_VARIANTS = {
    "swin_b": dict(embed_dim=128, depths=(2, 2, 18, 2),
                   num_heads=(4, 8, 16, 32)),
    # 32 px: an 8x8 map in windows of 4 (stage 1 shifts), then 4x4 (no
    # shift: the map is one window).
    "tiny_swin": dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                      window_size=4),
}


@torch.no_grad()
def init_weights(model: Swin, generator: torch.Generator) -> Swin:
    """The official initialisation, drawn from ``generator`` (CPU):
    every block linear and bias table N(0, 0.02) truncated at two standard
    deviations, their biases zero, LayerNorm scale one and bias zero; the
    patch convolution U(+-1/sqrt(fan_in)) (torch's default); the two heads
    as the ResNet's dense layers, U(+-sqrt(1/fan_in)) with zero bias."""
    heads = (model.fc, model.logits)
    for module in model.modules():
        if isinstance(module, Dense):
            if any(module is h for h in heads):
                limit = math.sqrt(1.0 / module.weight.shape[1])
                u = torch.rand(module.weight.shape, generator=generator)
                module.weight.copy_((2.0 * u - 1.0) * limit)
            else:
                module.weight.copy_(_trunc_normal(module.weight.shape, 0.02,
                                                  generator))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, WindowAttention):
            t = module.relative_position_bias_table
            t.copy_(_trunc_normal(t.shape, 0.02, generator))
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, Conv):
            limit = 1.0 / math.sqrt(module.weight[0].numel())
            for p in (module.weight, module.bias):
                u = torch.rand(p.shape, generator=generator)
                p.copy_((2.0 * u - 1.0) * limit)
    return model


def build_swin(variant: str = "swin_b", *, fc_layer_dim: int,
               out_features: int, logit_bias: bool = False,
               dtype: torch.dtype = torch.bfloat16, device=None,
               generator: Optional[torch.Generator] = None) -> Swin:
    """Construct a two-head Swin by variant name, in eval mode.

    Weights are drawn by :func:`init_weights` from ``generator`` (seed 0
    when ``None``); on the ``meta`` device nothing is drawn.
    """
    if variant not in _VARIANTS:
        raise ValueError(f"unknown swin variant {variant!r}; choose from "
                         f"{sorted(_VARIANTS)}")
    model = Swin(fc_layer_dim=fc_layer_dim, out_features=out_features,
                 logit_bias=logit_bias, dtype=dtype, variant=variant,
                 device=device, **_VARIANTS[variant])
    if torch.device(device or "cpu").type != "meta":
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(model, generator)
    return model.eval()
