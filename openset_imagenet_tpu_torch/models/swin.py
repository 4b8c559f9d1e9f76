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
  even blocks, and after a cyclic shift of the map by ``window_size //
  2`` in odd blocks (SW-MSA), where a region mask (-100,
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
product has been rounded.  LayerNorm rounds its float32 scale and shift
to the compute dtype, takes its statistics in float32 and rounds its
output to the compute dtype.  Every LayerNorm runs through
:mod:`..ops.layer_norm` (on the card one kernel each way, on the CPU its
plain version), and each residual junction ``h = x + round(y + b)``
whose sum a LayerNorm reads is fused with it (:meth:`LayerNorm.add`):
``y`` is the ``proj`` or ``fc2`` product without its bias (``Dense.
product``), ``b`` that Dense's bias, added in the junction after the
product has been rounded, as ``Dense`` adds it.  A stage hands each
block its input ``h`` and ``norm1(h)``; a block's second junction is
fused with the next block's ``norm1`` (the last block of the last stage:
with the model's final LayerNorm), so 45 of Swin-B's 53 LayerNorms take
their junction with them.  The patch embedding's, each stage's first
``norm1`` and patch merging's stand alone, and the end of a stage before
patch merging is the written-out add (``x + (y + b)``), which the merge's
concatenation reads.  Attention runs through
:func:`..ops.window_attention.window_attention`: the ``qkv`` Dense is
applied to the block's tokens in the map's own order (a per-token product
commutes with any permutation of the tokens), and the op reads each
window's q, k and v at their places in the map, rolled and partitioned
by index, adds the bias from the table and the region mask by index,
and writes the output back at the same places, which ``proj`` reads.  On
the card that is two hand-written kernels (one forward, one backward);
on the CPU its plain version.  Scores, softmax and the bias are float32;
q, k, v and the softmax weights are in the compute dtype.  No roll,
partition, merge or mask exists in device memory: a block's window and
shift (:meth:`SwinBlock.geometry`) depend on its map's size alone, and
the op derives the bias index and the region by index, so a model built
on ``meta`` and filled by ``load_state_dict`` holds no buffer.
:func:`relative_position_index`, :func:`region_mask`,
:func:`window_partition` and :func:`window_reverse` are the written-out
forms of what the op derives, which the tests hold it against.

``state_dict`` names follow the official code (``patch_embed.proj.*``,
``patch_embed.norm.*``, ``layers.{i}.blocks.{j}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}.*``,
``layers.{i}.downsample.{norm, reduction}.*``, ``norm.*``), and the heads
are ``fc.*`` and ``logits.*``.

Each block's attention (the ``qkv`` product, the window attention, the
``proj`` product without its bias) is the device span ``swin.attention``
(:mod:`..tracing`); on the card, ``window_attention.LAUNCHES`` and
``layer_norm.LAUNCHES`` count the kernels' launches.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops.layer_norm import add_layer_norm, layer_norm
from ..ops.window_attention import MASKED, window_attention
from .resnet import Conv, Dense, _trunc_normal

LN_EPSILON = 1e-5


class LayerNorm(nn.Module):
    """LayerNorm over the last dimension with float32 ``weight`` and
    ``bias`` rounded to the input's dtype; the statistics are taken in
    float32 and the output is rounded to the input's dtype
    (:mod:`..ops.layer_norm`: a kernel each way on the card, plain torch on
    the CPU).  :meth:`add` fuses it with the residual junction before it."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, LN_EPSILON)

    def add(self, x: torch.Tensor, y: torch.Tensor,
            y_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(h, self(h))`` with ``h = x + round(y + y_bias)``: the residual
        ``x``, a Dense's product ``y`` without its float32 bias
        ``y_bias``."""
        return add_layer_norm(x, y, y_bias, self.weight, self.bias,
                              LN_EPSILON)


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


class WindowAttention(nn.Module):
    """Multi-head attention inside windows, with the relative-position
    bias (``relative_position_bias_table``) and, after a shift, the
    region mask."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 device=None):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window_size - 1) ** 2, num_heads, device=device))
        self.qkv = Dense(dim, 3 * dim, device=device)
        self.proj = Dense(dim, dim, device=device)

    def forward(self, x: torch.Tensor, ws: int, shift: int) -> torch.Tensor:
        """``x``: ``[B, H, W, C]`` tokens in the map's order -> ``[B, H, W,
        C]``: attention in the ``ws x ws`` windows of the map rolled by
        ``-shift``, merged and rolled back, through ``proj``'s product;
        ``proj.bias`` is added at the junction after it."""
        return self.proj.product(window_attention(
            self.qkv(x), self.relative_position_bias_table, ws, shift))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device)
        self.fc2 = Dense(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``fc2``'s product, without ``fc2.bias`` (added at the junction
        after it)."""
        return self.fc2.product(F.gelu(self.fc1(x)))


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

    def geometry(self, h: int, w: int) -> Tuple[int, int]:
        """``(window, shift)`` of an ``h x w`` token map: the official rule
        (a map no larger than the window is one unshifted window)."""
        ws = self.window_size
        shift = ws // 2 if self.shifted else 0
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        if h % ws or w % ws:
            raise ValueError(f"a {h}x{w} token map does not divide into "
                             f"{ws}x{ws} windows")
        return ws, shift

    def chain(self, h: torch.Tensor, n: torch.Tensor,
              norm: Optional[LayerNorm]
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block on the residual stream ``h`` and ``n = norm1(h)``:
        ``(out, norm(out))``, each residual junction fused with the
        LayerNorm after it (``norm2``, then ``norm``: the next block's
        ``norm1`` or the model's final LayerNorm); ``(out, None)`` without
        ``norm``, the last add written out."""
        ws, shift = self.geometry(*h.shape[1:3])
        with tracing.span("swin.attention", device=h.device):
            y = self.attn(n, ws, shift)
        h, n = self.norm2.add(h, y, self.attn.proj.bias)
        y = self.mlp(n)
        if norm is None:
            return h + (y + self.mlp.fc2.bias.to(y.dtype)), None
        return norm.add(h, y, self.mlp.fc2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.chain(x, self.norm1(x), None)[0]


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

    def forward(self, x: torch.Tensor,
                norm: Optional[LayerNorm] = None) -> torch.Tensor:
        """The stage's output map, downsampled where the stage merges
        patches; ``norm(output)`` where ``norm`` is given to a stage
        without patch merging (the model's final LayerNorm, fused into the
        last junction).  Each block hands its output and the next block's
        ``norm1`` of it to the next."""
        norms = [block.norm1 for block in self.blocks[1:]]
        h, n = x, self.blocks[0].norm1(x)
        for block, after in zip(self.blocks, norms + [norm]):
            h, n = block.chain(h, n, after)
        if self.downsample is not None:
            return self.downsample(h)
        return h if norm is None else n


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, device=None):
        super().__init__()
        self.proj = Conv(3, dim, patch, patch, bias=True, device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images -> ``[B, H / patch, W / patch, dim]`` tokens."""
        return self.norm(self.proj(x).permute(0, 2, 3, 1).contiguous())


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
        last = len(self.layers) - 1
        for i, stage in enumerate(self.layers):
            x = stage(x, self.norm if i == last else None)
        features = self.fc(x.mean(dim=(1, 2)))
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
