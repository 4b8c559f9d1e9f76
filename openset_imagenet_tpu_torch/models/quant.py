"""Int8 quantized convolution of the post-training-quantized serving graph.

Counterpart of :class:`openset_imagenet_tpu.models.quant.QuantConv`: a
folded conv (batch-norm absorbed into kernel and bias) whose operands are
int8.  The scheme is the JAX package's symmetric one, without zero points:

- activations per tensor, ``q = clip(round(x * inv_input_scale), -127,
  127)`` (round half to even, as ``jnp.round``), ``inv_input_scale = 1 /
  s_in`` from calibration (:func:`..optimize.calibrate_amax`);
- weights per output channel, ``s_w[c] = max|kernel[..., c]| / 127``;
- int32 accumulation, and the epilogue ``y = acc * (s_in * s_w[c]) +
  bias`` in float32, rounded once to bfloat16.

The convolution and its epilogue are :func:`..ops.int8_conv.int8_conv`
(the CUDA kernel on the card, its plain version on the CPU).  Buffers
mirror the JAX leaves: int8 ``weight`` ``[Cout, kh, kw, Cin/groups]`` (the
kernel's layout; :mod:`..convert` maps JAX's HWIO ``kernel``), float32
``scale`` and ``bias`` ``[Cout]`` and the float32 scalar
``inv_input_scale``.  They are placeholders (zero kernel, unit scales)
until :func:`..optimize.quantize_params` fills them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.int8_conv import int8_conv


class QuantConv(nn.Module):
    """Int8 conv + folded-BN bias on NCHW activations (channels_last in
    memory on the serving path), out in the model's compute ``dtype``
    (bfloat16; float32 skips the last rounding); inference only."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(
            cout, kernel, kernel, cin // groups, dtype=torch.int8,
            device=device))
        self.register_buffer("scale", torch.ones(cout, device=device))
        self.register_buffer("bias", torch.zeros(cout, device=device))
        self.register_buffer("inv_input_scale",
                             torch.ones((), device=device))

    def _apply(self, fn, recurse=True):
        # ``Module.to(memory_format=torch.channels_last)`` re-lays every 4-D
        # buffer; the kernel reads the weight row-major as [Cout, kh, kw,
        # Cin/groups], so it is laid out so again once, here.
        module = super()._apply(fn, recurse)
        self.weight = self.weight.contiguous()
        return module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The NHWC view of a channels_last activation is contiguous; the
        # quantized tensor keeps its strides, so .contiguous() copies only
        # when the caller's activation was not channels_last.
        q = torch.clamp(torch.round(x.permute(0, 2, 3, 1).float()
                                    * self.inv_input_scale), -127, 127)
        y = int8_conv(q.to(torch.int8).contiguous(), self.weight,
                      self.scale, self.bias, self.stride, self.padding,
                      self.groups, self.dtype)
        return y.permute(0, 3, 1, 2)
