"""The int8 convolution of the quantized serving graph, with its epilogue.

No TPU kernel stands behind it: the JAX package's ``QuantConv``
(``models/quant.py:84-92`` there) computes ``lax.conv_general_dilated``
on int8 operands with int32 accumulation through XLA.  PyTorch has no
int8 convolution that accumulates in int32 (``F.conv2d`` on int8 tensors
returns int8, its sums wrapped), so the port writes one:

    y = bf16(f32(acc) * scale[c] + bias[c]),   acc = conv(q, w) in int32

with ``q`` NHWC int8 ``[B, H, W, Cin]``, ``w`` int8 ``[Cout, kh, kw,
Cin/groups]`` (K contiguous in both operands), ``scale`` and ``bias``
float32 ``[Cout]``, the output NHWC bfloat16 ``[B, Ho, Wo, Cout]`` (or
float32 for a float32 model, without the last rounding);
``padding`` zeros on every side (JAX's explicit ``(1, 1)`` of the 3x3
convs, 0 for a 1x1).  A channels_last activation is NHWC in memory, so a
caller passes ``x.permute(0, 2, 3, 1)`` and nothing is copied.

:func:`int8_conv` routes by device: CPU tensors go to
:func:`int8_conv_plain` (a float64 ``F.conv2d`` on the int8 values --
every partial sum is an integer far below 2**53 -- rounded to int32, then
the epilogue as separate eager ops), CUDA tensors to the CUDA C++ kernel
in ``csrc/int8_conv.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use into ``build/kernels/`` by :mod:`._build`, bound with ``ctypes``), or
raise.  Kernel and plain version give the same bits.  ``_plan`` picks the
kernel's route from the shape alone: ``tc128`` / ``tc64``, an implicit
GEMM on ``mma.sync`` int8 tensor cores, where a group has a multiple of
64 input channels and of 8 output channels (every resnet50 conv), else
``simt`` (``__dp4a`` where a group's channels come in fours: the ResNeXt
variants).  ``LAUNCHES["int8_conv"]`` counts the calls that launched the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor

LAUNCHES = {"int8_conv": 0}

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "int8_conv.cu"
_ROUTES = {"simt": 0, "tc64": 1, "tc128": 2}
_OUT_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


# -- plain version (CPU path; the reference the kernel is held to) ----------

def int8_conv_acc_plain(q: Tensor, weight: Tensor, stride: int = 1,
                        padding: int = 0, groups: int = 1) -> Tensor:
    """The int32 sums ``conv(q, weight)``, NHWC ``[B, Ho, Wo, Cout]``:
    a float64 convolution of the int8 values, exact, rounded to int32."""
    acc = F.conv2d(q.permute(0, 3, 1, 2).double(),
                   weight.permute(0, 3, 1, 2).double(), None, stride,
                   padding, 1, groups)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_conv_plain(q: Tensor, weight: Tensor, scale: Tensor, bias: Tensor,
                    stride: int = 1, padding: int = 0, groups: int = 1,
                    dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """:func:`int8_conv_acc_plain`, then ``acc.float() * scale``, ``+
    bias`` and the rounding to ``dtype`` as three eager ops."""
    acc = int8_conv_acc_plain(q, weight, stride, padding, groups)
    return ((acc.float() * scale) + bias).to(dtype)


# -- the kernel ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load(SOURCE, "int8_conv", {
        "i8c_conv": ([p] * 5 + [i] * 13 + [p], i)})


def _plan(cin: int, cout: int, groups: int, aligned: bool) -> str:
    """The kernel's route for a conv: tensor cores where every 64-byte K
    slice of a row lies in one filter tap of one group (``Cin/groups %
    64 == 0``), a group's outputs pair up into whole 8-column fragments
    (``Cout/groups % 8 == 0``) and the operands are 16-byte aligned --
    128-column tiles from 128 outputs a group, else 64; elsewhere the SIMT
    route."""
    cg, ng = cin // groups, cout // groups
    if aligned and cg % 64 == 0 and ng % 8 == 0:
        return "tc128" if ng >= 128 else "tc64"
    return "simt"


def resnet50_shapes(image_size: int = 224) -> dict:
    """``{(H, cin, cout, kernel, stride): count}`` of the 52 quantized
    convs of one resnet50 forward at ``image_size`` px (square inputs of H
    pixels a side; 3x3 convs pad 1, 1x1 convs 0)."""
    shapes: dict = {}
    h, cin = image_size // 4, 64
    for i, blocks in enumerate((3, 4, 6, 3)):
        width = 64 * 2 ** i
        for j in range(blocks):
            s = 2 if i > 0 and j == 0 else 1
            convs = [(h, cin, width, 1, 1), (h, width, width, 3, s),
                     (h // s, width, 4 * width, 1, 1)]
            if s != 1 or cin != 4 * width:
                convs.append((h, cin, 4 * width, 1, s))
            for conv in convs:
                shapes[conv] = shapes.get(conv, 0) + 1
            h, cin = h // s, 4 * width
    return shapes


def traffic(b: int, h: int, w: int, cin: int, cout: int, k: int,
            stride: int, padding: int, groups: int) -> Tuple[int, int]:
    """``(bytes, operations)`` one call needs: q, the weights, scale and
    bias read once, the bfloat16 output written once; ``2 * M * N * K``
    integer operations a group."""
    ho, wo = out_size(h, k, stride, padding), out_size(w, k, stride, padding)
    m = b * ho * wo
    kk = k * k * (cin // groups)
    nbytes = b * h * w * cin + cout * kk + 8 * cout + 2 * m * cout
    return nbytes, 2 * m * cout * kk


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC activations: "
                         "the permuted view of a channels_last tensor)")


def _kernel_conv(q, weight, scale, bias, stride, padding, groups, dtype):
    dev = q.device
    if q.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"q must be NHWC [B, H, W, Cin] and weight [Cout, "
                         f"kh, kw, Cin/groups], got {tuple(q.shape)} and "
                         f"{tuple(weight.shape)}")
    b, h, w, cin = q.shape
    cout, kh, kw, cg = weight.shape
    if kh != kw or groups < 1 or cin % groups or cout % groups or \
            cg != cin // groups:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit q "
                         f"{tuple(q.shape)} with groups={groups}")
    ho, wo = out_size(h, kh, stride, padding), out_size(w, kw, stride,
                                                       padding)
    if min(b, ho, wo, cout) <= 0 or stride < 1 or padding < 0:
        raise ValueError(f"empty or invalid conv: q {tuple(q.shape)}, "
                         f"kernel {kh}, stride {stride}, padding {padding}")
    for name, t, shape, want in (
            ("q", q, (b, h, w, cin), torch.int8),
            ("weight", weight, (cout, kh, kw, cg), torch.int8),
            ("scale", scale, (cout,), torch.float32),
            ("bias", bias, (cout,), torch.float32)):
        _check(name, t, shape, want, dev)
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv writes bfloat16 or float32, not "
                        f"{dtype}")
    y = torch.empty((b, ho, wo, cout), dtype=dtype, device=dev)
    route = _plan(cin, cout, groups,
                  all(t.data_ptr() % 16 == 0 for t in (q, weight, y)))
    vec4 = int(cg % 4 == 0 and q.data_ptr() % 4 == 0 and
               weight.data_ptr() % 4 == 0)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.i8c_conv(q.data_ptr(), weight.data_ptr(), scale.data_ptr(),
                           bias.data_ptr(), y.data_ptr(), b, h, w, cin,
                           cout, kh, kw, stride, padding, groups,
                           _ROUTES[route], vec4, _OUT_DTYPES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err} "
                           f"(q {tuple(q.shape)}, weight "
                           f"{tuple(weight.shape)}, {route})")
    LAUNCHES["int8_conv"] += 1
    return y


def int8_conv(q: Tensor, weight: Tensor, scale: Tensor, bias: Tensor,
              stride: int = 1, padding: int = 0, groups: int = 1,
              dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """``dtype(f32(conv(q, weight)) * scale + bias)``, NHWC: the kernel on
    CUDA tensors, :func:`int8_conv_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return int8_conv_plain(q, weight, scale, bias, stride, padding,
                               groups, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"int8_conv runs on CPU or CUDA tensors, not "
                         f"{q.device}")
    return _kernel_conv(q, weight, scale, bias, stride, padding, groups,
                        dtype)
