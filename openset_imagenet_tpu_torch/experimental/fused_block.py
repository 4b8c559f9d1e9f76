"""Fused-backward bottleneck block: a block-level autograd Function + K5.

Counterpart of :mod:`openset_imagenet_tpu.experimental.fused_block`.  The
bottleneck (1x1 -> 3x3(stride) -> 1x1, v1.5) becomes one
``torch.autograd.Function`` whose forward saves the block input, the three
raw conv outputs and the boundary ReLU gate as int8, and whose backward
runs each pointwise-conv region (ReLU/batch-norm backward, the channel
sums, the data-gradient product, the weight-gradient product and the skip
accumulation) as one K5 site (:mod:`..ops.fused_block_bwd`); the 3x3 conv
and the downsample path keep torch's own backward.  Batch-norm enters as
folded float32 ``(mul, add)`` vectors (:meth:`..models.norm.BatchNorm.
fold`), whose gradients come back as channel sums, so the ghost-statistics
chain rule is plain autograd outside the Function.

Tensors are NCHW in ``channels_last`` memory, as in the port's model;
conv weights keep the port's OIHW layout (``[cout, cin, 1, 1]`` for the
pointwise convs).  The K5 sites see ``[M, C]`` row views of them.

``use_kernel`` replaces JAX's ``use_pallas``: ``None`` routes each site by
the tensors' device (CPU: the plain version; CUDA: the CUDA kernel, or an
error), ``False`` is the explicit plain version, and ``True`` on a CPU
tensor raises.  Unlike the JAX package, whose default is its jnp backward
because of a TPU measurement (``experimental/__init__.py:8-16`` there) and
which reads ``OSI_FUSED_BLOCK_BWD``, the port reads no environment
variable: on a CUDA tensor the kernel is the default.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.norm import ghost_stats
from ..ops import fused_block_bwd as fbb
from ..ops.fused_block_bwd import bwd_site_plain

Tensor = torch.Tensor

__all__ = ["bottleneck_fused", "bwd_site_plain", "ghost_stats",
           "masked_add_relu"]


class _MaskedAddRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        s = a + b
        ctx.save_for_backward((s > 0).to(torch.int8))
        return torch.relu(s)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        gm = g * mask.to(g.dtype)
        return gm, gm


def masked_add_relu(a: Tensor, b: Tensor) -> Tensor:
    """``relu(a + b)`` whose backward reads an int8 gate, not the sum.

    The JAX ``masked_add_relu`` (``fused_block.py:51-76``): the same
    values and gradients as ``torch.relu(a + b)``, the tie at 0 included
    (the gate is ``a + b > 0``), with a 1-byte residual instead of the
    activation-dtype sum.
    """
    return _MaskedAddRelu.apply(a, b)


def _channel(v: Tensor, dtype) -> Tensor:
    return v.to(dtype).view(1, -1, 1, 1)


def _affine(z: Tensor, mul: Tensor, add: Tensor) -> Tensor:
    """``z * mul + add`` in z's dtype, the ghost batch-norm's rounding."""
    return z * _channel(mul, z.dtype) + _channel(add, z.dtype)


def _pw(x: Tensor, w: Tensor) -> Tensor:
    """Pointwise (1x1) conv with an OIHW ``[cout, cin, 1, 1]`` kernel."""
    return F.conv2d(x, w)


def _conv3x3(xa: Tensor, w: Tensor, stride: int) -> Tensor:
    return F.conv2d(xa, w, None, stride, 1)


def _block_fwd_math(x0, w1, w2, w3, wd, mul1, add1, mul2, add2, mul3, add3,
                    muld, addd, *, stride: int):
    """The bottleneck forward: ``(out, (z1, z2, z3, mask))``."""
    dt = x0.dtype
    z1 = _pw(x0, w1.to(dt))
    xa1 = torch.relu(_affine(z1, mul1, add1))
    z2 = _conv3x3(xa1, w2.to(dt), stride)
    xa2 = torch.relu(_affine(z2, mul2, add2))
    z3 = _pw(xa2, w3.to(dt))
    if wd is None:
        skip = x0
    else:
        skip = _affine(_pw(x0[:, :, ::stride, ::stride], wd.to(dt)), muld,
                       addd)
    pre = _affine(z3, mul3, add3) + skip
    return torch.relu(pre), (z1, z2, z3, (pre > 0).to(torch.int8))


def _unrows(rows: Tensor, like: Tensor) -> Tensor:
    n, c, h, w = like.shape
    return rows.view(n, h, w, c).permute(0, 3, 1, 2)


def _site_matrix(w: Tensor, dt) -> Tensor:
    """OIHW ``[co, ci, 1, 1]`` -> the site's ``[ci, co]`` in dtype ``dt``."""
    return w[:, :, 0, 0].t().to(dt).contiguous()


def _site(use_kernel, *args, **kw):
    if use_kernel is False:
        return bwd_site_plain(*args, **kw)
    if use_kernel and not args[0].is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the CPU runs "
                         "the plain version (use_kernel=None or False)")
    return fbb.bwd_site(*args, **kw)


def _as_rows(t: Tensor) -> Tensor:
    """``[N, C, H, W]`` -> its ``[M, C]`` rows: a view of channels_last
    memory (copied into that layout first if it is in another)."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


class _Bottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, w1, w2, w3, mul1, add1, mul2, add2, mul3, add3, wd,
                muld, addd, stride, use_kernel):
        out, (z1, z2, z3, mask) = _block_fwd_math(
            x0, w1, w2, w3, wd, mul1, add1, mul2, add2, mul3, add3, muld,
            addd, stride=stride)
        ctx.save_for_backward(x0, z1, z2, z3, mask, w1, w2, w3, wd, mul1,
                              add1, mul2, add2, mul3, muld, addd)
        ctx.stride, ctx.use_kernel = stride, use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        (x0, z1, z2, z3, mask, w1, w2, w3, wd, mul1, add1, mul2, add2, mul3,
         muld, addd) = ctx.saved_tensors
        s, dt = ctx.stride, x0.dtype

        def site(*args, **kw):
            return _site(ctx.use_kernel, *args, **kw)

        # Tail: boundary ReLU + bn3 + conv3 dX/dW + bn2/relu2 backward.
        dz2, ds4, dw3, (dmul3, dadd3), (dmul2, dadd2) = site(
            _as_rows(g.to(dt)), _as_rows(z3), _as_rows(mask), _as_rows(z2),
            None, _site_matrix(w3, dt), mul3, torch.zeros_like(mul3), mul2,
            add2, in_act=True, emit_gp=True)
        dz2 = _unrows(dz2, z2)

        # Middle: the 3x3 conv's own backward on a recomputed xa1.
        xa1 = torch.relu(_affine(z1, mul1, add1))
        w2t = w2.to(dt)
        dxa1, dw2, _ = torch.ops.aten.convolution_backward(
            dz2, xa1, w2t, None, [s, s], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])

        # Head: bn1/relu1 backward + conv1 dX/dW (+ the identity skip).
        dx0, _, dw1, (dmul1, dadd1), _ = site(
            _as_rows(dxa1), _as_rows(z1), None, _as_rows(x0),
            ds4 if wd is None else None,
            _site_matrix(w1, dt), mul1, add1, in_act=False, emit_gp=False)
        dx0 = _unrows(dx0, x0)

        pw_grad = lambda dw, like: dw.t()[:, :, None, None].to(like.dtype)
        grads = [dx0, pw_grad(dw1, w1), dw2.to(w2.dtype), pw_grad(dw3, w3),
                 dmul1, dadd1, dmul2, dadd2, dmul3, dadd3, None, None, None]
        if wd is not None:
            # The skip path (strided 1x1 conv + batch-norm) by autograd.
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_()
                          for t in (x0, wd, muld, addd)]
                xs, wds, mds, ads = leaves
                skip = _affine(_pw(xs[:, :, ::s, ::s], wds.to(dt)), mds, ads)
                dx0s, dwd, dmuld, daddd = torch.autograd.grad(
                    skip, leaves, _unrows(ds4, z3))
            grads[0] = dx0 + dx0s
            grads[10:13] = [dwd, dmuld, daddd]
        return (*grads, None, None)


def bottleneck_fused(x0: Tensor, w1: Tensor, w2: Tensor, w3: Tensor,
                     mul1: Tensor, add1: Tensor, mul2: Tensor, add2: Tensor,
                     mul3: Tensor, add3: Tensor, wd: Optional[Tensor] = None,
                     muld: Optional[Tensor] = None,
                     addd: Optional[Tensor] = None, *, stride: int = 1,
                     use_kernel: Optional[bool] = None) -> Tensor:
    """Bottleneck block whose backward runs its pointwise sites through K5.

    ``x0``: NCHW activations (channels_last memory) in the compute dtype;
    ``w1``/``w3``/``wd``: OIHW 1x1 kernels, ``w2`` the OIHW 3x3 kernel
    (float32 parameters, cast to the compute dtype as flax does);
    ``mul*``/``add*``: float32 folded batch-norm vectors.  Returns the
    block output; gradients flow to every tensor argument.  Without a
    gradient to compute (eval, ``torch.no_grad``) it is the plain forward.
    """
    tensors = (x0, w1, w2, w3, mul1, add1, mul2, add2, mul3, add3, wd, muld,
               addd)
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors)):
        return _block_fwd_math(x0, w1, w2, w3, wd, mul1, add1, mul2, add2,
                               mul3, add3, muld, addd, stride=stride)[0]
    return _Bottleneck.apply(*tensors, int(stride), use_kernel)
