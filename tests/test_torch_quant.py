"""The port's int8 convolution against the JAX package's ``QuantConv`` (CPU).

The plain version of ``ops.int8_conv`` (a float64 ``F.conv2d`` of the int8
values rounded to int32, then ``acc.float() * scale``, ``+ bias`` and the
rounding, as eager ops) and ``models.quant.QuantConv`` against flax's
``QuantConv`` on the same int8 parameters and inputs made from a seed with
numpy, at 1x1 and 3x3, stride 1 and 2, groups 1 and 4:

* the quantized input is bit-equal (``round`` half to even in both);
* the int32 sums are exact: equal to ``lax.conv_general_dilated`` with
  ``preferred_element_type=int32``, and to ``torch._int_mm`` over an
  explicit im2col, group by group;
* the output is bit-equal in bfloat16 and in float32 (XLA's CPU keeps the
  multiply and the add apart, as the kernel's ``__fmul_rn`` /
  ``__fadd_rn`` and the eager plain version do).

Also: ``int8_conv`` routes a CPU tensor to the plain version without
counting a launch and refuses other devices; ``_plan`` takes every
resnet50 conv on the tensor-core routes and the grouped ResNeXt convs on
the SIMT route; ``traffic`` counts bytes and operations.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu.models.quant import QuantConv as JQuantConv
from openset_imagenet_tpu_torch.models.quant import QuantConv
from openset_imagenet_tpu_torch.ops import int8_conv as ic

CASES = [  # kernel, stride, groups, cin, cout
    (1, 1, 1, 64, 32), (1, 2, 1, 32, 64), (3, 1, 1, 32, 32),
    (3, 2, 1, 16, 24), (3, 1, 4, 16, 16), (3, 2, 4, 32, 16),
    (1, 1, 4, 16, 32)]


def _params(k, cin, cout, groups, seed):
    rng = np.random.default_rng(seed)
    return {
        "kernel": rng.integers(-127, 128, (k, k, cin // groups, cout)
                               ).astype(np.int8),
        "scale": (rng.random(cout) * 1e-3 + 1e-5).astype(np.float32),
        "bias": rng.normal(size=cout).astype(np.float32),
        "inv_input_scale": np.asarray(40.0 + rng.random(), np.float32),
    }


def _jax_conv(k, stride, groups, cout, dtype):
    padding = [(1, 1), (1, 1)] if k == 3 else "SAME"
    return JQuantConv(cout, (k, k), strides=stride, padding=padding,
                      feature_group_count=groups, dtype=dtype)


def _port_conv(params, k, stride, groups, cin, cout, dtype):
    conv = QuantConv(cin, cout, k, stride, 1 if k == 3 else 0, groups,
                     dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            params["kernel"].transpose(3, 0, 1, 2))))
        for name in ("scale", "bias", "inv_input_scale"):
            getattr(conv, name).copy_(torch.from_numpy(params[name]))
    return conv


def _input(cin, seed, size=9):
    x = np.random.default_rng(seed + 1).normal(size=(2, size, size, cin))
    return (x * 2.5).astype(np.float32)


def im2col(q, k, stride, padding):
    """``[M, k*k*C]`` rows of an NHWC int8 tensor, (tap, channel) order."""
    qp = torch.nn.functional.pad(q, (0, 0, padding, padding, padding,
                                     padding))
    cols = qp.unfold(1, k, stride).unfold(2, k, stride)  # B,Ho,Wo,C,k,k
    b, ho, wo = cols.shape[:3]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, -1)


@pytest.mark.parametrize("k,stride,groups,cin,cout", CASES)
def test_plain_int8_conv_matches_jax_quantconv(k, stride, groups, cin, cout):
    params = _params(k, cin, cout, groups, seed=k * 100 + cin + groups)
    x32 = _input(cin, seed=cout)
    xb = jnp.asarray(x32, jnp.bfloat16)
    jconv = _jax_conv(k, stride, groups, cout, jnp.bfloat16)
    ref = np.asarray(jconv.apply({"params": params}, xb).astype(jnp.float32))
    # The quantized input and the int32 sums, as QuantConv forms them.
    jq = np.asarray(jnp.clip(jnp.round(xb.astype(jnp.float32)
                                       * params["inv_input_scale"]),
                             -127, 127).astype(jnp.int8))
    jacc = np.asarray(jax.lax.conv_general_dilated(
        jq, params["kernel"], (stride, stride),
        [(1, 1), (1, 1)] if k == 3 else [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))

    conv = _port_conv(params, k, stride, groups, cin, cout, torch.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    q = torch.clamp(torch.round(xt.permute(0, 2, 3, 1).float()
                                * conv.inv_input_scale), -127, 127
                    ).to(torch.int8).contiguous()
    np.testing.assert_array_equal(q.numpy(), jq)
    acc = ic.int8_conv_acc_plain(q, conv.weight, stride, conv.padding,
                                 groups)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), jacc)
    # The same sums from torch._int_mm over an explicit im2col, by group.
    cols, cg, ng = im2col(q, k, stride, conv.padding), cin // groups, \
        cout // groups
    cols = cols.view(cols.shape[0], k * k, groups, cg)
    for g in range(groups):
        a = cols[:, :, g].reshape(cols.shape[0], -1).contiguous()
        w = conv.weight[g * ng:(g + 1) * ng].reshape(ng, -1)
        if a.shape[0] > 16 and a.shape[1] % 8 == 0 and ng % 8 == 0:
            mm = torch._int_mm(a, w.t().contiguous())
        else:  # outside _int_mm's shape rule: an exact int64 product
            mm = (a.long() @ w.long().t()).int()
        np.testing.assert_array_equal(
            mm.numpy(), acc.reshape(-1, cout)[:, g * ng:(g + 1) * ng].numpy())

    with torch.no_grad():
        got = conv(xt)
    assert got.dtype == torch.bfloat16 and got.shape == (
        2, cout, *ref.shape[1:3])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  ref)
    before = ic.LAUNCHES["int8_conv"]
    direct = ic.int8_conv(q, conv.weight, conv.scale, conv.bias, stride,
                          conv.padding, groups)
    assert ic.LAUNCHES["int8_conv"] == before  # the plain version ran
    assert torch.equal(direct, got.permute(0, 2, 3, 1))


@pytest.mark.parametrize("k,stride,groups,cin,cout", CASES[:5])
def test_float32_output_matches_jax(k, stride, groups, cin, cout):
    """A float32 model's QuantConv: the epilogue without the bf16
    rounding, bit-equal to flax's."""
    params = _params(k, cin, cout, groups, seed=7 + k + cin)
    x = _input(cin, seed=cin + cout)
    ref = np.asarray(_jax_conv(k, stride, groups, cout, jnp.float32).apply(
        {"params": params}, jnp.asarray(x)))
    conv = _port_conv(params, k, stride, groups, cin, cout, torch.float32)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_channels_last_input_and_layout():
    """A channels_last activation goes in without a copy of its layout;
    ``.to(memory_format=channels_last)`` keeps the weight row-major."""
    params = _params(3, 16, 16, 1, seed=3)
    conv = _port_conv(params, 3, 1, 1, 16, 16, torch.bfloat16)
    x = torch.from_numpy(_input(16, seed=4)).permute(0, 3, 1, 2).to(
        torch.bfloat16)
    with torch.no_grad():
        a = conv(x.contiguous())
        conv = conv.to(memory_format=torch.channels_last)
        b = conv(x.contiguous(memory_format=torch.channels_last))
    assert conv.weight.is_contiguous()
    assert b.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(a, b)


def test_routes_and_refusals():
    # every resnet50 QuantConv: (cin, cout) of the 1x1, 3x3, downsample
    resnet50 = [(64, 64), (64, 256), (256, 64), (256, 128), (128, 128),
                (128, 512), (512, 128), (256, 512), (512, 256), (256, 256),
                (256, 1024), (1024, 256), (512, 1024), (1024, 512),
                (512, 512), (512, 2048), (2048, 512), (1024, 2048)]
    for cin, cout in resnet50:
        assert ic._plan(cin, cout, 1, True) == (
            "tc128" if cout >= 128 else "tc64")
    for cin, cout, g in ((128, 128, 32), (256, 256, 32), (512, 512, 32),
                         (1024, 1024, 32), (16, 16, 4)):
        assert ic._plan(cin, cout, g, True) == "simt"
    assert ic._plan(64, 64, 1, False) == "simt"
    q = torch.zeros(1, 4, 4, 8, dtype=torch.int8, device="meta")
    w = torch.zeros(8, 1, 1, 8, dtype=torch.int8, device="meta")
    v = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ic.int8_conv(q, w, v, v)


def test_traffic_counts():
    nbytes, ops = ic.traffic(2, 8, 8, 64, 128, 3, 2, 1, 1)
    m = 2 * 4 * 4
    assert ops == 2 * m * 128 * 9 * 64
    assert nbytes == 2 * 8 * 8 * 64 + 128 * 9 * 64 + 8 * 128 + 2 * m * 128
