"""The port's train-mode batch-norm against flax (CPU).

Both forms the JAX model builds: flax ``nn.BatchNorm`` (``stats_rows`` 0)
and ``SubsetBatchNorm`` (ghost statistics over the leading rows), on the
same NHWC inputs, parameters, running statistics and output cotangent.
Checked: the output, the updated running mean and variance, and the
gradients to the input, scale and bias.  Tolerances: float32 within 1e-5
(another reduction order).  bfloat16: outputs bit-equal, running
statistics within 1e-5 (float32 statistics); the flax form's gradients
within 1e-5 of their scale; the ghost form's input gradient within 1e-2
and its scale and bias gradients within 5e-2 of their scale -- that form
multiplies in bfloat16, and flax sums the bfloat16 products of the
per-channel gradients in bfloat16 where torch accumulates them in float32
(measured up to 3.4e-2 over five seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from openset_imagenet_tpu.models.norm import SubsetBatchNorm as JaxSubset
from openset_imagenet_tpu_torch.models.norm import BatchNorm

C = 6


def _inputs(seed, shape=(8, 5, 5, C)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": (rng.normal(size=C) * 0.1).astype(np.float32)}
    stats = {"mean": (rng.normal(size=C) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    return x, g, params, stats


def _flax(stats_rows, dtype, x, g, params, stats):
    if stats_rows:
        mod = JaxSubset(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=dtype, stats_rows=stats_rows)
    else:
        mod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5, dtype=dtype,
                            param_dtype=jnp.float32)
    xj = jnp.asarray(x).astype(dtype)

    def f(xv, p):
        y, mutated = mod.apply({"params": p, "batch_stats": stats}, xv,
                               mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, mutated)

    (_, (y, mutated)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(xj, params)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return (f32(y), {k: f32(v) for k, v in mutated["batch_stats"].items()},
            f32(gx), {k: f32(v) for k, v in gp.items()})


def _port(stats_rows, dtype, x, g, params, stats):
    bn = BatchNorm(C, stats_rows=stats_rows).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).requires_grad_()
    y = bn(xt)
    (y.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    return (nhwc(y), {"mean": bn.running_mean.numpy(),
                      "var": bn.running_var.numpy()},
            nhwc(xt.grad), {"scale": bn.weight.grad.numpy(),
                            "bias": bn.bias.grad.numpy()})


@pytest.mark.parametrize("stats_rows", [0, 3, 8, 12])
def test_float32_train_batchnorm_matches_flax(stats_rows):
    args = _inputs(stats_rows)
    y, stats, gx, gp = _port(stats_rows, torch.float32, *args)
    ry, rstats, rgx, rgp = _flax(stats_rows, jnp.float32, *args)
    np.testing.assert_allclose(y, ry, rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], rstats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(gx, rgx, rtol=1e-5, atol=1e-5)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(gp[k], rgp[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("stats_rows", [0, 3])
def test_bfloat16_train_batchnorm_matches_flax(stats_rows):
    args = _inputs(stats_rows + 100)
    y, stats, gx, gp = _port(stats_rows, torch.bfloat16, *args)
    ry, rstats, rgx, rgp = _flax(stats_rows, jnp.bfloat16, *args)
    np.testing.assert_array_equal(y, ry)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], rstats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    tol_x, tol_p = (1e-2, 5e-2) if stats_rows else (1e-5, 1e-5)
    np.testing.assert_allclose(gx, rgx, rtol=0,
                               atol=tol_x * np.abs(rgx).max())
    for k in ("scale", "bias"):
        np.testing.assert_allclose(gp[k], rgp[k], rtol=0,
                                   atol=tol_p * np.abs(rgp[k]).max(),
                                   err_msg=k)


def test_eval_mode_leaves_running_statistics_alone():
    x, _, params, stats = _inputs(5)
    bn = BatchNorm(C, stats_rows=3)
    with torch.no_grad():
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    before = bn.running_var.clone()
    bn.eval()(xt)
    assert torch.equal(bn.running_var, before)
    bn.train()(xt)
    assert not torch.equal(bn.running_var, before)
