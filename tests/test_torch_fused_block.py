"""The port's fused-backward bottleneck against the JAX package's (CPU).

* K5's plain version ``bwd_site_plain`` against JAX's ``_bwd_ref`` and
  its Pallas kernel in interpreter mode, at m = 512, ci = 16, co = 24 for
  the three site forms of ``tests/test_fused_block.py``: float32 within
  rtol and atol 1e-5 (summation order), bfloat16 within rtol 2e-2, atol
  1e-2 (the JAX package's own kernel-vs-reference bound; one bf16 ulp of
  dx) and gp exactly.  A ragged m (no power of two >= 256 divides it)
  against ``_bwd_ref``.  On CPU tensors the wrapper ``bwd_site`` is the
  plain version and launches nothing.
* ``bottleneck_fused``'s backward against torch autograd of
  ``_block_fwd_math`` in float32 within rtol and atol 1e-4 (as
  ``tests/test_fused_block.py:134-136``): identity skip, downsample at
  stride 1 and 2.
* ``masked_add_relu`` bit-exact against ``relu(a + b)``, values and
  gradients, ties at 0 included.
* The port's fused tiny50 (``fused_blocks`` + ``boundary_mask``, ghost
  window 2) against JAX's on shared weights at 48 px: float32 train and
  eval forwards and the running-statistics update within 1e-4, the
  bfloat16 eval forward bit for bit and the train forward within 2e-2 on
  the scores, and one ``make_train_step`` step each (SGD, Adam) from the
  same carried state: loss within rtol 1e-4, parameters and statistics
  within 1e-5 (``tests/test_torch_train.py``'s bounds).
* The port raises where the JAX model does, and ``make_tail_step``
  refuses a ragged tail for a fused model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu import train as jengine
from openset_imagenet_tpu.config import NameSpace as JaxNameSpace
from openset_imagenet_tpu.experimental import fused_block as jfb
from openset_imagenet_tpu.models.resnet import build_resnet as jax_build
from openset_imagenet_tpu_torch import convert
from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.experimental import fused_block as fb
from openset_imagenet_tpu_torch.models.resnet import build_resnet
from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb
from tests.test_torch_model import _random_variables

FORMS = {  # the three site forms of tests/test_fused_block.py:37-41
    "tail": dict(in_act=True, has_mask=True, has_ds=False, emit_gp=True),
    "head_ds": dict(in_act=False, has_mask=False, has_ds=True,
                    emit_gp=False),
    "head": dict(in_act=False, has_mask=False, has_ds=False, emit_gp=False),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("dx", "gp", "dw", "s_mul_o", "s_add_o", "s_mul_i", "s_add_i")


def _site_args(m, ci, co, dtype_name, form, seed=0):
    """The JAX test's inputs (``_site_inputs``), for both packages."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    cfg = FORMS[form]
    arr = {
        "g": rng.standard_normal((m, co)), "z": rng.standard_normal((m, co)),
        "mask": rng.integers(0, 2, (m, co)),
        "x": rng.standard_normal((m, ci)), "ds": rng.standard_normal((m, ci)),
        "w": rng.standard_normal((ci, co)) * 0.3,
        "mul_o": rng.standard_normal(co), "add_o": rng.standard_normal(co),
        "mul_i": rng.standard_normal(ci), "add_i": rng.standard_normal(ci)}
    drop = {"mask": not cfg["has_mask"], "ds": not cfg["has_ds"],
            "mul_i": not cfg["in_act"], "add_i": not cfg["in_act"]}
    jargs, targs = [], []
    for name, a in arr.items():
        if drop.get(name):
            jargs.append(None)
            targs.append(None)
            continue
        if name == "mask":
            j = jnp.asarray(a, jnp.int8)
            t = torch.from_numpy(a.astype(np.int8))
        elif name in ("g", "z", "x", "ds", "w"):
            j = jnp.asarray(a, jdt)
            t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(tdt)
        else:
            j = jnp.asarray(a, jnp.float32)
            t = torch.from_numpy(a.astype(np.float32))
        jargs.append(j)
        targs.append(t)
    kw = dict(in_act=cfg["in_act"], emit_gp=cfg["emit_gp"])
    return jargs, targs, kw, jdt


def _flat(out):
    dx, gp, dw, (smo, sao), (smi, sai) = out
    return dict(zip(NAMES, (dx, gp, dw, smo, sao, smi, sai)))


def _compare(got, ref, dtype_name, where):
    for name in NAMES:
        g, r = got[name], ref[name]
        assert (g is None) == (r is None), (where, name)
        if g is None:
            continue
        g = g.float().numpy()
        r = np.asarray(jnp.asarray(r, jnp.float32))
        if name == "gp":
            np.testing.assert_array_equal(g, r, err_msg=f"{where} gp")
        elif dtype_name == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(g, r, rtol=2e-2, atol=1e-2,
                                       err_msg=f"{where} {name}")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_bwd_site_plain_matches_jax(form, dtype_name):
    jargs, targs, kw, jdt = _site_args(512, 16, 24, dtype_name, form)
    got = _flat(fb.bwd_site_plain(*targs, **kw))
    ref = _flat(jfb._bwd_ref(*jargs, out_dtype=jdt, **kw))
    pal = _flat(jfb._bwd_pallas(*jargs, out_dtype=jdt, interpret=True, **kw))
    _compare(got, ref, dtype_name, f"{form} vs _bwd_ref")
    _compare(got, pal, dtype_name, f"{form} vs Pallas (interpret)")
    assert got["dx"].dtype == targs[0].dtype
    assert got["dw"].dtype == got["s_mul_o"].dtype == torch.float32


@pytest.mark.parametrize("form", sorted(FORMS))
def test_bwd_site_ragged_rows_match_ref(form):
    jargs, targs, kw, jdt = _site_args(300, 16, 24, "bfloat16", form,
                                       seed=3)
    before = dict(fbb.LAUNCHES)
    got = _flat(fbb.bwd_site(*targs, **kw))   # CPU tensors: plain version
    assert fbb.LAUNCHES == before
    _compare(got, _flat(jfb._bwd_ref(*jargs, out_dtype=jdt, **kw)),
             "bfloat16", f"{form} m=300")


def _block_args(downsample, stride, seed=1, b=2, hw=8, cin=8, f=2):
    """``tests/test_fused_block.py``'s block inputs, NCHW and OIHW."""
    rng = np.random.default_rng(seed)
    co = 4 * f
    if not downsample:
        cin = co
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    args = dict(
        x0=t(rng.standard_normal((b, cin, hw, hw))).contiguous(
            memory_format=torch.channels_last),
        w1=t(rng.standard_normal((f, cin, 1, 1)) * 0.4),
        w2=t(rng.standard_normal((f, f, 3, 3)) * 0.3),
        w3=t(rng.standard_normal((co, f, 1, 1)) * 0.4),
        mul1=t(rng.standard_normal(f)), add1=t(rng.standard_normal(f)),
        mul2=t(rng.standard_normal(f)), add2=t(rng.standard_normal(f)),
        mul3=t(rng.standard_normal(co)), add3=t(rng.standard_normal(co)))
    if downsample:
        args.update(wd=t(rng.standard_normal((co, cin, 1, 1)) * 0.4),
                    muld=t(rng.standard_normal(co)),
                    addd=t(rng.standard_normal(co)))
    return {k: v.requires_grad_() for k, v in args.items()}


@pytest.mark.parametrize("downsample,stride", [(False, 1), (True, 1),
                                               (True, 2)])
def test_block_backward_matches_autograd(downsample, stride):
    args = _block_args(downsample, stride)
    plain_out = fb._block_fwd_math(
        args["x0"], args["w1"], args["w2"], args["w3"], args.get("wd"),
        args["mul1"], args["add1"], args["mul2"], args["add2"],
        args["mul3"], args["add3"], args.get("muld"), args.get("addd"),
        stride=stride)[0]
    fused_out = fb.bottleneck_fused(**args, stride=stride)
    assert torch.equal(fused_out, plain_out)
    r = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(plain_out.shape)).astype(np.float32))
    keys = list(args)
    g_plain = torch.autograd.grad((plain_out * r).sum(), list(args.values()))
    g_fused = torch.autograd.grad((fused_out * r).sum(), list(args.values()))
    for k, a, b in zip(keys, g_fused, g_plain):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"grad {k}")


def test_block_use_kernel_routes():
    args = _block_args(False, 1)
    out = fb.bottleneck_fused(**args, use_kernel=False)
    grads = torch.autograd.grad(out.sum(), [args["x0"], args["w1"]])
    ref = torch.autograd.grad(fb.bottleneck_fused(**args).sum(),
                              [args["x0"], args["w1"]])
    for a, b in zip(grads, ref):
        assert torch.equal(a, b)
    out = fb.bottleneck_fused(**args, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        out.sum().backward()


def test_masked_add_relu_is_relu_of_sum():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((4, 8, 5, 5)).astype(np.float32)
    b = rng.standard_normal((4, 8, 5, 5)).astype(np.float32)
    b.reshape(-1)[::7] = -a.reshape(-1)[::7]           # ties: a + b == 0
    r = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        ins = [torch.from_numpy(v).to(dtype).requires_grad_() for v in (a, b)]
        ref_ins = [t.detach().clone().requires_grad_() for t in ins]
        got = fb.masked_add_relu(*ins)
        ref = torch.relu(ref_ins[0] + ref_ins[1])
        assert torch.equal(got, ref)
        assert int(((ref_ins[0] + ref_ins[1]) == 0).sum()) > 0
        g_got = torch.autograd.grad((got * r.to(dtype)).sum(), ins)
        g_ref = torch.autograd.grad((ref * r.to(dtype)).sum(), ref_ins)
        for x, y in zip(g_got, g_ref):
            assert torch.equal(x, y)


# -- the model ------------------------------------------------------------

# 48 px: at 32 px the last stage is 1x1 and a ghost window of 2 rows gives
# 2 values per channel, so ill-conditioned that both packages' float32
# forwards land 3e-3 from a float64 one; at 48 px both are within 4e-6.
SIZE, BATCH, GHOST = 48, 4, 2
MODEL_KW = dict(bn_stats_rows=GHOST, fused_blocks=True, boundary_mask=True)


def _images(seed=1, n=BATCH):
    return np.random.default_rng(seed).random(
        (n, SIZE, SIZE, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model(dtype_name, n=10):
    jmodel = jax_build("tiny50", fc_layer_dim=n, out_features=n,
                       dtype=DTYPES[dtype_name][0], **MODEL_KW)
    return jmodel, _random_variables(jmodel, seed=5)


def _port_model(dtype_name, variables, n=10):
    model = build_resnet("tiny50", fc_layer_dim=n, out_features=n,
                         dtype=DTYPES[dtype_name][1], **MODEL_KW)
    convert.load_into(model, convert.variables_to_state_dict(variables))
    return model


def test_fused_state_dict_keys_match_unfused():
    fused = build_resnet("resnet50", fc_layer_dim=7, out_features=7,
                         device="meta", **MODEL_KW)
    plain = build_resnet("resnet50", fc_layer_dim=7, out_features=7,
                         device="meta", bn_stats_rows=GHOST)
    assert {k: v.shape for k, v in fused.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}


@pytest.mark.parametrize("train", [True, False])
def test_float32_forward_and_statistics_match_jax(train):
    jmodel, variables = _jax_model("float32")
    images = _images()
    model = _port_model("float32", variables)
    model.train(train)
    if train:
        (ref_l, ref_f), upd = jmodel.apply(variables, images, train=True,
                                           mutable=["batch_stats"])
    else:
        ref_l, ref_f = jmodel.apply(variables, images, train=False)
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(images))
    for got, ref in ((logits, ref_l), (feats, ref_f)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    if train:
        want = convert.variables_to_state_dict(
            {"batch_stats": jax.device_get(upd["batch_stats"])})
        state = model.state_dict()
        for key, value in want.items():
            np.testing.assert_allclose(state[key].numpy(), value, rtol=1e-4,
                                       atol=1e-4, err_msg=key)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("train", [False, True])
def test_bfloat16_forward_matches_jax(train):
    jmodel, variables = _jax_model("bfloat16")
    images = _images(seed=2)
    model = _port_model("bfloat16", variables).train(train)
    out = jmodel.apply(variables, images, train=train,
                       mutable=["batch_stats"] if train else False)
    ref_logits = np.asarray(out[0][0] if train else out[0])
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(images))
    if not train:
        # Eval: folded running statistics, bit for bit.
        np.testing.assert_array_equal(logits.numpy(), ref_logits)
        return
    # Train: the ghost statistics are summed in another order in float32,
    # so a bf16 rounding of mul/add can flip; scores within 2e-2.
    np.testing.assert_allclose(_softmax(logits.numpy()),
                               _softmax(ref_logits), rtol=0, atol=2e-2)


LR = {"sgd": 1e-2, "adam": 1e-3}


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_train_step_matches_jax(kind):
    n = 8
    jmodel, variables = _jax_model("float32", n)
    tx = jengine.build_optimizer(JaxNameSpace({"type": kind,
                                               "lr": LR[kind]}), 1)
    state = jengine.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=jmodel.apply, tx=tx)
    rng = np.random.default_rng(4)
    batch = (rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8),
             rng.integers(-1, n, BATCH).astype(np.int32),
             np.ones(BATCH, np.float32))
    jstep = jengine.make_train_step(jengine.make_loss_fn("entropic", 0.5,
                                                         fused=True))
    new, metrics = jstep(state, *batch)
    snap = jax.device_get({"params": new.params,
                           "batch_stats": new.batch_stats,
                           "opt_state": new.opt_state})

    cfg = NameSpace({"model": {"variant": "tiny50", **MODEL_KW}})
    model = pengine.build_model(cfg, n, dtype=torch.float32, device="cpu")
    convert.load_into(model, convert.variables_to_state_dict(variables))
    pstate = pengine.create_state(model, pengine.build_optimizer(
        NameSpace({"type": kind, "lr": LR[kind]}), 1))
    step = pengine.make_train_step(pengine.make_loss_fn("entropic", 0.5,
                                                        fused="auto"))
    pstate, pm = step(pstate, *batch)
    np.testing.assert_allclose(float(pm["loss_sum"]),
                               float(metrics["loss_sum"]), rtol=1e-4)
    sd = {k: v.numpy() for k, v in pstate.model.state_dict().items()}
    colls = ("batch_stats", "params") if kind == "sgd" else ("batch_stats",)
    for coll in colls:
        for key, want in convert.variables_to_state_dict(
                {coll: snap[coll]}).items():
            np.testing.assert_allclose(sd[key], want, rtol=1e-5, atol=1e-5,
                                       err_msg=key)
    if kind == "adam":
        mu = convert.variables_to_state_dict(
            {"params": snap["opt_state"][0].mu})
        for key, p in pstate.model.named_parameters():
            g_ref = mu[key] / np.float32(0.1)
            np.testing.assert_allclose(
                p.grad.numpy(), g_ref, rtol=1e-4,
                atol=1e-4 * max(np.abs(g_ref).max(), 1e-30), err_msg=key)


# -- errors ---------------------------------------------------------------

def _jax_error(variant, train, **kw):
    jmodel = jax_build(variant, fc_layer_dim=3, out_features=3, **kw)
    x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    with pytest.raises(ValueError) as err:
        jmodel.init(jax.random.PRNGKey(0), x, train=train)
    return str(err.value)


@pytest.mark.parametrize("variant,rows,match", [
    ("tiny", 2, "fused_blocks requires Bottleneck variants"),
    ("tinyx", 2, "fused_blocks supports only the standard bottleneck"),
])
def test_construction_errors_match_jax(variant, rows, match):
    assert match in _jax_error(variant, False, bn_stats_rows=rows,
                               fused_blocks=True)
    with pytest.raises(ValueError, match=match):
        build_resnet(variant, fc_layer_dim=3, out_features=3,
                     bn_stats_rows=rows, fused_blocks=True)


def test_fused_training_without_ghost_rows_raises_as_jax():
    message = _jax_error("tiny50", True, fused_blocks=True)
    model = build_resnet("tiny50", fc_layer_dim=3, out_features=3,
                         fused_blocks=True).train()
    with pytest.raises(ValueError, match="bn_stats_rows") as err:
        model(torch.zeros(2, SIZE, SIZE, 3))
    assert str(err.value) == message


def test_tail_step_refuses_a_fused_ragged_tail():
    loss_fn = pengine.make_loss_fn("entropic")
    regular = pengine.make_train_step(loss_fn)
    model = pengine.build_model(NameSpace({"model": {
        "variant": "tiny50", **MODEL_KW}}), 4, device="cpu")
    assert pengine.make_tail_step(loss_fn, model, 0, regular) is None
    for n_tail in (1, GHOST, 3):
        with pytest.raises(ValueError, match="drop_remainder=True"):
            pengine.make_tail_step(loss_fn, model, n_tail, regular)
