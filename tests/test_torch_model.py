"""PyTorch port model and weight bridge against the JAX package (CPU).

* The bridge round trip fills every leaf and matches the JAX bridge.
* Parameter and batch-norm-statistic counts match for every variant, and
  the ``state_dict`` keys are the reference torch layout.
* Forward parity on shared weights at 32 px: float32 graphs within rtol
  1e-4 / atol 1e-4 * max|ref| (summation order only), bfloat16 graphs on
  argmax (a flip only at a near-tie) and softmax scores within atol 2e-2.
  Both batch-norm eval forms (``bn_stats_rows`` 0 and 8) are covered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu.convert import torch_state_dict_to_variables
from openset_imagenet_tpu.models.resnet import build_resnet as jax_build
from openset_imagenet_tpu_torch import convert
from openset_imagenet_tpu_torch.models.resnet import _VARIANTS
from openset_imagenet_tpu_torch.models.resnet import build_resnet
from tests.test_convert import fake_torch_dict, make_template
from torch_ref_model import TorchTwoHead


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_bridge_roundtrip_fills_every_leaf(prefix):
    _, template = make_template()
    tdict = fake_torch_dict(template, prefix=prefix)
    ref_vars = torch_state_dict_to_variables(tdict, template)
    ours = convert.state_dict_to_variables(tdict)
    ref_leaves = _leaves(ref_vars)
    assert len(_leaves(ours)) == len(ref_leaves)
    for (path, ref), (opath, got) in zip(ref_leaves, _leaves(ours)):
        assert path == opath
        np.testing.assert_array_equal(got, np.asarray(ref))
    back = convert.variables_to_state_dict(jax.device_get(ref_vars))
    stripped = convert.strip_module_prefix(tdict)
    assert set(back) == set(stripped)
    for key, value in stripped.items():
        np.testing.assert_array_equal(back[key], value)

    model = build_resnet("resnet50", fc_layer_dim=6, out_features=6,
                         device="meta").to_empty(device="cpu")
    convert.load_into(model, tdict)
    state = model.state_dict()
    assert set(state) == set(stripped)
    for key, value in stripped.items():
        np.testing.assert_array_equal(state[key].numpy(), value)


def test_bridge_missing_key_and_shape_mismatch_raise():
    _, template = make_template(variant="tiny50")
    tdict = fake_torch_dict(template)
    model = build_resnet("tiny50", fc_layer_dim=6, out_features=6)
    bad = dict(tdict)
    del bad["resnet_base.conv1.weight"]
    with pytest.raises(KeyError, match="conv1"):
        convert.load_into(model, bad)
    bad = dict(tdict)
    bad["resnet_base.fc.weight"] = np.zeros((7, 7), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.load_into(model, bad)
    with pytest.raises(KeyError, match="unmapped"):
        convert.state_dict_to_variables({"resnet_base.avgpool.x": tdict[
            "resnet_base.conv1.weight"]})


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_variant_counts_and_keys_match(variant):
    jmodel = jax_build(variant, fc_layer_dim=7, out_features=7)
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init(r, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    model = build_resnet(variant, fc_layer_dim=7, out_features=7,
                         device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for b in model.buffers())
    count = lambda tree: sum(int(np.prod(l.shape))
                             for l in jax.tree_util.tree_leaves(tree))
    assert n_params == count(shapes["params"])
    assert n_stats == count(shapes["batch_stats"])
    with torch.device("meta"):
        ref = TorchTwoHead(variant, fc_layer_dim=7, out_features=7)
    ref_shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        ref_shapes


def _random_variables(jmodel, seed):
    """JAX variables with every leaf random (BN statistics non-trivial)."""
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3), jnp.float32),
        train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _forward_pair(variant, bn_rows, dtype_name, seed=0, **model_kw):
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    jmodel = jax_build(variant, fc_layer_dim=10, out_features=10,
                       dtype=jdtype, bn_stats_rows=bn_rows, **model_kw)
    variables = _random_variables(jmodel, seed)
    images = np.random.default_rng(seed + 1).random(
        (6, 32, 32, 3)).astype(np.float32)
    ref = [np.asarray(a) for a in jmodel.apply(variables, images,
                                               train=False)]
    model = build_resnet(variant, fc_layer_dim=10, out_features=10,
                         dtype=tdtype, bn_stats_rows=bn_rows, **model_kw)
    convert.load_into(model, convert.variables_to_state_dict(variables))
    with torch.inference_mode():
        got = [t.numpy() for t in model(torch.from_numpy(images))]
    return got, ref


@pytest.mark.parametrize("bn_rows", [0, 8])
@pytest.mark.parametrize("variant", ["tiny", "tiny50", "tinyx"])
def test_float32_forward_matches_jax(variant, bn_rows):
    (logits, feats), (ref_logits, ref_feats) = _forward_pair(
        variant, bn_rows, "float32")
    assert logits.dtype == feats.dtype == np.float32
    for got, ref in ((logits, ref_logits), (feats, ref_feats)):
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_space_to_depth_stem_is_the_plain_stem():
    (logits, feats), (ref_logits, ref_feats) = _forward_pair(
        "tiny50", 0, "float32", seed=3, space_to_depth=True)
    for got, ref in ((logits, ref_logits), (feats, ref_feats)):
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("variant,bn_rows", [("tiny50", 0), ("tiny50", 8),
                                             ("tinyx", 0)])
def test_bfloat16_forward_matches_jax(variant, bn_rows):
    (logits, _), (ref_logits, _) = _forward_pair(variant, bn_rows,
                                                 "bfloat16", seed=5)
    scores, ref_scores = _softmax(logits), _softmax(ref_logits)
    # A class decision may flip only where the reference's top two scores
    # are a near-tie (tie-gap guard, as tests/test_optimize.py).
    top2 = np.sort(ref_scores, axis=-1)[:, -2:]
    flipped = np.nonzero(scores.argmax(-1) != ref_scores.argmax(-1))[0]
    for i in flipped:
        assert top2[i, 1] - top2[i, 0] < 2e-2, (i, top2[i])
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=2e-2)


@pytest.mark.parametrize("option,value", [
    ("remat", "elementwise"), ("folded", True), ("quantized", True)])
def test_deferred_options_raise(option, value):
    from openset_imagenet_tpu_torch.models.resnet import ResNet50

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ResNet50(fc_layer_dim=3, out_features=3, device="meta",
                 **{option: value})
