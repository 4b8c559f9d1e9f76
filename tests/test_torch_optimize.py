"""The port's inference optimizations against the JAX package's (CPU).

The cases of the JAX package's ``tests/test_optimize.py``, each held
against the JAX function on the same weights (``tests/test_optimize.py``'s
``_trained_variables``: jittered parameters and one train-mode forward,
so the running statistics are not trivial), carried into the port by
``convert``:

* ``fold_batchnorm`` trees bit-equal (basic, bottleneck, grouped, the
  space-to-depth stem, ghost batch-norm), and ``fold_inference`` loads
  them; the folded forward bit-equal in bfloat16 (the bias is added after
  the rounded conv, as flax adds it) and within rtol 1e-4 in float32
  (another summation order in the convs);
* the error paths with the JAX messages: missing statistics, an unpaired
  norm slot, a folded model in training, ``quantized`` without
  ``folded``, folded with ``fused_blocks`` or ``dot_1x1``, no calibration
  record, an unfolded tree, a percentile out of range, an empty or
  mis-sized calibration;
* ``calibrate_amax``: abs-max and percentiles (99.9, 50, 100) bit-equal
  in bfloat16; in float32 within rtol 1e-5 (the float32 convs of the two
  packages sum in another order, and four blocks down a median of small
  magnitudes moves by up to 1.5e-6 relative); the max over batches;
* ``quantize_params`` trees bit-equal, int8 kernels; the quantized
  forward bit-equal in bfloat16 and within rtol 1e-5 in float32;
* the predictors with ``optimize="fold_bn"`` / ``"int8"`` (abs-max and a
  percentile) against JAX's on a port-trained tiny run: the folded and
  quantized weights bit-equal to the JAX predictor's, classes by the JAX
  tests' rule (``_agree_with_tie_slack``: the JAX predictor's forward is
  jitted, which rounds fused chains once); the predict CLIs with
  ``--optimize fold_bn|int8``; the daemon on an int8 predictor;
* the calibration pixel cache: decoded once for calibration and
  prediction, evicted as served, and -- the repair of the JAX
  predictor's leak -- evicted on a chunk that only partly hits it too,
  where the JAX predictor keeps the entries;
* the grouped-conv warning.
"""

import csv
import json
import logging
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu import inference as jinference
from openset_imagenet_tpu import optimize as jopt
from openset_imagenet_tpu.models.resnet import build_resnet as jbuild
from openset_imagenet_tpu.script import predict as jpredict
from openset_imagenet_tpu_torch import convert
from openset_imagenet_tpu_torch import inference as pinference
from openset_imagenet_tpu_torch import optimize as popt
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.models.resnet import ResNet50, build_resnet
from openset_imagenet_tpu_torch.script import predict as ppredict
from openset_imagenet_tpu_torch.serve import PredictionServer
from tests.test_optimize import _agree_with_tie_slack, _trained_variables
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    one_torch_thread, tiny_cfg, write_protocol_csvs)

SIZE = 32
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _pair(variant, dtype="bfloat16", key=0, **kw):
    """A JAX model with trained-looking variables and the port's model
    carrying the same weights; the images of the train-mode forward."""
    jdt, tdt = DTYPES[dtype]
    jmodel = jbuild(variant, fc_layer_dim=3, out_features=3, dtype=jdt, **kw)
    variables, x = _trained_variables(jmodel, key=key)
    variables = jax.device_get(variables)
    model = build_resnet(variant, fc_layer_dim=3, out_features=3, dtype=tdt,
                         device="cpu", **kw)
    convert.load_into(model, convert.variables_to_state_dict(variables))
    return jmodel, variables, model, np.array(x)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _same_tree(got, want):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def _forward(model, x):
    with torch.inference_mode():
        return [t.numpy() for t in model(torch.from_numpy(np.array(x)))]


def _close_or_equal(got, want, dtype, rtol):
    for g, w in zip(got, want):
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       atol=rtol * np.abs(w).max())


# -- folding -------------------------------------------------------------------

@pytest.mark.parametrize("variant,kwargs", [
    ("tiny", {}), ("tiny50", {}), ("tinyx", {}),
    ("tiny50", {"space_to_depth": True}), ("tiny50", {"bn_stats_rows": 4})])
def test_fold_batchnorm_matches_jax(variant, kwargs):
    _, variables, model, _ = _pair(variant, "float32", key=5, **kwargs)
    want = jax.device_get(jopt.fold_batchnorm(variables["params"],
                                              variables["batch_stats"]))
    ours = convert.state_dict_to_variables(model.state_dict())
    got = popt.fold_batchnorm(ours["params"], ours["batch_stats"])
    _same_tree(got, want)
    folded = popt.fold_inference(model)
    assert folded.folded and not folded.training
    state = {k: v.numpy() for k, v in folded.state_dict().items()}
    ref = convert.variables_to_state_dict({"params": want})
    assert set(state) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(state[key], value, err_msg=key)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["tiny", "tiny50", "tinyx"])
def test_folded_forward_matches_jax(variant, dtype):
    jmodel, variables, model, x = _pair(variant, dtype, key=3)
    fparams = jopt.fold_batchnorm(variables["params"],
                                  variables["batch_stats"])
    want = [np.asarray(a) for a in jopt.fold_model(jmodel).apply(
        {"params": fparams, "batch_stats": {}}, x, train=False)]
    _close_or_equal(_forward(popt.fold_inference(model), x), want, dtype,
                    1e-4)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_fold_and_model_error_paths_match_jax():
    jmodel, variables, model, _ = _pair("tiny50", "float32", key=7)
    ours = convert.state_dict_to_variables(model.state_dict())
    assert _message(lambda: popt.fold_batchnorm(ours["params"], {})) == \
        _message(lambda: jopt.fold_batchnorm(variables["params"], {}))
    jparams, pparams = dict(variables["params"]), dict(ours["params"])
    jparams.pop("conv_init")
    pparams.pop("conv_init")
    stats = ours["batch_stats"]
    assert _message(lambda: popt.fold_batchnorm(pparams, stats)) == \
        _message(lambda: jopt.fold_batchnorm(jparams, stats))

    zeros = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    folded = popt.fold_inference(model)
    msg = _message(lambda: folded.train()(torch.zeros(1, SIZE, SIZE, 3)))
    assert msg == _message(lambda: jopt.fold_model(jmodel).init(
        jax.random.PRNGKey(0), zeros, train=True))
    for kw in ({"quantized": True},
               {"folded": True, "fused_blocks": True},
               {"folded": True, "boundary_mask": True},
               {"folded": True, "dot_1x1": True}):
        jm = jbuild("tiny50", fc_layer_dim=3, out_features=3).clone(**kw)
        assert _message(lambda: build_resnet(
            "tiny50", fc_layer_dim=3, out_features=3, device="meta",
            **kw)) == _message(lambda: jm.init(jax.random.PRNGKey(0), zeros,
                                               train=False)), kw


# -- calibration and quantization ---------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["tiny50", "tinyx"])
def test_calibrate_amax_matches_jax(variant, dtype):
    jmodel, variables, model, x = _pair(variant, dtype, key=17)
    fparams = jopt.fold_batchnorm(variables["params"],
                                  variables["batch_stats"])
    fmodel = jopt.fold_model(jmodel)
    folded = popt.fold_inference(model)
    batches = [0.01 * x, x]
    for pct in (None, 99.9, 50.0, 100.0):
        want = jopt.calibrate_amax(fmodel, fparams, batches, percentile=pct)
        got = popt.calibrate_amax(folded, batches, percentile=pct)
        assert set(got) == set(want) and len(got) == 16  # 4 blocks x 4
        for key in want:
            if dtype == "bfloat16":
                assert got[key] == want[key], (pct, key)
            else:
                assert got[key] == pytest.approx(want[key], rel=1e-5)
    # The max over batches, not the last batch.
    small = popt.calibrate_amax(folded, [0.01 * x])
    only = popt.calibrate_amax(folded, [x])
    both = popt.calibrate_amax(folded, batches)
    for key in both:
        assert both[key] == only[key] and small[key] <= both[key]
    for pct in (0.0, 101.0):
        assert _message(lambda: popt.calibrate_amax(folded, [x], pct)) == \
            _message(lambda: jopt.calibrate_amax(fmodel, fparams, [x], pct))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant,kwargs", [
    ("tiny", {}), ("tiny50", {}), ("tinyx", {}),
    ("tiny50", {"space_to_depth": True})])
def test_quantized_model_matches_jax(variant, kwargs, dtype):
    jmodel, variables, model, x = _pair(variant, dtype, key=11, **kwargs)
    fparams = jopt.fold_batchnorm(variables["params"],
                                  variables["batch_stats"])
    amax = jopt.calibrate_amax(jopt.fold_model(jmodel), fparams, [x])
    want = jax.device_get(jopt.quantize_params(fparams, amax))
    ours = convert.state_dict_to_variables(model.state_dict())
    got = popt.quantize_params(popt.fold_batchnorm(
        ours["params"], ours["batch_stats"]), amax)
    _same_tree(got, want)
    qmodel = popt._load(popt.quantize_model(model), got)
    assert qmodel.quantized and qmodel.folded
    ref = [np.asarray(a) for a in jopt.quantize_model(jmodel).apply(
        {"params": want, "batch_stats": {}}, x, train=False)]
    _close_or_equal(_forward(qmodel, x), ref, dtype, 1e-5)
    # The whole chain: fold, calibrate on the images, quantize.
    chained = popt.quantize_inference(model, [x])
    if dtype == "bfloat16":
        _close_or_equal(_forward(chained, x), ref, dtype, 0)


def test_quantize_error_paths_match_jax():
    jmodel, variables, model, x = _pair("tiny50", "float32", key=19)
    fparams = jax.device_get(jopt.fold_batchnorm(variables["params"],
                                                 variables["batch_stats"]))
    assert _message(lambda: popt.quantize_params(fparams, {})) == \
        _message(lambda: jopt.quantize_params(fparams, {}))
    amax = popt.calibrate_amax(popt.fold_inference(model), [x])
    unfolded = convert.state_dict_to_variables(model.state_dict())["params"]
    assert _message(lambda: popt.quantize_params(unfolded, amax)) == \
        _message(lambda: jopt.quantize_params(variables["params"], amax))
    for images in (np.zeros((0, SIZE, SIZE, 3), np.uint8),
                   np.zeros((2, 16, 16, 3), np.uint8)):
        assert _message(lambda: popt.optimized_inference(
            model, "int8", calibration=images, image_size=SIZE)) == \
            _message(lambda: jopt.optimized_inference(
                jmodel, None, "int8", calibration=images, image_size=SIZE))
    for mode, calibration in (("int4", None), ("int8", None)):
        assert _message(lambda: popt.optimized_inference(
            model, mode, calibration)) == _message(
            lambda: jopt.optimized_inference(jmodel, None, mode,
                                             calibration))


def test_grouped_int8_warns():
    _, _, model, x = _pair("tinyx", "float32", key=29)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("openset_imagenet_tpu_torch")
    log.addHandler(handler)
    try:
        qmodel = popt.optimized_inference(
            model, "int8", calibration=(x * 255).astype(np.uint8),
            image_size=SIZE)
    finally:
        log.removeHandler(handler)
    assert qmodel.quantized
    assert any("grouped" in r.getMessage() for r in records)


def test_calibration_chunks_like_jax(monkeypatch):
    """Chunks of 64 with the final 64 images as the last chunk."""
    seen = []
    monkeypatch.setattr(popt, "quantize_inference",
                        lambda model, chunks, percentile: seen.append(
                            [c[:, 0, 0, 0].tolist() for c in chunks]))
    images = np.zeros((150, SIZE, SIZE, 3), np.uint8)
    images[:, 0, 0, 0] = np.arange(150)
    model = ResNet50(fc_layer_dim=3, out_features=3, width=8,
                     stage_sizes=(1, 1, 1, 1), device="cpu")
    popt.optimized_inference(model, "int8", calibration=images,
                             image_size=SIZE)
    assert [len(c) for c in seen[0]] == [64, 64, 64]
    assert seen[0][2] == list(range(86, 150))


# -- the predictor, the CLIs, the daemon --------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port-trained tiny entropic ``_best`` and six JPEGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("optimize")
    write_protocol_csvs(root)
    cfg = tiny_cfg(root, "entropic", epochs=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine.worker(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    tree = root / "images"
    tree.mkdir()
    rng = np.random.default_rng(3)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8)
                        ).save(tree / f"im{i}.jpg")
    return cfg.output_directory / "entropic_best.pth", tree


def _predictors(ckpt, **kw):
    return (pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu",
                                        **kw),
            jinference.OpenSetPredictor(ckpt, variant="tiny",
                                        image_size=SIZE, **kw))


_IMAGES = np.random.default_rng(2).integers(0, 256, (8, SIZE, SIZE, 3),
                                            np.uint8)


@pytest.mark.parametrize("kw,flips", [
    ({"optimize": "fold_bn"}, 1),
    ({"optimize": "int8", "calibration": _IMAGES}, 2),
    ({"optimize": "int8", "calibration": _IMAGES,
      "calibration_percentile": 99.9}, 2)])
def test_predictor_optimized_matches_jax(trained, kw, flips):
    ckpt, _ = trained
    ours, ref = _predictors(ckpt, **kw)
    params = jax.device_get(ref._state.params)
    state = {k: v.numpy() for k, v in ours.model.state_dict().items()}
    if kw["optimize"] == "fold_bn":
        # The folded weights are JAX's, bit for bit.
        for key, value in convert.variables_to_state_dict(
                {"params": params}).items():
            np.testing.assert_array_equal(state[key], value, err_msg=key)
    else:
        # JAX calibrates through a jitted forward, which rounds fused
        # chains once: the scales agree to float32 rounding.
        assert ours.model.quantized
        for key, value in convert.variables_to_state_dict(
                {"params": params}).items():
            if key.endswith("scale"):
                np.testing.assert_allclose(state[key], value, rtol=1e-5)
    c1, s1 = ours.predict(_IMAGES)
    c0, s0 = ref.predict(_IMAGES)
    _agree_with_tie_slack(c0, s0, c1, s1, flips=flips)
    base = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu")
    cb, sb = base.predict(_IMAGES)
    _agree_with_tie_slack(cb, sb, c1, s1, flips=flips)


def _csv_classes(path):
    with open(path) as f:
        return {r["path"]: r["prediction"] for r in csv.DictReader(f)}


@pytest.mark.parametrize("extra", [
    ["--optimize", "fold_bn"], ["--optimize", "int8"],
    ["--optimize", "int8", "--calibration-images", "cal"]])
def test_predict_cli_optimize_matches_jax(trained, tmp_path, extra):
    ckpt, tree = trained
    base = [str(ckpt), "auto", str(tree), "--image-size", str(SIZE),
            "--imagenet-directory", str(tree.parent)]
    cal = tree.parent / "cal"
    if not cal.exists():
        cal.mkdir()
        for p in sorted(tree.glob("*.jpg"))[:3]:
            (cal / p.name).write_bytes(p.read_bytes())
    ours, ref, plain = (tmp_path / "ours.csv", tmp_path / "ref.csv",
                        tmp_path / "plain.csv")
    assert ppredict.main(base + ["-o", str(ours), "--device", "cpu",
                                 *extra]) == 0
    assert jpredict.main(base + ["-o", str(ref), "--model-variant", "tiny",
                                 "--no-compile-cache", *extra]) == 0
    assert ppredict.main(base + ["-o", str(plain), "--device", "cpu"]) == 0
    got, want, unopt = (_csv_classes(ours), _csv_classes(ref),
                        _csv_classes(plain))
    assert list(got) == list(want) and len(got) == 6
    assert sum(got[k] != want[k] for k in got) <= 1, (got, want)
    assert sum(got[k] != unopt[k] for k in got) <= 1, (got, unopt)


def test_int8_daemon_matches_predict(trained):
    ckpt, tree = trained
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu",
                                       optimize="int8", calibration=_IMAGES)
    server = PredictionServer(("127.0.0.1", 0), pred, max_batch=4,
                              window_ms=0.0).start()
    try:
        host, port = server.server_address[:2]
        body = sorted(tree.glob("*.jpg"))[0].read_bytes()
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/predict", data=body, method="POST",
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())
    finally:
        server.close()
    c, s = pred.predict([str(sorted(tree.glob("*.jpg"))[0])])
    assert got["prediction"] == int(c[0])
    assert abs(got["score"] - float(s[0])) <= 1e-6


def test_decoded_cache_decodes_once_and_evicts(trained, monkeypatch):
    """Path calibration keeps the decoded pixels until predicted: each
    file decodes once, and a chunk that only partly hits the cache evicts
    its cached paths as well (the JAX predictor keeps them: ADVICE's
    leak), so nothing outlives the first pass over its paths."""
    ckpt, tree = trained
    paths = sorted(str(p) for p in tree.glob("*.jpg"))
    decoded = []
    real = pinference.decode_serving_paths

    def counting(ps, image_size, reader=None):
        decoded.extend(ps)
        return real(ps, image_size, reader=reader)

    monkeypatch.setattr(pinference, "decode_serving_paths", counting)
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu",
                                       optimize="int8",
                                       calibration=paths[:4])
    assert decoded == paths[:4] and sorted(pred._decoded_cache) == paths[:4]
    pred.predict(paths[:2])  # whole-chunk hit: served from the cache
    assert decoded == paths[:4] and sorted(pred._decoded_cache) == \
        paths[2:4]
    c_mixed, s_mixed = pred.predict(paths[3:6])  # partial hit: decoded
    assert decoded == paths[:4] + paths[3:6]
    assert sorted(pred._decoded_cache) == [paths[2]]
    c_again, s_again = pred.predict(paths[3:6])
    np.testing.assert_array_equal(c_mixed, c_again)
    np.testing.assert_array_equal(s_mixed, s_again)

    # The JAX predictor on the same calls keeps the partly hit entry.
    ref = jinference.OpenSetPredictor(ckpt, variant="tiny", image_size=SIZE,
                                      optimize="int8", calibration=paths[:4])
    ref.predict(paths[:2])
    ref.predict(paths[3:6])
    assert sorted(ref._decoded_cache) == paths[2:4]
