"""The port's prediction paths against the JAX package's (CPU).

One module fixture trains a tiny entropic run with the port's worker at
32 px (``tests/test_torch_worker_host.py``'s config) and writes a small
image tree with PIL; the JAX package reads the same ``.pth`` through
``load_weights_any_format``.  Then:

* **decode parity, bit-equal uint8**: ``serve.decode_to_input``,
  ``decode_many_to_input``, ``native.jpeg.decode_batch_mem`` and
  ``train.decode_serving_paths`` of both packages on JPEGs at 32x32 and
  300x200 (the resize runs), a PNG, a CMYK JPEG, a JPEG truncated inside
  the crop window, and bytes no decoder takes (both raise the same type);
* ``calibrate_threshold`` equal to the JAX value (both modes, with and
  without background), and the same ``ValueError`` without unknown rows;
* ``collect_paths`` equal to JAX's;
* ``OpenSetPredictor`` on image paths against JAX's: float32 scores and
  features within rtol 1e-4 / atol 1e-4 * max|ref|, classes and
  rejections equal away from near-ties; bfloat16 by the model test's
  rule (scores within 2e-2, a class flipped only at a near-tie: the
  jitted JAX forward rounds fused chains once where the port rounds each
  op); both modes, a threshold, a background column;
* the predictor's refusals: JAX's ``ValueError``, with JAX's message,
  for a SavedModel bundle, an unknown ``optimize``, ``int8`` without
  calibration and calibration without ``int8``; ``NotImplementedError``
  (its ROADMAP item) for ``mesh=`` and a ``.stablehlo`` bundle; the
  ``fold_bn`` and ``int8`` modes build and predict;
* ``predict_stream`` bitwise equal to per-chunk ``predict`` in input
  order (ragged last chunk), a bad file in chunk 3 yielding chunks 1-2
  and then raising, and an early close leaving no producer thread;
* the predict CLIs of both packages on one directory in float32 (paths,
  classes, scores within 1e-4, ``--features-output``,
  ``--threshold-at-fpr``), the header-only CSV, the argument errors, the
  ``--optimize`` flags and the flag that is not ported.
"""

import csv
import io
import threading

import jax
import numpy as np
import pytest
import torch

from openset_imagenet_tpu import inference as jinference
from openset_imagenet_tpu import serve as jserve
from openset_imagenet_tpu import train as jengine
from openset_imagenet_tpu.native import jpeg as jjpeg
from openset_imagenet_tpu.script import predict as jpredict
from openset_imagenet_tpu_torch import inference as pinference
from openset_imagenet_tpu_torch import serve as pserve
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.native import jpeg as pjpeg
from openset_imagenet_tpu_torch.script import predict as ppredict
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    one_torch_thread, tiny_cfg, write_protocol_csvs)

SIZE = 32


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def _save(arr, fmt, mode="RGB", quality=90):
    from PIL import Image

    buf = io.BytesIO()
    img = Image.fromarray(arr).convert(mode)
    img.save(buf, format=fmt, **({"quality": quality}
                                 if fmt == "JPEG" else {}))
    return buf.getvalue()


def _blobs():
    """name -> bytes: the decode cases."""
    rng = np.random.default_rng(3)
    big = _save(_image(rng, 200, 300), "JPEG")
    return {
        "jpeg32": _save(_image(rng, 32, 32), "JPEG"),
        "jpeg300x200": big,
        "png": _save(_image(rng, 40, 48), "PNG"),
        "cmyk": _save(_image(rng, 64, 80), "JPEG", mode="CMYK"),
        "truncated": big[:int(len(big) * 0.45)],
        "garbage": b"\x00 not an image at all" * 8,
    }


def _outcome(fn):
    """``("ok", value)`` or ``("raised", exception type)``."""
    try:
        return "ok", fn()
    except Exception as exc:  # the type is what the test compares
        return "raised", type(exc)


def _same(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "ok":
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(want[1]))
    else:
        assert got[1] is want[1], (got, want)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port-trained tiny entropic ``_best`` and an image tree: 11 images
    of several sizes and formats in two directories."""
    root = tmp_path_factory.mktemp("predict")
    write_protocol_csvs(root)
    cfg = tiny_cfg(root, "entropic", epochs=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine.worker(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    rng = np.random.default_rng(11)
    tree = root / "images"
    for i in range(11):
        sub = tree / ("a" if i < 6 else "b")
        sub.mkdir(parents=True, exist_ok=True)
        h, w = [(32, 32), (48, 40), (60, 90)][i % 3]
        fmt, suffix = ("PNG", "png") if i % 4 == 3 else ("JPEG", "jpg")
        (sub / f"im{i:02d}.{suffix}").write_bytes(
            _save(_image(rng, h, w), fmt))
    return cfg.output_directory / "entropic_best.pth", tree


def _paths(tree):
    return ppredict.collect_paths([str(tree)], tree)


# -- decode parity ------------------------------------------------------------

@pytest.mark.parametrize("size", [SIZE, 224])
@pytest.mark.parametrize("name", sorted(_blobs()))
def test_decode_to_input_matches_jax(name, size):
    blob = _blobs()[name]
    _same(_outcome(lambda: pserve.decode_to_input(blob, size)),
          _outcome(lambda: jserve.decode_to_input(blob, size)))


def test_decode_many_and_batch_mem_match_jax():
    blobs = _blobs()
    good = [b for k, b in sorted(blobs.items())
            if k not in ("garbage", "truncated")]
    for size in (SIZE, 224):
        got = pserve.decode_many_to_input(good, size)
        want = jserve.decode_many_to_input(good, size)
        assert len(got) == len(want) == len(good)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == (size, size, 3)
            np.testing.assert_array_equal(g, w)
        resize = engine._resize_for_crop(size)
        images, ok = pjpeg.decode_batch_mem(good, resize, size)
        jimages, jok = jjpeg.decode_batch_mem(good, resize, size)
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(images[ok], jimages[jok])
        assert not ok.all() and ok.any()  # PNG and CMYK: PIL
    for name in ("garbage", "truncated"):
        bad = good + [blobs[name]]
        _same(_outcome(lambda: pserve.decode_many_to_input(bad, SIZE)),
              _outcome(lambda: jserve.decode_many_to_input(bad, SIZE)))
        with pytest.raises(ValueError, match="undecodable"):
            pserve.decode_many_to_input(bad, SIZE)


def test_decode_serving_paths_matches_jax(tmp_path):
    paths = []
    for name, blob in sorted(_blobs().items()):
        paths.append(tmp_path / f"{name}.img")
        paths[-1].write_bytes(blob)
    readable = [str(p) for p in paths
                if p.stem not in ("garbage", "truncated")]
    got, reader = engine.decode_serving_paths(readable, SIZE)
    want, _ = jengine.decode_serving_paths(readable, SIZE)
    assert got.dtype == np.uint8 and got.shape == (len(readable), SIZE,
                                                   SIZE, 3)
    np.testing.assert_array_equal(got, want)
    # The reader comes back for reuse, and decodes the same again.
    again, same = engine.decode_serving_paths(readable, SIZE, reader=reader)
    assert same is reader
    np.testing.assert_array_equal(again, got)
    for name in ("garbage", "truncated"):
        one = [str(tmp_path / f"{name}.img")]
        _same(_outcome(lambda: engine.decode_serving_paths(one, SIZE)[0]),
              _outcome(lambda: jengine.decode_serving_paths(one, SIZE)[0]))
    empty, _ = engine.decode_serving_paths([], SIZE)
    assert empty.shape == (0, SIZE, SIZE, 3) and empty.dtype == np.uint8


# -- calibrate_threshold and collect_paths --------------------------------------

def test_calibrate_threshold_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    n, c = 40, 4
    gt = rng.integers(-2, c - 1, n)
    scores = rng.dirichlet(np.ones(c), n).astype(np.float32)
    features = rng.normal(size=(n, 6)).astype(np.float32)
    path = tmp_path / "arr.npz"
    np.savez(path, gt=gt, logits=scores, features=features, scores=scores)
    for mode in ("softmax", "objectosphere"):
        for background in (False, True):
            for fpr in (0.0, 0.1, 0.5, 1.0):
                got = pinference.calibrate_threshold(path, fpr, mode,
                                                     background)
                want = jinference.calibrate_threshold(path, fpr, mode,
                                                      background)
                assert got == want, (mode, background, fpr)
                assert ppredict.calibrate_threshold(
                    path, fpr, mode, background) == want
    known = tmp_path / "known.npz"
    kn = gt >= 0
    np.savez(known, gt=gt[kn], logits=scores[kn], features=features[kn],
             scores=scores[kn])
    for impl in (pinference.calibrate_threshold,
                 jinference.calibrate_threshold):
        with pytest.raises(ValueError, match="no negative/unknown"):
            impl(known, 0.1, "softmax", False)


def test_collect_paths_matches_jax(trained, tmp_path):
    _, tree = trained
    assert _paths(tree) == jpredict.collect_paths([str(tree)], tree)
    comma = tmp_path / "beach, day.jpg"
    comma.write_bytes(_blobs()["jpeg32"])
    listing = tmp_path / "listing.csv"
    with open(listing, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["path", "prediction", "score"])
        w.writerow([comma.name, 0, "0.5"])
        w.writerow(["images/a/im00.jpg", 1, "0.25"])
    (tmp_path / "images").symlink_to(tree)
    specs = [str(listing), str(comma), "images/b"]
    got = ppredict.collect_paths(specs, tmp_path)
    assert got == jpredict.collect_paths(specs, tmp_path)
    assert got[0] == str(comma) and len(got) == 2 + 1 + 5
    missing = tmp_path / "missing.csv"
    missing.write_text("no/such/image.png,0\n")
    for impl in (ppredict.collect_paths, jpredict.collect_paths):
        with pytest.raises(FileNotFoundError, match="no such image"):
            impl([str(missing)], tmp_path)
        with pytest.raises(FileNotFoundError, match="no such image"):
            impl(["nowhere"], tmp_path)


# -- the predictor on paths -----------------------------------------------------

def _float32(mp):
    """Both packages' models in float32 (the model builders patched as
    ``tests/test_torch_evaluate.py`` does)."""
    jax_build, port_build = jengine.build_model, engine.build_model
    mp.setattr(jengine, "build_model", lambda cfg, n: jax_build(
        cfg, n).clone(dtype=jax.numpy.float32))
    mp.setattr(pinference, "build_model", lambda cfg, n, **kw: port_build(
        cfg, n, dtype=torch.float32, **kw))


def _predictors(ckpt, **kw):
    return (pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu",
                                        **kw),
            jinference.OpenSetPredictor(ckpt, variant="tiny",
                                        image_size=SIZE, **kw))


def _flips_only_at_near_ties(got, want, scores, tie):
    top2 = np.sort(scores, axis=-1)[:, -2:]
    for i in np.nonzero(got != want)[0]:
        assert top2[i, 1] - top2[i, 0] < tie, (i, top2[i])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_on_paths_matches_jax(trained, monkeypatch, dtype):
    ckpt, tree = trained
    if dtype == "float32":
        _float32(monkeypatch)
    ours, ref = _predictors(ckpt)
    assert ours.n_classes == ref.n_classes == 3
    assert (ours.threshold, ours.mode, ours.has_background, ours.meta) == \
        (0.0, "softmax", False, {})
    paths = _paths(tree)
    for mode, background in (("softmax", False), ("objectosphere", False),
                             ("softmax", True)):
        for p in (ours, ref):
            p.mode, p.has_background, p.threshold = mode, background, 0.0
        c_got, m_got, f_got, s_got = ours.predict(paths, return_arrays=True)
        c_ref, m_ref, f_ref, s_ref = ref.predict(paths, return_arrays=True)
        assert c_got.shape == (len(paths),) and s_got.shape == (len(paths), 3)
        if dtype == "float32":
            np.testing.assert_allclose(s_got, s_ref, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(f_got, f_ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(f_ref).max())
            np.testing.assert_allclose(m_got, m_ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(m_ref).max())
            tie = 1e-4
        else:
            np.testing.assert_allclose(s_got, s_ref, rtol=0, atol=2e-2)
            tie = 2e-2
        region = s_ref[:, :-1] if background else s_ref
        _flips_only_at_near_ties(c_got, c_ref, region, tie)
        # A threshold between two measures rejects the lower ones.
        cut = float(np.sort(m_ref)[3:5].mean())
        for p in (ours, ref):
            p.threshold = cut
        c_got, m_got = ours.predict(paths)
        c_ref, m_ref = ref.predict(paths)
        np.testing.assert_array_equal(c_got == -1, m_got < cut)
        near = np.abs(m_ref - cut) < (1e-4 if dtype == "float32"
                                      else 2e-2) * np.abs(m_ref).max()
        np.testing.assert_array_equal((c_got == -1)[~near],
                                      (c_ref == -1)[~near])


def test_predictor_reader_is_kept_and_arrays_still_work(trained):
    ckpt, tree = trained
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu")
    paths = _paths(tree)
    first = pred.predict(paths[:3])
    reader = pred._reader
    assert reader is not None
    again = pred.predict(paths[:3])
    assert pred._reader is reader
    for g, w in zip(first, again):
        np.testing.assert_array_equal(g, w)
    pixels, _ = engine.decode_serving_paths(paths[:3], SIZE)
    for g, w in zip(pred.predict(pixels), first):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="uint8"):
        pred.predict(pixels.astype(np.float32))


@pytest.mark.parametrize("n", [4, 3])
def test_predictor_reads_a_read_only_array(trained, n):
    """Staging pads into a buffer of its own: a caller's read-only array,
    at its bucket's size or under it, is read and never written."""
    ckpt, tree = trained
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu")
    pixels, _ = engine.decode_serving_paths(_paths(tree)[:n], SIZE)
    frozen = pixels.copy()
    frozen.flags.writeable = False
    for g, w in zip(pred.predict(frozen), pred.predict(pixels)):
        np.testing.assert_array_equal(g, w)


_CALIBRATION = np.zeros((1, SIZE, SIZE, 3), np.uint8)


def _same_refusal(port, ref):
    """Both constructors raise ``ValueError`` with one message."""
    with pytest.raises(ValueError) as got:
        port()
    with pytest.raises(ValueError) as want:
        ref()
    assert str(got.value) == str(want.value)
    return str(got.value)


# ``ValueError``: the JAX predictor's argument errors, with its messages
# (JAX ``inference.py:135-147``); ``item N``: valid there, not ported
# here; ``"ported"``: the optimized serving modes, which build and predict
# (held against the JAX predictor in tests/test_torch_optimize.py).
@pytest.mark.parametrize("kw,item", [
    ({"optimize": "fold"}, None), ({"optimize": "int8"}, None),
    ({"calibration": _CALIBRATION}, None),
    ({"calibration_percentile": 99.9}, None),
    ({"optimize": "fold_bn", "calibration_percentile": 99.9}, None),
    ({"optimize": "fold_bn"}, "ported"),
    ({"optimize": "int8", "calibration": _CALIBRATION}, "ported"),
    ({"optimize": "int8", "calibration": _CALIBRATION,
      "calibration_percentile": 99.9}, "ported"),
    ({"mesh": object()}, 8)])
def test_predictor_unported_arguments(trained, kw, item):
    ckpt, _ = trained
    port = lambda: pinference.OpenSetPredictor(ckpt, image_size=SIZE,
                                               device="cpu", **kw)
    if item is None:
        _same_refusal(port, lambda: jinference.OpenSetPredictor(
            ckpt, variant="tiny", image_size=SIZE, **kw))
    elif item == "ported":
        pred = port()
        assert pred.model.folded
        assert pred.model.quantized == (kw["optimize"] == "int8")
        classes, scores = pred.predict(np.zeros((3, SIZE, SIZE, 3),
                                                np.uint8))
        assert classes.shape == scores.shape == (3,)
        assert np.isfinite(scores).all()
    else:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            port()


# A SavedModel bundle is refused as the JAX predictor refuses it (JAX
# ``inference.py:128-134``); a ``.stablehlo`` bundle is not ported yet,
# and refused with ``optimize=`` as JAX refuses it.
@pytest.mark.parametrize("path,kw,match", [
    ("bundle", {}, "TF SavedModel"),
    ("bundle", {"optimize": "fold"}, "TF SavedModel"),
    ("m.stablehlo", {}, "item 7"),
    ("m.stablehlo", {"optimize": "fold_bn"}, "needs a checkpoint")])
def test_predictor_unported_artifacts(tmp_path, path, kw, match):
    (tmp_path / "bundle").mkdir()
    (tmp_path / "bundle" / "saved_model.pb").write_bytes(b"")
    port = lambda: pinference.OpenSetPredictor(tmp_path / path,
                                               device="cpu", **kw)
    if match.startswith("item"):
        with pytest.raises(NotImplementedError, match=match):
            port()
    else:
        assert match in _same_refusal(port, lambda: (
            jinference.OpenSetPredictor(tmp_path / path, **kw)))


# -- predict_stream -------------------------------------------------------------

def test_predict_stream_is_bitwise_per_chunk_predict(trained):
    ckpt, tree = trained
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu",
                                       threshold=0.4)
    paths = _paths(tree)  # 11 paths: chunks of 4, 4 and a ragged 3
    got = list(pred.predict_stream(paths, batch_size=4, return_arrays=True))
    assert [g[0] for g in got] == [paths[i:i + 4] for i in (0, 4, 8)]
    for i, (chunk, *results) in enumerate(got):
        want = pred.predict(chunk, return_arrays=True)
        for g, w in zip(results, want):
            np.testing.assert_array_equal(g, w)
        assert len(results[0]) == (3 if i == 2 else 4)
    assert list(pred.predict_stream([], batch_size=4)) == []


def test_predict_stream_yields_good_chunks_then_raises(trained, tmp_path):
    ckpt, tree = trained
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\x00 not an image at all" * 8)
    paths = _paths(tree)[:8] + [str(bad)] + _paths(tree)[8:]
    got = []
    with pytest.raises(OSError):
        for item in pred.predict_stream(paths, batch_size=4):
            got.append(item)
    assert [g[0] for g in got] == [paths[0:4], paths[4:8]]
    for chunk, cls, score in got:
        want_cls, want_score = pred.predict(chunk)
        np.testing.assert_array_equal(cls, want_cls)
        np.testing.assert_array_equal(score, want_score)


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "osi-predict-decode" and t.is_alive()]


def test_predict_stream_close_stops_the_producer(trained):
    ckpt, tree = trained
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu")
    paths = _paths(tree) * 4
    stream = pred.predict_stream(paths, batch_size=2, prefetch=1)
    next(stream)
    assert _producers()
    stream.close()
    assert not _producers()


# -- the predict CLI ------------------------------------------------------------

def _cli(ckpt, tree, out, *extra):
    return [str(ckpt), "3", str(tree), "--image-size", str(SIZE),
            "--batch-size", "4", "-o", str(out), "--no-compile-cache",
            *extra]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _run_both(ckpt, tree, tmp_path, name, *extra):
    ours, ref = tmp_path / f"{name}.csv", tmp_path / f"{name}_jax.csv"
    assert ppredict.main(_cli(ckpt, tree, ours, "--device", "cpu",
                              *extra)) == 0
    assert jpredict.main(_cli(ckpt, tree, ref, "--model-variant", "tiny",
                              *extra)) == 0
    return _rows(ours), _rows(ref)


def test_predict_cli_matches_jax(trained, tmp_path, monkeypatch):
    ckpt, tree = trained
    _float32(monkeypatch)
    npz = tmp_path / "features.npz"
    got, want = _run_both(ckpt, tree, tmp_path, "pred",
                          "--features-output", str(npz))
    jnpz = tmp_path / "features_jax.npz"
    jpredict.main(_cli(ckpt, tree, tmp_path / "again.csv", "--model-variant",
                       "tiny", "--features-output", str(jnpz)))
    assert got[0] == want[0] == ["path", "prediction", "score"]
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == 1 + 11
    np.testing.assert_allclose([float(r[2]) for r in got[1:]],
                               [float(r[2]) for r in want[1:]], atol=1e-4)
    scores = np.load(jnpz)["scores"]
    _flips_only_at_near_ties(np.array([int(r[1]) for r in got[1:]]),
                             np.array([int(r[1]) for r in want[1:]]),
                             scores, 1e-4)
    ours, ref = np.load(npz), np.load(jnpz)
    assert sorted(ours.files) == sorted(ref.files) == [
        "features", "paths", "scores"]
    for key in ours.files:
        assert ours[key].shape == ref[key].shape, key
    np.testing.assert_array_equal(ours["paths"], ref["paths"])
    np.testing.assert_allclose(ours["scores"], ref["scores"], atol=1e-4)

    # --no-stream writes the same bytes as the default stream.
    serial = tmp_path / "serial.csv"
    ppredict.main(_cli(ckpt, tree, serial, "--device", "cpu", "--no-stream"))
    assert serial.read_text() == (tmp_path / "pred.csv").read_text()


def test_predict_cli_threshold_at_fpr_matches_jax(trained, tmp_path,
                                                   monkeypatch):
    ckpt, tree = trained
    _float32(monkeypatch)
    rng = np.random.default_rng(17)
    gt = np.array([0, 1, 2, -1, -1, -1, -2, -1])
    scores = rng.dirichlet(np.ones(3), len(gt)).astype(np.float32)
    arr = tmp_path / "entropic_val_arr.npz"
    np.savez(arr, gt=gt, logits=scores, scores=scores,
             features=rng.normal(size=(len(gt), 3)).astype(np.float32))
    for fpr in ("0.0", "0.5", "1.0"):
        got, want = _run_both(ckpt, tree, tmp_path, f"fpr{fpr}",
                              "--threshold-at-fpr", fpr, "--calibrate",
                              str(arr))
        threshold = ppredict.calibrate_threshold(arr, float(fpr), "softmax",
                                                 False)
        assert threshold == jpredict.calibrate_threshold(
            arr, float(fpr), "softmax", False)
        for row in got[1:]:
            assert (int(row[1]) == -1) == (float(row[2]) < threshold), row
        near = [abs(float(r[2]) - threshold) < 1e-4 for r in want[1:]]
        assert [int(r[1]) == -1 for r, n in zip(got[1:], near) if not n] == \
            [int(r[1]) == -1 for r, n in zip(want[1:], near) if not n]
    assert all(int(r[1]) == -1 for r in _rows(tmp_path / "fpr0.0.csv")[1:])


def test_predict_cli_empty_match_writes_the_header(trained, tmp_path):
    ckpt, _ = trained
    empty = tmp_path / "empty"
    empty.mkdir()
    out = tmp_path / "none.csv"
    assert ppredict.main(_cli(ckpt, empty, out, "--device", "cpu")) == 0
    assert out.read_text() == "path,prediction,score\n"


@pytest.mark.parametrize("extra", [
    ["--threshold-at-fpr", "0.1"],
    ["--threshold-at-fpr", "0.1", "--calibrate", "a.npz", "-t", "0.5"],
    ["--calibrate", "a.npz"],
    ["-g", "0", "--devices", "2"],
    ["--compile-cache", "d", "--no-compile-cache"],
    ["--calibration-images", "x/"],
    ["--calibration-percentile", "99.9"],
])
def test_predict_cli_argument_errors_match_jax(extra):
    argv = ["c.pth", "3", "x", *extra]
    for get_args in (ppredict.get_args, jpredict.get_args):
        with pytest.raises(SystemExit):
            get_args(argv)


@pytest.mark.parametrize("extra,item", [
    (["--optimize", "fold_bn"], None), (["--optimize", "int8"], None),
    (["--optimize", "int8", "--calibration-images", "a"], None),
    (["--optimize", "int8", "--calibration-percentile", "99.9"], None),
    (["--devices", "2"], 8)])
def test_predict_cli_unported_flags(trained, tmp_path, extra, item):
    """``--devices`` raises its ROADMAP item; the ``--optimize`` flags are
    ported: every image gets a row (the classes against JAX's CLI in
    tests/test_torch_optimize.py).  ``a`` is a subdirectory of the tree,
    named relative to ``--imagenet-directory``."""
    ckpt, tree = trained
    argv = _cli(ckpt, tree, tmp_path / "x.csv", "--device", "cpu",
                "--imagenet-directory", str(tree), *extra)
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            ppredict.main(argv)
        return
    assert ppredict.main(argv) == 0
    rows = _rows(tmp_path / "x.csv")
    assert rows[0] == ["path", "prediction", "score"] and len(rows) == 12
    assert [r[0] for r in rows[1:]] == _paths(tree)


def test_predict_cli_port_flags(trained, tmp_path, capsys):
    """``--reader synthetic`` reads seeded noise per path (no decode),
    ``--no-compile-cache`` is logged as having no effect, and the default
    device is the card."""
    from openset_imagenet_tpu_torch.pipeline import SyntheticReader

    ckpt, tree = trained
    out = tmp_path / "synthetic.csv"
    assert ppredict.main(_cli(ckpt, tree, out, "--device", "cpu", "--reader",
                              "synthetic")) == 0
    assert "no effect" in capsys.readouterr().err
    paths = _paths(tree)
    reader = SyntheticReader(crop=SIZE, seed=0)
    pred = pinference.OpenSetPredictor(ckpt, image_size=SIZE, device="cpu")
    cls, score = pred.predict(np.stack([reader(p, None) for p in paths[:4]]))
    rows = _rows(out)[1:5]
    assert [int(r[1]) for r in rows] == list(cls)
    assert [r[2] for r in rows] == [f"{s:.6f}" for s in score]
    args = ppredict.get_args(["c.pth", "auto", "x"])
    assert (args.device, args.reader, args.n_classes) == ("cuda", "auto",
                                                          None)
    assert ppredict.device_of(ppredict.get_args(["c", "3", "x", "-g"])) == \
        "cuda:0"
