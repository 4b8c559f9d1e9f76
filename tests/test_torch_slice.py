"""The PyTorch port's serving slice against the JAX package (CPU).

* ``make_eval_step`` + ``validate`` on tiny50 with shared float32 weights,
  three batches with a masked tail, for the three losses: ``j``,
  ``conf_kn`` and ``conf_unk`` within 1e-4 (JAX's loss through its Pallas
  kernels in interpreter mode; the port's through its fused wrappers,
  which run their kernels' plain versions on CPU tensors, and unfused).
* ``OpenSetPredictor`` of both packages from the same reference ``.pth``:
  the same bucket ladder, the same classes (rejections included) and
  measures within 1e-4 in float32.
* Importing the port leaves jax (and the JAX package) unloaded.
"""

import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openset_imagenet_tpu import train as jengine
from openset_imagenet_tpu.convert import save_reference_checkpoint
from openset_imagenet_tpu.models.resnet import build_resnet as jax_build
from openset_imagenet_tpu.ops.losses import AverageMeter
from openset_imagenet_tpu_torch import convert
from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.inference import OpenSetPredictor
from tests.test_torch_model import _random_variables

SIZE = 32


class _Pipeline:
    """Yields fixed numpy batches, like ``pipeline.InputPipeline.epoch``."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        yield from self.batches


def _batches(n_classes, loss, seed=0, batch=8, valid_tail=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        images = rng.integers(0, 256, (batch, SIZE, SIZE, 3), np.uint8)
        low = 0 if loss == "garbage" else -1
        labels = rng.integers(low, n_classes, batch).astype(np.int32)
        mask = np.ones(batch, np.float32)
        if i == 2:
            mask[valid_tail:] = 0
        out.append(types.SimpleNamespace(images=images, labels=labels,
                                         mask=mask))
    return _Pipeline(out)


def _jax_state(n_classes, seed):
    model = jax_build("tiny50", fc_layer_dim=n_classes,
                      out_features=n_classes, dtype=jnp.float32)
    state = jengine.create_state(model, jax.random.PRNGKey(0),
                                 optax.identity(), image_size=SIZE)
    variables = _random_variables(model, seed)
    return state.replace(params=variables["params"],
                         batch_stats=variables["batch_stats"]), variables


def _trackers():
    return {k: AverageMeter() for k in ("j", "conf_kn", "conf_unk")}


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
def test_validate_matches_jax(loss):
    n_classes = 9 if loss == "garbage" else 8
    weights = (np.random.default_rng(1).uniform(0.5, 2.0, n_classes)
               .astype(np.float32) if loss == "garbage" else None)
    state, variables = _jax_state(n_classes, seed=11)
    pipeline = _batches(n_classes, loss)

    ref = _trackers()
    jax_step = jengine.make_eval_step(
        jengine.make_loss_fn(loss, 0.5, weights, fused=True), loss,
        n_classes)
    jengine.validate(state, pipeline, 0, jax_step, ref)

    cfg = NameSpace({"model": {"variant": "tiny50"}})
    model = pengine.build_model(cfg, n_classes, dtype=torch.float32,
                                device="cpu")
    convert.load_into(model, convert.variables_to_state_dict(variables))
    for fused in ("auto", False):
        got = _trackers()
        step = pengine.make_eval_step(
            pengine.make_loss_fn(loss, 0.5, weights, fused=fused), loss,
            n_classes)
        pengine.validate(model, pipeline, 0, step, got)
        for name in ("j", "conf_kn", "conf_unk"):
            assert got[name].count == ref[name].count, name
            np.testing.assert_allclose(got[name].avg, ref[name].avg,
                                       rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    state, _ = _jax_state(9, seed=21)
    path = tmp_path_factory.mktemp("slice") / "garbage_best.pth"
    save_reference_checkpoint(path, state, epoch=3, best_score=1.25)
    return path


def _float32_predictors(path, monkeypatch):
    """Both packages' predictors with their models built in float32."""
    from openset_imagenet_tpu import inference as jinference
    from openset_imagenet_tpu_torch import inference as pinference

    def jax_f32(cfg, n_classes):
        return jax_build(cfg.model.variant, fc_layer_dim=n_classes,
                         out_features=n_classes, dtype=jnp.float32)

    def port_f32(cfg, n_classes, device="cpu"):
        return pengine.build_model(cfg, n_classes, dtype=torch.float32,
                                   device=device)

    monkeypatch.setattr(jengine, "build_model", jax_f32)
    monkeypatch.setattr(pinference, "build_model", port_f32)
    return (jinference.OpenSetPredictor(path, variant="tiny50",
                                        image_size=SIZE),
            OpenSetPredictor(path, variant="tiny50", image_size=SIZE,
                             device="cpu"))


def test_predictor_matches_jax(checkpoint, monkeypatch):
    ref, ours = _float32_predictors(checkpoint, monkeypatch)
    assert ours.n_classes == ref.n_classes == 9
    assert [ours._bucket(n) for n in range(1, 301)] == \
        [ref._bucket(n) for n in range(1, 301)]

    images = np.random.default_rng(4).integers(0, 256, (5, SIZE, SIZE, 3),
                                               np.uint8)
    for mode, background in (("softmax", False), ("objectosphere", True)):
        for p in (ours, ref):
            p.mode, p.has_background, p.threshold = mode, background, 0.0
        c_ref, m_ref, f_ref, s_ref = ref.predict(images, return_arrays=True)
        c_got, m_got, f_got, s_got = ours.predict(images, return_arrays=True)
        np.testing.assert_array_equal(c_got, c_ref)
        np.testing.assert_allclose(m_got, m_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f_got, f_ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(f_ref).max())
        np.testing.assert_allclose(s_got, s_ref, rtol=1e-4, atol=1e-4)
        # Reject the lower half: threshold between two sorted measures.
        cut = np.sort(m_ref)[1:3].mean()
        for p in (ours, ref):
            p.threshold = float(cut)
        c_ref, _ = ref.predict(images)
        c_got, _ = ours.predict(images)
        np.testing.assert_array_equal(c_got, c_ref)
        assert (c_got == -1).sum() == 2


def test_predictor_warm_buckets(checkpoint):
    pred = OpenSetPredictor(checkpoint, variant="tiny50", image_size=SIZE,
                            device="cpu")
    assert not pred.buckets_compiled_up_to(8)
    pred.warmup(8)
    assert pred.buckets_compiled_up_to(8)
    assert not pred.buckets_compiled_up_to(16)
    cls, measure = pred.predict(np.zeros((3, SIZE, SIZE, 3), np.uint8))
    assert cls.shape == measure.shape == (3,)
    with pytest.raises(ValueError, match="uint8"):
        pred.predict(np.zeros((3, SIZE, SIZE, 3), np.float32))


def test_port_checkpoint_loads_in_both_packages(tmp_path):
    from openset_imagenet_tpu.convert import load_reference_checkpoint
    from openset_imagenet_tpu_torch import checkpoint

    _, variables = _jax_state(5, seed=31)
    model = pengine.build_model(NameSpace({"model": {"variant": "tiny50"}}),
                                5, dtype=torch.float32, device="cpu")
    convert.load_into(model, convert.variables_to_state_dict(variables))
    path = tmp_path / "port.pth"
    checkpoint.save_checkpoint(path, model, epoch=2, best_score=0.5)
    assert checkpoint.infer_n_classes(path) == 5
    again = pengine.build_model(NameSpace({"model": {"variant": "tiny50"}}),
                                5, dtype=torch.float32, device="cpu")
    # epoch 2 finished: stored as 3, the epoch to resume at.
    assert checkpoint.load_checkpoint(path, again)[1:] == (3, 0.5)
    assert checkpoint.read_metadata(path)["step"] == 0
    for key, value in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key
    jmodel = jax_build("tiny50", fc_layer_dim=5, out_features=5,
                       dtype=jnp.float32)
    jvars, epoch, best = load_reference_checkpoint(path, jmodel,
                                                   image_size=SIZE)
    assert (epoch, best) == (3, 0.5)
    images = np.random.default_rng(8).random((2, SIZE, SIZE, 3)).astype(
        np.float32)
    ref_logits, _ = jmodel.apply(jvars, images, train=False)
    with torch.inference_mode():
        logits, _ = again(torch.from_numpy(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-4, atol=1e-5)


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, openset_imagenet_tpu_torch as p\n"
        "[getattr(p, n) for n in p.__all__]\n"
        "import openset_imagenet_tpu_torch.checkpoint\n"
        "import openset_imagenet_tpu_torch.config\n"
        "import openset_imagenet_tpu_torch.train\n"
        "import openset_imagenet_tpu_torch.pipeline\n"
        "import openset_imagenet_tpu_torch.dataset\n"
        "import openset_imagenet_tpu_torch.convert\n"
        "import openset_imagenet_tpu_torch.experimental.fused_block\n"
        "import openset_imagenet_tpu_torch.ops.fused_block_bwd\n"
        "import openset_imagenet_tpu_torch.experimental.split_site\n"
        "import openset_imagenet_tpu_torch.ops.stream_probe\n"
        "import openset_imagenet_tpu_torch.tools.bench_split_site\n"
        "import openset_imagenet_tpu_torch.tools.bench_stream\n"
        "from openset_imagenet_tpu_torch.train import worker\n"
        "import openset_imagenet_tpu_torch.events\n"
        "import openset_imagenet_tpu_torch.logger\n"
        "import openset_imagenet_tpu_torch.native.jpeg\n"
        "import openset_imagenet_tpu_torch.script.train\n"
        "import openset_imagenet_tpu_torch.losses\n"
        "import openset_imagenet_tpu_torch.metrics\n"
        "heavy = ('jax', 'flax', 'optax', 'openset_imagenet_tpu', 'yaml',\n"
        "         'msgpack', 'pandas', 'PIL', 'triton')\n"
        "print([m for m in sys.modules if m.split('.')[0] in heavy])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_post_training_modules_leave_jax_unloaded():
    """The extraction, evaluation and protocol modules import neither jax
    nor the JAX package, nor matplotlib, sklearn or PyYAML (imported when
    a function needs them); ``plots`` imports matplotlib and no jax."""
    code = (
        "import sys\n"
        "import openset_imagenet_tpu_torch.ops.oscr\n"
        "import openset_imagenet_tpu_torch.util\n"
        "import openset_imagenet_tpu_torch.script.evaluate\n"
        "import openset_imagenet_tpu_torch.script.plot_all\n"
        "import openset_imagenet_tpu_torch.script.train_all\n"
        "import openset_imagenet_tpu_torch.script.protocols\n"
        "import openset_imagenet_tpu_torch.protocol\n"
        "import openset_imagenet_tpu_torch.wordnet\n"
        "import openset_imagenet_tpu_torch.tools.drive_cli\n"
        "from openset_imagenet_tpu_torch import get_arrays, "
        "calculate_oscr_torch\n"
        "heavy = ('jax', 'flax', 'optax', 'openset_imagenet_tpu', 'yaml',\n"
        "         'matplotlib', 'sklearn', 'PIL', 'triton')\n"
        "print([m for m in sys.modules if m.split('.')[0] in heavy])\n"
        "import openset_imagenet_tpu_torch.plots\n"
        "print([m for m in sys.modules if m.split('.')[0] in heavy[:4]])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["[]", "[]"], out.stdout


def test_prediction_modules_leave_jax_unloaded():
    """The prediction paths, the daemon and the inference optimizations
    (folding, int8 quantization and its kernel's wrapper) import neither
    jax nor the JAX package, nor PIL or triton (a decode imports PIL when
    it needs it)."""
    code = (
        "import sys\n"
        "import openset_imagenet_tpu_torch.serve\n"
        "import openset_imagenet_tpu_torch.inference\n"
        "import openset_imagenet_tpu_torch.optimize\n"
        "import openset_imagenet_tpu_torch.models.quant\n"
        "import openset_imagenet_tpu_torch.ops.int8_conv\n"
        "import openset_imagenet_tpu_torch.script.predict\n"
        "import openset_imagenet_tpu_torch.script.serve\n"
        "from openset_imagenet_tpu_torch.inference import "
        "calibrate_threshold\n"
        "from openset_imagenet_tpu_torch.native.jpeg import "
        "decode_batch_mem\n"
        "heavy = ('jax', 'flax', 'optax', 'openset_imagenet_tpu', 'yaml',\n"
        "         'PIL', 'triton')\n"
        "print([m for m in sys.modules if m.split('.')[0] in heavy])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
