"""The port's two-head Swin (``models/swin.py``) on the CPU.

Held against the benchmark's plain float32 reference of the Swin family
(``benchmark_torch/lib/family_swin.py``, plain ``torch``, no module of
the port) on its seeded weights, at a tiny size: 32 px, embedding 32,
depths (2, 2), heads (2, 4), window 4, so that stage 1 (an 8x8 map)
shifts in its odd block and stage 2 (4x4, one window) does not.

* float32: logits and features to 1e-5 of their norm; every leaf's
  gradient to 1e-4 of the larger of its norm and the median leaf's;
  three Adam steps through ``make_train_step`` as the benchmark's
  ``correct`` reads them, to 1e-5 (losses, first logits) and 1e-4
  (gradient and change norms).
* bfloat16: the logits within 2 % of their norm.  The reason: every
  product, LayerNorm, GELU and residual add rounds to 8 bits of mantissa
  (2**-9 relative) on a path of about twenty such layers, and the CPU
  reads 0.5-0.7 %; the reference with every linear layer's input and
  kernel in float8 e4m3 (the benchmark's control, 2**-4 relative) reads
  more than 2 %, so the tolerance tells the two precisions apart.
* The region mask: a token of another region of its shifted window moves
  nothing of a token's output, bit for bit; one of its own region does.
* ``meta`` -> ``to_empty`` -> strict load equals a build on the CPU.
* The operation counter and the parameter count against the published
  Swin-B figures (arXiv 2103.14030, Table 1).
* The normal path: ``build_model`` at Swin-B's published widths, the
  worker trains, resumes and selects γ, the checkpoint is rebuilt as a
  Swin by ``resolve_model_cfg`` and ``OpenSetPredictor``, a checkpoint
  without ``arch`` as a ResNet; ``fold_bn`` and ``int8`` refuse a Swin;
  the ``swin.attention`` spans and ``COUNTS``.
"""

import json
import math
import pathlib
import statistics

import numpy as np
import pytest
import torch

from benchmark_torch.lib import compare
from benchmark_torch.lib import family_swin as ref
from openset_imagenet_tpu_torch import checkpoint as ckpt
from openset_imagenet_tpu_torch import optimize, tracing
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.inference import OpenSetPredictor
from openset_imagenet_tpu_torch.models import swin
from openset_imagenet_tpu_torch.models.resnet import ResNet50
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    curr_of, one_torch_thread, run, tiny_cfg, write_protocol_csvs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = {"variant": "tiny_swin", "image_size": 32, "patch_size": 4,
       "embed_dim": 32, "depths": [2, 2], "num_heads": [2, 4],
       "window_size": 4, "mlp_ratio": 4, "fc_layer_dim": 6,
       "n_classes": 6, "lr": 1e-3}
SWIN = {"arch": "swin", "variant": "tiny_swin"}


def _model(dtype=torch.float32, seed=5, device="cpu"):
    model = engine.build_model(NameSpace({"model": SWIN}), CFG["n_classes"],
                               dtype=dtype, device=device)
    if device == "meta":
        model.to_empty(device="cpu")
    model.load_state_dict(ref.make_weights(CFG, seed, "cpu"), strict=True)
    return model


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(-1, CFG["n_classes"], n)
    return images, labels


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_forward_matches_the_reference_in_float32():
    images, _ = _batch()
    x = torch.from_numpy(images).float() / 255.0
    with torch.no_grad():
        logits, features = _model()(x)
        ref_logits, ref_features = ref.forward(
            ref.make_weights(CFG, 5, "cpu"), x, CFG)
    assert _rel(logits, ref_logits) < 1e-5
    assert _rel(features, ref_features) < 1e-5


def test_every_gradient_matches_the_reference_in_float32():
    images, labels = _batch(1)
    model = _model()
    loss_fn = engine.make_loss_fn("entropic", fused="auto")
    logits, _ = model(torch.from_numpy(images).float() / 255.0)
    loss, _ = loss_fn(logits, torch.from_numpy(labels),
                      torch.ones(len(labels)))
    loss.backward()
    w = ref.make_weights(CFG, 5, "cpu")
    params = {n: w[n].clone().requires_grad_() for n in ref.param_names(CFG)}
    ref_loss, grads, _ = ref.loss_and_grads(params, images, labels, CFG,
                                            block=3)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    median = statistics.median(float(g.norm()) for g in grads.values())
    for name, g in grads.items():
        gap = float((named[name].grad - g).norm())
        assert gap <= 1e-4 * max(float(g.norm()), median), name


def _program_steps(model, batches):
    """Three train steps of the program: the numbers the benchmark's
    ``correct`` reads (losses, first logits, first gradient norms as Adam
    holds them, change norms)."""
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loss_fn = engine.make_loss_fn("entropic", fused="auto")
    tx = engine.build_optimizer(NameSpace({"type": "adam", "lr": CFG["lr"]}),
                                steps_per_epoch=3)
    state = engine.create_state(model, tx)
    step = engine.make_train_step(loss_fn)
    named = list(model.named_parameters())
    first = []
    hook = model.register_forward_hook(
        lambda mod, inp, out: first.append(out[0].detach()))
    losses, g1 = [], {}
    for t, (images, labels) in enumerate(batches):
        state, m = step(state, images, labels,
                        np.ones(len(labels), np.float32))
        losses.append(float(m["loss_sum"] / m["count"]))
        if t == 0:
            hook.remove()
            g1 = {k: float(state.optimizer.state[p]["exp_avg"].norm() / 0.1)
                  for k, p in named}
    change = {k: float((p.detach() - w0[k]).norm()) for k, p in named}
    return losses, first[0], g1, change


def test_three_adam_steps_match_the_reference_in_float32():
    batches = [_batch(10 + t) for t in range(3)]
    prog = _program_steps(_model(), batches)
    want = ref.train_steps(ref.make_weights(CFG, 5, "cpu"), batches, CFG,
                           block=3)
    numbers, where = compare.train_numbers(prog, want)
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["logits_diff"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-4, (numbers, where)
    assert numbers["change_gap"] < 1e-4, (numbers, where)


BF16_LOGITS = 0.02  # the module docstring gives the reason


@pytest.mark.parametrize("seed", [5, 6])
def test_bfloat16_within_its_tolerance_and_float8_outside(seed):
    images, _ = _batch(seed)
    x = torch.from_numpy(images).float() / 255.0
    w = ref.make_weights(CFG, seed, "cpu")
    with torch.no_grad():
        logits, _ = _model(torch.bfloat16, seed)(x)
        want = ref.eval_logits(w, images, CFG)
        control = ref.eval_logits(w, images, CFG, quant=ref.control_quant)
    assert _rel(logits, want) < BF16_LOGITS
    assert _rel(control, want) > BF16_LOGITS


def _shifted_block(seed=3):
    """Stage 1's shifted block (an 8x8 map, windows of 4, shift 2)."""
    torch.manual_seed(seed)
    block = swin.SwinBlock(32, 2, 4, True, 4.0)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
    return block


def test_region_mask_isolates_the_regions_of_a_shifted_window():
    """After the roll by -2, the last window holds rows and columns 6, 7,
    0, 1 of the map: rows 6-7 form one region, rows 0-1 (wrapped from the
    top) another.  The output at (6, 6) does not see (0, 6) or (6, 0),
    and does see (7, 7)."""
    block = _shifted_block()
    assert block.geometry(8, 8, "cpu")[:2] == (4, 2)
    x = torch.randn(1, 8, 8, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        base = block(x)
        for other, seen in (((0, 6), False), ((6, 0), False),
                            ((1, 1), False), ((7, 7), True),
                            ((6, 7), True)):
            y = x.clone()
            y[0, other[0], other[1]] += 1.0
            out = block(y)[0, 6, 6]
            assert torch.equal(out, base[0, 6, 6]) != seen, other


def test_unshifted_where_the_map_is_one_window():
    block = _shifted_block()
    ws, shift, _, region = block.geometry(4, 4, "cpu")
    assert (ws, shift, region) == (4, 0, None)
    ws, shift, _, region = block.geometry(16, 16, "cpu")
    assert (ws, shift) == (4, 2) and region.shape == (16, 16, 16)
    assert sorted(set(region.unique().tolist())) == [swin.MASKED, 0.0]
    with pytest.raises(ValueError, match="6x6"):
        block.geometry(6, 6, "cpu")


def test_training_after_a_first_forward_under_inference_mode():
    """The window constants a first forward derives (as the predictor's,
    under ``torch.inference_mode``) are kept for later training steps,
    which save them for the backward."""
    model = _model()
    x = torch.from_numpy(_batch(6)[0]).float() / 255.0
    with torch.inference_mode():
        model(x)
    model(x)[0].sum().backward()
    table = model.layers[0].blocks[1].attn.relative_position_bias_table
    assert table.grad is not None


def test_meta_build_then_strict_load_equals_a_cpu_build():
    images, _ = _batch(2)
    x = torch.from_numpy(images).float() / 255.0
    with torch.no_grad():
        a = _model(torch.bfloat16, device="meta")(x)
        b = _model(torch.bfloat16)(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_published_parameters_and_multiply_adds():
    """Swin-B in Table 1 at 224 px with the 1000-class head (here ``fc``;
    an empty logits head): 88M parameters and 15.4G multiply-adds, to the
    figures' own rounding (within 1 %)."""
    cfg = dict(CFG, image_size=224, embed_dim=128, depths=[2, 2, 18, 2],
               num_heads=[4, 8, 16, 32], window_size=7, fc_layer_dim=1000,
               n_classes=0)
    model = swin.build_swin("swin_b", fc_layer_dim=1000, out_features=0,
                            device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(math.prod(s) for _, s, _ in ref.spec(cfg))
    assert abs(n / 1e6 - 88) <= 0.5
    assert abs(ref.forward_flops(cfg) / 2e9 - 15.4) <= 0.05
    assert ref.train_flops(cfg) == 3 * ref.forward_flops(cfg)
    # QK^T and PV: about 0.3G of the 15.4G multiply-adds.
    assert abs(ref.attention_flops(cfg) / 2e9 - 0.30) <= 0.01


def test_build_model_gives_swin_b_at_its_published_widths():
    model = engine.build_model(
        NameSpace({"model": {"arch": "swin", "variant": "swin_b"}}), 116,
        device="meta")
    assert isinstance(model, swin.Swin) and model.variant == "swin_b"
    assert model.patch_embed.proj.weight.shape == (128, 3, 4, 4)
    assert [len(s.blocks) for s in model.layers] == [2, 2, 18, 2]
    for i, stage in enumerate(model.layers):
        d = 128 * 2 ** i
        for j, block in enumerate(stage.blocks):
            assert block.attn.num_heads == (4, 8, 16, 32)[i]
            assert block.attn.qkv.weight.shape == (3 * d, d)
            assert block.mlp.fc1.weight.shape == (4 * d, d)
            assert block.attn.relative_position_bias_table.shape == (169,
                                                                     d // 32)
            assert block.window_size == 7 and block.shifted == (j % 2 == 1)
    assert model.fc.weight.shape == (116, 1024)
    assert model.logits.weight.shape == (116, 116)
    assert model.logits.bias is None
    # The benchmark's configuration names the same widths.
    with open(ROOT / "benchmark_torch" / "configs" / "swin_b-p1.json") as f:
        cfg = json.load(f)
    assert {k: cfg[k] for k in ("embed_dim", "depths", "num_heads",
                                "window_size")} == {
        "embed_dim": 128, "depths": [2, 2, 18, 2], "num_heads": [4, 8, 16, 32],
        "window_size": 7}
    assert ref.model_options(cfg) == {"arch": "swin", "variant": "swin_b"}


def test_build_model_refuses_what_a_swin_cannot_take():
    with pytest.raises(ValueError, match="ResNets only"):
        engine.build_model(NameSpace({"model": {**SWIN, "bn_stats_rows": 8}}),
                           6, device="meta")
    with pytest.raises(ValueError, match="unknown model arch"):
        engine.build_model(NameSpace({"model": {"arch": "vit"}}), 6,
                           device="meta")
    with pytest.raises(ValueError, match="unknown swin variant"):
        engine.build_model(NameSpace({"model": {"arch": "swin",
                                                "variant": "resnet50"}}), 6,
                           device="meta")


def test_tail_step_is_the_regular_step_without_batch_norm():
    step = engine.make_train_step(engine.make_loss_fn("entropic"))
    assert engine.make_tail_step(None, _model(), 3, step) is step


def test_fold_bn_and_int8_refuse_a_swin():
    model = _model()
    calibration = np.zeros((4, 32, 32, 3), np.uint8)
    for call in (lambda: optimize.optimized_inference(model, "fold_bn"),
                 lambda: optimize.optimized_inference(
                     model, "int8", calibration=calibration, image_size=32),
                 lambda: optimize.fold_inference(model),
                 lambda: optimize.quantize_inference(model, [calibration]),
                 lambda: optimize.fold_model(model)):
        with pytest.raises(ValueError, match="Swin tiny_swin"):
            call()


def test_attention_spans_and_counts_in_a_traced_step():
    model = _model()
    step = engine.make_train_step(engine.make_loss_fn("entropic"))
    tx = engine.build_optimizer(NameSpace({"type": "adam", "lr": 1e-3}),
                                steps_per_epoch=1)
    state = engine.create_state(model, tx)
    images, labels = _batch(4)
    before = dict(swin.COUNTS)
    tracing.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("train.step", key=7):
            step(state, images, labels, np.ones(8, np.float32))
    spans = [r for r in tracing.snapshot() if r.name == "swin.attention"]
    tracing.clear()
    assert len(spans) == 4  # one a block
    assert all(r.parent == "train.forward" and r.key == 7 for r in spans)
    # 8 images: stage 1 in 4 windows an image, stage 2 in one.
    assert swin.COUNTS["attention_calls"] - before["attention_calls"] == 4
    assert swin.COUNTS["windows"] - before["windows"] == 8 * (4 + 4 + 1 + 1)


def test_get_arrays_of_an_empty_split_sizes_the_swin_heads():
    class Empty:
        def epoch(self, epoch):
            return iter(())

    _, logits, features, scores = engine.get_arrays(_model(), Empty())
    assert logits.shape == scores.shape == (0, 6) and features.shape == (0, 6)


def test_worker_trains_resumes_and_rebuilds_a_swin(tmp_path):
    """The worker on a tiny Swin: two epochs with γ selection, ``_curr``
    and ``_best`` carrying ``arch``; a resume from ``_curr`` trains the
    third; the predictor and ``resolve_model_cfg`` rebuild a Swin; a
    checkpoint written without ``arch`` reads as a ResNet."""
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, model=SWIN)
    info = run(cfg)
    assert info["last_epoch"] == 1 and info["best_score"] > 0
    meta = ckpt.read_metadata(curr_of(cfg))
    assert meta["extra"] == {"arch": SWIN}
    assert ckpt.resolve_model_cfg(curr_of(cfg)) == {
        "arch": "swin", "variant": "tiny_swin", "space_to_depth": False}
    resumed = run(tiny_cfg(tmp_path, model=SWIN, epochs=3,
                           checkpoint=str(curr_of(cfg))))
    assert resumed["last_epoch"] == 2
    best = pathlib.Path(cfg.output_directory) / "entropic_best.pth"
    predictor = OpenSetPredictor(best, device="cpu", image_size=32)
    assert isinstance(predictor.model, swin.Swin)
    images, _ = _batch(3)
    model = engine.build_model(NameSpace({"model": SWIN}), 3, device="cpu")
    ckpt.load_checkpoint(best, model)
    with torch.no_grad():
        want = torch.softmax(model(torch.from_numpy(images).float()
                                   / 255.0)[0], -1)
    classes, scores = predictor.predict(images)
    np.testing.assert_array_equal(classes, want.argmax(-1).numpy())
    np.testing.assert_allclose(scores, want.max(-1).values.numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="Swin"):
        OpenSetPredictor(best, device="cpu", image_size=32,
                         optimize="fold_bn")
    # A ResNet's file: extra.arch without "arch", as the JAX worker and
    # the earlier port write it.
    old = tmp_path / "old.pth"
    resnet = engine.build_model(NameSpace({"model": {"variant": "tiny"}}), 3,
                                device="cpu")
    ckpt.save_checkpoint(old, resnet, 0, 0.0,
                         extra={"arch": {"variant": "tiny"}})
    assert ckpt.resolve_model_cfg(old) == {"variant": "tiny",
                                           "space_to_depth": False}
    assert isinstance(OpenSetPredictor(old, device="cpu",
                                       image_size=32).model, ResNet50)
