"""A configuration of another architecture comes in by its family alone.

The ResNet configurations reach today's reference and counter through
``families.of``; a small two-head patch-embedding MLP, defined here and
registered as ``benchmark_torch.lib.family_patchmlp`` without a file under
``lib/``, runs through the train and predict generators with ``engine.
build_model`` patched to build it, and is judged against its own plain
float32 reference: sound, it is correct; with one weight of the program's
model perturbed, it is not."""

import json
import math
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT, TINY, traffic

from benchmark_torch import calibrate
from benchmark_torch import run as bench
from benchmark_torch.lib import (compare, data, drive_predict, drive_train,
                                 families, flops, harness, reference)

CFG = {"name": "patchmlp-test", "family": "patchmlp", "image_size": 32,
       "patch": 8, "hidden": 16, "fc_layer_dim": 6, "n_classes": 6,
       "loss": "entropic", "optimizer": "adam", "lr": 1e-3, "batch": 16,
       "negative_share": 0.3}
CELLS = {"train": "train.patchmlp.test", "predict": "predict.patchmlp.test"}


def _patches(x: torch.Tensor, p: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // p, p, w // p, p, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)


def _shapes(cfg):
    p, d = int(cfg["patch"]), int(cfg["hidden"])
    fc = int(cfg["fc_layer_dim"])
    return [("embed.weight", (d, 3 * p * p)), ("embed.bias", (d,)),
            ("fc.weight", (fc, d)), ("fc.bias", (fc,)),
            ("logits.weight", (int(cfg["n_classes"]), fc))]


def _forward(w, x, cfg, quant=None):
    q = reference._rounder(quant)

    def dense(h, name, bias=True):
        return F.linear(q(h), q(w[f"{name}.weight"]),
                        w[f"{name}.bias"] if bias else None)

    t = F.gelu(dense(_patches(x, int(cfg["patch"])), "embed")).mean(1)
    features = dense(t, "fc")
    return dense(features, "logits", bias=False), features


def _family() -> types.ModuleType:
    """The patch-MLP family: the contract of :mod:`families`, its control
    the reference with every dense input and weight in float8."""
    fam = types.ModuleType("benchmark_torch.lib.family_patchmlp")

    def make_weights(cfg, seed, device):
        items = _shapes(cfg)
        sizes = [math.prod(s) for _, s in items]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) & (2 ** 63 - 1))
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        return {n: (z.view(s) / math.sqrt(s[1]) if len(s) == 2
                    else 0.1 * z.view(s))
                for (n, s), z in zip(items, flat.split(sizes))}

    def param_names(cfg):
        return [n for n, _ in _shapes(cfg)]

    def train_steps(w0, batches, cfg, steps=3, quant=None):
        names = param_names(cfg)
        params = {n: w0[n].clone().requires_grad_() for n in names}
        m = {n: torch.zeros_like(params[n]) for n in names}
        v = {n: torch.zeros_like(params[n]) for n in names}
        lr, b1, b2, eps = float(cfg["lr"]), 0.9, 0.999, 1e-8
        losses, g1, logits1 = [], None, None
        for t in range(1, steps + 1):
            images, labels = batches[t - 1]
            x = torch.as_tensor(images).float() / 255.0
            logits, _ = _forward(params, x, cfg, quant)
            loss = reference.entropic_rows(
                logits, torch.as_tensor(labels).long()).mean()
            grads = dict(zip(names, torch.autograd.grad(
                loss, [params[n] for n in names])))
            losses.append(float(loss.detach()))
            if t == 1:
                g1 = {n: float(grads[n].norm()) for n in names}
                logits1 = logits.detach()
            with torch.no_grad():
                for n in names:
                    g = grads[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    params[n].sub_(lr * (m[n] / (1 - b1 ** t)) / (
                        (v[n] / (1 - b2 ** t)).sqrt() + eps))
        with torch.no_grad():
            change = {n: float((params[n] - w0[n]).norm()) for n in names}
        return losses, logits1, g1, change

    @torch.no_grad()
    def eval_logits(w, images_u8, cfg, quant=None):
        return _forward(w, torch.as_tensor(images_u8).float() / 255.0,
                        cfg, quant)[0]

    def forward_flops(cfg):
        p, d = int(cfg["patch"]), int(cfg["hidden"])
        fc, size = int(cfg["fc_layer_dim"]), int(cfg["image_size"])
        tokens = (size // p) ** 2
        return 2.0 * (tokens * 3 * p * p * d + d * fc
                      + fc * int(cfg["n_classes"]))

    fam.make_weights = make_weights
    fam.param_names = param_names
    fam.train_steps = train_steps
    fam.eval_logits = eval_logits
    fam.calibrate_running_stats = lambda w, images_u8, cfg: w
    fam.forward_flops = forward_flops
    fam.train_flops = lambda cfg: 3.0 * forward_flops(cfg)
    fam.model_options = lambda cfg: {"variant": "patchmlp"}
    fam.control_quant = "fp8"
    return fam


class PatchMLP(torch.nn.Module):
    """The program's side: the same model as torch modules, returning
    ``(logits, features)`` as the port's ResNet does."""

    perturb = 0.0

    def __init__(self, cfg, n_classes, dtype, device):
        super().__init__()
        p, d = int(cfg["patch"]), int(cfg["hidden"])
        fc = int(cfg["fc_layer_dim"])
        kw = {"dtype": dtype, "device": device}
        self.patch = p
        self.embed = torch.nn.Linear(3 * p * p, d, **kw)
        self.fc = torch.nn.Linear(d, fc, **kw)
        self.logits = torch.nn.Linear(fc, n_classes, bias=False, **kw)

    def forward(self, x):
        x = x.to(self.embed.weight.dtype)
        t = F.gelu(self.embed(_patches(x, self.patch))).mean(1)
        features = self.fc(t)
        return self.logits(features), features

    def load_state_dict(self, state_dict, strict=True, assign=False):
        out = super().load_state_dict(state_dict, strict, assign)
        with torch.no_grad():
            self.fc.bias[0] += self.perturb
        return out


@pytest.fixture
def patchmlp(monkeypatch):
    """The family registered by module name, and the program's
    ``build_model`` (in the trainer and the predictor) building it in
    float32."""
    from openset_imagenet_tpu_torch import inference
    from openset_imagenet_tpu_torch import train as engine

    monkeypatch.setitem(sys.modules, "benchmark_torch.lib.family_patchmlp",
                        _family())

    def build(cfg, n_classes, dtype=torch.bfloat16, device="cuda",
              generator=None):
        return PatchMLP(CFG, n_classes, torch.float32, device)

    monkeypatch.setattr(engine, "build_model", build)
    monkeypatch.setattr(inference, "build_model", build)
    return PatchMLP


def _bench_with_cells() -> dict:
    """``BENCHMARK.json`` with the two cells added to the end-to-end
    metrics they report, as a configuration's PR adds them."""
    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    for m in b["end_to_end"]:
        kind = m["name"].split("_")[0]
        if kind in CELLS:
            m["workloads"] = m["workloads"] + [CELLS[kind]]
    return b


def _run(make_ctx, kind):
    if kind == "train":
        ctx = make_ctx(traffic("train_b256", warm_steps=4,
                               max_imgs_per_s=100000), seed=11,
                       seconds=0.2, config=CFG)
        return ctx, drive_train.run(ctx)
    ctx = make_ctx(traffic("predict_b256", batch=16, distinct_images=64,
                           check_rows=32, calibration_images=8,
                           max_imgs_per_s=100000), seed=12, config=CFG)
    return ctx, drive_predict.run(ctx)


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_second_family_runs_correct_through_the_generator(make_ctx,
                                                          patchmlp, kind):
    ctx, res = _run(make_ctx, kind)
    correct, checks = compare.judge(res.numbers, harness.limits_of(ctx))
    assert correct, checks
    line = bench.result_line(_bench_with_cells(), {"name": CELLS[kind]},
                             res, False, {"platform": "gpu"}, checks,
                             correct)
    # Off the card the window has no device time: setup_s alone.
    assert set(line["metrics"]) == {"setup_s"}
    assert line["correct"] is True
    c = res.counters
    assert bench.read_metric(f"{kind}.imgs_per_s", res) == pytest.approx(
        c["window_images"] / c["window_s"])
    fam = families.of(CFG)
    per_image = fam.train_flops(CFG) if kind == "train" else \
        fam.forward_flops(CFG)
    c = res.counters
    assert bench.read_metric(f"{kind}.mfu", res) == pytest.approx(
        100.0 * per_image * c["window_images"] / c["window_s"] / 989e12)


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_second_family_perturbed_weight_is_not_correct(make_ctx, patchmlp,
                                                       monkeypatch, kind):
    monkeypatch.setattr(patchmlp, "perturb", 1.0)
    ctx, res = _run(make_ctx, kind)
    assert not compare.judge(res.numbers, harness.limits_of(ctx))[0], \
        res.numbers


@pytest.mark.parametrize("name", ["resnet50-p1", "wide_resnet50_2-p1"])
def test_resnet_configurations_keep_the_reference_and_counter(name):
    with open(ROOT / "benchmark_torch" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    fam = families.of(cfg)
    for fn in ("make_weights", "param_names", "train_steps", "eval_logits",
               "calibrate_running_stats"):
        assert getattr(fam, fn) is getattr(reference, fn)
    assert fam.forward_flops is flops.forward_flops
    assert fam.train_flops is flops.train_flops
    assert fam.control_quant == "fp8"
    assert fam.model_options(cfg) == {"variant": cfg["variant"],
                                      "bn_stats_rows": cfg["bn_stats_rows"]}
    assert families.of(dict(TINY)) is fam


def test_unknown_family_names_the_file_it_expected():
    with pytest.raises(SystemExit, match="benchmark_torch/lib/family_nosuch"
                       r"\.py"):
        families.of({"name": "x", "family": "nosuch"})


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_second_family_control_reads_its_own_float8(make_ctx, patchmlp, kind):
    """``calibrate.py`` reads the family's own control (its reference in
    its ``control_quant``): some number reads three times or more what a
    sound run of the program reads, so the control can set an upper
    reading for the family's limits."""
    ctx, res = _run(make_ctx, kind)
    fn = calibrate.control_train if kind == "train" else \
        calibrate.control_answers
    control = fn(ctx, compare, data)["control"]
    assert set(control) <= set(res.numbers)
    assert any(control[k] >= 3 * res.numbers[k] > 0 or
               control[k] > 0 == res.numbers[k] for k in control), \
        (control, res.numbers)


@pytest.mark.parametrize("name", families.CONTRACT)
def test_family_lacking_part_of_the_contract_is_refused(monkeypatch, name):
    fam = _family()
    delattr(fam, name)
    monkeypatch.setitem(sys.modules, "benchmark_torch.lib.family_patchmlp",
                        fam)
    with pytest.raises(SystemExit, match=rf"family_patchmlp\.py.*{name}"):
        families.of(CFG)
