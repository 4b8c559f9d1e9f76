"""Inference-graph optimizations: batch-norm folding and int8 post-training
quantization.

Counterpart of :mod:`openset_imagenet_tpu.optimize`.  At inference a
batch-norm is the per-channel affine map of its running statistics,

    bn(z) = z * inv + (bias - mean * inv),     inv = scale / sqrt(var + eps)

so it folds into the preceding convolution: ``kernel' = kernel * inv``
(per output channel) and a bias ``bias - mean * inv``.  The folded graph
(``ResNet50(folded=True)``) has biased convs and identity norm slots.  The
int8 graph (``quantized=True``) builds on it: the block convs become
``QuantConv`` with per-tensor activation scales from calibration
(:func:`calibrate_amax`) and per-channel weight scales
(:func:`quantize_params`); the stem and both heads stay in bfloat16.

The parameter arithmetic runs in numpy float32 on the JAX package's tree
layout (``{"params": {"conv_init": {"kernel": HWIO, ...}, ...}}``, which
:mod:`.convert` gives for any model of the port), with the JAX package's
own expressions, so the folded and quantized trees are bit-equal to JAX's
from the same weights.  A port model carries its weights, so where a JAX
function takes and returns ``(model, state)`` the port's takes and
returns the model.
"""

from __future__ import annotations

import logging
from typing import Any, Tuple

import numpy as np
import torch

from . import convert
from .models.norm import BN_EPSILON
from .models.resnet import ResNet50

# conv slot -> the batch-norm slot it feeds, within one module scope.
_CONV_TO_BN = {
    "conv_init": "bn_init",
    "Conv_0": "bn1",
    "Conv_1": "bn2",
    "Conv_2": "bn3",
    "downsample_conv": "downsample_bn",
}
_BN_TO_CONV = {v: k for k, v in _CONV_TO_BN.items()}

# Conv slots that quantize: the block convolutions.  The stem (conv_init)
# and the dense heads (fc / logits) stay in the compute dtype.
_QUANT_SLOTS = frozenset({"Conv_0", "Conv_1", "Conv_2", "downsample_conv"})


def _is_param_leaf_dict(d) -> bool:
    """True for a module's own param dict ({'kernel': arr, ...})."""
    return isinstance(d, dict) and bool(d) and all(
        not isinstance(v, dict) for v in d.values())


def _fold_pair(conv: dict, bn: dict, stats: dict, epsilon: float) -> dict:
    inv = (np.asarray(bn["scale"], np.float32)
           / np.sqrt(np.asarray(stats["var"], np.float32) + epsilon))
    kernel = np.asarray(conv["kernel"], np.float32) * inv  # out-chan last
    bias = (np.asarray(bn["bias"], np.float32)
            - np.asarray(stats["mean"], np.float32) * inv)
    if "bias" in conv:
        bias = bias + np.asarray(conv["bias"], np.float32) * inv
    return {"kernel": kernel, "bias": bias}


def fold_batchnorm(params: Any, batch_stats: Any,
                   epsilon: float = BN_EPSILON) -> Any:
    """Fold every (conv, bn) pair of a JAX-layout parameter tree (numpy
    leaves); returns the tree of ``folded=True`` (JAX
    ``optimize.py:70-105``).

    A conv slot whose paired bn slot (``_CONV_TO_BN``) exists in the same
    scope absorbs that bn's running-statistics affine map, and the bn
    slot disappears; scopes with no pairing (``fc``, ``logits``) pass
    through.  Missing statistics and an unpaired bn slot raise.
    """
    def fold_scope(p: dict, s: dict) -> dict:
        out = {}
        for key, val in p.items():
            if key in _CONV_TO_BN and _CONV_TO_BN[key] in p:
                bn_key = _CONV_TO_BN[key]
                if bn_key not in s:
                    raise ValueError(
                        f"no running statistics for {bn_key!r} — was this "
                        "state trained (batch_stats collection present)?")
                out[key] = _fold_pair(val, p[bn_key], s[bn_key], epsilon)
            elif key in _BN_TO_CONV:
                if _BN_TO_CONV[key] not in p:
                    raise ValueError(
                        f"batch-norm slot {key!r} has no paired conv "
                        f"{_BN_TO_CONV[key]!r} in its scope — the tree "
                        "does not match the model zoo's layout")
                continue  # consumed by its conv
            elif isinstance(val, dict) and not _is_param_leaf_dict(val):
                out[key] = fold_scope(val, s.get(key, {})
                                      if isinstance(s, dict) else {})
            else:
                out[key] = val
        return out

    return fold_scope(dict(params), dict(batch_stats))


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _require_batch_norm(model: torch.nn.Module) -> None:
    """Refuse a model these optimizations cannot take: folding and int8
    rewrite a ResNet's conv -> batch-norm pairs, and another architecture
    (the Swin: LayerNorm and linear layers) has none."""
    if not isinstance(model, ResNet50):
        raise ValueError(
            "batch-norm folding and int8 quantization rewrite a ResNet's "
            f"conv and batch-norm pairs; this model is a "
            f"{type(model).__name__} {getattr(model, 'variant', '')}, which "
            "has none: serve it unoptimized")


def _twin(model: ResNet50, **over) -> ResNet50:
    """A model of ``model``'s geometry with ``over`` applied, on its
    device, in eval mode (weights not drawn: they are loaded next)."""
    _require_batch_norm(model)
    cfg = {**model.config, **over}
    return ResNet50(**cfg, device=_device_of(model)).eval()


# What fold_model changes: the folded graph, and the training-only flags
# cleared (their checkpoints share the standard parameter layout).
_FOLDED = dict(folded=True, quantized=False, bn_stats_rows=0, dot_1x1=False,
               fused_blocks=False, boundary_mask=False, remat=False)


def fold_model(model: ResNet50) -> ResNet50:
    """The ``folded=True`` twin of a model (same geometry; JAX
    ``optimize.py:108-117``): the training-only flags ``fused_blocks``,
    ``boundary_mask``, ``dot_1x1``, ``bn_stats_rows`` and ``remat`` are
    cleared.  Its weights are placeholders until loaded."""
    return _twin(model, **_FOLDED)


def _load(model: ResNet50, params: Any) -> ResNet50:
    convert.load_into(model, convert.variables_to_state_dict(
        {"params": params}))
    return model


def _fold(model: ResNet50) -> Tuple[ResNet50, Any]:
    _require_batch_norm(model)
    variables = convert.state_dict_to_variables(model.state_dict())
    fparams = fold_batchnorm(variables["params"], variables["batch_stats"])
    return _load(fold_model(model), fparams), fparams


def fold_inference(model: ResNet50) -> ResNet50:
    """Fold a trained model for serving (JAX ``optimize.py:340-352``):
    the folded twin on the same device, in eval mode, with the folded
    weights."""
    return _fold(model)[0]


# ---------------------------------------------------------------------------
# Int8 PTQ (builds on the folded graph).

def _site_key(name: str):
    """The JAX module path (``stage1_block1/Conv_0``) of a conv of the
    model named ``name``, if it sits in a quantizing slot; else None."""
    try:
        path = convert.flax_path(f"{name}.weight")[:-1]
    except KeyError:
        return None
    return "/".join(path) if path[-1] in _QUANT_SLOTS else None


def _percentile(mag: torch.Tensor, percentile: float) -> float:
    """``jnp.percentile(mag, percentile)`` (method ``linear``) in its
    float32 arithmetic: ``q = f32(percentile) / 100``, the position ``q *
    (n - 1)`` with ``n`` the element count as float32, the two order
    statistics around it weighted ``1 - w`` and ``w`` and added."""
    values = torch.sort(mag.reshape(-1)).values
    n = np.float32(values.numel())
    pos = np.float32(np.float32(percentile) / np.float32(100)) * (
        n - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hi_w = np.float32(pos - low)
    lo_w = np.float32(np.float32(1) - hi_w)
    low = int(np.clip(low, 0, n - 1))
    high = int(np.clip(high, 0, n - 1))
    lo_v = np.float32(values[low].item())
    hi_v = np.float32(values[high].item())
    return float(np.float32(np.float32(lo_v * lo_w) + np.float32(hi_v *
                                                               hi_w)))


def calibrate_amax(fmodel: ResNet50, batches,
                   percentile: float | None = None) -> dict:
    """Per-conv-input abs-max over calibration batches (activation scales;
    JAX ``optimize.py:130-196``).

    Forward pre-hooks on the FOLDED model's quantizing conv slots record
    ``max|input|`` of each batch, keyed by the JAX module path
    (``stage1_block1/Conv_0``, the path :func:`quantize_params` walks).
    ``batches``: NHWC image batches (numpy or tensors); uint8 gets the
    serving preprocessing (``train._to_float``), float batches are taken
    as preprocessed.  ``percentile`` (e.g. ``99.9``) replaces each batch's
    abs-max with that percentile of |input|, computed as
    ``jnp.percentile`` computes it.  Batches combine by max.
    """
    from .train import _on, _to_float

    if percentile is not None and not 0.0 < percentile <= 100.0:
        raise ValueError(f"percentile must be in (0, 100], got "
                         f"{percentile}")
    device = _device_of(fmodel)
    records: dict = {}

    def site_stat(x: torch.Tensor):
        mag = x.float().abs()
        if percentile is None:
            return mag.max()
        return _percentile(mag, percentile)

    def hook_for(key):
        def hook(module, args):
            records[key] = site_stat(args[0])
        return hook

    hooks = [module.register_forward_pre_hook(hook_for(key))
             for name, module in fmodel.named_modules()
             for key in (_site_key(name),) if key is not None]
    amax: dict = {}
    try:
        with torch.inference_mode():
            fmodel.eval()
            for batch in batches:
                x = _on(device, batch)
                x = _to_float(x) if x.dtype == torch.uint8 else x.float()
                records.clear()
                fmodel(x)
                for key, val in records.items():
                    amax[key] = max(amax.get(key, 0.0), float(val))
    finally:
        for h in hooks:
            h.remove()
    if not amax:
        raise ValueError("calibration saw no batches (or the model has "
                         "no quantizable conv slots)")
    return amax


def quantize_params(fparams: Any, amax: dict) -> Any:
    """Convert a folded JAX-layout tree to the int8 tree of
    ``quantized=True`` (JAX ``optimize.py:199-240``, the same numpy
    arithmetic): per-output-channel weight scales ``s_w[c] =
    max|kernel[..., c]| / 127``, per-tensor activation scales ``s_in =
    amax / 127``; each quantizing conv slot becomes ``{kernel: int8,
    scale: s_in * s_w, bias, inv_input_scale: 1 / s_in}``.
    """
    def walk(p: dict, prefix: Tuple[str, ...]) -> dict:
        out = {}
        for key, val in p.items():
            path = prefix + (key,)
            if key in _QUANT_SLOTS and _is_param_leaf_dict(val):
                pathstr = "/".join(path)
                if pathstr not in amax:
                    raise ValueError(
                        f"no calibration record for {pathstr!r} — was "
                        "calibrate_amax run on this model's folded twin?")
                if "bias" not in val:
                    raise ValueError(
                        f"{pathstr!r} has no bias — quantize the FOLDED "
                        "parameters (optimize.fold_batchnorm first)")
                s_in = max(amax[pathstr], 1e-8) / 127.0
                kernel = np.asarray(val["kernel"], np.float32)
                s_w = np.max(np.abs(kernel), axis=(0, 1, 2)) / 127.0
                s_w = np.maximum(s_w, 1e-12)  # dead channels
                kq = np.clip(np.rint(kernel / s_w), -127, 127)
                out[key] = {
                    "kernel": kq.astype(np.int8),
                    "scale": (s_in * s_w).astype(np.float32),
                    "bias": np.asarray(val["bias"], np.float32),
                    "inv_input_scale": np.asarray(1.0 / s_in, np.float32),
                }
            elif isinstance(val, dict) and not _is_param_leaf_dict(val):
                out[key] = walk(val, path)
            else:
                out[key] = val
        return out

    return walk(dict(fparams), ())


def quantize_model(model: ResNet50) -> ResNet50:
    """The ``quantized=True`` twin of a model (same geometry), weights
    placeholders until loaded."""
    return _twin(model, **{**_FOLDED, "quantized": True})


def quantize_inference(model: ResNet50, calibration,
                       percentile: float | None = None) -> ResNet50:
    """Fold + calibrate + quantize a trained model (JAX
    ``optimize.py:248-266``).  ``calibration``: image batches run through
    the folded graph to set the activation scales.  Returns the quantized
    model with its weights, in eval mode."""
    fmodel, fparams = _fold(model)
    amax = calibrate_amax(fmodel, calibration, percentile=percentile)
    del fmodel
    return _load(quantize_model(model), quantize_params(fparams, amax))


def _default_image_loader(image_size: int):
    """Decode image paths by the serving policy
    (:func:`~.train.decode_serving_paths`), so calibration sees serving
    pixels."""
    def load(paths):
        from .train import decode_serving_paths

        batch, _ = decode_serving_paths(paths, image_size)
        return batch

    return load


def optimized_inference(model: ResNet50, mode: str, calibration=None,
                        image_size: int = 224, load_images=None,
                        percentile: float | None = None) -> ResNet50:
    """Apply a named inference-graph optimization to a trained model (JAX
    ``optimize.py:283-337``): ``"fold_bn"`` or ``"int8"``.  For int8,
    ``calibration`` is a uint8 ``[N, H, W, 3]`` array or image paths
    (decoded by ``load_images``, default the serving policy at
    ``image_size``), run in chunks of 64 whose last chunk is the final 64
    images; ``percentile`` clips each activation scale to that percentile
    of |activation|.  Returns the optimized model on ``model``'s device.
    A model without batch-norm (a Swin) raises ``ValueError``.
    """
    _require_batch_norm(model)
    if mode == "fold_bn":
        return fold_inference(model)
    if mode != "int8":
        raise ValueError(f"unknown optimize mode {mode!r}; choose "
                         "'fold_bn' or 'int8'")
    if calibration is None:
        raise ValueError(
            "optimize='int8' needs calibration= (a uint8 image array "
            "or image paths) to set the activation scales")
    groups = model.config["groups"]
    if groups != 1:
        logging.getLogger("openset_imagenet_tpu_torch").warning(
            "int8 quantization of grouped convolutions (groups=%d): the "
            "int8_conv kernel runs convs of fewer than 64 channels a group "
            "on its SIMT route, without tensor cores; prefer serving "
            "resnext* models unoptimized", groups)
    if isinstance(calibration, np.ndarray):
        images = calibration
    else:
        images = (load_images or _default_image_loader(image_size))(
            calibration)
    if images.shape[0] == 0:
        raise ValueError("optimize='int8': calibration is empty")
    if images.shape[1:3] != (image_size, image_size):
        raise ValueError(
            f"calibration images are {images.shape[1:3]}, the "
            f"model expects {(image_size, image_size)}")
    # Chunks of 64 with a full-size tail, as the JAX package cuts them.
    chunks = [images[i:i + 64] for i in range(0, images.shape[0], 64)]
    if len(chunks) > 1 and chunks[-1].shape[0] != 64:
        chunks[-1] = images[-64:]
    return quantize_inference(model, chunks, percentile=percentile)
