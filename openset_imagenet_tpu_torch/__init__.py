"""PyTorch port of :mod:`openset_imagenet_tpu` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its module
layout (``models/resnet.py``, ``ops/fused_loss.py``, ``train.py``,
``inference.py`` ...) so each function has a counterpart of the same name.
It imports ``torch`` and ``numpy`` only -- never ``jax`` or the JAX
package -- and nothing here is imported before it is first used: the
public names below resolve lazily on attribute access.

What runs today is the serving slice and the whole training run: the
two-head ResNet (eval and train mode, full-batch and ghost batch-norm,
and the fused-backward bottleneck of ``model.fused_blocks`` with its
CUDA C++ site kernel), the weight bridge (parameters and optimizer
state), the three losses (forwards and backwards as hand-written Triton
kernels on CUDA tensors), the confidence metrics, the dataset index, the
input pipeline (with the native JPEG batch reader), the optimizer and
schedules (with ``opt.ema`` and ``opt.accumulate_steps``), the train and
eval steps and epoch loops, the worker (``worker(cfg)``: label surgery,
``_curr`` / ``_best`` checkpoints written atomically and in the
background, γ selection, resume, preemption, early stopping, the scalar
record and log file; ``python -m openset_imagenet_tpu_torch.script.train``),
:class:`OpenSetPredictor` (image paths or arrays, ``predict_stream``)
with the HTTP daemon (``serve``) and the CLIs ``script.predict`` and
``script.serve``, and the work after training: extraction
(``get_arrays``), OSCR on the host and on the device
(``calculate_oscr``, ``calculate_oscr_torch``), and the CLIs
``script.evaluate``, ``script.plot_all``, ``script.train_all`` and
``script.protocols`` (with ``protocol`` and ``wordnet``).  matplotlib
(``plots``) and PyYAML (configs) are imported only by what needs them.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "ResNet50": "models.resnet",
    "build_resnet": "models.resnet",
    "entropic_openset_loss": "ops.losses",
    "softmax_loss": "ops.losses",
    "garbage_loss": "ops.losses",
    "AverageMeter": "ops.losses",
    "entropic_openset_loss_fused": "ops.fused_loss",
    "softmax_loss_fused": "ops.fused_loss",
    "garbage_loss_fused": "ops.fused_loss",
    "confidence": "ops.metrics",
    "OpenSetPredictor": "inference",
    "ImagenetDataset": "dataset",
    "InputPipeline": "pipeline",
    "pipeline_from_dataset": "pipeline",
    "build_optimizer": "train",
    "create_state": "train",
    "make_train_step": "train",
    "train_epoch": "train",
    "worker": "train",
    "EarlyStopping": "ops.losses",
    "AsyncCheckpointer": "checkpoint",
    "get_arrays": "train",
    "calculate_oscr": "ops.oscr",
    "calculate_oscr_torch": "ops.oscr",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
    return getattr(module, name)
