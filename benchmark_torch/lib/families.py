"""A configuration's family: the module that knows its architecture.

A configuration file names its family under ``"family"`` (``"resnet"``
when the key is absent); :func:`of` imports ``benchmark_torch.lib.
family_<name>`` (``lib/family_<name>.py``).  The generators, ``calibrate.py``
and the FLOP readers reach the model only through it, so a configuration
of another architecture comes in as a family file, a configuration file
and its cells, with no edit to them.

Every family provides:

* ``make_weights(cfg, seed, device)``: seeded float32 weights, a name ->
  tensor map that the program's model (built from ``model_options``)
  takes with ``load_state_dict(strict=True)``.
* ``param_names(cfg)``: the names of ``make_weights`` that are trained
  (its buffers, such as running statistics, left out).
* ``train_steps(w0, batches, cfg, steps=3, quant=None)``: the plain
  reference's Adam steps from ``w0`` on ``batches`` (a list of ``(uint8
  images, int labels)``), as ``(losses, first logits, first gradient norms
  by leaf, change norms by leaf)``, the tuple
  :func:`.compare.train_numbers` reads.
* ``eval_logits(w, images_u8, cfg, quant=None)``: the reference's
  eval-mode float32 logits.
* ``calibrate_running_stats(w, images_u8, cfg)``: ``w`` with its running
  statistics taken from ``images_u8``; the identity for a family that has
  none.
* ``forward_flops(cfg)`` and ``train_flops(cfg)``: the FLOPs of one
  image's forward and of one trained image, from the shapes alone.
* ``model_options(cfg)``: the options the program's ``train.build_model``
  receives under ``model``, and the checkpoint under ``extra.arch``.
* ``control_quant``: the precision below the configuration's, which
  ``quant=`` of ``train_steps`` and ``eval_logits`` takes: the control
  that ``calibrate.py`` reads, and that has to come out not correct.

:func:`of` refuses a family that lacks any of these.

The reference imports no module of the program, and the program's model
returns ``(logits, features)``.
"""

from __future__ import annotations

import importlib
from types import ModuleType

CONTRACT = ("make_weights", "param_names", "train_steps", "eval_logits",
            "calibrate_running_stats", "forward_flops", "train_flops",
            "model_options", "control_quant")


def of(cfg: dict) -> ModuleType:
    """The family module of configuration ``cfg``."""
    name = cfg.get("family", "resnet")
    module = f"{__package__}.family_{name}"
    path = f"benchmark_torch/lib/family_{name}.py"
    try:
        family = importlib.import_module(module)
    except ModuleNotFoundError as exc:
        if exc.name != module:
            raise
        raise SystemExit(
            f"configuration {cfg.get('name')!r} names the family {name!r}, "
            f"and {path} is not there") from None
    missing = [k for k in CONTRACT if getattr(family, k, None) is None]
    if missing:
        raise SystemExit(f"the family {name!r} ({path}) lacks "
                         f"{', '.join(missing)} of the contract in "
                         "benchmark_torch/lib/families.py")
    return family
