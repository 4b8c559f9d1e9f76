"""The two-head ResNet family (:mod:`.families`): the reference and the
seeded weights of :mod:`.reference`, the FLOP count of :mod:`.flops`."""

from .flops import forward_flops, train_flops  # noqa: F401
from .reference import (calibrate_running_stats, eval_logits,  # noqa: F401
                        make_weights, param_names, train_steps)

control_quant = "fp8"


def model_options(cfg: dict) -> dict:
    return {"variant": cfg["variant"],
            "bn_stats_rows": int(cfg["bn_stats_rows"])}
