"""Shared pieces of the benchmark's CPU tests: a tiny configuration of
the two-head ResNet (the ``tiny50`` bottleneck variant at 32 px) and a
run context on the CPU."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark_torch.lib import harness  # noqa: E402

TINY = {"name": "tiny50-p1", "variant": "tiny50",
        "stage_sizes": [1, 1, 1, 1], "width": 8, "base_width": 64,
        "groups": 1, "image_size": 32, "fc_layer_dim": 6, "n_classes": 6,
        "loss": "entropic", "optimizer": "adam", "lr": 1e-3, "batch": 16,
        "bn_stats_rows": 8, "negative_share": 0.3}


def traffic(name: str, **over) -> dict:
    with open(ROOT / "benchmark_torch" / "traffic" / f"{name}.json") as f:
        t = json.load(f)
    t.update(over)
    return t


def limits() -> dict:
    with open(ROOT / "benchmark_torch" / "configs" / "resnet50-p1.json") as f:
        return json.load(f)["limits"]


@pytest.fixture
def make_ctx(tmp_path):
    import torch

    def make(kind_traffic: dict, seed: int = 7, seconds: float = 0.5,
             trace: bool = False, config: dict = None):
        cfg = dict(TINY if config is None else config)
        cfg.setdefault("limits", limits())
        return harness.Ctx(cell={"name": "tiny"}, config=cfg,
                           traffic=kind_traffic, seed=seed, seconds=seconds,
                           trace=trace, device=torch.device("cpu"),
                           t_process=0.0, out_dir=tmp_path)

    return make
