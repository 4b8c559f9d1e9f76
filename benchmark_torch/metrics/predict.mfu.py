"""Forward (``inference.OpenSetPredictor``, ``train.make_forward_step``):
the window's forward FLOPs (the family's ``forward_flops``, counted from
the configuration's shapes) over its seconds, as a share of one card's
989 TFLOP/s bf16 peak."""

from benchmark_torch.lib import card, families


def read(result):
    if result.kind != "predict":
        return None
    c = result.counters
    flops = families.of(result.config).forward_flops(result.config)
    rate = flops * c["window_images"] / c["window_s"]
    return 100.0 * rate / card.BF16_FLOP_PER_S
