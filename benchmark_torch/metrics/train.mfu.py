"""Train step (``train.make_train_step``): the window's model FLOPs (the
family's ``train_flops``, 3x the forward's, counted from the
configuration's shapes) over its seconds, as a share of one card's 989
TFLOP/s bf16 peak."""

from benchmark_torch.lib import card, families


def read(result):
    if result.kind != "train":
        return None
    c = result.counters
    flops = families.of(result.config).train_flops(result.config)
    rate = flops * c["window_images"] / c["window_s"]
    return 100.0 * rate / card.BF16_FLOP_PER_S
