"""Train step (``train.make_train_step``): the window's model FLOPs (3x
the forward's, counted from the configuration's shapes) over its seconds,
as a share of one card's 989 TFLOP/s bf16 peak."""

from benchmark_torch.lib import card, flops


def read(result):
    if result.kind != "train":
        return None
    c = result.counters
    rate = flops.train_flops(result.config) * c["window_images"] / \
        c["window_s"]
    return 100.0 * rate / card.BF16_FLOP_PER_S
