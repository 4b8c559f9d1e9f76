"""Forward (``inference.OpenSetPredictor``, ``train.make_forward_step``):
device milliseconds a traced chunk from the end event of one
``predict.dispatch`` span (``openset_imagenet_tpu_torch/tracing.py``) to
the start event of the next chunk's: the copies of the previous chunk's
results, and the card waiting for the next dispatch."""


def read(result):
    if result.kind != "predict":
        return None
    try:
        from openset_imagenet_tpu_torch import tracing
    except ImportError:  # a program without the span recorder
        return None
    starts, ends = {}, {}
    for r in tracing.snapshot():
        if r.name == "predict.dispatch" and r.device_t0 is not None:
            starts[r.key], ends[r.key] = r.device_t0, r.device_t1
    gaps = [starts[k + 1] - end for k, end in ends.items()
            if k + 1 in starts]
    return sum(gaps) / len(gaps) if gaps else None
