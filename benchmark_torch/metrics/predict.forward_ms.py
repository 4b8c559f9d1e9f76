"""Forward (``inference.OpenSetPredictor``, ``train.make_forward_step``):
device milliseconds a traced chunk between the two CUDA events of the
program's ``predict.dispatch`` span (``openset_imagenet_tpu_torch/
tracing.py``): the chunk's copy to the card and the forward, idle time
inside included."""


def read(result):
    if result.kind != "predict":
        return None
    try:
        from openset_imagenet_tpu_torch import tracing
    except ImportError:  # a program without the span recorder
        return None
    per_chunk = {}
    for r in tracing.snapshot():
        if r.name == "predict.dispatch" and r.device_ms is not None:
            per_chunk[r.key] = per_chunk.get(r.key, 0.0) + r.device_ms
    return sum(per_chunk.values()) / len(per_chunk) if per_chunk else None
