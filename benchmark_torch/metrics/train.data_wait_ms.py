"""Input pipeline (``pipeline.InputPipeline``): mean milliseconds a step
of the window waited in ``next()`` on the epoch's iterator that
``train_epoch`` consumes (the harness's ``pipeline.next`` span)."""


def read(result):
    waits = result.counters.get("data_wait_s") if result.kind == "train" \
        else None
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
