"""Daemon (``serve.DynamicBatcher``): images a forward over the window,
the change in ``GET /stats`` images over the change in its batches."""


def read(result):
    if result.kind != "serve":
        return None
    batches = result.counters["stats_batches"]
    return result.counters["stats_images"] / batches if batches else None
