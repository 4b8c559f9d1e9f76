"""Train step (``train.make_train_step``, driven by ``train.train_epoch``
over ``pipeline.InputPipeline``): every image trained in the window over
its seconds on the host's clock, both ends after a device sync.  It is the
rate a user of the trainer sees, and it follows the host's speed while the
step is bound by the host; ``--trace 1`` runs measure the window without
the profiler."""


def read(result):
    if result.kind != "train":
        return None
    c = result.counters
    return c["window_images"] / c["window_s"]
