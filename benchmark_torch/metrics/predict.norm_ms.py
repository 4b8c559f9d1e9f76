"""Model (``models/norm.py`` through ``ops/batch_norm.py``): device
milliseconds a traced chunk in the batch-norm kernels, the profiler's
operations whose names hold ``osi_bn_`` (the eval forward's apply).  None
where no such kernel ran (a program whose batch-norm is written out in
torch)."""

FRAGMENT = "osi_bn_"


def read(result):
    p = result.profile
    if result.kind != "predict" or p is None:
        return None
    sec = sum(s for name, (s, _) in p["by_kernel"].items()
              if FRAGMENT in name)
    return 1e3 * sec / p["steps"] if sec > 0 else None
