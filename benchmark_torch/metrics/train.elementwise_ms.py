"""Model (``models/resnet.py``, ``models/norm.py``): device milliseconds a
step in the profiler's ``elementwise`` and ``copy`` categories."""


def read(result):
    p = result.profile
    if result.kind != "train" or p is None:
        return None
    cat = p["by_cat"]
    ms = 1e3 * (cat.get("elementwise", 0.0) + cat.get("copy", 0.0))
    return ms / p["steps"] if ms > 0 else None
