"""Device time of a traced step in kernels that one layer launches, by
fragments of their names (lower-cased), over the reduced trace's
``by_kernel`` (:func:`.profile.summarize`).

``ATTENTION``: the kernels of ``F.scaled_dot_product_attention``
(PyTorch's memory-efficient ``fmha_cutlassF`` / ``fmha_cutlassB`` of
``PyTorchMemEffAttention``, the flash kernels, cuDNN's).  ``LAYER_NORM``:
torch's LayerNorm kernels, forward and backward (the gradients of the
input and of the scale and bias).
"""

from __future__ import annotations

from typing import Optional

ATTENTION = ("fmha_cutlass", "memeffattention", "flash_fwd", "flash_bwd",
             "cudnn_sdpa")
LAYER_NORM = ("layer_norm", "layernorm", "gammabetabackward")


def step_ms(profile: Optional[dict], fragments) -> Optional[float]:
    """Milliseconds a step in the kernels whose names hold one of
    ``fragments``; None without a trace or where none ran."""
    if profile is None:
        return None
    sec = sum(s for name, (s, _) in profile["by_kernel"].items()
              if any(f in name.lower() for f in fragments))
    return 1e3 * sec / profile["steps"] if sec > 0 else None
