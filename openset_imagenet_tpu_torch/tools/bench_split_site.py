"""Tail-site backward microbench on one NVIDIA card: plain torch, K5, K6.

Port of the JAX package's ``tools/bench_split_site.py``.  It answers one
question: do four lean streaming kernels (K6, the split form) beat the
unified site backward (K5) on this card?  Three cases on the same inputs:

* ``torch_plain``  -- :func:`..ops.fused_block_bwd.bwd_site_plain`, the
  site in plain torch (the counterpart of ``xla_jnp``);
* ``cuda_unified`` -- K5's tail form through ``bwd_site``;
* ``cuda_split``   -- K6 through
  :func:`..experimental.split_site.tail_site_split`.

The default shape is the resnet50 stage-1 tail site at batch 256: M =
256*56*56 rows, ci = 64, co = 256, bf16.  Each run chains ``CHAIN`` site
calls, feeding gp -> g and dx -> x and folding every small output into a
scalar, as the JAX tool's ``fori_loop`` does; on the card a run is
captured once in a CUDA graph and its replays are timed with CUDA events
(after two warm-up runs), so the time is the device's, without the host's
launch overhead.  Prints one JSON line per case: ms per
site call, the nominal bytes of the JAX tool's ``site_bytes`` and the
rate they imply, the least time the card could take for the site
(``bound_ms``: the bytes the function must move, each input read once and
each output written once, against the two products' bf16 operations; see
:mod:`._card`), its share of the measured time, the launches of each
kernel during the case, and the card's name and power limit.  A case that
fails, or a result that is not finite, ends the tool with an error.

    python -m openset_imagenet_tpu_torch.tools.bench_split_site \\
        [--batch 256] [--ci 64] [--co 256] [--iters 5] [--device cuda]

On the card each line also holds each kernel's device ms per site call
(``kernel_ms_per_site``), from one more eager run under
``torch.profiler``: K6's four kernels and its reduction apart.  The split
case adds each stage's own bound (``stage_bound_ms``, from its bytes), its
kernel's ms (``stage_ms``: k2 and k4 on either route) and the share of the
bound that kernel reaches (``stage_share``), and K6's route.
``--device cpu`` runs the same cases through the plain versions on the
host (for a check of the tool; its times are the host's).
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Callable, List, Optional

import torch

from ..experimental import split_site
from ..ops import fused_block_bwd as fbb
from . import _card

CHAIN = 8


def site_bytes(m: int, ci: int, co: int, split: bool) -> int:
    """Nominal bytes of one site call in bf16, as the JAX tool counts
    them (the split form re-reads gp twice and x once, and dxa
    round-trips)."""
    if split:
        reads = m * co * 3 + m * co * 4 + m * ci * 4 + (m * co * 2 +
                                                        m * ci * 2)
        writes = m * co * 2 + m * ci * 2 + m * ci * 2
    else:
        reads = m * co * 2 + m * co * 2 + m * co * 1 + m * ci * 2
        writes = m * co * 2 + m * ci * 2
    return reads + writes


def stage_bytes(m: int, ci: int, co: int, itemsize: int = 2) -> dict:
    """Bytes each kernel of the split form moves, as ``site_bytes``
    counts them: k1 reads g and the int8 mask and writes gp, k2 reads gp
    and z and writes dxa, k3 reads dxa and x and writes dx, k4 reads gp
    and x."""
    return {"k1_gate": m * co * (2 * itemsize + 1),
            "k2_dxa": m * (2 * co + ci) * itemsize,
            "k3_dx": 3 * m * ci * itemsize,
            "k4_dw": m * (co + ci) * itemsize}


def stage_of(kernel: str) -> Optional[str]:
    """The split stage a K6 kernel's profiled name belongs to (both routes'
    k2 and k4), or None."""
    for stage in ("k1_gate", "k2_dxa", "k3_dx", "k4_dw"):
        if kernel.startswith(stage):
            return stage
    return None


def function_bytes(m: int, ci: int, co: int, itemsize: int = 2) -> int:
    """Bytes the tail site must move: g, z, the int8 mask, x, W and the
    three float32 vectors read once; gp, dx, the float32 dW and the four
    float32 sums written once."""
    reads = (m * co * (2 * itemsize + 1) + m * ci * itemsize +
             ci * co * itemsize + 4 * (co + 2 * ci))
    writes = m * (co + ci) * itemsize + 4 * ci * co + 4 * 2 * (co + ci)
    return reads + writes


def function_flops(m: int, ci: int, co: int) -> int:
    """Operations of the two products (dxa = dz W^T, dW = xa^T dz)."""
    return 4 * m * ci * co


def site_inputs(m: int, ci: int, co: int, dtype: torch.dtype,
                device: torch.device, seed: int = 0):
    """``(g, z, mask, x, w, mul_o, mul_i, add_i)``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, dt=dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(dt)

    mask = torch.randint(0, 2, (m, co), generator=gen,
                         device=device).to(torch.int8)
    return (draw(m, co), draw(m, co), mask, draw(m, ci),
            draw(ci, co, scale=0.05), draw(co, dt=torch.float32),
            draw(ci, dt=torch.float32), draw(ci, dt=torch.float32))


def cases(zeros_o: torch.Tensor) -> List[tuple]:
    """``(name, site(g, z, mask, x, w, mul_o, mul_i, add_i), split)``."""
    def plain(g, z, mask, x, w, mul_o, mul_i, add_i):
        return fbb.bwd_site_plain(g, z, mask, x, None, w, mul_o, zeros_o,
                                  mul_i, add_i, in_act=True, emit_gp=True)

    def unified(g, z, mask, x, w, mul_o, mul_i, add_i):
        return fbb.bwd_site(g, z, mask, x, None, w, mul_o, zeros_o, mul_i,
                            add_i, in_act=True, emit_gp=True)

    return [("torch_plain", plain, False),
            ("cuda_unified", unified, False),
            ("cuda_split", split_site.tail_site_split, True)]


def make_runner(site: Callable, g, z, mask, x, w, mul_o, mul_i, add_i):
    """One run: ``CHAIN`` site calls, gp -> g and dx -> x; returns the
    scalar every small output is folded into."""
    def run():
        gg, xx = g, x
        acc = torch.zeros((), dtype=torch.float32, device=g.device)
        for _ in range(CHAIN):
            dx, gp, dw, (smo, sao), (smi, sai) = site(
                gg, z, mask, xx, w, mul_o, mul_i, add_i)
            acc = (acc + dw.sum() + smo.sum() + sao.sum() + smi.sum() +
                   sai.sum())
            gg, xx = gp, dx
        return acc

    return run


def kernel_ms(run: Callable) -> dict:
    """Device ms per site call of each kernel of one run (torch.profiler),
    by kernel name without its argument list."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        if event.self_device_time_total > 0:
            name = event.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + \
                event.self_device_time_total / 1e3 / CHAIN
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ci", type=int, default=64)
    ap.add_argument("--co", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_split_site: no CUDA device (--device cpu "
                         "runs the plain versions on the host)")
    card = _card.card_line() if device.type == "cuda" else None
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    m, ci, co = args.batch * 56 * 56, args.ci, args.co
    inputs = site_inputs(m, ci, co, torch.bfloat16, device)
    bound, bound_by = _card.bound_ms(function_bytes(m, ci, co),
                                     function_flops(m, ci, co))
    # Launches counted while a case runs: two warm-up runs and the one
    # captured in the graph (its replays launch nothing from the host).
    counters = (fbb.LAUNCHES, split_site.LAUNCHES)
    for case, site, split in cases(torch.zeros_like(inputs[5])):
        before = {k: v for c in counters for k, v in c.items()}
        run = make_runner(site, *inputs)
        ms, acc = _card.ms_per_run(run, args.iters, device, warmup=2)
        if not math.isfinite(float(acc)):
            raise RuntimeError(f"{case}: non-finite accumulator {float(acc)}")
        ms /= CHAIN
        per_kernel = kernel_ms(run) if card else None
        nb = site_bytes(m, ci, co, split)
        stage_bound = ({k: _card.bound_ms(b)[0] for k, b in
                        stage_bytes(m, ci, co).items()} if split else None)
        stage_ms = None
        if split and per_kernel:
            stage_ms = {}
            for kernel, kms in per_kernel.items():
                if stage_of(kernel):
                    stage_ms[stage_of(kernel)] = \
                        stage_ms.get(stage_of(kernel), 0.0) + kms
        print(json.dumps({
            "case": case, "ms_per_site": ms, "nominal_gb": nb / 1e9,
            "gb_per_s": nb / (ms / 1e3) / 1e9, "bound_ms": bound,
            "bound_by": bound_by,
            "share_of_bound": bound / ms if card else None,
            "m": m, "ci": ci, "co": co, "dtype": "bf16", "chain": CHAIN,
            "iters": args.iters,
            "launches": {k: v - before[k] for c in counters
                         for k, v in c.items()},
            "kernel_ms_per_site": per_kernel,
            "stage_bound_ms": stage_bound,
            "stage_ms": stage_ms,
            "stage_share": ({k: stage_bound[k] / v for k, v in
                             stage_ms.items()} if stage_ms else None),
            "route": (split_site._plan(m, ci, co, torch.bfloat16, True,
                                       fbb._sm_count(device.index or 0)
                                       ).route
                      if split and card else None),
            "device": name,
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
