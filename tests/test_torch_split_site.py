"""K6, the split tail-site backward, against the JAX package (CPU).

The port's :func:`tail_site_split` on CPU tensors (its plain version)
against the JAX ``tail_site_split`` run through its Pallas kernels in
interpret mode, on the same inputs made with numpy (``_site_inputs`` of
``tests/test_fused_block.py``), at m = 512, ci = 16, co = 24:

* float32: every output within rtol and atol 1e-5;
* bfloat16: gp exact, dx within rtol and atol 1e-2 (one bf16 ulp of dxa,
  which the two round after products summed in another order), dW and the
  four channel sums within 1e-4 relative in norm.

Against the port's unified site (K5's ``bwd_site_plain``) the split
differs only by rounding dxa to the activation dtype: within 8e-2 in
bf16 and 1e-5 in float32, the JAX test's bounds
(``tests/test_split_site.py:66-78``).  Then routing and refusals, and the
ported bench tool (its byte counts equal the JAX tool's; it runs on the
host with ``--device cpu``).
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu.experimental.split_site import (
    tail_site_split as jax_split)
from openset_imagenet_tpu_torch.experimental import split_site as ss
from openset_imagenet_tpu_torch.ops.fused_block_bwd import bwd_site_plain
from openset_imagenet_tpu_torch.tools import bench_split_site as tool
from tests.test_fused_block import _site_inputs

REPO = pathlib.Path(__file__).resolve().parents[1]
M, CI, CO = 512, 16, 24
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _torch(a):
    """A JAX array as a torch tensor of the same dtype and bits."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a).view(np.uint16).astype(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _inputs(dtype):
    g, z, mask, x, _, w, mul_o, add_o, mul_i, add_i = _site_inputs(
        M, CI, CO, dtype)
    return (g, z, mask, x, w, mul_o, mul_i, add_i), add_o


def _flat(out):
    dx, gp, dw, (smo, sao), (smi, sai) = out
    return {"dx": dx, "gp": gp, "dw": dw, "s_mul_o": smo, "s_add_o": sao,
            "s_mul_i": smi, "s_add_i": sai}


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _rel(a, b):
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_split_matches_jax_split(name):
    jdt, tdt = DTYPES[name]
    args, _ = _inputs(jdt)
    ref = _flat(jax_split(*args, out_dtype=jdt, interpret=True))
    before = dict(ss.LAUNCHES)
    got = _flat(ss.tail_site_split(*map(_torch, args)))
    assert ss.LAUNCHES == before          # CPU tensors: the plain version
    assert got["dx"].dtype == got["gp"].dtype == tdt
    assert got["dw"].dtype == torch.float32
    for key, want in ref.items():
        assert tuple(got[key].shape) == want.shape, key
    if name == "float32":
        for key, want in ref.items():
            np.testing.assert_allclose(_f32(got[key]), _f32(want),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        return
    np.testing.assert_array_equal(_f32(got["gp"]), _f32(ref["gp"]))
    np.testing.assert_allclose(_f32(got["dx"]), _f32(ref["dx"]), rtol=1e-2,
                               atol=1e-2)
    for key in ("dw", "s_mul_o", "s_add_o", "s_mul_i", "s_add_i"):
        assert _rel(got[key], ref[key]) <= 1e-4, key


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_split_matches_unified_site(name):
    jdt, tdt = DTYPES[name]
    args, add_o = _inputs(jdt)
    g, z, mask, x, w, mul_o, mul_i, add_i = map(_torch, args)
    split = _flat(ss.tail_site_split_plain(g, z, mask, x, w, mul_o, mul_i,
                                           add_i))
    unified = _flat(bwd_site_plain(g, z, mask, x, None, w, mul_o,
                                   _torch(add_o), mul_i, add_i, in_act=True,
                                   emit_gp=True))
    tol = 8e-2 if name == "bfloat16" else 1e-5
    for key, want in unified.items():
        np.testing.assert_allclose(_f32(split[key]), _f32(want), rtol=tol,
                                   atol=tol, err_msg=key)


def _torch_args(dtype=torch.float32, m=64, ci=8, co=16):
    rng = np.random.default_rng(3)
    t = lambda *s, dt=dtype: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dt)
    mask = torch.from_numpy(rng.integers(0, 2, (m, co)).astype(np.int8))
    return [t(m, co), t(m, co), mask, t(m, ci), t(ci, co),
            t(co, dt=torch.float32), t(ci, dt=torch.float32),
            t(ci, dt=torch.float32)]


def test_split_routes_and_refuses():
    args = _torch_args()
    before = dict(ss.LAUNCHES)
    got = ss.tail_site_split(*args)
    assert ss.LAUNCHES == before
    for a, b in zip(_flat(got).values(),
                    _flat(ss.tail_site_split_plain(*args)).values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ss.tail_site_split(*[a.to("meta") for a in args])
    # What the kernels refuse, checked before any build or launch.
    assert ss._check_site(*args, None) == (64, 8, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ss._check_site(*[a.half() if a.dtype == torch.float32 and a.dim() == 2
                         else a for a in args], None)
    with pytest.raises(TypeError, match="out_dtype"):
        ss._check_site(*args, torch.bfloat16)
    bad = list(args)
    bad[2] = None
    with pytest.raises(ValueError, match="int8 mask"):
        ss._check_site(*bad, None)
    bad = list(args)
    bad[2] = args[2].bool()
    with pytest.raises(TypeError, match="mask must be torch.int8"):
        ss._check_site(*bad, None)
    bad = list(args)
    bad[4] = args[4].t().contiguous()
    with pytest.raises(ValueError, match=r"w must be \(8, 16\)"):
        ss._check_site(*bad, None)
    bad = list(args)
    bad[3] = args[3].t().contiguous().t()
    with pytest.raises(ValueError, match="row-major"):
        ss._check_site(*bad, None)
    bad = list(args)
    bad[0] = args[0][:0]
    with pytest.raises(ValueError, match="non-empty"):
        ss._check_site(*bad, None)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_split_site", REPO / "tools" / "bench_split_site.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("m,ci,co", [(802816, 64, 256), (12544, 512, 2048),
                                     (1003, 37, 21)])
def test_tool_byte_counts_match_jax_tool(m, ci, co):
    jax_tool = _jax_tool()
    for split in (False, True):
        assert tool.site_bytes(m, ci, co, split) == \
            jax_tool.site_bytes(m, ci, co, split)
    assert sum(tool.stage_bytes(m, ci, co).values()) == \
        jax_tool.site_bytes(m, ci, co, True)
    # The function moves 2,048 bytes a row at the stage-1 tail in bf16
    # (the unified kernel's nominal bytes), plus W, dW and the vectors.
    if (ci, co) == (64, 256):
        small = 64 * 256 * 2 + 64 * 256 * 4 + 4 * (256 + 128) + 8 * 320
        assert tool.function_bytes(m, ci, co) == 2048 * m + small
        assert tool.site_bytes(m, ci, co, False) == 2048 * m


def test_tool_runs_on_the_host(capsys):
    assert tool.main(["--device", "cpu", "--batch", "1", "--iters", "1",
                      "--ci", "16", "--co", "24"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["case"] for r in lines] == ["torch_plain", "cuda_unified",
                                          "cuda_split"]
    for r in lines:
        assert (r["m"], r["ci"], r["co"], r["device"]) == (3136, 16, 24,
                                                           "cpu")
        assert np.isfinite(r["ms_per_site"]) and r["ms_per_site"] > 0
        assert r["card"] is None and r["share_of_bound"] is None
        assert r["kernel_ms_per_site"] is None
        assert all(v == 0 for v in r["launches"].values())
    assert lines[2]["nominal_gb"] > lines[1]["nominal_gb"]
    assert lines[0]["stage_bound_ms"] is None
    assert sorted(lines[2]["stage_bound_ms"]) == ["k1_gate", "k2_dxa",
                                                  "k3_dx", "k4_dw"]
