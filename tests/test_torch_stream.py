"""K7, the streaming probes, against the JAX tool's Pallas probes (CPU).

The port's :func:`axpy` and :func:`relu_mask` on CPU tensors (their plain
versions) against the Pallas kernels of ``tools/bench_pallas_stream.py``
of the JAX package, which run on the CPU under
``force_tpu_interpret_mode()``: bit equality at bf16 ``[2, 16, 256]`` and
``[3, 24, 256]`` (both round ``x * 1.0009765625`` to bf16 before adding
``b``), then over all 65,536 bf16 bit patterns: axpy's ``x`` (equal to
``torch.add(x, b)`` wherever ``x`` is not NaN, all NaN where it is) and
relu_mask's mask (equal to a mirror of the kernel's int16 compare
everywhere; ``threshold_backward`` differs on exactly the 254 NaN
masks).  Then the launch planner (every element covered exactly once,
for every configuration the launch sweep can pick), routing and
refusals, and the ported bench tool (its byte count equals the JAX
tool's; it runs on the host with ``--device cpu``).
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openset_imagenet_tpu_torch.ops import stream_probe as sp
from openset_imagenet_tpu_torch.tools import bench_stream as tool

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_pallas_stream", REPO / "tools" / "bench_pallas_stream.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bits(a):
    """bf16 values as their 16 bits (numpy)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    draws = [jnp.asarray(rng.standard_normal(shape) * 3, jnp.bfloat16)
             for _ in range(2)]
    as_torch = [torch.from_numpy(_bits(d).copy()).view(torch.bfloat16)
                for d in draws]
    return draws, as_torch


@pytest.mark.parametrize("shape", [(2, 16, 256), (3, 24, 256)])
@pytest.mark.parametrize("probe", ["axpy", "relu_mask"])
def test_probe_matches_pallas_bit_for_bit(probe, shape):
    jax_tool = _jax_tool()
    make = {"axpy": jax_tool.make_pallas_axpy,
            "relu_mask": jax_tool.make_pallas_relu_mask}[probe]
    (a, b), (ta, tb) = _operands(shape, seed=len(probe) + shape[0])
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(make(8)(a, b))
    before = dict(sp.LAUNCHES)
    got = getattr(sp, probe)(ta, tb)
    assert sp.LAUNCHES == before          # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_axpy_rounds_after_the_multiply():
    # In bf16 x * (1 + 2**-10) rounds back to x, so axpy is round(x + b);
    # one rounding of x * a + b would differ from it.
    (_, _), (x, b) = _operands((4, 8, 256), seed=5)
    assert torch.equal(sp.axpy(x, b), x + b)
    once = (x.float() * sp.AXPY_A + b.float()).to(torch.bfloat16)
    assert not torch.equal(once, x + b)


def test_relu_mask_keeps_g_where_the_mask_is_positive():
    (_, _), (g, m) = _operands((2, 8, 256), seed=6)
    m[0, 0, :4] = torch.tensor([0.0, -0.0, float("nan"), 1e-30])
    out = sp.relu_mask(g, m)
    assert torch.equal(out, torch.where(m.float() > 0, g, torch.zeros_like(g)))
    assert bool((out[0, 0, :3] == 0).all()) and out[0, 0, 3] == g[0, 0, 3]


def _every_bf16(shape=(1, 256, 256)):
    """All 65,536 bf16 bit patterns, in order, as a numpy bf16 array and a
    torch tensor."""
    bits = np.arange(-(1 << 15), 1 << 15, dtype=np.int16)
    return (bits.view(jnp.bfloat16).reshape(shape),
            torch.from_numpy(bits.copy()).view(torch.bfloat16).reshape(shape))


def _seeded(shape, seed):
    """A seeded bf16 operand with no zero (numpy and torch)."""
    draw = np.random.default_rng(seed).standard_normal(shape) * 3
    draw = np.where(draw == 0, 1.0, draw)
    jx = jnp.asarray(draw, jnp.bfloat16)
    return jx, torch.from_numpy(_bits(jx).copy()).view(torch.bfloat16)


def test_axpy_over_every_bf16_is_torch_add():
    """In bf16 ``x * 1.0009765625`` rounds back to ``x`` for every x, so
    the Pallas axpy, the plain version and ``torch.add(x, b)`` agree."""
    jx, x = _every_bf16()
    jb, b = _seeded(x.shape, seed=12)
    with pltpu.force_tpu_interpret_mode():
        pallas = _bits(jax.block_until_ready(
            _jax_tool().make_pallas_axpy(8)(jx, jb)))
    plain, add = _bits(sp.axpy_plain(x, b)), _bits(torch.add(x, b))
    nan = torch.isnan(x).numpy()
    assert nan.sum() == 2 * 127          # 254 NaN patterns
    for got in (plain, add):
        np.testing.assert_array_equal(got[~nan], pallas[~nan])
    for got in (plain, add, pallas):
        assert np.isnan(got.view(jnp.bfloat16)[nan].astype(np.float32)).all()
    # The multiply alone is the identity on every non-NaN value.
    np.testing.assert_array_equal(_bits(x * sp.AXPY_A)[~nan],
                                  _bits(x)[~nan])


def _relu_mask_bits(g, m):
    """A plain mirror of the kernel's compare: ``0 < bits <= 0x7F80`` on
    the mask's 16 bits as int16."""
    bits = m.view(torch.int16)
    return torch.where((bits > 0) & (bits <= 0x7F80), g,
                       torch.zeros_like(g))


def test_relu_mask_over_every_bf16_mask():
    jm, m = _every_bf16()
    jg, g = _seeded(m.shape, seed=13)
    with pltpu.force_tpu_interpret_mode():
        pallas = _bits(jax.block_until_ready(
            _jax_tool().make_pallas_relu_mask(8)(jg, jm)))
    plain = _bits(sp.relu_mask_plain(g, m))
    np.testing.assert_array_equal(_bits(_relu_mask_bits(g, m)), plain)
    # XLA on the CPU compares with denormals as zero, so JAX's relu-mask
    # gives 0 on the 127 positive subnormal masks, where the port (IEEE
    # compare, as torch's and the card's) keeps g; bit-equal elsewhere.
    bits = _bits(m)
    subnormal = (bits >= 0x0001) & (bits <= 0x007F)
    np.testing.assert_array_equal(plain != pallas, subnormal)
    assert (pallas[subnormal] == 0).all() and subnormal.sum() == 127
    # threshold_backward (``m <= 0 ? 0 : g``) passes g through on a NaN
    # mask: it differs on exactly the 254 NaN patterns.
    library = _bits(torch.ops.aten.threshold_backward(g, m, 0))
    differs = library != plain
    assert differs.sum() == 254
    np.testing.assert_array_equal(differs, torch.isnan(m).numpy())


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 6146048, 6422528])
def test_plan_covers_every_element_once(n):
    launches = set(tool.sweep_launches()) | set(sp.LAUNCH.values())
    assert len(launches) >= 180
    for launch in launches:
        tile, programs, warps = sp._plan(n, launch)
        assert (tile, warps) == (launch.tile, launch.warps)
        assert programs == (-(-n // tile) if launch.waves == 0 else
                            min(-(-n // tile), sp.SMS * launch.waves))
        seen = np.zeros(n, np.int8)
        for p, start, stop, masked in sp._schedule(n, tile, programs):
            assert 0 <= p < programs
            assert masked == (stop - start < tile)
            seen[start:stop] += 1
        assert (seen == 1).all(), launch


def test_launch_sweep_needs_the_card():
    with pytest.raises(SystemExit, match="on the card"):
        tool.main(["--launch-sweep", "--device", "cpu"])


def test_probes_route_and_refuse():
    (_, _), (x, b) = _operands((2, 8, 256), seed=7)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sp.axpy(x.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sp.relu_mask(x.to("meta"), b.to("meta"))
    # What the kernels refuse, checked before any launch.
    sp._check_operands("axpy", x, b)
    with pytest.raises(TypeError, match="bfloat16"):
        sp._check_operands("axpy", x.float(), b)
    with pytest.raises(ValueError, match="one shape"):
        sp._check_operands("axpy", x, b[:, :4])
    with pytest.raises(ValueError, match="non-empty"):
        sp._check_operands("relu_mask", x[:0], b[:0])
    with pytest.raises(ValueError, match="contiguous"):
        sp._check_operands("relu_mask", x.transpose(1, 2),
                           b.transpose(1, 2))
    with pytest.raises(ValueError, match="operands on"):
        sp._check_operands("axpy", x, b.to("meta"))


def test_tool_byte_count_matches_jax_tool(monkeypatch):
    jax_tool = _jax_tool()
    seen = []

    def bandwidth(fn, args, nbytes, iters=10, warmup=3):
        seen.append(nbytes)
        return 1.0

    monkeypatch.setattr(jax_tool, "bandwidth", bandwidth)
    shape = (8, 16, 256)
    jax_tool.run_shape(shape, 8)
    assert seen == [tool.stream_bytes(shape)] * 4
    # 38.5 MB at the default shape: 11.5 us at 3.35 TB/s.
    assert tool.stream_bytes((8, 3136, 256)) == 38535168


def test_tool_runs_on_the_host(capsys):
    assert tool.main(["--device", "cpu", "--rows", "16", "--iters", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["case"] for r in lines] == ["torch_axpy", "torch_relu_mask",
                                          "triton_axpy", "triton_relu_mask"]
    for r in lines:
        assert r["shape"] == [8, 16, 256] and r["device"] == "cpu"
        assert np.isfinite(r["gb_per_s"]) and r["ms"] > 0
        assert r["card"] is None and r["share_of_peak"] is None
        assert all(v == 0 for v in r["launches"].values())
