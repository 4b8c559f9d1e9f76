"""The host-side arithmetic of the port's kernels, on the CPU.

What the wrappers decide before a launch, so that it can be held here
where no kernel runs: the build key of a CUDA source (``ops/_build.py``
hashes the source and the headers it includes), K5's route and the rows
each block of its fused route walks (``ops/fused_block_bwd.py``), K6's
route, block counts and M-splits (``experimental/split_site.py``), the
grid of K1-K4 and the ticket the forwards' last program draws
(``ops/fused_loss.py``), and ``train.build_model``'s default device.
"""

import pathlib

import pytest
import torch

from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.experimental import split_site as ss
from openset_imagenet_tpu_torch.ops import _build
from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb
from openset_imagenet_tpu_torch.ops import fused_loss as fl

# Every resnet50 site at 224 px, batch 256: (M, ci, co, in_act, mask, ds).
RESNET50_SITES = [
    (802816, 64, 256, True, True, False),     # stage-1 tail
    (802816, 64, 64, False, False, False),    # stage-1 block-1 head
    (802816, 256, 64, False, False, True),    # stage-1 head
    (802816, 256, 128, False, False, False),  # stage-2 block-1 head
    (200704, 128, 512, True, True, False),    # stage-2 tail
    (200704, 512, 128, False, False, True),   # stage-2 head
    (200704, 512, 256, False, False, False),  # stage-3 block-1 head
    (50176, 256, 1024, True, True, False),    # stage-3 tail
    (50176, 1024, 256, False, False, True),   # stage-3 head
    (50176, 1024, 512, False, False, False),  # stage-4 block-1 head
    (12544, 512, 2048, True, True, False),    # stage-4 tail
    (12544, 2048, 512, False, False, True),   # stage-4 head
]


def test_source_key_covers_included_headers(tmp_path):
    header = tmp_path / "common.cuh"
    header.write_text("#pragma once\nconstexpr int K = 1;\n")
    source = tmp_path / "kernel.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "common.cuh"\n'
                      "int f() { return K; }\n")
    key = _build.source_key(source)
    assert len(key) == 16 and key == _build.source_key(source)
    header.write_text("#pragma once\nconstexpr int K = 2;\n")
    assert _build.source_key(source) != key   # a header edit rebuilds
    alone = tmp_path / "alone.cu"
    alone.write_text("int g() { return 3; }\n")
    assert _build.source_key(alone) == _build.source_key(alone)
    source.write_text('#include <cuda_runtime.h>\n#include "common.cuh"\n'
                      "int f() { return K + 0; }\n")
    assert _build.source_key(source) != key


@pytest.mark.parametrize("header", ["site_common.cuh", "hopper.cuh"])
def test_port_sources_key_their_shared_header(header, tmp_path):
    csrc = pathlib.Path(fbb.SOURCE).parent
    for name in ("fused_block_bwd.cu", "split_site.cu"):
        assert f'#include "{header}"' in (csrc / name).read_text()
        assert _build.source_key(csrc / name) == \
            _build.source_key(csrc / name)
        # An edit to the header changes the source's key.
        for f in (name, "site_common.cuh", "hopper.cuh"):
            (tmp_path / f).write_bytes((csrc / f).read_bytes())
        key = _build.source_key(tmp_path / name)
        (tmp_path / header).write_text((csrc / header).read_text() + "\n")
        assert _build.source_key(tmp_path / name) != key


@pytest.mark.parametrize("m", [1, 63, 64, 65, 300, 12544 + 77, 802816])
@pytest.mark.parametrize("blocks", [1, 7, 132])
def test_fused_rows_cover_every_row_once(m, blocks):
    tiles = -(-m // 64)
    blocks = min(blocks, tiles)
    ranges = fbb._row_ranges(m, blocks)
    assert len(ranges) == blocks
    covered = [r for begin, end in ranges for r in range(begin, end)] \
        if m < 100000 else None
    if covered is not None:
        assert covered == list(range(m))
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    for (_, end), (begin, _) in zip(ranges, ranges[1:]):
        assert end == begin and begin % 64 == 0
    sizes = [(end - begin + 63) // 64 for begin, end in ranges]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert fbb._row_ranges(m, blocks) == ranges   # shape and count alone


@pytest.mark.parametrize("site", RESNET50_SITES)
def test_every_resnet50_site_takes_a_tensor_core_route(site):
    m, ci, co, in_act, mask, ds = site
    route, parts = fbb._plan(m, ci, co, torch.bfloat16, in_act, mask, ds,
                             True, 132)
    if m == 802816:   # W fits beside two row tiles: one pass over the rows
        assert route == "fused" and parts == 132
        assert fbb._fused_smem(ci, co, in_act, mask, ds) <= fbb._SMEM_LIMIT
    else:
        assert route == "tiled" and parts >= 1
        # The kernel's M-splits (csrc launch_tiled): whole 64-row steps,
        # as many as planned, every row once; with the 128 x 128 tiles of
        # dW, at most one wave of two blocks per SM.
        rows = -(-(-(-m // parts)) // 64) * 64
        assert -(-m // rows) == parts and (parts - 1) * rows < m
        tiles = -(-ci // 128) * -(-co // 128)
        assert tiles * parts <= 2 * 132
    assert fbb._plan(m, ci, co, torch.float32, in_act, mask, ds, True,
                     132)[0] == "generic"
    assert fbb._plan(m, ci, co, torch.bfloat16, in_act, mask, ds, False,
                     132)[0] == "generic"


def test_ragged_sites_take_the_generic_route():
    assert fbb._plan(1003, 72, 40, torch.bfloat16, False, False, True, True,
                     132)[0] == "generic"
    assert fbb._plan(300, 64, 256, torch.bfloat16, False, False, True, True,
                     132) == ("fused", 5)
    # ds beside a 256 x 128 head does not fit two slots and W.
    assert fbb._plan(802816, 256, 128, torch.bfloat16, False, False, True,
                     True, 132)[0] == "tiled"


# Every resnet50 tail site at batch 256 (M, ci, co), the shapes of K6.
RESNET50_TAILS = [(802816, 64, 256), (200704, 128, 512), (50176, 256, 1024),
                  (12544, 512, 2048)]


@pytest.mark.parametrize("m,ci,co", RESNET50_TAILS)
def test_every_resnet50_tail_takes_k6_tensor_core_route(m, ci, co):
    plan = ss._plan(m, ci, co, torch.bfloat16, True, 132)
    assert plan.route == "tensor_cores"
    # k2: column tiles of up to 256 channels, so gp is read once at stages
    # 1-3 and twice at stage 4; blocks along M fill the card once.
    assert plan.bn == min(ci, 256) and -(-ci // plan.bn) == max(1, ci // 256)
    per_sm = 2 if 2 * ss._k2_smem(plan.bn, co) <= ss._SMEM_LIMIT else 1
    assert plan.p2 * -(-ci // plan.bn) <= 132 * per_sm
    assert ss._k2_smem(plan.bn, co) <= ss._SMEM_LIMIT
    assert ss._k4_smem(plan.bi) <= ss._SMEM_LIMIT
    tiles = -(-m // 64)
    ranges = ss.row_ranges(tiles, plan.p2)
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(e == b for (_, e), (b, _) in zip(ranges, ranges[1:]))
    assert all(e > b for b, e in ranges)
    # k4: the kernel's M-splits (csrc launch_tensor_cores) are whole
    # 64-row steps, as many as planned, every row once, one wave of one
    # block an SM.
    rows = -(-(-(-m // plan.splits)) // 64) * 64
    assert -(-m // rows) == plan.splits and (plan.splits - 1) * rows < m
    k4_tiles = -(-ci // plan.bi) * -(-co // 256)
    assert k4_tiles * plan.splits <= 132
    assert k4_tiles * plan.splits > 132 // 2
    # k1 and k3: contiguous ranges of row tiles, at most eight blocks an
    # SM, every tile once.
    for blocks, channels in ((plan.g1, co), (plan.g3, ci)):
        t = ss.stream_tiles(m, channels)
        ranges = ss.row_ranges(t, blocks)
        assert 1 <= blocks <= t and ranges[-1][1] == t
        assert all(e > b for b, e in ranges)
        assert all(e == b for (_, e), (b, _) in zip(ranges, ranges[1:]))
    # A function of the shape alone.
    assert ss._plan(m, ci, co, torch.bfloat16, True, 132) == plan


@pytest.mark.parametrize("m,ci,co,dtype,aligned", [
    (12544, 512, 2048, torch.float32, True),     # f32
    (12544 + 77, 512, 2048, torch.float32, True),
    (1003, 37, 21, torch.bfloat16, True),       # ragged channels
    (1000, 72, 40, torch.bfloat16, True),
    (802816, 64, 256, torch.bfloat16, False),   # rows off 16 bytes
])
def test_k6_other_sites_take_the_generic_route(m, ci, co, dtype, aligned):
    plan = ss._plan(m, ci, co, dtype, aligned, 132)
    assert plan.route == "generic" and (plan.bn, plan.bi) == (0, 0)
    assert plan.p2 == -(-m // 128)   # the SIMT k2's 128-row blocks
    assert plan.splits == fbb._splits(m, ci, co)
    assert ss._plan(m, ci, co, dtype, aligned, 132) == plan


def test_k6_ragged_m_takes_the_tensor_core_route():
    plan = ss._plan(12544 + 77, 512, 2048, torch.bfloat16, True, 132)
    assert plan.route == "tensor_cores"
    tiles = -(-(12544 + 77) // 64)
    assert ss.row_ranges(tiles, plan.p2)[-1][1] == tiles
    assert ss._plan(300, 64, 256, torch.bfloat16, True, 132).p2 == 5


# The one-launch forwards and their main path's shapes: K1 (entropic,
# 116 classes) and K3 (softmax / garbage, 117 with the garbage class).
ONE_LAUNCH = {"entropic_fwd": {(64, 116), (256, 116)},
              "ce_fwd": {(64, 117), (256, 117)}}


@pytest.mark.parametrize("kernel", sorted(ONE_LAUNCH))
@pytest.mark.parametrize("b,c", [(64, 117), (256, 117), (64, 116),
                                 (256, 116), (1000, 1000), (2, 8), (4099, 3),
                                 (200000, 16)])
def test_k3_grid_and_tickets(kernel, b, c):
    """K1's and K3's one-launch grid, and the ticket its last program
    draws."""
    tile_elems = fl._TILE_ELEMS[kernel]
    block_c, rows, tiles, grid = fl._grid(b, c, tile_elems)
    assert block_c >= c and block_c & (block_c - 1) == 0
    assert rows & (rows - 1) == 0
    assert rows * block_c <= max(tile_elems, block_c)
    n_tiles = -(-b // rows)
    assert 1 <= grid <= fl._MAX_PROGRAMS
    assert grid * tiles >= n_tiles > (grid - 1) * tiles   # no idle program
    assert (grid == 1) == (b <= rows)   # one program draws no ticket
    # The main path's shapes: two rows a program, one warp each.
    if (b, c) in ONE_LAUNCH[kernel]:
        assert (rows, tiles, grid) == (2, 1, b // 2)
        assert fl._warps(rows * block_c) == 1
    # The kernel is given last = grid - 1: the program that draws that
    # ticket adds every partial, each once, in index order.
    last = grid - 1
    summed = [i for start in range(0, last + 1, fl._SUM_BLOCK)
              for i in range(start, start + fl._SUM_BLOCK) if i <= last]
    assert summed == list(range(grid))


@pytest.mark.parametrize("kernel", ["entropic_bwd", "ce_bwd"])
@pytest.mark.parametrize("b,c", [(256, 116), (64, 116), (256, 117),
                                 (64, 117), (1000, 1000), (4099, 3)])
def test_k2_programs_cover_every_row_once(kernel, b, c):
    """K2's and K4's grid, chosen on the card: two-row programs of one warp
    at the main path's 116 (entropic, softmax) and 117 (garbage) classes."""
    block_c, rows = fl._tiling(c, fl._TILE_ELEMS[kernel])
    programs = -(-b // rows)
    assert programs * rows >= b > (programs - 1) * rows
    if c in (116, 117):
        assert (rows, programs, fl._warps(rows * block_c)) == (2, b // 2, 1)


def test_build_model_defaults_to_the_card():
    cfg = NameSpace({"model": {"variant": "tiny"}})
    assert next(pengine.build_model(cfg, 4, device="cpu").parameters()
                ).device.type == "cpu"
    if torch.cuda.is_available():
        model = pengine.build_model(cfg, 4)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pengine.build_model(cfg, 4)
