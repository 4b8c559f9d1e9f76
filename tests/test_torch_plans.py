"""The host-side arithmetic of the port's kernels, on the CPU.

What the wrappers decide before a launch, so that it can be held here
where no kernel runs: the build key of a CUDA source (``ops/_build.py``
hashes the source and the headers it includes), K5's route and the rows
each block of its fused route walks (``ops/fused_block_bwd.py``), the
grid of K1 and K3 and the ticket their last program draws
(``ops/fused_loss.py``), and ``train.build_model``'s default device.
"""

import pathlib

import pytest
import torch

from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.config import NameSpace
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


def test_port_sources_key_their_shared_header():
    csrc = pathlib.Path(fbb.SOURCE).parent
    for name in ("fused_block_bwd.cu", "split_site.cu"):
        assert '#include "site_common.cuh"' in (csrc / name).read_text()
        assert _build.source_key(csrc / name) == \
            _build.source_key(csrc / name)


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
    # One program holding every row, the grid chip_smoke.py times beside.
    assert fl._grid(b, c, None) == (block_c, 1 << (b - 1).bit_length(), 1,
                                    1)


@pytest.mark.parametrize("b,c", [(256, 116), (64, 116), (1000, 1000),
                                 (4099, 3)])
def test_k2_programs_cover_every_row_once(b, c):
    """K2's grid, chosen on the card: two-row programs of one warp at the
    main path's 116 classes."""
    block_c, rows = fl._tiling(c, fl._TILE_ELEMS["entropic_bwd"])
    programs = -(-b // rows)
    assert programs * rows >= b > (programs - 1) * rows
    if c == 116:
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
