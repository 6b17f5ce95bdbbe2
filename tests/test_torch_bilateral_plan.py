"""Kernel BFV's launch plan on the CPU (ops.cuda.bilateral_volume
.launch_plan): the tiling the wrapper hands csrc/bilateral_volume.cu for a
level's shape and window.  For every window 1-129 and depths on both sides
of the kernel's chunk edges, the plan fits the H100's 232,448 bytes of
shared memory a block, its chunks cover every inner slice once with a slot
left for the weight sum, its blocks tile the level, and the tiling's
constants are the kernel's.  The kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""

import pathlib
import re

import pytest

from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume as bv

SRC = (pathlib.Path(bv.__file__).parents[2] / "csrc" /
       "bilateral_volume.cu")
# KITTI's and README_DEMO's frames, coarse pyramid levels, one pixel,
# fewer rows than a block owns
LEVELS = ((375, 1242), (375, 450), (188, 225), (24, 29), (6, 8), (1, 1),
          (3, 100))


def kernel_constants():
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (k\w+) = (\d+);", SRC.read_text())}


def test_plan_constants_are_the_kernels():
    c = kernel_constants()
    assert (bv.PIX, bv.ROWS, bv.STAGES, bv.MAX_SMEM, bv.MAX_WND) == (
        c["kPix"], c["kRows"], c["kStages"], c["kMaxSmem"], c["kMaxWnd"])
    assert max(wx for wx, _ in bv.BLOCKS) == c["kMaxWx"]
    assert max(wy for _, wy in bv.BLOCKS) == c["kMaxWy"]


@pytest.mark.parametrize("d", [3, 4, 33, 34, 61, 129, 130, 300])
def test_plan_fits_and_covers_every_slice_once(d):
    inner = d - 2
    for wnd in range(1, bv.MAX_WND + 1):
        for h, w in LEVELS:
            plan = bv.launch_plan(2, h, w, d, wnd)
            # the block's bytes: the ring's window rows, the guide's, the
            # warps' weight tables and the wrapped columns
            ring = 4 * bv.STAGES * (bv.PIX * plan.wx + wnd - 1) * 32 * \
                plan.dc
            assert plan.smem == bv.smem_bytes(plan.dc, plan.wx, plan.wy,
                                              wnd)
            assert ring < plan.smem <= bv.MAX_SMEM, (h, w, wnd, plan)
            # slices a lane: the fewest that hold the inner slices and
            # sw's slot, else 4 in chunks
            assert plan.dc == min([dc for dc in (1, 2, 4)
                                   if 32 * dc - 1 >= inner] or [4])
            # chunk c's slot k is inner slice c * per_chunk + k, held by
            # lane k // dc; slot cnt is sw's, inside the lane's 32 dc
            seen = [0] * inner
            for c in range(plan.chunks):
                cnt = min(plan.per_chunk, inner - c * plan.per_chunk)
                assert 1 <= cnt < 32 * plan.dc
                assert cnt // plan.dc < 32
                for k in range(cnt):
                    seen[c * plan.per_chunk + k] += 1
            assert seen == [1] * inner, (wnd, plan)
            # the blocks of PIX wx x ROWS wy pixels tile the level
            bh, bw = bv.ROWS * plan.wy, bv.PIX * plan.wx
            assert plan.blocks == 2 * plan.chunks * -(-w // bw) * -(-h // bh)


def test_plan_by_level():
    """4 x 2 warps a block where that still gives the H100's SMs two
    blocks each and fits (KITTI's and README_DEMO's levels), else 2 x 2
    (small levels, wide windows)."""
    assert bv.launch_plan(2, 375, 1242, 129, 35)[:5] == (4, 127, 1, 4, 2)
    assert bv.launch_plan(2, 375, 450, 61, 35)[:5] == (2, 59, 1, 4, 2)
    assert bv.launch_plan(2, 188, 225, 31, 35)[:5] == (1, 29, 1, 4, 2)
    assert bv.launch_plan(2, 94, 113, 16, 35)[3:5] == (2, 2)
    assert bv.launch_plan(2, 24, 29, 4, 35)[3:5] == (2, 2)
    assert bv.launch_plan(2, 375, 1242, 129, 129)[3:5] == (2, 2)
    assert bv.launch_plan(2, 40, 64, 300, 7)[:3] == (4, 100, 3)
    for h, w in LEVELS:
        for wnd in (1, 35, 129):
            plan = bv.launch_plan(2, h, w, 61, wnd)
            big = bv.smem_bytes(plan.dc, 4, 2, wnd) <= bv.MAX_SMEM and \
                2 * -(-w // 32) * -(-h // 4) >= bv.MIN_BLOCKS
            assert plan[3:5] == ((4, 2) if big else (2, 2))
