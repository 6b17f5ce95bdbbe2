"""The fly kernel's launch plan on the CPU (ops.cuda.fly_cost.launch_plan):
the design and tiling the wrapper hands csrc/fly_cost.cu for a call's
shape.  Every launch of the no-volume KITTI schedule takes the shared-row
design in either lerp (cost: K5, K7; image: K6), a window and range too
wide for the rings fall back to one sample at a time, a plan fits a
block's 232,448 bytes wherever a design does, the row buffer's column
stride spreads 32 neighbouring columns over 32 banks, image lerp's
diagonal walk reads every window row of every center once, in order, from
a ring slot filled before and not yet refilled, and the grid stays within
its limits.  The kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py, its `_fly_` tests)."""

import json
import pathlib
import re

import pytest

from crossscalepatchmatch_tpu_torch.ops.cuda import MAX_HALF_WND
from crossscalepatchmatch_tpu_torch.ops.cuda import fly_cost as fc
from stereobench import roofline

ROOT = pathlib.Path(fc.__file__).parents[3]
CSRC = ROOT / "crossscalepatchmatch_tpu_torch" / "csrc"
NOVOL = json.loads((ROOT / "stereobench" / "configs" /
                    "kitti2015_grd_pp_novol.json").read_text())["engine"]
KITTI_HW = (375, 1242)
# max_dis of the presets and around the row buffer's fit, half windows of
# the presets, the tests' and the kernels' widest
MAX_DIS = (0, 1, 2, 12, 60, 61, 128, 129, 256, 300, 700, 1000, 8000)
HALF_WNDS = (0, 1, 3, 17, 36, 48, MAX_HALF_WND)


def plan(k, hw, md, stride=1, levels=1, lab=False, image=False,
         shape=KITTI_HW):
    return fc.launch_plan(k, *shape, hw, md, stride, levels, lab, image)


def constants(name):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", (CSRC / name).read_text())}


def test_plan_constants_are_the_kernels():
    fly, common = constants("fly_cost.cu"), constants("window_common.cuh")
    assert (fc.RAW_STAGES, fc.COST_STAGES, fc.RANGE_WORDS) == (
        fly["kRawStages"], fly["kCostStages"], fly["kRangeWords"])
    assert (fc.TAP_ROWS, fc.TAP_LUT) == (fly["kTapRows"], fly["kTapLut"])
    assert fc.TAP_ROWS == fc.MAX_TY + 1  # 16 rows read, one filled
    assert fc.TAP_LUT >= fc.LUT_N and fc.TAP_LUT % 4 == 0
    assert 2 * fly["kRangeSlots"] <= fly["kRangeWords"]
    assert (fc.RANGE_WORDS + fc.LUT_N) % 2 == 0  # the raw rows 8-aligned
    assert (fc.TX, fc.MAX_TY, fc.LUT_N, fc.MAX_SMEM) == (
        common["kTX"], common["kMaxTY"], common["kLutN"], common["kMaxSmem"])
    # the instances the launch dispatches on
    src = (CSRC / "fly_cost.cu").read_text()
    cases = {int(c) for c in re.findall(r"case (\d+):", src)}
    assert cases == set(fc.ROW_CANDS)


@pytest.mark.parametrize("lab", [False, True])
def test_novol_kitti_schedule_takes_the_shared_rows(lab):
    """Each of the no-volume KITTI pair's 27 launches (15 exact, 12 at
    stride 2; stereobench.roofline.fly_plan) takes the shared-row design,
    with Lab weights (K7) too, one chunk a view holding every candidate,
    16-row tiles that two of fit an SM; the stride-2 launches on a lattice
    of step 2."""
    launches = roofline.fly_plan(NOVOL)
    assert len(launches) == 27 and sum(s > 1 for _, s in launches) == 12
    hw = NOVOL["wnd_size"] // 2
    for k, stride in launches:
        p = plan(k, hw, NOVOL["max_dis"], stride, lab=lab)
        assert p.rows and p.chunks == 1, (k, p)
        assert p.per_chunk == k and p.cands == k
        assert p.tile_rows == fc.MAX_TY and p.lattice == stride
        assert 2 * (p.smem + fc.BLOCK_RESERVE) <= fc.SM_SMEM
        assert p.grid == ((39, 24, 2) if stride == 1 else (40, 24, 2))


@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("hw", HALF_WNDS)
def test_image_lerp_takes_the_shared_rows(lab, hw):
    """Image lerp takes the shared-row design wherever its ring fits a
    block: the thread's candidates as in cost lerp, at one level with a
    stride the rows on a lattice of that step and the 32 columns of a block
    adjacent; past the ring's fit, one sample at a time (sample_plan)."""
    for md in MAX_DIS:
        for k in (1, 2, 5, 8, 40):
            for stride, levels in ((1, 1), (2, 1), (1, 5), (3, 5)):
                p = plan(k, hw, md, stride, levels, lab, True, (28, 44))
                if fc.image_rows_smem_bytes(hw, md, lab) > fc.MAX_SMEM:
                    assert p == fc.sample_plan(k, 28, 44, hw, md, lab)
                    continue
                lat = stride if levels == 1 else 1
                assert p.rows and p.lattice == lat, (md, k, stride, p)
                assert p.smem == fc.image_rows_smem_bytes(hw, md, lab)
                assert p.per_chunk <= p.cands <= 8 and p.chunks == -(-k // 8)
                assert p.grid == (2, -(-28 // (16 * lat)) * lat,
                                  2 * p.chunks)


@pytest.mark.parametrize("lab", [False, True])
def test_image_kitti_schedule_takes_the_shared_rows(lab):
    """Each of the image-lerp KITTI pair's 27 launches (the configuration
    kitti2015_grd_pp_novol_img: K6, 12 of them at stride 2 as its own
    prescreen; with Lab weights too) takes the shared-row design: one chunk
    a view holding every candidate, 16-row tiles, the stride-2 launches'
    rows on a lattice of step 2 and their columns adjacent; the ring of 17
    tile rows, each the other view's 32 + 34 + 128 + 1 = 195 columns as
    16-byte channels and the tile's 66 columns as weight words, gradients
    (and with Lab colour words), beside the 768-word weight table: 65,088
    bytes a block (69,576 with Lab), two blocks an SM."""
    img = json.loads((ROOT / "stereobench" / "configs" /
                      "kitti2015_grd_pp_novol_img.json").read_text())["engine"]
    assert img == dict(NOVOL, fly_lerp="image")
    launches = roofline.fly_plan(img)
    assert len(launches) == 27 and sum(s > 1 for _, s in launches) == 12
    smem = 4 * (768 + 17 * (4 * 195 + (3 if lab else 2) * 66))
    assert smem == (69_576 if lab else 65_088)
    for k, stride in launches:
        p = plan(k, img["wnd_size"] // 2, img["max_dis"], stride, lab=lab,
                 image=True)
        assert p.rows and p.tile_rows == fc.MAX_TY, (k, p)
        assert p.chunks == 1 and p.per_chunk == p.cands == k
        assert p.lattice == stride and p.smem == smem
        assert 2 * (p.smem + fc.BLOCK_RESERVE) <= fc.SM_SMEM
        assert p.grid == (39, 24, 2)


@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("hw", [0, 1, 3])
def test_image_lerp_falls_back_past_the_ring(lab, hw):
    """A window of at most 7 at a range past ~780: the ring passes a
    block's shared memory while one sample at a time fits (the GPU tier's
    eight-row case: half_wnd 3, max_dis 1500, 181,704 bytes with Lab); a
    range one shorter than the ring's fit takes the shared rows."""
    md = min(m for m in range(4096)
             if fc.image_rows_smem_bytes(hw, m, lab) > fc.MAX_SMEM)
    assert 750 <= md <= 900
    for m in (md, 1500):
        p = plan(2, hw, m, 2, lab=lab, image=True, shape=(20, 1600))
        assert not p.rows and p == fc.sample_plan(2, 20, 1600, hw, m, lab)
        assert p.smem <= fc.MAX_SMEM
    assert plan(2, hw, md - 1, 2, lab=lab, image=True).rows
    if hw == 3 and lab:
        assert plan(2, 3, 1500, 2, lab=True, image=True,
                    shape=(20, 1600))[1:3] == (8, 1)
        assert fc.sample_smem_bytes(3, 1500, True, 8) == 181_704


@pytest.mark.parametrize("hw", [0, 1, 2, 3, 17, 36, MAX_HALF_WND])
@pytest.mark.parametrize("stride,lat", [(1, 1), (2, 2), (3, 3), (2, 1),
                                        (3, 1)])
def test_image_walk_reads_each_row_once_from_a_filled_slot(hw, stride, lat):
    """Image lerp's diagonal walk (csrc/fly_cost.cu
    fly_cost_kernel_image_rows): tile rows 0 .. 15 fill the ring before
    step 0, step t fills row t + 16 beside its reads, and at step t the
    center at tile row c (less hw; up to 16 a block) adds window row dy =
    lat * t - hw, tile row c + t, where its window holds it.  Each center
    adds every window row once, dy ascending (the plain version's order),
    from the slot its row was filled into and no later fill has taken, and
    a step's fill never takes a slot the step reads."""
    ring = {m % fc.TAP_ROWS: m for m in range(fc.TAP_ROWS - 1)}
    seen = {c: [] for c in range(fc.MAX_TY)}
    for t in range(2 * hw // lat + 1):
        filled = t + fc.TAP_ROWS - 1
        if (lat * t) % stride:
            ring[filled % fc.TAP_ROWS] = filled
            continue
        for c in seen:
            m = c + t
            assert ring.get(m % fc.TAP_ROWS) == m, (t, c)
            assert m % fc.TAP_ROWS != filled % fc.TAP_ROWS
            seen[c].append(lat * t - hw)
        ring[filled % fc.TAP_ROWS] = filled  # after the step's barrier
    want = list(range(-hw, hw + 1, stride))
    assert all(dys == want for dys in seen.values())


def test_wide_window_and_range_fall_back():
    """half_wnd 64 at a large max_dis: the rings pass a block's shared
    memory, so the launch computes one sample at a time (and where that
    does not fit either the kernel refuses it); the largest max_dis whose
    rings fit takes the shared rows, one more does not."""
    assert not plan(1, 64, 700).rows
    assert fc.rows_smem_bytes(64, 1, 1, 700, False) > fc.MAX_SMEM
    for hw, stride, lab in ((17, 1, False), (17, 1, True), (64, 1, False),
                            (17, 2, False)):
        md = max(m for m in range(4096)
                 if fc.rows_smem_bytes(hw, stride, stride, m, lab)
                 <= fc.MAX_SMEM)
        assert plan(1, hw, md, stride, lab=lab).rows
        assert not plan(1, hw, md + 1, stride, lab=lab).rows


@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("image", [False, True])
def test_every_plan_fits_a_block(lab, image):
    """A plan stays within 232,448 bytes a block wherever one design fits;
    where none does, it is the sample design that the kernel refuses."""
    for hw in range(MAX_HALF_WND + 1):
        for md in MAX_DIS:
            for stride, levels in ((1, 1), (2, 1), (3, 5)):
                p = plan(2, hw, md, stride, levels, lab, image)
                lat = stride if levels == 1 else 1
                rows = (fc.image_rows_smem_bytes(hw, md, lab) if image else
                        fc.rows_smem_bytes(hw, stride, lat, md, lab))
                fits = rows <= fc.MAX_SMEM or any(
                    fc.sample_smem_bytes(hw, md, lab, r) <= fc.MAX_SMEM
                    for r in (8, 16))
                if fits:
                    assert p.smem <= fc.MAX_SMEM, (hw, md, p)
                else:
                    assert not p.rows and p.smem > fc.MAX_SMEM
                want = (rows if p.rows else
                        fc.sample_smem_bytes(hw, md, lab, p.tile_rows))
                assert p.smem == want


def test_shared_memory_of_the_kitti_rings():
    """KITTI (half_wnd 17, max_dis 128): the rows' slice ranges, the
    weight table, three raw rows of 66 tile and 194 other-view columns, two
    cost rows of 66 columns at 129 floats; at stride 2 on the lattice 49
    tile columns, 2 apart, and 225 other-view columns."""
    assert fc.rows_smem_bytes(17, 1, 1, 128, False) == 4 * (
        8 + 766 + 3 * (2 * 194 + 2 * 66) + 2 * 66 * 129) == 77_448
    assert fc.rows_smem_bytes(17, 1, 1, 128, True) == 77_448 + 4 * 3 * 66
    assert fc.row_cols(17, 2, 2) == 49
    assert fc.rows_smem_bytes(17, 2, 2, 128, False) == 4 * (
        8 + 766 + 3 * (2 * 225 + 2 * 49) + 2 * 49 * 129)


@pytest.mark.parametrize("hw", [0, 1, 2, 3, 17, 36, MAX_HALF_WND])
@pytest.mark.parametrize("stride", [1, 2, 3, 7])
def test_lattice_columns_hold_every_sampled_column(hw, stride):
    """On the lattice a block's 32 centers cx = x0 + stride * lane sample
    columns cx - hw + stride * i, i over the window's offsets: tile column
    lane + i, inside the row_cols(hw, stride, stride) columns, each used."""
    n_off = len(range(-hw, hw + 1, stride))
    cols = fc.row_cols(hw, stride, stride)
    used = {lane + i for lane in range(fc.TX) for i in range(n_off)}
    assert used == set(range(cols))
    assert fc.row_cols(hw, stride, 1) == fc.TX + 2 * hw


@pytest.mark.parametrize("md", [0, 1, 2, 31, 32, 60, 64, 127, 128, 129, 256,
                                1000])
def test_cost_stride_maps_32_columns_to_32_banks(md):
    """32 neighbouring columns at one slice (a warp's centers at one
    window offset on a plane of one disparity) fall in 32 banks, for either
    tap of the pair (f, f + 1); a column holds every slice 1 .. max_dis."""
    cs = fc.cost_stride(md)
    assert cs % 2 == 1 and md <= cs <= md + 1
    for f in range(max(md, 1) + 1):
        assert len({(c * cs + f) % 32 for c in range(32)}) == 32


@pytest.mark.parametrize("k", [*range(1, 41), 100, 1000, 32767])
def test_chunks_cover_the_candidates_and_the_grid_fits(k):
    """The chunks take every candidate once, at most 8 a block, each on the
    fewest candidates a thread that hold it; the grid's z (views times
    chunks, or views times K one sample at a time) stays within 65,535 up
    to the wrapper's K limit."""
    for image in (False, True):
        p = plan(k, 17, 128, image=image)
        assert p.grid[2] <= 65535
        assert p.chunks * p.per_chunk >= k
        assert (p.chunks - 1) * p.per_chunk < k
        assert p.grid[2] == 2 * p.chunks
        if p.rows:
            assert p.per_chunk <= p.cands <= 8
            assert p.cands == min(c for c in fc.ROW_CANDS
                                  if c >= p.per_chunk)
            assert p.chunks == -(-k // 8)


@pytest.mark.parametrize("image", [False, True])
@pytest.mark.parametrize("stride", [1, 2, 3, 7])
@pytest.mark.parametrize("shape", [KITTI_HW, (375, 450), (20, 30), (1, 1),
                                   (37, 53)])
def test_lattice_blocks_cover_every_pixel_once(stride, shape, image):
    """The shared-row design's blocks (csrc/fly_cost.cu: blockIdx.x =
    column block * lattice + residue, rows alike, pixels x0 + lattice *
    lane; image lerp's columns adjacent, blockIdx.x = column block) take
    every pixel of the frame once."""
    h, w = shape
    p = plan(1, 17, 128, stride, image=image, shape=shape)
    lat = p.lattice
    assert lat == stride
    lat_x = 1 if image else lat
    seen = {}
    for gx in range(p.grid[0]):
        for gy in range(p.grid[1]):
            bx, by = gx // lat_x, gy // lat
            x0 = bx * fc.TX * lat_x + gx - bx * lat_x
            y0 = by * p.tile_rows * lat + gy - by * lat
            for ly in range(p.tile_rows):
                for lx in range(fc.TX):
                    x, y = x0 + lat_x * lx, y0 + lat * ly
                    if x < w and y < h:
                        seen[(y, x)] = seen.get((y, x), 0) + 1
    assert len(seen) == h * w and set(seen.values()) == {1}


def test_sample_design_keeps_its_tile_rule():
    """One sample at a time (sample_plan, either lerp): 16 rows unless 8
    keep more warps resident or only 8 fit; a launch past the shared rows'
    fit takes it (the GPU tier's eight-row cases: half_wnd 3, max_dis
    1500, cost lerp and image lerp with Lab)."""
    assert fc.sample_plan(1, 20, 150, 36, 128, False).tile_rows == 8
    assert fc.sample_plan(1, 20, 150, 32, 128, True).tile_rows == 8
    assert fc.sample_plan(1, *KITTI_HW, 17, 128, False).tile_rows == 16
    assert fc.sample_plan(1, 20, 30, 48, 4, False).tile_rows == 8
    for lab, image in ((False, False), (True, True)):
        p = plan(2, 3, 1500, 2, lab=lab, image=image, shape=(20, 1600))
        assert not p.rows and p.tile_rows == 8 and p.grid == (50, 3, 4)
