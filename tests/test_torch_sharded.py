"""The port's sharding pieces against the JAX engine's, on the CPU: the
halo collectives (crossscalepatchmatch_tpu_torch.parallel), the band forms
of the plain window cost, quadrant build and weighted median, the mesh and
the refusals.

Collectives run in spawned gloo ranks (tests/torch_sharded_worker.py) and
must equal JAX `extend_rows` / `extend_cols` / `_extend_planes` /
`_extend_planes_cols` under shard_map on the conftest's virtual CPU
devices element for element, multi-hop included.  The band plain versions
are held against the JAX jnp band functions (window_plane_cost with
center_row0 / row_valid / center_col0 / col_valid, the upsampled
cross-scale level at an odd origin, build_quadrant_volumes(valid=...),
weighted_median with an output window) at the tolerance of the
single-device tests: 1e-5 relative for f32 window sums (exp and the
summation order are the only freedoms), exact for u8 maps but the
weighted median's exp-ulp ties.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from crossscalepatchmatch_tpu.models import postprocess as jpp
from crossscalepatchmatch_tpu.ops import plane_cost as jpc
from crossscalepatchmatch_tpu.ops import prescreen_volume as jpv
from crossscalepatchmatch_tpu.parallel import tiled as jtiled
from crossscalepatchmatch_tpu.parallel.mesh import make_mesh as j_make_mesh
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import postprocess as tpp
from crossscalepatchmatch_tpu_torch.ops import plane_cost as tpc
from crossscalepatchmatch_tpu_torch.ops import prescreen_volume as tpv
from crossscalepatchmatch_tpu_torch.ops.cuda import (cross_scale_cost,
                                                     quadrant_build,
                                                     window_cost)
from jax_draws import config_pair
from torch_sharded_worker import spawn

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def j_shard(fn, shape, spec, x):
    """fn on every block of x under shard_map on a JAX mesh of `shape`;
    returns the blocks' outputs [n, ...] in mesh order."""
    n = int(np.prod(shape))
    mesh = j_make_mesh(*shape, devices=jax.devices()[:n])
    out = shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec)(
        jnp.asarray(x))
    return np.asarray(out)


def test_collectives_match_jax_element_for_element(tmp_path):
    """Row and column halos (one hop and multi-hop: halo 10 over 8-row
    blocks, the far ring 25 over 8-row blocks) and the plane re-anchoring,
    on (1, 4, 1) and (1, 1, 4) meshes."""
    rng = np.random.default_rng(0)
    rows = np.arange(32 * 5, dtype=np.float32).reshape(32, 5) + 1
    cols = np.arange(6 * 32, dtype=np.float32).reshape(6, 32) + 1
    planes_r = rng.normal(size=(32, 6, 3)).astype(np.float32)
    planes_c = rng.normal(size=(6, 32, 3)).astype(np.float32)
    ops = {"rows1": ((1, 4, 1), 3, "rows"), "rows3": ((1, 4, 1), 10, "rows"),
           "cols2": ((1, 1, 4), 10, "cols"),
           "planes4": ((1, 4, 1), 25, "planes"),
           "planes_c2": ((1, 1, 4), 9, "planes_cols")}
    arrays = {"rows1": rows, "rows3": rows, "cols2": cols,
              "planes4": planes_r, "planes_c2": planes_c}
    got = spawn(dict(job="collectives", ops=ops, arrays=arrays), 4,
                str(tmp_path))
    row_spec, col_spec = P("ty", None), P(None, "tx")
    want = {
        "rows1": j_shard(lambda b: jtiled.extend_rows(b, 3), (1, 4, 1),
                         row_spec, rows).reshape(4, 14, 5),
        "rows3": j_shard(lambda b: jtiled.extend_rows(b, 10), (1, 4, 1),
                         row_spec, rows).reshape(4, 28, 5),
        "cols2": np.moveaxis(j_shard(
            lambda b: jtiled.extend_cols(b, 10), (1, 1, 4), col_spec,
            cols).reshape(6, 4, 28), 1, 0),
        "planes4": j_shard(lambda b: jtiled._extend_planes(b, 25, 8),
                           (1, 4, 1), P("ty", None, None),
                           planes_r).reshape(4, 58, 6, 3),
        "planes_c2": np.moveaxis(j_shard(
            lambda b: jtiled._extend_planes_cols(b, 9, 8), (1, 1, 4),
            P(None, "tx", None), planes_c).reshape(6, 4, 26, 3), 1, 0),
    }
    for rank, res in enumerate(got):
        for name, (ty, tx, y) in res.items():
            np.testing.assert_array_equal(y, want[name][ty + tx],
                                          err_msg=f"{name} rank {rank}")
    # multi-hop reaches: rank 1's top rows of rows3 are global rows -2..7
    assert (got[1]["rows3"][2][:2] == 0).all()
    np.testing.assert_array_equal(got[1]["rows3"][2][2:10], rows[:8])


def band_scene(seed, hs, ws, hw, d, k, row0, h_glob):
    """An extended block [hs + 2hw, ws + 2hw] of a tile at global row row0
    (columns extended too), its volume, planes and row / column validity
    (the global image has h_glob rows; the block sits in the middle
    column of three)."""
    rng = np.random.default_rng(seed)
    ha, wa = hs + 2 * hw, ws + 2 * hw
    img = rng.integers(0, 256, (ha, wa, 3), dtype=np.uint8)
    vol = rng.uniform(0, 3, (ha, wa, d)).astype(np.float32)
    mc = np.float32(vol.max())
    ab = rng.uniform(-0.3, 0.3, (k, hs, ws, 2)).astype(np.float32)
    c = rng.uniform(-2, d + 1, (k, hs, ws, 1)).astype(np.float32)
    abc = np.concatenate([ab, c], -1)
    g_row = row0 + np.arange(-hw, hs + hw)
    row_valid = (g_row >= 0) & (g_row < h_glob)
    col_valid = np.ones(wa, bool)
    col_valid[:2] = False
    return img, vol, mc, abc, row_valid, col_valid


@pytest.mark.parametrize("stride", [1, 2])
def test_window_cost_band_matches_jax(stride):
    """K1 / K3's plain band form on an extended block whose first rows lie
    above the global image."""
    hw, hs, ws, d = 4, 9, 11, 9
    img, vol, mc, abc, rv, cv = band_scene(1, hs, ws, hw, d, 2, row0=3,
                                           h_glob=30)
    kw = dict(half_wnd=hw, max_dis=d - 1, gamma=10.0, center_row0=hw,
              center_col0=hw, wnd_stride=stride)
    want = np.asarray(jpc.window_plane_cost(
        jnp.asarray(img), jnp.asarray(vol), jnp.float32(mc),
        jnp.asarray(abc), row_valid=jnp.asarray(rv),
        col_valid=jnp.asarray(cv), **kw))
    got = tpc.window_plane_cost(
        torch.from_numpy(img), torch.from_numpy(vol), torch.tensor(mc),
        torch.from_numpy(abc), row_valid=torch.from_numpy(rv),
        col_valid=torch.from_numpy(cv), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("scale", [1, 2])
def test_coarse_level_band_at_an_odd_origin_matches_jax(scale):
    """A whole level s indexed at ((y + row0) >> s, (x + col0) >> s) for a
    tile at an odd origin equals JAX's upsampled level of the band
    (upsample_level / upsample_valid / window_plane_cost_upsampled)."""
    rng = np.random.default_rng(scale)
    hw, hs, ws, row0, col0 = 2, 7, 9, 7, 9
    h_glob, w_glob = 21, 27
    hl, wl = ((h_glob - 1) >> scale) + 1, ((w_glob - 1) >> scale) + 1
    md = 12 >> scale
    img = rng.integers(0, 256, (hl, wl, 3), dtype=np.uint8)
    vol = rng.uniform(0, 3, (hl, wl, md + 1)).astype(np.float32)
    mc = np.float32(vol.max())
    abc = np.concatenate([rng.uniform(-0.2, 0.2, (2, hs, ws, 2)),
                          rng.uniform(0, 13, (2, hs, ws, 1))],
                         -1).astype(np.float32)
    up = dict(scale=scale, half_wnd=hw, fine_hw=(hs, ws), row0=row0,
              col0=col0)
    want = np.asarray(jpc.window_plane_cost_upsampled(
        jpc.upsample_level(jnp.asarray(img), **up),
        jpc.upsample_level(jnp.asarray(vol), **up),
        jpc.upsample_valid(scale, hw, (hs, ws), (hl, wl), row0, col0),
        jnp.float32(mc), jnp.asarray(abc), scale=scale, half_wnd=hw,
        max_dis_s=md, gamma=10.0))
    got = tpc.level_plane_cost(
        torch.from_numpy(img), torch.from_numpy(vol), torch.tensor(mc),
        torch.from_numpy(abc), scale=scale, half_wnd=hw, max_dis=md,
        gamma=10.0, row0=row0, col0=col0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_quadrant_build_band_matches_jax():
    """build_quadrant_volumes(valid=...) on an extended block: a
    neighbour's halo counts, pixels past the global border do not."""
    hw, hs, ws, d = 4, 9, 11, 7
    img, vol, _, _, rv, cv = band_scene(2, hs, ws, hw, d, 1, row0=2,
                                        h_glob=14)
    valid = rv[:, None] & cv[None, :]
    want = jpv.build_quadrant_volumes(jnp.asarray(img), jnp.asarray(vol),
                                      jnp.asarray(valid), half_wnd=hw,
                                      gamma=10.0, stride=2)
    got = tpv.build_quadrant_volumes(torch.from_numpy(img),
                                     torch.from_numpy(vol),
                                     torch.from_numpy(valid), half_wnd=hw,
                                     gamma=10.0, stride=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-4)


def test_weighted_median_band_matches_jax():
    """The weighted median of a tile's block from its halo-extended maps,
    pixels past the global border invalid."""
    _, cfg = config_pair(max_dis=12, dis_scale=16, wnd_size=9)
    jcfg = config_pair(max_dis=12, dis_scale=16, wnd_size=9)[0]
    rng = np.random.default_rng(3)
    hw, hs, ws = 4, 10, 12
    ha, wa = hs + 2 * hw, ws + 2 * hw
    dis = rng.integers(0, 200, (2, ha, wa), dtype=np.uint8)
    imgs = rng.integers(0, 256, (2, ha, wa, 3), dtype=np.uint8)
    valid = rng.uniform(size=(2, ha, wa)) > 0.3
    valid[:, :hw - 1] = False          # rows above the global image
    kw = dict(center_row0=hw, out_h=hs, center_col0=hw, out_w=ws)
    want = np.asarray(jpp.weighted_median(
        jnp.asarray(dis), jnp.asarray(imgs), jnp.asarray(valid), jcfg, **kw))
    got = tpp.weighted_median(torch.from_numpy(dis), torch.from_numpy(imgs),
                              torch.from_numpy(valid), cfg, **kw).numpy()
    assert got.shape == (2, hs, ws)
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d == 0).mean() >= 0.99 and (d <= 1).mean() == 1.0


def test_prepared_band_forms_route_to_the_plain_band_forms():
    """On CPU tensors the kernels' band wrappers give their plain band
    forms: K1 / K3 (window_cost_prepared with bounds), K2
    (quadrant_volumes_prepared: the block's pixels of the plain build over
    the extended block) and K4 (prepare_cross_scale with the block's
    origin, the coarse levels whole); centers outside the valid interval
    are refused."""
    hw, hs, ws, d, row0, col0 = 3, 8, 10, 9, 8, 10
    h_glob, w_glob = 24, 30
    rng = np.random.default_rng(4)
    ha, wa = hs + 2 * hw, ws + 2 * hw
    imgs = torch.from_numpy(rng.integers(0, 256, (2, ha, wa, 3),
                                         dtype=np.uint8))
    vols = torch.from_numpy(rng.uniform(0, 3, (2, ha, wa, d))
                            .astype(np.float32))
    mcs = vols.amax(dim=(1, 2, 3))
    abc = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.2, 0.2, (2, 2, hs, ws, 2)),
         rng.uniform(0, d, (2, 2, hs, ws, 1))], -1).astype(np.float32))
    bounds = (-row0, h_glob - row0, -col0, w_glob - col0)
    g_row = row0 + torch.arange(-hw, hs + hw)
    rv = (g_row >= 0) & (g_row < h_glob)
    g_col = col0 + torch.arange(-hw, ws + hw)
    cv = (g_col >= 0) & (g_col < w_glob)
    kw = dict(half_wnd=hw, max_dis=d - 1, gamma=10.0)
    prep = window_cost.prepare_volumes(imgs, vols, mcs, rows_extended=True,
                                       cols_extended=True, **kw)
    assert prep.hw == (hs, ws)
    got = window_cost.window_cost_prepared(prep, abc, half_wnd=hw,
                                           max_dis=d - 1, bounds=bounds)
    want = torch.stack([tpc.window_plane_cost(
        imgs[v], vols[v], mcs[v], abc[v], center_row0=hw, row_valid=rv,
        center_col0=hw, col_valid=cv, **kw) for v in range(2)])
    assert torch.equal(got, want)
    bq, wq = quadrant_build.quadrant_volumes_prepared(
        prep, half_wnd=hw, gamma=10.0, stride=2, bounds=bounds)
    full = [tpv.build_quadrant_volumes(imgs[v], vols[v],
                                       rv[:, None] & cv[None, :],
                                       half_wnd=hw, gamma=10.0)
            for v in range(2)]
    assert bq.shape == (2, 4, hs, ws, d)
    assert torch.equal(bq, torch.stack([f[0] for f in full])[
        :, :, hw:hw + hs, hw:hw + ws])
    assert torch.equal(wq, torch.stack([f[1] for f in full])[
        :, :, hw:hw + hs, hw:hw + ws])
    # two levels: the block's fine level and the whole level 1
    l1 = torch.from_numpy(rng.integers(0, 256, (2, 12, 15, 3),
                                       dtype=np.uint8))
    v1 = torch.from_numpy(rng.uniform(0, 3, (2, 12, 15, d // 2 + 1))
                          .astype(np.float32))
    b1 = (-row0, (12 << 1) - row0, -col0, (15 << 1) - col0)
    cs = cross_scale_cost.prepare_cross_scale(
        [imgs, l1], [vols, v1], [mcs, v1.amax(dim=(1, 2, 3))], [0.7, 0.3],
        rows_extended=True, cols_extended=True, origin=(row0, col0),
        bounds=[bounds, b1], **kw)
    got = cross_scale_cost.cross_scale_cost_prepared(
        cs, abc, half_wnd=hw, max_dis=d - 1, levels=2)
    want = torch.stack([tpc.cross_scale_plane_cost(
        [imgs[v], l1[v]], [vols[v], v1[v]],
        [mcs[v], v1[v].amax()], [0.7, 0.3], abc[v],
        origins=[(hw, hw), (row0, col0)], row_valids=[rv, None],
        col_valids=[cv, None], **kw) for v in range(2)])
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="valid rectangle"):
        window_cost.window_cost_prepared(
            prep, abc, half_wnd=hw, max_dis=d - 1,
            bounds=(2, h_glob - row0, -col0, w_glob - col0))


def test_refusals(tmp_path):
    """A height the mesh does not divide, a seed count that is not the
    batch's, the no-volume cost (and resume slicing) on a spatial mesh, a
    sequence batch on a spatial mesh and a mesh larger than the world are
    refused."""
    kw = dict(max_dis=8, dis_scale=16, wnd_size=7, max_iter=1)
    got = spawn(dict(job="refusals", mesh=(1, 2, 1), cfg=kw), 2,
                str(tmp_path))
    assert got[0] == got[1] == {
        "height": "ValueError", "seeds": "ValueError",
        "fly": "NotImplementedError", "fly_steps": "NotImplementedError",
        "sequence": "NotImplementedError", "mesh": "ValueError"}


SUB_KW = dict(max_dis=12, dis_scale=16, wnd_size=7, max_iter=1,
              cost_method="GRD", use_cs=False, use_pp=False)


def subworld_case(mesh, case_dir, dryrun=None):
    """A 32x48 pair with the JAX engine's draws of each tile of `mesh`,
    for job_subworld (its checkpoints in case_dir/ck)."""
    from test_torch_sharded_pipeline import tile_draws

    jcfg, cfg = config_pair(**SUB_KW)
    pair = make_pair(h=32, w=48, max_dis=12, seed=5)
    hw = (32 // mesh[1], 48 // mesh[2])
    draws = {(3, t): tile_draws(3, t, hw, jcfg, cfg)
             for t in range(mesh[1] * mesh[2])}
    os.makedirs(case_dir / "ck")
    return dict(job="subworld", mesh=mesh, cfg=SUB_KW, l=pair.left[None],
                r=pair.right[None], seeds=[3], draws=draws,
                ckpt=str(case_dir / "ck" / "ck"), dryrun=dryrun)


def assert_outside(res):
    """What a rank outside the mesh gets: nothing, at once."""
    assert res["coordinate"] is None
    assert res["dis"] is None and res["steps"] is None
    assert res["resumable"] is None and res["sequence"] == []
    assert res["dryrun"] == ""


def test_mesh_over_the_first_rank_of_two(tmp_path):
    """make_mesh(1, 1, 1) in a world of two spans rank 0 (JAX make_mesh's
    devices=): rank 0's maps (run_batch_sharded, run_batch_sharded_steps,
    run_batch_sharded_resumable) are byte-equal to the world-of-one run,
    and held against JAX run_batch_sharded on make_mesh(1, 1, devices=
    jax.devices()[:1]) with the same draws at the single-device parity
    bound (near-tie adoptions may differ); rank 1 gets None and no
    sequence frame at once, writes no checkpoint and blocks nothing; the
    dry run over one rank runs on rank 0 alone."""
    two = spawn(subworld_case((1, 1, 1), tmp_path / "two", dryrun=1), 2,
                str(tmp_path / "two"), timeout=300)
    one = spawn(subworld_case((1, 1, 1), tmp_path / "one", dryrun=1), 1,
                str(tmp_path / "one"), timeout=300)
    ref = one[0]["dis"]
    assert ref.shape == (1, 2, 32, 48) and ref.max() > 0
    for key in ("dis", "steps", "resumable"):
        np.testing.assert_array_equal(two[0][key], ref, err_msg=key)
    assert two[0]["coordinate"] == (0, 0, 0)
    assert two[0]["sequence"][0].shape == (1, 2, 32, 48)
    assert two[0]["dryrun"].startswith("dryrun_multichip ok: mesh=(1,1,1)")
    assert_outside(two[1])
    assert sorted(os.listdir(tmp_path / "two" / "ck")) == ["ck.rank0"]
    jcfg, _ = config_pair(**SUB_KW)
    pair = make_pair(h=32, w=48, max_dis=12, seed=5)
    want = np.asarray(jtiled.jit_run_batch_sharded(
        jcfg, j_make_mesh(1, 1, devices=jax.devices()[:1]))(
        jnp.asarray(pair.left[None]), jnp.asarray(pair.right[None]),
        jnp.asarray([3], jnp.int32)))
    from test_torch_sharded_pipeline import assert_parity

    assert_parity(two[0]["dis"], want, [pair], config_pair(**SUB_KW)[1])


def test_mesh_over_the_first_two_ranks_of_three(tmp_path):
    """A (1, 2, 1) mesh in a world of three equals the (1, 2, 1) mesh that
    covers a world of two, byte for byte on both of its ranks; rank 2 gets
    nothing and blocks nothing, the dry run over two ranks ((2, 1, 1))
    runs on ranks 0 and 1."""
    three = spawn(subworld_case((1, 2, 1), tmp_path / "three", dryrun=2), 3,
                  str(tmp_path / "three"), timeout=300)
    two = spawn(subworld_case((1, 2, 1), tmp_path / "two"), 2,
                str(tmp_path / "two"), timeout=300)
    for rank in (0, 1):
        assert three[rank]["coordinate"] == (0, rank, 0)
        for key in ("dis", "steps", "resumable"):
            np.testing.assert_array_equal(three[rank][key], two[0]["dis"],
                                          err_msg=f"{key} rank {rank}")
        assert three[rank]["dryrun"].startswith(
            "dryrun_multichip ok: mesh=(2,1,1)")
    assert_outside(three[2])
    assert sorted(os.listdir(tmp_path / "three" / "ck")) == [
        "ck.rank0", "ck.rank1"]


def test_initialize_multihost_and_dryrun():
    """Without arguments or a cluster environment initialize_multihost
    forms a world of one rank, (1, 1, 1); from torchrun's environment (a
    localhost store) a world of one too; partial explicit arguments are
    refused; dryrun_multichip(4) runs the (2, 1, 2) mesh of the JAX dry
    run over four gloo ranks."""
    code = (
        "import os, sys\n"
        "from crossscalepatchmatch_tpu_torch.parallel import mesh as m\n"
        "import torch.distributed as dist\n"
        "try:\n"
        "    m.initialize_multihost('localhost:1', device='cpu')\n"
        "except ValueError:\n"
        "    print('partial refused')\n"
        "mesh = m.initialize_multihost(device='cpu')\n"
        "print(tuple(mesh.shape), mesh.mesh_dim_names, dist.get_backend())\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "PYTHONPATH")}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:2] == [
        "partial refused", "(1, 1, 1) ('data', 'ty', 'tx') gloo"]
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env.update(RANK="0", WORLD_SIZE="1", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "(1, 1, 1)" in res.stdout
    from crossscalepatchmatch_tpu_torch.parallel.dryrun import (
        dryrun_multichip, mesh_shape)

    assert [mesh_shape(n) for n in (1, 2, 4, 6, 8)] == [
        (1, 1, 1), (2, 1, 1), (2, 1, 2), (2, 3, 1), (2, 2, 2)]
    dryrun_multichip(4, device="cpu")


def test_dryrun_under_torchrun_joins_its_group():
    """Under torchrun's environment (here a world of one on a localhost
    store) the dry run's entry point runs inside torchrun's group: it
    starts no process of its own and leaves the group at the end."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import subprocess\n"
        "def no_spawn(*a, **k):\n"
        "    raise AssertionError('the dry run started a process')\n"
        "subprocess.Popen = no_spawn\n"
        "import torch.distributed as dist\n"
        "from crossscalepatchmatch_tpu_torch.parallel import dryrun\n"
        "rc = dryrun.main(['1', '--device', 'cpu'])\n"
        "print('rc', rc, 'initialized', dist.is_initialized())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-2] == ("dryrun_multichip ok: mesh=(1,1,1) "
                         "out=(1, 2, 16, 32) backend=gloo"), res.stdout
    assert lines[-1] == "rc 0 initialized False"
