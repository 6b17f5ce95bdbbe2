"""The refinement proposal's draws and their plain versions, on the CPU
(kernel RPROP itself: tests/test_torch_kernels_gpu.py, on the card).

The counter-based Philox4x32-10 of ops.cuda.refine_propose is held
against a scalar Python Philox4x32-10 written from Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3" (SC'11), on its known-answer vectors
and on random counters and keys; distinct keys of the draws give distinct
streams; the wrapper refuses what the kernel does not take; and a
refinement proposed by utils.rng.TorchDraws (its propose method) equals
the generic path (perturb_planes on its refine draws) bit for bit, one
stage at a time and through whole pairs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu_torch import CEN_CS_PP, KITTI, README_DEMO
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                            run_pair_warm)
from crossscalepatchmatch_tpu_torch.ops import plane
from crossscalepatchmatch_tpu_torch.ops.cuda import refine_propose as rp
from crossscalepatchmatch_tpu_torch.utils import roofline, spans
from crossscalepatchmatch_tpu_torch.utils.rng import (PHASE_REFINE,
                                                      PHASE_WARM, TorchDraws)

torch.set_num_threads(1)

SMALL = dict(max_dis=12, dis_scale=16, wnd_size=7)


def philox_scalar(ctr, key, rounds=10):
    """Philox4x32-R on Python ints, as SC'11 defines it: a round maps
    (c0, c1, c2, c3) under key (k0, k1) to (hi(M1 c2) ^ c1 ^ k0, lo(M1 c2),
    hi(M0 c0) ^ c3 ^ k1, lo(M0 c0)); the key is bumped by the Weyl
    constants between rounds."""
    m0, m1 = 0xD2511F53, 0xCD9E8D57
    w0, w1 = 0x9E3779B9, 0xBB67AE85
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + w0) % 2 ** 32, (k1 + w1) % 2 ** 32
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 % 2 ** 32,
                          (p0 >> 32) ^ c3 ^ k1, p0 % 2 ** 32)
    return c0, c1, c2, c3


KNOWN_ANSWERS = [
    # (counter, key, output): the Random123 distribution's kat_vectors
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KNOWN_ANSWERS,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    assert philox_scalar(ctr, key) == want
    got = rp.philox4x32(torch.tensor([ctr], dtype=torch.int64), key)
    assert tuple(int(x) for x in got[0]) == want


def test_philox_torch_matches_scalar_on_random_words():
    rng = np.random.default_rng(4)
    ctr = rng.integers(0, 2 ** 32, (64, 4), dtype=np.int64)
    ctr[:8] = 2 ** 32 - 1 - np.arange(8)[:, None]   # the top of the range
    for key in ((0, 0), (2 ** 32 - 1, 1), tuple(int(x) for x in
                                                 rng.integers(0, 2 ** 32, 2))):
        got = rp.philox4x32(torch.from_numpy(ctr), key).numpy()
        want = [philox_scalar(tuple(int(x) for x in c), key) for c in ctr]
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))


def test_refine_draws_are_the_words_of_the_packed_counter():
    """Pixel p of (phase, iteration, view, round) draws the block of
    counter (p, round | view << 16, iteration, phase): dz from word 0, dn
    from words 1-3, each (w >> 8) * 2^-24 scaled as lo + (hi - lo) * u."""
    key, (h, w) = (123456789, 987654321), (3, 5)
    dz, dn = rp.refine_draws(key, PHASE_WARM, 7, 1, 3, (h, w), 1.5, 0.25,
                             "cpu")
    for p in (0, 6, h * w - 1):
        words = philox_scalar((p, 3 | 1 << 16, 7, PHASE_WARM), key)
        u = [np.float32((x >> 8) * 2.0 ** -24) for x in words]
        z = np.float32(-1.5) + np.float32(3.0) * u[0]
        n = [np.float32(-0.25) + np.float32(0.5) * x for x in u[1:]]
        assert dz.dtype == dn.dtype == torch.float32
        assert float(dz.flatten()[p]) == float(z)
        assert [float(x) for x in dn.reshape(-1, 3)[p]] == [float(x)
                                                            for x in n]


def stream(draws, iteration=2, view=1, rnd=3, shape=(4, 5)):
    return torch.cat([x.flatten() for x in draws.refine(
        iteration, view, rnd, shape, 1.5, 0.05)])


@pytest.mark.parametrize("field", ["phase", "iteration", "view", "round",
                                   "tile", "seed"])
def test_distinct_keys_give_distinct_streams(field):
    base = stream(TorchDraws(11, "cpu"))
    other = {
        "phase": lambda: stream(TorchDraws(11, "cpu",
                                           refine_phase=PHASE_WARM)),
        "iteration": lambda: stream(TorchDraws(11, "cpu"), iteration=3),
        "view": lambda: stream(TorchDraws(11, "cpu"), view=0),
        "round": lambda: stream(TorchDraws(11, "cpu"), rnd=4),
        "tile": lambda: stream(TorchDraws(11, "cpu", tile=0)),
        "seed": lambda: stream(TorchDraws(12, "cpu")),
    }[field]()
    assert base.shape == other.shape
    # no element shared: the streams are unrelated, not shifted
    assert not bool(torch.isin(base, other).any())
    assert torch.equal(base, stream(TorchDraws(11, "cpu")))


def test_tile_none_and_tiles_have_their_own_keys():
    keys = {TorchDraws(5, "cpu").key, TorchDraws(5, "cpu", tile=0).key,
            TorchDraws(5, "cpu", tile=1).key, TorchDraws(6, "cpu").key}
    assert len(keys) == 4
    assert all(0 <= k < 2 ** 32 for key in keys for k in key)


def test_refine_draws_cover_their_ranges():
    dz, dn = rp.refine_draws((1, 2), PHASE_REFINE, 0, 0, 0, (64, 64), 6.0,
                             0.5, "cpu")
    assert float(dz.min()) >= -6.0 and float(dz.max()) < 6.0
    assert float(dn.min()) >= -0.5 and float(dn.max()) < 0.5
    # U(-z, z): mean ~0, sd z / sqrt(3), over 4,096 and 12,288 draws
    assert abs(float(dz.mean())) < 0.2
    assert abs(float(dz.std()) - 6.0 / 3 ** 0.5) < 0.1
    assert abs(float(dn.mean())) < 0.02


@pytest.mark.parametrize("fields", [
    dict(rnd=1 << 16), dict(view=2), dict(iteration=1 << 32),
    dict(phase=-1), dict(n=0)])
def test_counter_fields_outside_their_widths_raise(fields):
    args = dict(phase=1, iteration=0, view=0, rnd=0, n=4)
    args.update(fields)
    with pytest.raises(ValueError):
        rp.counters(device="cpu", **args)


def same_bits(a, b):
    """Bit-equal f32 tensors, NaNs included (a large jitter of the normal
    can make a plane of NaNs on both paths)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def abc_field(h, w, seed=0):
    rng = np.random.default_rng(seed)
    abc = np.concatenate([rng.uniform(-0.5, 0.5, (2, h, w, 2)),
                          rng.uniform(0, 20, (2, h, w, 1))], -1)
    return torch.from_numpy(abc.astype(np.float32))


class RefineOnly:
    """The same draws without a propose method: the generic path."""

    def __init__(self, draws):
        self.draws = draws

    def init(self, *a):
        return self.draws.init(*a)

    def refine(self, *a):
        return self.draws.refine(*a)


@pytest.mark.parametrize("k", [1, 4, 5, 10, 20])
def test_propose_equals_perturb_planes_on_refine_draws(k):
    """TorchDraws.propose (K = 20: two launches' worth of rounds on the
    card) against the generic path, both views, warm phase and a tile."""
    cfg = dataclasses.replace(README_DEMO, **SMALL)
    zs = np.linspace(6, 0.1, k, dtype=np.float32)
    ns = zs / zs[0]
    abc = abc_field(6, 7)
    for draws in (TorchDraws(3, "cpu"), TorchDraws(3, "cpu", tile=2),
                  TorchDraws(3, "cpu", refine_phase=PHASE_WARM)):
        got = draws.propose(abc, 1, range(k), zs, ns, cfg.eps)
        want = pm.propose_generic(RefineOnly(draws), abc, 1, range(k), zs,
                                  ns, cfg.eps)
        assert got.shape == (2, k, 6, 7, 3)
        assert same_bits(got, want)
    # rounds from the middle of a schedule
    zz, nn = np.tile(zs, 3), np.tile(ns, 3)
    tail = TorchDraws(3, "cpu").propose(abc, 1, range(2, k + 2), zz, nn,
                                        cfg.eps)
    assert same_bits(tail, pm.propose_generic(
        TorchDraws(3, "cpu"), abc, 1, range(2, k + 2), zz, nn, cfg.eps))


def test_plain_version_is_perturb_planes_stacked():
    abc = abc_field(5, 9, seed=1)
    zs, ns = np.float32([4, 2, 1]), np.float32([1, 0.5, 0.25])
    key = (77, 88)
    got = rp.refine_propose(abc, key, phase=2, iteration=4,
                            rounds=range(1, 3), zs=zs, ns=ns, eps=1e-8)
    for v in range(2):
        for k, i in enumerate(range(1, 3)):
            dz, dn = rp.refine_draws(key, 2, 4, v, i, (5, 9), float(zs[i]),
                                     float(ns[i]), "cpu")
            assert same_bits(got[v, k], plane.perturb_planes(
                abc[v], dz, dn, 1e-8))


def toy_cost(abc2):
    """A cost with a plane-dependent minimum: no volume needed."""
    a, b, c = abc2.unbind(-1)
    return (c - 7.0).abs() + a * a + b * b


@pytest.mark.parametrize("batch_refine", [True, False])
def test_plane_refinement_with_torch_draws_equals_generic(batch_refine):
    cfg = dataclasses.replace(README_DEMO, batch_refine=batch_refine,
                              **SMALL)
    abc = abc_field(8, 10, seed=2)
    state = pm.PMState(abc=abc, cost=toy_cost(abc))
    draws = TorchDraws(9, "cpu")
    with spans.recording() as rec:
        got = pm.plane_refinement(state, draws, 1, toy_cost, cfg)
    want = pm.plane_refinement(state, RefineOnly(draws), 1, toy_cost, cfg)
    assert same_bits(got.abc, want.abc)
    assert same_bits(got.cost, want.cost)
    assert not torch.equal(got.abc, abc)
    refine = [sp for sp in rec if sp.name == "refine"]
    r = len(cfg.refinement_schedule())
    assert len(refine) == (cfg.refine_stages if batch_refine else r)
    # the CPU runs the plain version: no stage is fused
    assert all(sp.attrs["fused"] is False for sp in refine)


CELLS = {
    # the benchmark's configurations at a small size: (config, warm)
    "kitti_pairs": (KITTI, False),
    "middlebury_pairs": (dataclasses.replace(CEN_CS_PP, scale_num=3), False),
    "kitti_video": (KITTI, True),
}


class Counting(TorchDraws):
    calls = 0

    def propose(self, *a):
        Counting.calls += 1
        return super().propose(*a)


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_pair_proposes_once_a_stage(cell):
    """6 proposals a KITTI or Middlebury pair (3 iterations of 2 stages), 2
    a video frame (one warm iteration): one RPROP launch each on the
    card."""
    cfg, warm = CELLS[cell]
    cfg = dataclasses.replace(cfg, **SMALL)
    pair = make_pair(h=32, w=48, max_dis=12, seed=1)
    Counting.calls = 0
    if warm:
        prior = run_pair(pair.left, pair.right, 0, cfg, device="cpu")["abc"]
        Counting.calls = 0
        run_pair_warm(pair.left, pair.right, 1, prior, cfg, 1, device="cpu",
                      draws=Counting(1, "cpu", refine_phase=PHASE_WARM))
        assert Counting.calls == 2
    else:
        run_pair(pair.left, pair.right, 1, cfg, device="cpu",
                 draws=Counting(1, "cpu"))
        assert Counting.calls == cfg.max_iter * cfg.refine_stages == 6


@pytest.mark.parametrize("warm", [False, True])
def test_pair_maps_equal_through_propose_and_generic(warm):
    cfg = dataclasses.replace(README_DEMO, **SMALL)
    pair = make_pair(h=24, w=32, max_dis=12, seed=2)
    if warm:
        prior = run_pair(pair.left, pair.right, 0, cfg, device="cpu")["abc"]

        def call(d):
            return run_pair_warm(pair.left, pair.right, 4, prior, cfg, 1,
                                 device="cpu", draws=d)
        draws = TorchDraws(4, "cpu", refine_phase=PHASE_WARM)
    else:
        def call(d):
            return run_pair(pair.left, pair.right, 4, cfg, device="cpu",
                            draws=d)
        draws = TorchDraws(4, "cpu")
    got, want = call(draws), call(RefineOnly(draws))
    for key in ("dis", "abc", "cost"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("case", [
    "dtype", "rank", "views", "last", "contiguous", "k0", "k17", "step",
    "round", "iteration", "key", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    abc = abc_field(4, 6)
    kw = dict(phase=1, iteration=0, rounds=range(0, 4), zs=np.ones(20),
              ns=np.ones(20), eps=1e-8)
    key = (1, 2)
    if case == "dtype":
        abc = abc.double()
    elif case == "rank":
        abc = abc[0]
    elif case == "views":
        abc = torch.cat([abc, abc[:1]])
    elif case == "last":
        abc = abc[..., :2].contiguous()
    elif case == "contiguous":
        abc = abc.transpose(1, 2)
    elif case == "k0":
        kw["rounds"] = range(3, 3)
    elif case == "k17":
        kw["rounds"] = range(0, 17)
    elif case == "step":
        kw["rounds"] = range(0, 8, 2)
    elif case == "round":
        kw["rounds"] = range((1 << 16) - 1, (1 << 16) + 1)
    elif case == "iteration":
        kw["iteration"] = 1 << 32
    elif case == "key":
        key = (1 << 32, 0)
    # every case is refused before the device is looked at; "device" is
    # the CPU tensor itself
    with pytest.raises(ValueError):
        rp.refine_propose_cuda(abc, key, **kw)


def test_refine_propose_work():
    """RPROP's bytes (both views' planes read once, the K candidates
    written once) and operations; bound by bytes: 0.0200 ms a KITTI stage
    (K = 5), 0.0073 and 0.0060 ms Middlebury's two (K = 5, 4)."""
    b, f = roofline.refine_propose_work(5, 375, 1242)
    assert b == 2 * 375 * 1242 * 12 * 6 == 67_068_000
    assert f == 2 * 375 * 1242 * (11 + 33 * 5)
    assert roofline.bound(b, f)[1] == "bytes"
    assert round(roofline.bound(b, f)[0], 4) == 0.0200
    for k, ms in ((5, 0.0073), (4, 0.0060)):
        b, f = roofline.refine_propose_work(k, 375, 450)
        assert round(roofline.bound(b, f)[0], 4) == ms
