"""Accuracy parity scoring of the port against the native oracle (the
reference's semantics): the config matrix, the use_cs ablation and the
production-size anchor, on the port's engine.

The scoring logic of the repository's eval.py and tools/kitti_anchor.py
(which run the JAX engine), with its own copies of their tables and scene
recipes, so the oracle scores those tools cached belong to the same scenes
and can be read here:

  * CONFIGS (eval.py's 13 rows), CS_SCENES (its 5 ablation scenes) and
    ANCHOR (kitti_anchor.py's defaults: 256x832, d=96, GRD + PP, scene seed
    7, 5 engine seeds, @3px);
  * make_scene: make_pair with the crc32 scene seed and, for a photo row,
    photo_textures of the host photograph (None when there is none);
  * row_config: scale_num / reg_lambda follow use_cs; parse_set / overrides:
    eval.py's --adopt, --exact-iters, --refine-stages and --set KEY=VALUE;
  * the statistics: the matrix and the anchor take eval.py's unpaired
    bootstrap (default_rng(0) per row: the engine's and the oracle's seeds
    are independent samples); the use_cs ablation's bootstrap is paired by
    seed (cs - ss on the same seed), with a generator per scene seeded from
    the scene's name, so a scene's interval does not depend on the scenes
    run before it;
  * OracleScores: read-only access to .eval_oracle_cache.json and
    tools/.kitti_anchor_cache.json; a miss runs the port's oracle binding
    and keeps the scores in memory only.

The engine is an argument (engine(left, right, cfg, seed) -> u8[2, H, W]
maps); engine_on(device) runs models.pipeline.run_pair_np there.  No jax.
"""

from __future__ import annotations

import json
import os
import sys
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .config import CostMethod, CSPMConfig
from .data import StereoPair, load_host_photo, make_pair, photo_textures
from .metrics import bad_pixel_rate

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_CACHE = os.path.join(_ROOT, ".eval_oracle_cache.json")
ANCHOR_CACHE = os.path.join(_ROOT, "tools", ".kitti_anchor_cache.json")

BOUND = 0.005          # BASELINE.json: bad-pixel delta vs the oracle
N_BOOT = 10000

# (name, scene h, scene w, max_dis, dis_scale, cc, use_cs, use_pp,
#  scene kwargs): eval.py's CONFIGS.  max_dis / dis_scale / cc / pp follow
# the reference's input.txt (Middlebury pairs with CEN + post-processing,
# and the README GRD demo) on synthetic scenes with matching disparity
# ranges; then occlusion-heavy and low-texture scenes, sensor noise,
# inter-camera exposure mismatch, imperfect rectification, and textures
# from a real photograph.
CONFIGS = [
    ("readme_demo_grd", 192, 256, 16, 8, "GRD", False, False, {}),
    ("tsukuba_cen_pp", 192, 256, 16, 16, "CEN", False, True, {}),
    ("venus_cen_pp", 192, 256, 20, 8, "CEN", False, True, {}),
    ("cones_cen_pp", 160, 224, 24, 4, "CEN", False, True, {}),
    ("teddy_cen_cs_pp", 160, 224, 24, 4, "CEN", True, True, {}),
    ("reindeer_cen_pp", 192, 416, 80, 3, "CEN", False, True, {}),
    ("occlusions_cen_pp", 176, 240, 24, 4, "CEN", False, True,
     {"n_fg": 4}),
    ("lowtex_grd_pp", 192, 256, 16, 8, "GRD", False, True,
     {"texture_contrast": 0.3}),
    ("noisy_cen_pp", 192, 256, 20, 8, "CEN", False, True,
     {"noise_sigma": 4.0}),
    ("exposure_grd_pp", 192, 256, 16, 8, "GRD", False, True,
     {"exposure_gain": 1.15, "exposure_bias": 6.0}),
    ("rectjitter_cen_pp", 192, 256, 20, 8, "CEN", False, True,
     {"rect_jitter": 0.5}),
    ("photo_cen_pp", 192, 256, 20, 8, "CEN", False, True,
     {"photo": True}),
    ("photo_grd", 192, 256, 16, 8, "GRD", False, False,
     {"photo": True}),
]
QUICK = CONFIGS[:2]

# the paired use_cs ablation's scenes (eval.py's CS_SCENES): weak data
# terms, photometric noise, natural texture, and a clean control; CEN
# without PP isolates the aggregation from the post-processor
CS_SCENES = [
    ("lowtex", 192, 256, 20, 8, {"texture_contrast": 0.3}),
    ("noisy", 192, 256, 20, 8, {"noise_sigma": 4.0}),
    ("noisy_lowtex", 192, 256, 20, 8,
     {"noise_sigma": 4.0, "texture_contrast": 0.5}),
    ("photo", 192, 256, 20, 8, {"photo": True}),
    ("clean", 160, 224, 24, 4, {}),
]

# tools/kitti_anchor.py's defaults: one KITTI-like scene at production
# geometry, GRD + post-processing, scored @3px
ANCHOR = dict(h=256, w=832, max_dis=96, dis_scale=2, cc="GRD", scene_seed=7,
              engine_seeds=5, oracle_seeds=2, thresh=3.0)

Engine = Callable[[np.ndarray, np.ndarray, CSPMConfig, int], np.ndarray]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def engine_on(device="cuda", draws_for=None) -> Engine:
    """The port's run_pair_np on `device` as an Engine; draws_for(seed,
    cfg), if given, makes each run's draw source (the tests hand in the JAX
    engine's)."""
    from .models.pipeline import run_pair_np

    def run(left, right, cfg, seed):
        draws = None if draws_for is None else draws_for(seed, cfg)
        return run_pair_np(left, right, cfg, seed, device=device,
                           draws=draws)["dis"]

    return run


def device_name(device) -> str:
    """What a result ran on: the card's name, or "cpu"."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def scene_seed(name: str) -> int:
    """The stable per-row scene seed (str hash is salted per process)."""
    return zlib.crc32(name.encode()) % 1000


def make_scene(name: str, h: int, w: int, max_dis: int,
               scene_kw: dict) -> Optional[StereoPair]:
    """The row's synthetic pair, eval.py's recipe; None for a photo row on a
    host without the photograph."""
    cseed = scene_seed(name)
    scene_kw = dict(scene_kw)
    if scene_kw.pop("photo", False):
        photo = load_host_photo()
        if photo is None:
            return None
        scene_kw["textures"] = photo_textures(
            photo, 5, h, w + max_dis + 4, np.random.default_rng(cseed))
    return make_pair(h=h, w=w, max_dis=max_dis, seed=cseed, **scene_kw)


def anchor_scene(h=ANCHOR["h"], w=ANCHOR["w"],
                 max_dis=ANCHOR["max_dis"]) -> StereoPair:
    return make_pair(h=h, w=w, max_dis=max_dis, seed=ANCHOR["scene_seed"])


def parse_set(items: Sequence[str]) -> dict:
    """--set KEY=VALUE items as config overrides: booleans, then int, then
    float, else the string (eval.py's parsing)."""
    out = {}
    for kv in items:
        key, _, val = kv.partition("=")
        if val in ("True", "true", "False", "false"):
            val = val in ("True", "true")
        else:
            try:
                val = int(val)
            except ValueError:
                try:
                    val = float(val)
                except ValueError:
                    pass
        out[key] = val
    return out


def overrides(adopt: Optional[str] = None, exact_iters: Optional[int] = None,
              refine_stages: Optional[int] = None,
              sets: Sequence[str] = ()) -> dict:
    """The engine's config overrides from eval.py's flags."""
    kw = {} if adopt is None else dict(adopt_mode=adopt)
    if exact_iters is not None:
        kw["exact_iters"] = exact_iters
    if refine_stages is not None:
        kw["refine_stages"] = refine_stages
    kw.update(parse_set(sets))
    return kw


def row_config(max_dis: int, dis_scale: int, cc: str, use_cs: bool,
               use_pp: bool, **kw) -> CSPMConfig:
    """The engine's config of a row: 3 pyramid levels and lambda 0.3 with
    use_cs (the small scenes have 3 usable levels), else 5 and 0."""
    return CSPMConfig(max_dis=max_dis, dis_scale=dis_scale,
                      cost_method=CostMethod[cc], use_cs=use_cs,
                      use_pp=use_pp, scale_num=3 if use_cs else 5,
                      reg_lambda=0.3 if use_cs else 0.0, **kw)


def unpaired_ci_hi(engine_bads, oracle_bads, n_boot: int = N_BOOT) -> float:
    """eval.py's 95% upper bound on mean(engine) - mean(oracle): both sides
    resampled on their own, one default_rng(0) per row."""
    brng = np.random.default_rng(0)
    e_s = np.asarray(engine_bads, np.float64)
    o_s = np.asarray(oracle_bads, np.float64)
    d_bs = (brng.choice(e_s, (n_boot, e_s.size)).mean(axis=1)
            - brng.choice(o_s, (n_boot, o_s.size)).mean(axis=1))
    return float(np.quantile(d_bs, 0.975))


def paired_ci(cs, ss, scene: str, n_boot: int = N_BOOT):
    """95% interval of mean(cs - ss) over seeds, the seeds resampled in
    pairs; the generator is seeded from the scene's name."""
    d = np.asarray(cs, np.float64) - np.asarray(ss, np.float64)
    rng = np.random.default_rng(zlib.crc32(scene.encode()))
    idx = rng.integers(0, d.size, (n_boot, d.size))
    d_bs = d[idx].mean(axis=1)
    return (float(np.quantile(d_bs, 0.025)),
            float(np.quantile(d_bs, 0.975)))


class OracleScores:
    """The oracle's per-seed scores: the two caches, read only; a miss is
    computed with the port's oracle binding and kept in memory."""

    def __init__(self):
        self.eval = self._read(ORACLE_CACHE)
        self.anchor = self._read(ANCHOR_CACHE)
        self.computed: Dict[str, object] = {}

    @staticmethod
    def _read(path: str) -> dict:
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _lookup(self, key, compute):
        if key in self.eval:
            return self.eval[key]
        if key not in self.computed:
            log(f"oracle: {key} not cached, running the native oracle")
            self.computed[key] = compute()
        return self.computed[key]

    def row(self, name: str, pair: StereoPair, n: int, **kw):
        """(per-seed bad-pixel @1px, s per seed) of a matrix row; key
        '<name>/v2/<n>'."""
        def compute():
            t0 = time.perf_counter()
            bads = [oracle_bad(pair, seed=s, **kw) for s in range(n)]
            return [bads, (time.perf_counter() - t0) / max(n, 1)]

        bads, secs = self._lookup(f"{name}/v2/{n}", compute)
        return list(bads), secs

    def ablation(self, scene: str, pair: StereoPair, n: int,
                 **kw) -> List[float]:
        """Per-seed bad-pixel of an ablation side (kw: oracle_bad's, use_cs
        among them); key 'csab/<scene>/<use_cs>/<n>'."""
        return list(self._lookup(
            f"csab/{scene}/{kw['use_cs']}/{n}",
            lambda: [oracle_bad(pair, seed=s, **kw) for s in range(n)]))

    def anchor_scores(self, key: str):
        """(per-seed bad-pixel, s per seed) of the anchor, None if the anchor
        cache has no entry (the oracle takes hours there)."""
        entry = self.anchor.get(key, {}).get("oracle", {})
        if not entry:
            return None
        return [v[0] for v in entry.values()], [v[1] for v in entry.values()]


def oracle_bad(pair: StereoPair, *, max_dis: int, dis_scale: int, cc: str,
               use_cs: bool, use_pp: bool, seed: int) -> float:
    """The native oracle's bad-pixel @1px (left view) on a pair, eval.py's
    call: scale_num and reg_lambda as row_config sets them."""
    from . import oracle

    dis = oracle.run_pair(pair.left, pair.right, max_dis=max_dis,
                          dis_scale=dis_scale, cc_name=cc, use_cs=use_cs,
                          use_pp=use_pp, reg_lambda=0.3 if use_cs else 0.0,
                          scale_num=3 if use_cs else 5, seed=seed)
    return float(bad_pixel_rate(np.asarray(dis[0], np.float32) / dis_scale,
                                pair.disp_left, pair.valid_left, 1.0))


def median_ms(ms: Sequence[float]) -> float:
    """The median of the runs after the first (the first pays for building
    and loading), the one run's with a single run."""
    later = sorted(ms[1:] or ms)
    return later[len(later) // 2]


def score_engine(engine: Engine, pair: StereoPair, cfg: CSPMConfig,
                 seeds: int, thresh: float = 1.0):
    """(per-seed bad-pixel of the left view @thresh, per-seed ms) of seeds
    0 .. seeds - 1, each run timed on the host's clock (the engine returns
    host arrays, so a run has ended on the card)."""
    bads, ms = [], []
    for seed in range(seeds):
        t0 = time.perf_counter()
        dis = engine(pair.left, pair.right, cfg, seed)
        ms.append((time.perf_counter() - t0) * 1e3)
        bads.append(float(bad_pixel_rate(
            np.asarray(dis[0], np.float32) / cfg.dis_scale,
            pair.disp_left, pair.valid_left, thresh)))
    return bads, ms


def score_row(row, engine: Engine, oracle: OracleScores, *, seeds: int = 5,
              oracle_seeds: int = 5,
              engine_kw: Optional[dict] = None) -> Optional[dict]:
    """One matrix row (a CONFIGS entry, or one like it): the engine's and
    the oracle's mean bad-pixel @1px, the delta, its bootstrap upper bound
    and the bound's verdict, the per-seed scores, ms/pair (median_ms) and
    the last run's seconds (eval.py's t_engine_s); None for a photo row
    without the photograph."""
    name, h, w, max_dis, dis_scale, cc, use_cs, use_pp, scene_kw = row
    pair = make_scene(name, h, w, max_dis, scene_kw)
    if pair is None:
        return None
    bads_o, t_oracle = oracle.row(name, pair, oracle_seeds, max_dis=max_dis,
                                  dis_scale=dis_scale, cc=cc, use_cs=use_cs,
                                  use_pp=use_pp)
    cfg = row_config(max_dis, dis_scale, cc, use_cs, use_pp,
                     **(engine_kw or {}))
    bads, ms = score_engine(engine, pair, cfg, seeds)
    bad_o, bad_e = float(np.mean(bads_o)), float(np.mean(bads))
    ci_hi = unpaired_ci_hi(bads, bads_o)
    return dict(config=name, bad_oracle=round(bad_o, 4),
                bad_engine=round(bad_e, 4), delta=round(bad_e - bad_o, 4),
                delta_ci95_hi=round(ci_hi, 4), within_bound=ci_hi <= BOUND,
                t_oracle_s=round(t_oracle, 1),
                t_engine_s=round(ms[-1] / 1e3, 2),
                ms_pair=round(median_ms(ms), 1), engine_bads=bads,
                oracle_bads=list(bads_o))


def run_matrix(engine: Engine, oracle: OracleScores, rows=CONFIGS, *,
               seeds: int = 5, oracle_seeds: int = 5,
               engine_kw: Optional[dict] = None) -> dict:
    """eval.py's matrix on the engine: one stderr line a row, and the JSON
    summary (worst delta, worst CI upper end, the rows, the skipped
    rows)."""
    out, skipped = [], []
    for row in rows:
        r = score_row(row, engine, oracle, seeds=seeds,
                      oracle_seeds=oracle_seeds, engine_kw=engine_kw)
        if r is None:
            log(f"{row[0]}: skipped (no host photo available)")
            skipped.append(row[0])
            continue
        out.append(r)
        log(f"{r['config']:22s} oracle {r['bad_oracle']:.4f}  engine "
            f"{r['bad_engine']:.4f} ({r['ms_pair']:7.1f} ms/pair)  delta "
            f"{r['delta']:+.4f} (ci95<={r['delta_ci95_hi']:+.4f})  "
            f"{'OK' if r['within_bound'] else 'OVER'}")
    return {"metric": "bad_pixel_delta_vs_oracle_worst",
            "value": max((r["delta"] for r in out), default=None),
            "worst_ci95_hi": max((r["delta_ci95_hi"] for r in out),
                                 default=None),
            "bound": BOUND, "rows": out, "skipped": skipped}


def run_cs_ablation(engine: Engine, oracle: OracleScores, scenes=CS_SCENES,
                    *, seeds: int = 5, oracle_seeds: int = 5) -> dict:
    """The paired use_cs on/off comparison on CEN without PP: per side
    (engine, oracle; a side with 0 seeds is left out) the mean bad-pixel
    @1px single- and cross-scale, the delta cs - ss and its paired
    bootstrap interval."""
    rows, skipped = [], []
    for name, h, w, max_dis, dis_scale, scene_kw in scenes:
        pair = make_scene(name, h, w, max_dis, scene_kw)
        if pair is None:
            log(f"{name}: skipped (no host photo)")
            skipped.append(name)
            continue
        row = {"scene": name}
        for side, n in (("engine", seeds), ("oracle", oracle_seeds)):
            if n <= 0:
                continue
            bads, ms = {}, {}
            for use_cs in (False, True):
                if side == "engine":
                    cfg = row_config(max_dis, dis_scale, "CEN", use_cs, False)
                    bads[use_cs], runs = score_engine(engine, pair, cfg, n)
                    ms[use_cs] = median_ms(runs)
                else:
                    bads[use_cs] = oracle.ablation(
                        name, pair, n, max_dis=max_dis,
                        dis_scale=dis_scale, cc="CEN", use_cs=use_cs,
                        use_pp=False)
            lo, hi = paired_ci(bads[True], bads[False], name)
            row[side] = dict(
                ss=round(float(np.mean(bads[False])), 4),
                cs=round(float(np.mean(bads[True])), 4),
                delta=round(float(np.mean(bads[True])
                                  - np.mean(bads[False])), 4),
                delta_ci95=[round(lo, 4), round(hi, 4)])
            if ms:
                row[side]["ms_pair"] = {"ss": round(ms[False], 1),
                                        "cs": round(ms[True], 1)}
            log(f"{name:14s} {side:6s} ss {row[side]['ss']:.4f}  cs "
                f"{row[side]['cs']:.4f}  delta {row[side]['delta']:+.4f} "
                f"[{lo:+.4f}, {hi:+.4f}]")
        rows.append(row)
    return {"metric": "cs_ablation_bad_pixel", "rows": rows,
            "skipped": skipped}


def anchor_key(h: int, w: int, max_dis: int, cc: str) -> str:
    return f"{h}x{w}_d{max_dis}_{cc}_pp"


def run_anchor(engine: Engine, oracle: OracleScores, *, h=ANCHOR["h"],
               w=ANCHOR["w"], max_dis=ANCHOR["max_dis"],
               dis_scale=ANCHOR["dis_scale"], cc=ANCHOR["cc"],
               engine_seeds=ANCHOR["engine_seeds"],
               thresh=ANCHOR["thresh"]) -> Optional[dict]:
    """kitti_anchor.py --engine-only on the engine: the anchor scene scored
    @thresh against every cached oracle seed; None when the cache has no
    entry for this geometry."""
    key = anchor_key(h, w, max_dis, cc)
    cached = oracle.anchor_scores(key)
    if cached is None:
        return None
    bads_o, t_o = cached
    pair = anchor_scene(h, w, max_dis)
    cfg = CSPMConfig(max_dis=max_dis, dis_scale=dis_scale,
                     cost_method=CostMethod[cc], use_cs=False, use_pp=True)
    bads, ms = score_engine(engine, pair, cfg, engine_seeds, thresh)
    bad_o, bad_e = float(np.mean(bads_o)), float(np.mean(bads))
    ci_hi = unpaired_ci_hi(bads, bads_o)
    return dict(metric="kitti_anchor_bad3_delta_vs_oracle", scene=key,
                bad_oracle=round(bad_o, 4), bad_engine=round(bad_e, 4),
                delta=round(bad_e - bad_o, 4),
                delta_ci95_hi=round(ci_hi, 4), bound=BOUND,
                within_bound=ci_hi <= BOUND, oracle_seeds=len(bads_o),
                engine_seeds=len(bads),
                t_oracle_s=round(float(np.mean(t_o)), 0),
                t_engine_s=round(ms[-1] / 1e3, 2),
                ms_pair=round(median_ms(ms), 1), engine_bads=bads)
