"""A cell's inputs and its closed loop: the configuration and the traffic
mix read from their files, the configuration's plain reference resolved,
the frames made from the seed and put on the device, and pairs run one at
a time through the program's entry point.

Everything that belongs to one configuration or one mix is data in its
file; nothing here names a cell.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import time
from typing import List

import numpy as np
import torch

from .scene import make_scene

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ENTRIES = ("run_pair", "run_pair_warm")
# the plain reference of a configuration whose file names none
REFERENCE = "stereobench.reference"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # stereobench/configs/<config>.json
    traffic: dict       # stereobench/traffic/<traffic>.json
    per_layer: list     # BENCHMARK.json's per-layer metrics
    reference: object   # the configuration's plain reference module


def reference_of(config: dict):
    """The plain reference module that a configuration names under
    "reference" (a module under stereobench; REFERENCE where the key is
    absent).  It exposes check_engine(engine), outputs(l, r, abc, engine,
    compute=..., store=...) and CONTROLS (name -> (compute, store))."""
    name = config.get("reference", REFERENCE)
    if not name.startswith("stereobench."):
        raise ValueError(f"reference {name!r} is not a module under "
                         "stereobench")
    return importlib.import_module(name)


def load_cell(name: str, bench: dict | None = None,
              root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`), with its
    configuration and traffic files read and its reference resolved;
    ValueError if it is not there or its reference does not cover its
    engine."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    wl = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(os.path.join(root, cfg["file"]))
    reference = reference_of(config)
    reference.check_engine(config["engine"])
    return Cell(name=name, chips=wl["chips"], config=config,
                traffic=load_json(os.path.join(
                    root, "stereobench", "traffic", wl["traffic"] + ".json")),
                per_layer=bench["per_layer"], reference=reference)


def engine_config(config: dict):
    """The program's CSPMConfig from the file's "engine" fields, every one
    of which the file gives (ValueError if one is missing)."""
    from crossscalepatchmatch_tpu_torch.config import (Aggregator,
                                                       CostMethod,
                                                       CSPMConfig)

    e = dict(config["engine"])
    missing = {f.name for f in dataclasses.fields(CSPMConfig)} - set(e)
    if missing:
        raise ValueError(f"engine fields not given: {sorted(missing)}")
    e["cost_method"] = CostMethod(e["cost_method"])
    e["aggregator"] = Aggregator(e["aggregator"])
    e["far_offsets"] = tuple(e["far_offsets"])
    return CSPMConfig(**e)


def stream_seed(seed: int, stream: int) -> int:
    """A 62-bit seed of one random stream of the run (scene order, noise,
    draws, the checked sample), derived from --seed."""
    ss = np.random.SeedSequence([seed % 2 ** 64, stream])
    return int(ss.generate_state(1, np.uint64)[0] >> 2)


def make_scenes(config: dict, traffic: dict) -> list:
    """The configuration's fixed set of scenes, noise-free, each as wide as
    the frame plus the mix's pan over a scene's frames."""
    f = config["frame"]
    extra = traffic["pan_px"] * (traffic["frames_per_scene"] - 1)
    return [make_scene(f["height"], f["width"] + extra,
                       config["max_disparity"], s["seed"], s["n_fg"],
                       noise_sigma=0.0)
            for s in config["scenes"]]


class Pool:
    """The frames of a run on the device, and their ground truth.  Frame i
    shows scene order[(i // F) % S] (F the mix's frames_per_scene, the S
    scenes of the configuration in an order drawn from the seed) through a
    window of the frame's width panned k * pan_px columns along it,
    k = i % F: a camera that moves past the scene.  Each of the S * F
    frames carries its own draw of sensor noise, so consecutive frames
    never repeat."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 scenes: list | None = None):
        self.h, self.w = config["frame"]["height"], config["frame"]["width"]
        self.thresh = config["bad_px_threshold"]
        self.scale = config["engine"]["dis_scale"]
        self.fps = traffic["frames_per_scene"]
        self.pan = traffic["pan_px"]
        self.device = device
        scenes = scenes or make_scenes(config, traffic)
        self.order = np.random.default_rng(
            stream_seed(seed, 0)).permutation(len(scenes))
        gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
        sigma = traffic["noise_sigma"]
        self.frames, self.gt = [], []
        for sc in scenes:
            wide = [torch.as_tensor(v, device=device).float()
                    for v in (sc.left, sc.right)]
            shots = []
            for k in range(self.fps):
                o = k * self.pan
                shots.append(tuple(
                    (v[:, o:o + self.w] + sigma * torch.randn(
                        (self.h, self.w, 3), generator=gen, device=device))
                    .clamp(0, 255).to(torch.uint8) for v in wide))
            self.frames.append(shots)
            self.gt.append((torch.as_tensor(sc.disp_left),
                            torch.as_tensor(sc.valid_left)))
        self._truth = {}

    def scene_of(self, i: int) -> int:
        return int(self.order[(i // self.fps) % len(self.order)])

    def frame(self, i: int):
        """(left, right) u8[H, W, 3] views of frame i."""
        return self.frames[self.scene_of(i)][i % self.fps]

    def truth(self, i: int):
        """(disparity f64[H, W], non-occluded bool[H, W]) of frame i's left
        view, on the device: the scene's, cut to the frame, without the
        pixels whose match lies left of the frame's right view."""
        key = (self.scene_of(i), i % self.fps)
        if key not in self._truth:
            disp, valid = self.gt[key[0]]
            o = key[1] * self.pan
            d = disp[:, o:o + self.w]
            xs = torch.arange(self.w, dtype=torch.float32)[None, :]
            inside = torch.round(xs - d) >= 0
            self._truth[key] = (d.double().to(self.device),
                                (valid[:, o:o + self.w] & inside)
                                .to(self.device))
        return self._truth[key]

    def bad_px(self, i: int, dis_left) -> float:
        """The share, in %, of frame i's non-occluded left pixels whose
        disparity in the u8 map `dis_left` [H, W] is off by more than the
        configuration's threshold."""
        d, valid = self.truth(i)
        err = (dis_left.to(self.device).double() / self.scale - d).abs() \
            > self.thresh
        return 100.0 * float((err & valid).sum()) / max(int(valid.sum()), 1)


@dataclasses.dataclass
class Kept:
    """A pair of the window kept for the check: its frame and outputs."""
    index: int
    out: dict


class Loop:
    """The closed loop of a cell: one pair in flight, each pair's latency
    from the call until its outputs are synchronised on the device."""

    def __init__(self, cell: Cell, seed: int, device,
                 scenes: list | None = None):
        from crossscalepatchmatch_tpu_torch.models import pipeline

        t = cell.traffic
        if t["entry"] not in ENTRIES or t["loop"] != "closed" \
                or t["in_flight"] != 1:
            raise ValueError(f"traffic {t}: this harness runs {ENTRIES} in "
                             "a closed loop with one pair in flight")
        self.device = torch.device(device)
        self.cfg = engine_config(cell.config)
        self.warm = t["entry"] == "run_pair_warm"
        self.warm_iters = t.get("warm_iters", 1)
        self.pipeline = pipeline
        self.pool = Pool(cell.config, t, seed, self.device, scenes)
        self.draw_base = stream_seed(seed, 2)
        self.sample = np.random.default_rng(stream_seed(seed, 3))
        self.keep_n = cell.config["check_pairs"]
        self.next = 0
        self.prior = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> dict:
        """Run the next pair; its outputs (on the device, synchronised)."""
        i = self.next
        self.next += 1
        l, r = self.pool.frame(i)
        seed = self.draw_base + i
        if self.warm and self.prior is not None:
            out = self.pipeline.run_pair_warm(
                l, r, seed, self.prior, self.cfg, self.warm_iters,
                device=self.device)
        else:
            out = self.pipeline.run_pair(l, r, seed, self.cfg,
                                         device=self.device)
        self.prior = out["abc"] if self.warm else None
        self.sync()
        return out

    def run(self, seconds: float | None = None, pairs: int | None = None,
            maps: str | None = "host") -> "Window":
        """Pairs until `seconds` have passed (the last pair started inside
        them is finished) or `pairs` have run; returns the window.  Each
        pair's left u8 map is kept for the bad-pixel shares worked out once
        the window has closed: with `maps` "host" copied to the host after
        the pair's latency is read (a long window's maps would crowd the
        device's peak), with "device" held where the program left it (no
        op of the harness's own, for a short traced window), with None not
        kept."""
        win = Window()
        t0 = time.perf_counter()
        while True:
            n = len(win.ms)
            if pairs is not None and n >= pairs:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            i = self.next
            ts = time.perf_counter()
            out = self.step()
            win.ms.append((time.perf_counter() - ts) * 1e3)
            if maps == "host":
                win.maps.append((i, out["dis"][0].to("cpu")))
            elif maps == "device":
                win.maps.append((i, out["dis"][0]))
            self._keep(win, n, Kept(i, out))
            win.seconds = time.perf_counter() - t0
        return win

    def _keep(self, win: "Window", n: int, kept: Kept) -> None:
        """A uniform sample of keep_n pairs of the window (reservoir
        sampling, drawn from the seed)."""
        if n < self.keep_n:
            win.kept.append(kept)
            return
        j = int(self.sample.integers(0, n + 1))
        if j < self.keep_n:
            win.kept[j] = kept


@dataclasses.dataclass
class Window:
    ms: List[float] = dataclasses.field(default_factory=list)
    maps: list = dataclasses.field(default_factory=list)  # (i, u8[H, W])
    kept: List[Kept] = dataclasses.field(default_factory=list)
    seconds: float = 0.0

    def bad_px(self, pool: Pool) -> List[float]:
        """Each pair's bad-pixel share, in %, in the window's order."""
        return [pool.bad_px(i, m) for i, m in self.maps]
