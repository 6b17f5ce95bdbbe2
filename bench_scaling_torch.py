"""Scaling-efficiency benchmark of the PyTorch port's sharded pipeline
(crossscalepatchmatch_tpu_torch.parallel): stereo pairs/s on one rank
against the whole mesh.

    torchrun --nproc-per-node=N bench_scaling_torch.py [--h 384] [--w 448]
        [--max_dis 60] [--wnd 35] [--batch B] [--reps 10] [--device cuda]
    python3 bench_scaling_torch.py --project [--t1 S] [--host_link_gbs G]

The port's counterpart of bench_scaling.py, on its workload: GRD, max_dis
60, wnd 35, dis_scale 4 and the production defaults at 384x448, pair s
being data.make_pair(h, w, max_dis, seed=s).  Without --batch one pair's
rows are sharded over "ty" (a mesh size n is skipped where h % n or
h // n < half_wnd); --batch B shards a fixed batch of B pairs over "data"
(n skipped where B % n).  Both are strong scaling: fixed work, a growing
number of ranks.

Launch: under torchrun every rank joins torchrun's group
(parallel.mesh.initialize_multihost: NCCL where every rank has a card of
its own, gloo where ranks share one); without torchrun it runs as a world
of one rank.  The meshes are n = 1 and n = the world: the n = 1 mesh spans
rank 0 (parallel.mesh.make_mesh over the first ranks), the other ranks
idle at the end-of-call barrier.  Per mesh: one untimed warm-up call
(draw seeds 0..B-1; it builds the kernels), then --reps timed calls with
draw seeds B*i + j.  Each call ends in torch.cuda.synchronize() on every
rank and a gather of every rank's readings (a barrier); its time is the
slowest rank's host-clock time.  Every timed call is gated: each pair's
left map (gathered) has non-occluded bad-pixel @1px <= BAD_PIXEL_MAX
(0.01), and on the full mesh the mean over the calls is within GAP_MAX
(0.005) of the n = 1 run's.  A miss raises GateMissed on every rank, so
the run exits non-zero and prints no result line.

Rank 0 prints one JSON line per mesh, bench_scaling.py's keys ("metric":
"sharded_pairs_per_second", "mesh": "ty=n" / "data=n", "value" pairs/s,
"efficiency_vs_1dev" = value / (value at n = 1 * n), "platform", "note")
and the device (name and power limit from nvidia-smi, card count), the
transport, the world, reps, the seconds a call (median, quartiles, min,
max), the bad-pixel (mean, max), the bytes staged through the host a call
(parallel._comm.host_bytes, every rank) and the kernel launches of the
timed calls (every rank).  "note" says what the row measures: "real
devices" only with NCCL and one card a rank; ranks sharing one card run
over gloo, their halos staged through the host, and the CPU (--device
cpu, the tests) runs the plain versions: those rows measure the
mechanism only.

--project prints bench_scaling.py's analytic projection (project_rows:
its formula, mesh rows and keys) on inputs taken here: t1, the n = 1
run's median s/pair (or --t1); the card-to-card bandwidth, a timed
cuda:0 -> cuda:1 copy of one halo message where the host has two or more
cards; the link between hosts, which one host cannot measure, only as
--host_link_gbs.  A row whose link has no figure is left out and named.
With no card-to-card figure and no --host_link_gbs it exits 2.

Runs on the card; without a CUDA device and without --device cpu it
exits 1.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from crossscalepatchmatch_tpu_torch.config import CostMethod, CSPMConfig
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.parallel import _comm
from crossscalepatchmatch_tpu_torch.parallel.mesh import (
    initialize_multihost, make_mesh)
from crossscalepatchmatch_tpu_torch.parallel.tiled import (
    rank_device, run_batch_sharded)
from crossscalepatchmatch_tpu_torch.utils.profiling import (
    launch_counts, reset_launch_counts)

THRESH_PX = 1.0
BAD_PIXEL_MAX = 0.01        # every pair of a timed call
GAP_MAX = 0.005             # |mean bad-pixel, full mesh - n = 1|
# the projection's cluster shapes (bench_scaling.py): (hosts, cards)
PROJECTED = ((1, 4), (1, 8), (2, 16), (4, 32))
LINK_COPIES = 50            # timed copies of the card-to-card link


class GateMissed(RuntimeError):
    """A timed call's output missed its correctness gate."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def quartiles(xs):
    q1, med, q3 = np.percentile(np.asarray(xs, np.float64), (25, 50, 75))
    return dict(median=float(med), q1=float(q1), q3=float(q3),
                min=float(min(xs)), max=float(max(xs)))


def describe_device(dev) -> dict:
    """What the run ran on: the card's name, power limit (nvidia-smi) and
    count; "cpu" and no limit on the CPU."""
    if dev.type != "cuda":
        return dict(kind="cpu", power_limit=None, count=0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    idx = dev.index or 0
    limit = smi[idx].split(",")[-1].strip() if len(smi) > idx else None
    return dict(kind=torch.cuda.get_device_name(dev), power_limit=limit,
                count=torch.cuda.device_count())


def workload_cfg(args) -> CSPMConfig:
    return CSPMConfig(max_dis=args.max_dis, dis_scale=4, wnd_size=args.wnd,
                      cost_method=CostMethod.GRD)


def mesh_plan(args, world: int, half_wnd: int):
    """[(name, n, mesh shape)] of the runs, in order (the module note)."""
    plan = []
    for n in sorted({1, world}):
        if args.batch > 0:
            if args.batch % n == 0:
                plan.append((f"data={n}", n, (n, 1, 1)))
        elif args.h % n == 0 and args.h // n >= half_wnd:
            plan.append((f"ty={n}", n, (1, n, 1)))
    return plan


def run_note(on_card: bool, backend: str) -> str:
    if not on_card:
        return "CPU ranks (gloo, plain versions) -- mechanism only"
    if backend == "nccl":
        return "real devices"
    return "ranks share one card (gloo, host-staged) -- mechanism only"


def _gather(vec: torch.Tensor, comm_dev) -> torch.Tensor:
    """Every rank's f64 vector, [world, k] on the host, rank order."""
    vec = vec.to(comm_dev)
    parts = [torch.empty_like(vec) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, vec)
    return torch.stack(parts).cpu()


def time_mesh(mesh, cfg, l, r, pairs, reps: int, dev, comm_dev) -> list:
    """The warm-up and `reps` timed calls of run_batch_sharded on `mesh`;
    per timed call (the same on every rank): the slowest rank's seconds,
    the bytes staged through the host and the launches (every rank), and
    the batch's bad-pixel (mean, max) from rank 0's gathered maps.  Raises
    GateMissed on every rank when a call's worst pair is over
    BAD_PIXEL_MAX."""
    b = l.shape[0]
    calls = []
    for i in range(reps + 1):
        seeds = [b * i + j for j in range(b)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.all_reduce(torch.zeros(1, device=comm_dev))
        reset_launch_counts()
        _comm.host_bytes = 0
        t0 = time.perf_counter()
        dis = run_batch_sharded(l, r, seeds, cfg, mesh, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        bads = [0.0]
        if dist.get_rank() == 0:
            maps = dis.cpu().numpy()
            bads = ([bad_pixel_rate(maps[k, 0] / cfg.dis_scale, p.disp_left,
                                    p.valid_left, THRESH_PX)
                     for k, p in enumerate(pairs)]
                    if maps.shape == (b, 2, *l.shape[1:3]) else [np.inf])
        counts = launch_counts()
        got = _gather(torch.tensor(
            [dt, _comm.host_bytes, float(np.mean(bads)), max(bads),
             *counts.values()], dtype=torch.float64), comm_dev)
        if i == 0:
            continue                                  # the warm-up
        call = dict(s=float(got[:, 0].max()), host_bytes=int(got[:, 1].sum()),
                    bad_mean=float(got[0, 2]), bad_max=float(got[0, 3]),
                    launches=dict(zip(counts, got[:, 4:].sum(0).long()
                                      .tolist())))
        if not call["bad_max"] <= BAD_PIXEL_MAX:
            raise GateMissed(f"timed call {i}: bad-pixel @{THRESH_PX:g}px "
                             f"{call['bad_max']:.4f} > {BAD_PIXEL_MAX}")
        calls.append(call)
    return calls


def measure(args, dev, only_one_rank: bool = False) -> list:
    """Every mesh's JSON record (the module note), the same on every rank;
    only the n = 1 mesh with only_one_rank (--project's t1)."""
    cfg = workload_cfg(args)
    world, backend = dist.get_world_size(), dist.get_backend()
    rdev = rank_device(dev)
    comm_dev = rdev if backend == "nccl" else torch.device("cpu")
    b = max(args.batch, 1)
    pairs = [make_pair(h=args.h, w=args.w, max_dis=args.max_dis, seed=s)
             for s in range(b)]
    l = torch.as_tensor(np.stack([p.left for p in pairs]), device=rdev)
    r = torch.as_tensor(np.stack([p.right for p in pairs]), device=rdev)
    device = describe_device(rdev)
    note = run_note(dev.type == "cuda", backend)
    plan = mesh_plan(args, world, cfg.half_wnd)
    rows = []
    for name, n, shape in plan[:1] if only_one_rank else plan:
        mesh = make_mesh(*shape)
        calls = time_mesh(mesh, cfg, l, r, pairs, args.reps, rdev, comm_dev)
        q = quartiles([c["s"] for c in calls])
        value = b / q["median"]
        base = rows[0]["value"] if rows else value
        row = dict(
            metric="sharded_pairs_per_second", mesh=name, value=value,
            efficiency_vs_1dev=value / (base * n),
            platform="gpu" if dev.type == "cuda" else "cpu", note=note,
            device=device, transport=_comm.transport(mesh), world=world,
            shape=[args.h, args.w, args.max_dis, args.wnd], batch=b,
            reps=args.reps, s_per_call=q,
            bad_pixel=dict(thresh=THRESH_PX, gate=BAD_PIXEL_MAX,
                           gap_max=GAP_MAX,
                           mean=float(np.mean([c["bad_mean"]
                                               for c in calls])),
                           max=max(c["bad_max"] for c in calls)),
            host_bytes_per_call=float(np.mean([c["host_bytes"]
                                               for c in calls])),
            launches={k: sum(c["launches"][k] for c in calls)
                      for k in calls[0]["launches"]})
        if rows:
            gap = row["bad_pixel"]["mean"] - rows[0]["bad_pixel"]["mean"]
            if not abs(gap) <= GAP_MAX:
                raise GateMissed(f"mesh {name}: bad-pixel mean "
                                 f"{row['bad_pixel']['mean']:.4f} against "
                                 f"{rows[0]['bad_pixel']['mean']:.4f} at "
                                 f"n = 1, gap over {GAP_MAX}")
        if dist.get_rank() == 0:
            log(f"{name}: {q['median'] * 1e3:.1f} ms a call (quartiles "
                f"{q['q1'] * 1e3:.1f} / {q['q3'] * 1e3:.1f}, {args.reps} "
                f"calls), {row['value']:.3f} pairs/s, efficiency "
                f"{row['efficiency_vs_1dev']:.3f}; bad-pixel @1px mean "
                f"{row['bad_pixel']['mean']:.4f} max "
                f"{row['bad_pixel']['max']:.4f}; "
                f"{row['host_bytes_per_call']:.0f} bytes staged a call; "
                f"{row['transport']}; {device['kind']}, power limit "
                f"{device['power_limit']}")
        rows.append(row)
    return rows


# -- the projection ---------------------------------------------------------

def halo_message_bytes(w: int, cfg: CSPMConfig) -> int:
    """One plane-halo message of a propagation sweep: (far ring + half
    window) rows of the f32 plane field [W, 3]."""
    return (max(cfg.far_offsets) + cfg.half_wnd) * w * 3 * 4


def project_rows(h: int, w: int, cfg: CSPMConfig, t1: float,
                 card_bps, host_bps):
    """bench_scaling.project's rows (its formula and meshes): per
    iteration, sweep, view and side one halo message; t_comm = the
    messages' bytes over the link's bytes/s (card_bps between the cards of
    a host, host_bps per card between hosts), t_comp = t1 over the cards
    with the round-up of rows; efficiency t_comp / (t_comp + t_comm), no
    overlap.  A row whose link is None is left out.  Returns (rows, the
    left-out meshes)."""
    halo_bytes = (cfg.max_iter * cfg.prop_sweeps * 2 * 2
                  * halo_message_bytes(w, cfg))
    rows, left_out = [], []

    def row(n_hosts, n_cards, mesh, ty, bps):
        if bps is None:
            left_out.append(mesh)
            return
        t_comm = halo_bytes / bps
        t_comp = t1 * (-(-h // ty) * ty) / h / ty
        rows.append({"hosts": n_hosts, "chips": n_cards, "mesh": mesh,
                     "t_comp_s": round(t_comp, 4),
                     "t_comm_s": round(t_comm, 6),
                     "projected_efficiency": round(
                         t_comp / (t_comp + t_comm), 4)})

    for n_hosts, n_cards in PROJECTED:
        # data across hosts (no steady-state traffic between them), rows
        # over each host's cards
        ty = n_cards // n_hosts
        row(n_hosts, n_cards, f"(data={n_hosts}, ty={ty})", ty, card_bps)
        if n_hosts > 1:
            # one pair's rows over every card: halos cross hosts
            row(n_hosts, n_cards, f"(ty={n_cards} across hosts)", n_cards,
                host_bps)
    return rows, left_out


def card_link_bytes_per_s(nbytes: int) -> float:
    """A cuda:0 -> cuda:1 copy of `nbytes`, LINK_COPIES times between CUDA
    events on cuda:0's stream (the copy's), after one untimed copy."""
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda:0")
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda:1")
    dst.copy_(src)
    for d in (0, 1):
        torch.cuda.synchronize(d)
    with torch.cuda.device(0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LINK_COPIES):
            dst.copy_(src, non_blocking=True)
        end.record()
    for d in (0, 1):
        torch.cuda.synchronize(d)
    return nbytes * LINK_COPIES / (start.elapsed_time(end) / 1e3)


def project_line(args, dev, t1: float, t1_source: str, card_bps) -> dict:
    cfg = workload_cfg(args)
    host_bps = (None if args.host_link_gbs is None
                else args.host_link_gbs * 1e9)
    rows, left_out = project_rows(args.h, args.w, cfg, t1, card_bps,
                                  host_bps)
    msg = halo_message_bytes(args.w, cfg)
    card = ("not measured (fewer than two cards)" if card_bps is None else
            f"{card_bps / 1e9} GB/s (cuda:0 -> cuda:1, measured, "
            f"{msg}-byte halo message)")
    host = ("not given" if host_bps is None
            else f"{args.host_link_gbs} GB/s a card (--host_link_gbs)")
    return {
        "metric": "projected_scaling_efficiency",
        "workload": f"{args.h}x{args.w} max_dis={args.max_dis} GRD, "
                    f"t1={t1}s/pair",
        "model": f"t_comp/(t_comp+t_comm), no overlap; card link {card}; "
                 f"host link {host}",
        "target": ">=0.80 at >=2 hosts",
        "rows": rows,
        "left_out": [f"{m}: no figure for its link" for m in left_out],
        "t1_source": t1_source,
        "device": describe_device(dev),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=int, default=384)
    ap.add_argument("--w", type=int, default=448)
    ap.add_argument("--max_dis", type=int, default=60)
    ap.add_argument("--wnd", type=int, default=35)
    ap.add_argument("--batch", type=int, default=0,
                    help=">0: shard a fixed batch of B pairs over 'data'")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed calls a mesh, after one warm-up call")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks compute (default: the card)")
    ap.add_argument("--project", action="store_true",
                    help="print the analytic multi-host projection")
    ap.add_argument("--t1", type=float, default=None,
                    help="s/pair on one card for --project (default: "
                         "measured, the n = 1 run's median)")
    ap.add_argument("--host_link_gbs", type=float, default=None,
                    help="GB/s a card between hosts, for --project's rows "
                         "that cross hosts (one host cannot measure it)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    link_measurable = on_card and torch.cuda.device_count() >= 2
    if args.project and not link_measurable and args.host_link_gbs is None:
        log("bench_scaling_torch --project: no link bandwidth: this host "
            "has fewer than two cards to measure one, and no "
            "--host_link_gbs was given")
        return 2
    if on_card and not torch.cuda.is_available():
        log("bench_scaling_torch: no CUDA device (torch.cuda.is_available() "
            "is False); --device cpu runs the plain versions on the CPU")
        return 1
    if on_card:
        # this rank's card (LOCAL_RANK under torchrun), before any group
        torch.cuda.set_device(rank_device(dev))
    owned = not dist.is_initialized()
    initialize_multihost(device=args.device)
    try:
        rank = dist.get_rank()
        if not args.project:
            rows = measure(args, dev)
            if rank == 0:
                for row in rows:
                    print(json.dumps(row), flush=True)
            return 0
        t1, source = args.t1, "given (--t1)"
        if t1 is None:
            base = measure(args, dev, only_one_rank=True)[0]
            t1 = base["s_per_call"]["median"] / base["batch"]
            source = (f"measured: mesh {base['mesh']}, median of "
                      f"{args.reps} calls")
        if rank == 0:
            card_bps = (card_link_bytes_per_s(halo_message_bytes(
                args.w, workload_cfg(args))) if link_measurable else None)
            print(json.dumps(project_line(args, dev, t1, source, card_bps)),
                  flush=True)
        return 0
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
