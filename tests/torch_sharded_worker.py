"""One rank of a sharded test of the PyTorch port, in a process of its own.

    python tests/torch_sharded_worker.py CASE.pkl RANK WORLD STORE OUT_DIR

The test (tests/test_torch_sharded*.py) writes CASE.pkl, starts WORLD of
these processes, and reads OUT_DIR/rank{RANK}.pkl back.  A rank joins a
gloo group through the file store STORE, runs the case's `job` on the
CPU (job_card_mesh: on the case's device, the card for
tests/test_torch_kernels_gpu.py) and pickles what it returns.  It imports
the port only, never JAX: draws that replay the JAX engine come in the
case as numpy arrays (ReplayDraws).
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from crossscalepatchmatch_tpu_torch import config as tconfig  # noqa: E402
from crossscalepatchmatch_tpu_torch.parallel import tiled  # noqa: E402
from crossscalepatchmatch_tpu_torch.parallel.mesh import (  # noqa: E402
    TIMEOUT, make_mesh)


class ReplayDraws:
    """A draw source (crossscalepatchmatch_tpu_torch.utils.rng) that hands
    out recorded draws: init -> (disp, normal), refine keyed by
    (iteration, view, round) -> (dz, dn, z_mag, n_mag)."""

    def __init__(self, rec):
        self.rec = rec

    def init(self, shape, max_dis, eps):
        disp, normal = self.rec["init"]
        assert disp.shape == tuple(shape), (disp.shape, shape)
        return torch.from_numpy(disp), torch.from_numpy(normal)

    def refine(self, iteration, view, rnd, shape, z_mag, n_mag):
        dz, dn, z, n = self.rec["refine"][(iteration, view, rnd)]
        assert (np.float32(z), np.float32(n)) == (np.float32(z_mag),
                                                  np.float32(n_mag))
        assert dz.shape == tuple(shape)
        return torch.from_numpy(dz), torch.from_numpy(dn)


def port_cfg(kw):
    args = dict(kw)
    if "cost_method" in args:
        args["cost_method"] = tconfig.CostMethod(args["cost_method"])
    if "aggregator" in args:
        args["aggregator"] = tconfig.Aggregator(args["aggregator"])
    return tconfig.CSPMConfig(**args)


def draw_factory(case):
    recs = case.get("draws")
    if recs is None:
        return None
    return lambda seed, tile: ReplayDraws(recs[(seed, tile)])


# -- jobs: job(case) -> a picklable result of this rank ---------------------

def job_collectives(case):
    """extend_rows / extend_cols and the plane re-anchoring on blocks of
    the case's global arrays, on each mesh of the case."""
    out = {}
    for name, (shape, halo, which) in case["ops"].items():
        mesh = make_mesh(*shape)
        _, ty, tx = mesh.get_coordinate()
        x = torch.from_numpy(case["arrays"][name])
        hs, ws = x.shape[0] // shape[1], x.shape[1] // shape[2]
        blk = x[ty * hs:(ty + 1) * hs, tx * ws:(tx + 1) * ws]
        if which == "rows":
            y = tiled.extend_rows(blk, halo, mesh)
        elif which == "cols":
            y = tiled.extend_cols(blk, halo, mesh)
        elif which == "planes":
            y = tiled._extend_planes(blk, halo, hs, mesh)
        else:
            y = tiled._extend_planes_cols(blk, halo, ws, mesh)
        out[name] = (ty, tx, y.numpy())
    return out


def _inputs(case):
    return case["l"], case["r"], case["seeds"], port_cfg(case["cfg"])


def job_run_batch_sharded(case):
    l, r, seeds, cfg = _inputs(case)
    mesh = make_mesh(*case["mesh"])
    return tiled.run_batch_sharded(l, r, seeds, cfg, mesh, device="cpu",
                                   draws=draw_factory(case)).numpy()


def job_card_mesh(case):
    """run_batch_sharded on case["device"] for each named config of
    case["runs"], `reps` times (the draws TorchDraws(seed, "cpu", tile)
    where case["cpu_draws"], the default ones otherwise): per config the
    last run's maps, this rank's launch counts of it, and whether every
    run gave the same maps."""
    from crossscalepatchmatch_tpu_torch.utils.profiling import (
        launch_counts, reset_launch_counts)
    from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws

    device = torch.device(case["device"])
    mesh = make_mesh(*case["mesh"])
    draws = ((lambda seed, tile: TorchDraws(seed, "cpu", tile=tile))
             if case["cpu_draws"] else None)
    out = {}
    for name, kw in case["runs"].items():
        maps = []
        for _ in range(case["reps"]):
            reset_launch_counts()
            maps.append(tiled.run_batch_sharded(
                case["l"], case["r"], case["seeds"], port_cfg(kw), mesh,
                device=device, draws=draws))
            if device.type == "cuda":
                torch.cuda.synchronize()
        out[name] = dict(dis=maps[-1].cpu().numpy(), counts=launch_counts(),
                         same=all(torch.equal(m, maps[0]) for m in maps))
    return out


def job_sequence(case):
    cfg = port_cfg(case["cfg"])
    mesh = make_mesh(*case["mesh"])
    return [{k: v.numpy() for k, v in out.items()} for out in
            tiled.run_sequence_batch(case["frames"], cfg, mesh,
                                     seed=case["seed"], device="cpu")]


def job_resume(case):
    """The uninterrupted run, slices composed by run_batch_sharded_steps,
    and run_batch_sharded_resumable: fresh, resumed after a rewind to
    case["rewind"], and against a file of another mesh (refused)."""
    from crossscalepatchmatch_tpu_torch import checkpoint

    l, r, seeds, cfg = _inputs(case)
    mesh = make_mesh(*case["mesh"])
    kw = dict(device="cpu")
    full = tiled.run_batch_sharded(l, r, seeds, cfg, mesh, **kw).numpy()
    state = None
    for lo, hi in case["slices"]:
        state = tiled.run_batch_sharded_steps(l, r, seeds, cfg, mesh, state,
                                              lo, hi, **kw)
    sliced = tiled.run_batch_sharded_steps(l, r, seeds, cfg, mesh, state,
                                           cfg.max_iter, finalize=True,
                                           **kw).numpy()
    ckpt = case["ckpt"]
    saved = {}
    orig = checkpoint._save

    def spy(path, **arrays):
        saved[int(arrays["iteration"])] = arrays
        orig(path, **arrays)

    checkpoint._save = spy
    try:
        fresh = checkpoint.run_batch_sharded_resumable(
            l, r, seeds, cfg, mesh, ckpt, **kw).numpy()
    finally:
        checkpoint._save = orig
    path = f"{ckpt}.rank{dist.get_rank()}"
    checkpoint._save(path, **saved[case["rewind"]])
    resumed = checkpoint.run_batch_sharded_resumable(
        l, r, seeds, cfg, mesh, ckpt, **kw).numpy()
    other = dict(saved[case["rewind"]])
    other["mesh"] = np.asarray([9, 9, 9], np.int64)
    checkpoint._save(path, **other)
    try:
        checkpoint.run_batch_sharded_resumable(l, r, seeds, cfg, mesh, ckpt,
                                               **kw)
        refused = None
    except ValueError as e:
        refused = str(e)
    dist.barrier()
    return dict(full=full, sliced=sliced, fresh=fresh, resumed=resumed,
                refused=refused, iterations=sorted(saved))


def job_subworld(case):
    """The sharded entry points on a mesh over the first ranks of the
    group (case["mesh"]): each result on every rank (None, or no frame, on
    a rank outside the mesh), then a barrier of the whole group; with
    case["dryrun"] = n, also the dry run over the first n ranks (what it
    printed)."""
    import contextlib
    import io

    from crossscalepatchmatch_tpu_torch import checkpoint
    from crossscalepatchmatch_tpu_torch.parallel import dryrun

    l, r, seeds, cfg = _inputs(case)
    mesh = make_mesh(*case["mesh"])
    kw = dict(device="cpu", draws=draw_factory(case))
    out = dict(coordinate=mesh.get_coordinate())

    def arr(x):
        return None if x is None else x.numpy()

    out["dis"] = arr(tiled.run_batch_sharded(l, r, seeds, cfg, mesh, **kw))
    out["steps"] = arr(tiled.run_batch_sharded_steps(
        l, r, seeds, cfg, mesh, finalize=True, **kw))
    out["resumable"] = arr(checkpoint.run_batch_sharded_resumable(
        l, r, seeds, cfg, mesh, case["ckpt"], **kw))
    seq_mesh = make_mesh(mesh.shape[0], 1, 1)
    out["sequence"] = [arr(f["dis"]) for f in tiled.run_sequence_batch(
        [(l, r)], cfg, seq_mesh, device="cpu")]
    if case.get("dryrun"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun.dryrun_multichip(case["dryrun"], device="cpu")
        out["dryrun"] = buf.getvalue()
    dist.barrier()
    return out


def job_refusals(case):
    """What each entry point raises on inputs the mesh refuses."""
    cfg = port_cfg(case["cfg"])
    mesh = make_mesh(*case["mesh"])
    l = np.zeros((2, 31, 32, 3), np.uint8)
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = type(e).__name__

    catch("height", lambda: tiled.run_batch_sharded(
        l, l, [0, 0], cfg, mesh, device="cpu"))
    ok = np.zeros((2, 32, 32, 3), np.uint8)
    catch("seeds", lambda: tiled.run_batch_sharded(
        ok, ok, [0], cfg, mesh, device="cpu"))
    fly = port_cfg({**case["cfg"], "precompute_volume": False})
    catch("fly", lambda: tiled.run_batch_sharded(
        ok, ok, [0, 0], fly, mesh, device="cpu"))
    catch("fly_steps", lambda: tiled.run_batch_sharded_steps(
        ok, ok, [0, 0], fly, mesh, device="cpu"))
    catch("sequence", lambda: next(tiled.run_sequence_batch(
        [(ok, ok)], cfg, mesh, device="cpu")))
    catch("mesh", lambda: make_mesh(1, 3, 1))
    return out


def spawn(case, world, tmp_dir, timeout=600):
    """Run `case` on `world` ranks (processes of this file) and return
    each rank's result, in rank order.  A rank that fails ends the others
    and raises AssertionError with its output."""
    import subprocess
    import time

    case_path = os.path.join(tmp_dir, "case.pkl")
    with open(case_path, "wb") as f:
        pickle.dump(case, f)
    store = os.path.join(tmp_dir, "store")
    logs = [open(os.path.join(tmp_dir, f"rank{r}.log"), "w+")
            for r in range(world)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case_path, str(r),
         str(world), store, tmp_dir], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env) for r in range(world)]
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad or time.monotonic() > t_end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        msgs = []
        for r in failed:
            logs[r].seek(0)
            msgs.append(f"rank {r} exit {procs[r].returncode}:\n"
                        f"{logs[r].read()[-4000:]}")
        raise AssertionError("\n".join(msgs))
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def main():
    case_path, rank, world, store, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        res = globals()[f"job_{case['job']}"](case)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
