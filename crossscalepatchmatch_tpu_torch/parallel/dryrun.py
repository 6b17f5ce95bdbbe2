"""Multi-rank dry run of the sharded pipeline (the port's counterpart of the
JAX package's __graft_entry__.dryrun_multichip).

    python -m crossscalepatchmatch_tpu_torch.parallel.dryrun N [--production]
        [--device cpu|cuda]

runs the full (data, ty, tx) step over N ranks, N processes joined by gloo
through a file store, and checks the maps' shape and that they are not all
zero.  Under torchrun (`torchrun --nproc-per-node=N -m ...dryrun N`) every
rank joins torchrun's group instead (parallel.mesh.initialize_multihost:
NCCL where each rank has a card of its own), and inside an initialised
process group of N or more ranks every rank calls dryrun_multichip(N)
itself: the mesh spans the first N ranks and the others return at once.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np


def mesh_shape(n_ranks: int):
    """(n_data, n_ty, n_tx) as the JAX dry run lays out n devices: two
    pairs where n is even, two column blocks where what is left is even,
    row bands for the rest."""
    n_data = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    n_tx = 2 if (n_ranks // n_data) % 2 == 0 else 1
    return n_data, n_ranks // (n_data * n_tx), n_tx


def _run(n_ranks: int, production: bool, device) -> None:
    """One rank's part of the dry run (the process group is initialised;
    nothing to do on a rank outside the first n_ranks)."""
    import torch.distributed as dist

    from ..config import CostMethod, CSPMConfig
    from ..data import make_pair
    from .mesh import make_mesh
    from .tiled import run_batch_sharded

    n_data, n_ty, n_tx = mesh_shape(n_ranks)
    mesh = make_mesh(n_data, n_ty, n_tx)
    if production:
        # wnd=35: the 17-px halo exceeds the 16-row bands, so every
        # exchange is multi-hop
        md = 60
        cfg = CSPMConfig(max_dis=md, dis_scale=4, wnd_size=35, max_iter=2,
                         cost_method=CostMethod.GRD, use_cs=False,
                         use_pp=True)
        h, w = 16 * n_ty, 128 * n_tx
    else:
        md = 8
        cfg = CSPMConfig(max_dis=md, dis_scale=16, wnd_size=9, max_iter=1,
                         prop_sweeps=1, cost_method=CostMethod.GRD,
                         use_cs=False, use_pp=True)
        h, w = 16 * n_ty, 32 * n_tx
    pairs = [make_pair(h=h, w=w, max_dis=md, seed=s) for s in range(n_data)]
    l = np.stack([p.left for p in pairs])
    r = np.stack([p.right for p in pairs])
    dis = run_batch_sharded(l, r, list(range(n_data)), cfg, mesh,
                            device=device)
    if dis is None:
        return
    assert tuple(dis.shape) == (n_data, 2, h, w), dis.shape
    assert int(dis.max()) > 0, "dry run produced an all-zero map"
    print(f"dryrun_multichip ok: mesh=({n_data},{n_ty},{n_tx}) "
          f"out={tuple(dis.shape)} backend={dist.get_backend()}", flush=True)


def dryrun_multichip(n_ranks: int, production: bool = False,
                     device="cuda") -> None:
    """Run the sharded step over an n_ranks mesh (JAX
    __graft_entry__.py:30-82: the same mesh layout and geometries).

    Inside an initialised process group of n_ranks or more every rank
    calls this: the mesh takes the first n_ranks ranks and the others
    return at once (a smaller group raises ValueError).
    Under torchrun's environment every rank joins torchrun's group
    (initialize_multihost) and leaves it at the end.  Otherwise it starts
    n_ranks processes joined by gloo and raises RuntimeError if any fails.
    `device`: where the ranks compute ("cpu", or "cuda": a card a rank
    where the host has enough, parallel.tiled.rank_device)."""
    import torch.distributed as dist

    from .mesh import _cluster_env_detected, initialize_multihost

    if not dist.is_initialized() and _cluster_env_detected():
        initialize_multihost(device=device)
        try:
            dryrun_multichip(n_ranks, production, device)
        finally:
            dist.destroy_process_group()
        return
    if dist.is_initialized():
        _run(n_ranks, production, device)
        return
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", __name__, str(n_ranks), "--rank",
             str(rank), "--store", store, "--device", str(device),
             *(["--production"] if production else [])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(n_ranks)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [(i, p.returncode, o) for i, (p, o) in
              enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise RuntimeError("dry run failed:\n" + "\n".join(
            f"rank {i} exit {rc}:\n{o}" for i, rc, o in failed))
    print(outs[0].strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank (with --store)")
    ap.add_argument("--store", default=None, help="file store of the group")
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n_ranks, args.production, args.device)
        return 0
    import torch
    import torch.distributed as dist

    from .mesh import TIMEOUT

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.n_ranks,
                            timeout=TIMEOUT)
    try:
        _run(args.n_ranks, args.production, args.device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
