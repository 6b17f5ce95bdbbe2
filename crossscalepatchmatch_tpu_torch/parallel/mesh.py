"""Process meshes for data-parallel and spatially tiled execution
(port of crossscalepatchmatch_tpu.parallel.mesh on torch.distributed).

One rank per process.  The ranks form a 3-D logical mesh (a DeviceMesh
with the dimension names ("data", "ty", "tx")):
  * "data": independent stereo pairs (batch data parallelism);
  * "ty":   horizontal row bands of one pair, with halo exchange between
    neighbouring bands;
  * "tx":   column blocks of one pair (2-D tiling for wide inputs).
Both views of a pair stay on the same rank.

The group's backend decides how tensors travel (parallel.tiled): NCCL
moves CUDA tensors between cards, one card a rank; gloo moves host
tensors, so a mesh of several ranks on a host with one card runs over gloo
and stages its halos through host memory.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ("data", "ty", "tx")
# How long a collective waits for its peers before it raises.
TIMEOUT = datetime.timedelta(seconds=300)


def make_mesh(n_data: int = 1, n_ty: Optional[int] = None, n_tx: int = 1
              ) -> DeviceMesh:
    """A (data, ty, tx) mesh over the first n_data * n_ty * n_tx ranks of
    the default process group, in rank order (rank = (d * n_ty + ty) *
    n_tx + tx; JAX make_mesh with devices=jax.devices()[:n]).

    n_ty defaults to what the world leaves: world // (n_data * n_tx).
    Every rank of the process group calls make_mesh, in the mesh or not:
    the mesh's groups are made collectively.  On a rank outside the mesh
    `get_coordinate()` is None, and the sharded entry points
    (parallel.tiled) return at once there.  Raises ValueError when the
    mesh needs more ranks than the world has, and RuntimeError if no
    process group is initialised (initialize_multihost makes one).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.mesh.initialize_multihost)")
    world = dist.get_world_size()
    if n_ty is None:
        n_ty = world // (n_data * n_tx)
    n = n_data * n_ty * n_tx
    if min(n_data, n_ty, n_tx) < 1 or n > world:
        raise ValueError(f"mesh {n_data}x{n_ty}x{n_tx} needs more than the "
                         f"{world} ranks of the process group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(n_data, n_ty, n_tx),
                      mesh_dim_names=MESH_DIMS)


def _cluster_env_detected() -> bool:
    """True when torchrun (or a launcher speaking its protocol) advertises
    the process group in the environment."""
    return all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                           "MASTER_ADDR", "MASTER_PORT"))


def default_backend(device="cuda") -> str:
    """NCCL where every rank of this host has a card of its own, else gloo
    (the CPU, or several ranks sharing a card: NCCL refuses two ranks on
    one device).  Chosen from the topology, never after a failure."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda") -> DeviceMesh:
    """Join (or form) the process group and return a (data, ty, tx) mesh
    whose "data" axis spans the hosts and whose "ty" axis spans each
    host's local ranks (JAX mesh.py:57-90).

    - Explicit arguments (coordinator "host:port", the process count, this
      process's index): init_process_group over TCP, each process a host.
    - torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
      LOCAL_WORLD_SIZE ranks a host): init_process_group from it.
    - Neither: a world of one rank (an in-process store).
    The backend follows the topology (default_backend(device)).  A
    failure to form the group propagates: a cluster run never degrades to
    a silent single-rank mesh.  An initialised group is reused.

    Args:
      device: where the ranks compute ("cuda": each rank on its own card
        where the host has enough, see parallel.tiled.rank_device).
    """
    explicit = (coordinator_address is not None
                or (num_processes or 0) > 1 or process_id is not None)
    backend = default_backend(device)
    if dist.is_initialized():
        pass
    elif explicit:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("give coordinator_address, num_processes and "
                             "process_id together")
        dist.init_process_group(backend, init_method=f"tcp://"
                                f"{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT)
    elif _cluster_env_detected():
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    world = dist.get_world_size()
    local = 1 if explicit else int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks do not split into hosts of {local}")
    return make_mesh(n_data=world // local, n_ty=local)
