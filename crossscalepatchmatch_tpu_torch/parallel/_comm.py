"""Collectives along the axes of a (data, ty, tx) mesh (parallel.mesh).

Transport follows the group's backend, never a failure: NCCL moves CUDA
tensors as they are (one card a rank); gloo moves host tensors, so a CUDA
tensor is copied to the host, sent, and what arrives is copied back to the
card (a mesh of several ranks on a host with one card; the halos are a few
hundred KB).  `host_bytes` counts the bytes so staged.  A collective that
fails raises; there is no other transport to fall back on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Bytes of CUDA tensors staged through host memory (sent and received; a
# plain count: bench_scaling_torch.py resets and reads it).
host_bytes = 0


@dataclasses.dataclass
class Axis:
    """One rank's view of one mesh axis: its group, the global ranks along
    the axis in order, and its own index among them."""

    name: str
    group: dist.ProcessGroup
    ranks: List[int]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def via_host(self) -> bool:
        return dist.get_backend(self.group) == "gloo"


def axis(mesh: DeviceMesh, name: str) -> Axis:
    group = mesh.get_group(name)
    return Axis(name, group, dist.get_process_group_ranks(group),
                mesh.get_local_rank(name))


def transport(mesh: DeviceMesh) -> str:
    """How this mesh moves a CUDA tensor: "nccl (device)" or "gloo (host
    staged)"."""
    return ("gloo (host staged)" if dist.get_backend() == "gloo"
            else f"{dist.get_backend()} (device)")


def _wire(t: torch.Tensor, via_host: bool) -> torch.Tensor:
    """The tensor as it travels: contiguous, bool as u8, on the host for
    gloo."""
    global host_bytes
    t = t.to(torch.uint8) if t.dtype == torch.bool else t
    if via_host and t.is_cuda:
        host_bytes += t.numel() * t.element_size()
        t = t.cpu()
    return t.contiguous()


def _land(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received wire tensor back in `like`'s dtype and device."""
    global host_bytes
    if t.device != like.device:
        host_bytes += t.numel() * t.element_size()
        t = t.to(like.device)
    return t.to(like.dtype) if t.dtype != like.dtype else t


def extend_axis(x: torch.Tensor, halo: int, dim: int,
                ax: Axis) -> torch.Tensor:
    """Prepend / append `halo` slices along `dim` from the neighbours on the
    mesh axis (JAX tiled.py:58-85).

    A halo taller than the block is served by multi-hop exchange: the piece
    at distance j moves in one distance-j point-to-point exchange
    (batch_isend_irecv), so a far ring or a window halo is never truncated
    by small blocks.  Ranks at the mesh edge receive zeros past the global
    image (the caller masks them by validity); only the slices sent to a
    peer travel (or are staged through the host)."""
    if halo == 0:
        return x
    dim = dim % x.dim()
    size = x.shape[dim]
    hops = -(-halo // size)                       # blocks touched per side
    rem = halo - (hops - 1) * size                # slices from the far one
    n, i = ax.size, ax.index
    lo, hi = [], []
    for j in range(hops, 0, -1):                  # farthest block first
        take = rem if j == hops else size
        zeros = torch.zeros_like(x.narrow(dim, 0, take))
        ops = []
        if i + j < n:
            tail = _wire(x.narrow(dim, size - take, take), ax.via_host)
            from_hi = torch.zeros_like(tail)      # the head of rank i + j
            peer = ax.ranks[i + j]
            ops += [dist.P2POp(dist.isend, tail, peer, ax.group),
                    dist.P2POp(dist.irecv, from_hi, peer, ax.group)]
        if i - j >= 0:
            head = _wire(x.narrow(dim, 0, take), ax.via_host)
            from_lo = torch.zeros_like(head)      # the tail of rank i - j
            peer = ax.ranks[i - j]
            ops += [dist.P2POp(dist.isend, head, peer, ax.group),
                    dist.P2POp(dist.irecv, from_lo, peer, ax.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        lo.append(_land(from_lo, x) if i - j >= 0 else zeros)
        hi.append(_land(from_hi, x) if i + j < n else zeros)
    return torch.cat(lo + [x] + hi[::-1], dim=dim)


def all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The blocks of every rank along the axis, concatenated in axis order
    along `dim` (a tiled all-gather)."""
    if ax.size == 1:
        return x
    w = _wire(x, ax.via_host)
    parts = [torch.empty_like(w) for _ in range(ax.size)]
    dist.all_gather(parts, w, group=ax.group)
    return torch.cat([_land(p, x) for p in parts], dim=dim)


def all_max(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """The elementwise max over the ranks of the given axes."""
    for ax in axes:
        if ax.size > 1:
            w = _wire(x, ax.via_host).clone()
            dist.all_reduce(w, op=dist.ReduceOp.MAX, group=ax.group)
            x = _land(w, x)
    return x
