"""Slanted-plane parameter math (port of crossscalepatchmatch_tpu.ops.plane).

Planes are stored as (a, b, c) with d(x, y) = a*x + b*y + c
(CSPM/plane.h:25-34).  The random draws are arguments here: they come from
a draw source (utils.rng), so a test can hand both packages the same draws.
"""

from __future__ import annotations

import torch


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, keepdim (sqrt of the sum of
    squares, the form jnp.linalg.norm takes)."""
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def pixel_grid(h: int, w: int, device) -> tuple:
    """(xs, ys): f32[H, W] column and row coordinates."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return xs.expand(h, w), ys.expand(h, w)


def params_from_normal_point(normal: torch.Tensor, point: torch.Tensor,
                             eps: float = 1e-8) -> torch.Tensor:
    """(a, b, c) from a plane normal and a point (x, y, disparity) on it;
    the denominator is max(|nz|, eps) with the sign of nz kept."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    denom = torch.clamp(nz.abs(), min=eps) * torch.where(nz < 0.0, -1.0, 1.0)
    a = -nx / denom
    b = -ny / denom
    c = (normal * point).sum(-1) / denom
    return torch.stack([a, b, c], dim=-1)


def normal_from_params(abc: torch.Tensor) -> torch.Tensor:
    """Unit normal (nz > 0) of the plane (a, b, c): n ~ (-a, -b, 1)."""
    a, b = abc[..., 0], abc[..., 1]
    inv_len = torch.rsqrt(a * a + b * b + 1.0)
    return torch.stack([-a * inv_len, -b * inv_len, inv_len], dim=-1)


def disparity_at(abc: torch.Tensor, x, y) -> torch.Tensor:
    """Evaluate d(x, y) = a*x + b*y + c."""
    return abc[..., 0] * x + abc[..., 1] * y + abc[..., 2]


def reanchor(abc: torch.Tensor, x, y, disp: torch.Tensor) -> torch.Tensor:
    """Plane with the same (a, b) passing through (x, y, disp)."""
    a, b = abc[..., 0], abc[..., 1]
    c = disp - a * x - b * y
    return torch.stack([a, b, c], dim=-1)


def random_planes(disp: torch.Tensor, normal: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """Random plane init from drawn disparities and normals
    (cs_patchmatch.cc:115-148).

    Args:
      disp: f32[..., H, W] disparity draws, U(eps, max_dis).
      normal: f32[..., H, W, 3] N(0, 1) draws (normalized here).

    Returns:
      f32[..., H, W, 3] plane parameters (a, b, c).
    """
    h, w = disp.shape[-2], disp.shape[-1]
    normal = normal / torch.clamp(_norm(normal), min=eps)
    xs, ys = pixel_grid(h, w, disp.device)
    point = torch.stack([xs.expand_as(disp), ys.expand_as(disp), disp],
                        dim=-1)
    return params_from_normal_point(normal, point, eps)


def perturb_planes(abc: torch.Tensor, dz: torch.Tensor, dn: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """Refinement proposal (cs_patchmatch.cc:311-338): the disparity at the
    pixel moves by dz, the normal by dn, which is then renormalized.

    Args:
      abc: f32[..., H, W, 3] current planes.
      dz: f32[..., H, W] disparity jitter draws, U(-z_mag, z_mag).
      dn: f32[..., H, W, 3] normal jitter draws, U(-n_mag, n_mag).
    """
    h, w = abc.shape[-3], abc.shape[-2]
    xs, ys = pixel_grid(h, w, abc.device)
    z = disparity_at(abc, xs, ys) + dz
    normal = normal_from_params(abc) + dn
    normal = normal / torch.clamp(_norm(normal), min=eps)
    point = torch.stack([xs.expand_as(z), ys.expand_as(z), z], dim=-1)
    return params_from_normal_point(normal, point, eps)
