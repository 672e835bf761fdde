"""Projective geometry with analytic Jacobians (torch).

Counterpart of `splatt3r_slam_tpu/geometry/projective.py`. All functions
broadcast over leading batch dims; invalid log-depths are masked with
`where` instead of in-place writes.
"""

from __future__ import annotations

import torch


def point_to_dist(X):
    """Euclidean norm along the last axis, kept-dim."""
    return torch.linalg.norm(X, dim=-1, keepdim=True)


def point_to_ray_dist(X, jacobian: bool = False):
    """Point → [ray(3), dist(1)] with optional 4x3 Jacobian.

    dr/dX = (I − r rᵀ)/d, dd/dX = rᵀ.
    """
    d = point_to_dist(X)
    d_inv = 1.0 / d
    r = d_inv * X
    rd = torch.cat([r, d], dim=-1)
    if not jacobian:
        return rd
    batch = X.shape[:-1]
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(batch + (3, 3))
    outer = X[..., :, None] * X[..., None, :]
    dr_dX = d_inv[..., None] * (eye - (d_inv**2)[..., None] * outer)
    dd_dX = r[..., None, :]
    return rd, torch.cat([dr_dX, dd_dX], dim=-2)


def decompose_K(K):
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def project_calib(P, K, img_size, jacobian: bool = False, border: float = 0.0,
                  z_eps: float = 0.0):
    """Pinhole projection → [u, v, log z] + validity (+ 3x3 Jacobian).

    img_size is (H, W).
    """
    h, w = img_size
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P[..., 0], P[..., 1], P[..., 2]
    z_safe = torch.where(z > z_eps, z, torch.ones_like(z))
    u = fx * x / z_safe + cx
    v = fy * y / z_safe + cy

    valid_u = (u > border) & (u < w - 1 - border)
    valid_v = (v > border) & (v < h - 1 - border)
    valid_z = z > z_eps
    valid = (valid_u & valid_v & valid_z)[..., None]

    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z))
    pz = torch.stack([u, v, logz], dim=-1)
    if not jacobian:
        return pz, valid

    z_inv = 1.0 / z_safe
    zero = torch.zeros_like(z_inv)
    J = torch.stack(
        [
            torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv], dim=-1),
            torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1),
            torch.stack([zero, zero, z_inv], dim=-1),
        ],
        dim=-2,
    )
    return pz, J, valid


def backproject(p, z, K):
    """Pixel + depth → camera-space point."""
    tmp1 = (p[..., 0] - K[0, 2]) / K[0, 0]
    tmp2 = (p[..., 1] - K[1, 2]) / K[1, 1]
    dirs = torch.stack([tmp1, tmp2, torch.ones_like(tmp1)], dim=-1)
    return z * dirs


def get_pixel_coords(b: int, img_size, dtype=torch.float32, device="cuda"):
    """(b, h, w, 2) pixel grid in (u, v) order."""
    h, w = img_size
    v, u = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([u, v], dim=-1)[None].expand(b, h, w, 2)


def constrain_points_to_ray(img_size, Xs, K):
    """Snap points to their pixel rays, keeping depth."""
    b = Xs.shape[0]
    uv = get_pixel_coords(b, img_size, Xs.dtype, Xs.device).reshape(
        Xs.shape[:-1] + (2,))
    return backproject(uv, Xs[..., 2:3], K)
