"""Gaussian-splat math utilities + camera→world conversion.

Counterpart of `splatt3r_slam_tpu/splat/gaussians.py`: Σ = R S Sᵀ Rᵀ from
scale + xyzw quaternion, RGB↔SH and real SH up to degree 3 (`eval_sh`),
the `gaussians_to_world` filters (depth window with an adaptive percentile
upper bound, max-scale and confidence gates, SH residual + C0 colour,
[sR|t] world transform), and the viewer's oriented surfels from a keyframe
pointmap (`pointmap_to_surfels`). Filters never compact: filtered-out
gaussians get opacity 0.
"""

from __future__ import annotations

import torch

from splatt3r_slam_tpu_torch.lie import sim3

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def RGB2SH(rgb):
    return (rgb - 0.5) / C0


def SH2RGB(sh):
    return sh * C0 + 0.5


def eval_sh(deg: int, sh, dirs):
    """Real SH up to degree 3 at unit directions.

    sh: (..., C, (deg+1)²); dirs: (..., 3) → (..., C)."""
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2]
                  - C1 * x * sh[..., 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4]
                      + C2[1] * yz * sh[..., 5]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + C2[3] * xz * sh[..., 7]
                      + C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + C3[1] * xy * z * sh[..., 10]
                          + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                          * sh[..., 12]
                          + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + C3[5] * z * (xx - yy) * sh[..., 14]
                          + C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    return result


def build_covariance(scale, rotation_xyzw):
    """Σ = R diag(s²) Rᵀ."""
    R = sim3.quat_to_matrix(rotation_xyzw)
    return torch.einsum("...ij,...j,...kj->...ik", R, scale * scale, R)


_TRIU_R = (0, 0, 0, 1, 1, 2)
_TRIU_C = (0, 1, 2, 1, 2, 2)


def cov_to_triu(cov):
    """(..., 3, 3) → (..., 6) upper-triangular [xx xy xz yy yz zz]."""
    return torch.stack([cov[..., r, c] for r, c in zip(_TRIU_R, _TRIU_C)],
                       dim=-1)


def triu_to_cov(t):
    xx, xy, xz, yy, yz, zz = t.unbind(-1)
    rows = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1)
    return rows.reshape(t.shape[:-1] + (3, 3))


def gaussians_to_world_masked(means, scales, rotations, sh, opacities, conf,
                              img, T_WC, spatial_stride: int = 1,
                              depth_min: float = 0.05,
                              depth_max_percentile: float = 0.98,
                              max_scale: float = 0.5,
                              min_confidence: float = 1.5):
    """Filter + world-transform one view's gaussians (fixed-size output).

    means/scales (h, w, 3); rotations (h, w, 4); sh (h, w, 3, d);
    opacities (h, w, 1); conf (h, w); img (h, w, 3) in [0, 1]; T_WC (8,).
    Returns (means_w (G,3), cov_triu (G,6), colors (G,3), opa (G,)) with
    G = (h/s)·(w/s)."""
    s = spatial_stride
    means = means[::s, ::s].reshape(-1, 3)
    scales = scales[::s, ::s].reshape(-1, 3)
    rotations = rotations[::s, ::s].reshape(-1, 4)
    sh0 = sh[::s, ::s, :, 0].reshape(-1, 3)
    opa = opacities[::s, ::s].reshape(-1)
    conf = conf[::s, ::s].reshape(-1)
    img = img[::s, ::s].reshape(-1, 3)

    z = means[:, 2]
    valid = z > depth_min
    if depth_max_percentile < 1.0:
        # adaptive upper bound: linear-interpolated percentile of valid depths
        z_for_q = torch.where(valid, z, torch.full_like(z, float("nan")))
        z_upper = torch.nanquantile(z_for_q, depth_max_percentile)
        z_upper = torch.where(torch.isnan(z_upper),
                              torch.full_like(z_upper, float("inf")), z_upper)
        valid = valid & (z <= z_upper)
    valid = valid & (scales.amax(-1) < max_scale)
    if min_confidence > 0:
        valid = valid & (conf >= min_confidence)

    M = sim3.matrix(T_WC)
    R = M[:3, :3]
    t = M[:3, 3]
    means_w = means @ R.T + t
    cov = build_covariance(scales, rotations)
    cov_w = torch.einsum("ij,njk,lk->nil", R, cov, R)
    colors = torch.clamp(SH2RGB(sh0 + RGB2SH(img)), 0.0, 1.0)
    opa = torch.where(valid, opa, torch.zeros_like(opa))
    return means_w, cov_to_triu(cov_w), colors, opa


def pointmap_to_surfels(X_grid, color_grid, T_WC, stride: int = 4,
                        flatten: float = 0.1):
    """Oriented surfel gaussians from a keyframe pointmap grid (the
    viewer's pointmap mode, drawn by the same tile rasterizer as the
    splats): each strided sample becomes a disc Σ = r²(I − nnᵀ) +
    (flatten·r)²nnᵀ, its normal n from the cross product of the grid
    tangents and its radius r matched to the local sample spacing, so that
    neighbouring discs just overlap.

    X_grid: (H, W, 3) camera-frame pointmap; color_grid: (H, W, 3) in
    [0, 1]; T_WC: (8,) Sim3. Returns (means_w (G,3), cov_triu (G,6),
    colors (G,3), opa (G,))."""
    # edge padding needs a (C, H, W) layout
    Xp = torch.nn.functional.pad(X_grid.permute(2, 0, 1)[None],
                                 (1, 1, 1, 1), mode="replicate")[0]
    Xp = Xp.permute(1, 2, 0)
    du = (Xp[1:-1, 2:] - Xp[1:-1, :-2]) * 0.5  # ∂X/∂u per pixel
    dv = (Xp[2:, 1:-1] - Xp[:-2, 1:-1]) * 0.5
    s = int(stride)
    o = s // 2
    X = X_grid[o::s, o::s].reshape(-1, 3)
    du = du[o::s, o::s].reshape(-1, 3) * s  # per-sample spacing
    dv = dv[o::s, o::s].reshape(-1, 3) * s
    col = color_grid[o::s, o::s].reshape(-1, 3)
    n = torch.linalg.cross(du, dv)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    r = 0.6 * torch.maximum(torch.linalg.norm(du, dim=-1),
                            torch.linalg.norm(dv, dim=-1))[:, None]
    nnT = n[:, :, None] * n[:, None, :]
    eye = torch.eye(3, dtype=X.dtype, device=X.device)[None]
    cov = (r[..., None] ** 2) * (eye - nnT) \
        + ((flatten * r)[..., None] ** 2) * nnT
    # world transform [sR|t]: means = sR·X + t, Σw = (sR) Σ (sR)ᵀ
    t, q, sc = sim3.split(T_WC)
    R = sim3.quat_to_matrix(q) * sc[..., None]
    means_w = X @ R.T + t
    cov_w = torch.einsum("ij,njk,lk->nil", R, cov, R)
    opa = torch.full((X.shape[0],), 0.95, dtype=X.dtype, device=X.device)
    return means_w, cov_to_triu(cov_w), col, opa


class GaussianAccumulator:
    """Frame → world-space gaussian chunks for the pool (the self
    prediction; include_cross=True adds the cross view)."""

    def __init__(self, spatial_stride: int = 4, depth_min: float = 0.05,
                 depth_max_percentile: float = 0.98, max_scale: float = 0.5,
                 min_confidence: float = 1.5, include_cross: bool = False):
        self.kw = dict(spatial_stride=spatial_stride, depth_min=depth_min,
                       depth_max_percentile=depth_max_percentile,
                       max_scale=max_scale, min_confidence=min_confidence)
        self.include_cross = include_cross

    def gaussians_to_world(self, frame):
        """Returns (means, cov_triu, colors, opacities) or None."""
        if frame.gaussian_pred is None:
            return None
        preds = [frame.gaussian_pred]
        if self.include_cross and frame.gaussian_pred_cross is not None:
            preds.append(frame.gaussian_pred_cross)
        img = torch.clamp(frame.img[0] * 0.5 + 0.5, 0.0, 1.0)
        outs = [
            gaussians_to_world_masked(
                p["means"][0], p["scales"][0], p["rotations"][0], p["sh"][0],
                p["opacities"][0], p["conf"][0], img, frame.T_WC, **self.kw)
            for p in preds
        ]
        return tuple(torch.cat([o[k] for o in outs]) for k in range(4))
