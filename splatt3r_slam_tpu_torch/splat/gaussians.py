"""Gaussian-splat math utilities + camera→world conversion.

Counterpart of `splatt3r_slam_tpu/splat/gaussians.py`: Σ = R S Sᵀ Rᵀ from
scale + xyzw quaternion, RGB↔SH, and the `gaussians_to_world` filters
(depth window with an adaptive percentile upper bound, max-scale and
confidence gates, SH residual + C0 colour, [sR|t] world transform).
Filters never compact: filtered-out gaussians get opacity 0.
"""

from __future__ import annotations

import torch

from splatt3r_slam_tpu_torch.lie import sim3

C0 = 0.28209479177387814


def RGB2SH(rgb):
    return (rgb - 0.5) / C0


def SH2RGB(sh):
    return sh * C0 + 0.5


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
