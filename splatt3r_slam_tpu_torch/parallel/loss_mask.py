"""Training loss masks: target-pixel visibility in context frustums.

Counterpart of `splatt3r_slam_tpu/parallel/loss_mask.py`: for each target
view, mask pixels whose unprojected 3D point falls inside at least one
context view's frustum (in front of the camera and projecting inside the
image), so the photometric loss ignores never-seen regions.
"""

from __future__ import annotations

import torch


def unproject(depth, K, T_WC):
    """depth (H, W), K (3,3), T_WC (4,4) cam→world → world points (H,W,3)."""
    H, W = depth.shape
    dev = depth.device
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    Pc = torch.stack([x, y, depth], dim=-1)
    return Pc @ T_WC[:3, :3].T + T_WC[:3, 3]


def in_frustum_mask(points_w, K, T_WC, hw, z_eps=1e-6):
    """points (..., 3) world; True where visible in the camera."""
    H, W = hw
    Pc = (points_w - T_WC[:3, 3]) @ T_WC[:3, :3]
    z = Pc[..., 2]
    z_s = torch.where(z > z_eps, z, torch.ones_like(z))
    u = K[0, 0] * Pc[..., 0] / z_s + K[0, 2]
    v = K[1, 1] * Pc[..., 1] / z_s + K[1, 2]
    return (z > z_eps) & (u >= 0) & (u < W) & (v >= 0) & (v < H)


def calculate_loss_mask(target_depth, target_K, target_T_WC,
                        context_Ks, context_T_WCs, hw):
    """(H, W) bool — target pixels visible in ≥1 context view.

    target_depth (H, W); context_Ks (V, 3, 3); context_T_WCs (V, 4, 4)."""
    pts = unproject(target_depth, target_K, target_T_WC)
    masks = [in_frustum_mask(pts, context_Ks[v], context_T_WCs[v], hw)
             for v in range(context_T_WCs.shape[0])]
    return torch.stack(masks).any(dim=0) & (target_depth > 0)
