"""SLAM per-frame render façade.

Counterpart of `splatt3r_slam_tpu/splat/decoder.py::render_frame`:
covariances from scales/rotations, SH residual from the source images,
Sim3 poses, then the tile rasterizer — the hand-written CUDA compositor
for CUDA tensors (`rasterizer.default_rasterizer`), the plain compositor on
the CPU. The pixelsplat-style batch renderer (`DecoderSplatting`) and
depth rendering are training/viewer paths, ported in later slices.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from splatt3r_slam_tpu_torch.lie import sim3
from splatt3r_slam_tpu_torch.splat.gaussians import (
    RGB2SH,
    SH2RGB,
    build_covariance,
    cov_to_triu,
)


@torch.no_grad()
def frame_gaussians(frame, ref_frame):
    """The frame's self and cross predictions as one flat set (means,
    cov_triu, colors, opacities) in the frame's camera, colours from the
    SH residual over the source images."""
    means, covs, cols, opas = [], [], [], []
    for p, img_n in ((frame.gaussian_pred, frame.img),
                     (frame.gaussian_pred_cross, ref_frame.img)):
        img = torch.clamp(img_n[0] * 0.5 + 0.5, 0.0, 1.0)
        cov = build_covariance(p["scales"][0].reshape(-1, 3),
                               p["rotations"][0].reshape(-1, 4))
        sh0 = p["sh"][0][..., 0].reshape(-1, 3) + RGB2SH(img.reshape(-1, 3))
        means.append(p["means"][0].reshape(-1, 3))
        covs.append(cov_to_triu(cov))
        cols.append(torch.clamp(SH2RGB(sh0), 0.0, 1.0))
        opas.append(p["opacities"][0].reshape(-1))
    return (torch.cat(means), torch.cat(covs), torch.cat(cols),
            torch.cat(opas))


@torch.no_grad()
def render_frame(frame, ref_frame, K=None, target_T_WC=None, hw=None,
                 k_max=512, tpg_side=4, bg=(0.0, 0.0, 0.0),
                 rasterizer: str = "auto"):
    """Render the frame's stored gaussian predictions (self + cross, both
    in the frame's camera) from `target_T_WC` (default: the frame's own
    pose). Returns an (H, W, 3) float image, or None without predictions.

    rasterizer: "auto" ("cuda" for CUDA tensors, "torch" on the CPU),
    "cuda" (render_tiles_cuda) or "torch" (render_tiles)."""
    if frame.gaussian_pred is None or frame.gaussian_pred_cross is None:
        return None
    from splatt3r_slam_tpu_torch.splat.cuda_rasterizer import (
        render_tiles_cuda,
    )
    from splatt3r_slam_tpu_torch.splat.rasterizer import (
        default_rasterizer,
        render_tiles,
    )

    gp = frame.gaussian_pred
    dev = gp["means"].device
    if rasterizer == "auto":
        rasterizer = default_rasterizer(gp["means"])
    _, h, w, _ = gp["means"].shape
    if hw is None:
        hw = (h, w)
    if K is None:
        focal = float(max(hw))
        K = torch.tensor([[focal, 0, hw[1] / 2], [0, focal, hw[0] / 2],
                          [0, 0, 1]], dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)

    with record_function("port.render.gaussians"):
        means, covs, cols, opas = frame_gaussians(frame, ref_frame)

    # gaussians live in the frame's camera; view = T_target⁻¹ ∘ T_frame
    T_t = frame.T_WC if target_T_WC is None else target_T_WC
    view = torch.linalg.inv(sim3.matrix(T_t)) @ sim3.matrix(frame.T_WC)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    if rasterizer == "cuda":
        return render_tiles_cuda(means, covs, cols, opas, view, K, hw, bg,
                                 tpg_side=tpg_side, k_max=k_max)
    if rasterizer == "torch":
        return render_tiles(means, covs, cols, opas, view, K, hw, bg,
                            tpg_side=tpg_side, k_max=k_max)
    raise ValueError(f"unknown rasterizer {rasterizer!r}")
