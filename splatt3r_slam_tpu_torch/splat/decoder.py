"""Rendering decoder: two-view Gaussian predictions → target-view images.

Counterpart of `splatt3r_slam_tpu/splat/decoder.py`:
- `DecoderSplatting`, the pixelsplat-style batch renderer the trainer's
  render loss runs: target extrinsics rebased into the first context
  view's frame, the whole scene rescaled by 1/near, view-1 self
  predictions stacked with view-2 cross predictions, and each (batch,
  view) pair rendered. Differentiable: on the hand-written compositor
  through `cuda_rasterizer.Composite`, on the plain one through autograd;
- `get_fov`, `get_projection_matrix`, `render_depth` (depth as colour);
- `render_frame`, the SLAM per-frame render façade: covariances from
  scales/rotations, SH residual from the source images, Sim3 poses.
The rasterizer is the hand-written CUDA compositor for CUDA tensors
(`rasterizer.default_rasterizer`) and the plain compositor on the CPU.
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


def _rasterizer(name: str, like: torch.Tensor):
    """"auto" | "cuda" | "torch" → the render function. "auto" is "cuda"
    for CUDA tensors and "torch" on the CPU; "cuda" with CPU tensors runs
    the compositor's plain forward and backward."""
    from splatt3r_slam_tpu_torch.splat.cuda_rasterizer import (
        render_tiles_cuda,
    )
    from splatt3r_slam_tpu_torch.splat.rasterizer import (
        default_rasterizer,
        render_tiles,
    )

    if name == "auto":
        name = default_rasterizer(like)
    if name == "cuda":
        return render_tiles_cuda
    if name == "torch":
        return render_tiles
    raise ValueError(f"unknown rasterizer {name!r}")


def get_fov(K_norm):
    """Horizontal/vertical FOV from a normalized intrinsics matrix."""
    fx, fy = K_norm[..., 0, 0], K_norm[..., 1, 1]
    return torch.stack([2.0 * torch.atan(0.5 / fx),
                        2.0 * torch.atan(0.5 / fy)], dim=-1)


def get_projection_matrix(near, far, fov_x, fov_y):
    """Frustum → NDC matrix, Z to (0,1), Z-flip convention."""
    near, far, fov_x, fov_y = torch.broadcast_tensors(
        *(torch.as_tensor(a, dtype=torch.float32)
          for a in (near, far, fov_x, fov_y)))
    top = torch.tan(0.5 * fov_y) * near
    right = torch.tan(0.5 * fov_x) * near
    z = torch.zeros_like(near)
    o = torch.ones_like(near)
    rows = [
        [near / right, z, z, z],
        [z, near / top, z, z],
        [z, z, far / (far - near), -(far * near) / (far - near)],
        [z, z, o, z],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def render_depth(means, cov_triu, opa, view, K, hw, mode: str = "depth",
                 near: float = 0.1, far: float = 100.0, k_max=512,
                 tpg_side=4):
    """Depth rendering via depth-as-colour compositing (modes depth /
    disparity / relative_disparity / log). Returns (H, W) float."""
    means, view = means.float(), view.float()
    z = means @ view[2, :3] + view[2, 3]  # camera-space depth per gaussian
    if mode == "disparity":
        fake = 1.0 / torch.clamp(z, min=1e-9)
    elif mode == "relative_disparity":
        # 0 at near, 1 at far (in disparity)
        disp = 1.0 / torch.clamp(z, min=1e-9)
        dnear, dfar = 1.0 / near, 1.0 / far
        fake = 1.0 - (disp - dfar) / (dnear - dfar)
    elif mode == "log":
        fake = torch.log(torch.clamp(z, near, far))
    else:
        fake = z
    colors = fake[:, None].expand(means.shape[0], 3)
    img = _rasterizer("auto", means)(
        means, cov_triu, colors, opa, view, K, hw,
        torch.zeros(3, device=means.device), tpg_side=tpg_side, k_max=k_max)
    return img[..., 0]


class DecoderSplatting:
    """pixelsplat-style batch renderer over the tile rasterizer.

    rasterizer: "auto" ("cuda", the hand-written compositor under its
    autograd Function, for CUDA tensors; "torch", the plain compositor, on
    the CPU), "cuda" or "torch"."""

    def __init__(self, background_color=(0.0, 0.0, 0.0), k_max=512,
                 tpg_side=4, rasterizer: str = "auto"):
        self.bg = torch.tensor(background_color, dtype=torch.float32)
        self.k_max = k_max
        self.tpg_side = tpg_side
        self.rasterizer = rasterizer

    def __call__(self, batch, pred1, pred2, image_shape):
        """batch: {'context': [{'camera_pose' (B,4,4)}],
                   'target': [{'camera_pose' (B,4,4),
                               'camera_intrinsics' (B,3,3)} ...]}.
        Returns (color (B, V, 3, H, W), None): channel-first, as the
        reference's output contract."""
        H, W = image_shape
        inv_base = torch.linalg.inv(
            batch["context"][0]["camera_pose"].float())  # cam→world, inverted
        extr = torch.stack([t["camera_pose"] for t in batch["target"]],
                           dim=1).float()  # (B, V, 4, 4)
        intr = torch.stack([t["camera_intrinsics"] for t in batch["target"]],
                           dim=1).float()  # (B, V, 3, 3) pixel-space
        extr = torch.einsum("bij,bvjk->bvik", inv_base, extr)
        B, V = extr.shape[:2]

        def both(a, b, last):
            return torch.cat([a.reshape(B, -1, last), b.reshape(B, -1, last)],
                             dim=1)

        means = both(pred1["means"], pred2["means_in_other_view"], 3)
        covs = both(cov_to_triu(pred1["covariances"]),
                    cov_to_triu(pred2["covariances"]), 6)
        colors = torch.clamp(SH2RGB(both(pred1["sh"][..., 0],
                                         pred2["sh"][..., 0], 3)), 0.0, 1.0)
        opa = both(pred1["opacities"], pred2["opacities"], 1)[..., 0]

        raster = _rasterizer(self.rasterizer, means)
        bg = self.bg.to(means.device)
        near = 0.1
        scale = 1.0 / near
        imgs = []
        for b in range(B):
            m = means[b] * scale
            c = covs[b] * (scale**2)
            for v in range(V):
                E = extr[b, v].clone()
                E[:3, 3] = E[:3, 3] * scale
                img = raster(m, c, colors[b], opa[b], torch.linalg.inv(E),
                             intr[b, v], (H, W), bg, tpg_side=self.tpg_side,
                             k_max=self.k_max)
                imgs.append(img)
        color = torch.stack(imgs).reshape(B, V, H, W, 3)
        return color.permute(0, 1, 4, 2, 3), None


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
    gp = frame.gaussian_pred
    dev = gp["means"].device
    raster = _rasterizer(rasterizer, gp["means"])
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
    return raster(means, covs, cols, opas, view, K, hw, bg,
                  tpg_side=tpg_side, k_max=k_max)
