"""Model façade for the SLAM runtime.

Counterpart of `splatt3r_slam_tpu/runtime/inference.py`: mono two-view
inference with keyframe feature caching, and lazy Gaussian
materialization from the decoder hooks the tracking-mode frontend keeps.
PyTorch runs eagerly, so the JAX package's jitted units are plain methods
run under `torch.no_grad()`.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.models.heads import combine_gaussians
from splatt3r_slam_tpu_torch.runtime.frame import Frame


def _extract_gaussians(res: dict) -> dict:
    """Gaussian params for rendering."""
    d = {k: res[k] for k in ("means", "scales", "rotations", "sh",
                             "opacities")}
    d["conf"] = res["conf"]
    return d


class InferenceEngine:
    """Holds the model and runs its inference units."""

    def __init__(self, model, h: int, w: int):
        self.model = model.eval().requires_grad_(False)
        self.h, self.w = h, w
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def encode(self, img):
        return self.model.encode(img)

    @torch.no_grad()
    def decoder(self, feat1, pos1, feat2, pos2, mode="full"):
        """decode + both heads → (res1, res2) activation dicts."""
        d1, d2 = self.model.decode(feat1, pos1, feat2, pos2)
        hw = (self.h, self.w)
        return (self.model.apply_head(1, d1, hw, mode),
                self.model.apply_head(2, d2, hw, mode))

    @torch.no_grad()
    def _gauss_from_hooks_one(self, d, X, C, head_idx):
        """One view's Gaussian materialization from kept decoder hooks."""
        h, w = self.h, self.w
        g = self.model.apply_head(head_idx, d, (h, w), "gaussian_only")
        return combine_gaussians(g, X.reshape(1, h, w, 3),
                                 C.reshape(1, h, w),
                                 self.model.cfg.use_offsets)

    def ensure_encoded(self, frame: Frame):
        if frame.feat is None:
            frame.feat, frame.pos = self.encode(frame.img)

    def ensure_gaussians(self, frame: Frame, need_cross: bool = True):
        """Materialize frame.gaussian_pred(_cross) from kept hook tokens
        (no-op when the frontend already ran the full heads).
        need_cross=False materializes only the self view."""
        if frame.gauss_hooks is None:
            return
        hk = frame.gauss_hooks
        with record_function("port.gaussians.heads"):
            if frame.gaussian_pred is None:
                frame.gaussian_pred = self._gauss_from_hooks_one(
                    hk["d1"], hk["X1"], hk["C1"], 1)
            if need_cross and frame.gaussian_pred_cross is None:
                frame.gaussian_pred_cross = self._gauss_from_hooks_one(
                    hk["d2"], hk["X2"], hk["C2"], 2)

    def inference_mono(self, frame: Frame):
        """Single-view init: the frame against itself. Returns
        (X (N,3), C (N,1)) and stores Gaussian predictions on the frame."""
        self.ensure_encoded(frame)
        res11, res21 = self.decoder(frame.feat, frame.pos, frame.feat,
                                    frame.pos)
        frame.gaussian_pred = _extract_gaussians(res11)
        frame.gaussian_pred_cross = _extract_gaussians(res21)
        return self._downsample_XC(res11)

    def _downsample_XC(self, res):
        ds = config.get("dataset", {}).get("img_downsample", 1)
        X = res["pts3d"][0]
        C = res["conf"][0]
        if ds > 1:
            X = X[::ds, ::ds]
            C = C[::ds, ::ds]
        return X.reshape(-1, 3), C.reshape(-1, 1)
