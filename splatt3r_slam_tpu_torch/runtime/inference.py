"""Model façade for the SLAM runtime.

Counterpart of `splatt3r_slam_tpu/runtime/inference.py`: mono,
asymmetric (frame against keyframe) and symmetric (backend edges) two-view
inference with keyframe feature caching, lazy Gaussian materialization
from the decoder hooks the tracking-mode frontend keeps, and the backend's
one-way and symmetric edge matching. PyTorch runs eagerly, so the JAX
package's jitted units are plain methods run under `torch.no_grad()`. The
edge matching runs the heads in "tracking" mode: it reads only pts3d,
conf, desc and desc_conf, which that mode computes as "full" does, and it
skips the gaussian DPTs (the JAX package's decode returns them too).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.models.heads import combine_gaussians
from splatt3r_slam_tpu_torch.ops import matching
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

    @staticmethod
    def _edge_stride() -> int:
        """img_downsample × matching.match_stride: the (h/s, w/s) grid the
        backend's edge matching and stored edge state live on."""
        ds = config.get("dataset", {}).get("img_downsample", 1)
        return ds * max(1, int(config["matching"].get("match_stride", 1)))

    @torch.no_grad()
    def match_asymmetric(self, frame: Frame, keyframe: Frame,
                         idx_i2j_init=None):
        """One decoder pass frame←keyframe + matching. Returns (idx_f2k
        (1,N), valid_match_k (1,N,1), Xff, Cff, Qff, Xkf, Ckf, Qkf),
        flattened per pixel."""
        self.ensure_encoded(frame)
        self.ensure_encoded(keyframe)
        res11, res21 = self.decoder(frame.feat, frame.pos, keyframe.feat,
                                    keyframe.pos)
        frame.gaussian_pred = _extract_gaussians(res11)
        frame.gaussian_pred_cross = _extract_gaussians(res21)
        ds = config.get("dataset", {}).get("img_downsample", 1)

        def dsmap(a):
            return a[:, ::ds, ::ds] if ds > 1 else a

        idx_f2k, valid_match_k = matching.match(
            dsmap(res11["pts3d"]), dsmap(res21["pts3d"]),
            dsmap(res11["desc"]), dsmap(res21["desc"]), idx_i2j_init,
            **matching.match_kwargs_from_config(config["matching"]))

        def flat(a, c):
            return dsmap(a)[0].reshape(-1, c)

        return (idx_f2k, valid_match_k,
                flat(res11["pts3d"], 3), flat(res11["conf"][..., None], 1),
                flat(res11["desc_conf"][..., None], 1),
                flat(res21["pts3d"], 3), flat(res21["conf"][..., None], 1),
                flat(res21["desc_conf"][..., None], 1))

    @torch.no_grad()
    def match_oneway(self, feat_i, pos_i, feat_j, pos_j):
        """One edge direction: decode (i as view 1, j as view 2) and match
        j's cross points onto i's ray image. Returns (idx_i2j (ns,), valid_j
        (ns,), Qj (ns,) = sqrt(Qii[idx]·Qji)) on the matching subgrid."""
        r1, r2 = self.decoder(feat_i, pos_i, feat_j, pos_j, "tracking")
        s = self._edge_stride()

        def dsmap(a):
            return a[:, ::s, ::s] if s > 1 else a

        idx, valid = matching.match(
            dsmap(r1["pts3d"]), dsmap(r2["pts3d"]), dsmap(r1["desc"]),
            dsmap(r2["desc"]), None,
            **matching.match_kwargs_from_config(config["matching"]))
        Q1 = dsmap(r1["desc_conf"]).reshape(1, -1)
        Q2 = dsmap(r2["desc_conf"]).reshape(1, -1)
        Qj = torch.sqrt(torch.gather(Q1, 1, idx) * Q2)
        return idx[0], valid[0, :, 0], Qj[0]

    @torch.no_grad()
    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j):
        """Both directions of E edges as one decoder batch of 2E: view-1
        rows [i..., j...] against view-2 rows [j..., i...]. Inputs (E, P,
        C). Returns (idx_i2j, idx_j2i, valid_j, valid_i, Qii, Qjj, Qji,
        Qij), each with a leading E, on the matching subgrid."""
        E = feat_i.shape[0]
        r1, r2 = self.decoder(torch.cat([feat_i, feat_j]),
                              torch.cat([pos_i, pos_j]),
                              torch.cat([feat_j, feat_i]),
                              torch.cat([pos_j, pos_i]), "tracking")
        s = self._edge_stride()

        def dsmap(a):
            return a[:, ::s, ::s] if s > 1 else a

        idx, valid = matching.match(
            dsmap(r1["pts3d"]), dsmap(r2["pts3d"]), dsmap(r1["desc"]),
            dsmap(r2["desc"]), None,
            **matching.match_kwargs_from_config(config["matching"]))
        Q1 = dsmap(r1["desc_conf"]).reshape(2 * E, -1, 1)  # [Qii | Qjj]
        Q2 = dsmap(r2["desc_conf"]).reshape(2 * E, -1, 1)  # [Qji | Qij]
        return (idx[:E], idx[E:], valid[:E], valid[E:],
                Q1[:E], Q1[E:], Q2[:E], Q2[E:])
