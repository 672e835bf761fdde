"""Analytic plane-scene oracle engine for closed-loop runs.

Counterpart of `splatt3r_slam_tpu/runtime/oracle.py`. Random weights never
track (every GN solve fails), so tracking, data-driven keyframing, the
backend's multi-iteration solves and RELOC can only run as users run them
on geometry that is right. This module supplies it: a plane scene with a
known camera trajectory whose per-pixel pointmaps and cross-frame
correspondences are computed analytically.

Two uses:
- standalone (`inner=None`): an `InferenceEngine` double with no network;
- wrapping the real engine (`inner=engine`): every real network dispatch
  still runs and only its outputs are replaced by oracle geometry, so a
  run over the wrapper pays the model's full device cost.

Frame identity travels inside the features: the oracle stamps
`feat[0, 0, 0] = frame_id` after encoding (into a copy, so no tensor that
shares the encoder's storage changes), and the batched backend matcher
(`match_symmetric`, which sees only stacked features) reads the ids back
from that slot. The host geometry and its noise are numpy in float64, as
the JAX package computes them, so the modular path gets the same values bit
for bit; the fused step computes its geometry on the device
(`runtime/fused.py::_oracle_geometry`).
"""

from __future__ import annotations

import numpy as np
import torch

from splatt3r_slam_tpu_torch import resolve_device


def make_rays(h: int, w: int, focal: float) -> np.ndarray:
    """(h·w, 3) pixel-centre unit-z rays, v-major."""
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5,
                       indexing="xy")
    r = np.stack(
        [(u - w / 2) / focal, (v - h / 2) / focal, np.ones_like(u)], -1)
    return r.reshape(-1, 3)


def pan_trajectory(n: int, w: int, plane_d: float = 2.0) -> list:
    """TUM-like smooth pan over the plane: a lateral translation worth ~8%
    of the image width per frame at the plane's depth, gentle yaw and a
    parallax bob, so keyframe overlap decays ~8% a frame and the keyframe
    criterion (match_frac_thresh 0.333) fires every ~6-8 frames."""
    focal = float(w)
    px_per_frame = 0.078 * w
    poses = []
    for i in range(n):
        yaw = 0.004 * i
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = [px_per_frame * i * plane_d / focal,
                    0.05 * np.sin(0.4 * i), 0.03 * np.sin(0.23 * i)]
        poses.append(T)
    return poses


def reloc_pan_trajectory(n: int, w: int, blackout: tuple[int, int],
                         revisit_back: int = 8,
                         plane_d: float = 2.0) -> list:
    """Kidnapped-camera pan: as `pan_trajectory` until the occlusion
    window, then the camera re-emerges `revisit_back` frames before the
    window started, inside the mapped region, and pans on from there
    (without the revisit no keyframe overlaps the re-emerging view)."""
    base = pan_trajectory(n + revisit_back, w, plane_d)
    a, b = blackout
    return [base[max(a - revisit_back, 0) + (i - b)] if i >= b else base[i]
            for i in range(n)]


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _long(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def _bool(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, bool)).to(device)


class PlaneSceneOracle:
    """Exact-geometry engine over the plane n·X = d.

    Mirrors `InferenceEngine`'s surface (`runtime/inference.py`):
    `ensure_encoded`, `ensure_gaussians`, `inference_mono`,
    `match_asymmetric`, `match_symmetric`, `match_oneway`, and `model` and
    `device` for the fused frontend. Ground-truth 4x4 camera poses are
    registered per frame id with `register()` before the frame is
    processed. `device` applies when there is no `inner` engine.
    """

    CONF = 10.0

    def __init__(self, h: int, w: int, focal: float | None = None,
                 plane_n=(0.0, 0.0, 1.0), plane_d: float = 2.0,
                 inner=None, stride: int = 1, noise: float = 0.0,
                 conf_noise: float = 0.0,
                 blackout: tuple[int, int] | None = None, device="cuda"):
        self.h, self.w = int(h), int(w)
        self.N = self.h * self.w
        self.focal = float(focal if focal is not None else w)
        self.rays = make_rays(self.h, self.w, self.focal)
        n = np.asarray(plane_n, np.float64)
        self.n = n / np.linalg.norm(n)
        self.d = float(plane_d)
        self.inner = inner
        self.device = (inner.device if inner is not None
                       else resolve_device(device))
        # the matching subgrid's stride (config matching.match_stride):
        # correspondences are emitted on the grid the pipeline matches on
        self.stride = max(1, int(stride))
        self.hs, self.ws = self.h // self.stride, self.w // self.stride
        self.Ns = self.hs * self.ws
        self.gt: dict[int, np.ndarray] = {}
        # prediction noise: `noise` a depth-proportional pointmap sigma,
        # `conf_noise` a lognormal sigma on the confidences, `blackout` an
        # [a, b) frame-id window of full occlusion (matches invalid,
        # geometry meaningless) that forces a real tracking loss
        self.noise = float(noise)
        self.conf_noise = float(conf_noise)
        self.blackout = tuple(blackout) if blackout is not None else None
        # per-pose pointmap cache: the active keyframe's pose recurs every
        # frame
        self._pm_cache: dict[bytes, np.ndarray] = {}

    # -- noise model -------------------------------------------------------
    def _rng(self, fid: int, salt: int):
        seed = (0x9E3779B97F4A7C15 * (2 * int(fid) + 1) + salt) % (1 << 64)
        return np.random.default_rng(seed)

    def blacked(self, fid: int) -> bool:
        return (self.blackout is not None
                and self.blackout[0] <= int(fid) < self.blackout[1])

    def _noisy(self, X: np.ndarray, fid: int, salt: int) -> np.ndarray:
        if self.noise <= 0.0:
            return X
        rng = self._rng(fid, salt)
        return X + rng.standard_normal(X.shape) * (
            self.noise * np.abs(X[:, 2:3]))

    def _conf(self, n: int, fid: int, salt: int) -> np.ndarray:
        C = np.full((n, 1), self.CONF, np.float32)
        if self.conf_noise > 0.0:
            rng = self._rng(fid, salt)
            C = C * np.exp(self.conf_noise * rng.standard_normal((n, 1))
                           ).astype(np.float32)
        return C

    # -- ground truth ------------------------------------------------------
    def register(self, frame_id: int, T: np.ndarray):
        self.gt[int(frame_id)] = np.asarray(T, np.float64)

    def gt_pointmap_cam(self, T: np.ndarray) -> np.ndarray:
        """Per-pixel ray/plane intersection in camera coordinates, (N, 3)."""
        key = T.tobytes()
        hit = self._pm_cache.get(key)
        if hit is not None:
            return hit
        r = self.rays
        Rw = (T[:3, :3] @ r.T).T
        tstar = (self.d - self.n @ T[:3, 3]) / (Rw @ self.n)
        out = r * tstar[:, None]
        if len(self._pm_cache) > 64:
            self._pm_cache.clear()
        self._pm_cache[key] = out
        return out

    def _project(self, T_src: np.ndarray, T_dst: np.ndarray):
        """src pixels' world points in dst's image: continuous (u, v), the
        in-bounds mask (N,), X in dst's camera (N, 3)."""
        Xc_src = self.gt_pointmap_cam(T_src)
        Xw = (T_src[:3, :3] @ Xc_src.T).T + T_src[:3, 3]
        Xc = (T_dst[:3, :3].T @ (Xw - T_dst[:3, 3]).T).T
        z = np.maximum(Xc[:, 2], 1e-9)
        u = self.focal * Xc[:, 0] / z + self.w / 2
        v = self.focal * Xc[:, 1] / z + self.h / 2
        ok = ((u >= 0) & (u < self.w) & (v >= 0) & (v < self.h)
              & (Xc[:, 2] > 0))
        return u, v, ok, Xc

    def project_into(self, T_src: np.ndarray, T_dst: np.ndarray):
        """src pixels' world points in dst's image: (flat index (N,), mask
        (N,), X in dst's camera (N, 3)); the pixel is the floor of (u, v)."""
        u, v, ok, Xc = self._project(T_src, T_dst)
        ui = np.clip(np.floor(u).astype(np.int64), 0, self.w - 1)
        vi = np.clip(np.floor(v).astype(np.int64), 0, self.h - 1)
        return vi * self.w + ui, ok, Xc

    def project_into_sub(self, T_src: np.ndarray, T_dst: np.ndarray):
        """Subgrid variant: src's subgrid pixels located on dst's (hs, ws)
        matching subgrid → (flat subgrid index (Ns,), mask (Ns,), X in
        dst's camera (Ns, 3)). Subgrid sample (i, j) is the full-resolution
        pixel (s·i, s·j); the match is the nearest dst subgrid sample
        (round to nearest, ties to even)."""
        s = self.stride
        u, v, ok, Xc = self._project(T_src, T_dst)

        def sub(a):
            return np.ascontiguousarray(
                a.reshape(self.h, self.w, -1)[::s, ::s]).reshape(self.Ns, -1)

        u_s, v_s = sub(u)[:, 0], sub(v)[:, 0]
        ui = np.clip(np.rint((u_s - 0.5) / s).astype(np.int64), 0,
                     self.ws - 1)
        vi = np.clip(np.rint((v_s - 0.5) / s).astype(np.int64), 0,
                     self.hs - 1)
        return vi * self.ws + ui, sub(ok)[:, 0], sub(Xc)

    def _edge_proj(self):
        return self.project_into_sub if self.stride > 1 else self.project_into

    # -- InferenceEngine surface ------------------------------------------
    @property
    def model(self):
        return self.inner.model

    def _stamp(self, frame):
        """Write the frame id into feat[0, 0, 0] of a copy of the
        features. The id must be exact in the feature dtype (bfloat16 holds
        integers exactly only up to 256); the check runs on the host."""
        fid = float(frame.frame_id)
        if float(torch.tensor(fid, dtype=frame.feat.dtype)) != fid:
            raise ValueError(
                f"frame_id {frame.frame_id} not exactly representable in "
                f"feature dtype {frame.feat.dtype}; cap the oracle run "
                "length (at most 256 frames with bfloat16 features)")
        feat = frame.feat.clone()
        feat[0, 0, 0] = fid
        frame.feat = feat

    @staticmethod
    def _ids(feat) -> list[int]:
        """Frame ids stamped into (E, P, C) features: E scalars pulled."""
        return [int(i) for i in torch.round(feat[:, 0, 0].float()).tolist()]

    def ensure_encoded(self, frame):
        if frame.feat is not None:
            return
        if self.inner is not None:
            self.inner.ensure_encoded(frame)
        else:
            frame.feat = torch.zeros((1, 1, 1), device=self.device)
            frame.pos = torch.zeros((1, 1, 2), device=self.device)
        self._stamp(frame)

    def ensure_gaussians(self, frame, need_cross: bool = True):
        if self.inner is not None:
            self.inner.ensure_gaussians(frame, need_cross)

    def inference_mono(self, frame):
        self.ensure_encoded(frame)
        if self.inner is not None:
            self.inner.inference_mono(frame)  # paid for; output replaced
        fid = frame.frame_id
        if self.blacked(fid):
            # occluded: a meaningless constant-depth sheet
            X = self.rays * self.d
        else:
            X = self._noisy(self.gt_pointmap_cam(self.gt[fid]), fid, 0)
        C = self._conf(self.N, fid, 1)
        return _f32(X, self.device), _f32(C, self.device)

    def match_asymmetric(self, frame, keyframe, idx_i2j_init=None):
        self.ensure_encoded(frame)
        self.ensure_encoded(keyframe)
        if self.inner is not None:
            self.inner.match_asymmetric(frame, keyframe, idx_i2j_init)
        fid, kid = frame.frame_id, keyframe.frame_id
        Tf, Tk = self.gt[fid], self.gt[kid]
        # per keyframe pixel: its match in the frame and its position in
        # the frame's camera (the decoder's cross prediction)
        idx, ok, Xkf = self.project_into(Tk, Tf)
        if self.blacked(fid) or self.blacked(kid):
            ok = np.zeros_like(ok)
        Xff = self._noisy(self.gt_pointmap_cam(Tf), fid, 0)
        Xkf = self._noisy(Xkf, fid, 2)
        Q = torch.full((self.N, 1), self.CONF, device=self.device)
        dev = self.device
        return (_long(idx[None], dev), _bool(ok[None, :, None], dev),
                _f32(Xff, dev), _f32(self._conf(self.N, fid, 1), dev), Q,
                _f32(Xkf, dev), _f32(self._conf(self.N, fid, 3), dev), Q)

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j):
        if self.inner is not None:
            self.inner.match_symmetric(feat_i, pos_i, feat_j, pos_j)
        # only the E stamped ids come to the host, not the features
        ids_i, ids_j = self._ids(feat_i), self._ids(feat_j)
        proj = self._edge_proj()
        E, N = len(ids_i), (self.Ns if self.stride > 1 else self.N)
        idx_i2j = np.zeros((E, N), np.int64)
        idx_j2i = np.zeros((E, N), np.int64)
        valid_j = np.zeros((E, N, 1), bool)
        valid_i = np.zeros((E, N, 1), bool)
        for e, (fi, fj) in enumerate(zip(ids_i, ids_j)):
            Ti, Tj = self.gt[fi], self.gt[fj]
            idx_i2j[e], valid_j[e, :, 0], _ = proj(Tj, Ti)
            idx_j2i[e], valid_i[e, :, 0], _ = proj(Ti, Tj)
            if self.blacked(fi) or self.blacked(fj):
                valid_j[e] = False
                valid_i[e] = False
        dev = self.device
        Q = torch.full((E, N, 1), self.CONF, device=dev)
        return (_long(idx_i2j, dev), _long(idx_j2i, dev), _bool(valid_j, dev),
                _bool(valid_i, dev), Q, Q, Q, Q)

    def match_oneway(self, feat_i, pos_i, feat_j, pos_j):
        """One direction of an (i, j) edge, as `InferenceEngine.match_oneway`:
        rows are j's subgrid pixels located in i's image."""
        if self.inner is not None:
            self.inner.match_oneway(feat_i, pos_i, feat_j, pos_j)
        (fi,), (fj,) = self._ids(feat_i), self._ids(feat_j)
        idx, ok, _ = self._edge_proj()(self.gt[fj], self.gt[fi])
        if self.blacked(fi) or self.blacked(fj):
            ok = np.zeros_like(ok)
        Q = torch.full((len(idx),), self.CONF, device=self.device)
        return _long(idx, self.device), _bool(ok, self.device), Q

    def fused_inputs(self, frame_id: int, kf_frame_id: int) -> dict:
        """Per-frame inputs of the oracle variant of the fused tracking step
        (`runtime/fused.py::fused_track_step` with `oracle=`). The geometry
        is computed on the device inside the step from the two poses; the
        host ships 40 floats in one copy. `on` is a tensor, so the step
        selects between oracle and network values with `torch.where` and
        the network and the matcher always run. `fid` seeds the step's
        device noise generator; `conf_noise` applies only to the modular and
        mono paths."""
        fid, kid = int(frame_id), int(kf_frame_id)
        blk = self.blacked(fid) or self.blacked(kid)
        packed = np.concatenate([
            [1.0], self.gt[fid].ravel(), self.gt[kid].ravel(), self.n,
            [self.d, self.focal, 0.0 if blk else 1.0, self.noise]])
        v = _f32(packed, self.device)
        return {"on": v[0], "T_f": v[1:17].view(4, 4),
                "T_k": v[17:33].view(4, 4), "plane_n": v[33:36],
                "plane_d": v[36], "focal": v[37], "ok": v[38],
                "sigma": v[39] if self.noise > 0.0 else None, "fid": fid}


class OracleRetrieval:
    """Retrieval-database double for closed-loop relocalization.

    Candidates are ranked by true view overlap (the share of a keyframe's
    pixels visible in the query frame, from the ground-truth poses), an
    ideal retrieval, so the RELOC path's real machinery (the strict
    `add_factors` gate, the pose seed from the top candidate, the solve;
    `backend/factor_graph.py::relocalize`) runs deterministically. Pass the
    real `RetrievalDatabase` as `inner` to pay its full query cost per
    event. Each keyframe enters the inner database once; the JAX package's
    version adds it twice (its `update` passes `add_after_query` on and
    then calls `add_to_database` as well).
    `update` returns keyframe indices, which equal add order (every
    keyframe event adds one entry, in order)."""

    def __init__(self, oracle: PlaneSceneOracle, inner=None,
                 min_overlap: float = 0.25):
        self.oracle = oracle
        self.inner = inner
        self.min_overlap = float(min_overlap)
        self.fids: list[int] = []

    def update(self, frame, add_after_query=True, k=3, min_thresh=0.0):
        if self.inner is not None:
            self.inner.update(frame, add_after_query=add_after_query, k=k,
                              min_thresh=min_thresh)
        Tq = self.oracle.gt[int(frame.frame_id)]
        scores = []
        for kf_idx, fid in enumerate(self.fids):
            _, ok, _ = self.oracle.project_into(self.oracle.gt[fid], Tq)
            scores.append((float(ok.mean()), kf_idx))
        top = [i for s, i in sorted(scores, reverse=True)[:int(k)]
               if s >= self.min_overlap]
        if add_after_query:  # the inner update has added it already
            self.fids.append(int(frame.frame_id))
        return top

    def add_to_database(self, frame):
        if self.inner is not None:
            self.inner.add_to_database(frame)
        self.fids.append(int(frame.frame_id))
