"""Fused frontend: the whole per-frame tracking step.

Counterpart of `splatt3r_slam_tpu/runtime/fused.py` (without the
closed-loop oracle variant):

    encode(new frame) → decode+heads(frame, keyframe) → match →
    mask/fraction reductions → Sim(3) GN → keyframe pointmap fusion →
    keyframe-selection criterion

Keyframe tensors stay on the device; the host pulls one small flags vector
per frame to drive the mode state machine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from splatt3r_slam_tpu_torch.geometry.projective import (
    backproject,
    get_pixel_coords,
)
from splatt3r_slam_tpu_torch.lie import sim3
from splatt3r_slam_tpu_torch.ops import matching
from splatt3r_slam_tpu_torch.tracking.tracker import (
    TrackingConfig,
    opt_pose_calib_sim3,
    opt_pose_ray_dist_sim3,
)


class KFState(NamedTuple):
    """Device-resident last-keyframe state."""

    feat: torch.Tensor  # (1, P, C)
    pos: torch.Tensor  # (1, P, 2)
    X: torch.Tensor  # (N, 3) canonical pointmap
    C: torch.Tensor  # (N, 1) accumulated confidence
    N_fused: torch.Tensor  # () float — fusion count
    T_WC: torch.Tensor  # (8,)


def unique_match_count(idx, valid, ns):
    """Exact number of distinct keyframe pixels hit by valid matches
    (torch.unique(idx[valid]) semantics with static shapes: invalid
    entries scatter to an overflow slot `ns`, so they never collide with a
    real index such as 0)."""
    hits = torch.zeros((ns + 1,), dtype=torch.bool, device=idx.device)
    tgt = torch.where(valid, idx.long(), torch.full_like(idx.long(), ns))
    hits[tgt] = True
    return hits[:ns].sum()


class MatchingParams(NamedTuple):
    max_iter: int = 10
    lambda_init: float = 1e-8
    convergence_thresh: float = 1e-6
    dist_thresh: float = 1e-1
    radius: int = 3
    dilation_max: int = 5
    closed_form_init: bool = True
    polish_iters: int = 2
    refine_schedule: tuple | None = None  # None → (dilation_max, 1)
    refine_quantize: bool = True
    # s > 1 runs matching + the pose GN on an (h/s, w/s) subgrid; pointmap
    # fusion, heads and mapping stay full resolution
    match_stride: int = 1

    @classmethod
    def from_config(cls, cfg):
        kw = matching.match_kwargs_from_config(cfg["matching"])
        kw["match_stride"] = int(cfg["matching"].get("match_stride", 1))
        return cls(**kw)


@torch.no_grad()
def fused_track_step(model, img, kf: KFState, T_WCf_init, idx_init, h: int,
                     w: int, tcfg: TrackingConfig, mcfg: MatchingParams,
                     head_mode: str = "tracking", use_calib: bool = False,
                     K=None):
    """One tracking step → (outputs dict, flags (8,) [match_frac, new_kf,
    fail, try_reloc, N_fused, T_WC[:3]]), all on the device."""
    n = h * w
    s = max(1, int(mcfg.match_stride))
    hs, ws = h // s, w // s
    ns = hs * ws

    def sub_grid(a):
        return a[:, ::s, ::s] if s > 1 else a

    def sub_flat(a):
        if s == 1:
            return a
        return a.reshape(h, w, -1)[::s, ::s].reshape(ns, -1)

    with record_function("port.track.encode"):
        feat, pos = model.encode(img)
    with record_function("port.track.decode"):
        d1, d2 = model.decode(feat, pos, kf.feat, kf.pos)
    with record_function("port.track.heads"):
        res11 = model.apply_head(1, d1, (h, w), head_mode)
        res21 = model.apply_head(2, d2, (h, w), head_mode)

    with record_function("port.track.match"):
        idx_f2k_b, valid_b = matching.match(
            sub_grid(res11["pts3d"]), sub_grid(res21["pts3d"]),
            sub_grid(res11["desc"]), sub_grid(res21["desc"]), idx_init,
            max_iter=mcfg.max_iter, lambda_init=mcfg.lambda_init,
            convergence_thresh=mcfg.convergence_thresh,
            dist_thresh=mcfg.dist_thresh, radius=mcfg.radius,
            dilation_max=mcfg.dilation_max,
            closed_form_init=mcfg.closed_form_init,
            polish_iters=mcfg.polish_iters,
            refine_schedule=mcfg.refine_schedule,
            refine_quantize=mcfg.refine_quantize,
        )
    idx = idx_f2k_b[0]
    valid_match = valid_b[0]

    Xff = res11["pts3d"][0].reshape(n, 3)
    Cff = res11["conf"][0].reshape(n, 1)
    Xkf = res21["pts3d"][0].reshape(n, 3)
    Ckf = res21["conf"][0].reshape(n, 1)

    Xff_s = sub_flat(Xff)
    Cff_s = sub_flat(Cff)
    Qff_s = sub_grid(res11["desc_conf"])[0].reshape(ns, 1)
    Qkf_s = sub_grid(res21["desc_conf"])[0].reshape(ns, 1)
    Xk_s = sub_flat(kf.X)
    Ck_s = sub_flat(kf.C)

    # masks & fractions
    Qk = torch.sqrt(Qff_s[idx] * Qkf_s)
    Ck_avg = Ck_s / kf.N_fused
    valid_Q = Qk > tcfg.Q_conf
    valid_opt = (valid_match & (Cff_s[idx] > tcfg.C_conf)
                 & (Ck_avg > tcfg.C_conf) & valid_Q)
    valid_kf = valid_match & valid_Q
    match_frac = valid_opt.float().mean()
    match_frac_k = valid_kf.float().mean()
    unique_frac = unique_match_count(idx, valid_match[:, 0], ns) / ns

    with record_function("port.track.gn"):
        if use_calib:
            # subgrid pixels at their true image coordinates (stride·grid)
            uv_sub = get_pixel_coords(1, (hs, ws), device=img.device
                                      ).reshape(ns, 2) * float(s)
            Xf_ray = backproject(uv_sub, Xff_s[..., 2:3], K)
            Xk_ray = backproject(uv_sub, Xk_s[..., 2:3], K)
            zk = Xk_ray[..., 2:3]
            valid_meas = zk > tcfg.depth_eps
            logz = torch.where(valid_meas,
                               torch.log(torch.clamp(zk, min=1e-12)),
                               torch.zeros_like(zk))
            meas_k = torch.where(valid_meas,
                                 torch.cat([uv_sub, logz], dim=-1),
                                 torch.zeros_like(Xk_ray))
            T_WCf, T_CkCf, fail = opt_pose_calib_sim3(
                Xf_ray[idx], Xk_ray, T_WCf_init, kf.T_WC, Qk, valid_opt,
                meas_k, valid_meas, K, (h, w), tcfg)
        else:
            T_WCf, T_CkCf, fail = opt_pose_ray_dist_sim3(
                Xff_s[idx], Xk_s, T_WCf_init, kf.T_WC, Qk, valid_opt, tcfg)
    try_reloc = (match_frac < tcfg.min_match_frac) | fail

    # keyframe pointmap fusion with the frame's cross prediction
    Xkk = sim3.act(T_CkCf, Xkf)
    ok = ~try_reloc
    kf_new = kf._replace(
        X=torch.where(ok, (kf.C * kf.X + Ckf * Xkk) / (kf.C + Ckf), kf.X),
        C=torch.where(ok, kf.C + Ckf, kf.C),
        N_fused=kf.N_fused + ok.float(),
    )
    new_kf = (torch.minimum(match_frac_k, unique_frac)
              < tcfg.match_frac_thresh) & ok
    T_out = torch.where(ok, T_WCf, T_WCf_init)
    flags = torch.cat([
        torch.stack([match_frac, new_kf.float(), fail.float(),
                     try_reloc.float(), kf_new.N_fused]),
        T_out[:3],
    ])
    out = {"feat": feat, "pos": pos, "X": Xff, "C": Cff, "T_WCf": T_out,
           "idx_f2k": idx_f2k_b, "kf": kf_new,
           "edge_half": (idx, valid_match[:, 0], Qk[:, 0])}
    if head_mode == "full":
        keys = ("means", "scales", "rotations", "sh", "opacities", "conf")
        out["gaussians"] = {k: res11[k] for k in keys}
        out["gaussians_cross"] = {k: res21[k] for k in keys}
    else:
        out.update(d1=d1, d2=d2, Xkf=Xkf, Ckf=Ckf)
    return out, flags


class FusedTracker:
    """Host loop around the fused step: one step + one flags pull per
    frame."""

    def __init__(self, engine, keyframes, config):
        self.engine = engine
        self.keyframes = keyframes
        self.tcfg = TrackingConfig.from_config(config)
        self.mcfg = MatchingParams.from_config(config)
        self.use_calib = bool(config.get("use_calib", False))
        self.idx_f2k = None
        self._kf_state = None
        self._host_N = 0
        self.filtering_mode = config["tracking"]["filtering_mode"]
        self.filtering_score = config["tracking"]["filtering_score"]
        # pipeline_lag=1: consume each frame's flags one frame late
        self.pipeline_lag = int(config["tracking"].get("pipeline_lag", 0))
        self._pending = None
        self.last_T_WC_host = None
        self.fails = 0  # frames whose pose solve failed

    def step(self, img, kf, T_WCf_init, idx_init, K=None):
        return fused_track_step(
            self.engine.model, img, kf, T_WCf_init, idx_init, self.engine.h,
            self.engine.w, self.tcfg, self.mcfg, use_calib=self.use_calib,
            K=K)

    def reset_idx_f2k(self):
        self.idx_f2k = None
        # a lagged decision refers to a keyframe being replaced
        self._pending = None

    def _sync_kf_state(self):
        kf = self.keyframes.last_keyframe()
        self._kf_state = KFState(
            feat=kf.feat, pos=kf.pos, X=kf.X_canon, C=kf.C,
            N_fused=torch.tensor(float(kf.N), device=kf.X_canon.device),
            T_WC=kf.T_WC)
        self._host_N = int(kf.N)

    def track(self, frame):
        flushed = None
        if self._kf_state is None or self.keyframes.is_dirty[-1]:
            # consume the lagged in-flight frame first so the host N
            # matches the device fold count before the resync
            if self._pending is not None:
                pf, pfl, pkfr = self._pending
                self._pending = None
                flushed = self._consume(pf, pfl.cpu().numpy(), pkfr)
            self.engine.ensure_encoded(self.keyframes.last_keyframe())
            self._sync_kf_state()

        K = self.keyframes.K if self.use_calib else None
        if K is not None:
            K = K.to(frame.img.device)
        out, flags = self.step(frame.img, self._kf_state, frame.T_WC,
                               self.idx_f2k, K)

        self.idx_f2k = out["idx_f2k"]
        frame.feat, frame.pos = out["feat"], out["pos"]
        frame.X_canon, frame.C = out["X"], out["C"]
        frame.N = 1
        frame.N_updates = 1
        if "gaussians" in out:
            frame.gaussian_pred = out["gaussians"]
            frame.gaussian_pred_cross = out["gaussians_cross"]
        else:
            frame.gauss_hooks = {
                "d1": out["d1"], "d2": out["d2"],
                "X1": out["X"], "C1": out["C"],
                "X2": out["Xkf"], "C2": out["Ckf"],
            }
        frame.T_WC = out["T_WCf"]
        eh_idx, eh_valid, eh_Q = out["edge_half"]
        frame.edge_half = {"idx_j2i": eh_idx, "valid_i": eh_valid,
                           "Qi": eh_Q, "kf_idx": len(self.keyframes) - 1}
        kfr = self.keyframes.last_keyframe()
        kfr.X_canon = out["kf"].X
        kfr.C = out["kf"].C
        self._kf_state = out["kf"]
        self.keyframes.is_dirty[len(self.keyframes) - 1] = False

        if self.pipeline_lag > 0:
            prev, self._pending = self._pending, (frame, flags, kfr)
            if prev is None:
                return flushed if flushed is not None else (False, False)
            pframe, pflags, pkfr = prev
            return self._consume(pframe, pflags.cpu().numpy(), pkfr)
        return self._consume(frame, flags.cpu().numpy(), kfr)

    def _consume(self, frame, flags: np.ndarray, kfr):
        """Apply one frame's host decisions from its fetched flags."""
        match_frac, new_kf, fail, try_reloc, n_fused = flags[:5]
        frame.T_WC_host = flags[5:8]
        self.last_T_WC_host = frame.T_WC_host
        if try_reloc > 0:
            if fail > 0:
                self.fails += 1
                print(f"Cholesky failed {frame.frame_id}")
            else:
                print(f"Skipped frame {frame.frame_id}")
            return False, True
        self._host_N = int(round(float(n_fused)))
        kfr.N = self._host_N
        if new_kf > 0:
            self.reset_idx_f2k()
            self._kf_state = None
        return bool(new_kf > 0), False
