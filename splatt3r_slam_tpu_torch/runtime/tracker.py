"""Modular frontend tracking (FrameTracker).

Counterpart of `splatt3r_slam_tpu/runtime/tracker.py`: per frame, an
asymmetric decode + match against the last keyframe, pointmap fusion in
any of the six filtering modes, the Sim(3) GN pose solve, the keyframe
decision by match fraction, and the RELOC trigger on low overlap or a
failed solve. The fused tracker (`runtime/fused.py`) covers the default
`weighted_pointmap` mode in one step; this one runs the other modes and
`fused=False`.
"""

from __future__ import annotations

import torch

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.geometry.projective import (
    constrain_points_to_ray,
    get_pixel_coords,
)
from splatt3r_slam_tpu_torch.lie import sim3
from splatt3r_slam_tpu_torch.runtime.frame import Frame, KeyframeBuffer
from splatt3r_slam_tpu_torch.runtime.fused import unique_match_count
from splatt3r_slam_tpu_torch.tracking.tracker import (
    TrackingConfig,
    opt_pose_calib_sim3,
    opt_pose_ray_dist_sim3,
)


def _track_masks(idx_f2k, valid_match_k, Qff, Qkf, Cf_all, Ck, C_conf,
                 Q_conf):
    """Qk, the optimisation and keyframe masks, the match fraction, the
    keyframe match fraction and the unique fraction. idx_f2k (n,);
    valid_match_k, Qff, Qkf, Cf_all, Ck (n, 1).

    The unique count is exact (`torch.unique(idx[valid])` semantics); the
    JAX package's scatter counts one too many or too few when pixel 0 is
    hit by invalid rows only, or by valid rows only (ROADMAP Queue 3)."""
    Qk = torch.sqrt(Qff[idx_f2k] * Qkf)
    Cf = Cf_all[idx_f2k]
    valid_Q = Qk > Q_conf
    valid_opt = valid_match_k & (Cf > C_conf) & (Ck > C_conf) & valid_Q
    valid_kf = valid_match_k & valid_Q
    n = idx_f2k.shape[0]
    match_frac = valid_opt.sum() / n
    match_frac_k = valid_kf.sum() / n
    unique_frac = unique_match_count(idx_f2k, valid_match_k[:, 0], n) / n
    return Qk, valid_opt, valid_kf, match_frac, match_frac_k, unique_frac


class FrameTracker:
    def __init__(self, engine, keyframes: KeyframeBuffer):
        self.cfg = config["tracking"]
        self.tcfg = TrackingConfig.from_config(config)
        self.engine = engine
        self.keyframes = keyframes
        self.reset_idx_f2k()
        self.filtering_mode = self.cfg["filtering_mode"]
        self.filtering_score = self.cfg["filtering_score"]
        self.fails = 0  # frames whose pose solve failed

    def reset_idx_f2k(self):
        self.idx_f2k = None

    @torch.no_grad()
    def track(self, frame: Frame):
        """Returns (new_kf: bool, try_reloc: bool)."""
        keyframe = self.keyframes.last_keyframe()
        (idx_f2k_b, valid_match_k_b, Xff, Cff, Qff, Xkf, Ckf, Qkf
         ) = self.engine.match_asymmetric(frame, keyframe, self.idx_f2k)
        self.idx_f2k = idx_f2k_b
        idx_f2k = idx_f2k_b[0]
        valid_match_k = valid_match_k_b[0]

        frame.update_pointmap(Xff, Cff, self.filtering_mode,
                              self.filtering_score)

        use_calib = config["use_calib"]
        img_size = tuple(int(v) for v in frame.img_shape.reshape(-1)[:2])
        K = keyframe.K.to(Xff.device) if use_calib else None
        Xf, Xk = frame.X_canon, keyframe.X_canon
        Cf_all = frame.get_average_conf()
        Ck = keyframe.get_average_conf()

        meas_k = valid_meas_k = None
        if use_calib:
            Xf = constrain_points_to_ray(img_size, Xf[None], K)[0]
            Xk = constrain_points_to_ray(img_size, Xk[None], K)[0]
            uv_k = get_pixel_coords(1, img_size,
                                    device=Xk.device).reshape(-1, 2)
            z = Xk[..., 2:3]
            valid_meas_k = z > self.cfg["depth_eps"]
            logz = torch.where(valid_meas_k,
                               torch.log(torch.clamp(z, min=1e-12)),
                               torch.zeros_like(z))
            meas_k = torch.where(valid_meas_k, torch.cat([uv_k, logz], -1),
                                 torch.zeros_like(Xk))

        (Qk, valid_opt, valid_kf, match_frac, match_frac_k, unique_frac
         ) = _track_masks(idx_f2k, valid_match_k, Qff, Qkf, Cf_all, Ck,
                          float(self.cfg["C_conf"]),
                          float(self.cfg["Q_conf"]))

        if float(match_frac) < self.cfg["min_match_frac"]:
            print(f"Skipped frame {frame.frame_id}")
            return False, True

        Xf_m = Xf[idx_f2k]
        if not use_calib:
            T_WCf, T_CkCf, fail = opt_pose_ray_dist_sim3(
                Xf_m, Xk, frame.T_WC, keyframe.T_WC, Qk, valid_opt,
                self.tcfg)
        else:
            T_WCf, T_CkCf, fail = opt_pose_calib_sim3(
                Xf_m, Xk, frame.T_WC, keyframe.T_WC, Qk, valid_opt, meas_k,
                valid_meas_k, K, img_size, self.tcfg)
        if bool(fail):
            self.fails += 1
            print(f"Cholesky failed {frame.frame_id}")
            return False, True

        frame.T_WC = T_WCf
        # fold the frame's cross prediction of the keyframe back into the
        # keyframe's canonical pointmap
        keyframe.update_pointmap(sim3.act(T_CkCf, Xkf), Ckf,
                                 self.filtering_mode, self.filtering_score)
        self.keyframes[len(self.keyframes) - 1] = keyframe

        new_kf = min(float(match_frac_k), float(unique_frac)) < self.cfg[
            "match_frac_thresh"]
        if new_kf:
            self.reset_idx_f2k()
        return new_kf, False
