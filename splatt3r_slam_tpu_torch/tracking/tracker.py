"""Frontend Sim(3) Gauss-Newton pose tracking.

Counterpart of `splatt3r_slam_tpu/tracking/tracker.py`: per-frame alignment
of the current frame's matched points against the last keyframe, on the
relative pose T_CkCf, with Huber-whitened residuals and a 7x7 Cholesky
solve per iteration. The JAX `lax.while_loop` becomes a Python loop that
pulls one (converged, bad) pair per iteration; the loop stops on
convergence, on a failed solve, or at `max_iters`. A failed Cholesky
(`cholesky_ex` info ≠ 0, or a non-finite step) zeroes the step and sets
`fail`, which the runtime maps to relocalization.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splatt3r_slam_tpu_torch.geometry.projective import (
    point_to_ray_dist,
    project_calib,
)
from splatt3r_slam_tpu_torch.geometry.robust import huber
from splatt3r_slam_tpu_torch.lie import sim3


class TrackingConfig(NamedTuple):
    """Static tracking parameters (config/base.yaml `tracking:`)."""

    min_match_frac: float = 0.05
    max_iters: int = 50
    C_conf: float = 0.0
    Q_conf: float = 1.5
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    huber: float = 1.345
    match_frac_thresh: float = 0.333
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    sigma_point: float = 0.05
    pixel_border: float = -10.0
    depth_eps: float = 1e-6
    filtering_mode: str = "weighted_pointmap"
    filtering_score: str = "median"

    @classmethod
    def from_config(cls, cfg: dict) -> "TrackingConfig":
        t = cfg["tracking"]
        return cls(**{k: t[k] for k in cls._fields if k in t})


def _solve_7x7(sqrt_info, r, J, k_huber: float):
    """Whiten → Huber → normal equations → Cholesky.

    sqrt_info, r: (n, d); J: (n, d, 7). Returns (tau (7,), cost, bad)."""
    whitened_r = sqrt_info * r
    robust = sqrt_info * torch.sqrt(huber(whitened_r, k=k_huber))
    A = (robust[..., None] * J).reshape(-1, 7)
    b = robust * r
    H = A.T @ A
    g = -(A.T @ b.reshape(-1))
    cost = 0.5 * (b * b).sum()
    L, info = torch.linalg.cholesky_ex(H)
    tau = torch.cholesky_solve(g[:, None], L)[:, 0]
    bad = (info != 0) | ~torch.isfinite(tau).all()
    return tau, cost, bad


def _gn_loop(residual_fn, T_init, cfg: TrackingConfig):
    """GN loop: stops on convergence, failure or max_iters.

    residual_fn(T) -> (sqrt_info (n,d), r (n,d), J (n,d,7)).
    Returns (T, fail) with fail a bool tensor on T's device."""
    T = T_init
    old_cost = torch.tensor(float("inf"), device=T.device)
    fail = torch.zeros((), dtype=torch.bool, device=T.device)
    for _ in range(cfg.max_iters):
        sqrt_info, r, J = residual_fn(T)
        tau, new_cost, bad = _solve_7x7(sqrt_info, r, J, cfg.huber)
        tau = torch.where(bad, torch.zeros_like(tau), tau)
        T = sim3.retr(T, tau)
        rel_dec = ((old_cost - new_cost) / old_cost).abs()
        converged = (rel_dec < cfg.rel_error) | (
            torch.linalg.norm(tau) < cfg.delta_norm)
        fail = fail | bad
        old_cost = new_cost
        if bool((converged | fail).item()):
            break
    return T, fail


def opt_pose_ray_dist_sim3(Xf, Xk, T_WCf, T_WCk, Qk, valid,
                           cfg: TrackingConfig):
    """Uncalibrated ray+log-dist tracking. Xf, Xk (n, 3) matched points;
    Qk (n, 1) match confidence; valid (n, 1) bool.

    Returns (T_WCf', T_CkCf, fail)."""
    Xf, Xk, T_WCf, T_WCk, Qk = (a.float() for a in (Xf, Xk, T_WCf, T_WCk,
                                                    Qk))
    w = valid.float() * torch.sqrt(Qk)
    sqrt_info = torch.cat([(w / cfg.sigma_ray).expand(-1, 3),
                           w / cfg.sigma_dist], dim=-1)  # (n, 4)
    T_CkCf0 = sim3.rel(T_WCk, T_WCf)
    rd_k = point_to_ray_dist(Xk)

    def residual(T_CkCf):
        # closed-form ∂(ray, dist)/∂ξ rows: dr/dω = −[r]ₓ, dr/dσ = 0,
        # dd/dτ = rᵀ, dd/dσ = d
        P = sim3.act(T_CkCf, Xf)
        d2 = (P * P).sum(-1, keepdim=True)
        d = torch.sqrt(d2)
        dinv = 1.0 / d
        rh = P * dinv
        r = rd_k - torch.cat([rh, d], dim=-1)
        n3i = dinv / d2
        px, py, pz = P[:, 0:1], P[:, 1:2], P[:, 2:3]
        rx, ry, rz = rh[:, 0:1], rh[:, 1:2], rh[:, 2:3]
        z = torch.zeros_like(rx)
        dxx = dinv - px * px * n3i
        dyy = dinv - py * py * n3i
        dzz = dinv - pz * pz * n3i
        dxy = -px * py * n3i
        dxz = -px * pz * n3i
        dyz = -py * pz * n3i
        row_x = torch.cat([dxx, dxy, dxz, z, rz, -ry, z], dim=-1)
        row_y = torch.cat([dxy, dyy, dyz, -rz, z, rx, z], dim=-1)
        row_z = torch.cat([dxz, dyz, dzz, ry, -rx, z, z], dim=-1)
        row_d = torch.cat([rx, ry, rz, z, z, z, d], dim=-1)
        J = -torch.stack([row_x, row_y, row_z, row_d], dim=1)  # (n, 4, 7)
        return sqrt_info, r, J

    T_CkCf, fail = _gn_loop(residual, T_CkCf0, cfg)
    return sim3.multiply(T_WCk, T_CkCf), T_CkCf, fail


def opt_pose_calib_sim3(Xf, Xk, T_WCf, T_WCk, Qk, valid, meas_k,
                        valid_meas_k, K, img_size, cfg: TrackingConfig):
    """Calibrated pixel+log-depth tracking; meas_k (n, 3) [u, v, log z]."""
    Xf, Xk, T_WCf, T_WCk, Qk, meas_k, K = (
        a.float() for a in (Xf, Xk, T_WCf, T_WCk, Qk, meas_k, K))
    w = valid.float() * torch.sqrt(Qk)
    sqrt_info = torch.cat([(w / cfg.sigma_pixel).expand(-1, 2),
                           w / cfg.sigma_depth], dim=-1)  # (n, 3)
    T_CkCf0 = sim3.rel(T_WCk, T_WCf)

    def residual(T_CkCf):
        Xf_Ck = sim3.act(T_CkCf, Xf)
        dX_dT = sim3.act_jacobian(Xf_Ck)
        pz, dpz_dX, valid_proj = project_calib(
            Xf_Ck, K, img_size, jacobian=True, border=cfg.pixel_border,
            z_eps=cfg.depth_eps)
        valid2 = (valid_proj & valid_meas_k).float()
        r = meas_k - pz
        J = -torch.einsum("nij,njk->nik", dpz_dX, dX_dT)
        return valid2 * sqrt_info, r, J

    T_CkCf, fail = _gn_loop(residual, T_CkCf0, cfg)
    return sim3.multiply(T_WCk, T_CkCf), T_CkCf, fail
