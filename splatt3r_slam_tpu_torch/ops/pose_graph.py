"""Batched Sim(3) pose-graph Gauss-Newton (the backend's solve).

Counterpart of `splatt3r_slam_tpu/ops/pose_graph.py`: ray + log-dist,
calibrated pixel + log-depth and 3D point edge rows, per-edge 14×14
systems scattered into a dense (7m', 7m') system with the first `num_fix`
poses pinned, and a Jacobi-preconditioned dense Cholesky solve, iterated
until ‖dx‖ < `delta_thresh` or `max_iter`.

How it differs from the JAX module, for the same numbers:
- No padding. The JAX package pads edges and poses to bucket sizes (and
  stages tuples into its jit) only to bound XLA recompiles; padded edges
  and poses are inert there, so this module solves on the real sizes.
- The while loop on ‖dx‖ pulls ‖dx‖ (and the Cholesky status) to the host
  once per iteration and stops there, instead of running `max_iter`
  masked iterations.
- A failed Cholesky: `torch.linalg.cholesky_ex` reports it and dx is set
  to 0, as the JAX package's NaN factor turns into dx = 0.
- Edges run in chunks of `_CHUNK` (the JAX `lax.map(batch_size=8)`).
- True fp32 without relying on a global TF32 flag: the small per-row
  contractions and the 7×7 normal equations are elementwise products and
  sums, never a matmul. Since ∂r/∂ξ_i = −∂r/∂ξ_j exactly, the 14×14 edge
  system is [[A, −A], [−A, A]] and g = [−b, b] with A, b from ∂r/∂ξ_j
  alone, which halves the work and changes no product.
"""

from __future__ import annotations

import torch

from splatt3r_slam_tpu_torch.geometry.projective import (
    constrain_points_to_ray,
    point_to_ray_dist,
    project_calib,
)
from splatt3r_slam_tpu_torch.geometry.robust import huber
from splatt3r_slam_tpu_torch.lie import sim3

# edges whose rows are built at once: at the eval profile one edge's
# Jacobians are 196,608 × 4 × 7 fp32 (22 MB), so 8 keep a chunk near 0.5 GB
_CHUNK = 8


def _mat(a, b):
    """(..., r, k) @ (..., k, l) as k elementwise products, in fp32."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k, None] * b[..., None, k, :]
    return out


def _ok(valid, Q, Ci, Cj, C_thresh, Q_thresh):
    q = Q[..., None]
    return valid[..., None] & (q > Q_thresh) & (Ci > C_thresh) & (
        Cj > C_thresh), q


def _jac_j(T_ij, T_i, dr_dX, Xj_Ci):
    """∂r/∂ξ_j = (∂r/∂X · ∂X/∂ξ_ij) · Adj(T_i)⁻¹, (B, N, r, 7)."""
    Jij = _mat(dr_dX, sim3.act_jacobian(Xj_Ci))
    return sim3.adj_inv_apply_row(T_i[:, None, None], Jij)


def _edge_rays(T_ij, T_i, Xi, Xj, Ci, Cj, Q, valid, sigma_ray, sigma_dist,
               C_thresh, Q_thresh):
    """Ray + dist rows of B edges. Xi (B, N, 3) points of kf i gathered by
    the match, Xj (B, N, 3); Ci, Cj (B, N, 1); Q (B, N); valid (B, N).
    Returns (Jj (B, N, 4, 7), w (B, N, 4), err (B, N, 4)); Ji = −Jj."""
    rd_i = point_to_ray_dist(Xi)
    Xj_Ci = sim3.act(T_ij[:, None], Xj)
    rd_j, drd_dX = point_to_ray_dist(Xj_Ci, jacobian=True)
    err = rd_j - rd_i
    ok, q = _ok(valid, Q, Ci, Cj, C_thresh, Q_thresh)
    sq = torch.sqrt(q)
    sqrt_w = torch.cat([(sq / sigma_ray).expand(-1, -1, 3),
                        sq / sigma_dist], dim=-1) * ok
    w = huber(sqrt_w * err) * sqrt_w * sqrt_w
    return _jac_j(T_ij, T_i, drd_dX, Xj_Ci), w, err


def _edge_calib(T_ij, T_i, Xi, Xj, Ci, Cj, Q, valid, K, img_size,
                pixel_border, z_eps, sigma_pixel, sigma_depth, C_thresh,
                Q_thresh):
    """Pixel + log-depth rows of B edges (3 a pixel)."""
    meas, valid_meas = project_calib(Xi, K, img_size, border=pixel_border,
                                     z_eps=z_eps)
    Xj_Ci = sim3.act(T_ij[:, None], Xj)
    pz, dpz_dX, valid_proj = project_calib(
        Xj_Ci, K, img_size, jacobian=True, border=pixel_border, z_eps=z_eps)
    err = pz - meas
    ok, q = _ok(valid, Q, Ci, Cj, C_thresh, Q_thresh)
    ok = ok & valid_meas & valid_proj
    sq = torch.sqrt(q)
    sqrt_w = torch.cat([(sq / sigma_pixel).expand(-1, -1, 2),
                        sq / sigma_depth], dim=-1) * ok
    w = huber(sqrt_w * err) * sqrt_w * sqrt_w
    return _jac_j(T_ij, T_i, dpz_dX, Xj_Ci), w, err


def _edge_points(T_ij, T_i, Xi, Xj, Ci, Cj, Q, valid, sigma_point,
                 C_thresh, Q_thresh):
    """3D point-alignment rows of B edges (3 a pixel)."""
    Xj_Ci = sim3.act(T_ij[:, None], Xj)
    err = Xj_Ci - Xi
    ok, q = _ok(valid, Q, Ci, Cj, C_thresh, Q_thresh)
    sqrt_w = ((torch.sqrt(q) / sigma_point) * ok).expand(-1, -1, 3)
    w = huber(sqrt_w * err) * sqrt_w * sqrt_w
    Jj = sim3.adj_inv_apply_row(T_i[:, None, None],
                                sim3.act_jacobian(Xj_Ci))
    return Jj, w, err


def _edge_system(Jj, w, err):
    """(H (B, 14, 14), g (B, 14)) of B edges from ∂r/∂ξ_j, weights and
    residuals, with J2 = [−Jj | Jj]: H = J2ᵀ W J2, g = J2ᵀ W err."""
    Jw = Jj * w[..., None]
    A = torch.stack([(Jw * Jj[..., i, None]).sum((1, 2)) for i in range(7)],
                    dim=1)  # (B, 7, 7)
    b = (Jw * err[..., None]).sum((1, 2))  # (B, 7)
    H = torch.cat([torch.cat([A, -A], -1), torch.cat([-A, A], -1)], -2)
    return H, torch.cat([-b, b], -1)


def _assemble_dense(H_e, g_e, ii, jj, m, num_fix):
    """Scatter per-edge 14×14 blocks into the dense (7m', 7m') system,
    m' = m − num_fix. Blocks touching pinned poses are dropped; poses no
    edge touches get an identity diagonal so the factor stays SPD."""
    H_e, g_e = H_e.float(), g_e.float()
    blocks = torch.cat([H_e[:, :7, :7], H_e[:, :7, 7:], H_e[:, 7:, :7],
                        H_e[:, 7:, 7:]])
    r = torch.cat([ii, ii, jj, jj]) - num_fix
    c = torch.cat([ii, jj, ii, jj]) - num_fix
    mp = m - num_fix
    keep = (r >= 0) & (c >= 0)
    r = torch.where(keep, r, mp)  # row/column mp collects pinned blocks
    c = torch.where(keep, c, mp)
    Hd = torch.zeros(((mp + 1) * (mp + 1), 7, 7), dtype=torch.float32,
                     device=H_e.device)
    Hd.index_add_(0, r * (mp + 1) + c, blocks)
    Hd = Hd.view(mp + 1, mp + 1, 7, 7)[:mp, :mp]
    gr = torch.cat([ii, jj]) - num_fix
    gr = torch.where(gr >= 0, gr, mp)
    gd = torch.zeros((mp + 1, 7), dtype=torch.float32, device=H_e.device)
    gd.index_add_(0, gr, torch.cat([g_e[:, :7], g_e[:, 7:]]))
    H = Hd.permute(0, 2, 1, 3).reshape(mp * 7, mp * 7)
    diag = torch.diagonal(H)
    H = H + torch.diag((diag == 0).float())
    return H, gd[:mp].reshape(mp * 7)


def _solve_spd(H, g):
    """Jacobi-preconditioned dense Cholesky solve → (x, info): info != 0
    where the preconditioned matrix is not positive definite."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    dinv = 1.0 / d
    Hs = H * dinv[:, None] * dinv[None, :]
    L, info = torch.linalg.cholesky_ex(Hs)
    x = torch.cholesky_solve((g * dinv)[:, None], L)[:, 0]
    return x * dinv, info


def _gn_iterations(edge_fn, Twc, ii, jj, num_fix, max_iter, delta_thresh,
                   stats=None):
    """GN driver: stop after `max_iter` or once ‖dx‖ < delta_thresh (one
    host pull of ‖dx‖ and the Cholesky status per iteration).
    edge_fn(Twc) → (H_e (E, 14, 14), g_e (E, 14))."""
    m = Twc.shape[0]
    for _ in range(max_iter):
        H_e, g_e = edge_fn(Twc)
        H, g = _assemble_dense(H_e, g_e, ii, jj, m, num_fix)
        x, info = _solve_spd(H, g)
        dx = -x
        dx = torch.where(torch.isfinite(dx) & (info == 0), dx,
                         torch.zeros_like(dx))
        dxp = torch.cat([torch.zeros((num_fix, 7), dtype=torch.float32,
                                     device=dx.device), dx.view(-1, 7)])
        Twc = sim3.retr(Twc, dxp)
        norm, failed = torch.stack([torch.linalg.norm(dx),
                                    (info != 0).float()]).tolist()
        if stats is not None:
            stats["iters"] = stats.get("iters", 0) + 1
            stats["chol_fail"] = stats.get("chol_fail", 0) + int(failed)
        if not norm >= delta_thresh:
            break
    return Twc


def _gather_edge_points(Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                        pix_stride: int = 1):
    """Per-edge gathered tensors Xi (E, Ns, 3), Xj, Ci, Cj; pix_stride > 1
    keeps every pix_stride-th residual row of each edge."""
    s = pix_stride
    idx_s = idx_ii2jj[:, ::s].long()
    ind = torch.where(valid_match[:, ::s], idx_s, torch.zeros_like(idx_s))
    ii_c = ii.long()[:, None]
    return Xs[ii_c, ind], Xs[jj.long(), ::s], Cs[ii_c, ind], Cs[jj.long(), ::s]


def _edge_loop(row_fn, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
               num_fix, max_iter, delta_thresh, pix_stride, stats):
    """The shared solve: gather once (the gathers do not depend on the
    poses), then GN with the edge systems built `_CHUNK` edges at a time."""
    Twc = Twc.float()
    ii, jj = ii.long(), jj.long()
    Xi, Xj, Ci, Cj = _gather_edge_points(Xs, Cs, ii, jj, idx_ii2jj,
                                         valid_match, pix_stride)
    Q_s = Q[:, ::pix_stride].float()
    v_s = valid_match[:, ::pix_stride]
    E = ii.shape[0]

    def edge_fn(T):
        T_i = T[ii]
        T_ij = sim3.rel(T_i, T[jj])
        Hs, gs = [], []
        for a in range(0, E, _CHUNK):
            sl = slice(a, a + _CHUNK)
            H, g = _edge_system(*row_fn(T_ij[sl], T_i[sl], Xi[sl], Xj[sl],
                                        Ci[sl], Cj[sl], Q_s[sl], v_s[sl]))
            Hs.append(H)
            gs.append(g)
        return torch.cat(Hs), torch.cat(gs)

    return _gn_iterations(edge_fn, Twc, ii, jj, num_fix, max_iter,
                          delta_thresh, stats)


@torch.no_grad()
def gauss_newton_rays(Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                      num_fix: int = 1, max_iter: int = 10,
                      sigma_ray: float = 0.003, sigma_dist: float = 10.0,
                      C_thresh: float = 0.0, Q_thresh: float = 1.5,
                      delta_thresh: float = 1e-8, pix_stride: int = 1,
                      stats: dict | None = None):
    """Ray + dist pose-graph GN. Twc (m, 8); Xs (m, N, 3); Cs (m, N, 1);
    ii, jj (E,) keyframe ranks; idx_ii2jj (E, N) match indices into kf i's
    pixels; valid_match (E, N) bool; Q (E, N) match confidence. Returns the
    solved (m, 8) poses; `stats` (optional dict) counts iterations and
    Cholesky failures."""
    def rows(*a):
        return _edge_rays(*a, sigma_ray, sigma_dist, C_thresh, Q_thresh)

    return _edge_loop(rows, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                      num_fix, max_iter, delta_thresh, pix_stride, stats)


@torch.no_grad()
def gauss_newton_calib(Twc, Xs, Cs, K, ii, jj, idx_ii2jj, valid_match, Q,
                       img_size, num_fix: int = 1, max_iter: int = 10,
                       pixel_border: float = -10.0, z_eps: float = 1e-6,
                       sigma_pixel: float = 1.0, sigma_depth: float = 10.0,
                       C_thresh: float = 0.0, Q_thresh: float = 1.5,
                       delta_thresh: float = 1e-8, pix_stride: int = 1,
                       stats: dict | None = None):
    """Calibrated pixel + log-depth pose-graph GN; img_size is (H, W)."""
    K = K.float()

    def rows(*a):
        return _edge_calib(*a, K, img_size, pixel_border, z_eps, sigma_pixel,
                           sigma_depth, C_thresh, Q_thresh)

    return _edge_loop(rows, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                      num_fix, max_iter, delta_thresh, pix_stride, stats)


@torch.no_grad()
def gauss_newton_points(Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                        num_fix: int = 1, max_iter: int = 10,
                        sigma_point: float = 0.05, C_thresh: float = 0.0,
                        Q_thresh: float = 1.5, delta_thresh: float = 1e-8,
                        pix_stride: int = 1, stats: dict | None = None):
    """3D point-alignment pose-graph GN."""
    def rows(*a):
        return _edge_points(*a, sigma_point, C_thresh, Q_thresh)

    return _edge_loop(rows, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                      num_fix, max_iter, delta_thresh, pix_stride, stats)


def _subgrid(Xs, sub_stride: int, sub_hw):
    """(m, N, c) per-keyframe rows → (m, N/s², c) rows of the (h/s, w/s)
    subgrid that stride-s edge matching indexes."""
    if sub_stride <= 1:
        return Xs
    h, w = sub_hw
    m, _, c = Xs.shape
    return Xs.reshape(m, h, w, c)[:, ::sub_stride, ::sub_stride].reshape(
        m, -1, c)


def stack_keyframes(X_list, C_list, Ns, sub_stride: int = 1, sub_hw=None,
                    K=None, img_size=None):
    """The staged entry points' keyframe inputs: stacked pointmaps (ray-
    constrained at full resolution when K is given) and confidences over
    each keyframe's fusion count, both on the matching subgrid."""
    Xs = torch.stack(X_list).float()
    if K is not None:
        Xs = constrain_points_to_ray(img_size, Xs, K.float())
    Cs = torch.stack(C_list).float() / torch.as_tensor(
        Ns, dtype=torch.float32, device=Xs.device)[:, None, None]
    return (_subgrid(Xs, sub_stride, sub_hw),
            _subgrid(Cs, sub_stride, sub_hw))
