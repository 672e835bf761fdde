"""Plain PyTorch Sim(3) solves of the SLAM loop, in float64: the tracking
step's pose, its keyframe-pointmap fusion and the backend's pose graph.

They follow the program step by step from its state: the keyframe's
canonical pointmap, confidence and pose and the frame's starting pose
before a tracking step; the keyframes' poses and pointmaps before a
backend solve. Each of those is the output of an earlier stage that is
checked by itself (a fusion, a tracking step, a solve). What the oracle
derives from the true poses (each frame's pointmap, the matches and their
validity, the confidences of 10) is worked out here again from the true
poses (`geometry.Scene`).

The algorithm is MASt3R-SLAM's: tracking minimises Huber-weighted ray and
distance residuals of the frame's matched points moved into the keyframe
(sigmas `sigma_ray`, `sigma_dist`) by Gauss-Newton on a left Sim(3)
perturbation, stopping when the cost falls by less than `rel_error` or the
step is below `delta_norm`; the backend stacks ray-and-distance rows of
both directions of every edge (every `gn_stride`-th row), pins the first
`pin` keyframes and iterates a Jacobi-preconditioned Cholesky solve
`max_iters` times or until the step is below `delta_norm`.

`Arith` is the arithmetic: rows in float64 and sums in float64 for the
reference; rows in bfloat16 and sums in float32 for the control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Arith(NamedTuple):
    rows: torch.dtype = torch.float64
    sums: torch.dtype = torch.float64


REFERENCE = Arith()
CONTROL = Arith(torch.bfloat16, torch.float32)


# -- Sim(3) on [t(3), q xyzw(4), s] ------------------------------------------
def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def qmul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def qrot(q, x):
    qv, qw = q[..., :3], q[..., 3:4]
    qv, x = torch.broadcast_tensors(qv, x)
    uv = 2.0 * _cross(qv, x)
    return x + qw * uv + _cross(qv, uv)


def act(T, x):
    return T[..., 7:8] * qrot(T[..., 3:7], x) + T[..., :3]


def inverse(T):
    q = torch.cat([-T[..., 3:6], T[..., 6:7]], -1)
    s = 1.0 / T[..., 7:8]
    return torch.cat([-s * qrot(q, T[..., :3]), q, s], -1)


def compose(A, B):
    t = A[..., 7:8] * qrot(A[..., 3:7], B[..., :3]) + A[..., :3]
    q = qmul(*torch.broadcast_tensors(A[..., 3:7], B[..., 3:7]))
    s = A[..., 7:8] * B[..., 7:8]
    t, s = t.expand(q.shape[:-1] + (3,)), s.expand(q.shape[:-1] + (1,))
    return torch.cat([t, q, s], -1)


def exp(xi):
    """Sim(3) exponential of [tau, phi, sigma] (Eade's closed form)."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    th2 = (phi * phi).sum(-1, keepdim=True)
    th = torch.sqrt(th2)
    small_t = th < 1e-6
    th_s = torch.where(small_t, torch.ones_like(th), th)
    half = 0.5 * th_s
    imag = torch.where(small_t, 0.5 - th2 / 48.0, torch.sin(half) / th_s)
    real = torch.where(small_t, 1.0 - th2 / 8.0, torch.cos(half))
    q = torch.cat([imag * phi, real], -1)
    s = torch.exp(sigma)
    small_s = sigma.abs() < 1e-6
    sg = torch.where(small_s, torch.ones_like(sigma), sigma)
    th2_s = torch.where(small_t, torch.ones_like(th2), th2)
    C = torch.where(small_s, torch.ones_like(sigma), (s - 1.0) / sg)
    # A, B of W = C I + A Φ + B Φ²
    A_ss = torch.where(small_t, torch.full_like(th, 0.5),
                       (1.0 - torch.cos(th_s)) / th2_s)
    B_ss = torch.where(small_t, torch.full_like(th, 1.0 / 6.0),
                       (th_s - torch.sin(th_s)) / (th2_s * th_s))
    A_sl_t = ((sg - 1.0) * s + 1.0) / (sg * sg)
    B_sl_t = (s * 0.5 * sg * sg + s - 1.0 - sg * s) / (sg * sg * sg)
    a_, b_ = s * torch.sin(th_s), s * torch.cos(th_s)
    c_ = th2_s + sg * sg
    A_sl = (a_ * sg + (1.0 - b_) * th_s) / (th_s * c_)
    B_sl = (C - ((b_ - 1.0) * sg + a_ * th_s) / c_) / th2_s
    A = torch.where(small_s, A_ss, torch.where(small_t, A_sl_t, A_sl))
    B = torch.where(small_s, B_ss, torch.where(small_t, B_sl_t, B_sl))
    px = _cross(phi, tau)
    t = C * tau + A * px + B * _cross(phi, px)
    return torch.cat([t, q, s], -1)


def retract(T, xi):
    """exp(xi) ∘ T (left perturbation)."""
    return compose(exp(xi), T)


def _skew(x):
    x0, x1, x2 = x.unbind(-1)
    o = torch.zeros_like(x0)
    return torch.stack([o, -x2, x1, x2, o, -x0, -x1, x0, o],
                       -1).reshape(x.shape[:-1] + (3, 3))


def act_jacobian(p):
    """∂(exp(ξ)·p)/∂ξ at ξ = 0: [I | −[p]ₓ | p], (..., 3, 7)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1] + (3, 3))
    return torch.cat([eye, -_skew(p), p[..., None]], -1)


def adj_inv_rows(T, J):
    """Rows J (..., 7) times Adj(T)⁻¹."""
    t, q, s = T[..., :3], T[..., 3:7], T[..., 7:8]
    a, b, c = J[..., :3], J[..., 3:6], J[..., 6:7]
    Ra = qrot(q, a)
    y1 = qrot(q, b) + _cross(t.expand(Ra.shape), Ra) / s
    return torch.cat([Ra / s, y1, c + (t * Ra).sum(-1, keepdim=True) / s],
                     -1)


def ray_dist(X, jacobian=False):
    d = torch.linalg.norm(X, dim=-1, keepdim=True)
    r = X / d
    rd = torch.cat([r, d], -1)
    if not jacobian:
        return rd
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        X.shape[:-1] + (3, 3))
    drdX = (eye - r[..., :, None] * r[..., None, :]) / d[..., None]
    return rd, torch.cat([drdX, r[..., None, :]], -2)


def huber(r, k):
    a = r.abs()
    return torch.where(a < k, torch.ones_like(a),
                       k / torch.where(a < k, torch.ones_like(a), a))


# -- the tracking step ------------------------------------------------------
def track(Xf, Xk, T_WCf, T_WCk, Qk, valid, tcfg: dict,
          ar: Arith = REFERENCE):
    """The frame's pose from matched points Xf (frame) and Xk (keyframe)
    → (T_WCf, T_CkCf, failed)."""
    rd = ar.rows
    Xf, Xk, Qk = Xf.to(rd), Xk.to(rd), Qk.to(rd)
    w = valid.to(rd) * torch.sqrt(Qk)
    sq = torch.cat([(w / float(tcfg["sigma_ray"])).expand(-1, 3),
                    w / float(tcfg["sigma_dist"])], -1)
    T_WCk = T_WCk.to(ar.sums)
    T = compose(inverse(T_WCk), T_WCf.to(ar.sums))
    rd_k = ray_dist(Xk)
    old = torch.tensor(float("inf"), dtype=ar.sums, device=Xf.device)
    failed = False
    for _ in range(int(tcfg["max_iters"])):
        P = act(T.to(rd), Xf)
        rdp, dP = ray_dist(P, jacobian=True)
        r = rd_k - rdp
        J = -(dP @ act_jacobian(P))  # (n, 4, 7)
        wr = sq * torch.sqrt(huber(sq * r, float(tcfg["huber"])))
        A = (wr[..., None] * J).reshape(-1, 7).to(ar.sums)
        b = (wr * r).reshape(-1).to(ar.sums)
        H, g = A.T @ A, -(A.T @ b)
        cost = 0.5 * (b * b).sum()
        L, info = torch.linalg.cholesky_ex(H)
        tau = torch.cholesky_solve(g[:, None], L)[:, 0]
        bad = bool(info != 0) or not bool(torch.isfinite(tau).all())
        if bad:
            tau = torch.zeros_like(tau)
        T = retract(T, tau)
        conv = bool(((old - cost) / old).abs() < float(tcfg["rel_error"])) \
            or float(torch.linalg.norm(tau)) < float(tcfg["delta_norm"])
        failed = failed or bad
        old = cost
        if conv or failed:
            break
    return compose(T_WCk, T), T, failed


def fuse(X, C, Xkf, Ckf, T_CkCf, ar: Arith = REFERENCE):
    """The keyframe's canonical pointmap after one fusion: the frame's
    cross prediction moved into the keyframe, confidence-weighted."""
    X, C, Xkf, Ckf = (a.to(ar.rows) for a in (X, C, Xkf, Ckf))
    Xkk = act(T_CkCf.to(ar.rows), Xkf)
    return (C * X + Ckf * Xkk) / (C + Ckf)


# -- the backend's pose graph -----------------------------------------------
def pose_graph(Twc, Xs, Cs, ii, jj, idx, valid, Q, lcfg: dict,
               pix_stride: int, ar: Arith = REFERENCE):
    """Solved (m, 8) keyframe poses. Xs (m, N, 3), Cs (m, N, 1); edges ii,
    jj (E,) with idx (E, N) into keyframe ii's pixels, valid (E, N), Q
    (E, N)."""
    rd, sm = ar.rows, ar.sums
    pin = int(lcfg["pin"])
    s = max(1, int(pix_stride))
    m = Twc.shape[0]
    ii, jj = ii.long(), jj.long()
    sel = torch.where(valid[:, ::s], idx[:, ::s].long(),
                      torch.zeros_like(idx[:, ::s].long()))
    Xi = Xs[ii[:, None], sel].to(rd)
    Xj = Xs[jj, ::s].to(rd)
    Ci, Cj = Cs[ii[:, None], sel].to(rd), Cs[jj, ::s].to(rd)
    q = Q[:, ::s, None].to(rd)
    ok = (valid[:, ::s, None] & (q > float(lcfg["Q_conf"]))
          & (Ci > float(lcfg["C_conf"])) & (Cj > float(lcfg["C_conf"])))
    sq = torch.sqrt(q)
    sqw = torch.cat([(sq / float(lcfg["sigma_ray"])).expand(-1, -1, 3),
                     sq / float(lcfg["sigma_dist"])], -1) * ok
    rd_i = ray_dist(Xi)
    T = Twc.to(sm)
    mp = m - pin
    for _ in range(int(lcfg["max_iters"])):
        Ti = T[ii]
        Tij = compose(inverse(Ti), T[jj]).to(rd)
        P = act(Tij[:, None], Xj)
        rdp, dP = ray_dist(P, jacobian=True)
        err = rdp - rd_i
        w = huber(sqw * err, 1.345) * sqw * sqw
        Jj = adj_inv_rows(Ti.to(rd)[:, None, None], dP @ act_jacobian(P))
        Jw = (Jj * w[..., None]).to(sm)
        Jj, err = Jj.to(sm), err.to(sm)
        A = torch.einsum("enra,enrb->eab", Jw, Jj)  # ∂r/∂ξ_j blocks
        bvec = torch.einsum("enra,enr->ea", Jw, err)
        H = torch.zeros((m, m, 7, 7), dtype=sm, device=Xs.device)
        g = torch.zeros((m, 7), dtype=sm, device=Xs.device)
        for e in range(ii.shape[0]):
            a, c = int(ii[e]), int(jj[e])
            H[a, a] += A[e]
            H[c, c] += A[e]
            H[a, c] -= A[e]
            H[c, a] -= A[e]
            g[a] -= bvec[e]
            g[c] += bvec[e]
        Hm = H[pin:, pin:].permute(0, 2, 1, 3).reshape(7 * mp, 7 * mp)
        gm = g[pin:].reshape(-1)
        diag = torch.diagonal(Hm)
        Hm = Hm + torch.diag((diag == 0).to(sm))
        dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
        L, info = torch.linalg.cholesky_ex(Hm * dinv[:, None] * dinv[None])
        x = torch.cholesky_solve((gm * dinv)[:, None], L)[:, 0] * dinv
        dx = -x
        if bool(info != 0) or not bool(torch.isfinite(dx).all()):
            dx = torch.zeros_like(dx)
        xi = torch.cat([torch.zeros((pin, 7), dtype=sm, device=Xs.device),
                        dx.view(-1, 7)])
        T = retract(T, xi)
        if not float(torch.linalg.norm(dx)) >= float(lcfg["delta_norm"]):
            break
    return T
