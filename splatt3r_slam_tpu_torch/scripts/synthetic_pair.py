"""Sub-pixel synthetic oracle: the real matcher and GN on analytic geometry.

The port's copy of the repository's `tests/synthetic_pair.py` (the port's
package imports nothing of the JAX package). Unlike an oracle that serves
exact integer-pixel correspondences, this synthesizes what the network
would output: per-view pointmaps of a textured plane evaluated at pixel
centres with depth-proportional noise, and descriptors that are smooth
functions of the world point. Then it runs the production matcher
(`ops/matching.py::match`, the call the fused frontend makes) and the
production GN solvers, so that the accuracy cost of `match_stride`,
`gn_stride`, `closed_form_init` and `refine_quantize` can be measured:
the only discretisation left is the matcher's own pixel quantisation.

The scene and views are numpy, equal to the JAX helpers' bit for bit;
`track_pair` and `solve_graph` take the device the matcher and the solvers
run on. The backend solve goes through `ops/pose_graph.py`'s
`stack_keyframes` and `gauss_newton_rays(..., pix_stride=)` (the JAX
helper calls the staged entry point, a jit-staging wrapper of the same
solve).
"""

from __future__ import annotations

import numpy as np
import torch

PLANE_N = np.array([0.2, 0.12, 1.0]) / np.linalg.norm([0.2, 0.12, 1.0])
PLANE_D = 2.0


def se3_to_sim3(T, device="cpu"):
    """4x4 rigid transform → the 8-float [t, q_xyzw, s=1] embedding
    (lietorch layout), float32 on `device`."""
    R = np.asarray(T)[:3, :3]
    t = np.asarray(T)[:3, 3]
    tr = np.trace(R)
    if tr > 0:
        S = np.sqrt(tr + 1.0) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / S, (R[0, 2] - R[2, 0]) / S,
                      (R[1, 0] - R[0, 1]) / S, 0.25 * S])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        S = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[i] = 0.25 * S
        q[j] = (R[j, i] + R[i, j]) / S
        q[k] = (R[k, i] + R[i, k]) / S
        q[3] = (R[k, j] - R[j, k]) / S
    q = q / np.linalg.norm(q)
    return torch.tensor(np.concatenate([t, q, [1.0]]), dtype=torch.float32,
                        device=device)


def make_scene(h, w, focal=None):
    return dict(h=h, w=w, focal=float(focal or w), n=PLANE_N, d=PLANE_D)


def _rays(sc):
    h, w, f = sc["h"], sc["w"], sc["focal"]
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5,
                       indexing="xy")
    r = np.stack([(u - w / 2) / f, (v - h / 2) / f, np.ones_like(u)], -1)
    return r.reshape(-1, 3)


def pointmap_cam(sc, T):
    """Exact per-pixel plane intersection in camera coords, (n, 3)."""
    r = _rays(sc)
    Rw = (T[:3, :3] @ r.T).T
    tstar = (sc["d"] - sc["n"] @ T[:3, 3]) / (Rw @ sc["n"])
    return r * tstar[:, None]


def cam_to_world(T, Xc):
    return (T[:3, :3] @ Xc.T).T + T[:3, 3]


def descriptors(Xw, fdim=24, seed=0):
    """Smooth, discriminative 'network descriptors': random Fourier
    features of the world point, L2-normalised (as the real descriptor
    head's are)."""
    rng = np.random.default_rng(seed)
    Wrf = rng.normal(size=(3, fdim)) * 2.2
    b = rng.uniform(0, 2 * np.pi, size=(fdim,))
    D = np.cos(Xw @ Wrf + b).astype(np.float32)
    return D / np.linalg.norm(D, axis=-1, keepdims=True)


def noisy(X, sigma_rel, rng):
    """Depth-proportional isotropic noise (network error grows with
    range)."""
    return X + sigma_rel * X[:, 2:3] * rng.normal(size=X.shape)


def make_view(sc, T, rng, sigma_x=0.004, sigma_d=0.05, desc_seed=0):
    """One synthetic 'network inference' for the view at ground-truth pose
    T: canonical pointmap (own camera), world-anchored descriptors."""
    Xc = pointmap_cam(sc, T)
    Xw = cam_to_world(T, Xc)
    D = descriptors(Xw, seed=desc_seed)
    D = D + sigma_d * rng.normal(size=D.shape).astype(np.float32)
    D = D / np.linalg.norm(D, axis=-1, keepdims=True)
    return dict(T=T, Xc=noisy(Xc, sigma_x, rng).astype(np.float32),
                D=D.astype(np.float32))


def cross_pointmap(sc, view_kf, T_f, rng, sigma_x=0.004):
    """The decoder's cross prediction: the keyframe's pixels' points
    expressed in the frame's camera."""
    Xc_kf = pointmap_cam(sc, view_kf["T"])
    Xw = cam_to_world(view_kf["T"], Xc_kf)
    Xf = (T_f[:3, :3].T @ (Xw - T_f[:3, 3]).T).T
    return noisy(Xf, sigma_x, rng).astype(np.float32)


def _sub(a, h, w, s):
    if s == 1:
        return a
    return np.ascontiguousarray(a.reshape(h, w, -1)[::s, ::s]).reshape(
        (h // s) * (w // s), -1)


def track_pair(sc, view_f, view_kf, X_cross, tcfg, *, match_stride=1,
               closed_form_init=False, polish_iters=2, max_iter=10,
               refine_quantize=False, dist_thresh=0.1, radius=3,
               dilation_max=5, device="cpu"):
    """The fused frontend's semantics for one tracked pair: subgrid
    matching through the production matcher, then the production ray+dist
    Sim(3) GN → (rotation error in degrees, translation error, GN failed,
    share of valid matches)."""
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.ops import matching
    from splatt3r_slam_tpu_torch.tracking.tracker import (
        opt_pose_ray_dist_sim3,
    )

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    h, w, s = sc["h"], sc["w"], match_stride
    hs, ws = h // s, w // s
    ns = hs * ws

    X11 = _sub(view_f["Xc"], h, w, s).reshape(1, hs, ws, 3)
    X21 = _sub(X_cross, h, w, s).reshape(1, hs, ws, 3)
    D11 = _sub(view_f["D"], h, w, s).reshape(1, hs, ws, -1)
    D21 = _sub(view_kf["D"], h, w, s).reshape(1, hs, ws, -1)

    idx, valid = matching.match(
        t(X11), t(X21), t(D11), t(D21), None,
        max_iter=max_iter, dist_thresh=dist_thresh, radius=radius,
        dilation_max=dilation_max, closed_form_init=closed_form_init,
        polish_iters=polish_iters, refine_quantize=refine_quantize,
    )
    idx = idx[0].cpu().numpy()
    valid = valid[0, :, 0].cpu().numpy()

    Xff_s = _sub(view_f["Xc"], h, w, s)
    Xk_s = _sub(view_kf["Xc"], h, w, s)
    Q = torch.full((ns, 1), 10.0, device=device)
    T_kf = se3_to_sim3(view_kf["T"], device)
    T_WCf, _, fail = opt_pose_ray_dist_sim3(
        t(Xff_s[idx]), t(Xk_s), T_kf, T_kf, Q, t(valid)[:, None], tcfg)
    T_est = sim3.matrix(T_WCf).cpu().numpy()
    T_gt = view_f["T"]
    sc_est = np.cbrt(np.linalg.det(T_est[:3, :3]))
    dR = (T_est[:3, :3] / sc_est).T @ T_gt[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    terr = float(np.linalg.norm(T_est[:3, 3] - T_gt[:3, 3]))
    return ang, terr, bool(fail), float(valid.mean())


def solve_graph(sc, views, rng, *, gn_stride=1, max_iter=10,
                pose_noise=0.01, match_kw=None, device="cpu"):
    """Backend oracle: a consecutive-edge pose graph over `views`, its edges
    from the production matcher in both directions, solved by the
    production GN at `pix_stride=gn_stride` → the Sim(3)-aligned ATE."""
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.ops import matching, pose_graph
    from splatt3r_slam_tpu_torch.runtime.evaluate import umeyama_alignment

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    h, w = sc["h"], sc["w"]
    n = h * w
    m = len(views)
    match_kw = match_kw or {}

    # two-way edges (k, k+1): the matcher in both directions
    ii, jj, idx_t, valid_t = [], [], [], []
    for k in range(m - 1):
        vi, vj = views[k], views[k + 1]
        Xj_in_i = cross_pointmap(sc, vj, vi["T"], rng)
        Xi_in_j = cross_pointmap(sc, vi, vj["T"], rng)
        for (a, b, Xb_in_a, va, vb) in (
            (k, k + 1, Xj_in_i, vi, vj),
            (k + 1, k, Xi_in_j, vj, vi),
        ):
            idx_ab, valid_ab = matching.match(
                t(va["Xc"].reshape(1, h, w, 3)),
                t(Xb_in_a.reshape(1, h, w, 3)),
                t(va["D"].reshape(1, h, w, -1)),
                t(vb["D"].reshape(1, h, w, -1)),
                None, **match_kw,
            )
            # rows are b's pixels, values index into a ⇒ edge (ii=a, jj=b)
            ii.append(a)
            jj.append(b)
            idx_t.append(idx_ab[0])
            valid_t.append(valid_ab[0, :, 0])

    def perturbed(T, r):
        tau = np.zeros(7, np.float32)
        tau[:3] = pose_noise * r.normal(size=3)
        tau[3:6] = pose_noise * r.normal(size=3)
        return sim3.retr(se3_to_sim3(T, device), t(tau))

    r = np.random.default_rng(123)
    Twc = torch.stack([se3_to_sim3(views[0]["T"], device)]
                      + [perturbed(v["T"], r) for v in views[1:]])
    Xs, Cs = pose_graph.stack_keyframes(
        [t(v["Xc"]) for v in views],
        [torch.full((n, 1), 10.0, device=device) for _ in views],
        np.ones((m,), np.float32))
    E = len(ii)
    Twc_new = pose_graph.gauss_newton_rays(
        Twc, Xs, Cs,
        torch.tensor(ii, device=device), torch.tensor(jj, device=device),
        torch.stack(idx_t), torch.stack(valid_t),
        torch.full((E, n), 10.0, device=device),
        num_fix=1, max_iter=max_iter, sigma_ray=0.003, sigma_dist=10.0,
        C_thresh=0.0, Q_thresh=1.5, delta_thresh=1e-8,
        pix_stride=gn_stride,
    )
    est = sim3.matrix(Twc_new)[:, :3, 3].cpu().numpy().astype(np.float64)
    gt = np.stack([v["T"][:3, 3] for v in views])
    s_, R_, t_ = umeyama_alignment(est, gt)
    err = (s_ * (R_ @ est.T)).T + t_ - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def make_trajectory(sc, n_views, rng, yaw_step=0.015, t_step=0.09):
    views = []
    for i in range(n_views):
        yaw = yaw_step * i
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = [t_step * i, 0.02 * np.sin(0.7 * i), 0.015 * i]
        views.append(make_view(sc, T, rng))
    return views
