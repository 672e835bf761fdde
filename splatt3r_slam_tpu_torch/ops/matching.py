"""Pixel correspondence by iterative projection + descriptor refinement.

Counterpart of `splatt3r_slam_tpu/ops/matching.py`:
- `iter_proj`: per-pixel 2-DoF Levenberg-Marquardt projection of a unit
  ray onto a ray image, vectorized over all pixels with a static iteration
  count (lambda up/down per pixel, no data-dependent control flow);
- `refine_matches`: windowed descriptor dot-product argmax over a
  dilation schedule, with int8 descriptor storage (`refine_quantize`) and
  bf16-rounded descriptors scored in fp32;
- `match`: the entry point, with the closed-form pinhole init + short LM
  polish fast path and the occlusion distance check.

Batched functions take a leading batch dim b; indices are int64.
"""

from __future__ import annotations

import torch

from splatt3r_slam_tpu_torch.ops.image import img_gradient


def match_kwargs_from_config(mcfg: dict) -> dict:
    """config['matching'] → kwargs for `match` (fast-path knobs default on)."""
    dil = int(mcfg["dilation_max"])
    sched = mcfg.get("refine_schedule")
    sched = tuple(sched) if sched is not None else (
        (dil, 1) if dil > 1 else (1,))
    return dict(
        max_iter=int(mcfg["max_iter"]),
        lambda_init=float(mcfg["lambda_init"]),
        convergence_thresh=float(mcfg["convergence_thresh"]),
        dist_thresh=float(mcfg["dist_thresh"]),
        radius=int(mcfg["radius"]),
        dilation_max=dil,
        closed_form_init=bool(mcfg.get("closed_form_init", True)),
        polish_iters=int(mcfg.get("polish_iters", 2)),
        refine_schedule=sched,
        refine_quantize=bool(mcfg.get("refine_quantize", True)),
    )


def fit_pinhole(X, eps: float = 1e-6):
    """Least-squares pinhole (fx, fy, cx, cy) from pointmaps (b, h, w, 3)."""
    b, h, w, _ = X.shape
    z = torch.clamp(X[..., 2], min=eps)
    a = X[..., 0] / z
    bb = X[..., 1] / z
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=X.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=X.device), indexing="ij")
    valid = (X[..., 2] > eps).float()
    n = torch.clamp(valid.sum((1, 2)), min=1.0)

    def solve_axis(t, target):
        st = (t * valid).sum((1, 2))
        stt = (t * t * valid).sum((1, 2))
        sy = (target * valid).sum((1, 2))
        sty = (t * target * valid).sum((1, 2))
        det = stt * n - st * st
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        return (sty * n - st * sy) / det, (stt * sy - st * sty) / det

    fx, cx = solve_axis(a, uu)
    fy, cy = solve_axis(bb, vv)
    return fx, fy, cx, cy


def prep_rays_with_grad(X11):
    """Normalized ray image + gradients, (b, h, w, 9) [rays, gx, gy]."""
    rays = X11 / torch.linalg.norm(X11, dim=-1, keepdim=True)
    gx, gy = img_gradient(rays)
    return torch.cat([rays, gx, gy], dim=-1)


def _corner_table(rays_img):
    """(b, h, w, c) → (b, h*w, 4c) table of each pixel's 2x2 corners."""
    b, h, w, c = rays_img.shape
    p = torch.cat([rays_img, rays_img[:, -1:]], dim=1)
    p = torch.cat([p, p[:, :, -1:]], dim=2)  # edge pad by one
    tab = torch.cat([p[:, :h, :w], p[:, :h, 1:w + 1], p[:, 1:h + 1, :w],
                     p[:, 1:h + 1, 1:w + 1]], dim=-1)
    return tab.reshape(b, h * w, 4 * c)


def _bilinear_gather(tab4, u, v, w: int, c: int):
    """Bilinear sample (b, n, c) from a corner table (b, hw, 4c).

    Callers guarantee u ∈ [1, w-2], v ∈ [1, h-2]."""
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    # a NaN coordinate (a singular LM step) reads row 0, and its NaN du/dv
    # make the sample NaN, which `iter_proj` rejects; XLA converts NaN to
    # an in-bounds index the same way, where torch's .long() gives -2^63
    base = (torch.nan_to_num(v0, nan=0.0).long() * w
            + torch.nan_to_num(u0, nan=0.0).long())
    rows = torch.gather(tab4, 1, base[..., None].expand(-1, -1, 4 * c))
    i00, i01, i10, i11 = rows.split(c, dim=-1)
    return ((1 - du) * (1 - dv) * i00 + du * (1 - dv) * i01
            + (1 - du) * dv * i10 + du * dv * i11)


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter: int = 10,
              lambda_init: float = 1e-8, cost_thresh: float = 1e-6):
    """Batched LM iterative projection.

    rays_with_grad_img (b, h, w, 9); pts3d_norm (b, n, 3); p_init (b, n, 2).
    Returns (p (b, n, 2) float, converged (b, n) bool)."""
    b, h, w, _ = rays_with_grad_img.shape
    u = torch.clamp(p_init[..., 0], 1.0, w - 2.0)
    v = torch.clamp(p_init[..., 1], 1.0, h - 2.0)
    lam = torch.full_like(u, lambda_init)
    conv = torch.zeros_like(u, dtype=torch.bool)
    tab4 = _corner_table(rays_with_grad_img)
    samp = _bilinear_gather(tab4, u, v, w, 9)

    def cost_of(s):
        r = s[..., 0:3]
        r = r / torch.linalg.norm(r, dim=-1, keepdim=True)
        err = r - pts3d_norm
        return (err * err).sum(-1), err

    for _ in range(max_iter):
        gx = samp[..., 3:6]
        gy = samp[..., 6:9]
        cost, err = cost_of(samp)
        A00 = (gx * gx).sum(-1) + lam
        A01 = (gx * gy).sum(-1)
        A11 = (gy * gy).sum(-1) + lam
        b0 = -(err * gx).sum(-1)
        b1 = -(err * gy).sum(-1)
        det_inv = 1.0 / (A00 * A11 - A01 * A01)
        du = det_inv * (A11 * b0 - A01 * b1)
        dv = det_inv * (-A01 * b0 + A00 * b1)
        u_new = torch.clamp(u + du, 1.0, w - 2.0)
        v_new = torch.clamp(v + dv, 1.0, h - 2.0)
        samp_new = _bilinear_gather(tab4, u_new, v_new, w, 9)
        new_cost, _ = cost_of(samp_new)
        accept = new_cost < cost
        u = torch.where(accept, u_new, u)
        v = torch.where(accept, v_new, v)
        samp = torch.where(accept[..., None], samp_new, samp)
        lam = torch.where(accept, lam * 0.1, lam * 10.0)
        conv = torch.where(accept, new_cost < cost_thresh, cost < cost_thresh)
    return torch.stack([u, v], dim=-1), conv


def _window_offsets(radius: int, device):
    """(side², 2) (du, dv) offsets, v-major scan order (du fastest)."""
    a = torch.arange(-radius, radius + 1, device=device)
    dv, du = torch.meshgrid(a, a, indexing="ij")
    return torch.stack([du, dv], dim=-1).reshape(-1, 2)


def refine_matches(D11, D21, p1, radius: int = 3, dilation_max: int = 5,
                   schedule: tuple | None = None, quantize: bool = True):
    """Coarse-to-fine windowed descriptor argmax.

    D11 (b, h, w, f); D21 (b, n, f); p1 (b, n, 2) int. For each dilation d
    in `schedule` (default d = dilation_max..1), scores the (2r+1)² pixels
    at spacing d around the current centre and re-centres on the best
    (first index on ties). Returns (b, n, 2) int64."""
    b, h, w, fdim = D11.shape
    n = p1.shape[1]
    if schedule is None:
        schedule = tuple(range(dilation_max, 0, -1))
    if quantize:
        D11img = torch.clamp(torch.round(D11 * 127.0), -127, 127).to(
            torch.int8)
    else:
        D11img = D11.to(torch.bfloat16)
    D21b = D21.to(torch.bfloat16)
    offs = _window_offsets(radius, D11.device)  # (k, 2)
    k = offs.shape[0]
    u = p1[..., 0].long()
    v = p1[..., 1].long()

    for d in schedule:
        uc = torch.clamp(u, 0, w - 1)
        vc = torch.clamp(v, 0, h - 1)
        r = radius * d
        wp = w + 2 * r
        pad = torch.zeros((b, h + 2 * r, wp, fdim), dtype=D11img.dtype,
                          device=D11.device)
        pad[:, r:r + h, r:r + w] = D11img
        yy = vc[..., None] + r + offs[:, 1] * d  # (b, n, k)
        xx = uc[..., None] + r + offs[:, 0] * d
        lin = (yy * wp + xx).reshape(b, n * k, 1).expand(-1, -1, fdim)
        rows = torch.gather(pad.reshape(b, -1, fdim), 1, lin)
        rows = rows.reshape(b, n, k, fdim)
        # bf16-rounded operands, fp32 products and sum: what XLA computes
        # for the JAX version's bf16 multiply (it drops the product's
        # rounding back to bf16).
        scores = (rows.to(torch.bfloat16).float()
                  * D21b[:, :, None, :].float()).sum(-1)
        uu = u[..., None] + offs[:, 0] * d
        vv = v[..., None] + offs[:, 1] * d
        inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        scores = torch.where(inside, scores,
                             torch.full_like(scores, float("-inf")))
        best = scores.argmax(-1, keepdim=True)
        u = torch.gather(uu, -1, best)[..., 0]
        v = torch.gather(vv, -1, best)[..., 0]
    return torch.stack([u, v], dim=-1)


def pixel_to_lin(p, w: int):
    """(u, v) → v*w + u."""
    return p[..., 0] + w * p[..., 1]


def lin_to_pixel(idx, w: int):
    """v*w + u → (u, v)."""
    return torch.stack([idx % w, idx // w], dim=-1)


def match(X11, X21, D11, D21, idx_1_to_2_init=None, *, max_iter: int = 10,
          lambda_init: float = 1e-8, convergence_thresh: float = 1e-6,
          dist_thresh: float = 1e-1, radius: int = 3, dilation_max: int = 5,
          closed_form_init: bool = False, polish_iters: int = 2,
          refine_schedule: tuple | None = None,
          refine_quantize: bool = False):
    """Full correspondence pipeline.

    X11 (b,h,w,3) view-1 points in frame 1; X21 (b,h,w,3) view-2 points in
    frame 1; D11/D21 (b,h,w,f) descriptors. Defaults are the reference
    semantics; `closed_form_init`, `polish_iters`, `refine_schedule` and
    `refine_quantize` are the fast path the fused frontend uses.
    Returns (idx_1_to_2 (b, h*w) int64, valid (b, h*w, 1) bool).
    """
    b, h, w, _ = X11.shape
    n = h * w
    rays_img = prep_rays_with_grad(X11)
    pts3d_norm = X21.reshape(b, n, 3)
    pts3d_norm = pts3d_norm / torch.linalg.norm(pts3d_norm, dim=-1,
                                                keepdim=True)
    if idx_1_to_2_init is None:
        idx_1_to_2_init = torch.arange(n, device=X11.device).expand(b, n)
    p_init = lin_to_pixel(idx_1_to_2_init, w).float()

    eff_iters = max_iter
    if closed_form_init:
        fx, fy, cx, cy = fit_pinhole(X11)
        z = pts3d_norm[..., 2]
        ok = z > 1e-6
        zc = torch.where(ok, z, torch.ones_like(z))
        u_proj = fx[:, None] * pts3d_norm[..., 0] / zc + cx[:, None]
        v_proj = fy[:, None] * pts3d_norm[..., 1] / zc + cy[:, None]
        p_init = torch.where(ok[..., None],
                             torch.stack([u_proj, v_proj], dim=-1), p_init)
        eff_iters = polish_iters

    p1, valid_proj = iter_proj(rays_img, pts3d_norm, p_init, eff_iters,
                               lambda_init, convergence_thresh)
    p1 = p1.long()  # truncation (p ≥ 1) as the reference's .long()

    lin = pixel_to_lin(p1, w)
    X11_at = torch.gather(X11.reshape(b, n, 3), 1,
                          lin[..., None].expand(-1, -1, 3))
    dists = torch.linalg.norm(X11_at - X21.reshape(b, n, 3), dim=-1)
    valid = valid_proj & (dists < dist_thresh)

    if radius > 0:
        p1 = refine_matches(D11, D21.reshape(b, n, -1), p1, radius,
                            dilation_max, schedule=refine_schedule,
                            quantize=refine_quantize)
    return pixel_to_lin(p1, w), valid[..., None]
