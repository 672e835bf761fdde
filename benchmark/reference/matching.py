"""Plain PyTorch pixel matching: MASt3R-SLAM's iterative projection of each
pixel's ray onto the other view's ray image, the occlusion distance check,
and the windowed descriptor refinement.

The fast path the configurations run is its algorithm: a closed-form
pinhole fit for the start, two Levenberg-Marquardt steps a pixel, a
coarse-to-fine window of dilations (max, 1), and descriptors stored as
int8 (round(127 d)) and bfloat16 and scored in float32. `dtype` is the
arithmetic of the solve: float32 for the reference, bfloat16 for the
control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TAPS = [(-1, -1, -3.0, -3.0), (-1, 0, 0.0, -10.0), (-1, 1, 3.0, -3.0),
         (0, -1, -10.0, 0.0), (0, 1, 10.0, 0.0), (1, -1, -3.0, 3.0),
         (1, 0, 0.0, 10.0), (1, 1, 3.0, 3.0)]


def gradients(img):
    """Scharr-like x/y gradients (taps / 32, reflect padding) of
    (b, h, w, c) → (gx, gy)."""
    p = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    p = p.permute(0, 2, 3, 1)
    h, w = img.shape[1], img.shape[2]
    gx, gy = torch.zeros_like(img), torch.zeros_like(img)
    for dy, dx, wx, wy in _TAPS:
        tile = p[:, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w, :]
        if wx:
            gx = gx + (wx / 32.0) * tile
        if wy:
            gy = gy + (wy / 32.0) * tile
    return gx, gy


def pinhole(X, eps=1e-6):
    """Least-squares (fx, fy, cx, cy) of pointmaps (b, h, w, 3)."""
    b, h, w, _ = X.shape
    z = torch.clamp(X[..., 2], min=eps)
    a, bb = X[..., 0] / z, X[..., 1] / z
    vv, uu = torch.meshgrid(torch.arange(h, dtype=X.dtype, device=X.device),
                            torch.arange(w, dtype=X.dtype, device=X.device),
                            indexing="ij")
    valid = (X[..., 2] > eps).to(X.dtype)
    n = torch.clamp(valid.sum((1, 2)), min=1.0)

    def axis(t, target):
        st = (t * valid).sum((1, 2))
        stt = (t * t * valid).sum((1, 2))
        sy = (target * valid).sum((1, 2))
        sty = (t * target * valid).sum((1, 2))
        det = stt * n - st * st
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        return (sty * n - st * sy) / det, (stt * sy - st * sty) / det

    fx, cx = axis(a, uu)
    fy, cy = axis(bb, vv)
    return fx, fy, cx, cy


def _corners(img):
    b, h, w, c = img.shape
    p = torch.cat([img, img[:, -1:]], dim=1)
    p = torch.cat([p, p[:, :, -1:]], dim=2)
    tab = torch.cat([p[:, :h, :w], p[:, :h, 1:w + 1], p[:, 1:h + 1, :w],
                     p[:, 1:h + 1, 1:w + 1]], dim=-1)
    return tab.reshape(b, h * w, 4 * c)


def _bilinear(tab, u, v, w, c):
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    base = (torch.nan_to_num(v0, nan=0.0).long() * w
            + torch.nan_to_num(u0, nan=0.0).long())
    rows = torch.gather(tab, 1, base[..., None].expand(-1, -1, 4 * c))
    i00, i01, i10, i11 = rows.split(c, dim=-1)
    return ((1 - du) * (1 - dv) * i00 + du * (1 - dv) * i01
            + (1 - du) * dv * i10 + du * dv * i11)


def project(rays_grad, pts, p, iters, lam0, thresh):
    """Per-pixel LM of a unit ray onto a ray image → (p, converged)."""
    b, h, w, _ = rays_grad.shape
    u = torch.clamp(p[..., 0], 1.0, w - 2.0)
    v = torch.clamp(p[..., 1], 1.0, h - 2.0)
    lam = torch.full_like(u, lam0)
    conv = torch.zeros_like(u, dtype=torch.bool)
    tab = _corners(rays_grad)
    samp = _bilinear(tab, u, v, w, 9)

    def cost(s):
        r = s[..., 0:3]
        r = r / torch.linalg.norm(r, dim=-1, keepdim=True)
        e = r - pts
        return (e * e).sum(-1), e

    for _ in range(iters):
        gx, gy = samp[..., 3:6], samp[..., 6:9]
        c, e = cost(samp)
        a00 = (gx * gx).sum(-1) + lam
        a01 = (gx * gy).sum(-1)
        a11 = (gy * gy).sum(-1) + lam
        b0, b1 = -(e * gx).sum(-1), -(e * gy).sum(-1)
        di = 1.0 / (a00 * a11 - a01 * a01)
        un = torch.clamp(u + di * (a11 * b0 - a01 * b1), 1.0, w - 2.0)
        vn = torch.clamp(v + di * (-a01 * b0 + a00 * b1), 1.0, h - 2.0)
        sn = _bilinear(tab, un, vn, w, 9)
        cn, _ = cost(sn)
        acc = cn < c
        u, v = torch.where(acc, un, u), torch.where(acc, vn, v)
        samp = torch.where(acc[..., None], sn, samp)
        lam = torch.where(acc, lam * 0.1, lam * 10.0)
        conv = torch.where(acc, cn < thresh, c < thresh)
    return torch.stack([u, v], dim=-1), conv


def refine(D11, D21, p, radius, schedule, quantize):
    """Windowed descriptor argmax, coarse to fine (first index on ties)."""
    b, h, w, f = D11.shape
    n = p.shape[1]
    img = (torch.clamp(torch.round(D11.float() * 127.0), -127, 127).to(
        torch.int8) if quantize else D11.to(torch.bfloat16))
    d21 = D21.to(torch.bfloat16)
    a = torch.arange(-radius, radius + 1, device=D11.device)
    dv, du = torch.meshgrid(a, a, indexing="ij")
    offs = torch.stack([du, dv], -1).reshape(-1, 2)
    k = offs.shape[0]
    u, v = p[..., 0].long(), p[..., 1].long()
    for d in schedule:
        uc, vc = torch.clamp(u, 0, w - 1), torch.clamp(v, 0, h - 1)
        r = radius * d
        wp = w + 2 * r
        pad = torch.zeros((b, h + 2 * r, wp, f), dtype=img.dtype,
                          device=D11.device)
        pad[:, r:r + h, r:r + w] = img
        yy = vc[..., None] + r + offs[:, 1] * d
        xx = uc[..., None] + r + offs[:, 0] * d
        lin = (yy * wp + xx).reshape(b, n * k, 1).expand(-1, -1, f)
        rows = torch.gather(pad.reshape(b, -1, f), 1, lin).reshape(b, n, k, f)
        scores = (rows.to(torch.bfloat16).float()
                  * d21[:, :, None, :].float()).sum(-1)
        uu = u[..., None] + offs[:, 0] * d
        vv = v[..., None] + offs[:, 1] * d
        inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        scores = torch.where(inside, scores,
                             torch.full_like(scores, float("-inf")))
        best = scores.argmax(-1, keepdim=True)
        u = torch.gather(uu, -1, best)[..., 0]
        v = torch.gather(vv, -1, best)[..., 0]
    return torch.stack([u, v], dim=-1)


def match(X11, X21, D11, D21, idx_init, mcfg: dict,
          dtype=torch.float32):
    """(idx (b, h·w) of each view-2 pixel in view 1, valid (b, h·w)) with
    the matching section of a configuration, in `dtype`."""
    X11, X21 = X11.to(dtype), X21.to(dtype)
    b, h, w, _ = X11.shape
    n = h * w
    rays = X11 / torch.linalg.norm(X11, dim=-1, keepdim=True)
    gx, gy = gradients(rays)
    rays_grad = torch.cat([rays, gx, gy], dim=-1)
    pts = X21.reshape(b, n, 3)
    pts = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
    if idx_init is None:
        idx_init = torch.arange(n, device=X11.device).expand(b, n)
    p = torch.stack([idx_init % w, idx_init // w], -1).to(dtype)
    # the fast path: a pinhole fit gives the start, a short polish follows
    fx, fy, cx, cy = pinhole(X11)
    z = pts[..., 2]
    ok = z > 1e-6
    zc = torch.where(ok, z, torch.ones_like(z))
    proj = torch.stack([fx[:, None] * pts[..., 0] / zc + cx[:, None],
                        fy[:, None] * pts[..., 1] / zc + cy[:, None]], -1)
    p = torch.where(ok[..., None], proj, p)
    p, conv = project(rays_grad, pts, p, 2, float(mcfg["lambda_init"]),
                      float(mcfg["convergence_thresh"]))
    p = p.long()
    lin = p[..., 0] + w * p[..., 1]
    at = torch.gather(X11.reshape(b, n, 3), 1, lin[..., None].expand(-1, -1,
                                                                    3))
    dist = torch.linalg.norm(at - X21.reshape(b, n, 3), dim=-1)
    valid = conv & (dist < float(mcfg["dist_thresh"]))
    r, dil = int(mcfg["radius"]), int(mcfg["dilation_max"])
    if r > 0:
        p = refine(D11, D21.reshape(b, n, -1), p, r,
                   (dil, 1) if dil > 1 else (1,), quantize=True)
    return p[..., 0] + w * p[..., 1], valid
