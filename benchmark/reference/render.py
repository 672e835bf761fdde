"""Plain PyTorch gaussians of the SLAM loop: a keyframe's predictions
moved into the world as the map accumulates them (`to_world`), and a
frame's predictions splatted as the loop renders them each frame:
Σ = R diag(s²) Rᵀ from scale and xyzw quaternion, colour from the
degree-0 SH residual over the source image,
EWA projection with a 0.3-pixel blur, 16x16 tiles binned in exact depth
order (each gaussian on at most 4x4 tiles, at most 512 gaussians a tile),
and front-to-back alpha compositing (alpha capped at 0.99, below 1/255
skipped). The frame's own and cross predictions lie on one plane in the
oracle's scene, so many of them tie in depth to the last bit: the depths
are formed by the same products as the program's (the view inv(M)·M of
the frame's pose, then X·Rᵀ + t), so that ties fall the same way. `dtype`
is the arithmetic: float32 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import math

import torch

TILE = 16
C0 = 0.28209479177387814


def quat_to_matrix(q):
    i, j, k, r = q.unbind(-1)
    s = 2.0 / torch.clamp((q * q).sum(-1), min=1e-12)
    rows = torch.stack([
        1 - s * (j ** 2 + k ** 2), s * (i * j - k * r), s * (i * k + j * r),
        s * (i * j + k * r), 1 - s * (i ** 2 + k ** 2), s * (j * k - i * r),
        s * (i * k - j * r), s * (j * k + i * r), 1 - s * (i ** 2 + j ** 2),
    ], dim=-1)
    return rows.reshape(q.shape[:-1] + (3, 3))


def frame_gaussians(pred, pred_cross, img, img_ref):
    """The frame's self and cross predictions as one set (means, cov
    upper triangle [xx xy xz yy yz zz], colours, opacities)."""
    out = [[], [], [], []]
    for p, im in ((pred, img), (pred_cross, img_ref)):
        rgb = torch.clamp(im[0] * 0.5 + 0.5, 0.0, 1.0).reshape(-1, 3)
        R = quat_to_matrix(p["rotations"][0].reshape(-1, 4))
        s = p["scales"][0].reshape(-1, 3)
        cov = torch.einsum("nij,nj,nkj->nik", R, s * s, R)
        tri = torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                           cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], -1)
        sh0 = p["sh"][0][..., 0].reshape(-1, 3) + (rgb - 0.5) / C0
        out[0].append(p["means"][0].reshape(-1, 3))
        out[1].append(tri)
        out[2].append(torch.clamp(sh0 * C0 + 0.5, 0.0, 1.0))
        out[3].append(p["opacities"][0].reshape(-1))
    return tuple(torch.cat(o) for o in out)


def pose_matrix(T):
    """4x4 [sR | t] of a pose [t, q xyzw, s]."""
    R = quat_to_matrix(T[3:7]) * T[7:8][..., None]
    top = torch.cat([R, T[:3, None]], dim=-1)
    bottom = torch.zeros((1, 4), dtype=T.dtype, device=T.device)
    bottom[0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def render(means, cov, colors, opa, view, K, hw, dtype=torch.float32,
           k_max=512, tpg_side=4, tile_chunk=32):
    """(H, W, 3) image of gaussians seen through `view` (world to camera,
    4x4)."""
    H, W = hw
    means, cov, colors, opa, view, K = (a.to(dtype) for a in
                                        (means, cov, colors, opa, view, K))
    dev = means.device
    R, t = view[:3, :3], view[:3, 3]
    Xc = means @ R.T + t
    z = Xc[:, 2]
    ok = (z > 0.01) & (opa > 1.0 / 255.0)
    zs = torch.where(ok, z, torch.ones_like(z))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * Xc[:, 0] / zs + cx
    v = fy * Xc[:, 1] / zs + cy
    cxx, cxy, cxz, cyy, cyz, czz = cov.unbind(-1)
    zi = 1.0 / zs
    a0, c0 = fx * zi, -fx * Xc[:, 0] * zi * zi
    b1, c1 = fy * zi, -fy * Xc[:, 1] * zi * zi
    # J = ∂(u, v)/∂X in world coordinates: the projection's rows times R
    j0 = [a0 * R[0, i] + c0 * R[2, i] for i in range(3)]
    j1 = [b1 * R[1, i] + c1 * R[2, i] for i in range(3)]

    def rowmul(a, b, c):
        return (a * cxx + b * cxy + c * cxz, a * cxy + b * cyy + c * cyz,
                a * cxz + b * cyz + c * czz)

    w0, w1 = rowmul(*j0), rowmul(*j1)
    s00 = w0[0] * j0[0] + w0[1] * j0[1] + w0[2] * j0[2] + 0.3
    s01 = w0[0] * j1[0] + w0[1] * j1[1] + w0[2] * j1[2]
    s11 = w1[0] * j1[0] + w1[1] * j1[1] + w1[2] * j1[2] + 0.3
    det = s00 * s11 - s01 * s01
    dets = torch.where(det > 1e-12, det, torch.ones_like(det))
    ok = ok & (det > 1e-12)
    conic = torch.stack([s11 / dets, -s01 / dets, s00 / dets], -1)
    mid = 0.5 * (s00 + s11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    rad = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    ok = ok & (u + rad > 0) & (u - rad < W) & (v + rad > 0) & (v - rad < H)

    # tiles, in exact depth order
    TX, TY = W // TILE, H // TILE
    T = TX * TY
    order = torch.argsort(torch.where(ok, z.float(),
                                      torch.full_like(z.float(), math.inf)),
                          stable=True)
    uo, vo, ro, oko = u[order], v[order], rad[order], ok[order]

    def rng(c, r, n):
        lo = torch.floor((c - r) / TILE).clamp(0, n - 1).to(torch.int32)
        hi = torch.floor((c + r) / TILE).clamp(0, n - 1).to(torch.int32)
        return lo, hi

    tx0, tx1 = rng(uo, ro, TX)
    ty0, ty1 = rng(vo, ro, TY)
    a = torch.arange(tpg_side, dtype=torch.int32, device=dev)
    dyy, dxx = torch.meshgrid(a, a, indexing="ij")
    tx = tx0[:, None] + dxx.reshape(1, -1)
    ty = ty0[:, None] + dyy.reshape(1, -1)
    kok = (tx <= tx1[:, None]) & (ty <= ty1[:, None]) & oko[:, None]
    tid = torch.where(kok, ty * TX + tx, torch.full_like(tx, T))
    skey, sidx = torch.sort(tid.reshape(-1), stable=True)
    sg = order[sidx // tid.shape[1]]
    bounds = torch.searchsorted(
        skey, torch.arange(T + 1, dtype=torch.int32, device=dev))
    starts, ends = bounds[:T], bounds[1:]
    pos = starts[:, None] + torch.arange(k_max, device=dev)[None]
    vk = pos < ends[:, None]
    gidx = sg[pos.clamp(0, sg.shape[0] - 1)]

    attrs = torch.cat([u[:, None], v[:, None], conic, colors,
                       opa[:, None]], -1)
    p = torch.arange(TILE * TILE, device=dev)
    local = torch.stack([p % TILE, p // TILE], -1).to(dtype) + 0.5
    t = torch.arange(T, device=dev)
    origins = torch.stack([(t % TX) * TILE, (t // TX) * TILE], -1).to(dtype)
    out = []
    for t0 in range(0, T, tile_chunk):
        rows = attrs[gidx[t0:t0 + tile_chunk]]
        pix = origins[t0:t0 + tile_chunk, None] + local[None]
        d = pix[:, None] - rows[:, :, None, 0:2]
        cn = rows[..., 2:5]
        power = -0.5 * (cn[:, :, None, 0] * d[..., 0] ** 2
                        + cn[:, :, None, 2] * d[..., 1] ** 2) \
            - cn[:, :, None, 1] * d[..., 0] * d[..., 1]
        alpha = torch.clamp(rows[..., 8][:, :, None] * torch.exp(power),
                            max=0.99)
        alpha = torch.where(alpha < 1.0 / 255.0, torch.zeros_like(alpha),
                            alpha) * vk[t0:t0 + tile_chunk, :, None]
        one = 1.0 - alpha
        trans = torch.cumprod(one, dim=1)
        wgt = alpha * trans / one
        out.append(torch.einsum("ckp,ckd->cpd", wgt, rows[..., 5:8]))
    px = torch.cat(out).reshape(TY, TX, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return px.reshape(H, W, 3).float()


def render_frame(pred, pred_cross, img, img_ref, T_WC, hw,
                 dtype=torch.float32):
    """A frame's predictions rendered from its own pose T_WC (the view
    inv(M) M of its 4x4 M, as the SLAM loop forms it; focal = the larger
    side, principal point at the centre), black background."""
    H, W = hw
    f = float(max(hw))
    dev = pred["means"].device
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    M = pose_matrix(T_WC)
    view = torch.linalg.inv(M) @ M
    return render(*frame_gaussians(pred, pred_cross, img, img_ref), view,
                  K, hw, dtype=dtype)


def to_world(pred, img, T_WC, spatial_stride: int, depth_min: float,
             depth_max_percentile: float, max_scale: float,
             min_confidence: float, dtype=torch.float64):
    """One view's gaussians in the world as the map keeps them: every
    `spatial_stride`-th pixel, colour from the degree-0 SH residual over
    the image, Σ = R diag(s²) Rᵀ moved by the pose's sR, and opacity 0
    where the depth lies outside (depth_min, the depth_max_percentile
    quantile of the valid depths], the largest scale reaches max_scale or
    the confidence is below min_confidence → (means, cov upper triangle,
    colours, opacities). The quantile is the linear one of the float32
    depths, so that its threshold is the same number on both sides."""
    s = int(spatial_stride)

    def grid(a, c):
        return a[0][::s, ::s].reshape(-1, c)

    z32 = grid(pred["means"], 3)[:, 2].float()
    means = grid(pred["means"], 3).to(dtype)
    scales = grid(pred["scales"], 3).to(dtype)
    rot = grid(pred["rotations"], 4).to(dtype)
    sh0 = pred["sh"][0][::s, ::s, :, 0].reshape(-1, 3).to(dtype)
    opa = grid(pred["opacities"], 1)[:, 0].to(dtype)
    conf = pred["conf"][0][::s, ::s].reshape(-1).to(dtype)
    rgb = torch.clamp(img[0] * 0.5 + 0.5, 0.0, 1.0)[::s, ::s]
    rgb = rgb.reshape(-1, 3).to(dtype)
    valid = z32 > depth_min
    if depth_max_percentile < 1.0:
        q = torch.nanquantile(torch.where(valid, z32, torch.full_like(
            z32, math.nan)), depth_max_percentile)
        if not bool(torch.isnan(q)):
            valid = valid & (z32 <= q)
    valid = valid & (grid(pred["scales"], 3).amax(-1) < max_scale)
    if min_confidence > 0:
        valid = valid & (pred["conf"][0][::s, ::s].reshape(-1)
                         >= min_confidence)
    M = pose_matrix(T_WC.to(dtype))
    R, t = M[:3, :3], M[:3, 3]
    Rg = quat_to_matrix(rot)
    cov = torch.einsum("nij,nj,nkj->nik", Rg, scales * scales, Rg)
    cov = torch.einsum("ij,njk,lk->nil", R, cov, R)
    tri = torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                       cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], -1)
    col = torch.clamp((sh0 + (rgb - 0.5) / C0) * C0 + 0.5, 0.0, 1.0)
    return (means @ R.T + t, tri, col,
            torch.where(valid, opa, torch.zeros_like(opa)))
