"""Tile-binned 3D Gaussian splatting rasterizer (forward), plain PyTorch.

Counterpart of `splatt3r_slam_tpu/splat/rasterizer.py`:
1. `project_gaussians`: world gaussians → screen means, conics, depth,
   radius, validity (EWA 2D covariance with a 0.3 px blur);
2. `bin_tiles`: the gaussians in exact depth order, each emitting
   ≤ tpg_side² int32 tile-id keys; ONE stable sort with the gaussian index
   as payload, per-tile segment bounds by a left binary search, and
   per-tile depth-ordered index lists capped at k_max. (The JAX package
   sorts one `tile_id << 18 | depth_q` key, so gaussians of a tile whose
   18-bit depths tie composite in index order there; here they composite
   in depth order, as the exact oracle does;
   `tests/test_torch_port_rasterizer.py::
   test_depth_key_ties_composite_in_depth_order` holds both);
3. `render_tiles`: the plain compositor — an exclusive cumulative product
   over each tile's depth axis;
4. `render_bruteforce`: the exact O(G·P) oracle (tests only), and
   `render_bruteforce_scan`, the same oracle over depth-ordered chunks of
   gaussians, block by block, in O(g_chunk·256) memory (the fidelity
   sweep's).

The hand-written CUDA compositor lives in `cuda_rasterizer.py`;
`default_rasterizer` picks it for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

TILE = 16


def default_rasterizer(t: torch.Tensor) -> str:
    """'cuda' (the hand-written compositor) for CUDA tensors, 'torch' (the
    plain compositor) for CPU tensors."""
    return "cuda" if t.is_cuda else "torch"


def project_gaussians(means, cov_triu, opa, view, K, hw, near=0.01,
                      blur=0.3):
    """World gaussians → (means2d, conic, depth, radius, ok).

    view: (4,4) world→camera; K: (3,3) pixel intrinsics. Per-gaussian
    3x3/2x2 algebra is written component-wise over (G,) vectors."""
    H, W = hw
    means, cov_triu, opa, view, K = (
        a.float() for a in (means, cov_triu, opa, view, K))
    R = view[:3, :3]
    t = view[:3, 3]
    Xc = means @ R.T + t
    z = Xc[:, 2]
    ok = (z > near) & (opa > 1.0 / 255.0)
    z_s = torch.where(ok, z, torch.ones_like(z))

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * Xc[:, 0] / z_s + cx
    v = fy * Xc[:, 1] / z_s + cy
    means2d = torch.stack([u, v], dim=-1)

    cxx, cxy, cxz, cyy, cyz, czz = cov_triu.unbind(-1)

    def rowmul(a, b, c):
        return (a * cxx + b * cxy + c * cxz,
                a * cxy + b * cyy + c * cyz,
                a * cxz + b * cyz + c * czz)

    zi = 1.0 / z_s
    a0 = fx * zi
    c0 = -fx * Xc[:, 0] * zi * zi
    b1 = fy * zi
    c1 = -fy * Xc[:, 1] * zi * zi
    j0x = a0 * R[0, 0] + c0 * R[2, 0]
    j0y = a0 * R[0, 1] + c0 * R[2, 1]
    j0z = a0 * R[0, 2] + c0 * R[2, 2]
    j1x = b1 * R[1, 0] + c1 * R[2, 0]
    j1y = b1 * R[1, 1] + c1 * R[2, 1]
    j1z = b1 * R[1, 2] + c1 * R[2, 2]
    w0x, w0y, w0z = rowmul(j0x, j0y, j0z)
    w1x, w1y, w1z = rowmul(j1x, j1y, j1z)
    s00 = w0x * j0x + w0y * j0y + w0z * j0z + blur
    s01 = w0x * j1x + w0y * j1y + w0z * j1z
    s11 = w1x * j1x + w1y * j1y + w1z * j1z + blur

    det = s00 * s11 - s01 * s01
    det_s = torch.where(det > 1e-12, det, torch.ones_like(det))
    ok = ok & (det > 1e-12)
    conic = torch.stack([s11 / det_s, -s01 / det_s, s00 / det_s], dim=-1)
    mid = 0.5 * (s00 + s11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    inside = ((u + radius > 0) & (u - radius < W) & (v + radius > 0)
              & (v - radius < H))
    return means2d, conic, z, radius, ok & inside


def _tile_range(c, radius, n_tiles):
    lo = torch.floor((c - radius) / TILE).clamp(0, n_tiles - 1)
    hi = torch.floor((c + radius) / TILE).clamp(0, n_tiles - 1)
    return lo.to(torch.int32), hi.to(torch.int32)


def bin_tiles(means2d, depth, radius, ok, hw, tpg_side, k_max):
    """Tile binning shared by the plain and CUDA compositors.

    Returns (gidx (T, k_max) int64, valid_k (T, k_max) bool, counts (T,)
    int32): per-tile depth-ordered gaussian indices, padded and capped."""
    H, W = hw
    TX, TY = W // TILE, H // TILE
    T = TX * TY
    dev = means2d.device

    # gaussians in exact depth order (stable: equal depths keep index
    # order), so that ONE stable sort on the tile id leaves each tile's
    # list in depth order
    by_depth = torch.argsort(
        torch.where(ok, depth, torch.full_like(depth, math.inf)), stable=True)
    means2d, radius, ok = means2d[by_depth], radius[by_depth], ok[by_depth]

    tx0, tx1 = _tile_range(means2d[:, 0], radius, TX)
    ty0, ty1 = _tile_range(means2d[:, 1], radius, TY)
    a = torch.arange(tpg_side, dtype=torch.int32, device=dev)
    dyy, dxx = torch.meshgrid(a, a, indexing="ij")  # dx fastest
    tx = tx0[:, None] + dxx.reshape(1, -1)  # (G, TPG)
    ty = ty0[:, None] + dyy.reshape(1, -1)
    key_ok = (tx <= tx1[:, None]) & (ty <= ty1[:, None]) & ok[:, None]
    tile_id = torch.where(key_ok, ty * TX + tx, torch.full_like(tx, T))

    sorted_key, order = torch.sort(tile_id.reshape(-1), stable=True)
    sorted_g = by_depth[order // tile_id.shape[1]]
    probes = torch.arange(T + 1, dtype=torch.int32, device=dev)

    bounds = torch.searchsorted(sorted_key, probes, right=False)
    starts, ends = bounds[:T], bounds[1:]
    pos = starts[:, None] + torch.arange(k_max, device=dev)[None, :]
    valid_k = pos < ends[:, None]
    pos = pos.clamp(0, sorted_g.shape[0] - 1)
    gidx = sorted_g[pos]
    counts = torch.clamp(ends - starts, max=k_max).to(torch.int32)
    return gidx, valid_k, counts


def tile_origins(hw, device):
    """(T, 2) int32 pixel origins (x, y) of the 16x16 tiles, row-major."""
    H, W = hw
    TX = W // TILE
    t = torch.arange((H // TILE) * TX, dtype=torch.int32, device=device)
    return torch.stack([(t % TX) * TILE, (t // TX) * TILE], dim=-1)


def _pixel_offsets(device):
    """(256, 2) pixel-centre offsets inside a tile, row-major."""
    p = torch.arange(TILE * TILE, device=device)
    return torch.stack([p % TILE, p // TILE], dim=-1).float() + 0.5


def tiles_to_image(px, hw):
    """(T·256, C) per-tile pixel rows → (H, W, C) image."""
    H, W = hw
    TX, TY = W // TILE, H // TILE
    C = px.shape[-1]
    img = px.reshape(TY, TX, TILE, TILE, C).permute(0, 2, 1, 3, 4)
    return img.reshape(H, W, C)


def render_tiles(means, cov_triu, colors, opa, view, K, hw, bg=None,
                 tpg_side: int = 4, k_max: int = 512, tile_chunk: int = 32):
    """Render (H, W, 3) with the plain compositor. H, W multiples of 16."""
    H, W = hw
    assert H % TILE == 0 and W % TILE == 0
    dev = means.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    means2d, conic, depth, radius, ok = project_gaussians(
        means, cov_triu, opa, view, K, hw)
    gidx, valid_k, _ = bin_tiles(means2d, depth, radius, ok, hw, tpg_side,
                                 k_max)
    attrs = torch.cat([means2d, conic, colors.float(), opa.float()[:, None]],
                      dim=-1)  # (G, 9): u v ca cb cc r g b opa
    pix_local = _pixel_offsets(dev)
    origins = tile_origins(hw, dev).float()
    T = gidx.shape[0]
    out = []
    for t0 in range(0, T, tile_chunk):
        rows = attrs[gidx[t0:t0 + tile_chunk]]  # (C, K, 9)
        vk = valid_k[t0:t0 + tile_chunk]
        pix = origins[t0:t0 + tile_chunk, None, :] + pix_local[None]
        d = pix[:, None, :, :] - rows[:, :, None, 0:2]  # (C, K, 256, 2)
        cn = rows[..., 2:5]
        power = -0.5 * (cn[:, :, None, 0] * d[..., 0] ** 2
                        + cn[:, :, None, 2] * d[..., 1] ** 2) \
            - cn[:, :, None, 1] * d[..., 0] * d[..., 1]
        alpha = torch.clamp(rows[..., 8][:, :, None] * torch.exp(power),
                            max=0.99)
        alpha = torch.where(alpha < 1.0 / 255.0, torch.zeros_like(alpha),
                            alpha) * vk[:, :, None]
        one_m = 1.0 - alpha
        trans_incl = torch.cumprod(one_m, dim=1)
        w = alpha * trans_incl / one_m  # one_m ≥ 0.01
        rgb = torch.einsum("ckp,ckd->cpd", w, rows[..., 5:8])
        rgb = rgb + trans_incl[:, -1, :, None] * bg[None, None, :]
        out.append(rgb)
    return tiles_to_image(torch.cat(out).reshape(T * TILE * TILE, 3), hw)


def render_bruteforce(means, cov_triu, colors, opa, view, K, hw, bg=None):
    """O(G·P) reference renderer (tests/small scenes only): exact global
    depth-sorted alpha compositing over every pixel."""
    H, W = hw
    dev = means.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    means2d, conic, depth, radius, ok = project_gaussians(
        means, cov_triu, opa, view, K, hw)
    order = torch.argsort(torch.where(ok, depth,
                                      torch.full_like(depth, math.inf)),
                          stable=True)
    means2d, conic = means2d[order], conic[order]
    colors, opa, ok = colors[order].float(), opa[order].float(), ok[order]
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xx, yy], -1).reshape(-1, 2) + 0.5
    d = pix[None] - means2d[:, None, :]
    power = -0.5 * (conic[:, None, 0] * d[..., 0] ** 2
                    + conic[:, None, 2] * d[..., 1] ** 2) \
        - conic[:, None, 1] * d[..., 0] * d[..., 1]
    alpha = torch.clamp(opa[:, None] * torch.exp(power), max=0.99)
    alpha = torch.where(alpha < 1.0 / 255.0, torch.zeros_like(alpha), alpha)
    alpha = alpha * ok[:, None]
    one_m = 1.0 - alpha
    trans_incl = torch.cumprod(one_m, dim=0)
    w = alpha * trans_incl / one_m
    rgb = torch.einsum("gp,gc->pc", w, colors)
    rgb = rgb + trans_incl[-1][:, None] * bg[None, :]
    return rgb.reshape(H, W, 3)


def render_bruteforce_scan(means, cov_triu, colors, opa, view, K, hw,
                           bg=None, g_chunk: int = 2048):
    """Exact compositing oracle at scale: the math of `render_bruteforce`
    (global depth sort, every gaussian against every pixel: no k_max cap,
    no tile-coverage crop), with the transmittance carried over
    depth-ordered chunks of `g_chunk` gaussians, so that memory is
    O(g_chunk·256) instead of O(G·P). Plain PyTorch: it is the reference
    the fidelity sweep holds the tile renderer to, not a path of it.

    It runs 16x16 pixel blocks one at a time and, in each, skips the
    gaussians whose alpha is below 1/255 (and so exactly zero) on every
    pixel of the block: alpha ≥ 1/255 needs ½·dᵀ·conic·d ≤ ln(255·opacity),
    an ellipse whose bounding box, grown by one pixel, is tested against
    the block. A skipped pair would multiply the transmittance by exactly
    1 and add exactly 0, so the image is the dense computation's."""
    H, W = hw
    dev = means.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    means2d, conic, depth, radius, ok = project_gaussians(
        means, cov_triu, opa, view, K, hw)
    order = torch.argsort(torch.where(ok, depth,
                                      torch.full_like(depth, math.inf)),
                          stable=True)
    opa_ok = torch.where(ok, opa.float(), torch.zeros_like(depth))
    att = torch.cat([means2d, conic, colors.float(), opa_ok[:, None]],
                    dim=-1)[order]  # (G, 9): u v ca cb cc r g b opa
    u, v, ca, cb, cc = att[:, :5].unbind(-1)
    lim = torch.log(255.0 * att[:, 8])  # -inf where the opacity is 0
    live = (lim > 0) & ok[order]
    det = torch.where(live, ca * cc - cb * cb, torch.ones_like(ca))
    lim = torch.where(live, lim, torch.zeros_like(lim))
    hx = torch.sqrt(2.0 * lim * cc / det) + 1.0
    hy = torch.sqrt(2.0 * lim * ca / det) + 1.0
    x0, x1, y0, y1 = u - hx, u + hx, v - hy, v + hy
    bgf = bg.float()
    img = torch.empty(H, W, 3, device=dev)
    for by in range(0, H, TILE):
        for bx in range(0, W, TILE):
            bh, bw = min(TILE, H - by), min(TILE, W - bx)
            # pixel centres of the block lie in [b + 0.5, b + n - 0.5]
            idx = torch.nonzero(live & (x1 >= bx + 0.5) & (x0 <= bx + bw - 0.5)
                                & (y1 >= by + 0.5) & (y0 <= by + bh - 0.5)
                                )[:, 0]
            yy, xx = torch.meshgrid(
                torch.arange(by, by + bh, dtype=torch.float32, device=dev),
                torch.arange(bx, bx + bw, dtype=torch.float32, device=dev),
                indexing="ij")
            px = xx.reshape(1, -1) + 0.5
            py = yy.reshape(1, -1) + 0.5
            rgb = torch.zeros(bh * bw, 3, device=dev)
            trans = torch.ones(bh * bw, device=dev)
            for g0 in range(0, idx.shape[0], g_chunk):
                rows = att[idx[g0:g0 + g_chunk]]
                du = px - rows[:, 0:1]  # (Gc, P)
                dv = py - rows[:, 1:2]
                power = -0.5 * (rows[:, 2:3] * du * du
                                + rows[:, 4:5] * dv * dv) \
                    - rows[:, 3:4] * du * dv
                alpha = torch.clamp(rows[:, 8:9] * torch.exp(power),
                                    max=0.99)
                alpha = torch.where(alpha < 1.0 / 255.0,
                                    torch.zeros_like(alpha), alpha)
                one_m = 1.0 - alpha
                ti = torch.cumprod(one_m, dim=0)  # within-chunk inclusive
                w = alpha * (ti / one_m) * trans[None, :]
                rgb = rgb + torch.einsum("gp,gc->pc", w, rows[:, 5:8])
                trans = trans * ti[-1]
            img[by:by + bh, bx:bx + bw] = (
                rgb + trans[:, None] * bgf[None, :]).reshape(bh, bw, 3)
    return img
