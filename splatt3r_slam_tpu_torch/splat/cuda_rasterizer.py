"""Hand-written CUDA tile compositor (forward and backward) and its wrappers.

Counterpart of `splatt3r_slam_tpu/splat/pallas_rasterizer.py`: the kernel
`csrc/composite.cu` replaces the TPU kernel `_composite_kernel`, and
`csrc/composite_bwd.cu` replaces `_composite_bwd_kernel` (see the note at
the top of each source for what bounds it and how the design answers).
`Composite` is the `torch.autograd.Function` over the two, the counterpart
of the JAX package's custom VJP `_composite`, so one function
(`render_tiles_cuda`) serves rendering and the render-loss training step.
Binning is shared with the plain compositor (`rasterizer.bin_tiles`); rows
are packed row-major as (T·k_max, 9) [u v conic_a conic_b conic_c opacity
r g b], and the gradient rows have the same layout — the TPU's transposed
(16, T·k_max) layout existed only for Mosaic's (8, 128) tiling.

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface at first use (`cuda_build.build`, one nvcc per source,
started together), into `splatt3r_slam_tpu_torch/_build/`, and loaded with
ctypes.
Both sources include `csrc/composite_common.cuh` (the staging ring and the
one evaluation of alpha), so a library's name carries a hash of its source,
of every header beside it and of the compiler flags. `composite` /
`composite_bwd` launch the kernels for CUDA tensors (and raise on failure)
and run the plain PyTorch versions `composite_torch` /
`composite_bwd_torch` for CPU tensors; there is no fallback from one to the
other. Any `k_max` is taken: inside the forward's library the launcher
picks the staging by what it is given, 16-byte copies where every tile's
rows are 16-byte aligned (`k_max % 4 == 0`) and element-wise copies of the
same kernel otherwise; the backward stages element-wise throughout.
`launches` and `bwd_launches` count kernel launches.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from splatt3r_slam_tpu_torch import cuda_build
from splatt3r_slam_tpu_torch.cuda_build import (  # noqa: F401
    BUILD_DIR,
    NVCC_FLAGS,
    _digest,
    _entry,
    _nvcc,
)
from splatt3r_slam_tpu_torch.splat.rasterizer import (
    TILE,
    _pixel_offsets,
    bin_tiles,
    project_gaussians,
    tile_origins,
    tiles_to_image,
)

NPIX = TILE * TILE
ROWF = 9  # u v ca cb cc opa r g b
# the compositor's kernels: name → (source, C entry point, argument types)
KERNELS = {name: cuda_build.KERNELS[name]
           for name in ("composite", "composite_bwd")}

launches = 0  # kernel launches made by `composite`
bwd_launches = 0  # kernel launches made by `composite_bwd`


def _check(who, dev, specs):
    """Raise unless every (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on `dev`."""
    for name, t, dt, shape in specs:
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_rows(who, rows, T):
    if rows.dtype != torch.float32 or rows.dim() != 2 or \
            rows.shape[1] != ROWF or T == 0 or rows.shape[0] % T != 0 or \
            not rows.is_contiguous():
        raise ValueError(f"{who}: rows must be a contiguous float32 "
                         f"(T·k_max, {ROWF}) tensor, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    return rows.shape[0] // T


def _alpha_terms(R, origins, counts, pix_local, kk):
    """The compositor's per-(tile, row, pixel) terms for a slab of tiles,
    in the kernels' own expression: (du, dv, expp, raw, alpha, live, r).
    r is R with the rows at and beyond each tile's count set to zero: the
    kernels never read those rows, so whatever they hold (a huge conic
    whose power overflows to NaN) must not reach a sum."""
    live = (kk[None, :] < counts[:, None])[:, :, None]
    r = torch.where(live, R, torch.zeros_like(R))
    pix = origins[:, None, :].float() + pix_local[None]
    du = pix[:, None, :, 0] - r[:, :, None, 0]  # (C, K, 256)
    dv = pix[:, None, :, 1] - r[:, :, None, 1]
    power = -0.5 * (r[:, :, None, 2] * du * du
                    + r[:, :, None, 4] * dv * dv) \
        - r[:, :, None, 3] * du * dv
    expp = torch.exp(power)
    raw = r[:, :, None, 5] * expp
    alpha = torch.clamp(raw, max=0.99)
    alpha = torch.where(alpha < 1.0 / 255.0, torch.zeros_like(alpha), alpha)
    return du, dv, expp, raw, alpha, live, r


def composite_torch(counts, origins, rows, bg, tile_chunk: int = 32):
    """Plain PyTorch version of the forward kernel: per-tile exclusive
    cumulative product over the depth axis. Same arguments and output as
    `composite`: counts (T,) int32, origins (T, 2) int32, rows
    (T·k_max, 9) f32, bg (3,) f32 → (T·256, 4) f32 [rgb + T·bg, T]."""
    T = counts.shape[0]
    k_max = rows.shape[0] // max(T, 1)
    R = rows.reshape(T, k_max, ROWF)
    pix_local = _pixel_offsets(rows.device)
    kk = torch.arange(k_max, device=rows.device)
    out = []
    for t0 in range(0, T, tile_chunk):
        alpha, _, r = _alpha_terms(
            R[t0:t0 + tile_chunk], origins[t0:t0 + tile_chunk],
            counts[t0:t0 + tile_chunk], pix_local, kk)[4:]
        incl = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        rgb = torch.einsum("ckp,ckd->cpd", alpha * excl, r[..., 6:9])
        t_final = incl[:, -1, :, None]
        out.append(torch.cat([rgb + t_final * bg, t_final], dim=-1))
    return torch.cat(out).reshape(T * NPIX, 4)


def composite_bwd_torch(counts, origins, rows, gout, out,
                        tile_chunk: int = 32):
    """Plain PyTorch version of the backward kernel, its arithmetic written
    out (no autograd): counts, origins, rows as `composite_torch`; gout,
    out (T·256, 4) the output cotangent and the saved forward output →
    grows (T·k_max, 9), zero at and beyond each tile's count.

    Per pixel, with D = gout·out and front-to-back carries T_i (exclusive
    transmittance) and A_i = Σ_{j≤i} (g_rgb·c_j)·α_j·T_j:
    dL/dα_i = (g_rgb·c_i)·T_i − (D − A_i)/(1 − α_i), chained through
    α = min(0.99, opacity·e^power) only where 1/255 ≤ opacity·e^power < 0.99,
    and each row's nine partials are summed over the tile's 256 pixels."""
    T = counts.shape[0]
    k_max = rows.shape[0] // max(T, 1)
    R = rows.reshape(T, k_max, ROWF)
    G = gout.reshape(T, NPIX, 4)
    O = out.reshape(T, NPIX, 4)
    pix_local = _pixel_offsets(rows.device)
    kk = torch.arange(k_max, device=rows.device)
    grows = []
    for t0 in range(0, T, tile_chunk):
        du, dv, expp, raw, alpha, live, r = _alpha_terms(
            R[t0:t0 + tile_chunk], origins[t0:t0 + tile_chunk],
            counts[t0:t0 + tile_chunk], pix_local, kk)
        one_m = 1.0 - alpha
        incl = torch.cumprod(one_m, dim=1)
        t_excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]],
                           dim=1)
        w = alpha * t_excl  # (C, K, 256)
        g = G[t0:t0 + tile_chunk]
        g_rgb = g[..., :3]  # (C, 256, 3)
        D = (g * O[t0:t0 + tile_chunk]).sum(-1)  # (C, 256)
        gc = torch.einsum("cpd,ckd->ckp", g_rgb, r[..., 6:9])
        a_incl = torch.cumsum(gc * w, dim=1)
        d_alpha = gc * t_excl - (D[:, None, :] - a_incl) / one_m
        active = (raw < 0.99) & (raw >= 1.0 / 255.0) & live
        zero = torch.zeros_like(d_alpha)
        pg = torch.where(active, d_alpha * alpha, zero)  # dL/dpower
        ca, cb, cc = (r[:, :, None, i] for i in (2, 3, 4))
        grows.append(torch.cat([
            torch.stack([
                (pg * (ca * du + cb * dv)).sum(-1),
                (pg * (cc * dv + cb * du)).sum(-1),
                (pg * (-0.5 * du * du)).sum(-1),
                (pg * (-du * dv)).sum(-1),
                (pg * (-0.5 * dv * dv)).sum(-1),
                torch.where(active, d_alpha * expp, zero).sum(-1),
            ], dim=-1),
            torch.einsum("cpd,ckp->ckd", g_rgb, w),
        ], dim=-1))  # (C, K, 9)
    return torch.cat(grows).reshape(T * k_max, ROWF)


def _plain_tensors(who, **tensors):
    """Raise unless every tensor is a plain local one: a DTensor (a
    sharded model's activation) takes neither the kernel nor the plain
    path."""
    for name, t in tensors.items():
        if isinstance(t, DTensor):
            raise TypeError(f"{who}: {name} is a DTensor; the compositor "
                            "takes plain local tensors")


def composite(counts, origins, rows, bg):
    """Tile compositor: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Arguments as `composite_torch`; raises
    ValueError on any other dtype, shape, device or a non-contiguous
    tensor, TypeError on a DTensor. Returns a tensor with no graph;
    `Composite` is the differentiable form."""
    _plain_tensors("composite", counts=counts, origins=origins, rows=rows,
                   bg=bg)
    T = counts.shape[0]
    dev = rows.device
    _check("composite", dev, (("counts", counts, torch.int32, (T,)),
                              ("origins", origins, torch.int32, (T, 2)),
                              ("bg", bg, torch.float32, (3,))))
    k_max = _check_rows("composite", rows, T)
    if not rows.is_cuda:
        return composite_torch(counts, origins, rows, bg)
    out = torch.empty((T * NPIX, 4), dtype=torch.float32, device=dev)
    cuda_build.launch("composite", dev, counts.data_ptr(),
                      origins.data_ptr(), rows.data_ptr(), bg.data_ptr(),
                      out.data_ptr(), T, k_max)
    global launches
    launches += 1
    return out


def composite_bwd(counts, origins, rows, gout, out):
    """Backward tile compositor: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Arguments as `composite_bwd_torch`,
    checked as `composite` checks its own."""
    _plain_tensors("composite_bwd", counts=counts, origins=origins,
                   rows=rows, gout=gout, out=out)
    T = counts.shape[0]
    dev = rows.device
    _check("composite_bwd", dev,
           (("counts", counts, torch.int32, (T,)),
            ("origins", origins, torch.int32, (T, 2)),
            ("gout", gout, torch.float32, (T * NPIX, 4)),
            ("out", out, torch.float32, (T * NPIX, 4))))
    k_max = _check_rows("composite_bwd", rows, T)
    if not rows.is_cuda:
        return composite_bwd_torch(counts, origins, rows, gout, out)
    # the kernel writes every row of every tile, zeros at and beyond each
    # tile's count (through pack_rows' gather they scatter into real
    # gaussians)
    grows = torch.empty_like(rows)
    cuda_build.launch("composite_bwd", dev, counts.data_ptr(),
                      origins.data_ptr(), rows.data_ptr(), gout.data_ptr(),
                      out.data_ptr(), grows.data_ptr(), T, k_max)
    global bwd_launches
    bwd_launches += 1
    return grows


class Composite(torch.autograd.Function):
    """Differentiable tile compositor: `composite` forward, `composite_bwd`
    backward. Gradients go to rows and bg; the gather that built rows and
    the projection are left to autograd outside this boundary."""

    @staticmethod
    def forward(ctx, counts, origins, rows, bg):
        out = composite(counts, origins, rows, bg)
        ctx.save_for_backward(counts, origins, rows, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        counts, origins, rows, out = ctx.saved_tensors
        # gout arrives as a view (the image's permute, column 3 untouched)
        gout = gout.contiguous()
        grows = composite_bwd(counts, origins, rows, gout, out)
        # rgb += T_final·bg per pixel ⇒ d_bg = Σ_p g_rgb·T_final
        d_bg = (gout[:, :3] * out[:, 3:4]).sum(0)
        return None, None, grows, d_bg


def pack_rows(means, cov_triu, colors, opa, view, K, hw, tpg_side=4,
              k_max=512):
    """Project + bin → the compositor's (counts, origins, rows) inputs."""
    means2d, conic, depth, radius, ok = project_gaussians(
        means, cov_triu, opa, view, K, hw)
    opa_m = torch.where(ok, opa.float(), torch.zeros_like(means2d[:, 0]))
    gidx, _, counts = bin_tiles(means2d, depth, radius, ok, hw, tpg_side,
                                k_max)
    packed = torch.cat([means2d, conic, opa_m[:, None], colors.float()],
                       dim=-1)  # (G, 9) in kernel order
    rows = packed[gidx.reshape(-1)].contiguous()
    return counts, tile_origins(hw, means.device), rows


def render_tiles_cuda(means, cov_triu, colors, opa, view, K, hw, bg=None,
                      tpg_side: int = 4, k_max: int = 512):
    """Render (H, W, 3) through `Composite` (differentiable in means,
    cov_triu, colors, opa and bg); binning as `render_tiles`."""
    if bg is None:
        bg = torch.zeros(3, device=means.device)
    with record_function("port.render.project_bin"):
        counts, origins, rows = pack_rows(means, cov_triu, colors, opa, view,
                                          K, hw, tpg_side, k_max)
    with record_function("port.render.composite"):
        out = Composite.apply(counts, origins, rows,
                              bg.to(device=means.device, dtype=torch.float32)
                              .contiguous())
    return tiles_to_image(out[:, :3], hw)
