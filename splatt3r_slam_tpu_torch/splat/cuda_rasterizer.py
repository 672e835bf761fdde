"""Hand-written CUDA tile compositor and its wrapper.

Counterpart of `splatt3r_slam_tpu/splat/pallas_rasterizer.py` (forward):
the kernel `csrc/composite.cu` replaces the TPU kernel `_composite_kernel`
(see the note at the top of that source for what bounds it and how the
design answers). Binning is shared with the plain compositor
(`rasterizer.bin_tiles`); rows are packed row-major as (T·k_max, 9)
[u v conic_a conic_b conic_c opacity r g b] — the TPU's transposed
(16, T·k_max) layout existed only for Mosaic's (8, 128) tiling.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C interface at first use (`build`), into `splatt3r_slam_tpu_torch/
_build/`, and loaded with ctypes. `composite` launches it for CUDA tensors
(and raises on failure) and runs the plain PyTorch version
`composite_torch` for CPU tensors; there is no fallback from one to the
other. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch
from torch.profiler import record_function

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
_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "composite.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0  # kernel launches made by `composite`
_fn = None


def _nvcc() -> str:
    for c in (os.environ.get("NVCC"), shutil.which("nvcc"),
              "/usr/local/cuda/bin/nvcc"):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (needs the CUDA toolkit, sm_90a)")


def build() -> tuple[pathlib.Path, str]:
    """Compile composite.cu (once per source hash) → (library, ptxas log)."""
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"libcomposite_{hashlib.sha256(src).hexdigest()[:12]}.so"
    log = so.with_suffix(".log")
    if so.exists():
        return so, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    log.write_text(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so, r.stdout + r.stderr


def _load():
    global _fn
    if _fn is None:
        so, _ = build()
        fn = ctypes.CDLL(str(so)).composite_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def composite_torch(counts, origins, rows, bg, tile_chunk: int = 32):
    """Plain PyTorch version of the kernel: per-tile exclusive cumulative
    product over the depth axis. Same arguments and output as
    `composite`: counts (T,) int32, origins (T, 2) int32, rows
    (T·k_max, 9) f32, bg (3,) f32 → (T·256, 4) f32 [rgb + T·bg, T]."""
    T = counts.shape[0]
    k_max = rows.shape[0] // max(T, 1)
    R = rows.reshape(T, k_max, ROWF)
    pix_local = _pixel_offsets(rows.device)
    kk = torch.arange(k_max, device=rows.device)
    out = []
    for t0 in range(0, T, tile_chunk):
        r = R[t0:t0 + tile_chunk]
        pix = origins[t0:t0 + tile_chunk, None, :].float() + pix_local[None]
        du = pix[:, None, :, 0] - r[:, :, None, 0]  # (C, K, 256)
        dv = pix[:, None, :, 1] - r[:, :, None, 1]
        power = -0.5 * (r[:, :, None, 2] * du * du
                        + r[:, :, None, 4] * dv * dv) \
            - r[:, :, None, 3] * du * dv
        alpha = torch.clamp(r[:, :, None, 5] * torch.exp(power), max=0.99)
        alpha = torch.where(alpha < 1.0 / 255.0, torch.zeros_like(alpha),
                            alpha)
        live = kk[None, :] < counts[t0:t0 + tile_chunk, None]
        alpha = alpha * live[:, :, None]
        incl = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        rgb = torch.einsum("ckp,ckd->cpd", alpha * excl, r[..., 6:9])
        t_final = incl[:, -1, :, None]
        out.append(torch.cat([rgb + t_final * bg, t_final], dim=-1))
    return torch.cat(out).reshape(T * NPIX, 4)


def composite(counts, origins, rows, bg):
    """Tile compositor: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Arguments as `composite_torch`."""
    if not rows.is_cuda:
        return composite_torch(counts, origins, rows, bg)
    T = counts.shape[0]
    dev = rows.device
    for name, t, dt, shape in (("counts", counts, torch.int32, (T,)),
                               ("origins", origins, torch.int32, (T, 2)),
                               ("bg", bg, torch.float32, (3,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"composite: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if rows.dtype != torch.float32 or rows.dim() != 2 or \
            rows.shape[1] != ROWF or T == 0 or rows.shape[0] % T != 0 or \
            not rows.is_contiguous():
        raise ValueError("composite: rows must be a contiguous float32 "
                         f"(T·k_max, {ROWF}) tensor, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    k_max = rows.shape[0] // T
    out = torch.empty((T * NPIX, 4), dtype=torch.float32, device=dev)
    fn = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(counts.data_ptr(), origins.data_ptr(), rows.data_ptr(),
                 bg.data_ptr(), out.data_ptr(), T, k_max, stream)
    if err != 0:
        raise RuntimeError(f"composite kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


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
    """Render (H, W, 3) through `composite`; binning as `render_tiles`."""
    if bg is None:
        bg = torch.zeros(3, device=means.device)
    with record_function("port.render.project_bin"):
        counts, origins, rows = pack_rows(means, cov_triu, colors, opa, view,
                                          K, hw, tpg_side, k_max)
    with record_function("port.render.composite"):
        out = composite(counts, origins, rows,
                        bg.to(device=means.device, dtype=torch.float32)
                        .contiguous())
    return tiles_to_image(out[:, :3], hw)
