"""Tile rasterizer benchmark: the plain renderer against the CUDA kernel.

    python -m splatt3r_slam_tpu_torch.scripts.bench_rasterizer
        [--device cuda|cpu] [--tiny]

Counterpart of the repository's `scripts/bench_rasterizer.py`, at the
production gaussian counts (400k, 1M and 4M; the SLAM pool reaches about
4.2M, a two-view render about 393k at 512x384), 384x512, tpg_side 4,
k_max 512. Per count it times `rasterizer.render_tiles` (the plain
PyTorch compositor, `plain_ms`; the JAX script's XLA column) and
`cuda_rasterizer.render_tiles_cuda` (the hand-written forward kernel
`csrc/composite.cu`, `cuda_ms`; its Pallas column), five calls each after
one warm-up (`_common.time_calls`: device time on the card, the JAX
script's chained dispatch), and prints the largest absolute
difference of the two images (`max_abs_diff`). That difference is not the
kernel's error: the plain renderer evaluates the quadratic as a·du² where
the kernel takes (a·du)·du, which can move a frame by ~2e-4; the kernel
against its own plain version is held in `chip_smoke.py`. On the card each
row also carries the peak device memory of the two renders (`peak_mib`):
at 4M gaussians the binning sorts up to 64M (tile, gaussian) pairs.

An error in one column (out of memory, say) is printed in its place, as
the JAX script prints it. Runs on CUDA unless `--device cpu` is given and
raises without a GPU; `--tiny` (implied on the CPU) renders 4,000 gaussians
at 64x96. The last line of stdout is the result as JSON: {"<count>": row,
..., "device", "power_limit_w"}.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

HW = (384, 512)
COUNTS = (400_000, 1_000_000, 4_000_000)
TINY_HW = (64, 96)
TINY_COUNTS = (4_000,)
ITERS = 5


def make_scene(g, seed=0, hw=HW):
    """The JAX script's seeded scene, in numpy: `g` isotropic gaussians in
    a frustum-shaped box in front of an identity camera of focal 500 →
    (means, cov_triu, colors, opa, view, K)."""
    rng = np.random.default_rng(seed)
    # camera at origin looking +z; gaussians in a frustum-ish box
    means = np.stack(
        [
            rng.uniform(-2.0, 2.0, g),
            rng.uniform(-1.5, 1.5, g),
            rng.uniform(0.5, 6.0, g),
        ],
        axis=-1,
    ).astype(np.float32)
    s = rng.uniform(0.003, 0.02, (g, 1)).astype(np.float32)
    cov = np.zeros((g, 6), np.float32)
    cov[:, 0] = s[:, 0] ** 2
    cov[:, 3] = s[:, 0] ** 2
    cov[:, 5] = s[:, 0] ** 2
    colors = rng.uniform(0, 1, (g, 3)).astype(np.float32)
    opa = rng.uniform(0.3, 1.0, g).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    K = np.array(
        [[500.0, 0, hw[1] / 2], [0, 500.0, hw[0] / 2], [0, 0, 1]], np.float32
    )
    return means, cov, colors, opa, view, K


def scene_tensors(g, device, seed=0, hw=HW):
    """`make_scene` as tensors on `device`."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in make_scene(g, seed, hw))


def main(argv=None) -> dict:
    """Run the benchmark; returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm
    from splatt3r_slam_tpu_torch.splat.cuda_rasterizer import (
        render_tiles_cuda,
    )
    from splatt3r_slam_tpu_torch.splat.rasterizer import render_tiles

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.bench_rasterizer",
        description=__doc__.split("\n")[0])
    cm.add_device_args(ap)
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)
    hw, counts = (TINY_HW, TINY_COUNTS) if tiny else (HW, COUNTS)
    cuda = device.type == "cuda"

    results: dict = {}
    for g in counts:
        scene = scene_tensors(g, device, hw=hw)
        row: dict = {}
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        imgs = {}
        for key, render in (("plain_ms", render_tiles),
                            ("cuda_ms", render_tiles_cuda)):
            try:
                with torch.no_grad():
                    ms, imgs[key] = cm.time_calls(
                        lambda: render(*scene, hw, tpg_side=4, k_max=512),
                        device, ITERS)
                row[key] = round(ms, 2)
            except (RuntimeError, MemoryError) as e:  # out of memory etc.
                row[key] = f"ERR {type(e).__name__}"
        if len(imgs) == 2:
            row["max_abs_diff"] = float(
                (imgs["plain_ms"] - imgs["cuda_ms"]).abs().max())
        if cuda:
            row["peak_mib"] = round(
                torch.cuda.max_memory_allocated(device) / 2**20, 1)
        del scene, imgs
        results[str(g)] = row
        print(g, row, file=sys.stderr)
    out = {**results, **cm.device_fields(device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
