"""Rasterizer fidelity sweep: the tile renderer against the exact oracle.

    python -m splatt3r_slam_tpu_torch.scripts.sweep_rasterizer_fidelity
        [--device cuda|cpu] [--quick] [--out FILE]

Counterpart of the repository's `scripts/sweep_rasterizer_fidelity.py`:
PSNR, SSIM and the largest absolute difference of the production tile
renderer at k_max ∈ {128, 256, 512, 1024} and tpg_side ∈ {2, 4, 8} against
the exact compositing oracle (`rasterizer.render_bruteforce_scan`: no
depth cap, no coverage crop), on seeded random scenes of 30k, 150k and
600k gaussians rendered at 192x256, whose gaussians per tile span the
production range. The renderer is the one the SLAM run uses on the device:
the hand-written CUDA compositor (`render_tiles_cuda`) on the card, the
plain compositor (`render_tiles`) on the CPU. `--quick` runs one scene of
30k at tpg_side 4 and k_max 128. Each row is printed as it is measured;
the last line of stdout is the result as JSON, written to `--out` too
when given. It runs on CUDA unless `--device cpu` is given, and raises
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

HW = (192, 256)
FOCAL = 200.0
SCENES = (30_000, 150_000, 600_000)
K_MAXES = (128, 256, 512, 1024)
TPG_SIDES = (2, 4, 8)


def make_scene(G, device, seed=0, spread=3.0):
    """A seeded SLAM-like cloud in front of the camera, drawn as the JAX
    script draws it: positions filling the frustum, anisotropic scales,
    random orientations and opacities → (means, cov_triu, colors, opa)."""
    from splatt3r_slam_tpu_torch.splat.gaussians import (
        build_covariance,
        cov_to_triu,
    )

    rng = np.random.default_rng(seed)
    means = np.empty((G, 3), np.float32)
    means[:, 2] = 1.5 + 6.0 * rng.random(G)
    means[:, 0] = (rng.random(G) - 0.5) * spread * means[:, 2]
    means[:, 1] = (rng.random(G) - 0.5) * spread * 0.75 * means[:, 2]
    scales = (0.004 + 0.02 * rng.random((G, 3))).astype(np.float32) \
        * means[:, 2:3]
    q = rng.normal(size=(G, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    colors = rng.random((G, 3)).astype(np.float32)
    opa = (0.2 + 0.8 * rng.random(G)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=device)

    covt = cov_to_triu(build_covariance(t(scales), t(q)))
    return t(means), covt, t(colors), t(opa)


def camera(device):
    """(view, K) of the sweep: identity pose, focal 200 at 192x256."""
    K = torch.tensor([[FOCAL, 0, HW[1] / 2], [0, FOCAL, HW[0] / 2],
                      [0, 0, 1]], device=device)
    return torch.eye(4, device=device), K


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse < 1e-12 else float(10 * np.log10(1.0 / mse))


def main(argv=None) -> dict:
    """Run the sweep; returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts."
             "sweep_rasterizer_fidelity",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; asking for cuda "
                         "without a GPU raises)")
    ap.add_argument("--quick", action="store_true",
                    help="one scene of 30k at tpg_side 4, k_max 128")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    from splatt3r_slam_tpu_torch import resolve_device, set_fp32_precision
    from splatt3r_slam_tpu_torch.splat.decoder import _rasterizer
    from splatt3r_slam_tpu_torch.splat.rasterizer import (
        render_bruteforce_scan,
    )
    from splatt3r_slam_tpu_torch.utils.metrics import ssim_mean

    set_fp32_precision()
    device = resolve_device(args.device)
    view, K = camera(device)
    scenes = SCENES[:1] if args.quick else SCENES
    kms = (128,) if args.quick else K_MAXES
    tpgs = (4,) if args.quick else TPG_SIDES

    results = []
    for G in scenes:
        means, covt, colors, opa = make_scene(G, device)
        render = _rasterizer("auto", means)
        exact_t = torch.clamp(render_bruteforce_scan(
            means, covt, colors, opa, view, K, HW), 0, 1)
        exact = exact_t.cpu().numpy()
        for tpg in tpgs:
            for km in kms:
                img_t = torch.clamp(render(means, covt, colors, opa, view,
                                           K, HW, tpg_side=tpg, k_max=km),
                                    0, 1)
                img = img_t.cpu().numpy()
                r = dict(G=G, tpg_side=tpg, k_max=km,
                         psnr=round(psnr(img, exact), 2),
                         ssim=round(float(ssim_mean(img_t, exact_t)), 4),
                         max_abs=round(float(np.abs(img - exact).max()), 4))
                results.append(r)
                print(json.dumps(r))
    out = {"hw": list(HW), "scenes": list(scenes), "results": results,
           **cm.device_fields(device)}
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
