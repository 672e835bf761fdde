"""Training export callbacks: batch visual dumps + Gaussian PLY export.

Counterpart of `splatt3r_slam_tpu/parallel/export.py`: periodic dumps of
(context, target, rendered) image grids, and `save_as_ply` for predicted
Gaussians in the standard 3DGS PLY layout. PNGs are written by
`utils/image.py::write_png` (zlib + struct), so no image package is needed.
"""

from __future__ import annotations

import pathlib

import numpy as np

from splatt3r_slam_tpu_torch.utils.image import write_png


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_batch_visuals(out_dir, step: int, batch: dict, rendered):
    """Dump a side-by-side grid: context pair, target gt, render."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def u8(x):
        return (np.clip(_np(x), 0, 1) * 255).astype(np.uint8)

    img1 = u8(_np(batch["img1"])[0] * 0.5 + 0.5)
    img2 = u8(_np(batch["img2"])[0] * 0.5 + 0.5)
    gt = u8(_np(batch["target_img"])[0, 0])
    rd = u8(_np(rendered)[0, 0])
    grid = np.concatenate(
        [np.concatenate([img1, img2], axis=1),
         np.concatenate([gt, rd], axis=1)], axis=0)
    write_png(out_dir / f"step_{step:07d}.png", grid)


def save_as_ply(path, means, scales, rotations, sh, opacities):
    """Standard 3DGS PLY: x y z, f_dc_*, opacity(logit), scale_*(log),
    rot_* (wxyz)."""
    means = _np(means).reshape(-1, 3)
    scales = _np(scales).reshape(-1, 3)
    rot = _np(rotations).reshape(-1, 4)  # xyzw internal
    sh = _np(sh)
    sh0 = sh.reshape(-1, 3, sh.shape[-1])[:, :, 0]
    opa = _np(opacities).reshape(-1)
    n = len(means)

    eps = 1e-8
    log_scales = np.log(np.maximum(scales, eps))
    logit_opa = np.log(np.clip(opa, eps, 1 - eps) /
                       (1 - np.clip(opa, eps, 1 - eps)))
    rot_wxyz = np.concatenate([rot[:, 3:4], rot[:, :3]], axis=1)

    names = (["x", "y", "z"]
             + [f"f_dc_{i}" for i in range(3)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    rec = np.zeros(n, dtype=[(nm, "<f4") for nm in names])
    rec["x"], rec["y"], rec["z"] = means.T
    for i in range(3):
        rec[f"f_dc_{i}"] = sh0[:, i]
    rec["opacity"] = logit_opa
    for i in range(3):
        rec[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        rec[f"rot_{i}"] = rot_wxyz[:, i]

    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {nm}\n" for nm in names)
              + "end_header\n").encode("ascii")
    if hasattr(path, "write"):  # file-like
        path.write(header)
        path.write(rec.tobytes())
        return
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())
