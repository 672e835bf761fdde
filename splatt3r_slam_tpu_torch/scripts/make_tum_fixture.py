"""Generate a TUM-format fixture sequence (a synthetic box room).

    python -m splatt3r_slam_tpu_torch.scripts.make_tum_fixture [--out DIR]
        [--frames N] [--device cuda|cpu]

Counterpart of the repository's `scripts/make_tum_fixture.py`: the exact
on-disk layout the TUM loader parses (`rgb/` PNG frames, `rgb.txt`
timestamp → file index, `groundtruth.txt` TUM trajectory), so that the
eval protocol (the CLI with `--no-viz`, then `scripts.compute_ate`) runs
end to end without the real TUM download. The default `--out` is the
committed fixture, tests/fixtures/tum/rgbd_dataset_freiburg1_fixture.

Scene: the textured interior of an axis-aligned box, rendered by exact
ray/plane intersection with smooth multi-octave sinusoid textures;
camera: a smooth sideways arc with yaw, returning toward the start (a loop
closure opportunity). The renderer is the JAX script's numpy, so the
pixels and both text files are the same; the PNGs are written with
`utils/image.py::write_png` (zlib, no cv2), so their bytes may differ from
cv2's. The work is host numpy; like every entry point of the port it asks
for the device first (CUDA unless `--device cpu` is given, raising without
a GPU). Prints the result as JSON.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

# fr1 factory pinhole at half resolution (same FOV as 640x480, no
# distortion applied to the synthetic render): the loader's intrinsics
# rescale is aspect-relative, so a 320x240 frame resized to the working
# crop lands on the same geometry as a real 640x480 fr1 frame, at a
# quarter of the committed bytes.
FX, FY, CX, CY = 517.3 / 2, 516.5 / 2, 318.6 / 2, 255.3 / 2
W, H = 320, 240

# box interior: x in [-2,2], y in [-1.5,1.5], z in [-1,7]; the camera
# starts near the origin looking +z
BOX_LO = np.array([-2.0, -1.5, -1.0])
BOX_HI = np.array([2.0, 1.5, 7.0])


def texture(face_id: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Smooth per-face RGB texture in [0,1]; (..., 3)."""
    rng = np.random.default_rng(100 + face_id)
    img = np.zeros(u.shape + (3,), np.float32)
    for c in range(3):
        acc = np.zeros_like(u)
        for octave in range(3):
            fu, fv = rng.uniform(0.5, 2.5, 2) * (2.0**octave)
            pu, pv = rng.uniform(0, 2 * np.pi, 2)
            acc += np.sin(fu * u + pu) * np.cos(fv * v + pv) / (2.0**octave)
        img[..., c] = acc
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return 0.15 + 0.7 * img


def render(T_WC: np.ndarray) -> np.ndarray:
    """Render the box interior from a 4x4 camera-to-world pose."""
    uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    rays_c = np.stack(
        [(uu - CX) / FX, (vv - CY) / FY, np.ones_like(uu)], axis=-1
    )
    rays_w = rays_c @ T_WC[:3, :3].T
    origin = T_WC[:3, 3]

    best_t = np.full((H, W), np.inf)
    img = np.zeros((H, W, 3), np.float32)
    # 6 axis-aligned faces: (axis, plane coordinate, face id)
    faces = [(a, BOX_LO[a], 2 * a) for a in range(3)] + [
        (a, BOX_HI[a], 2 * a + 1) for a in range(3)
    ]
    for axis, coord, fid in faces:
        d = rays_w[..., axis]
        t = np.where(np.abs(d) > 1e-9, (coord - origin[axis]) / d, np.inf)
        hit = t > 1e-3
        p = origin + rays_w * t[..., None]
        oa, ob = [a for a in range(3) if a != axis]
        inside = (
            (p[..., oa] >= BOX_LO[oa] - 1e-6)
            & (p[..., oa] <= BOX_HI[oa] + 1e-6)
            & (p[..., ob] >= BOX_LO[ob] - 1e-6)
            & (p[..., ob] <= BOX_HI[ob] + 1e-6)
        )
        closer = hit & inside & (t < best_t)
        if not closer.any():
            continue
        tex = texture(fid, p[..., oa] * 2.2, p[..., ob] * 2.2)
        img[closer] = tex[closer]
        best_t[closer] = t[closer]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def yaw_pose(x: float, z: float, yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[:3, 3] = [x, 0.0, z]
    return T


def rot_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    tr = np.trace(R)
    if tr > 0:
        S = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [
                (R[2, 1] - R[1, 2]) / S,
                (R[0, 2] - R[2, 0]) / S,
                (R[1, 0] - R[0, 1]) / S,
                0.25 * S,
            ]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        S = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[i] = 0.25 * S
        q[j] = (R[j, i] + R[i, j]) / S
        q[k] = (R[k, i] + R[i, k]) / S
        q[3] = (R[k, j] - R[j, k]) / S
    return q / np.linalg.norm(q)


def main(argv=None) -> dict:
    """Write the fixture; returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm
    from splatt3r_slam_tpu_torch.utils.image import write_png

    p = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.make_tum_fixture",
        description=__doc__.split("\n")[0])
    p.add_argument(
        "--out",
        default="tests/fixtures/tum/rgbd_dataset_freiburg1_fixture",
    )
    p.add_argument("--frames", type=int, default=24)
    cm.add_device_args(p, tiny=False)
    args = p.parse_args(argv)
    cm.setup(args)

    out = pathlib.Path(args.out)
    (out / "rgb").mkdir(parents=True, exist_ok=True)

    n = args.frames
    rgb_lines = ["# color images", "# fixture: synthetic box room",
                 "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# fixture: synthetic box room",
                "# timestamp tx ty tz qx qy qz qw"]
    for i in range(n):
        s = i / max(n - 1, 1)
        # out-and-back arc: sideways translation + yaw, returning near the
        # start so retrieval sees a revisit
        x = 0.8 * np.sin(np.pi * s)
        z = 0.4 * np.sin(2 * np.pi * s)
        yaw = 0.35 * np.sin(np.pi * s)
        T = yaw_pose(x, z, yaw)
        img = render(T)
        ts = 1000.0 + i / 30.0
        name = f"rgb/{ts:.6f}.png"
        write_png(out / name, img)
        rgb_lines.append(f"{ts:.6f} {name}")
        q = rot_to_quat_xyzw(T[:3, :3])
        t = T[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    (out / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (out / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    res = {"out": str(out), "frames": n}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
