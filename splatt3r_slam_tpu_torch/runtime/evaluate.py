"""Result export + trajectory evaluation.

Counterpart of `splatt3r_slam_tpu/runtime/evaluate.py`: the TUM trajectory
(scale dropped from Sim(3)), the confidence-thresholded PLY point cloud,
keyframe PNGs, and ATE RMSE after Sim(3) (Umeyama) alignment, the metric
`evo_ape tum <gt> <est> -as` computes. Host numpy; each keyframe's tensors
come to the host once. PNGs are written by `utils/image.py::write_png`.
"""

from __future__ import annotations

import pathlib

import numpy as np

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.geometry.projective import (
    constrain_points_to_ray,
)
from splatt3r_slam_tpu_torch.lie import sim3
from splatt3r_slam_tpu_torch.runtime.frame import uimg01
from splatt3r_slam_tpu_torch.utils.image import write_png

_PLY_DTYPE = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
              ("red", "u1"), ("green", "u1"), ("blue", "u1")]


def prepare_savedir(save_as: str, dataset):
    save_dir = pathlib.Path("logs")
    if save_as != "default":
        save_dir = save_dir / save_as
    save_dir.mkdir(exist_ok=True, parents=True)
    seq_name = pathlib.Path(str(dataset.dataset_path)).stem
    return save_dir, seq_name


def save_traj(logdir, logfile, timestamps, keyframes, intrinsics=None):
    """TUM format: `t x y z qx qy qz qw` per keyframe."""
    logdir = pathlib.Path(logdir)
    logdir.mkdir(exist_ok=True, parents=True)
    with open(logdir / logfile, "w") as f:
        for i in range(len(keyframes)):
            kf = keyframes[i]
            t = timestamps[kf.frame_id]
            T7 = sim3.to_se3(kf.T_WC).detach().cpu().numpy().reshape(-1)
            x, y, z, qx, qy, qz, qw = T7
            f.write(f"{t} {x} {y} {z} {qx} {qy} {qz} {qw}\n")


def save_ply(filename, points: np.ndarray, colors: np.ndarray):
    """Binary little-endian PLY with xyz + rgb."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8)
    n = len(points)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    ).encode("ascii")
    rec = np.zeros(n, dtype=_PLY_DTYPE)
    rec["x"], rec["y"], rec["z"] = points.T
    rec["red"], rec["green"], rec["blue"] = colors.T
    with open(filename, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())


def load_ply(filename):
    """Reader for the PLY files written above."""
    with open(filename, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int([line for line in header.decode().splitlines()
                 if line.startswith("element vertex")][0].split()[-1])
        rec = np.frombuffer(f.read(), dtype=_PLY_DTYPE, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1)
    col = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
    return pts, col


def save_reconstruction(savedir, filename, keyframes, c_conf_threshold):
    """World-space point cloud with per-point RGB."""
    savedir = pathlib.Path(savedir)
    savedir.mkdir(exist_ok=True, parents=True)
    pcs, cols = [], []
    for i in range(len(keyframes)):
        kf = keyframes[i]
        X = kf.X_canon
        if config.get("use_calib") and kf.K is not None:
            img_size = tuple(int(v) for v in
                             np.asarray(kf.img_shape).reshape(-1)[:2])
            X = constrain_points_to_ray(img_size, X[None],
                                        kf.K.to(X.device))[0]
        pW = sim3.act(kf.T_WC, X).detach().cpu().numpy().reshape(-1, 3)
        color = (uimg01(kf) * 255).astype(np.uint8).reshape(-1, 3)
        valid = (kf.get_average_conf().detach().cpu().numpy().reshape(-1)
                 > c_conf_threshold)
        pcs.append(pW[valid])
        cols.append(color[valid])
    save_ply(savedir / filename, np.concatenate(pcs), np.concatenate(cols))


def save_keyframes(savedir, timestamps, keyframes):
    """Keyframe RGB dumps, one PNG per keyframe named by its timestamp."""
    savedir = pathlib.Path(savedir)
    savedir.mkdir(exist_ok=True, parents=True)
    for i in range(len(keyframes)):
        kf = keyframes[i]
        t = timestamps[kf.frame_id]
        write_png(savedir / f"{t}.png", (uimg01(kf) * 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# ATE RMSE with Sim(3) alignment (the `evo_ape tum -as` metric)
# ---------------------------------------------------------------------------


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale=True):
    """Least-squares Sim(3) aligning x→y. x, y: (n, 3). Returns (s, R, t)."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc**2).sum() / len(x)
    # a degenerate source (all positions equal) leaves the scale
    # unobservable: s = 1 keeps the metric finite
    s = (float(np.trace(np.diag(D) @ S) / var_x)
         if with_scale and var_x > 1e-12 else 1.0)
    t = my - s * R @ mx
    return s, R, t


def read_tum_trajectory(path):
    data = np.loadtxt(path, comments="#")
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def associate(t_a, t_b, max_dt=0.02):
    """One-to-one timestamp association (the TUM benchmark's associate.py,
    as evo uses it): every pair within max_dt, by increasing |dt|, each
    stamp taken at most once."""
    t_a = np.asarray(t_a, dtype=np.float64)
    t_b = np.asarray(t_b, dtype=np.float64)
    dt = np.abs(t_a[:, None] - t_b[None, :])
    ii, jj = np.nonzero(dt < max_dt)
    order = np.argsort(dt[ii, jj], kind="stable")
    used_a = np.zeros(len(t_a), bool)
    used_b = np.zeros(len(t_b), bool)
    ia, ib = [], []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if not used_a[i] and not used_b[j]:
            used_a[i] = used_b[j] = True
            ia.append(i)
            ib.append(j)
    sort = np.argsort(ia)
    return np.asarray(ia, np.int64)[sort], np.asarray(ib, np.int64)[sort]


def ate_rmse(gt_file, est_file, max_dt=0.02, with_scale=True):
    """ATE RMSE after Sim(3) alignment (== `evo_ape tum gt est -as`)."""
    t_gt, p_gt, _ = read_tum_trajectory(gt_file)
    t_es, p_es, _ = read_tum_trajectory(est_file)
    ig, ie = associate(t_gt, t_es, max_dt)
    if len(ig) < 3:
        raise ValueError("too few associated poses")
    g, e = p_gt[ig], p_es[ie]
    s, R, t = umeyama_alignment(e, g, with_scale)
    e_aligned = (s * (R @ e.T)).T + t
    err = np.linalg.norm(e_aligned - g, axis=1)
    return float(np.sqrt((err**2).mean()))
