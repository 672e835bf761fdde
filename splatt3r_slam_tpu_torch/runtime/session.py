"""SLAM session save / resume.

Counterpart of `splatt3r_slam_tpu/runtime/session.py`: the keyframes'
tensors and poses, the factor graph's edges, the gaussian pool and the
mode, as one compressed npz, so that a run can be stopped and resumed, or
a map relocalized against later. The file's keys, shapes and dtypes are
the JAX package's, so a file saved by either package loads in the other.

On load the keyframes' tensors and the pool's rows go to the pool's
device, which `SLAMSystem` sets to its engine's.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.runtime.frame import Frame, Mode

# factor-graph list → (npz key, dtype saved, torch dtype loaded)
_EDGES = (("idx_ii2jj", "edges_idx", np.int32, torch.long),
          ("idx_jj2ii", "edges_idx2", np.int32, torch.long),
          ("valid_match_j", "edges_vj", np.bool_, torch.bool),
          ("valid_match_i", "edges_vi", np.bool_, torch.bool),
          ("Q_ii2jj", "edges_qj", np.float32, torch.float32),
          ("Q_jj2ii", "edges_qi", np.float32, torch.float32))


def _np(t, dtype=None):
    """A tensor (bf16 widened to fp32) or array → numpy, cast to dtype."""
    if torch.is_tensor(t):
        t = t.detach()
        t = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    a = np.asarray(t)
    return a if dtype is None else a.astype(dtype)


def _uimg_u8(u):
    u = np.asarray(u)
    return u if u.dtype == np.uint8 else (np.clip(u, 0, 1) * 255).astype(
        np.uint8)


def _match_stride() -> int:
    return int(config["matching"].get("match_stride", 1))


def save_session(path, system, backend=None):
    """Write `system`'s keyframes, pool and mode, and `backend`'s edges,
    to the npz `path`."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    kfs = system.keyframes
    n = system.pool.n
    blobs = {
        "n_keyframes": np.asarray(len(kfs)),
        "mode": np.asarray(system.mode.value),
        "pool_n": np.asarray(n),
        "pool_data": _np(system.pool.data[:n]),
        "pool_kf_id": system.pool.kf_id[:n],
    }
    for i in range(len(kfs)):
        kf = kfs[i]
        blobs[f"kf{i}_id"] = np.asarray(kf.frame_id)
        blobs[f"kf{i}_T"] = _np(kf.T_WC)
        blobs[f"kf{i}_X"] = _np(kf.X_canon)
        blobs[f"kf{i}_C"] = _np(kf.C)
        blobs[f"kf{i}_N"] = np.asarray(kf.N)
        blobs[f"kf{i}_uimg"] = _uimg_u8(kf.uimg)
        blobs[f"kf{i}_shape"] = np.asarray(kf.img_shape)
        if kf.feat is not None:
            blobs[f"kf{i}_feat"] = _np(kf.feat, np.float32)
            blobs[f"kf{i}_pos"] = _np(kf.pos)
    if backend is not None and backend.ii:
        # the edges' rows live on the matching subgrid: a resume under
        # another match_stride would mis-index the solver's pointmaps
        blobs["edges_match_stride"] = np.asarray(_match_stride())
        blobs["edges_ii"] = np.asarray(backend.ii)
        blobs["edges_jj"] = np.asarray(backend.jj)
        for name, key, dtype, _ in _EDGES:
            blobs[key] = np.stack([_np(t, dtype)
                                   for t in getattr(backend, name)])
    np.savez_compressed(path, **blobs)


def load_session(path, system, backend=None):
    """Append the keyframes of the npz `path` to `system`, write its pool
    rows and mode, and (with `backend`) its edges. Raises ValueError if the
    edges were built at another `matching.match_stride` than the
    config's."""
    z = np.load(path, allow_pickle=False)
    dev = system.pool.device
    if backend is not None and "edges_ii" in z:
        saved = int(z["edges_match_stride"]) \
            if "edges_match_stride" in z else 1
        if saved != _match_stride():
            raise ValueError(
                f"session edges were built at matching.match_stride="
                f"{saved}, current config uses {_match_stride()}; set the "
                "config to match before resuming")

    def put(key, dtype=None):
        return torch.as_tensor(z[key], device=dev, dtype=dtype)

    system.mode = Mode(int(z["mode"]))
    for i in range(int(z["n_keyframes"])):
        shape = z[f"kf{i}_shape"]
        T = put(f"kf{i}_T")
        f = Frame(int(z[f"kf{i}_id"]), img=None, img_shape=shape,
                  img_true_shape=shape.copy(), uimg=z[f"kf{i}_uimg"],
                  T_WC=T, T_WC_host=z[f"kf{i}_T"][:3].copy())
        f.X_canon = put(f"kf{i}_X")
        f.C = put(f"kf{i}_C")
        f.N = int(z[f"kf{i}_N"])
        f.N_updates = f.N
        if f"kf{i}_feat" in z:
            f.feat = put(f"kf{i}_feat")
            f.pos = put(f"kf{i}_pos", torch.long)
        system.keyframes.append(f)
    pn = int(z["pool_n"])
    if pn:
        pool = system.pool
        pool.data[:pn] = torch.as_tensor(z["pool_data"],
                                         device=pool.data.device)
        pool.kf_id[:pn] = z["pool_kf_id"]
        pool.n = pn
    if backend is not None and "edges_ii" in z:
        backend.ii = [int(v) for v in z["edges_ii"]]
        backend.jj = [int(v) for v in z["edges_jj"]]
        for name, key, _, dtype in _EDGES:
            setattr(backend, name, list(put(key, dtype).unbind(0)))
    return system
