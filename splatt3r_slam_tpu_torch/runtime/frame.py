"""Frame state, keyframe store, and Gaussian pool (single process).

Counterpart of `splatt3r_slam_tpu/runtime/frame.py`:
- `Frame` is a host dataclass holding device tensors;
- `KeyframeBuffer` keeps per-keyframe tensors in host lists;
- `GaussianPool` is a preallocated device pool written in fixed-size
  chunks (sub-threshold gaussians carry opacity 0 so the rasterizer ignores
  them) with FIFO drop-oldest-half eviction. Chunks are written in place.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import numpy as np
import torch

from splatt3r_slam_tpu_torch import resolve_device
from splatt3r_slam_tpu_torch.lie import sim3


class Mode(Enum):
    INIT = 0
    TRACKING = 1
    RELOC = 2
    TERMINATED = 3


def _fuse_weighted(X_old, C_old, X, C):
    return (C_old * X_old + C * X) / (C_old + C), C_old + C


def _fuse_indep_conf(X_old, C_old, X, C):
    m = C > C_old
    return torch.where(m, X, X_old), torch.where(m, C, C_old)


def _fuse_weighted_spherical(X_old, C_old, X, C):
    def to_sph(P):
        r = torch.linalg.norm(P, dim=-1, keepdim=True)
        phi = torch.atan2(P[..., 1:2], P[..., 0:1])
        theta = torch.acos(torch.clamp(P[..., 2:3] / r, -1.0, 1.0))
        return torch.cat([r, phi, theta], dim=-1)

    def to_cart(s):
        r, phi, theta = s[..., 0:1], s[..., 1:2], s[..., 2:3]
        st = torch.sin(theta)
        return torch.cat([r * st * torch.cos(phi), r * st * torch.sin(phi),
                          r * torch.cos(theta)], dim=-1)

    s = (C_old * to_sph(X_old) + C * to_sph(X)) / (C_old + C)
    return to_cart(s), C_old + C


def _score(C, filtering_score):
    # torch.median returns the lower middle element; the reference (and the
    # JAX package) take the mean of the two middle elements
    if filtering_score == "median":
        return float(torch.quantile(C.float().flatten(), 0.5))
    return float(C.mean())


@dataclasses.dataclass
class Frame:
    """Per-frame state."""

    frame_id: int
    img: torch.Tensor  # (1, h, w, 3) normalized NHWC
    img_shape: np.ndarray  # (1, 2) [h, w]
    img_true_shape: np.ndarray
    uimg: np.ndarray  # (h, w, 3) uint8 host
    T_WC: torch.Tensor = None  # (8,) Sim3
    T_WC_host: Optional[np.ndarray] = None
    X_canon: Optional[torch.Tensor] = None  # (N, 3)
    C: Optional[torch.Tensor] = None  # (N, 1)
    feat: Optional[torch.Tensor] = None  # (1, P, C)
    pos: Optional[torch.Tensor] = None  # (1, P, 2)
    N: int = 0
    N_updates: int = 0
    K: Optional[torch.Tensor] = None
    score: float = 0.0
    gaussian_pred: Optional[dict] = None
    gaussian_pred_cross: Optional[dict] = None
    # decoder hook tokens kept by the tracking-mode frontend for lazy
    # Gaussian materialization (InferenceEngine.ensure_gaussians)
    gauss_hooks: Optional[dict] = None
    # one direction of the prospective (kf, frame) backend edge
    edge_half: Optional[dict] = None
    portrait: bool = False

    def __post_init__(self):
        if self.T_WC is None:
            self.T_WC = sim3.identity(device=self.img.device)

    def update_pointmap(self, X, C, filtering_mode="weighted_pointmap",
                        filtering_score="median"):
        if self.N == 0:
            self.X_canon, self.C = X, C
            self.N = 1
            self.N_updates = 1
            if filtering_mode == "best_score":
                self.score = _score(C, filtering_score)
            return
        if filtering_mode == "first":
            if self.N_updates == 1:
                self.X_canon, self.C, self.N = X, C, 1
        elif filtering_mode == "recent":
            self.X_canon, self.C, self.N = X, C, 1
        elif filtering_mode == "best_score":
            new_score = _score(C, filtering_score)
            if new_score > self.score:
                self.X_canon, self.C, self.N = X, C, 1
                self.score = new_score
        elif filtering_mode == "indep_conf":
            self.X_canon, self.C = _fuse_indep_conf(self.X_canon, self.C, X, C)
            self.N = 1
        elif filtering_mode == "weighted_pointmap":
            self.X_canon, self.C = _fuse_weighted(self.X_canon, self.C, X, C)
            self.N += 1
        elif filtering_mode == "weighted_spherical":
            self.X_canon, self.C = _fuse_weighted_spherical(
                self.X_canon, self.C, X, C)
            self.N += 1
        else:
            raise ValueError(f"unknown filtering_mode {filtering_mode}")
        self.N_updates += 1

    def get_average_conf(self):
        return self.C / self.N if self.C is not None else None

    def release_transients(self):
        """Drop per-frame prediction buffers once the gaussian pool has
        absorbed them (keyframes keep pointmaps only)."""
        self.gaussian_pred = None
        self.gaussian_pred_cross = None
        self.gauss_hooks = None
        self.edge_half = None


class FramePrefetcher:
    """1-deep lookahead frame source on a worker thread."""

    def __init__(self, load_fn, n: int):
        from concurrent.futures import ThreadPoolExecutor

        self._ex = ThreadPoolExecutor(1)
        self._load = load_fn
        self._n = n
        self._next = 0
        self._fut = self._ex.submit(load_fn, 0) if n > 0 else None

    def get(self, i: int):
        """Return item i (consecutive i from 0 only)."""
        if i != self._next:
            raise IndexError(f"FramePrefetcher.get({i}) out of order "
                             f"(expected {self._next}); sequential only")
        out = self._fut.result()
        self._next = i + 1
        if i + 1 < self._n:
            self._fut = self._ex.submit(self._load, i + 1)
        return out

    def close(self):
        self._ex.shutdown(wait=False, cancel_futures=True)


def create_frame(i, img, T_WC=None, img_size=512, downsample=1,
                 device="cuda") -> Frame:
    """Frame from an (H, W, 3) image already at the working geometry
    (long side == img_size, both sides multiples of 16, not square).

    Normalisation is u8/127.5 − 1 on the device. Host resizing (PIL or the
    native helper) is ported with the CLI in a later slice; until then a
    frame that needs it raises NotImplementedError."""
    dev = resolve_device(device)
    H0, W0 = img.shape[:2]
    if not (img_size != 224 and max(H0, W0) == img_size and H0 % 16 == 0
            and W0 % 16 == 0 and H0 != W0):
        raise NotImplementedError(
            f"frame of shape {(H0, W0)} needs resizing to img_size="
            f"{img_size}; host resizing is ported together with the CLI "
            "and dataloader (later slice)")
    u8 = (img if img.dtype == np.uint8
          else np.uint8(np.clip(img, 0, 1) * 255))
    rgb = torch.from_numpy(np.ascontiguousarray(u8)).to(dev).float()[None]
    rgb = rgb / 127.5 - 1.0
    img_shape = np.int32([[H0, W0]])
    uimg = u8
    if downsample > 1:
        uimg = uimg[::downsample, ::downsample]
        img_shape = img_shape // downsample
    return Frame(i, rgb, img_shape, img_shape.copy(), uimg,
                 T_WC if T_WC is not None else sim3.identity(device=dev),
                 portrait=H0 > W0)


class KeyframeBuffer:
    """Keyframe store: per-keyframe tensors in host lists."""

    def __init__(self, h: int, w: int, buffer: int = 512):
        self.h, self.w = h, w
        self.buffer = buffer
        self.frames: list[Frame] = []
        self.is_dirty: list[bool] = []
        self.K: Optional[torch.Tensor] = None

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx) -> Frame:
        kf = self.frames[idx]
        if self.K is not None:
            kf.K = self.K
        return kf

    def append(self, value: Frame):
        if len(self.frames) == self.buffer:
            print(f"WARNING: keyframe count exceeds the reference buffer "
                  f"capacity ({self.buffer}); continuing with an unbounded "
                  f"buffer (device memory grows per keyframe).")
        self.frames.append(value)
        self.is_dirty.append(True)

    def last_keyframe(self) -> Optional[Frame]:
        return self.frames[-1] if self.frames else None

    def release_older_transients(self):
        """Release prediction buffers on all but the newest keyframe."""
        for f in self.frames[:-1]:
            f.release_transients()

    def set_intrinsics(self, K):
        self.K = torch.as_tensor(K, dtype=torch.float32)


class GaussianPool:
    """World-space Gaussian accumulator. Rows of `data` are
    [means(3) cov_triu(6) colors(3) opacity(1)]; kf_id is host-side."""

    def __init__(self, max_gaussians: int = 4 * 1024 * 1024, device="cuda"):
        self.max_gaussians = int(max_gaussians)
        self.device = resolve_device(device)
        self.n = 0
        self.data = torch.zeros((self.max_gaussians, 13), dtype=torch.float32,
                                device=self.device)
        self.kf_id = np.zeros((self.max_gaussians,), np.int32)

    def append_chunk(self, means, cov_triu, colors, opacities, kf_idx: int,
                     opacity_threshold: float = 0.05):
        """Append a chunk; sub-threshold opacities are zeroed, not dropped."""
        g = means.shape[0]
        if g > self.max_gaussians:
            means, cov_triu, colors, opacities = (
                a[: self.max_gaussians]
                for a in (means, cov_triu, colors, opacities))
            g = self.max_gaussians
        if self.n + g > self.max_gaussians:
            half = self.max_gaussians // 2
            keep = self.data[self.n - half: self.n].clone()
            self.data.zero_()
            self.data[:half] = keep
            self.kf_id[:half] = self.kf_id[self.n - half: self.n]
            self.n = half
        opa = torch.where(opacities > opacity_threshold, opacities,
                          torch.zeros_like(opacities))
        self.data[self.n: self.n + g] = torch.cat(
            [means, cov_triu, colors, opa[:, None]], dim=-1).float()
        self.kf_id[self.n: self.n + g] = kf_idx
        self.n += g

    def get_all(self):
        if self.n == 0:
            return None
        d = self.data[: self.n]
        return d[:, 0:3], d[:, 3:9], d[:, 9:12], d[:, 12]

    def clear(self):
        self.n = 0
