"""Interactive / headless viewer.

Counterpart of `splatt3r_slam_tpu/runtime/visualization.py` (the
reference's viewer process): an interactive Gaussian-splat view from a free
camera, keyframe thumbnails and the current frame, camera frustums and
factor-graph edges, with the GUI controls flowing back to the main loop as
`WindowMsg`.

Every view is rasterized on the device by the tile renderer over the
shared `GaussianPool` (the hand-written CUDA compositor for CUDA tensors,
`splat/decoder.py::_rasterizer`); the viewer is a thin host client. The
canvas is composed and written without cv2 (`utils/draw.py`,
`utils/image.write_png`): headless, each tick writes a PNG. Only the
interactive window imports cv2, when it is opened; the mouse callback
takes cv2's event codes as plain integers, so it runs without cv2.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from splatt3r_slam_tpu_torch.lie import sim3
from splatt3r_slam_tpu_torch.runtime.frame import uimg01
from splatt3r_slam_tpu_torch.utils import draw

# cv2's mouse event codes and the shift-key flag
EVENT_MOUSEMOVE = 0
EVENT_LBUTTONDOWN, EVENT_RBUTTONDOWN, EVENT_MBUTTONDOWN = 1, 2, 3
EVENT_LBUTTONUP, EVENT_RBUTTONUP, EVENT_MBUTTONUP = 4, 5, 6
EVENT_MOUSEWHEEL = 10
EVENT_FLAG_SHIFTKEY = 16

WINDOW = "splatt3r-slam-tpu"


@dataclasses.dataclass
class WindowMsg:
    """GUI → main control channel, consumed live by the main loop."""

    is_terminated: bool = False
    is_paused: bool = False
    next: bool = False
    C_conf_threshold: float = 1.5
    gs_on: bool = True
    max_gaussians: int = -1
    spatial_stride: int = 4
    show_keyframes: bool = True
    show_edges: bool = True
    render_mode: str = "rgb"  # "rgb" | "depth"
    show_images: bool = True  # keyframe strip + current-frame panel
    # pointmap display when gs_on is off: "surfel" renders oriented discs
    # through the device rasterizer; "scatter" is the cheap point fallback
    pointmap_mode: str = "surfel"


def depth2rgb(depth: np.ndarray, min_d=0.1, max_d=10.0):
    """Colourize a depth map with the turbo colour map → (H, W, 3) uint8."""
    d = np.clip((depth - min_d) / max(max_d - min_d, 1e-9), 0, 1)
    return draw.TURBO[(d * 255).astype(np.uint8)]


def vfov_to_intrinsics(vfov_deg: float, h: int, w: int) -> np.ndarray:
    """Vertical FOV → pixel intrinsics."""
    f = 0.5 * h / np.tan(np.radians(vfov_deg) / 2)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def opengl_to_opencv_cam(T_gl: np.ndarray) -> np.ndarray:
    """OpenGL camera (−z forward, +y up) → OpenCV (+z forward, +y down)."""
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(T_gl.dtype)
    return T_gl @ flip


def orbit_pose(center, radius, yaw, pitch) -> np.ndarray:
    """Camera-to-world 4x4 orbiting `center` (OpenCV convention)."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    eye = center + radius * np.array([cy * cp, sp, sy * cp])
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right) + 1e-9
    down = np.cross(fwd, right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T


class Viewer:
    """GS viewer: interactive (cv2 window) or headless (a PNG a tick).

    rasterizer: "auto" (the CUDA compositor for CUDA tensors, the plain
    one on the CPU), "cuda" or "torch", as `splat/decoder.py` takes it.
    k_max 512 is the render path's cap, the one the fidelity sweep holds
    to PSNR >= 88 dB against the exact oracle at every density."""

    def __init__(self, system, hw=(384, 512), headless=True,
                 out_dir="logs/viz", vfov=60.0, rasterizer="auto",
                 k_max=512):
        self.rasterizer = rasterizer
        self.k_max = int(k_max)
        self.system = system
        self.h, self.w = hw
        self.headless = headless
        self.out_dir = pathlib.Path(out_dir)
        self.K = vfov_to_intrinsics(vfov, self.h, self.w)
        self.state = WindowMsg()
        self.yaw, self.pitch, self.radius = 0.0, 0.3, 4.0
        # free camera: pan offset added to the orbit centre; user_cam stops
        # the auto-orbit once the user steers
        self.center_offset = np.zeros(3, np.float32)
        self.user_cam = False
        self.show_help = False
        self._drag = None  # (button, last_x, last_y)
        self._last_T_cam = np.eye(4, dtype=np.float32)
        self._window_ready = False
        self._frame_idx = 0
        if headless:
            self.out_dir.mkdir(parents=True, exist_ok=True)

    # ---- free camera ---------------------------------------------------
    def set_camera(self, yaw=None, pitch=None, radius=None,
                   center_offset=None):
        """Programmatic camera control (same effect as mouse steering)."""
        if yaw is not None:
            self.yaw = float(yaw)
        if pitch is not None:
            self.pitch = float(np.clip(pitch, -1.5, 1.5))
        if radius is not None:
            self.radius = float(max(radius, 1e-3))
        if center_offset is not None:
            self.center_offset = np.asarray(center_offset, np.float32)
        self.user_cam = True

    def _on_mouse(self, event, x, y, flags, param=None):
        """Mouse callback (cv2's event codes): L-drag orbit, R-drag or
        shift-drag pan, wheel dolly."""
        if event in (EVENT_LBUTTONDOWN, EVENT_RBUTTONDOWN,
                     EVENT_MBUTTONDOWN):
            self._drag = (event, x, y)
            self.user_cam = True
            return
        if event in (EVENT_LBUTTONUP, EVENT_RBUTTONUP, EVENT_MBUTTONUP):
            self._drag = None
            return
        if event == EVENT_MOUSEWHEEL:
            # dolly: flags carry the wheel delta's sign
            self.radius *= 0.9 if flags > 0 else 1.1
            self.user_cam = True
            return
        if event == EVENT_MOUSEMOVE and self._drag is not None:
            btn, lx, ly = self._drag
            dx, dy = x - lx, y - ly
            self._drag = (btn, x, y)
            pan = (btn in (EVENT_RBUTTONDOWN, EVENT_MBUTTONDOWN)
                   or bool(flags & EVENT_FLAG_SHIFTKEY))
            if pan:
                # translate the orbit centre in the current image plane
                right = self._last_T_cam[:3, 0]
                down = self._last_T_cam[:3, 1]
                k = 0.0015 * self.radius
                self.center_offset = (
                    self.center_offset - k * dx * right - k * dy * down
                ).astype(np.float32)
            else:
                self.yaw += 0.008 * dx
                self.pitch = float(np.clip(self.pitch + 0.008 * dy,
                                           -1.5, 1.5))

    # ---- device renders ------------------------------------------------
    def _render(self, means, cov, colors, opa, T_WC_4x4):
        """Rasterize world gaussians from camera-to-world T_WC_4x4 on the
        gaussians' device → (h, w, 3) float in [0, 1] (host)."""
        from splatt3r_slam_tpu_torch.splat.decoder import _rasterizer

        dev = means.device
        view = torch.as_tensor(np.linalg.inv(T_WC_4x4).astype(np.float32),
                               device=dev)
        img = _rasterizer(self.rasterizer, means)(
            means, cov, colors, opa, view,
            torch.as_tensor(self.K, device=dev), (self.h, self.w),
            k_max=self.k_max)
        return np.clip(img.float().cpu().numpy(), 0, 1)

    def render_gs_view(self, T_WC_4x4=None):
        """Rasterize the accumulated world gaussians from a camera."""
        data = self.system.pool.get_all()
        if data is None:
            return np.zeros((self.h, self.w, 3), np.float32)
        means, cov, colors, opa = data
        if T_WC_4x4 is None:
            center = means.mean(0).float().cpu().numpy()
            T_WC_4x4 = orbit_pose(center, self.radius, self.yaw, self.pitch)
        if self.state.render_mode == "depth":
            from splatt3r_slam_tpu_torch.splat.decoder import render_depth

            view = np.linalg.inv(T_WC_4x4).astype(np.float32)
            d = render_depth(
                means, cov, opa, torch.as_tensor(view, device=means.device),
                torch.as_tensor(self.K, device=means.device),
                (self.h, self.w), mode="depth",
                k_max=self.k_max).float().cpu().numpy()
            lo, hi = (np.percentile(d[d > 0], [2, 98])
                      if (d > 0).any() else (0.1, 10.0))
            return depth2rgb(d, float(lo), float(max(hi, lo + 1e-3))
                             ).astype(np.float32) / 255.0
        return self._render(means, cov, colors, opa, T_WC_4x4)

    # ---- overlays: frustums, graph edges, pointmap mode ----------------
    def _project_pts(self, pts_w, view):
        """World points (N,3) → pixel coords (N,2) + in-front mask."""
        Xc = pts_w @ view[:3, :3].T + view[:3, 3]
        z = Xc[:, 2]
        ok = z > 1e-3
        zs = np.where(ok, z, 1.0)
        u = self.K[0, 0] * Xc[:, 0] / zs + self.K[0, 2]
        v = self.K[1, 1] * Xc[:, 1] / zs + self.K[1, 2]
        return np.stack([u, v], -1), ok, z

    def _kf_mats(self):
        """Every keyframe's 4x4 pose, from one host copy of the stacked
        Sim(3) poses."""
        kfs = self.system.keyframes
        if len(kfs) == 0:
            return []
        T = torch.stack([kfs[i].T_WC for i in range(len(kfs))])
        return list(sim3.matrix(T.float()).cpu().numpy())

    def _draw_overlays(self, canvas, view, mats):
        """Camera frustums (red) and factor-graph edges (green), projected
        into the free camera."""
        if not mats:
            return canvas
        s = 0.1  # frustum scale
        # frustum corners in camera coords: apex + 4 image-plane corners
        local = np.array(
            [[0, 0, 0], [-s, -s, 2 * s], [s, -s, 2 * s],
             [s, s, 2 * s], [-s, s, 2 * s]], np.float32)
        lines = [(0, 1), (0, 2), (0, 3), (0, 4),
                 (1, 2), (2, 3), (3, 4), (4, 1)]
        if self.state.show_keyframes:
            for T in mats:
                pts_w = local @ T[:3, :3].T + T[:3, 3]
                uv, ok, _ = self._project_pts(pts_w, view)
                for a, b in lines:
                    if ok[a] and ok[b]:
                        draw.line(canvas, tuple(uv[a].astype(int)),
                                  tuple(uv[b].astype(int)), (255, 64, 64))
        backend = getattr(self.system, "backend", None)
        if self.state.show_edges and backend is not None and backend.ii:
            centers = np.stack([T[:3, 3] for T in mats])
            uv, ok, _ = self._project_pts(centers, view)
            for i, j in zip(backend.ii, backend.jj):
                if i < len(mats) and j < len(mats) and ok[i] and ok[j]:
                    draw.line(canvas, tuple(uv[i].astype(int)),
                              tuple(uv[j].astype(int)), (64, 255, 64))
        return canvas

    def surfels(self):
        """The last 16 keyframes' pointmaps as oriented surfels at the
        state's spatial stride → (means, cov_triu, colors, opa) on the
        keyframes' device, or None without pointmaps."""
        from splatt3r_slam_tpu_torch.splat.gaussians import (
            pointmap_to_surfels,
        )

        stride = max(1, int(self.state.spatial_stride))
        parts = [[], [], [], []]
        for kf in list(self.system.keyframes)[-16:]:
            if kf.X_canon is None:
                continue
            hw = tuple(int(v) for v in
                       np.asarray(kf.img_shape).reshape(-1)[:2])
            X = kf.X_canon.float().reshape(hw[0], hw[1], 3)
            # uint8 up, then / 255 on the device: uimg01's float32 values
            col = torch.as_tensor(np.ascontiguousarray(kf.uimg),
                                  device=X.device)
            col = (col.float() / 255.0 if col.dtype == torch.uint8
                   else col.float())
            out = pointmap_to_surfels(X, col, kf.T_WC.float(), stride=stride)
            for acc, o in zip(parts, out):
                acc.append(o)
        if not parts[0]:
            return None
        return tuple(torch.cat(p) for p in parts)

    def render_surfel_view(self, T_WC_4x4):
        """Pointmap surfel mode: keyframe pointmaps as oriented discs,
        rasterized on the device by the same tile pipeline as the splats."""
        data = self.surfels()
        if data is None:
            return np.zeros((self.h, self.w, 3), np.float32)
        return self._render(*data, T_WC_4x4)

    def render_pointmap_view(self, view, mats):
        """Pointmap scatter fallback (`pointmap_mode: "scatter"`):
        subsampled keyframe points, far-to-near painter's order."""
        canvas = np.zeros((self.h, self.w, 3), np.float32)
        kfs = list(self.system.keyframes)
        pts_all, col_all = [], []
        for k in range(max(0, len(kfs) - 16), len(kfs)):
            kf = kfs[k]
            if kf.X_canon is None:
                continue
            X = kf.X_canon.float().reshape(-1, 3)[::7].cpu().numpy()
            T = mats[k]
            pts_all.append(X @ T[:3, :3].T + T[:3, 3])
            col_all.append(uimg01(kf).reshape(-1, 3)[::7])
        if not pts_all:
            return canvas
        pts = np.concatenate(pts_all)
        cols = np.concatenate(col_all)
        uv, ok, z = self._project_pts(pts, view)
        inb = ok & (uv[:, 0] >= 0) & (uv[:, 0] < self.w) & \
            (uv[:, 1] >= 0) & (uv[:, 1] < self.h)
        uv, cols, z = uv[inb], cols[inb], z[inb]
        order = np.argsort(-z)  # far first
        ui = uv[order].astype(np.int32)
        canvas[ui[:, 1], ui[:, 0]] = cols[order]
        return canvas

    def _compose(self):
        center = None
        kfs = self.system.keyframes
        mats = self._kf_mats()
        if mats:
            center = np.stack([T[:3, 3] for T in mats]).mean(axis=0)
        data = self.system.pool.get_all() if self.state.gs_on else None
        if center is None and data is not None:
            center = data[0].mean(0).float().cpu().numpy()
        if center is None:
            center = np.zeros(3, np.float32)
        T_cam = orbit_pose(center + self.center_offset, self.radius,
                           self.yaw, self.pitch)
        self._last_T_cam = T_cam  # pan axes for the mouse callback
        view = np.linalg.inv(T_cam).astype(np.float32)

        if self.state.gs_on and data is not None:
            gs = (self.render_gs_view(T_cam) * 255).astype(np.uint8)
        elif self.state.pointmap_mode == "surfel":
            gs = (self.render_surfel_view(T_cam) * 255).astype(np.uint8)
        else:
            gs = (self.render_pointmap_view(view, mats) * 255).astype(
                np.uint8)
        canvas = self._draw_overlays(gs.copy(), view, mats)
        # image panels: keyframe strip bottom-left, current camera frame
        # picture-in-picture top-right
        if self.state.show_images:
            thumbs = []
            for i in range(max(0, len(kfs) - 4), len(kfs)):
                t = (uimg01(kfs[i]) * 255).astype(np.uint8)
                thumbs.append(draw.resize_linear_u8(
                    t, (self.w // 4, self.h // 4)))
            if thumbs:
                strip = np.concatenate(thumbs, axis=1)
                canvas[-strip.shape[0]:, : strip.shape[1]] = strip
            cur = getattr(self.system, "current_frame", None)
            if cur is not None and cur.uimg is not None:
                pip = (uimg01(cur) * 255).astype(np.uint8)
                pip = draw.resize_linear_u8(pip, (self.w // 4, self.h // 4))
                ph, pw = pip.shape[:2]
                canvas[2: 2 + ph, self.w - pw - 2: self.w - 2] = pip
                draw.rectangle(canvas, (self.w - pw - 2, 2),
                               (self.w - 2, 2 + ph), (255, 255, 255))
        draw.put_text(canvas, f"gaussians: {self.system.pool.n}  kfs: "
                      f"{len(kfs)}  mode: {self.system.mode.name}",
                      (8, 20), 0.5, (255, 255, 255))
        # on-canvas control readouts
        st = self.state
        mg = st.max_gaussians if st.max_gaussians > 0 else "-"
        draw.put_text(
            canvas,
            f"conf[{st.C_conf_threshold:.1f}] stride[{st.spatial_stride}] "
            f"maxg[{mg}] {st.render_mode}"
            + (" paused" if st.is_paused else ""),
            (8, 38), 0.45, (200, 255, 200))
        if self.show_help:
            for li, txt in enumerate((
                "drag: orbit   shift/right-drag: pan   wheel: dolly",
                "space pause  n next  q quit  g gaussians  x depth",
                "p surfel/scatter pointmap",
                "[/] conf  ,/. stride  -/= max gaussians  h help",
            )):
                draw.put_text(canvas, txt, (8, 58 + 16 * li), 0.4,
                              (255, 255, 160))
        return canvas

    def _handle_key(self, key: int):
        """Keyboard control surface (key-bound equivalents of the
        reference's sliders); separate from update() so that it runs
        without a display."""
        st = self.state
        if key == ord("q"):
            st.is_terminated = True
        elif key == ord(" "):
            st.is_paused = not st.is_paused
        elif key == ord("n"):
            st.next = True
        elif key == ord("h"):
            self.show_help = not self.show_help
        elif key == ord("a"):
            self.set_camera(yaw=self.yaw - 0.2)
        elif key == ord("d"):
            self.set_camera(yaw=self.yaw + 0.2)
        elif key == ord("w"):
            self.set_camera(radius=self.radius * 0.9)
        elif key == ord("s"):
            self.set_camera(radius=self.radius * 1.1)
        elif key == ord("o"):
            self.user_cam = False  # resume the auto-orbit
        # GUI → main runtime controls
        elif key == ord("x"):
            st.render_mode = "depth" if st.render_mode == "rgb" else "rgb"
        elif key == ord("i"):
            st.show_images = not st.show_images
        elif key == ord("g"):
            st.gs_on = not st.gs_on
        elif key == ord("p"):
            st.pointmap_mode = ("scatter" if st.pointmap_mode == "surfel"
                                else "surfel")
        elif key == ord("k"):
            st.show_keyframes = not st.show_keyframes
        elif key == ord("e"):
            st.show_edges = not st.show_edges
        elif key == ord("["):
            st.C_conf_threshold = max(0.0, st.C_conf_threshold - 0.1)
        elif key == ord("]"):
            st.C_conf_threshold += 0.1
        elif key == ord(","):
            st.spatial_stride = max(1, st.spatial_stride - 1)
        elif key == ord("."):
            st.spatial_stride += 1
        elif key == ord("-"):
            if st.max_gaussians > 0:
                st.max_gaussians //= 2
            else:
                st.max_gaussians = 2 * 1024 * 1024
        elif key == ord("="):
            if st.max_gaussians > 0:
                st.max_gaussians *= 2

    def update(self):
        """One viewer tick; returns the current WindowMsg state."""
        canvas = self._compose()
        if not self.user_cam:
            self.yaw += 0.05  # slow auto-orbit until the user steers
        if self.headless:
            from splatt3r_slam_tpu_torch.utils.image import write_png

            write_png(self.out_dir / f"{self._frame_idx:06d}.png", canvas)
        else:  # pragma: no cover - needs a display
            import cv2

            if not self._window_ready:
                cv2.namedWindow(WINDOW)
                cv2.setMouseCallback(WINDOW, self._on_mouse)
                self._window_ready = True
            cv2.imshow(WINDOW, np.ascontiguousarray(canvas[..., ::-1]))
            self._handle_key(cv2.waitKey(1) & 0xFF)
        self._frame_idx += 1
        return self.state  # GUI → main loop: one process, so the state itself
