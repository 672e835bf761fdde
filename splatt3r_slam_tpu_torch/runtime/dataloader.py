"""Host-side dataset readers.

Counterpart of `splatt3r_slam_tpu/runtime/dataloader.py`: TUM `rgb.txt`
lists, EuRoC `mav0/cam0` (`data.csv`, `sensor.yaml`), ETH3D
`calibration.txt`, 7-Scenes `seq-01/*.color.png`, RGB folders, and the
live and video sources. PNG and JPEG frames are read by `utils/image.py`
and `utils/jpeg.py`, so the readers need neither cv2 nor PIL. Timestamps
stay the strings that the lists hold, so the trajectory writer prints them
as they are.

Calibrated input (`use_calib`, `--calib`, and EuRoC always) undistorts each
frame on the host in numpy, with the numbers of OpenCV 5's calls that the
JAX package makes: `optimal_new_camera_matrix` (alpha 0,
`getOptimalNewCameraMatrix`), `undistort_rectify_map`
(`initUndistortRectifyMap`, float32 maps) and `Intrinsics.remap`
(`remap`, bilinear, constant border 0). Video and webcam input import
cv2, and RealSense imports pyrealsense2, only when used.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.utils.image import read_image, resize_img


def _natsorted(paths):
    def key(p):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


def _import(name: str, what: str):
    """Import an optional package, or an ImportError that names it."""
    try:
        return __import__(name)
    except ImportError as e:
        raise ImportError(f"{what} needs the {name!r} package, which is not "
                          "installed") from e


def _read_list(path) -> list[list[str]]:
    """Rows of a whitespace-separated text file, '#' comments dropped."""
    rows = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.split("#", 1)[0].split()
        if line:
            rows.append(line)
    return rows


class MonocularDataset:
    """Sequential RGB source: returns (timestamp, float image in [0,1])."""

    def __init__(self):
        self.rgb_files = []
        self.timestamps = []
        self.img_size = 512
        self.camera_intrinsics = None
        self.use_calibration = config.get("use_calib", False)
        self.save_results = True
        self.dataset_path = None

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, idx):
        img = self.get_image(idx)
        return self.get_timestamp(idx), img

    def get_timestamp(self, idx):
        return self.timestamps[idx]

    def read_img(self, idx):
        return read_image(self.rgb_files[idx])  # cv2.imread + BGR→RGB

    def get_image(self, idx):
        img = self.read_img(idx)
        if self.use_calibration and self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return img.astype(np.float32) / 255.0

    def get_img_shape(self):
        img = self.read_img(0)
        out = resize_img(img.astype(np.float32) / 255.0, self.img_size)
        return tuple(out["img"].shape[1:3]), img.shape[:2]

    def subsample(self, stride):
        self.rgb_files = self.rgb_files[::stride]
        self.timestamps = self.timestamps[::stride]

    def has_calib(self):
        return self.camera_intrinsics is not None


class TUMDataset(MonocularDataset):
    """TUM RGB-D sequences; fr1/fr2/fr3 factory calibrations."""

    _CALIB = {
        1: [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026,
            1.1633],
        2: [520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001,
            0.9172],
        3: [535.4, 539.2, 320.1, 247.6],
    }

    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        entries = _read_list(self.dataset_path / "rgb.txt")
        self.rgb_files = [self.dataset_path / e[1] for e in entries]
        self.timestamps = [e[0] for e in entries]
        m = re.search(r"freiburg(\d+)", str(dataset_path))
        if m:
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, 640, 480, self._CALIB[int(m.group(1))])


def read_sensor_yaml(path) -> dict:
    """`resolution`, `intrinsics` and `distortion_coefficients` of a EuRoC
    `sensor.yaml`. The file starts with OpenCV's `%YAML:1.0` directive,
    which PyYAML refuses, and holds a nested `T_BS` map whose flow list
    spans lines; only the three top-level flow lists of numbers are read."""
    text = pathlib.Path(path).read_text()
    out = {}
    for key in ("resolution", "intrinsics", "distortion_coefficients"):
        m = re.search(rf"^{key}\s*:\s*\[([^\]]*)\]", text, re.MULTILINE)
        if m is None:
            raise ValueError(f"{path}: no {key!r} list")
        out[key] = [float(v) for v in m.group(1).split(",") if v.strip()]
    out["resolution"] = [int(v) for v in out["resolution"]]
    return out


class EurocDataset(MonocularDataset):
    """EuRoC MAV cam0: grayscale frames as RGB, always undistorted (heavy
    radial distortion)."""

    def __init__(self, dataset_path):
        super().__init__()
        self.use_calibration = True
        self.dataset_path = pathlib.Path(dataset_path)
        cam = self.dataset_path / "mav0" / "cam0"
        entries = [[c.strip() for c in line.split(",")]
                   for line in (cam / "data.csv").read_text().splitlines()
                   if line.strip() and not line.lstrip().startswith("#")]
        self.rgb_files = [cam / "data" / e[1] for e in entries]
        self.timestamps = [e[0] for e in entries]
        cam0 = read_sensor_yaml(cam / "sensor.yaml")
        W, H = cam0["resolution"]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H,
            [*cam0["intrinsics"], *cam0["distortion_coefficients"]],
            always_undistort=True)


class ETH3DDataset(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        entries = _read_list(self.dataset_path / "rgb.txt")
        self.rgb_files = [self.dataset_path / e[1] for e in entries]
        self.timestamps = [e[0] for e in entries]
        calib = np.loadtxt(self.dataset_path / "calibration.txt",
                           dtype=np.float32)
        _, (H, W) = self.get_img_shape()
        self.camera_intrinsics = Intrinsics.from_calib(self.img_size, W, H,
                                                       calib)


class SevenScenesDataset(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = _natsorted(
            (self.dataset_path / "seq-01").glob("*.color.png"))
        self.timestamps = [float(i) for i in range(len(self.rgb_files))]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, 640, 480, [585.0, 585.0, 320.0, 240.0])


class MP4Dataset(MonocularDataset):
    """Video source (cv2), decoding forward from the capture's cursor."""

    def __init__(self, dataset_path):
        super().__init__()
        cv2 = self._cv2 = _import("cv2", "video input")
        self.use_calibration = False
        self.dataset_path = pathlib.Path(dataset_path)
        self.cap = cv2.VideoCapture(str(self.dataset_path))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.total_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.stride = config["dataset"]["subsample"]
        self.timestamps = []
        self._pos = 0  # raw frame index the capture will decode next

    def __len__(self):
        return self.total_frames // self.stride

    def get_timestamp(self, idx):
        return (self.timestamps[idx] if idx < len(self.timestamps)
                else idx / self.fps)

    def read_img(self, idx):
        cv2 = self._cv2
        target = idx * self.stride
        if target < self._pos:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, target)
            self._pos = target
        while self._pos < target:
            if not self.cap.grab():
                raise ValueError(f"Failed to read frame {idx}")
            self._pos += 1
        ret, img = self.cap.read()
        if not ret:
            raise ValueError(f"Failed to read frame {idx}")
        self._pos += 1
        self.timestamps.append(target / self.fps)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def subsample(self, stride):
        self.stride *= stride


class RGBFiles(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        self.use_calibration = False
        self.dataset_path = pathlib.Path(dataset_path)
        files = list(self.dataset_path.glob("*.png"))
        files += list(self.dataset_path.glob("*.jpg"))
        self.rgb_files = _natsorted(files)
        self.timestamps = [i / 30.0 for i in range(len(self.rgb_files))]


class Webcam(MonocularDataset):
    def __init__(self):
        super().__init__()
        cv2 = self._cv2 = _import("cv2", "webcam input")
        self.use_calibration = False
        self.cap = cv2.VideoCapture(-1)
        self.save_results = False
        self.timestamps = []

    def __len__(self):
        return 999_999

    def read_img(self, idx):
        ret, img = self.cap.read()
        if not ret:
            raise ValueError("Failed to read webcam frame")
        self.timestamps.append(idx / 30.0)
        return self._cv2.cvtColor(img, self._cv2.COLOR_BGR2RGB)


class RealsenseDataset(MonocularDataset):
    """Intel RealSense live colour stream (pyrealsense2)."""

    def __init__(self):
        super().__init__()
        rs = _import("pyrealsense2", "realsense input")
        self.save_results = False
        self.timestamps = []
        self.h, self.w = 480, 640
        self.pipeline = rs.pipeline()
        rs_config = rs.config()
        rs_config.enable_stream(rs.stream.color, self.w, self.h,
                                rs.format.bgr8, 30)
        self.profile = self.pipeline.start(rs_config)
        self.rgb_profile = rs.video_stream_profile(
            self.profile.get_stream(rs.stream.color))
        if self.use_calibration:
            i = self.rgb_profile.get_intrinsics()
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, self.w, self.h, [i.fx, i.fy, i.ppx, i.ppy])

    def __len__(self):
        return 999_999

    def read_img(self, idx):
        frames = self.pipeline.wait_for_frames()
        self.timestamps.append(frames.get_timestamp() / 1000.0)
        img = np.asanyarray(frames.get_color_frame().get_data())
        return np.ascontiguousarray(img[..., ::-1])  # BGR → RGB


def resize_transformation(H1: int, W1: int, size: int):
    """(scale_w, scale_h, half_crop_w, half_crop_h) of the reference's
    resize to `size` and centre crop (the JAX package's `resize_img(...,
    return_transformation=True)`)."""
    S = max(W1, H1)
    long_edge = round(size * max(W1 / H1, H1 / W1)) if size == 224 else size
    W, H = (int(round(x * long_edge / S)) for x in (W1, H1))
    cx, cy = W // 2, H // 2
    if size == 224:
        halfw = halfh = min(cx, cy)
    else:
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if W == H:
            halfh = 3 * halfw / 4
    # PIL's crop rounds each edge of the box
    crop_h = round(cy + halfh) - round(cy - halfh)
    return W1 / W, H1 / H, (W - 2 * halfw) / 2, (H - crop_h) / 2


def _undistort_points(pts, K, dist, P, iters: int = 5) -> np.ndarray:
    """OpenCV's `undistortPoints(pts, K, dist, None, P)` with its default
    criterion (5 fixed-point iterations, not a converged solve; under
    strong distortion such as TUM fr1's k3 the two differ), in float64.
    pts (n, 2) → (n, 2); P None keeps normalised coordinates."""
    k = np.zeros(8)
    k[:len(dist)] = dist
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    x0 = x = (u - cx) * (1.0 / fx)
    y0 = y = (v - cy) * (1.0 / fy)
    done = np.zeros(len(u), bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        # a negative icdist stops the point at its distorted position
        stop = (icdist < 0) & ~done
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
        x = np.where(done, x, np.where(stop, x0, (x0 - dx) * icdist))
        y = np.where(done, y, np.where(stop, y0, (y0 - dy) * icdist))
        done |= stop
    R = np.eye(3) if P is None else np.asarray(P, np.float64)
    w = 1.0 / (R[2, 0] * x + R[2, 1] * y + R[2, 2])
    return np.stack([(R[0, 0] * x + R[0, 1] * y + R[0, 2]) * w,
                     (R[1, 0] * x + R[1, 1] * y + R[1, 2]) * w], -1)


def _undistorted_rectangles(K, dist, W: int, H: int, P):
    """Inscribed and circumscribed rectangles (x, y, width, height) of a
    9x9 grid of points, undistorted (OpenCV 5's `getUndistortRectangles`:
    the grid spans [0, W-1] x [0, H-1], all in float64)."""
    n = 9
    g = np.arange(n, dtype=np.float64)
    xs, ys = g * (W - 1) / (n - 1), g * (H - 1) / (n - 1)
    grid = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    q = _undistort_points(grid, K, dist, P).reshape(n, n, 2)
    ix0, ix1 = q[:, 0, 0].max(), q[:, -1, 0].min()
    iy0, iy1 = q[0, :, 1].max(), q[-1, :, 1].min()
    ox0, ox1 = q[..., 0].min(), q[..., 0].max()
    oy0, oy1 = q[..., 1].min(), q[..., 1].max()
    return ((ix0, iy0, ix1 - ix0, iy1 - iy0),
            (ox0, oy0, ox1 - ox0, oy1 - oy0))


def optimal_new_camera_matrix(K, dist, size, center_principal_point=True):
    """`cv2.getOptimalNewCameraMatrix(K, dist, size, 0, size,
    centerPrincipalPoint=...)` (alpha 0: every pixel of the undistorted
    image is valid) → (3, 3) float64. size is (W, H)."""
    W, H = size
    M = np.array(K, np.float64)
    if center_principal_point:
        cx0, cy0 = M[0, 2], M[1, 2]
        cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
        (x, y, w, h), _ = _undistorted_rectangles(K, dist, W, H, K)
        s = max(cx / (cx0 - x), cy / (cy0 - y), cx / (x + w - cx0),
                cy / (y + h - cy0))
        M[0, 0] *= s
        M[1, 1] *= s
        M[0, 2], M[1, 2] = cx, cy
    else:
        (x, y, w, h), _ = _undistorted_rectangles(K, dist, W, H, None)
        M[0, 0] = (W - 1) / w
        M[1, 1] = (H - 1) / h
        M[0, 2] = -M[0, 0] * x
        M[1, 2] = -M[1, 1] * y
    return M


def undistort_rectify_map(K, dist, K_new, size):
    """`cv2.initUndistortRectifyMap(K, dist, None, K_new, size,
    CV_32FC1)` → (mapx, mapy), each (H, W) float32: the distorted source
    position of every pixel of the undistorted image (k1, k2, p1, p2 and
    an optional k3)."""
    W, H = size
    k = np.zeros(5)
    k[:len(dist)] = dist
    k1, k2, p1, p2, k3 = k
    iR = np.linalg.inv(np.asarray(K_new, np.float64))
    j = np.arange(W, dtype=np.float64)[None, :]
    i = np.arange(H, dtype=np.float64)[:, None]
    w = 1.0 / (i * iR[2, 1] + iR[2, 2] + j * iR[2, 0])
    x = (i * iR[0, 1] + iR[0, 2] + j * iR[0, 0]) * w
    y = (i * iR[1, 1] + iR[1, 2] + j * iR[1, 0]) * w
    x2, y2, xy2 = x * x, y * y, 2 * x * y
    r2 = x2 + y2
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    return ((K[0, 0] * xd + K[0, 2]).astype(np.float32),
            (K[1, 1] * yd + K[1, 2]).astype(np.float32))


def _fma32(a, b, c):
    """a·b + c rounded once to float32 (OpenCV's remap uses fused
    multiply-adds; the float64 product of two float32 values is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


class Intrinsics:
    """Camera calibration: undistortion maps and the intrinsics of the
    resized, cropped frame (`K_frame`)."""

    def __init__(self, img_size, W, H, K_orig, K, distortion, mapx, mapy):
        self.img_size = img_size
        self.W, self.H = W, H
        self.K_orig = K_orig
        self.K = K
        self.distortion = distortion
        self.mapx, self.mapy = mapx, mapy
        sw, sh, half_w, half_h = resize_transformation(H, W, img_size)
        self.K_frame = K.copy().astype(np.float32)
        self.K_frame[0, 0] = K[0, 0] / sw
        self.K_frame[1, 1] = K[1, 1] / sh
        self.K_frame[0, 2] = K[0, 2] / sw - half_w
        self.K_frame[1, 2] = K[1, 2] / sh - half_h
        # the remap's gather: the four source neighbours of every pixel as
        # flat indices (index H·W is a zero pixel: constant border 0) and
        # the float32 fractions; the maps are fixed, so this is done once
        x0, y0 = np.floor(mapx), np.floor(mapy)
        self._ax = (mapx - x0)[..., None]
        self._ay = (mapy - y0)[..., None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        self._taps = []
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            self._taps.append(np.where(ok, yy * W + xx, H * W))

    def remap(self, img: np.ndarray) -> np.ndarray:
        """`cv2.remap(img, mapx, mapy, INTER_LINEAR)` on (H, W, 3) uint8
        with OpenCV 5's float arithmetic: interpolate along x, then y, each
        step one fused multiply-add in float32, round half to even."""
        src = np.concatenate([img.reshape(-1, img.shape[-1]),
                              np.zeros((1, img.shape[-1]), img.dtype)]
                             ).astype(np.float32)
        p00, p01, p10, p11 = (src[t] for t in self._taps)
        top = _fma32(self._ax, p01 - p00, p00)
        bot = _fma32(self._ax, p11 - p10, p10)
        out = _fma32(self._ay, bot - top, top)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)

    @staticmethod
    def from_calib(img_size, W, H, calib, always_undistort=False):
        """None without `use_calib` (unless `always_undistort`), else the
        calibration [fx, fy, cx, cy, k1, k2, p1, p2(, k3)] undistorted
        with the optimal new camera matrix."""
        if not config.get("use_calib", False) and not always_undistort:
            return None
        fx, fy, cx, cy = [float(c) for c in calib[:4]]
        distortion = np.zeros(4)
        if len(calib) > 4:
            distortion = np.array(calib[4:], dtype=np.float64)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        center = config.get("dataset", {}).get("center_principle_point",
                                               True)
        K_opt = optimal_new_camera_matrix(K, distortion, (W, H), center)
        mapx, mapy = undistort_rectify_map(K, distortion, K_opt, (W, H))
        return Intrinsics(img_size, W, H, K, K_opt, distortion, mapx, mapy)


def load_dataset(dataset_path: str) -> MonocularDataset:
    """Dispatch on path tokens, as the reference does."""
    parts = dataset_path.split("/")
    if "tum" in parts:
        return TUMDataset(dataset_path)
    if "euroc" in parts:
        return EurocDataset(dataset_path)
    if "eth3d" in parts:
        return ETH3DDataset(dataset_path)
    if "7-scenes" in parts:
        return SevenScenesDataset(dataset_path)
    if "realsense" in parts:
        return RealsenseDataset()
    if "webcam" in parts:
        return Webcam()
    ext = parts[-1].split(".")[-1].lower()
    if ext in ("mp4", "avi", "mov"):
        return MP4Dataset(dataset_path)
    return RGBFiles(dataset_path)
