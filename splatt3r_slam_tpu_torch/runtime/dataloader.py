"""Host-side dataset readers.

Counterpart of `splatt3r_slam_tpu/runtime/dataloader.py`: TUM `rgb.txt`
lists, ETH3D `calibration.txt`, 7-Scenes `seq-01/*.color.png`, RGB folders,
and the live and video sources. PNG frames are read by `utils/image.py`,
so the readers need neither cv2 nor PIL. Timestamps stay the strings that
`rgb.txt` holds, so the trajectory writer prints them as they are.

Calibrated input (undistortion with an optimal new camera matrix, EuRoC)
waits for ROADMAP Queue 1's "Calibrated input" item: `Intrinsics.from_calib`
raises NotImplementedError when `use_calib` is on. Video, webcam and `.jpg`
frames import cv2, and RealSense imports pyrealsense2, only when used.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.utils.image import read_png, resize_img

_CALIB_TODO = ("calibrated input (undistortion without cv2, --calib, EuRoC) "
               "is ROADMAP Queue 1's 'Calibrated input' item, not ported yet")


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


def _read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB from a PNG file (or another format via cv2)."""
    if str(path).lower().endswith(".png"):
        return read_png(path)
    cv2 = _import("cv2", f"reading {pathlib.Path(path).suffix} frames")
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


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
        return _read_rgb(self.rgb_files[idx])

    def get_image(self, idx):
        img = self.read_img(idx)
        if self.use_calibration and self.camera_intrinsics is not None:
            raise NotImplementedError(_CALIB_TODO)
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


class EurocDataset(MonocularDataset):
    """EuRoC MAV cam0: always undistorted, so it waits for calibrated
    input."""

    def __init__(self, dataset_path):
        raise NotImplementedError(f"EuRoC: {_CALIB_TODO}")


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


class Intrinsics:
    """Camera calibration. Only the uncalibrated case is ported:
    `from_calib` returns None without `use_calib`, as the reference does,
    and raises otherwise."""

    @staticmethod
    def from_calib(img_size, W, H, calib, always_undistort=False):
        if not config.get("use_calib", False) and not always_undistort:
            return None
        raise NotImplementedError(_CALIB_TODO)


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
