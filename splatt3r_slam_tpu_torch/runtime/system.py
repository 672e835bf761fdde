"""SLAM system: mode state machine + frame loop orchestration.

Counterpart of `splatt3r_slam_tpu/runtime/system.py`: INIT → TRACKING
(→ RELOC) through the fused tracker (or the modular one for the other
filtering modes and `fused=False`), the Gaussian accumulation policy, and
a backend (`backend/factor_graph.py`) run after each keyframe event:
inline with `single_thread: True`, or on a worker thread whose failure is
raised again on the main thread. RELOC succeeds only through the
backend's retrieval-anchored `relocalize`.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.runtime.frame import (
    Frame,
    FramePrefetcher,
    GaussianPool,
    KeyframeBuffer,
    Mode,
    create_frame,
)


def _host_translation(frame: Frame):
    """Translation of frame.T_WC, from the flags pull when available."""
    if getattr(frame, "T_WC_host", None) is not None:
        return np.asarray(frame.T_WC_host)
    return frame.T_WC[:3].detach().cpu().numpy()


def should_append_gaussians(frame: Frame, is_keyframe: bool,
                            last_append_frame_id, last_T_WC,
                            min_translation: float = 0.12,
                            min_frame_gap: int = 3):
    """Append on keyframes, after `min_translation` of motion, or every
    `min_frame_gap` frames."""
    if is_keyframe:
        return True
    if last_append_frame_id is None:
        return True
    if frame.frame_id - last_append_frame_id >= min_frame_gap:
        return True
    if last_T_WC is not None:
        dt = _host_translation(frame) - np.asarray(last_T_WC[:3])
        if np.linalg.norm(dt) > min_translation:
            return True
    return False


@dataclasses.dataclass
class SLAMResult:
    keyframes: KeyframeBuffer
    gaussians: GaussianPool
    n_frames: int
    fps: float


class SLAMSystem:
    """Single-process SLAM loop.

    engine: InferenceEngine; h, w: working resolution; backend: optional
    object with `on_keyframe(kf_idx)` and `relocalize(frame)`;
    gaussian_module: optional GaussianAccumulator (None disables GS
    accumulation).
    """

    def __init__(self, engine, h, w, backend=None, gaussian_module=None,
                 K=None, fused=True, max_gaussians=4 * 1024 * 1024):
        self.engine = engine
        self.h, self.w = h, w
        self.keyframes = KeyframeBuffer(h, w)
        if K is not None:
            self.keyframes.set_intrinsics(K)
        mode = config["tracking"]["filtering_mode"]
        if fused and mode == "weighted_pointmap":
            from splatt3r_slam_tpu_torch.runtime.fused import FusedTracker

            self.tracker = FusedTracker(engine, self.keyframes, config)
        else:
            if fused:
                print(
                    "[splatt3r-slam-tpu] filtering_mode="
                    f"{mode!r} has no fused frontend; falling back to the "
                    "modular tracker (~5x slower per frame). "
                    "weighted_pointmap restores the fast path.")
            from splatt3r_slam_tpu_torch.runtime.tracker import FrameTracker

            self.tracker = FrameTracker(engine, self.keyframes)
        self.backend = backend
        self.gaussian_module = gaussian_module
        self.pool = GaussianPool(max_gaussians, device=engine.device)
        self.mode = Mode.INIT
        self.current_frame = None
        # constant-position motion model: seed each frame's pose from the
        # previous frame's
        self._last_frame_T_WC = None
        self.last_gs_frame_id = None
        self.last_gs_T_WC = None
        self.single_thread = bool(config.get("single_thread", True))
        self._backend_lock = threading.Lock()
        self._backend_queue: list[int] = []
        self._backend_thread = None
        self._backend_busy = False
        self._backend_error: Exception | None = None
        self._stop = False

    def prewarm(self, background: bool = True):
        """Nothing to compile ahead in eager PyTorch (the JAX package
        compiles its backend's shapes here)."""
        return None

    def _run_backend_task(self, kf_idx: int):
        if self.backend is None:
            return True
        return self.backend.on_keyframe(kf_idx)

    def _dispatch_backend(self, kf_idx: int):
        if self.backend is None:
            return
        if self.single_thread:
            self._run_backend_task(kf_idx)
            return
        with self._backend_lock:
            self._backend_queue.append(kf_idx)
            if self._backend_thread is None or \
                    not self._backend_thread.is_alive():
                self._backend_thread = threading.Thread(
                    target=self._backend_worker, daemon=True,
                    name="backend")
                self._backend_thread.start()

    def _backend_worker(self):
        while not self._stop:
            with self._backend_lock:
                task = (self._backend_queue.pop(0) if self._backend_queue
                        else None)
                self._backend_busy = task is not None
            if task is None:
                time.sleep(0.002)
                continue
            try:
                self._run_backend_task(task)
            except Exception as e:  # raised on the main thread by drain
                with self._backend_lock:
                    self._backend_error = e
                    self._backend_busy = False
                    self._backend_queue.clear()
                    self._backend_thread = None  # dispatch respawns
                return
            with self._backend_lock:
                self._backend_busy = False

    def _drain_backend(self):
        """Block until the worker is idle; raise any worker failure."""
        while True:
            with self._backend_lock:
                if self._backend_error is not None:
                    err, self._backend_error = self._backend_error, None
                    raise err
                if not self._backend_queue and not self._backend_busy:
                    return
                if (self._backend_queue and not self._backend_busy
                        and (self._backend_thread is None
                             or not self._backend_thread.is_alive())):
                    raise RuntimeError(
                        "backend worker died with "
                        f"{len(self._backend_queue)} pending task(s)")
            time.sleep(0.002)

    def close(self):
        """Finish the backend's queued work (raising a worker's failure)
        and stop its worker."""
        try:
            if not self.single_thread:
                self._drain_backend()
        finally:
            self._stop = True
            if self._backend_thread is not None:
                self._backend_thread.join(timeout=10)

    def _append_gaussians(self, frame: Frame, kf_idx: int):
        if self.gaussian_module is None:
            return
        self.engine.ensure_gaussians(
            frame, need_cross=bool(self.gaussian_module.include_cross))
        out = self.gaussian_module.gaussians_to_world(frame)
        if out is None:
            return
        self.pool.append_chunk(*out, kf_idx)
        self.last_gs_frame_id = frame.frame_id
        self.last_gs_T_WC = _host_translation(frame)

    def add_keyframe(self, frame: Frame):
        """Make `frame` the newest keyframe: append it, hand it to the
        backend, add its gaussians to the pool and release the older
        keyframes' prediction buffers."""
        self.keyframes.append(frame)
        self._dispatch_backend(len(self.keyframes) - 1)
        self._append_gaussians(frame, len(self.keyframes) - 1)
        self.keyframes.release_older_transients()

    def process_frame(self, frame: Frame, force_keyframe: bool = False):
        """Advance the state machine by one frame. Returns (mode, new_kf)."""
        self.current_frame = frame
        if self.mode != Mode.INIT and self._last_frame_T_WC is not None:
            frame.T_WC = self._last_frame_T_WC
        if self.mode == Mode.INIT:
            X, C = self.engine.inference_mono(frame)
            frame.update_pointmap(X, C, self.tracker.filtering_mode,
                                  self.tracker.filtering_score)
            self.add_keyframe(frame)
            self.mode = Mode.TRACKING
            self._last_frame_T_WC = frame.T_WC
            return self.mode, True

        if self.mode == Mode.TRACKING:
            new_kf_dev, try_reloc = self.tracker.track(frame)
            self._last_frame_T_WC = frame.T_WC
            new_kf = new_kf_dev or force_keyframe
            if try_reloc:
                self.mode = Mode.RELOC
                return self.mode, False
            if frame.T_WC_host is None:
                # pipeline_lag=1: reuse the last consumed host pose
                frame.T_WC_host = getattr(self.tracker, "last_T_WC_host",
                                          None)
            if should_append_gaussians(frame, new_kf, self.last_gs_frame_id,
                                       self.last_gs_T_WC):
                self._append_gaussians(frame, len(self.keyframes) - 1)
            if new_kf:
                if not new_kf_dev:
                    self.tracker.reset_idx_f2k()
                self.keyframes.append(frame)
                self._dispatch_backend(len(self.keyframes) - 1)
                self.keyframes.release_older_transients()
            return self.mode, new_kf

        if self.mode == Mode.RELOC:
            X, C = self.engine.inference_mono(frame)
            frame.update_pointmap(X, C, self.tracker.filtering_mode,
                                  self.tracker.filtering_score)
            success = False
            if self.backend is not None:
                success = self.backend.relocalize(frame)
            if success:
                self.keyframes.release_older_transients()
                self.mode = Mode.TRACKING
                self.tracker.reset_idx_f2k()
                self._last_frame_T_WC = frame.T_WC
            return self.mode, success

        raise RuntimeError(f"bad mode {self.mode}")

    def run(self, dataset, max_frames=None, verbose=True):
        """Process a dataset: item i is (timestamp, (H, W, 3) image)."""
        n = len(dataset) if max_frames is None else min(len(dataset),
                                                        max_frames)
        downsample = config["dataset"]["img_downsample"]
        img_size = max(self.h, self.w)

        def load(i):
            _, img = dataset[i]
            return create_frame(i, img, img_size=img_size,
                                downsample=downsample,
                                device=self.engine.device)

        prefetch = FramePrefetcher(load, n)
        t0 = time.time()
        try:
            for i in range(n):
                frame = prefetch.get(i)
                if config.get("use_calib") and self.keyframes.K is not None:
                    frame.K = self.keyframes.K
                self.process_frame(frame)
                if verbose and i % 30 == 29:
                    print(f"frame {i + 1}/{n}  FPS: "
                          f"{(i + 1) / (time.time() - t0):.2f}  "
                          f"mode={self.mode}")
        finally:
            prefetch.close()
        self.close()
        elapsed = time.time() - t0
        return SLAMResult(self.keyframes, self.pool, n,
                          n / elapsed if elapsed > 0 else 0.0)
