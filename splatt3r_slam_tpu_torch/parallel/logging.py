"""Training observability: CSV metrics logger + profiler trace window.

Counterpart of `splatt3r_slam_tpu/parallel/logging.py`: a dependency-free
CSV logger with metric-dict semantics, and a `torch.profiler` trace window
(chrome trace) around a chosen step range. Under a process group only
rank 0 writes either; on the other ranks both do nothing.
"""

from __future__ import annotations

import csv
import json
import pathlib
import time

from splatt3r_slam_tpu_torch.parallel.mesh import is_rank0


class MetricsLogger:
    """Append-style CSV metrics file per run (+ metadata JSON).

    Columns grow with the union of metric keys seen — rows written
    before a key appears hold ''. `log(step, metrics)` accepts scalars,
    0-d tensors, or anything float()-able.
    """

    def __init__(self, run_dir, run_name: str = "train", meta: dict = None):
        self.dir = pathlib.Path(run_dir)
        self.path = self.dir / f"{run_name}_metrics.csv"
        self.enabled = is_rank0()
        if not self.enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path.unlink(missing_ok=True)
        self._keys = []
        self._t0 = time.time()
        if meta:
            (self.dir / f"{run_name}_meta.json").write_text(
                json.dumps(meta, indent=1, default=str)
            )

    def log(self, step: int, metrics: dict):
        if not self.enabled:
            return
        row = {"step": int(step),
               "wall_time_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        new_keys = [k for k in row if k not in self._keys]
        if new_keys:
            # header grows (e.g. val_* metrics appearing): rewrite the
            # file once under the widened header; a steady-state log() is
            # a single appended line
            old = []
            if self._keys and self.path.exists():
                with open(self.path, newline="") as f:
                    old = list(csv.DictReader(f))
            self._keys.extend(new_keys)
            with open(self.path, "w", newline="") as f:
                wr = csv.DictWriter(f, fieldnames=self._keys, restval="")
                wr.writeheader()
                wr.writerows(old)
                wr.writerow(row)
            return
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._keys, restval="").writerow(row)


class TraceWindow:
    """`torch.profiler` trace around steps [start, stop). Call `.step(i)`
    once per train step; the chrome trace lands in
    `logdir/steps_<start>_<stop>.json` when the window closes."""

    def __init__(self, logdir, start: int, stop: int):
        self.logdir = pathlib.Path(logdir)
        self.start, self.stop = int(start), int(stop)
        self._prof = None

    def step(self, i: int):
        if not is_rank0():
            return
        if self._prof is None and self.start <= i < self.stop:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and i >= self.stop:
            self.close()

    def close(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            self.logdir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(
                str(self.logdir / f"steps_{self.start}_{self.stop}.json"))
