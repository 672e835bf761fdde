"""The one traffic generator: camera trajectories, frames and the frames
checked, from a traffic file's parameters and `--seed`.

A traffic file (`workloads/<cell>.json`) gives:
- `scene`: the plane n·X = d the oracle renders (`plane_n`, `plane_d`);
- `trajectory`: a handheld pan over the plane, after the repository's
  closed loop (`runtime/oracle.py::pan_trajectory`): a translation of
  `step` of the image width a source frame at the plane's depth, along the
  plane (that pan moves along the camera's x axis, so over a tilted plane
  its depth falls, from 2 m to 0.9 m by frame 60, and keyframes come ever
  faster until tracking fails), a yaw sway of `yaw` (amplitude in radians,
  angular rate a frame), a bob of `bob` (amplitude, rate) vertically and
  `bob_z` along the optical axis; with `out_and_back` the session pans
  out for its first half and retraces the path on the source frames it
  skipped;
- `session_frames`: frames processed by one session (a fresh system);
  the configuration's `dataset.subsample` sets how many source frames
  apart they are;
- `warmup_frames`, `trace_frames`, `checked_frames`, `checked_solves`:
  frames the set-up runs, frames a traced run profiles, frames and
  backend solves a session compares with the reference.

Every seed gets the same trajectory, keyframe cadence and sizes: the seed
draws the weights, the texture of the frames and which frames are checked.
"""

from __future__ import annotations

import numpy as np
import torch


def pan_pose(t: float, w: int, traj: dict, plane_n,
             plane_d: float) -> np.ndarray:
    """4x4 camera-to-world pose at source frame t."""
    n = np.asarray(plane_n, np.float64)
    n = n / np.linalg.norm(n)
    along = np.array([1.0, 0.0, 0.0]) - n[0] * n
    along /= np.linalg.norm(along)
    ya, yr = traj["yaw"]
    yaw = ya * np.sin(yr * t)
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    ba, br = traj["bob"]
    za, zr = traj["bob_z"]
    T[:3, 3] = (traj["step"] * t * plane_d * along
                + [0.0, ba * np.sin(br * t), za * np.sin(zr * t)])
    return T


def source_index(j: int, n: int, subsample: int, out_and_back: bool) -> int:
    """Source frame of processed frame j of a session of n."""
    if not out_and_back or j < n // 2:
        return subsample * j
    return subsample * (n - 1 - j) + subsample // 2


class Traffic:
    """One cell's traffic at (h, w), drawn from `seed`."""

    def __init__(self, spec: dict, h: int, w: int, subsample: int,
                 seed: int):
        self.spec = spec
        self.h, self.w = int(h), int(w)
        self.subsample = int(subsample)
        self.seed = int(seed)
        self.n = int(spec["session_frames"])
        sc = spec["scene"]
        self.plane_n = tuple(float(v) for v in sc["plane_n"])
        self.plane_d = float(sc["plane_d"])
        tr = spec["trajectory"]
        self.out_and_back = bool(tr.get("out_and_back", False))
        self.src = [source_index(j, self.n, self.subsample,
                                 self.out_and_back) for j in range(self.n)]
        self.poses = [pan_pose(t, self.w, tr, self.plane_n, self.plane_d)
                      for t in self.src]

    def frames(self, device) -> torch.Tensor:
        """(n, h, w, 3) float32 frames normalised as the program's
        `create_frame` does (u8 / 127.5 - 1), and their (n, h, w, 3) uint8
        host copies: crops that pan across a smooth random texture as the
        camera does, 8-pixel cells of uniform colour."""
        rng = np.random.default_rng(self.seed)
        px = self.spec["trajectory"]["step"] * self.w
        width = self.w + int(np.ceil(px * max(self.src))) + 8
        cell = 8
        small = rng.integers(0, 256, ((self.h + cell) // cell + 1,
                                      width // cell + 1, 3), np.uint8)
        base = np.kron(small, np.ones((cell, cell, 1), np.uint8))
        u8 = np.stack([base[: self.h, int(round(px * t)):
                            int(round(px * t)) + self.w] for t in self.src])
        img = torch.from_numpy(u8).to(device).float() / 127.5 - 1.0
        return img, u8

    def checked(self, session: int) -> list[int]:
        """The processed frames of `session` whose outputs are kept for the
        comparison: `checked_frames` of them drawn from the seed, one among
        the session's first ten frames and never the first frame (it
        starts the map)."""
        k = int(self.spec.get("checked_frames", 4))
        rng = np.random.default_rng([self.seed, 7919, session])
        first = int(rng.integers(1, min(10, self.n)))
        rest = [j for j in range(1, self.n) if j != first]
        more = rng.choice(rest, size=min(k - 1, len(rest)), replace=False)
        return sorted([first] + [int(j) for j in more])

    def checked_solves(self, session: int) -> list[int]:
        """The backend solves of `session` (counted from 0, the first
        keyframe's) whose inputs are kept for the comparison: `count` of
        the 2nd to the `among`-th (`checked_solves` in the traffic file),
        drawn from the seed."""
        c = self.spec.get("checked_solves", {"count": 2, "among": 4})
        rng = np.random.default_rng([self.seed, 104729, session])
        pool = np.arange(1, int(c["among"]))
        return sorted(int(j) for j in rng.choice(
            pool, size=min(int(c["count"]), len(pool)), replace=False))
