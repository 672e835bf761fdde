"""The plane scene's geometry in float64 NumPy, worked out from the true
poses the traffic hands both sides: what the oracle gives the program in
place of a trained network (each frame's pointmap, the matches between two
views on the matching subgrid, their validity), the keyframe decisions
(`tracking.match_frac_thresh` on the keyframe's subgrid pixels seen in the
frame) and the backend's edges (the consecutive one, and those retrieval
ranks by true overlap and the match gate passes).

The matches are the nearest subgrid pixel, so the poses the solves find
are near the true ones but not on them: at 512x384 the tracked poses lie
some 0.2-0.7% of the scene's depth off (`pose_gap` against the truth). The
solves are therefore judged against the reference solves of `solve.py`
on the same inputs, not against the truth.
"""

from __future__ import annotations

import numpy as np


class Scene:
    """The plane n·X = d seen by a pinhole camera of focal length w."""

    def __init__(self, h: int, w: int, plane_n, plane_d: float):
        self.h, self.w = int(h), int(w)
        self.focal = float(w)
        n = np.asarray(plane_n, np.float64)
        self.n = n / np.linalg.norm(n)
        self.d = float(plane_d)
        u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5,
                           indexing="xy")
        self.rays = np.stack([(u - w / 2) / self.focal,
                              (v - h / 2) / self.focal,
                              np.ones_like(u)], -1).reshape(-1, 3)

    def points(self, T: np.ndarray) -> np.ndarray:
        """Per-pixel ray/plane intersections in T's camera, (h·w, 3)."""
        tstar = (self.d - self.n @ T[:3, 3]) / (self.rays @ (T[:3, :3].T
                                                             @ self.n))
        return self.rays * tstar[:, None]

    def in_camera(self, T_src, T_dst) -> np.ndarray:
        """src's pixels' plane points in dst's camera, (h·w, 3)."""
        Xw = self.points(T_src) @ T_src[:3, :3].T + T_src[:3, 3]
        return (Xw - T_dst[:3, 3]) @ T_dst[:3, :3]

    def project(self, T_src, T_dst):
        """src's pixels' world points in dst's image: (u, v, in view)."""
        Xc = self.in_camera(T_src, T_dst)
        z = np.maximum(Xc[:, 2], 1e-9)
        u = self.focal * Xc[:, 0] / z + self.w / 2
        v = self.focal * Xc[:, 1] / z + self.h / 2
        ok = ((u >= 0) & (u < self.w) & (v >= 0) & (v < self.h)
              & (Xc[:, 2] > 0))
        return u, v, ok

    def overlap(self, T_src, T_dst) -> float:
        """Share of src's pixels seen by dst (retrieval's ranking)."""
        return float(self.project(T_src, T_dst)[2].mean())

    def sub(self, a: np.ndarray, stride: int) -> np.ndarray:
        """Per-pixel rows (h·w, ...) → the rows of the stride's subgrid."""
        s = max(1, int(stride))
        a = a.reshape((self.h, self.w) + a.shape[1:])[::s, ::s]
        return a.reshape((-1,) + a.shape[2:])

    def matches(self, T_src, T_dst, stride: int):
        """src's subgrid pixels located on dst's subgrid: (flat index,
        in view); the nearest sample at a stride above 1, the floor at 1."""
        s = max(1, int(stride))
        hs, ws = self.h // s, self.w // s
        u, v, ok = (self.sub(a, s) for a in self.project(T_src, T_dst))
        if s > 1:
            ui = np.clip(np.rint((u - 0.5) / s), 0, ws - 1).astype(np.int64)
            vi = np.clip(np.rint((v - 0.5) / s), 0, hs - 1).astype(np.int64)
        else:
            ui = np.clip(np.floor(u), 0, ws - 1).astype(np.int64)
            vi = np.clip(np.floor(v), 0, hs - 1).astype(np.int64)
        return vi * ws + ui, ok

    def keyframe_criterion(self, T_frame, T_kf, stride: int) -> dict:
        """The tracking step's fractions for a frame against its keyframe:
        the share of the keyframe's subgrid pixels seen in the frame, and
        the lesser of it and the share of the frame's subgrid pixels they
        hit."""
        s = max(1, int(stride))
        idx, ok = self.matches(T_kf, T_frame, s)
        frac = float(ok.mean())
        unique = len(np.unique(idx[ok])) / ((self.h // s) * (self.w // s))
        return {"match_frac": frac, "criterion": min(frac, unique)}

    def edge_fraction(self, T_i, T_j, stride: int) -> float:
        """The backend gate's fraction for edge (i, j): the lesser share of
        either keyframe's subgrid pixels seen by the other."""
        return min(float(self.matches(T_j, T_i, stride)[1].mean()),
                   float(self.matches(T_i, T_j, stride)[1].mean()))


def sim3_matrix(T8: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw s] → 4x4 [sR | t]."""
    T8 = np.asarray(T8, np.float64)
    t, q, s = T8[:3], T8[3:7], T8[7]
    x, y, z, w = q / np.linalg.norm(q)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    M = np.eye(4)
    M[:3, :3] = s * R
    M[:3, 3] = t
    return M


def pose_gap(T8: np.ndarray, M: np.ndarray, scale: float) -> float:
    """The largest of the translation gap over `scale` (the plane's depth),
    the rotation gap in radians and the scale gap between a Sim(3) pose
    [t, q, s] and a 4x4 [sR | t]."""
    T8 = np.asarray(T8, np.float64)
    sa = float(T8[7])
    sb = float(np.cbrt(np.linalg.det(M[:3, :3])))
    if not (np.isfinite(T8).all() and np.isfinite(M).all() and sa > 0
            and sb > 0):
        return float("inf")
    A = sim3_matrix(T8)
    dt = np.linalg.norm(A[:3, 3] - M[:3, 3]) / scale
    c = (np.trace((A[:3, :3] / sa).T @ (M[:3, :3] / sb)) - 1.0) / 2.0
    ang = float(np.arccos(np.clip(c, -1.0, 1.0)))
    return float(max(dt, ang, abs(sa - sb)))


class Expectation:
    """What one session of the closed loop should do, followed frame by
    frame: which frames become keyframes (with the keyframe the program
    tracked each frame against, since the criterion is relative to it) and
    which edges each keyframe event adds."""

    def __init__(self, scene: Scene, poses, slam: dict, retrieval: bool):
        self.scene, self.poses = scene, poses
        self.stride = int(slam["matching"].get("match_stride", 1))
        self.thresh = float(slam["tracking"]["match_frac_thresh"])
        self.min_frac = float(slam["tracking"]["min_match_frac"])
        self.gate = float(slam["local_opt"]["min_match_frac"])
        self.k = int(slam["retrieval"]["k"])
        self.retrieval = bool(retrieval)

    def keyframe(self, j: int, kf_j: int) -> tuple[bool, float]:
        """(frame j becomes a keyframe, the criterion's distance from its
        threshold) when tracked against keyframe kf_j."""
        c = self.scene.keyframe_criterion(self.poses[j], self.poses[kf_j],
                                          self.stride)
        if c["match_frac"] < self.min_frac:
            return False, abs(c["match_frac"] - self.min_frac)
        return c["criterion"] < self.thresh, abs(c["criterion"]
                                                 - self.thresh)

    def edges(self, keyframes: list[int]) -> list[tuple[int, int]]:
        """The backend's edges (keyframe indices) after the events of
        `keyframes` (frame ids in order), as retrieval over true overlap
        (at least 0.25, the `k` best, ties to the later keyframe) and the
        gate (`local_opt.min_match_frac`, consecutive edges never gated)
        give them."""
        out = []
        for m, fid in enumerate(keyframes):
            cands = [(m - 1, m)] if m > 0 else []
            if self.retrieval:
                Tq = self.poses[fid]
                scores = sorted(((self.scene.overlap(self.poses[keyframes[i]],
                                                     Tq), i)
                                 for i in range(m)), reverse=True)
                cands += [(i, m) for s, i in scores[: self.k] if s >= 0.25]
            for i, jj in cands:
                if i == jj - 1 or self.scene.edge_fraction(
                        self.poses[keyframes[i]], self.poses[keyframes[jj]],
                        self.stride) >= self.gate:
                    out.append((i, jj))
        return out
