"""Factor graph over keyframe pairs + backend driver.

Counterpart of `splatt3r_slam_tpu/backend/factor_graph.py`: edges from
symmetric matching with bidirectional match-fraction gating (consecutive
edges never gated), the consecutive edge reusing the direction the fused
tracking step computed, retrieval edges per new keyframe, the pose-graph
solve writing poses back, and retrieval-anchored relocalization.

Edge state stays on the device, one (ns,) tensor per edge and direction;
one host pull per `add_factors` call brings the gating fractions over.
The solve stacks the keyframes and edges it needs at their real sizes (the
JAX package's bucket padding only bounds XLA recompiles). There is no
`prewarm`: nothing compiles in eager PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from splatt3r_slam_tpu_torch.config import config
from splatt3r_slam_tpu_torch.ops import pose_graph
from splatt3r_slam_tpu_torch.runtime.frame import Frame, KeyframeBuffer

_EDGE_LISTS = ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i",
               "Q_ii2jj", "Q_jj2ii")


def edge_gate(idx_i2j, idx_j2i, valid_j, valid_i, Qii, Qjj, Qji, Qij,
              Q_conf: float):
    """Post-match gating of E edges → (Qj (E, ns), Qi (E, ns), valid_j
    (E, ns), valid_i (E, ns), frac (2, E)): Qj = sqrt(Qii[idx_i2j]·Qji),
    Qi = sqrt(Qjj[idx_j2i]·Qij), and the share of each direction's rows that
    are valid with Q above Q_conf."""
    Qj = torch.sqrt(torch.gather(Qii, 1, idx_i2j[..., None]) * Qji)
    Qi = torch.sqrt(torch.gather(Qjj, 1, idx_j2i[..., None]) * Qij)
    vj = valid_j & (Qj > Q_conf)
    vi = valid_i & (Qi > Q_conf)
    frac = torch.stack([vj.float().mean((1, 2)), vi.float().mean((1, 2))])
    return Qj[..., 0], Qi[..., 0], valid_j[..., 0], valid_i[..., 0], frac


class FactorGraph:
    def __init__(self, engine, frames: KeyframeBuffer, K=None,
                 retrieval=None):
        self.engine = engine
        self.frames = frames
        self.cfg = config["local_opt"]
        self.K = K
        self.retrieval = retrieval
        self.ii: list[int] = []
        self.jj: list[int] = []
        for name in _EDGE_LISTS:
            setattr(self, name, [])
        # what the run did: solves, GN iterations, Cholesky failures,
        # edges added by kind, relocalizations tried and accepted
        self.stats = dict(solves=0, iters=0, chol_fail=0, neighbor_edges=0,
                          factor_edges=0, reloc_tried=0, reloc_ok=0)

    def _append_edge(self, i, j, *tensors):
        self.ii.append(int(i))
        self.jj.append(int(j))
        for name, t in zip(_EDGE_LISTS, tensors):
            getattr(self, name).append(t)

    # ------------------------------------------------------------------
    def add_factors(self, ii, jj, min_match_frac, is_reloc=False) -> bool:
        """Create edges (ii[k], jj[k]) by symmetric matching with
        bidirectional gating."""
        if len(ii) == 0:
            return False
        kf_ii = [self.frames[int(i)] for i in ii]
        kf_jj = [self.frames[int(j)] for j in jj]
        for kf in kf_ii + kf_jj:
            self.engine.ensure_encoded(kf)
        with record_function("port.backend.match"):
            res = self.engine.match_symmetric(
                torch.cat([k.feat for k in kf_ii]),
                torch.cat([k.pos for k in kf_ii]),
                torch.cat([k.feat for k in kf_jj]),
                torch.cat([k.pos for k in kf_jj]))
        with record_function("port.backend.gate"):
            Qj, Qi, valid_j, valid_i, frac = edge_gate(
                *res, float(self.cfg["Q_conf"]))
            frac = frac.cpu().numpy()  # the one host pull
        idx_i2j, idx_j2i = res[0], res[1]
        ii_np = np.asarray(ii, np.int64)
        jj_np = np.asarray(jj, np.int64)
        invalid = np.minimum(frac[0], frac[1]) < min_match_frac
        invalid = ~(ii_np == jj_np - 1) & invalid
        if invalid.any() and is_reloc:
            return False
        added = False
        for k in np.nonzero(~invalid)[0]:
            self._append_edge(ii_np[k], jj_np[k], idx_i2j[k], idx_j2i[k],
                              valid_j[k], valid_i[k], Qj[k], Qi[k])
            self.stats["factor_edges"] += 1
            added = True
        self._enforce_max_edges()
        return added

    def _enforce_max_edges(self):
        """Sliding-window edge capacity (`local_opt.max_edges`, at most
        1024 as in the JAX package): the oldest non-consecutive edges go
        first, then the oldest consecutive ones."""
        cap = min(int(float(self.cfg.get("max_edges", 1024))), 1024)
        E = len(self.ii)
        if E <= cap:
            return
        nonconsec = [k for k in range(E) if self.ii[k] != self.jj[k] - 1]
        consec = [k for k in range(E) if self.ii[k] == self.jj[k] - 1]
        victims = set((nonconsec + consec)[:E - cap])
        keep = [k for k in range(E) if k not in victims]
        for name in ("ii", "jj") + _EDGE_LISTS:
            lst = getattr(self, name)
            setattr(self, name, [lst[k] for k in keep])

    # ------------------------------------------------------------------
    def get_unique_kf_idx(self):
        return (np.unique(np.concatenate([self.ii, self.jj])) if self.ii
                else np.asarray([], np.int64))

    def _stride_params(self):
        """(sub_stride, sub_hw, pix_stride): the edge state lives on the
        matching subgrid; `gn_stride` (full-resolution row subsampling) is
        divided by the rows the subgrid already removed."""
        s = max(1, int(config["matching"].get("match_stride", 1)))
        ds = int(config.get("dataset", {}).get("img_downsample", 1))
        sub_hw = (self.frames.h // ds, self.frames.w // ds)
        pix_stride = max(1, int(self.cfg.get("gn_stride", 1)) // (s * s))
        return s, sub_hw, pix_stride

    def _solve_inputs(self, unique_kf, K=None, img_size=None):
        """Stacked keyframe and two-way edge tensors for the solve."""
        fr = [self.frames[int(i)] for i in unique_kf]
        sub_stride, sub_hw, _ = self._stride_params()
        Twc = torch.stack([f.T_WC for f in fr]).float()
        Xs, Cs = pose_graph.stack_keyframes(
            [f.X_canon for f in fr], [f.C for f in fr],
            [max(f.N, 1) for f in fr], sub_stride, sub_hw, K, img_size)
        rank = {int(k): r for r, k in enumerate(unique_kf)}
        dev = Twc.device
        ii = torch.tensor([rank[i] for i in self.ii] +
                          [rank[j] for j in self.jj], device=dev)
        jj = torch.tensor([rank[j] for j in self.jj] +
                          [rank[i] for i in self.ii], device=dev)
        idx = torch.stack(self.idx_ii2jj + self.idx_jj2ii)
        valid = torch.stack(self.valid_match_j + self.valid_match_i)
        Q = torch.stack(self.Q_ii2jj + self.Q_jj2ii).float()
        return Twc, Xs, Cs, ii, jj, idx, valid, Q

    def _common(self):
        _, _, pix_stride = self._stride_params()
        return dict(num_fix=int(self.cfg["pin"]),
                    max_iter=int(self.cfg["max_iters"]),
                    C_thresh=float(self.cfg["C_conf"]),
                    Q_thresh=float(self.cfg["Q_conf"]),
                    delta_thresh=float(self.cfg["delta_norm"]),
                    pix_stride=pix_stride, stats=self.stats)

    def solve_GN_rays(self):
        pin = int(self.cfg["pin"])
        unique_kf = self.get_unique_kf_idx()
        if len(unique_kf) <= pin:
            return
        Twc, Xs, Cs, ii, jj, idx, valid, Q = self._solve_inputs(unique_kf)
        Twc_new = pose_graph.gauss_newton_rays(
            Twc, Xs, Cs, ii, jj, idx, valid, Q,
            sigma_ray=float(self.cfg["sigma_ray"]),
            sigma_dist=float(self.cfg["sigma_dist"]), **self._common())
        self.frames.update_T_WCs(Twc_new[pin:], unique_kf[pin:])

    def solve_GN_calib(self):
        pin = int(self.cfg["pin"])
        unique_kf = self.get_unique_kf_idx()
        if len(unique_kf) <= pin:
            return
        img_size = tuple(int(v) for v in np.asarray(
            self.frames[0].img_shape).reshape(-1)[:2])
        K = torch.as_tensor(self.K, dtype=torch.float32,
                            device=self.frames[0].T_WC.device)
        Twc, Xs, Cs, ii, jj, idx, valid, Q = self._solve_inputs(
            unique_kf, K, img_size)
        Twc_new = pose_graph.gauss_newton_calib(
            Twc, Xs, Cs, K, ii, jj, idx, valid, Q, img_size,
            pixel_border=float(self.cfg["pixel_border"]),
            z_eps=float(self.cfg["depth_eps"]),
            sigma_pixel=float(self.cfg["sigma_pixel"]),
            sigma_depth=float(self.cfg["sigma_depth"]), **self._common())
        self.frames.update_T_WCs(Twc_new[pin:], unique_kf[pin:])

    def solve(self):
        with record_function("port.backend.solve"):
            self.stats["solves"] += 1
            if config.get("use_calib") and self.K is not None:
                self.solve_GN_calib()
            else:
                self.solve_GN_rays()

    # ------------------------------------------------------------------
    # backend-driver API used by SLAMSystem
    # ------------------------------------------------------------------
    def add_neighbor_edge_from_tracking(self, kf_idx: int) -> bool:
        """Consecutive edge (kf_idx-1, kf_idx) that reuses the direction
        the fused tracking step computed (Frame.edge_half): only the
        reverse decode + match runs, and consecutive edges are never
        gated."""
        if not bool(self.cfg.get("reuse_tracking_edge", True)):
            return False
        frame_j = self.frames[kf_idx]
        eh = getattr(frame_j, "edge_half", None)
        if eh is None or eh["kf_idx"] != kf_idx - 1:
            return False
        kf_i = self.frames[kf_idx - 1]
        self.engine.ensure_encoded(kf_i)
        self.engine.ensure_encoded(frame_j)
        with record_function("port.backend.match"):
            idx_i2j, valid_j, Qj = self.engine.match_oneway(
                kf_i.feat, kf_i.pos, frame_j.feat, frame_j.pos)
        self._append_edge(kf_idx - 1, kf_idx, idx_i2j, eh["idx_j2i"],
                          valid_j, eh["valid_i"], Qj, eh["Qi"])
        self.stats["neighbor_edges"] += 1
        frame_j.edge_half = None
        self._enforce_max_edges()
        return True

    def _retrieve(self, frame, add_after_query: bool):
        with record_function("port.retrieval"):
            return self.retrieval.update(
                frame, add_after_query=add_after_query,
                k=int(config["retrieval"]["k"]),
                min_thresh=float(config["retrieval"]["min_thresh"]))

    def on_keyframe(self, kf_idx: int) -> bool:
        """Neighbour edge + retrieval edges + solve."""
        edges_ii, edges_jj = [], []
        if kf_idx > 0 and not self.add_neighbor_edge_from_tracking(kf_idx):
            edges_ii.append(kf_idx - 1)
            edges_jj.append(kf_idx)
        if self.retrieval is not None and kf_idx >= 0:
            for r in self._retrieve(self.frames[kf_idx], True):
                edges_ii.append(int(r))
                edges_jj.append(kf_idx)
        if edges_ii:
            self.add_factors(edges_ii, edges_jj,
                             float(self.cfg["min_match_frac"]))
        self.solve()
        return True

    def relocalize(self, frame: Frame) -> bool:
        """Retrieval-anchored relocalization."""
        if self.retrieval is None:
            return False
        self.stats["reloc_tried"] += 1
        retr = self._retrieve(frame, False)
        if len(retr) == 0:
            return False
        self.frames.append(frame)
        kf_idx = len(self.frames) - 1
        # retrieval-score order, duplicates dropped: the pose is seeded
        # from the best-scoring keyframe
        seen: set[int] = set()
        retr = [int(r) for r in retr
                if int(r) not in seen and not seen.add(int(r))]
        rcfg = config["reloc"]
        if self.add_factors(retr, [kf_idx] * len(retr),
                            float(rcfg["min_match_frac"]),
                            is_reloc=bool(rcfg["strict"])):
            self.retrieval.add_to_database(frame)
            frame.T_WC = self.frames[retr[0]].T_WC
            frame.T_WC_host = None  # stale after the reseed
            self.frames[kf_idx] = frame
            self.solve()
            self.stats["reloc_ok"] += 1
            return True
        self.frames.pop_last()
        return False
