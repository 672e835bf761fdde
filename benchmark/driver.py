"""Drive the program under test: the port's `SLAMSystem` on the plane-scene
oracle, as a configuration file states it.

Each session is a fresh system (`SLAMSystem` with the fused frontend, the
pose-graph backend `FactorGraph`, the gaussian accumulator, and with the
configuration's retrieval a real ASMK database behind the oracle's
overlap ranking), fed the traffic's frames one at a time: register the
frame's true pose with the oracle, hand the frame to `process_frame`, and
with the configuration's render render it as the CLI exports it
(`ensure_gaussians`, `render_frame` from the frame's pose, the image
brought to the host). A frame is done when its pose is on the host and
its render is.

The benchmark keeps what the comparison needs by wrapping calls into the
program, never by changing them: the model's `encode`, `decode` and
`apply_head` (their outputs on the checked frames, and the operations of
every dispatch), the tracker's step (its matches), the backend's solve
(the keyframe poses after it) and the accumulator (the world-space
chunks of the keyframes whose solves are checked). The wrappers add a
Python call and keep references; they copy nothing.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import flops
from benchmark.reference.network import Shape


class Tap:
    """Wraps the model's entry points: counts the operations of every
    dispatch, and keeps the outputs while `active` is a dict."""

    def __init__(self, model, shape: Shape):
        self.shape = shape
        self.ops = 0
        self.active: dict | None = None
        enc, dec, head = model.encode, model.decode, model.apply_head

        def encode(img):
            out = enc(img)
            self.ops += flops.encoder(shape, *img.shape[:3])
            if self.active is not None:
                self.active.setdefault("encode", out)
            return out

        def decode(f1, pos1, f2, pos2):
            out = dec(f1, pos1, f2, pos2)
            self.ops += flops.decoder(shape, f1.shape[0], f1.shape[1],
                                      f2.shape[1])
            if self.active is not None:
                self.active.setdefault("decode", (f1, f2, out))
            return out

        def apply_head(num, hooks, image_size, mode="full"):
            out = head(num, hooks, image_size, mode)
            self.ops += flops.head(shape, hooks[0].shape[0], *image_size,
                                   mode)
            if self.active is not None:
                self.active.setdefault(("head", num, mode), (hooks, out))
            return out

        model.encode, model.decode, model.apply_head = encode, decode, \
            apply_head


class Program:
    """The port set up for one configuration: the model filled with the
    benchmark's weights, the inference engine and (with retrieval) one
    ASMK database that every session's oracle ranking queries."""

    def __init__(self, cfg: dict, state: dict, device, seed: int,
                 tiny_retrieval: bool = False, fault=None):
        from splatt3r_slam_tpu_torch import config as cfgmod
        from splatt3r_slam_tpu_torch import set_fp32_precision
        from splatt3r_slam_tpu_torch.models import (
            Splatt3RModel,
            TwoViewConfig,
        )
        from splatt3r_slam_tpu_torch.models.layers import set_flash_attention
        from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine

        set_fp32_precision()
        set_flash_attention(cfg["flash_attention"])
        cfgmod.set_global_config(copy.deepcopy(cfg["slam"]))
        self.cfg, self.device = cfg, device
        m = dict(cfg["model"])
        m["head_layer_dims"] = tuple(m["head_layer_dims"])
        fields = TwoViewConfig._fields
        with torch.device(device):
            model = Splatt3RModel(TwoViewConfig(
                **{k: v for k, v in m.items() if k in fields}))
        model.load_state_dict(state, strict=True)
        self.shape = Shape.from_dict(m)
        self.h, self.w = cfg["image"]["height"], cfg["image"]["width"]
        self.engine = InferenceEngine(model, self.h, self.w)
        self.fault = fault or {}
        if "model" in self.fault:  # a fault planted under the benchmark
            self.fault["model"](model)
        self.tap = Tap(model, self.shape)
        self.pose_graph_calls: list = []
        self._wrap_pose_graph()
        self.db = None
        if cfg["runtime"]["retrieval"]:
            from splatt3r_slam_tpu_torch.retrieval import RetrievalDatabase

            c = self.shape.enc_embed_dim
            kw = {"n_words": 256, "nfeat": 16} if tiny_retrieval else {}
            self.db = RetrievalDatabase(feat_dim=c, proj_dim=min(c, 1024),
                                        seed=int(seed) % (1 << 32),
                                        device=device, **kw)


    def _wrap_pose_graph(self):
        """Keep the inputs and output of the backend's pose-graph solves."""
        from splatt3r_slam_tpu_torch.ops import pose_graph

        solve = getattr(pose_graph.gauss_newton_rays, "__wrapped__",
                        pose_graph.gauss_newton_rays)
        calls = self.pose_graph_calls

        def gauss_newton_rays(*args, **kw):
            out = solve(*args, **kw)
            calls.append((args, {k: v for k, v in kw.items()
                                 if k != "stats"}, out))
            return out

        gauss_newton_rays.__wrapped__ = solve
        pose_graph.gauss_newton_rays = gauss_newton_rays


class Session:
    """One fresh SLAM system over one session of the traffic."""

    def __init__(self, prog: Program, traffic, frames, frames_u8,
                 index: int, checked=(), checked_solves=()):
        from splatt3r_slam_tpu_torch.backend import FactorGraph
        from splatt3r_slam_tpu_torch.config import config
        from splatt3r_slam_tpu_torch.runtime.oracle import (
            OracleRetrieval,
            PlaneSceneOracle,
        )
        from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
        from splatt3r_slam_tpu_torch.splat import GaussianAccumulator

        self.prog, self.traffic, self.index = prog, traffic, index
        self.frames, self.frames_u8 = frames, frames_u8
        self.checked = set(checked)
        self.checked_solves = set(checked_solves)
        rt = prog.cfg["runtime"]
        self.oracle = PlaneSceneOracle(
            prog.h, prog.w, float(prog.w), plane_n=traffic.plane_n,
            plane_d=traffic.plane_d, inner=prog.engine,
            stride=int(config["matching"].get("match_stride", 1)))
        self.sys = SLAMSystem(self.oracle, prog.h, prog.w, fused=True,
                              max_gaussians=int(rt["max_gaussians"]))
        retrieval = None
        if prog.db is not None:
            retrieval = OracleRetrieval(self.oracle, inner=prog.db)
        self.sys.backend = FactorGraph(self.oracle, self.sys.keyframes,
                                       retrieval=retrieval)
        self.sys.gaussian_module = GaussianAccumulator(**rt["gaussians"])
        self.render_every = int(rt["render_every"])
        self.records: list[dict] = []  # one a processed frame
        self.solves: list[dict] = []  # the keyframes' poses after each
        self.captures: list[dict] = []
        # the gaussian chunks of the keyframes whose solves are checked
        self.chunks: list[dict] = []
        self.n_chunks = 0
        if "session" in prog.fault:  # a fault planted under the benchmark
            prog.fault["session"](self)
        self._wrap()

    def _wrap(self):
        tap = self.prog.tap
        tracker, backend = self.sys.tracker, self.sys.backend
        step, solve = tracker.step, backend.solve
        acc = self.sys.gaussian_module
        to_world = acc.gaussians_to_world

        def tracker_step(img, kf, T_init, idx_init, K=None, oracle=None):
            out, flags = step(img, kf, T_init, idx_init, K, oracle)
            if tap.active is not None:
                tap.active["step"] = {
                    "kf": kf, "T_init": T_init, "idx_init": idx_init,
                    "idx": out["idx_f2k"], "T": out["T_WCf"],
                    "kf_new": out["kf"], "flags": flags}
            return out, flags

        def backend_solve():
            calls = self.prog.pose_graph_calls
            calls.clear()
            solve()
            fids = [f.frame_id for f in self.sys.keyframes.frames]
            keep = len(self.solves) in self.checked_solves
            self.solves.append({
                "poses": [(fid, f.T_WC) for fid, f in
                          zip(fids, self.sys.keyframes.frames)],
                "fids": fids, "calls": list(calls) if keep else []})
            calls.clear()

        def gaussians_to_world(frame):
            out = to_world(frame)
            if out is not None:
                if self.n_chunks in self.checked_solves:
                    self.chunks.append({
                        "fid": frame.frame_id, "T_WC": frame.T_WC,
                        "pred": dict(frame.gaussian_pred),
                        "cross": (None if frame.gaussian_pred_cross is None
                                  else dict(frame.gaussian_pred_cross)),
                        "out": out})
                self.n_chunks += 1
            return out

        tracker.step = tracker_step
        backend.solve = backend_solve
        acc.gaussians_to_world = gaussians_to_world

    def step(self, j: int) -> dict:
        """Process frame j of the session → its record."""
        from splatt3r_slam_tpu_torch.runtime.frame import Frame, Mode
        from splatt3r_slam_tpu_torch.splat.decoder import render_frame

        tr, sysm, tap = self.traffic, self.sys, self.prog.tap
        self.oracle.register(j, tr.poses[j])
        img = self.frames[j: j + 1]
        shape = np.array([[self.prog.h, self.prog.w]])
        frame = Frame(j, img, shape, shape.copy(), self.frames_u8[j])
        kf = sysm.keyframes.last_keyframe()
        rec = {"session": self.index, "j": j,
               "kf": None if kf is None else kf.frame_id,
               "mode": sysm.mode.name}
        capture = j in self.checked and sysm.mode == Mode.TRACKING
        if capture:
            tap.active = {"j": j, "kf": rec["kf"]}
        t0 = time.perf_counter()
        try:
            with record_function("bench.process_frame"):
                _, flag = sysm.process_frame(frame)
            image, ref = None, None
            if self.render_every and j % self.render_every == 0:
                with record_function("bench.render"):
                    self.oracle.ensure_gaussians(frame)
                    last = sysm.keyframes.last_keyframe()
                    ref = last if last is not None else frame
                    image = render_frame(frame, ref)
                    if image is not None:
                        image.cpu()  # the export: the image on the host
        finally:
            cap, tap.active = tap.active, None
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        rec["flag"] = bool(flag)
        rec["after"] = sysm.mode.name
        rec["T_WC"] = frame.T_WC
        if capture:
            cap["image"] = image
            # the cross prediction takes its colours from the newest
            # keyframe after the frame: the frame itself if it became one
            cap["ref"] = None if ref is None else ref.frame_id
            cap["T_WC"] = frame.T_WC
            cap["pred"] = (frame.gaussian_pred, frame.gaussian_pred_cross)
            cap["session"] = self.index
            self.captures.append(cap)
        self.records.append(rec)
        return rec

    def close(self) -> dict:
        """Stop the system → what the session leaves for the comparison."""
        self.sys.close()
        be = self.sys.backend
        return {"edges": list(zip(be.ii, be.jj)),
                "keyframes": [f.frame_id for f in self.sys.keyframes.frames],
                "stats": dict(be.stats)}
