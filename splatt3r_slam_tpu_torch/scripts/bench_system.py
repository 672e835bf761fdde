"""System benchmark: the port's whole SLAM loop, keyframe events included.

    python -m splatt3r_slam_tpu_torch.scripts.bench_system [--frames N]
        [--device cuda|cpu] [--tiny] [--cadence K] [--threaded]
        [--retrieval] [--render-stride R] [--lag] [--match-stride S]
        [--reloc-events N] [--oracle [--fused] [--noise S]
        [--conf-noise S] [--blackout A B]] [--cold] [--prewarm]

Counterpart of the repository's `scripts/bench_system.py`, with every mode
and every key of its JSON, plus `device` and `power_limit_w`. It runs
`SLAMSystem` end to end (keyframe creation, the backend's `add_factors`
and pose-graph solve, gaussian accumulation, renders) on a synthetic
panning sequence with the full-size model and seeded random weights, and
prints one JSON line last: `system_fps_512x384` (loop FPS) in the default
and cadence modes, `closed_loop[_fused]_fps_512x384` with `--oracle`
(`_tiny` forms for the tiny model). `--oracle` wraps the engine in the
plane-scene oracle (`runtime/oracle.py`), so tracking, data-driven
keyframing, the backend's solves and RELOC run closed loop on exact
geometry while every network dispatch is still paid, and the run also
yields a keyframe ATE.

Where it differs from the JAX script: the backend task it times is the
port's `SLAMSystem._run_backend_task(kf_idx)`; `--threaded` ends with
`SLAMSystem.close()`, which drains the worker, raises its failure and
stops it; the frame loop's timed window ends in a device synchronise,
and renders are synchronised one render late through pinned copies
behind CUDA events. Runs on CUDA by default and never falls back to the CPU (see
`scripts/_common.py`).
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np


class SyntheticDataset:
    """Panning crops over a textured base image (no disk IO)."""

    save_results = False

    def __init__(self, n, h, w, seed=0):
        rng = np.random.default_rng(seed)
        # smooth texture: random low-freq field upsampled; base sized so
        # every crop stays fully inside (frames must keep (h, w) exactly)
        sh = (h + 4 * n + 8) // 8 + 1
        sw = (w + 6 * n + 8) // 8 + 1
        small = rng.random((sh, sw, 3)).astype(np.float32)
        base = np.kron(small, np.ones((8, 8, 1), np.float32))
        self.frames = [
            np.ascontiguousarray(base[4 * i: 4 * i + h, 6 * i: 6 * i + w])
            for i in range(n)
        ]
        assert all(f.shape == (h, w, 3) for f in self.frames)

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return float(i), self.frames[i]


def oracle_trajectory(n, w, plane_d=2.0, blackout=None):
    """`runtime/oracle.py`'s pan trajectory (the kidnapped-camera one when
    an occlusion window is given)."""
    from splatt3r_slam_tpu_torch.runtime.oracle import (
        pan_trajectory,
        reloc_pan_trajectory,
    )

    if blackout:
        return reloc_pan_trajectory(n, w, blackout, plane_d=plane_d)
    return pan_trajectory(n, w, plane_d)


def _retrieval_db(args, cfg, device):
    from splatt3r_slam_tpu_torch.retrieval import RetrievalDatabase

    return RetrievalDatabase(
        feat_dim=cfg.enc_embed_dim, proj_dim=min(cfg.enc_embed_dim, 1024),
        device=device,
        **({"n_words": 256, "nfeat": 16} if args.tiny else {}))


def _instrument(sysm, sink):
    """Record each backend task's wall time (worker thread included)."""
    inner = sysm._run_backend_task

    def timed(kf_idx):
        ts = time.time()
        try:
            return inner(kf_idx)
        finally:
            sink.append((kf_idx, time.time() - ts))

    sysm._run_backend_task = timed


def run_oracle_closed_loop(args, engine, cfg, h, w, device, cfgmod):
    """The closed loop on the plane-scene oracle: `SLAMSystem`'s state
    machine end to end (INIT → TRACKING with data-driven keyframing, the
    backend's edges and solve on every keyframe, RELOC if the gate trips)
    with exact plane geometry in place of trained weights → the result
    dict."""
    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.runtime.evaluate import umeyama_alignment
    from splatt3r_slam_tpu_torch.runtime.frame import Mode, create_frame
    from splatt3r_slam_tpu_torch.runtime.oracle import (
        OracleRetrieval,
        PlaneSceneOracle,
    )
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.scripts._common import device_fields, sync

    n = args.frames
    ds = SyntheticDataset(n, h, w)
    blackout = tuple(args.blackout) if args.blackout else None
    poses = oracle_trajectory(n, w, blackout=blackout)
    # the fused mode keeps the configured matching subgrid, on which the
    # oracle emits its correspondences; the modular one runs at stride 1
    stride = (int(cfgmod.config["matching"].get("match_stride", 1))
              if args.fused else 1)

    def build():
        oracle = PlaneSceneOracle(h, w, float(w), plane_n=(0.12, 0.08, 1.0),
                                  plane_d=2.0, inner=engine, stride=stride,
                                  noise=args.noise,
                                  conf_noise=args.conf_noise,
                                  blackout=blackout)
        sysm = SLAMSystem(oracle, h, w, fused=args.fused)
        retrieval = _retrieval_db(args, cfg, device) if args.retrieval \
            else None
        if blackout:
            # ideal (overlap-ranked) retrieval, so that RELOC runs
            # deterministically; a real database inside still pays its
            # query cost
            retrieval = OracleRetrieval(oracle, inner=retrieval)
        sysm.backend = FactorGraph(oracle, sysm.keyframes,
                                   retrieval=retrieval)
        return oracle, sysm

    def drive(oracle, sysm, collect=None, drain_s=None):
        relocs, reloc_ok, was_reloc = 0, 0, False
        t0 = time.time()
        for i in range(n):
            oracle.register(i, poses[i])
            frame = create_frame(i, ds[i][1], img_size=w, device=device)
            tf0 = time.time()
            pre_mode = sysm.mode
            _, flag = sysm.process_frame(frame)
            # in RELOC the flag is the relocalization's success, not a
            # keyframe
            new_kf = bool(flag) and pre_mode != Mode.RELOC
            if pre_mode == Mode.RELOC and flag:
                reloc_ok += 1
            in_reloc = sysm.mode == Mode.RELOC
            if in_reloc and not was_reloc:
                relocs += 1
            was_reloc = in_reloc
            if collect is not None:
                collect.append((time.time() - tf0, new_kf))
        sync(device)
        td0 = time.time()
        if not bool(cfgmod.config.get("single_thread", True)):
            sysm.close()
        if drain_s is not None:
            drain_s[0] = time.time() - td0
        # loop FPS as main.py prints it (the backend's queue is not drained
        # into it); the wall FPS with the final drain is reported beside it
        return (n / (td0 - t0), n / (time.time() - t0), relocs, reloc_ok)

    # a warm-up run first (in this mode also with --cold, as in the JAX
    # script), then the timed one
    oracle_w, warm = build()
    if args.prewarm:
        warm.prewarm(background=False)
    drive(oracle_w, warm)
    warm.close()
    del warm, oracle_w
    gc.collect()

    times, task_times, drain_s = [], [], [0.0]
    oracle, sysm = build()
    _instrument(sysm, task_times)
    fps, wall_fps, relocs, reloc_ok = drive(oracle, sysm, collect=times,
                                            drain_s=drain_s)
    sysm.close()

    est = np.stack([sim3.matrix(kf.T_WC).detach().cpu().numpy()[:3, 3]
                    for kf in sysm.keyframes]).astype(np.float64)
    gt = np.stack([oracle.gt[kf.frame_id][:3, 3] for kf in sysm.keyframes])
    s, R, t = umeyama_alignment(est, gt)
    err = (s * (R @ est.T)).T + t - gt
    ate = float(np.sqrt((err ** 2).sum(axis=1).mean()))

    track_t = [dt for dt, kf in times if not kf]
    kf_t = [dt for dt, kf in times if kf]
    base = "closed_loop_fused" if args.fused else "closed_loop"
    return {
        "metric": f"{base}_fps_512x384" if not args.tiny
        else f"{base}_fps_tiny",
        "value": round(fps, 3),
        "wall_fps_incl_drain": round(wall_fps, 3),
        "unit": "frames/s",
        "mode": "oracle_closed_loop",
        "frontend": "fused" if args.fused else "modular",
        "match_stride": stride,
        "frames": n,
        "keyframes": len(sysm.keyframes),
        "relocs": relocs,
        "reloc_successes": reloc_ok,
        "noise": args.noise,
        "conf_noise": args.conf_noise,
        "blackout": list(blackout) if blackout else None,
        "backend_edges": len(sysm.backend.ii),
        "ate_rmse_m": round(ate, 6),
        "threaded": bool(not cfgmod.config.get("single_thread", True)),
        "retrieval": bool(args.retrieval),
        "t_track_p50_ms": round(1e3 * float(np.median(track_t)), 1)
        if track_t else None,
        "t_kf_event_p50_ms": round(1e3 * float(np.median(kf_t)), 1)
        if kf_t else None,
        "t_drain_s": round(drain_s[0], 2),
        "backend_task_ms": [[int(k), round(1e3 * t, 1)]
                            for k, t in task_times],
        "frame_ms": [round(1e3 * t, 1) for t, _ in times],
        "note": "real network dispatches at full device cost; outputs "
                "replaced by exact plane geometry (runtime/oracle.py) so "
                "keyframing/GN/backend run genuinely closed-loop; FPS is "
                "a conservative bound (adds oracle host math + "
                "host->device transfers"
                + ("; fused frontend at the configured matching stride"
                   if args.fused else "; modular frontend") + ")",
        **device_fields(device),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.bench_system",
        description=__doc__.split("\n")[0])
    from splatt3r_slam_tpu_torch.scripts._common import add_device_args

    add_device_args(ap)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cadence", type=int, default=0,
                    help="force a keyframe every K frames and turn off "
                         "data-driven keyframing and RELOC (random weights "
                         "would otherwise keyframe or relocalize every "
                         "frame)")
    ap.add_argument("--threaded", action="store_true",
                    help="single_thread: false (the backend on a worker "
                         "thread)")
    ap.add_argument("--retrieval", action="store_true",
                    help="loop-closure retrieval in the backend")
    ap.add_argument("--render-stride", type=int, default=0,
                    help="render the current view every R frames (with "
                         "gaussian accumulation on), synchronised one "
                         "render late")
    ap.add_argument("--lag", action="store_true",
                    help="tracking.pipeline_lag=1 (each frame's flags "
                         "consumed one frame late)")
    ap.add_argument("--oracle", action="store_true",
                    help="closed loop on the plane-scene oracle: tracking, "
                         "data-driven keyframing and the backend run on "
                         "exact geometry while every network dispatch is "
                         "paid; also yields an ATE")
    ap.add_argument("--cold", action="store_true",
                    help="skip the warm-up drive. Eager PyTorch compiles "
                         "nothing ahead, but the timed run then pays the "
                         "first-use costs: the CUDA context, cuBLAS/cuDNN "
                         "set-up and, if splatt3r_slam_tpu_torch/_build/ is "
                         "empty, the compositor's nvcc build")
    ap.add_argument("--prewarm", action="store_true",
                    help="call SLAMSystem.prewarm() before the frame loop; "
                         "in the port it compiles nothing and returns "
                         "None (the JAX package compiles its backend's "
                         "shapes there)")
    ap.add_argument("--fused", action="store_true",
                    help="with --oracle: the fused frontend at the "
                         "configured matching stride, the oracle's "
                         "geometry swapped in on the device")
    ap.add_argument("--match-stride", type=int, default=0,
                    help="override matching.match_stride (0 = config)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="with --oracle: depth-proportional pointmap noise "
                         "sigma")
    ap.add_argument("--conf-noise", type=float, default=0.0,
                    help="with --oracle: lognormal sigma on confidences")
    ap.add_argument("--blackout", type=int, nargs=2, default=None,
                    metavar=("A", "B"),
                    help="with --oracle: occlusion window [A, B) of frame "
                         "ids (a real tracking loss and relocalization)")
    ap.add_argument("--reloc-events", type=int, default=0,
                    help="after the frame loop, time N relocalization "
                         "events (mono inference, retrieval query, "
                         "add_factors, solve); implies --retrieval")
    args = ap.parse_args(argv)
    if args.reloc_events and args.oracle:
        ap.error("--oracle and --reloc-events do not compose: reloc "
                 "events are timed under forced conditions the oracle "
                 "loop would silently ignore")
    if args.oracle and args.cadence:
        ap.error("--oracle and --cadence do not compose: cadence mode "
                 "disables data-driven keyframing, which would degenerate "
                 "the oracle run to a single INIT keyframe")
    if args.fused and not args.oracle:
        ap.error("--fused is an --oracle mode (the non-oracle bench "
                 "already uses the fused frontend)")
    if args.reloc_events:
        args.retrieval = True
    return args


def main(argv=None, model=None) -> dict:
    """Run the benchmark; `model` (a full-width `Splatt3RModel` on the
    device) skips building one. Returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    args = parse_args(argv)
    device, tiny = cm.setup(args)
    args.tiny = tiny

    from splatt3r_slam_tpu_torch import config as cfgmod

    cm.load_base_config()
    if args.cadence:
        # pin the keyframe cadence: no data-driven keyframes, no reloc
        cfgmod.config["tracking"]["match_frac_thresh"] = -1.0
        cfgmod.config["tracking"]["min_match_frac"] = 0.0
    if args.match_stride:
        cfgmod.config["matching"]["match_stride"] = int(args.match_stride)
    if args.oracle and not args.fused:
        # the modular tracker consumes full-resolution analytic indices
        cfgmod.config["matching"]["match_stride"] = 1
    if args.threaded:
        cfgmod.config["single_thread"] = False
    if args.lag:
        cfgmod.config["tracking"]["pipeline_lag"] = 1

    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.runtime.frame import (
        FramePrefetcher,
        Mode,
        create_frame,
    )
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.runtime.system import (
        SLAMSystem,
        should_append_gaussians,
    )
    from splatt3r_slam_tpu_torch.splat import GaussianAccumulator
    from splatt3r_slam_tpu_torch.splat.decoder import render_frame

    cfg = cm.model_config(tiny)
    h, w = cm.hw(tiny)
    engine = InferenceEngine(cm.make_model(cfg, device, model), h, w)

    if args.oracle:
        out = run_oracle_closed_loop(args, engine, cfg, h, w, device, cfgmod)
        print(json.dumps(out))
        return out

    def build_system():
        sysm = SLAMSystem(engine, h, w)
        retrieval = _retrieval_db(args, cfg, device) if args.retrieval \
            else None
        sysm.backend = FactorGraph(engine, sysm.keyframes,
                                   retrieval=retrieval)
        # gaussian accumulation belongs to the render path (main.py:468)
        if args.render_stride:
            sysm.gaussian_module = GaussianAccumulator(spatial_stride=4)
        return sysm

    n = args.frames
    ds = SyntheticDataset(n, h, w)

    def drive(sysm, dataset, collect=None):
        """The frame loop. The default mode re-bootstraps (INIT) where a
        frame falls into RELOC: random weights never track. `--cadence K`
        forces a keyframe every K frames and, where random weights send
        a frame to RELOC, stays in TRACKING and runs the keyframe event
        itself, so that its cost is measured."""
        nloc = len(dataset)
        prefetch = FramePrefetcher(
            lambda k: create_frame(k, dataset[k][1], img_size=w,
                                   device=device), nloc)
        renders = cm.LatePull(device)
        relocs = 0
        t0 = time.time()
        try:
            for i in range(nloc):
                tg0 = time.time()
                frame = prefetch.get(i)
                if collect is not None:
                    get_waits.append(time.time() - tg0)
                tf0 = time.time()
                force = bool(args.cadence) and i > 0 and \
                    i % args.cadence == 0
                sysm.process_frame(frame, force_keyframe=force)
                if sysm.mode == Mode.RELOC:
                    relocs += 1
                    if args.cadence:
                        sysm.mode = Mode.TRACKING
                        if force:
                            sysm.add_keyframe(frame)
                        elif sysm.gaussian_module is not None and \
                                should_append_gaussians(
                                frame, False, sysm.last_gs_frame_id,
                                sysm.last_gs_T_WC):
                            # the production policy appends gaussians
                            # every few tracked frames too
                            sysm._append_gaussians(
                                frame, len(sysm.keyframes) - 1)
                    else:
                        sysm.mode = Mode.INIT
                        sysm.process_frame(frame)
                if args.render_stride and i % args.render_stride == 0:
                    sysm.engine.ensure_gaussians(frame)
                    kf = sysm.keyframes.last_keyframe()
                    img_r = render_frame(frame,
                                         kf if kf is not None else frame)
                    if img_r is not None:
                        # wait for the previous render while this one runs
                        renders.push(img_r.reshape(-1)[:1])
                if collect is not None:
                    collect.append((time.time() - tf0, force))
        finally:
            prefetch.close()
        renders.flush()
        cm.sync(device)
        td0 = time.time()
        if not bool(cfgmod.config.get("single_thread", True)):
            sysm.close()
        drain_s[0] = time.time() - td0
        dt = time.time() - t0
        # loop FPS as main.py prints it; the final drain is reported apart
        loop_fps[0] = nloc / max(dt - drain_s[0], 1e-9)
        return nloc / dt, relocs

    if not args.cold:
        # the warm-up drives the whole length in cadence mode, so that the
        # timed run meets no first use
        warm = build_system()
        get_waits, drain_s, loop_fps = [], [0.0], [0.0]
        drive(warm, SyntheticDataset(n if args.cadence else 6, h, w))
        warm.close()
        del warm
        gc.collect()

    system = build_system()
    times, get_waits, drain_s, loop_fps = [], [], [0.0], [0.0]
    task_times = []
    _instrument(system, task_times)
    if args.prewarm:
        system.prewarm()
    fps, relocs = drive(system, ds, collect=times)
    out = {
        "metric": "system_fps_512x384" if not tiny else "system_fps_tiny",
        "value": round(loop_fps[0], 3),
        "wall_fps_incl_drain": round(fps, 3),
        "unit": "frames/s",
        "frames": n,
        "keyframes": len(system.keyframes),
        "reboots": relocs,
        "gaussians": int(system.pool.n),
        "backend_edges": len(system.backend.ii),
        "cold": bool(args.cold),
        "prewarm": bool(args.prewarm),
    }
    if args.cadence:
        track_t = [t for t, f in times if not f]
        kf_t = [t for t, f in times if f]
        out.update({
            "mode": "cadence",
            "cadence": args.cadence,
            "threaded": bool(args.threaded),
            "retrieval": bool(args.retrieval),
            "render_stride": args.render_stride,
            "t_track_mean_ms": round(1e3 * float(np.mean(track_t)), 1)
            if track_t else None,
            "t_track_p50_ms": round(1e3 * float(np.median(track_t)), 1)
            if track_t else None,
            "t_kf_event_mean_ms": round(1e3 * float(np.mean(kf_t)), 1)
            if kf_t else None,
            "t_kf_event_p50_ms": round(1e3 * float(np.median(kf_t)), 1)
            if kf_t else None,
            "fps_p50_with_renders": round(
                1.0 / max(float(np.median(track_t)), 1e-9), 2)
            if track_t else None,
            # a steady cycle: (cadence - 1) tracked frames and one
            # keyframe event at their medians
            "fps_effective_p50": round(args.cadence / max(
                (args.cadence - 1) * float(np.median(track_t))
                + float(np.median(kf_t)), 1e-9), 2)
            if track_t and kf_t else None,
            "t_get_wait_p50_ms": round(
                1e3 * float(np.median(get_waits)), 1) if get_waits else None,
            "t_get_wait_sum_s": round(float(np.sum(get_waits)), 2)
            if get_waits else None,
            "t_drain_s": round(drain_s[0], 2),
            "backend_task_ms": [
                [int(k), round(1e3 * t, 1)] for k, t in task_times
            ],
            "outlier_frames": [
                [int(i), round(1e3 * t, 1)]
                for i, (t, _) in enumerate(times) if t > 1.0
            ],
            "frame_ms": [round(1e3 * t, 1) for t, _ in times],
        })

    if args.reloc_events:
        # the RELOC event end to end: mono inference, fusion, retrieval
        # query, add_factors on the candidates and the solve. Random
        # weights cannot pass the strict gate, which would return before
        # the solve, so the gates are relaxed and every event pays the
        # success path
        cfgmod.config["reloc"]["min_match_frac"] = 0.0
        cfgmod.config["reloc"]["strict"] = False
        cfgmod.config["retrieval"]["min_thresh"] = 0.0
        ds_r = SyntheticDataset(args.reloc_events + 1, h, w, seed=7)
        reloc_ms, successes = [], 0
        for j in range(args.reloc_events + 1):  # event 0 warms up
            frame = create_frame(10_000 + j, ds_r[j][1], img_size=w,
                                 device=device)
            system.mode = Mode.RELOC
            tr0 = time.time()
            _, success = system.process_frame(frame)
            cm.sync(device)
            dt = time.time() - tr0
            if j > 0:
                reloc_ms.append(1e3 * dt)
                successes += bool(success)
        system.mode = Mode.TRACKING
        out.update({
            "reloc_events": args.reloc_events,
            "reloc_success": successes,
            "reloc_event_ms_p50": round(float(np.median(reloc_ms)), 1),
            "reloc_event_ms_mean": round(float(np.mean(reloc_ms)), 1),
            "reloc_event_ms": [round(t, 1) for t in reloc_ms],
        })
    system.close()
    out.update(cm.device_fields(device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
