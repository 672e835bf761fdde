"""Benchmark: the port's tracking frames per second at 512x384.

    python -m splatt3r_slam_tpu_torch.bench [--device cuda|cpu] [--tiny]

Counterpart of the repository's `bench.py`, with its workload: the full
per-frame tracking step (encoder on the new frame, decoder and
tracking-mode heads against the keyframe, iterative-projection matching,
the Sim(3) Gauss-Newton pose solve, pointmap fusion, the keyframe
criterion; `runtime/fused.py::fused_track_step`) on 40 panned synthetic
384x512 frames, `TwoViewConfig()` (ViT-L, bf16 trunk and heads; the
`BENCH_HEAD_DTYPE` environment variable overrides the heads' dtype) with
seeded random weights, config/base.yaml, frames made on a prefetch thread
(`FramePrefetcher`), a fixed keyframe from `inference_mono`, and each
frame's flags pulled one frame late. Three timed passes over frames 3-39
follow a warm-up of frames 1-2; each later pass gets a fresh prefetcher
and replays frames 0-2 untimed. Each pass's FPS and the spread go to
stderr; the last line of stdout is

    {"metric": "tracking_fps_512x384", "value": <median>, "unit":
     "frames/s", "device": "<name>", "power_limit_w": <W>}

(`tracking_fps_tiny_cpu` for the tiny fp32 model at 48x64 over 10 frames,
which runs only with `--device cpu` or `--tiny`).

There is no `vs_baseline`: the JAX script's 15 FPS target was set for one
TPU v5e, and the port runs on another device. Nor does it fall back to the
CPU when the device is missing, as the JAX script does when its
accelerator probe fails: asking for CUDA without a GPU raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def main(argv=None, model=None) -> dict:
    """Run the benchmark; `model` (a full-width `Splatt3RModel` on the
    device) skips building one. Returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(prog="python -m splatt3r_slam_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    cm.add_device_args(ap)
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)

    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.runtime.frame import (
        FramePrefetcher,
        create_frame,
    )
    from splatt3r_slam_tpu_torch.runtime.fused import (
        KFState,
        MatchingParams,
        fused_track_step,
    )
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.tracking import TrackingConfig

    cm.load_base_config()
    cfg = cm.model_config(tiny, os.environ.get("BENCH_HEAD_DTYPE") or None)
    h, w = cm.hw(tiny)
    n_frames = 10 if tiny else 40
    model = cm.make_model(cfg, device, model)
    engine = InferenceEngine(model, h, w)
    frames = cm.panned_frames(n_frames, h, w)
    tcfg = TrackingConfig()
    mcfg = MatchingParams.from_config(cfgmod.config)

    def prefetcher():
        return FramePrefetcher(
            lambda i: create_frame(i, frames[i], img_size=w, device=device),
            n_frames)

    prefetch = prefetcher()
    kf_frame = prefetch.get(0)
    X, C = engine.inference_mono(kf_frame)
    kf = KFState(feat=kf_frame.feat, pos=kf_frame.pos, X=X, C=C,
                 N_fused=torch.tensor(1.0, device=device),
                 T_WC=kf_frame.T_WC)

    def track_step(i, kf, get_frame):
        f = get_frame(i)
        out, flags = fused_track_step(model, f.img, kf, f.T_WC, None, h, w,
                                      tcfg, mcfg)
        return out["kf"], flags

    for i in range(1, 3):  # warm-up
        kf, flags = track_step(i, kf, prefetch.get)
        flags.cpu()

    def one_pass(kf, get_frame):
        """Frames 3.. with frame t's flags pulled after frame t+1 is
        dispatched; ends when the last flags are on the host."""
        pull = cm.LatePull(device)
        t0 = time.perf_counter()
        for i in range(3, n_frames):
            kf, flags = track_step(i, kf, get_frame)
            pull.push(flags)  # the decision of frame i-1
        pull.flush()
        return (n_frames - 3) / (time.perf_counter() - t0), kf

    passes = []
    for p in range(3):
        if p > 0:
            prefetch.close()
            prefetch = prefetcher()
            prefetch.get(0)
            for i in range(1, 3):
                kf, flags = track_step(i, kf, prefetch.get)
                flags.cpu()
        fps, kf = one_pass(kf, prefetch.get)
        passes.append(fps)
    prefetch.close()
    fps = float(np.median(passes))
    print("bench passes (FPS): " + ", ".join(f"{p:.2f}" for p in passes)
          + f"  -> p50 {fps:.2f}, spread {max(passes) - min(passes):.2f}",
          file=sys.stderr)
    metric = ("tracking_fps_512x384" if not tiny
              else f"tracking_fps_tiny_{device.type}")
    out = {"metric": metric, "value": round(fps, 3), "unit": "frames/s",
           **cm.device_fields(device)}
    print(json.dumps(out))
    out["passes"] = passes
    return out


if __name__ == "__main__":
    main()
