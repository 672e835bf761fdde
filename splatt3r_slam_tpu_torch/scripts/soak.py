"""Long-horizon soak run: device memory and FPS over many frames.

    python -m splatt3r_slam_tpu_torch.scripts.soak [--frames N]
        [--kf-every K] [--kf-capacity C] [--max-edges E]
        [--max-gaussians G] [--out FILE] [--device cuda|cpu] [--tiny]

Counterpart of the repository's `scripts/soak.py`, with its flags. Under
forced keyframe churn (a keyframe every K frames, random weights) it
exercises the three long-horizon mechanisms: the factor graph's edge
window (`local_opt.max_edges`, `FactorGraph._enforce_max_edges`), the
gaussian pool's drop-oldest-half FIFO eviction, and the keyframe buffer
past its capacity, where it warns and keeps growing, device memory
included (`runtime/frame.py::KeyframeBuffer.append`). It reports FPS,
keyframes, edges and gaussians per third of the run, with device memory
from `torch.cuda.memory_allocated()` and the peak of
`torch.cuda.max_memory_allocated()` within each third, in MiB; the peaks
are reset after a warm-up of 11 frames, and `peak_mem_mb_post_warmup` is
the largest of them. Memory is None on the CPU. The JSON result is the
last line of stdout (and `--out` writes it too). Runs on CUDA by default
and never falls back to the CPU (see `scripts/_common.py`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def torus_base(h: int, w: int, seed: int = 0) -> np.ndarray:
    """The textured base image the frames pan over: a seeded random field
    of 8x8 blocks, 256 px larger than a frame each way."""
    rng = np.random.default_rng(seed)
    small = rng.random(((h + 8) // 8 + 32, (w + 8) // 8 + 32, 3)).astype(
        np.float32)
    return np.kron(small, np.ones((8, 8, 1), np.float32))


def torus_frame(base: np.ndarray, i: int, h: int, w: int) -> np.ndarray:
    """Frame i: a crop panning 17 px down and 23 px across per frame that
    wraps around `base`, so any frame count costs O(1) host memory."""
    bh, bw = base.shape[0] - h, base.shape[1] - w
    y, x = (17 * i) % bh, (23 * i) % bw
    return np.ascontiguousarray(base[y: y + h, x: x + w])


def _mem_mb(device, peak=False):
    if torch.device(device).type != "cuda":
        return None
    b = (torch.cuda.max_memory_allocated(device) if peak
         else torch.cuda.memory_allocated(device))
    return round(b / 2**20, 1)


def main(argv=None, model=None) -> dict:
    """Run the soak; `model` (a full-width `Splatt3RModel` on the device)
    skips building one. Returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.soak",
        description=__doc__.split("\n")[0])
    cm.add_device_args(ap)
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--kf-every", type=int, default=5)
    ap.add_argument("--kf-capacity", type=int, default=512,
                    help="keyframe buffer capacity (shrink it to reach the "
                         "over-capacity path in a short run)")
    ap.add_argument("--max-edges", type=int, default=512)
    ap.add_argument("--max-gaussians", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)
    if args.frames < 3:
        ap.error("--frames must be at least 3 (the run is reported in "
                 "thirds)")

    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.runtime.frame import (
        FramePrefetcher,
        Mode,
        create_frame,
    )
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.splat import GaussianAccumulator

    cm.load_base_config()
    # pinned cadence; no data-driven keyframes or RELOC (random weights)
    cfgmod.config["tracking"]["match_frac_thresh"] = -1.0
    cfgmod.config["tracking"]["min_match_frac"] = 0.0
    cfgmod.config["local_opt"]["max_edges"] = args.max_edges

    cfg = cm.model_config(tiny)
    h, w = cm.hw(tiny)
    engine = InferenceEngine(cm.make_model(cfg, device, model), h, w)
    system = SLAMSystem(engine, h, w, max_gaussians=args.max_gaussians)
    system.keyframes.buffer = args.kf_capacity
    system.backend = FactorGraph(engine, system.keyframes)
    system.gaussian_module = GaussianAccumulator(
        spatial_stride=4, min_confidence=0.0, max_scale=1e9,
        depth_max_percentile=1.0, depth_min=-1e9)

    base = torus_base(h, w)
    n = args.frames
    prefetch = FramePrefetcher(
        lambda i: create_frame(i, torus_frame(base, i, h, w), img_size=w,
                               device=device), n)

    thirds = []
    t0 = t_start = time.time()
    mem0 = None
    pool_evictions = prev_pool_n = over_capacity_frames = 0
    try:
        for i in range(n):
            frame = prefetch.get(i)
            force = i > 0 and i % args.kf_every == 0
            system.process_frame(frame, force_keyframe=force)
            if system.mode == Mode.RELOC:
                # random weights: GN failures flip to RELOC; stay in
                # TRACKING (the soak measures the long-horizon buffers)
                system.mode = Mode.TRACKING
                if force:
                    system.add_keyframe(frame)
            if int(system.pool.n) < prev_pool_n:
                pool_evictions += 1
            prev_pool_n = int(system.pool.n)
            if len(system.keyframes) > args.kf_capacity:
                over_capacity_frames += 1
            if i == 10:
                cm.sync(device)
                mem0 = _mem_mb(device)  # after the warm-up
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
            if (i + 1) % (n // 3) == 0 and len(thirds) < 3:
                cm.sync(device)
                now = time.time()
                thirds.append({
                    "fps": round((n // 3) / (now - t0), 3),
                    "mem_mb": _mem_mb(device),
                    "peak_mem_mb": _mem_mb(device, peak=True),
                    "keyframes": len(system.keyframes),
                    "edges": len(system.backend.ii),
                    "gaussians": int(system.pool.n),
                })
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                t0 = now
    finally:
        prefetch.close()
        system.close()

    peaks = [t["peak_mem_mb"] for t in thirds if t["peak_mem_mb"] is not None]
    out = {
        "frames": n,
        "kf_every": args.kf_every,
        "kf_capacity": args.kf_capacity,
        "max_edges": args.max_edges,
        "max_gaussians": args.max_gaussians,
        "tiny": tiny,
        "wall_s": round(time.time() - t_start, 1),
        "thirds": thirds,
        "mem_mb_post_warmup": mem0,
        "peak_mem_mb_post_warmup": max(peaks) if peaks else None,
        "pool_evictions": pool_evictions,
        "keyframes_final": len(system.keyframes),
        "edges_final": len(system.backend.ii),
        "gaussians_final": int(system.pool.n),
        "over_capacity_frames": over_capacity_frames,
        **cm.device_fields(device),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
