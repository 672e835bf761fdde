#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--out results.json]

Phases, each printing one line of its own; any failure exits non-zero:

1. build   — compile splatt3r_slam_tpu_torch/csrc/composite.cu with nvcc
             (sm_90a) from this checkout and print the build seconds;
2. kernel  — hold the tile compositor against its plain PyTorch version
             (`composite_torch`) at the production shape (393,216 gaussians,
             384x512, tpg_side=4, k_max=512), on a tile list longer than one
             chunk and on the background-only case, within 1e-4 (both fp32;
             they differ only in summation order); time both with CUDA
             events and compute the kernel's bound from this scene's counts;
3. slice   — the port's main path at full width: TwoViewConfig() defaults
             (ViT-L encoder, 768x12 decoder, 256-wide DPT, bf16 trunk and
             heads) with seeded random weights, config/base.yaml defaults,
             InferenceEngine → SLAMSystem(backend=None) with main.py's
             GaussianAccumulator → process_frame on panned synthetic
             384x512 frames → ensure_gaussians + render_frame every frame;
             the compositor's launch count must equal the number of renders;
             then the kernel against its plain version on the last frame's
             own gaussians, and one more frame under torch.profiler (host
             time each `port.*` span was open, device time of the kernels
             launched inside it, and the device's idle share);
4. device  — the card's name and power limit (nvidia-smi);
then one JSON line with the kernel table and, last, the ok/device line.

Precision: torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are both set False, so fp32 matmuls and
convolutions (the pose solve, fp32 head projections) run in full fp32; the
bf16 trunk is unaffected.

Random weights give no valid matches, so every tracked frame fails its
pose solve and the state machine enters RELOC, which needs the backend and
retrieval (later slices). The run puts the system back into TRACKING after
such a frame, so that each frame goes through the fused tracking step.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

H, W = 384, 512
FRAMES = 10
TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# per pixel-row pair: du, dv (2), the conic quadratic (9), exp (counted
# as 2), opacity product, clamp and 1/255 test (3), weight (1), 3 colour
# FMAs (6), transmittance update (2)
OPS_PER_PAIR = 25
ROW_BYTES = 9 * 4


def _events_ms(fn, reps, torch):
    """Median per-call device time over `reps` calls (CUDA events)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(counts):
    """Least time for one composite over these counts: the larger of the
    live pairs' fp32 operations over the fp32 peak and the bytes (each
    live row read once, counts, origins, bg, the (T·256, 4) output
    written once) over the memory rate."""
    n_rows = int(counts.sum())
    T = counts.shape[0]
    t_ops = n_rows * 256 * OPS_PER_PAIR / PEAK_FP32 * 1e3
    t_bytes = (n_rows * ROW_BYTES + T * 12 + 12 + T * 256 * 16) \
        / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _profile_frame(torch, run_frame):
    """One frame under torch.profiler → (wall ms, device kernel ms, spans):
    spans maps each `port.*` span to (host ms it was open, device ms of
    the kernels launched inside it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def on_cuda(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    def dev_ms(e, self_only=False):
        name = "self_device_time_total" if self_only else "device_time_total"
        old = name.replace("device", "cuda")
        v = getattr(e, name, None)
        return (getattr(e, old, 0) if v is None else v) / 1e3

    kernels = sum(dev_ms(e, self_only=True) for e in prof.key_averages()
                  if on_cuda(e) and not e.key.startswith("port."))
    spans: dict = {}
    for e in prof.events():
        if e.name.startswith("port.") and not on_cuda(e):
            host, dev = spans.get(e.name, (0.0, 0.0))
            spans[e.name] = (host + e.cpu_time_total / 1e3, dev + dev_ms(e))
    return wall_ms, kernels, spans


def _scene(torch, n_pix, seed):
    """Seeded production-size scene: two pointmap layers of H·W gaussians
    in front of a 512-focal camera (what render_frame draws per frame)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = 2 * n_pix
    v, u = torch.meshgrid(torch.arange(H, device="cuda"),
                          torch.arange(W, device="cuda"), indexing="ij")
    uv = torch.stack([u, v], -1).reshape(-1, 2).float().repeat(2, 1)
    z = 1.0 + 2.0 * torch.rand(G, device="cuda", generator=g)
    f = float(max(H, W))
    means = torch.stack([(uv[:, 0] + 0.5 - W / 2) * z / f,
                         (uv[:, 1] + 0.5 - H / 2) * z / f, z], -1)
    scales = (0.5 + 2.0 * torch.rand(G, 3, device="cuda", generator=g)) \
        * (z / f)[:, None]
    q = torch.randn(G, 4, device="cuda", generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    colors = torch.rand(G, 3, device="cuda", generator=g)
    opa = 0.3 + 0.7 * torch.rand(G, device="cuda", generator=g)
    return means, scales, q, colors, opa


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.models import TwoViewConfig, init_model
    from splatt3r_slam_tpu_torch.runtime.frame import Mode, create_frame
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.splat import GaussianAccumulator
    from splatt3r_slam_tpu_torch.splat import cuda_rasterizer as cr
    from splatt3r_slam_tpu_torch.splat.decoder import (
        frame_gaussians,
        render_frame,
    )
    from splatt3r_slam_tpu_torch.splat.gaussians import (
        build_covariance,
        cov_to_triu,
    )

    results: dict = {}

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so, log = cr.build()
    build_s = time.perf_counter() - t0
    ptxas = " ".join(ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln)
    print(f"[build] {build_s:.2f} s {os.path.relpath(so, root)} | {ptxas}")
    results["build_s"] = build_s

    # -- 2. kernel against its plain version --------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K = torch.tensor([[512.0, 0, W / 2], [0, 512.0, H / 2], [0, 0, 1]],
                     device="cuda")
    view = torch.eye(4, device="cuda")
    means, scales, q, colors, opa = _scene(torch, H * W, seed=0)
    covt = cov_to_triu(build_covariance(scales, q))
    counts, origins, rows = cr.pack_rows(means, covt, colors, opa, view, K,
                                         (H, W), tpg_side=4, k_max=512)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    out_k = cr.composite(counts, origins, rows, bg)
    out_p = cr.composite_torch(counts, origins, rows, bg)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    assert torch.isfinite(out_k).all(), "kernel output not finite"
    assert err <= TOL, f"kernel vs plain max-abs {err} > {TOL}"

    # a tile list longer than one 128-row chunk, and background only
    g = torch.Generator(device="cuda").manual_seed(1)
    n_mc = 400
    m_mc = torch.zeros(n_mc, 3, device="cuda")
    m_mc[:, :2] = 0.02 * torch.randn(n_mc, 2, device="cuda", generator=g)
    m_mc[:, 2] = torch.linspace(2.0, 6.0, n_mc, device="cuda")
    c_mc = torch.tensor([1e-4, 0, 0, 1e-4, 0, 1e-4],
                        device="cuda").expand(n_mc, 6).contiguous()
    K64 = torch.tensor([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]],
                       device="cuda")
    extra_err = 0.0
    for case in (
        (m_mc, c_mc, torch.rand(n_mc, 3, device="cuda", generator=g),
         torch.full((n_mc,), 0.05, device="cuda")),
        (torch.tensor([[0.0, 0.0, -1.0]], device="cuda"), c_mc[:1] * 100,
         torch.ones(1, 3, device="cuda"), torch.ones(1, device="cuda")),
    ):
        cnt, org, rw = cr.pack_rows(*case, view, K64, (64, 64))
        a = cr.composite(cnt, org, rw, bg)
        b = cr.composite_torch(cnt, org, rw, bg)
        extra_err = max(extra_err, float((a - b).abs().max()))
    assert int(cnt.sum()) == 0, "background case should bin no gaussians"
    assert extra_err <= TOL, f"multi-chunk/background max-abs {extra_err}"

    ms = _events_ms(lambda: cr.composite(counts, origins, rows, bg), 30,
                    torch)
    plain_ms = _events_ms(
        lambda: cr.composite_torch(counts, origins, rows, bg), 5, torch)
    n_rows = int(counts.sum())
    T = counts.shape[0]
    pairs = n_rows * 256
    bound_ms, bound_by = _bound_ms(counts)
    print(f"[kernel] composite_kernel max_abs_err {err:.3e} (production), "
          f"{extra_err:.3e} (multi-chunk + background), tol {TOL:g} | "
          f"{ms:.4f} ms (median of 30) vs plain {plain_ms:.3f} ms | "
          f"bound {bound_ms:.4f} ms by {bound_by} ({n_rows} rows, "
          f"{pairs} pairs, mean count {n_rows / T:.1f}, "
          f"{int((counts == 512).sum())}/{T} tiles at the cap)")
    results["kernel"] = dict(max_abs_err=err, extra_err=extra_err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, rows=n_rows, tiles=T)

    # -- 3. the main path at full width -------------------------------------
    cfgmod.reset_config()  # config/base.yaml defaults
    t0 = time.perf_counter()
    model = init_model(TwoViewConfig(), seed=0, device="cuda")
    engine = InferenceEngine(model, H, W)
    sysm = SLAMSystem(engine, H, W, gaussian_module=GaussianAccumulator(
        spatial_stride=4, depth_max_percentile=0.98, max_scale=0.5,
        min_confidence=1.5))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    base = (rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8)

    cr.launches = 0
    track_ms, gauss_ms, render_ms, modes, renders = [], [], [], [], 0
    last = None

    def run_frame(i):
        """One frame as main.py runs it: track, then render."""
        img = base[i: i + H, 2 * i: 2 * i + W]
        frame = create_frame(i, img, img_size=W, device="cuda")
        ta = time.perf_counter()
        mode, _ = sysm.process_frame(frame)
        torch.cuda.synchronize()
        tb = time.perf_counter()
        if mode == Mode.RELOC:
            sysm.mode = Mode.TRACKING  # see the module docstring
        engine.ensure_gaussians(frame)
        torch.cuda.synchronize()
        tg = time.perf_counter()
        kf = sysm.keyframes.last_keyframe()
        out = render_frame(frame, kf if kf is not None else frame)
        torch.cuda.synchronize()
        tc = time.perf_counter()
        assert out is not None and out.shape == (H, W, 3), "no render"
        assert torch.isfinite(out).all(), f"render {i} not finite"
        return mode, frame, kf, ((tb - ta) * 1e3, (tg - tb) * 1e3,
                                 (tc - tg) * 1e3)

    for i in range(FRAMES):
        mode, frame, kf, (t_track, t_gauss, t_render) = run_frame(i)
        modes.append(mode.name)
        renders += 1
        track_ms.append(t_track)
        gauss_ms.append(t_gauss)
        render_ms.append(t_render)
        last = (frame, kf)
    launches = cr.launches
    assert launches == renders, f"{launches} launches for {renders} renders"

    # right on the main path's own data: the kernel against its plain
    # version on the last frame's gaussians (read after the launch count,
    # so these launches are not counted)
    frame, kf = last
    view = torch.linalg.inv(sim3.matrix(frame.T_WC)) @ sim3.matrix(frame.T_WC)
    cat = frame_gaussians(frame, kf)
    cnt, org, rw = cr.pack_rows(*cat, view, K, (H, W))
    zero = torch.zeros(3, device="cuda")
    a = cr.composite(cnt, org, rw, zero)
    b = cr.composite_torch(cnt, org, rw, zero)
    path_err = float((a - b).abs().max())
    assert path_err <= TOL, f"main-path kernel vs plain {path_err}"
    path_ms = _events_ms(lambda: cr.composite(cnt, org, rw, zero), 30,
                         torch)
    path_plain_ms = _events_ms(
        lambda: cr.composite_torch(cnt, org, rw, zero), 5, torch)
    path_bound_ms, path_bound_by = _bound_ms(cnt)
    # render_tiles (the JAX XLA path's counterpart) evaluates the power in
    # another order, so alpha's 1/255 cut can fall elsewhere: reported, not
    # held to the kernel's tolerance
    ref = render_frame(frame, kf, rasterizer="torch")
    got = render_frame(frame, kf, rasterizer="cuda")
    tiles_err = float((ref - got).abs().max())
    steady = slice(2, None) if FRAMES > 3 else slice(0, None)
    print(f"[slice] {FRAMES} frames {H}x{W} ViT-L bf16 (setup "
          f"{setup_s:.1f} s) | process_frame median "
          f"{statistics.median(track_ms[steady]):.2f} ms, ensure_gaussians "
          f"median {statistics.median(gauss_ms[steady]):.2f} ms, "
          f"render_frame median {statistics.median(render_ms[steady]):.2f} "
          f"ms (frames 2+; tf32 off for matmul and cudnn) | keyframes "
          f"{len(sysm.keyframes)} | pool "
          f"{sysm.pool.n} | compositor launches {launches} = renders "
          f"{renders} | modes {','.join(modes)} | last frame: kernel vs "
          f"plain {path_err:.2e}, render vs render_tiles {tiles_err:.2e}, "
          f"mean count {float(cnt.float().mean()):.1f}, kernel "
          f"{path_ms:.4f} ms vs plain {path_plain_ms:.3f} ms, bound "
          f"{path_bound_ms:.5f} ms by {path_bound_by}")
    results["slice"] = dict(frames=FRAMES, track_ms=track_ms,
                            gauss_ms=gauss_ms, render_ms=render_ms,
                            modes=modes,
                            keyframes=len(sysm.keyframes),
                            pool=sysm.pool.n, launches=launches,
                            kernel_vs_plain=path_err,
                            render_vs_render_tiles=tiles_err,
                            kernel_ms=path_ms, plain_ms=path_plain_ms,
                            bound_ms=path_bound_ms)
    # one more frame under the profiler (after the launch count is read)
    wall, busy, spans = _profile_frame(torch, lambda: run_frame(FRAMES))
    print(f"[profile] one frame: wall {wall:.2f} ms, device kernels "
          f"{busy:.2f} ms (idle {max(0.0, 1 - busy / wall):.1%}) | "
          + ", ".join(f"{k} {h:.2f} ms open / {d:.2f} ms on the device"
                      for k, (h, d) in sorted(spans.items(),
                                              key=lambda kv: -kv[1][0])))
    results["profile"] = dict(wall_ms=wall, device_ms=busy, spans=spans)

    # -- 4. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} | nvidia-smi: {smi}")
    results["device"] = dict(kind=kind, smi=smi)

    kernels = [{
        "name": "composite_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/composite.cu",
        "replaces": "splatt3r_slam_tpu/splat/pallas_rasterizer.py:61",
        "launches": launches,
        "max_abs_err": max(err, extra_err, path_err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
