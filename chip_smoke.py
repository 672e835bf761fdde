#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--out results.json]

Phases, each printing one line of its own; any failure exits non-zero:

1. build   — compile splatt3r_slam_tpu_torch/csrc/composite.cu and
             composite_bwd.cu with nvcc (sm_90a) from this checkout, one
             nvcc each, started together; print the build seconds and what
             ptxas says of each kernel's registers and spills;
2. kernel  — hold the tile compositor against its plain PyTorch version
             (`composite_torch`) at the production shape (393,216 gaussians,
             384x512, tpg_side=4, k_max=512), on a tile list longer than one
             chunk and on the background-only case, within 1e-4 (both fp32;
             they differ only in summation order); time both with CUDA
             events and compute the kernel's bound from this scene's counts;
   kernel-bwd — hold the backward compositor against its plain version
             (`composite_bwd_torch`) at the production shape, at the
             training shape (196,608 gaussians, 256x384, k_max=256), on the
             multi-chunk tile and on the background-only case, with a
             seeded random cotangent whose transmittance column is
             non-zero, and against torch autograd through `composite_torch`
             on the multi-chunk scene; each gradient column within 1e-4 of
             that column's largest entry (both fp32; they differ in
             summation order, and (D - A)/(1 - alpha) cancels for deep
             rows, so the error over the rows at depth 384-511 of capped
             tiles is reported on its own); time both, bound as above;
3. slice   — the port's serving path at full width: TwoViewConfig() defaults
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
4. train   — the port's training path at full width: the same model with
             seeded random weights under `Trainer` with
             TrainConfig(render_loss=True, ssim_weight=0.1,
             mast3r_loss_weight=1.0, k_max=256), 3 steps of
             `synthetic_batches` at 256x384 (B=1, V=1) through
             `make_train_step`: every loss finite, a gaussian-DPT weight
             moved and an encoder weight did not, forward and backward
             compositor launches each equal to steps·B·V; one
             `make_eval_step` call; then one more step under torch.profiler
             (`port.train.*` spans), and both kernels against their plain
             versions, timed, on that step's own rows;
5. device  — the card's name and power limit (nvidia-smi);
then one JSON line with the kernel table and, last, the ok/device line.

Precision: torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are both set False, so fp32 matmuls and
convolutions (the pose solve, fp32 head projections) run in full fp32; the
bf16 trunk is unaffected.

Random weights give no valid matches, so every tracked frame fails its
pose solve and the state machine enters RELOC, which needs the backend and
retrieval (later slices). The run puts the system back into TRACKING after
such a frame, so that each frame goes through the fused tracking step.
The training data is synthetic (normal-noise images and targets), as the
train CLI's dry runs use.
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
# backward, per pixel-row pair: du, dv (2), the conic quadratic (9), exp
# (2), opacity product (1), clamp, 1/255 test and 0.99 test (3), weight (1),
# g·c (5), accumulator FMA (2), 1 - alpha (1), colour gradients (3),
# dL/dalpha (4), dL/dpower (1), opacity gradient (1), u and v gradients (4
# each), conic gradients (3 each), transmittance update (1), and one add
# per pair into each of the nine sums over pixels (9)
OPS_PER_PAIR_BWD = 62
ROW_BYTES = 9 * 4
TRAIN_HW = (256, 384)
TRAIN_STEPS = 3
BWD_TOL = 1e-4  # of each gradient column's largest entry


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


def _bound_bwd_ms(counts):
    """Least time for one backward composite over these counts: the larger
    of the live pairs' fp32 operations over the fp32 peak and the bytes
    (each live row read once and its gradient row written once, counts,
    origins, and gout and out read at 32 B per pixel) over the memory
    rate."""
    n_rows = int(counts.sum())
    T = counts.shape[0]
    t_ops = n_rows * 256 * OPS_PER_PAIR_BWD / PEAK_FP32 * 1e3
    t_bytes = (2 * n_rows * ROW_BYTES + T * 12 + T * 256 * 32) \
        / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _bwd_errors(grows, want):
    """(largest |grows - want| over a column's largest |want|, largest
    absolute error): the backward's tolerance is per gradient column."""
    err = (grows - want).abs().amax(0)
    peak = want.abs().amax(0).clamp_min(1e-30)
    return float((err / peak).max()), float(err.max())


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


def _scene(torch, hw, seed):
    """Seeded production-size scene: two pointmap layers of H·W gaussians
    in front of a max(H, W)-focal camera (what render_frame draws per
    frame, and what a training render draws per view)."""
    H, W = hw
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = 2 * H * W
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
    built = cr.build()
    build_s = time.perf_counter() - t0
    assert set(built) == {"composite", "composite_bwd"}, sorted(built)
    print(f"[build] {build_s:.2f} s | " + " | ".join(
        f"{os.path.relpath(so, root)}: " + " ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln)
        for so, log in built.values()))
    results["build_s"] = build_s

    # -- 2. kernel against its plain version --------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K = torch.tensor([[512.0, 0, W / 2], [0, 512.0, H / 2], [0, 0, 1]],
                     device="cuda")
    view = torch.eye(4, device="cuda")
    means, scales, q, colors, opa = _scene(torch, (H, W), seed=0)
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
    small = []  # (counts, origins, rows) of the two small cases
    for case in (
        (m_mc, c_mc, torch.rand(n_mc, 3, device="cuda", generator=g),
         torch.full((n_mc,), 0.05, device="cuda")),
        (torch.tensor([[0.0, 0.0, -1.0]], device="cuda"), c_mc[:1] * 100,
         torch.ones(1, 3, device="cuda"), torch.ones(1, device="cuda")),
    ):
        cnt, org, rw = cr.pack_rows(*case, view, K64, (64, 64))
        small.append((cnt, org, rw))
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

    # -- 2b. backward kernel against its plain version -----------------------
    def bwd_case(cnt, org, rw, seed):
        """→ (gout, out, kernel grows, plain grows) on a seeded cotangent
        whose transmittance column is non-zero."""
        out = cr.composite(cnt, org, rw, bg)
        gg = torch.Generator(device="cuda").manual_seed(seed)
        gout = torch.randn(out.shape, device="cuda", generator=gg)
        gk = cr.composite_bwd(cnt, org, rw, gout, out)
        torch.cuda.synchronize()
        assert torch.isfinite(gk).all(), "backward kernel output not finite"
        return gout, out, gk, cr.composite_bwd_torch(cnt, org, rw, gout, out)

    gout, out_k, gk, gp = bwd_case(counts, origins, rows, 10)
    bwd_rel, bwd_abs = _bwd_errors(gk, gp)
    # the deep rows of capped tiles, where (D - A)/(1 - alpha) cancels most
    deep = ((counts == 512)[:, None]
            & (torch.arange(512, device="cuda") >= 384)[None]).reshape(-1)
    assert bool(deep.any()), "no tile at the cap in the production scene"
    deep_rel = float(((gk - gp)[deep].abs().amax(0)
                      / gp.abs().amax(0).clamp_min(1e-30)).max())
    dead = (torch.arange(512, device="cuda")[None]
            >= counts[:, None]).reshape(-1)
    assert not bool(gk[dead].any()), "gradient in rows beyond a tile's count"
    assert bwd_rel <= BWD_TOL, f"backward kernel vs plain {bwd_rel} (cap)"

    # the training shape: one view's render of two 256x384 pointmap layers
    Kt = torch.tensor([[384.0, 0, TRAIN_HW[1] / 2],
                       [0, 384.0, TRAIN_HW[0] / 2], [0, 0, 1]], device="cuda")
    tm, ts, tq, tc, to = _scene(torch, TRAIN_HW, seed=2)
    t_cnt, t_org, t_rows = cr.pack_rows(
        tm, cov_to_triu(build_covariance(ts, tq)), tc, to, view, Kt,
        TRAIN_HW, tpg_side=4, k_max=256)
    t_gout, t_out, t_gk, t_gp = bwd_case(t_cnt, t_org, t_rows, 11)
    train_rel, train_abs = _bwd_errors(t_gk, t_gp)
    assert train_rel <= BWD_TOL, f"backward kernel vs plain {train_rel} " \
        "(training shape)"

    small_rel = small_abs = 0.0
    for i, (cnt, org, rw) in enumerate(small):
        s_gout, _, s_gk, s_gp = bwd_case(cnt, org, rw, 12 + i)
        rel, ab = _bwd_errors(s_gk, s_gp)
        small_rel, small_abs = max(small_rel, rel), max(small_abs, ab)
    assert not bool(s_gk.any()), "background-only case has a gradient"
    assert small_rel <= BWD_TOL, f"multi-chunk/background backward {small_rel}"
    # and against torch autograd through the plain forward, on the
    # multi-chunk scene (small enough for the plain version's graph), with
    # d_bg as `Composite` takes it
    cnt, org, rw = small[0]
    rw_a = rw.clone().requires_grad_()
    bg_a = bg.clone().requires_grad_()
    rw_k = rw.clone().requires_grad_()
    bg_k = bg.clone().requires_grad_()
    out_a = cr.composite_torch(cnt, org, rw_a, bg_a)
    a_gout = torch.randn(out_a.shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(14))
    (out_a * a_gout).sum().backward()
    (cr.Composite.apply(cnt, org, rw_k, bg_k) * a_gout).sum().backward()
    auto_rel, _ = _bwd_errors(rw_k.grad, rw_a.grad)
    auto_bg = float((bg_k.grad - bg_a.grad).abs().max()
                    / bg_a.grad.abs().max())
    assert auto_rel <= BWD_TOL and auto_bg <= BWD_TOL, \
        f"Composite vs autograd: rows {auto_rel}, bg {auto_bg}"

    bwd_ms = _events_ms(
        lambda: cr.composite_bwd(counts, origins, rows, gout, out_k), 30,
        torch)
    bwd_plain_ms = _events_ms(
        lambda: cr.composite_bwd_torch(counts, origins, rows, gout, out_k), 3,
        torch)
    bwd_bound_ms, bwd_bound_by = _bound_bwd_ms(counts)
    t_fwd_ms = _events_ms(lambda: cr.composite(t_cnt, t_org, t_rows, bg), 30,
                          torch)
    t_bwd_ms = _events_ms(
        lambda: cr.composite_bwd(t_cnt, t_org, t_rows, t_gout, t_out), 30,
        torch)
    t_bwd_plain_ms = _events_ms(
        lambda: cr.composite_bwd_torch(t_cnt, t_org, t_rows, t_gout, t_out),
        3, torch)
    t_bwd_bound_ms, t_bwd_bound_by = _bound_bwd_ms(t_cnt)
    t_fwd_bound_ms, _ = _bound_ms(t_cnt)
    print(f"[kernel-bwd] composite_bwd_kernel max error / column peak "
          f"{bwd_rel:.3e} (production; {deep_rel:.3e} over rows 384-511 of "
          f"the {int((counts == 512).sum())} capped tiles), {train_rel:.3e} "
          f"(training shape), {small_rel:.3e} (multi-chunk + background), "
          f"{auto_rel:.3e} rows / {auto_bg:.3e} bg (Composite vs autograd "
          f"through composite_torch), tol {BWD_TOL:g} | at the cap "
          f"{bwd_ms:.4f} ms (median of 30) vs plain {bwd_plain_ms:.3f} ms, "
          f"bound {bwd_bound_ms:.4f} ms by {bwd_bound_by} | training shape "
          f"({int(t_cnt.sum())} rows, mean count "
          f"{float(t_cnt.float().mean()):.1f}, "
          f"{int((t_cnt == 256).sum())}/{t_cnt.shape[0]} tiles at the cap) "
          f"{t_bwd_ms:.4f} ms vs plain {t_bwd_plain_ms:.3f} ms, bound "
          f"{t_bwd_bound_ms:.4f} ms by {t_bwd_bound_by}; forward there "
          f"{t_fwd_ms:.4f} ms, bound {t_fwd_bound_ms:.4f} ms")
    results["kernel_bwd"] = dict(
        rel_err=bwd_rel, abs_err=bwd_abs, deep_rel_err=deep_rel,
        train_rel_err=train_rel, train_abs_err=train_abs,
        small_rel_err=small_rel, autograd_rel_err=auto_rel,
        autograd_bg_rel_err=auto_bg, ms=bwd_ms, plain_ms=bwd_plain_ms,
        bound_ms=bwd_bound_ms, bound_by=bwd_bound_by,
        train_shape=dict(rows=int(t_cnt.sum()), tiles=t_cnt.shape[0],
                         ms=t_bwd_ms, plain_ms=t_bwd_plain_ms,
                         bound_ms=t_bwd_bound_ms, bound_by=t_bwd_bound_by,
                         fwd_ms=t_fwd_ms, fwd_bound_ms=t_fwd_bound_ms))
    del gk, gp, t_gk, t_gp, gout, out_k, t_gout, t_out

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

    cr.launches = cr.bwd_launches = 0
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
    assert cr.bwd_launches == 0, "the serving path launched a backward"

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

    # -- 4. the training path at full width -----------------------------------
    from splatt3r_slam_tpu_torch.parallel import TrainConfig, Trainer
    from splatt3r_slam_tpu_torch.train import synthetic_batches

    del model, engine, sysm, last, frame, kf, cat
    torch.cuda.empty_cache()
    th, tw = TRAIN_HW
    B = V = 1
    t0 = time.perf_counter()
    trainer = Trainer(
        TwoViewConfig(),
        TrainConfig(render_loss=True, ssim_weight=0.1, mast3r_loss_weight=1.0,
                    k_max=256), device="cuda", seed=0)
    torch.cuda.synchronize()
    train_setup_s = time.perf_counter() - t0
    batches = list(synthetic_batches(TRAIN_STEPS + 2, B, th, tw, True,
                                     seed=0))
    named = dict(trainer.model.named_parameters())
    head_key = "downstream_head1.gaussian_dpt.dpt.head.4.weight"
    enc_key = "enc_blocks.0.attn.qkv.weight"
    assert named[head_key].requires_grad and not named[enc_key].requires_grad
    head_before = named[head_key].detach().clone()
    enc_before = named[enc_key].detach().clone()
    step = trainer.make_train_step()

    torch.cuda.reset_peak_memory_stats()
    cr.launches = cr.bwd_launches = 0
    step_ms, losses = [], []
    for batch in batches[:TRAIN_STEPS]:
        ta = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ta) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
        assert all(np.isfinite(v) for v in losses[-1].values()), losses[-1]
    train_launches, train_bwd_launches = cr.launches, cr.bwd_launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    want = TRAIN_STEPS * B * V
    assert train_launches == want and train_bwd_launches == want, \
        f"{train_launches} forward / {train_bwd_launches} backward " \
        f"launches for {want} renders"
    assert torch.isfinite(named[head_key]).all(), "gaussian head not finite"
    head_moved = float((named[head_key].detach() - head_before).abs().max())
    assert head_moved > 0, "no gaussian-DPT weight changed"
    assert torch.equal(named[enc_key].detach(), enc_before), \
        "an encoder weight changed"

    ta = time.perf_counter()
    emetrics, rendered = trainer.make_eval_step()(batches[TRAIN_STEPS])
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - ta) * 1e3
    emetrics = {k: float(v) for k, v in emetrics.items()}
    assert tuple(rendered.shape) == (B, V, th, tw, 3)
    assert all(np.isfinite(emetrics[k]) for k in ("mse", "psnr", "ssim")), \
        emetrics

    # one more step under the profiler (after the launch counts are read),
    # keeping what the backward compositor was given
    seen = {}
    real_bwd = cr.composite_bwd

    def keep_bwd(*a):
        seen["args"] = tuple(t.detach() for t in a)
        return real_bwd(*a)

    cr.composite_bwd = keep_bwd
    try:
        t_wall, t_busy, t_spans = _profile_frame(
            torch, lambda: step(batches[TRAIN_STEPS + 1]))
    finally:
        cr.composite_bwd = real_bwd
    s_cnt, s_org, s_rows, s_gout, s_out = seen["args"]
    zero = torch.zeros(3, device="cuda")
    s_fwd_err = float((cr.composite(s_cnt, s_org, s_rows, zero)
                       - cr.composite_torch(s_cnt, s_org, s_rows, zero))
                      .abs().max())
    assert s_fwd_err <= TOL, f"training-path forward vs plain {s_fwd_err}"
    s_gk = cr.composite_bwd(s_cnt, s_org, s_rows, s_gout, s_out)
    s_gp = cr.composite_bwd_torch(s_cnt, s_org, s_rows, s_gout, s_out)
    s_rel, s_abs = _bwd_errors(s_gk, s_gp)
    s_peak = float(s_gp.abs().max())
    assert s_rel <= BWD_TOL, f"training-path backward vs plain {s_rel}"
    # autograd launches the backward's kernels from its own thread, so the
    # profiler attributes none of them to the span: take the remainder
    t_bwd_dev = t_busy - sum(d for k, (_, d) in t_spans.items()
                             if k.startswith("port.train.")
                             and k != "port.train.backward")
    s_bwd_ms = _events_ms(
        lambda: cr.composite_bwd(s_cnt, s_org, s_rows, s_gout, s_out), 30,
        torch)
    s_fwd_ms = _events_ms(lambda: cr.composite(s_cnt, s_org, s_rows, zero),
                          30, torch)
    s_bwd_plain_ms = _events_ms(
        lambda: cr.composite_bwd_torch(s_cnt, s_org, s_rows, s_gout, s_out),
        3, torch)
    s_bound_ms, s_bound_by = _bound_bwd_ms(s_cnt)
    print(f"[train] {TRAIN_STEPS} steps {th}x{tw} B={B} V={V} ViT-L bf16, "
          f"gaussian heads only (setup {train_setup_s:.1f} s) | step ms "
          + ", ".join(f"{m:.1f}" for m in step_ms)
          + " | loss " + ", ".join(f"{m['loss']:.4f}" for m in losses)
          + f" (mse {losses[-1]['mse']:.4f}, ssim {losses[-1]['ssim']:.4f}, "
          f"regr3d {losses[-1]['regr3d']:.4f}) | peak memory "
          f"{peak_gb:.2f} GiB | compositor launches forward "
          f"{train_launches} / backward {train_bwd_launches} = renders "
          f"{want} | {head_key} moved by {head_moved:.2e}, {enc_key} "
          f"unchanged | eval {eval_ms:.1f} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in emetrics.items())
          + f" | a step's own rows ({int(s_cnt.sum())} rows, mean count "
          f"{float(s_cnt.float().mean()):.1f}): backward {s_bwd_ms:.4f} ms "
          f"vs plain {s_bwd_plain_ms:.3f} ms, bound {s_bound_ms:.5f} ms by "
          f"{s_bound_by}, forward {s_fwd_ms:.4f} ms; kernel vs plain "
          f"forward {s_fwd_err:.2e}, backward {s_rel:.2e} of column peak "
          f"({s_abs:.2e} absolute, largest gradient entry {s_peak:.2e})")
    print(f"[train-profile] one step: wall {t_wall:.2f} ms, device kernels "
          f"{t_busy:.2f} ms (idle {max(0.0, 1 - t_busy / t_wall):.1%}) | "
          + ", ".join(f"{k} {h:.2f} ms open / {d:.2f} ms on the device"
                      for k, (h, d) in sorted(t_spans.items(),
                                              key=lambda kv: -kv[1][0]))
          + f" | port.train.backward by remainder: {t_bwd_dev:.2f} ms on "
          "the device (its kernels run from autograd's thread)")
    results["train"] = dict(
        steps=TRAIN_STEPS, hw=TRAIN_HW, step_ms=step_ms, losses=losses,
        peak_gib=peak_gb, launches=train_launches,
        bwd_launches=train_bwd_launches, head_moved=head_moved,
        eval_ms=eval_ms, eval=emetrics,
        own_rows=dict(rows=int(s_cnt.sum()), bwd_ms=s_bwd_ms,
                      fwd_ms=s_fwd_ms, bwd_plain_ms=s_bwd_plain_ms,
                      bound_ms=s_bound_ms, bound_by=s_bound_by,
                      fwd_err=s_fwd_err, bwd_rel_err=s_rel,
                      bwd_abs_err=s_abs, bwd_peak=s_peak),
        profile=dict(wall_ms=t_wall, device_ms=t_busy, spans=t_spans,
                     backward_device_ms_by_remainder=t_bwd_dev))

    # -- 5. device ----------------------------------------------------------
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
        "launches": launches + train_launches,
        "max_abs_err": max(err, extra_err, path_err, s_fwd_err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "launches_serving": launches, "launches_training": train_launches,
    }, {
        "name": "composite_bwd_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "splatt3r_slam_tpu/splat/pallas_rasterizer.py:202",
        "launches": train_bwd_launches,
        # on the seeded scenes, whose cotangent is unit normal; a training
        # step's own gradients are held relative to their peak (below)
        "max_abs_err": max(bwd_abs, train_abs, small_abs),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
        "max_err_over_column_peak": max(bwd_rel, train_rel, small_rel,
                                        s_rel),
        "ms_training_shape": t_bwd_ms,
        "bound_ms_training_shape": t_bwd_bound_ms,
        "launches_serving": 0, "launches_training": train_bwd_launches,
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
