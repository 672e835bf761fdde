"""Per-stage times of the port's tracking step, with FLOPs and MFU.

    python -m splatt3r_slam_tpu_torch.scripts.profile_stages [--iters N]
        [--device cuda|cpu] [--tiny]

Counterpart of the repository's `scripts/profile_stages.py`. It times each
stage of `runtime/fused.py::fused_track_step` in isolation at the working
shape (384x512, ViT-L, bf16, seeded random weights, config/base.yaml):
the encoder, the decoder, head 1 and head 2 in tracking mode, subgrid
matching at the configured stride, the Gauss-Newton pose solve
(`opt_pose_ray_dist_sim3`), and the whole fused step. Each stage runs
`--iters` times after two warm-up calls; `<stage>_ms` is the host time
per call of that window, which ends in a device synchronise, and
`device_ms` holds each stage's kernel time per call on the card (the sum
of its kernels' device time under torch.profiler over two more calls;
None on the CPU), so `1 - device_ms / <stage>_ms` is the card's idle
share; `kernels_per_call` counts the kernel launches, and
`fused_step_top_kernels` names the fused step's five longest kernels
(ms and launches per call). `sum_stages_ms` adds the stages and `fusion_gain_ms` is that sum
less the fused step.

FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over one fused
step, which counts matrix products, convolutions and scaled dot-product
attention: `fused_step_gflop`, `achieved_tflops` over the fused step's
time, and `mfu_pct_vs_h100_bf16_peak` against the H100 SXM data sheet's
989 TFLOP/s of dense bf16 (`device` and `power_limit_w` say which card and
limit that was; a card below 700 W runs slower under load). The JAX
script's `bytes_accessed_gb` comes from XLA's cost model, which has no
counterpart here that counts the same bytes, so it is left out. The JSON
result is the last line of stdout. Runs on CUDA by default and never falls
back to the CPU (see `scripts/_common.py`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

H100_BF16_DENSE_FLOPS = 989e12


def timeit(fn, device, iters=10, warmup=2):
    """→ (host ms per call over `iters` chained calls ending in a
    synchronise, `kernel_profile` of two more calls or None on the
    CPU)."""
    from splatt3r_slam_tpu_torch.scripts._common import kernel_profile, sync

    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    host = (time.perf_counter() - t0) / iters * 1e3
    return host, kernel_profile(fn, device)


def fused_step_flops(step) -> int:
    """FLOPs of one call of `step` as FlopCounterMode counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        step()
    return int(fc.get_total_flops())


def main(argv=None, model=None) -> dict:
    """Profile the stages; `model` (a full-width `Splatt3RModel` on the
    device) skips building one. Returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.profile_stages",
        description=__doc__.split("\n")[0])
    cm.add_device_args(ap)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)

    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.ops import matching
    from splatt3r_slam_tpu_torch.runtime.fused import (
        KFState,
        MatchingParams,
        fused_track_step,
    )
    from splatt3r_slam_tpu_torch.tracking import TrackingConfig
    from splatt3r_slam_tpu_torch.tracking.tracker import (
        opt_pose_ray_dist_sim3,
    )

    cm.load_base_config()
    cfg = cm.model_config(tiny)
    h, w = cm.hw(tiny)
    n = h * w
    model = cm.make_model(cfg, device, model)
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.random((1, h, w, 3)), dtype=torch.float32,
                          device=device)

    with torch.no_grad():
        feat, pos = model.encode(img)
        d1, d2 = model.decode(feat, pos, feat, pos)
        # the per-frame path skips the gaussian DPTs (head mode
        # "tracking"); gaussians are made later, for renders only
        res11 = model.apply_head(1, d1, (h, w), "tracking")
        res21 = model.apply_head(2, d2, (h, w), "tracking")

    mcfg = MatchingParams.from_config(cfgmod.config)
    s = max(1, int(mcfg.match_stride))

    def sub(a):
        return a[:, ::s, ::s] if s > 1 else a

    def f_match():
        return matching.match(
            sub(res11["pts3d"]), sub(res21["pts3d"]), sub(res11["desc"]),
            sub(res21["desc"]), None, max_iter=mcfg.max_iter,
            lambda_init=mcfg.lambda_init,
            convergence_thresh=mcfg.convergence_thresh,
            dist_thresh=mcfg.dist_thresh, radius=mcfg.radius,
            dilation_max=mcfg.dilation_max,
            closed_form_init=mcfg.closed_form_init,
            polish_iters=mcfg.polish_iters,
            refine_schedule=mcfg.refine_schedule,
            refine_quantize=mcfg.refine_quantize)

    with torch.no_grad():
        idxb, validb = f_match()
    tcfg = TrackingConfig()
    ns = (h // s) * (w // s)
    idx, valid = idxb[0], validb[0]
    Xff = sub(res11["pts3d"])[0].reshape(ns, 3)
    Xkf = sub(res21["pts3d"])[0].reshape(ns, 3)
    Qk = torch.sqrt(sub(res11["desc_conf"])[0].reshape(ns, 1)[idx]
                    * sub(res21["desc_conf"])[0].reshape(ns, 1))
    T_id = sim3.identity(device=device)
    kf = KFState(feat=feat, pos=pos, X=res21["pts3d"][0].reshape(n, 3),
                 C=torch.ones((n, 1), device=device),
                 N_fused=torch.tensor(1.0, device=device), T_WC=T_id)

    stages = {
        "encode": lambda: model.encode(img),
        "decode": lambda: model.decode(feat, pos, feat, pos),
        "head1": lambda: model.apply_head(1, d1, (h, w), "tracking"),
        "head2": lambda: model.apply_head(2, d2, (h, w), "tracking"),
        "match": f_match,
        "gn": lambda: opt_pose_ray_dist_sim3(Xff[idx], Xkf, T_id, T_id, Qk,
                                             valid, tcfg),
        "fused_step": lambda: fused_track_step(model, img, kf, T_id, None, h,
                                               w, tcfg, mcfg),
    }
    times, prof = {}, {}
    with torch.no_grad():
        for name, fn in stages.items():
            times[f"{name}_ms"], prof[f"{name}_ms"] = timeit(
                fn, device, iters=args.iters)
        flops = fused_step_flops(stages["fused_step"])
    times["sum_stages_ms"] = sum(
        v for k, v in times.items() if k != "fused_step_ms")
    times["fusion_gain_ms"] = times["sum_stages_ms"] - times["fused_step_ms"]
    out = {k: round(v, 2) for k, v in times.items()}
    out["device_ms"] = {k: (round(v["ms"], 3) if v else None)
                        for k, v in prof.items()}
    out["kernels_per_call"] = {k: (v["launches"] if v else None)
                               for k, v in prof.items()}
    out["fused_step_top_kernels"] = (prof["fused_step_ms"]["top"]
                                     if prof["fused_step_ms"] else None)
    tsec = times["fused_step_ms"] / 1e3
    out["fused_step_gflop"] = round(flops / 1e9, 1)
    out["achieved_tflops"] = round(flops / tsec / 1e12, 3)
    out["mfu_pct_vs_h100_bf16_peak"] = (
        round(100.0 * flops / tsec / H100_BF16_DENSE_FLOPS, 2)
        if device.type == "cuda" else None)
    out["match_stride"] = s
    out["backend"] = device.type
    out["hw"] = f"{h}x{w}"
    out.update(cm.device_fields(device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
