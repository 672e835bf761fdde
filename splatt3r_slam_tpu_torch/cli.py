"""Splatt3R-SLAM on PyTorch: the command-line SLAM run.

    python -m splatt3r_slam_tpu_torch --dataset PATH [--config FILE]
        [--no-viz] [--device cuda|cpu] [...]

Counterpart of the repository's `main.py`, with its flags plus `--device`
(default `cuda`; asking for CUDA without a GPU raises). Frames are read
and resized on the host (`runtime/dataloader.py`, `utils/image.py`),
tracked by `SLAMSystem` with the pose-graph backend (`FactorGraph`) and
ASMK retrieval attached, and each `--render-stride`-th frame's splat
render is written as a PNG one frame late. Unless `--no-viz` is given,
the viewer (`runtime/visualization.py`) ticks every 10th frame once the
pool holds gaussians: in a window when `DISPLAY` is set, else headless,
writing each tick's canvas as a PNG under `logs/<save-as>/<seq>_viz/`;
its controls feed back into the run (`_apply_gui_state`, pause and next-
frame). At the end come the TUM trajectory, the PLY reconstruction and
the keyframe PNGs under `logs/<save-as>/`. With `--calib FILE` (or a
config with `use_calib`) each frame is undistorted on the host and the
tracking and backend solves run calibrated on the resized frame's
intrinsics. Weights come from `--checkpoint`, else from `checkpoints/`
in the repository, else seeded random weights; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import sys
import time

import numpy as np

HF_CKPT = "epoch=19-step=1200.ckpt"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch",
        description="Splatt3R-SLAM (PyTorch/CUDA)")
    p.add_argument("--dataset", required=True,
                   help="path: tum/eth3d/7-scenes dir, RGB folder, video "
                        "file, 'webcam', or 'realsense'")
    p.add_argument("--config", default="config/base.yaml")
    p.add_argument("--calib", default="",
                   help="intrinsics YAML ({width, height, calibration: [fx, "
                        "fy, cx, cy, k1, k2, p1, p2(, k3)]} or fx, fy, cx, "
                        "cy, distortion): turns use_calib on and undistorts "
                        "each frame")
    p.add_argument("--checkpoint", default=None,
                   help="Splatt3R .ckpt / MASt3R .pth (torch state dict); "
                        "omit to use checkpoints/ in the repository, else "
                        "seeded random weights. Never downloads")
    p.add_argument("--require-checkpoint", action="store_true",
                   help="error out instead of falling back to random "
                        "weights")
    p.add_argument("--retrieval-checkpoint", default=None)
    p.add_argument("--codebook", default=None)
    p.add_argument("--save-as", default="default")
    p.add_argument("--no-viz", action="store_true",
                   help="no viewer (by default it ticks every 10th frame, "
                        "headless without DISPLAY)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--no-gaussians", action="store_true")
    p.add_argument("--gaussian-stride", "--spatial-stride", type=int,
                   default=4, dest="gaussian_stride",
                   help="spatial subsampling stride of appended gaussians")
    p.add_argument("--max-gaussians", type=int, default=4 * 1024 * 1024)
    p.add_argument("--depth-max-percentile", type=float, default=0.98,
                   help="drop gaussians deeper than this depth percentile "
                        "(1.0 disables)")
    p.add_argument("--max-scale", type=float, default=0.5,
                   help="drop gaussians whose largest scale axis exceeds "
                        "this")
    p.add_argument("--min-confidence", type=float, default=1.5,
                   help="drop gaussians below this pointmap confidence "
                        "(0 disables)")
    p.add_argument("--render-stride", type=int, default=1,
                   help="export a splat render PNG every N frames (0 = off)")
    p.add_argument("--c-conf-threshold", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny-model", action="store_true",
                   help="scaled-down model (CPU smoke runs)")
    p.add_argument("--flash-attention", choices=("auto", "on", "off"),
                   default="auto",
                   help="attention through the port's flash-attention "
                        "kernel (csrc/flash_attention.cu): 'on' wherever "
                        "n_q and n_kv are multiples of 256 and Dh of 64, "
                        "'auto' on the GPU once n_q*n_kv >= 4096^2, 'off' "
                        "never; otherwise "
                        "torch.nn.functional.scaled_dot_product_attention. "
                        "Forward only: training under 'on' raises")
    p.add_argument("--no-prewarm", action="store_true",
                   help="accepted for main.py's flag surface; eager "
                        "PyTorch has nothing to compile ahead, so it does "
                        "nothing")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p.parse_args(argv)


def load_model_params(args, cfg_model, device):
    """The model with weights from --checkpoint, else checkpoints/ in the
    repository, else seeded random weights (or an error with
    --require-checkpoint)."""
    from splatt3r_slam_tpu_torch.models import Splatt3RModel, init_model
    from splatt3r_slam_tpu_torch.models.checkpoint import (
        load_state_dict,
        load_torch_checkpoint,
    )

    ckpt = args.checkpoint
    if ckpt is None:
        local = pathlib.Path(__file__).resolve().parents[1] / "checkpoints" \
            / HF_CKPT
        if local.exists():
            ckpt = str(local)
        elif args.require_checkpoint:
            raise SystemExit(f"--require-checkpoint: no checkpoint at {local} "
                             "and none given with --checkpoint")
        else:
            print(f"no checkpoint at {local} (the port never downloads)")
    if ckpt is None:
        print("WARNING: no checkpoint found — using random weights "
              "(geometry will be meaningless).")
        return init_model(cfg_model, seed=args.seed, device=device)
    print(f"Loading Splatt3R checkpoint: {ckpt}")
    model = Splatt3RModel(cfg_model).to(device)
    load_state_dict(model, load_torch_checkpoint(ckpt))
    return model.eval().requires_grad_(False)


def build_retrieval(args, cfg_model, device):
    """The retrieval database from --retrieval-checkpoint / --codebook, or
    None if building it fails: the run goes on without loop closure and
    relocalization, as `main.py` does."""
    from splatt3r_slam_tpu_torch.retrieval import RetrievalDatabase

    try:
        return RetrievalDatabase(
            checkpoint_path=args.retrieval_checkpoint,
            codebook_path=args.codebook, feat_dim=cfg_model.enc_embed_dim,
            proj_dim=min(cfg_model.enc_embed_dim, 1024), device=device)
    except Exception as e:
        print(f"retrieval disabled: {e}")
        return None


def _apply_gui_state(system, args, state):
    """Apply the viewer's live controls to the running system: the pool's
    capacity and the appended gaussians' spatial stride each tick; the
    confidence threshold gates the PLY export only (the gaussian filter
    keeps --min-confidence)."""
    if state.max_gaussians > 0:
        system.pool.max_gaussians = state.max_gaussians
    if system.gaussian_module is not None:
        system.gaussian_module.kw["spatial_stride"] = state.spatial_stride
    args.c_conf_threshold = state.C_conf_threshold


def main(argv=None):
    args = parse_args(argv)

    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch import resolve_device, set_fp32_precision
    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.models import TwoViewConfig
    from splatt3r_slam_tpu_torch.models.layers import set_flash_attention
    from splatt3r_slam_tpu_torch.runtime import evaluate as ev
    from splatt3r_slam_tpu_torch.runtime.dataloader import (
        Intrinsics,
        load_dataset,
    )
    from splatt3r_slam_tpu_torch.runtime.frame import (
        FramePrefetcher,
        create_frame,
    )
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.splat import GaussianAccumulator
    from splatt3r_slam_tpu_torch.splat.decoder import render_frame
    from splatt3r_slam_tpu_torch.utils.image import write_png

    import torch

    set_fp32_precision()
    device = resolve_device(args.device)
    set_flash_attention(args.flash_attention)
    cfg = cfgmod.load_config(args.config)
    if args.calib:
        with open(args.calib) as f:
            cfgmod.config["calib_params"] = cfgmod.parse_yaml(f.read(),
                                                              args.calib)
        cfgmod.config["use_calib"] = True

    dataset = load_dataset(args.dataset)
    dataset.img_size = args.img_size
    stride = cfg["dataset"]["subsample"]
    if stride > 1 and dataset.save_results:
        dataset.subsample(stride)
    if args.calib:
        # {width, height, calibration: [...]} or fx, fy, cx, cy, distortion
        c = cfgmod.config["calib_params"]
        _, (H0, W0) = dataset.get_img_shape()
        if "calibration" in c:
            calib_vec = list(c["calibration"])
        else:
            calib_vec = [c["fx"], c["fy"], c["cx"], c["cy"]] + list(
                c.get("distortion", []))
        dataset.camera_intrinsics = Intrinsics.from_calib(
            dataset.img_size, c.get("width", W0), c.get("height", H0),
            calib_vec)
        dataset.use_calibration = True
    (h, w), _ = dataset.get_img_shape()
    print(f"Working resolution: {h}x{w}")

    # model precision profile (config `model:` dtype / head_dtype)
    mknobs = cfgmod.config.get("model", {}) or {}
    defaults = TwoViewConfig._field_defaults
    cfg_model = TwoViewConfig(
        dtype=mknobs.get("dtype", defaults["dtype"]),
        head_dtype=mknobs.get("head_dtype", defaults["head_dtype"]))
    if args.tiny_model:
        cfg_model = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    engine = InferenceEngine(load_model_params(args, cfg_model, device), h, w)

    K = None
    if cfgmod.config.get("use_calib") and dataset.has_calib():
        K = torch.as_tensor(dataset.camera_intrinsics.K_frame,
                            dtype=torch.float32, device=device)
    retrieval = build_retrieval(args, cfg_model, device)
    system = SLAMSystem(engine, h, w, K=K, max_gaussians=args.max_gaussians)
    system.backend = FactorGraph(engine, system.keyframes, K=K,
                                 retrieval=retrieval)
    if not args.no_gaussians:
        system.gaussian_module = GaussianAccumulator(
            spatial_stride=args.gaussian_stride,
            depth_max_percentile=args.depth_max_percentile,
            max_scale=args.max_scale, min_confidence=args.min_confidence)

    save_dir, seq_name = ev.prepare_savedir(args.save_as, dataset)
    render_dir = save_dir / f"{seq_name}_renders"
    if args.render_stride > 0:
        shutil.rmtree(render_dir, ignore_errors=True)
        render_dir.mkdir(parents=True, exist_ok=True)

    viewer = None
    if not args.no_viz:
        from splatt3r_slam_tpu_torch.runtime.visualization import Viewer

        viewer = Viewer(system, hw=(h, w),
                        headless=not os.environ.get("DISPLAY"),
                        out_dir=save_dir / f"{seq_name}_viz")
        # the GUI state starts from the flags, so headless ticks change
        # nothing
        viewer.state.C_conf_threshold = args.c_conf_threshold
        viewer.state.spatial_stride = args.gaussian_stride
        viewer.state.gs_on = not args.no_gaussians

    downsample = cfgmod.config["dataset"]["img_downsample"]
    n = len(dataset) if args.max_frames is None else min(len(dataset),
                                                         args.max_frames)

    def load(i):
        ts, img = dataset[i]
        return ts, create_frame(i, img, img_size=args.img_size,
                                downsample=downsample, device=device)

    prefetch = FramePrefetcher(load, n)
    timestamps = []
    # 1-render-lag PNG export: the previous frame's render is written while
    # the device computes the next one
    pending_render = None  # (frame index, device image)

    def flush_render():
        nonlocal pending_render
        if pending_render is None:
            return
        ri, img_r = pending_render
        pending_render = None
        out = (np.clip(img_r.float().cpu().numpy(), 0, 1) * 255).astype(
            np.uint8)
        write_png(render_dir / f"{ri:06d}.png", out)

    t0 = time.time()
    try:
        for i in range(n):
            ts, frame = prefetch.get(i)
            timestamps.append(ts)
            if K is not None:
                frame.K = K
            system.process_frame(frame)
            if args.render_stride > 0 and i % args.render_stride == 0:
                engine.ensure_gaussians(frame)
                if frame.gaussian_pred is not None:
                    kf = system.keyframes.last_keyframe()
                    img_r = render_frame(frame, kf if kf is not None
                                         else frame, K=K)
                    if img_r is not None:
                        flush_render()
                        pending_render = (i, img_r)
            if viewer is not None and i % 10 == 0 and system.pool.n > 0:
                state = viewer.update()
                _apply_gui_state(system, args, state)
                if state.is_terminated:
                    break
                while state.is_paused and not state.next and \
                        not state.is_terminated:
                    state = viewer.update()
                state.next = False
            if i % 30 == 29:
                fps = (i + 1) / (time.time() - t0)
                print(f"frame {i + 1}/{n}  FPS {fps:.2f}  mode {system.mode}"
                      f"  keyframes {len(system.keyframes)}")
    finally:
        prefetch.close()
        flush_render()
    system.close()
    elapsed = time.time() - t0
    print(f"done: {n} frames in {elapsed:.1f}s "
          f"({n / max(elapsed, 1e-9):.2f} FPS), "
          f"{len(system.keyframes)} keyframes")

    if dataset.save_results:
        ev.save_traj(save_dir, f"{seq_name}.txt", timestamps,
                     system.keyframes)
        ev.save_reconstruction(save_dir, f"{seq_name}.ply", system.keyframes,
                               args.c_conf_threshold)
        ev.save_keyframes(save_dir / f"{seq_name}_keyframes", timestamps,
                          system.keyframes)
        print(f"results under {save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
