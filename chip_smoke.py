#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--out results.json] [--parent DIR]

Phases, each printing one line of its own; any failure exits non-zero:

1. build   — compile every kernel of the port from this checkout:
             splatt3r_slam_tpu_torch/csrc/composite.cu and composite_bwd.cu
             (both include composite_common.cuh), flash_attention.cu
             (6 template instances: bf16 and fp32, Dh 64/128/256, and 2
             wide kernels, bf16 and fp32, that take every multiple of 128
             from Dh 384 up at run time, on thread-block clusters along
             Dh; all on the tensor cores, fp32 in split TF32) and
             flash_attention_bwd.cu (the dK/dV and dQ
             kernels, 12 template instances and 4 wide kernels, the fp32
             ones on thread-block clusters along Dh), with nvcc
             (sm_90a), one nvcc a source, started together
             (`cuda_build.build`); print the build seconds, each library's
             kernels (template instances and wide kernels) and what ptxas
             says of each kernel's registers and spills (no kernel may
             spill); then the host JPEG entropy walk csrc/jpeg_huffman.cpp
             with g++ (`[build-host]`);
2. kernel  — hold the tile compositor against its plain PyTorch version
             (`composite_torch`) at the production shape (393,216 gaussians,
             384x512, tpg_side=4, k_max=512), on a tile list longer than one
             chunk, on the background-only case, on tiles whose counts sit
             on the chunk and ring boundaries (0, 1, 127, 128, 129, k_max)
             and on a k_max that is no multiple of 4 (30), within 1e-4 (both
             fp32; they differ only in summation order); time the kernel
             and compute its bound from this scene's counts;
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
             tiles is reported on its own); the boundary counts and the
             unaligned k_max as above; in every case exact zeros in the
             rows at and beyond each tile's count, although the wrapper
             hands the kernel uninitialised memory, and the same bits from
             two runs; time both, bound as above;
3. slice   — the port's serving path at full width: TwoViewConfig() defaults
             (ViT-L encoder, 768x12 decoder, 256-wide DPT, bf16 trunk and
             heads) with seeded random weights, config/base.yaml defaults,
             InferenceEngine → SLAMSystem with main.py's GaussianAccumulator,
             pose-graph backend (FactorGraph) and retrieval
             (RetrievalDatabase, feat_dim = proj_dim = 1024, 65,536 words) →
             process_frame on panned synthetic 384x512 frames, a keyframe
             forced every other frame → ensure_gaussians + render_frame every
             frame; the compositor's launch count must equal the number of
             renders, and each keyframe after the first must add the
             neighbour edge from the tracking half and run the stride-2 /
             gn_stride 16 solve; then the kernel against its plain version
             on the last frame's own gaussians, and one more (keyframe)
             frame under torch.profiler (host time each `port.*` span was
             open, device time of the kernels launched inside it, and the
             device's idle share);
4. closed-loop — the SLAM loop closed on the plane-scene oracle at full
             width: PlaneSceneOracle(inner=engine, plane (0.12, 0.08, 1) ·
             X = 2, stride 2) around an engine on phase 3's model, base.yaml
             unchanged (bf16 trunk, match stride 2, gn_stride 16, normal GN
             iterations, no keyframe forced), the fused frontend with the
             oracle's geometry swapped in on the device, FactorGraph with
             OracleRetrieval(inner=RetrievalDatabase(65,536 words)), and
             ensure_gaussians + render_frame every frame, over
             pan_trajectory(40, 512). The real encoder, decoder, heads and
             matcher run on every frame and are paid for; tracking, the
             keyframe criterion, the backend's solves and RELOC run on exact
             geometry. It checks no RELOC and no GN failure, 4-10 keyframes,
             an edge to every keyframe after the first, a solve of more than
             one GN iteration, compositor launches equal to the renders,
             real encoder features beyond [0, 0, 0], the Sim(3)-aligned
             keyframe ATE below 0.16 m (the JAX package's CI budget), and
             the kernel against its plain version on the last frame's rows;
             it prints median host ms of process_frame on tracked frames and
             on keyframes, on_keyframe, the solve's GN iterations and
             render_frame, then one tracked frame and one keyframe under
             torch.profiler. Then the noisy kidnapped-camera variant:
             reloc_pan_trajectory(30, 512, (16, 20)), noise 0.01, conf_noise
             0.2, an occlusion window at frames 16-19; it must enter RELOC
             through the tracking gate and not before frame 16, relocalize
             at least once, end in TRACKING with 4-12 keyframes, and keep
             the ATE over the keyframes outside the window below 0.25 m (the
             ATE over all keyframes is printed: a blacked-out frame that
             relocalizes onto the last keyframe through the consecutive
             edge, which is never gated, keeps the seed keyframe's pose,
             as in the JAX package);
4b. entry — the measurement entry points, each through its `main(argv,
             model=...)` on phase 3's model at full width (ViT-L, 384x512),
             its printed JSON held to be its last line, the compositor's
             counts set to 0 just before each and read just after:
             `splatt3r_slam_tpu_torch.bench` (three passes of 37 timed
             frames; every input of every fused step and every parameter on
             cuda); `scripts.bench_system --cadence 5 --threaded
             --retrieval --render-stride 1` over 40 frames (8 keyframes, one
             backend task per keyframe drained with no worker failure,
             forward compositor launches equal to the renders, 40 in the
             warm-up and 40 timed, no backward launch); `--oracle --fused
             --lag` over 40 frames (no RELOC, 4-10 keyframes, keyframe ATE
             below 0.16 m); `--reloc-events 3` over 8 frames (3 successes);
             `scripts.soak` over 120 frames with a keyframe every 3, a
             keyframe buffer of 16, 24 edges and 262,144 gaussians (more
             than 16 keyframes, frames over the capacity counted, edges and
             gaussians within their caps in every third, a pool eviction;
             device memory and FPS per third printed);
             `scripts.profile_stages` (`sum_stages_ms` and
             `fused_step_gflop` above 0) and
             `scripts.profile_keyframe_event`, whose JSON is printed;
4c. viz   — on phase 3's model and the noise-free closed loop's system
             (its keyframes, edges and gaussian pool), each part with the
             compositor's counts set to 0 just before it and read just
             after: `Viewer(system, hw=(384, 512), headless=True)` ticks
             once in each mode (splat colour, splat depth, surfels at
             stride 4 from the last 16 keyframes, scatter; overlays and
             image panels on), each tick a 384x512x3 PNG, forward launches
             equal to the 3 renders (scatter renders none), and the kernel
             against its plain version on the surfel view's and the splat
             view's own rows (surfel rows timed); the session saved with
             its FactorGraph and loaded into a fresh system and graph on the
             same engine: poses, X_canon, C, features, pool rows and every
             edge list bit for bit, the viewer's splat render identical,
             one backend solve on each within 1e-6; `demo.main` on two
             panned 384x512 PNGs it writes, `--n-views 8`: a PLY of 393,216
             vertices, 8 PNGs, 8 launches, the kernel against its plain
             version on the last view's rows (timed); the web app
             (`serve(engine, port=0)` on a thread): POST /reconstruct with
             the two PNGs, GET /render at three yaws (3 launches, each JPEG
             body the one `encode_jpeg` writes for `engine.render`'s
             pixels) and /gaussians.ply;
             `scripts.sweep_rasterizer_fidelity` in full (30k, 150k, 600k
             gaussians at 192x256; k_max 128-1024; tpg_side 2, 4, 8: 36
             launches), the production caps (tpg_side 4, k_max 512) at PSNR
             >= 88 dB against the exact oracle at every density (the bar
             PARITY.md records), and the kernel against its plain
             version on the 600k, k_max 1024, tpg_side 2 rows (timed);
5. train   — the port's training path at full width: the same model with
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
5b. dist  — multi-GPU training at world size 1 over NCCL (one card, one
             rank), at full width: `graft_entry.entry()` (the flagship
             two-view forward, TwoViewConfig() at 384x512, seeded weights;
             pts3d (1, 384, 512, 3) and finite; forward ms printed);
             `train.main(["--devices", "1", ...])` with phase 5's recipe
             (256x384, B=1, V=1, 3 steps), which opens its own process
             group: the backend is nccl, the mesh (1, 1, 1), every model
             parameter a DTensor, forward and backward compositor launches
             each 3, the CSV and the checkpoint written, the group closed
             after; then 2 steps of the mesh `Trainer` and 2 of the
             single-device `Trainer` from the same seeded weights and
             batches, cuDNN's deterministic algorithms on: each step's loss
             within 1e-4 relative and every parameter after the steps
             within 2·lr, both printed with the step times and peak memory
             beside phase 5's, and both kernels against their plain
             versions on the mesh step's own rows (the backward per
             column within 1e-4 of its peak or within the plain version's
             own difference between the card and the CPU, where a
             column's peak is at cancellation level);
             `graft_entry.dryrun_multichip(1)` (the tiny model's full-loss
             step, every parameter training): loss, mse, ssim, lpips and
             regr3d finite, loss != regr3d, one launch each way. Each line
             carries the card's name and power limit;
6. cli     — `python -m splatt3r_slam_tpu_torch --dataset
             tests/fixtures/tum/rgbd_dataset_freiburg1_fixture --config
             tests/fixtures/tum/eval_fixture.yaml --no-viz --seed 0` run in
             this process through the module's `main(argv)`, from a
             temporary working directory: full width, --img-size 512 (the
             fixture's 320x240 frames upscaled to 512x384), fp32 heads,
             full-resolution matching and backend rows, retrieval on every
             keyframe, a keyframe forced every frame and a relaxed RELOC
             gate (the fixture config), 12 frames. It checks exit 0, one
             trajectory row per keyframe with the timestamps of rgb.txt, a
             PLY with vertices, the keyframe PNGs, one render PNG per frame,
             forward compositor launches equal to the renders and no
             backward launch, at least one solve and an edge to every
             keyframe after the first, and the kernel against its plain
             version on the last render's rows; it prints the mode sequence,
             keyframes, edges, solves, Cholesky failures, relocalizations,
             median host ms of process_frame, on_keyframe, the solve, the
             retrieval update and render_frame (each timed with a
             synchronise before and after), the run's seconds and the ATE
             against groundtruth.txt (printed, not held: the weights are
             random); then one more keyframe through the backend under
             torch.profiler (`port.backend.*`, `port.retrieval`);
6b. viz-cli — the same CLI run as users run it by default: without
             --no-viz and with DISPLAY unset, so that the viewer ticks
             headless every 10th frame once the pool holds gaussians; the
             checks of 6, one viewer PNG per tick, forward launches equal to
             the renders plus the ticks; the run's seconds printed beside
             the --no-viz run's;
6c. jpeg  — JPEG without cv2 (`utils/jpeg.py`; `sys.modules["cv2"] = None`
             for the whole phase, restored after): the committed corpus
             (tests/fixtures/jpeg) decoded by both entropy walks and held
             against cv2's committed pixels within one level, the
             differing values counted; host ms per decode (C++ walk, plain
             Python walk, each with its walk's share) beside `decode_png`
             at 320x240, 640x480 and 752x480 (the TUM frame, resized,
             quality 95); the CLI of 6 on the fixture's 24 frames written
             as quality-95 JPEG into a folder (`RGBFiles`), with the checks
             of 6 and its seconds beside 6's; `demo.main` on two JPEG files
             (2 views, 2 launches) and the web app with a JPEG upload (200)
             and a `/render` that is `image/jpeg`, read back by the port's
             decoder (1 launch), on a fresh full-width model. Each line
             carries the card's name and power limit;
7. calib   — the same CLI with calibrated input, with the checks of 6: the
             fixture with `--calib` pointing at a YAML written here (width
             320, height 240, fr1's calibration halved: 258.65, 258.25,
             159.3, 127.65, and fr1's five distortion coefficients), and a
             EuRoC `mav0/cam0` layout written here (12 seeded 752x480
             grayscale PNGs, data.csv, the sensor.yaml of EuRoC cam0 with
             its published intrinsics and distortion) under the fixture
             config with use_calib on. Each must undistort every frame on
             the host and run calibrated tracking solves and
             `solve_GN_calib`; it prints the undistortion's host ms per
             frame;
7b. scripts — the kernel, model and accuracy scripts and the ablation
             runner, each through its `main` as a user runs it (CUDA,
             defaults), the compositor's counts set to 0 just before each
             and read just after, each result printed on a `[scripts-*]`
             line: `scripts.bench_rasterizer` (400k, 1M and 4M gaussians at
             384x512, 6 forward launches each; the image against the plain
             renderer's within 2e-3, the JAX tests' compositor bar; then the
             kernel against its plain version on each scene's own rows,
             timed, with its bound); `scripts.bench_rasterizer_grad` (400k:
             `backward_validated_on_hardware` true; 30 forward and 11
             backward launches; both kernels against their plain versions
             on its last backward's rows, the backward timed, with its
             bound); `scripts.bench_attention` (flash and efficient SDPA run
             at every shape; einsum vs SDPA within 0.05); `scripts.
             bench_heads_batched tracking` (bf16 heads at full width; the
             vmapped pair within 2^-5 of the peak of the sequential one);
             `scripts.sweep_accuracy` (in a temporary directory; the
             reference-exact variant tracks every pair); `ablations` (six
             recipes, each a fresh full-width model on the world-size-1
             mesh, 5 steps at 32x48: finite metrics, 30 launches each way);
             `scripts.make_tum_fixture` into a temporary directory (the
             committed fixture's pixels, its text files byte-identical),
             `scripts.compute_ate` of the committed groundtruth against
             itself (0) and `scripts.convert_lpips` of a seeded state dict
             (loads back through `load_lpips_params`); no other launch;
             bench_attention's flash rows are the phase's only launches of
             the flash-attention kernel (3 shapes x 34 calls);
7c. flash — the flash-attention path (`--flash-attention on`; the kernel
             csrc/flash_attention.cu replaces the TPU kernel that
             `splatt3r_slam_tpu/models/layers.py::_attend_flash` reaches):
             the kernel against its plain version (`flash_attention_torch`)
             in the working dtype, within 2^-7 of the output's peak in bf16
             and 1e-5 in fp32, at ViT-L's shapes (B2 N768 Dh64: encoder H16,
             decoder self and cross H12), on v strided as the fused qkv
             projection hands it over, at n_q 768 x n_kv 1024, in fp32 (B1
             N768 H16), at `auto`'s threshold (B1 N4096 H16), at the B1
             shapes where the main paths call it (each view alone: B1 N768
             H16 with v strided, the encoder; B1 N768 H12, the decoder),
             and in fp32 at the fp32 comparison step's own B1 shapes (the
             same two) and at Dh 128 and 256 (B1 n_q 256 n_kv 512 H4, Dh
             128 with v strided), every fp32 row with its residuals l and
             m within 1e-5 of the plain version's; the wide kernels in bf16
             and fp32 with their residuals at Dh 384 and 512 (B1 n_q 256
             n_kv 512 H4), B1 N768 H8 Dh 512, B1 n_q 256 n_kv 512 H2
             Dh 1024 and B1 n_q 256 n_kv 512 H1 Dh 1152 (the clusters'
             passes above Dh 1024); each timed (`ms`,
             `call_ms`) beside the plain version, SDPA on the same inputs
             (`library_ms`) and the bound (in fp32 the faster of the fp32
             pipes and split TF32 on the tensor cores), with its blocks,
             blocks an SM (the occupancy API), waves and ptxas registers
             (`flash_attention_plan`; for the wide kernels also the
             cluster's blocks and the clusters resident at once, the
             waves counted over those); held, untimed, with its residuals,
             at the scales 0.1 and -0.125 in bf16 and fp32
             (`[flash-scale]`); `auto` picks the kernel at N4096 and SDPA
             at N768; `attend` routed as the JAX package routes it
             (`[flash-route]`): with "on" and with "auto" at B1 N4096 H2
             Dh 192 and 320 (head dims the TPU kernel refuses) no launch
             and SDPA's output bit for bit, at Dh 384 one launch of the
             wide forward each, and under autograd with "on" one of the
             wide backward pair, held against the plain versions; the
             fixture CLI of 6 with --flash-attention on and
             without the flag in turns (on, auto, auto, on), with the
             checks of 6, every `attend` call of an `on` run a kernel
             launch and none in an `auto` run, the kernel held on the last
             call's own q, k and v; the same CLI with the model in fp32 (a
             config's `model:` dtype and head_dtype float32) with on and
             auto in turns (`[flash-cli-fp32]`, the same checks, every
             attend call in fp32); one tracked frame of a
             fresh ViT-L with the mode on under torch.profiler (the flash
             kernel's device time, the frame's idle share); `bench` with
             the mode on (tracking_fps_512x384, times only). Every other
             phase runs in the default mode ("auto") and launches the flash
             kernel no time (`_no_flash`), and no phase but 7d its
             backward;
7d. flash-train — full-finetune training with the mode on (the backward
             kernels csrc/flash_attention_bwd.cu replace the TPU kernels
             `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel`
             that the Pallas flash attention's VJP runs): at 7c's shapes
             (the full-finetune step's own B1 shapes among them), at Dh
             128 and 256 in bf16 and fp32 (B1 n_q 256 n_kv 512 H4, Dh 128
             with v strided), at 7c's rows of the wide kernels and, in
             fp32, at Dh 1152 (B1 n_q 256 n_kv 512 H1: the clusters' passes
             above Dh 1024), the fp32 wide pair run twice at each row and
             its gradients the same bits, the forward's output with its
             residuals l and m the same as without, l and m within 1e-5 of
             the plain version's, and both backward kernels against the
             plain backward (`flash_attention_bwd_torch`), each gradient
             within 2^-7 of its peak in bf16 and 1e-5 in fp32, each kernel
             timed (`ms`, `call_ms`) beside the plain backward, SDPA's
             backward on the same inputs (`library_ms`) and its bound (in
             fp32 the faster of the fp32 pipes and split TF32 on the
             tensor cores), and each kernel's blocks, blocks an SM (the
             occupancy API), cluster size and resident clusters
             (cudaOccupancyMaxActiveClusters) where it has clusters, waves,
             ptxas registers and spills, the fp32 pair also
             at the fp32 comparison step's own B1 shapes (N768 H16 with v
             strided, H12); `train.main` in this process
             with the mode on and
             train.train_gaussian_heads_only=false (every parameter
             training, remat on as the CLI's default), 3 steps at 384x512
             (768 tokens), B=1, V=1, the render-loss recipe of phase 5: each
             step's 96 attend calls (the encoder's 24 blocks once per view,
             the decoder's 12 blocks x 2 views x self and cross) launch
             the forward twice (the recompute) and each backward kernel
             once (the wide kernels' share of them read apart: none, as
             ViT-L's heads are 64 wide), step ms and peak memory printed,
             its third step under
             torch.profiler (`[flash-train-profile]`: the backward pair's
             device ms and launches in the step, the step's device time and
             idle share); then a step's forward
             and backward on one fresh model and batch with "on" and
             "auto" (SDPA) in turns (on, auto, auto, on), loss and gradient
             norm within 5e-2 of each other (bf16 and a render whose
             capped tile lists reorder), step ms and peak memory, and the
             kernels held on the last attention call's own tensors; and
             the same model in fp32 on the Regr3D loss alone (on, auto),
             within 1e-4 (`[flash-train-kernel]`, `[flash-train-main]`,
             `[flash-train-profile]`, `[flash-train-compare]`,
             `[flash-train]` lines);
7e. eval-tum — the port's TUM evaluation script
             (`python -m splatt3r_slam_tpu_torch.scripts.eval_tum`, the
             counterpart of scripts/eval_tum.sh) as its own process on the
             committed fixture at full width (TwoViewConfig(), seeded
             random weights, eval_fixture.yaml, EXTRA_ARGS without
             --require-checkpoint): a finite ATE line, trajectory rows of 8
             columns whose stamps lie within 0.02 s of the groundtruth's,
             the PLY, the keyframe and the render PNGs, and its seconds;
8. device  — the card's name and power limit (nvidia-smi);
then one JSON line with the kernel table and, last, the ok/device line.

With `--parent DIR` it also builds the `composite.cu` and `composite_bwd.cu`
found in DIR (an earlier commit's sources, e.g. written there with `git show
REV:path`; same C entry points) and, after phase 2, times them in turns
with this checkout's kernels at the production and the training shape, on
the device alone, median of 7 rounds (`[compare]`). The earlier backward
wrote live rows only, so it is timed with the memset it needs. Where DIR
holds a `flash_attention_bwd.cu`, it also builds that into a library of its
own and, after phase 7d, times its dK/dV and dQ kernels in turns with this
checkout's at every shape of 7d (the wide rows where DIR's source has the
fp32 wide kernels), median of 7 rounds, with the gradient elements
where the two builds differ and, for the fp32 wide pair, whether it is
faster at every row and its sum over the parent's (`[compare-flash-bwd]`);
where it holds a `flash_attention.cu`,
it builds that too and, after phase 7c, times its forward in turns with
this checkout's at every bf16 Dh-64 shape, every fp32 shape and every
wide row (both dtypes) of 7c, median of 7 rounds, with both `call_ms` and,
in bf16, the count of output elements where the two differ, in fp32 their
largest difference, and whether the wide forward is faster at B1 N768 H8
Dh 512 in both dtypes and at every fp32 wide row (`[compare-flash]`).
Each set of sources is compared only where DIR holds it. nvcc compiles
DIR's sources in DIR: a header that they include (`composite_common.cuh`,
or `flash_common.cuh` for the flash sources of this checkout and later)
must be put there too.

With `--wide-from-128` it also builds this checkout's two flash sources
again with `-DFLASH_WIDE_FROM=128`, where the wide kernels take Dh 128 and
256 in place of the template instances, holds the wide forward, its
residuals and the backward pair there against the plain versions at 7c's
and 7d's bars, and, after phase 7d, times the forward, dK/dV and dQ of the
two builds in turns at 7c's and 7d's Dh 128 and 256 rows, both dtypes,
median of 7 rounds (`[wide-vs-instances]`): why the instances stay.

Times. A kernel's `ms` is its time on the device alone: 20 launches enqueued
back to back behind a device-side delay, so that the host is ahead of the
card, between two CUDA events, divided by 20 (`device_ms`). Its `call_ms`
is one isolated call on an empty queue with the Python wrapper included,
which is what a main path with a few rows a tile pays. Plain versions are
timed per call.

Precision: `set_fp32_precision()` sets
torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
False, as every entry point of the port does, so fp32 matmuls and
convolutions (the pose solve, fp32 head projections) run in full fp32; the
bf16 trunk is unaffected.

Random weights give no valid matches, so on the network's own outputs a
GN step of the pose solve always fails and sends the frame to RELOC. Phase
3 therefore runs the tracking solve with max_iters 0 and min_match_frac 0
(it passes the seeded pose through, as tests/test_torch_port_slice.py
does), so that tracked frames succeed and the keyframes reach the backend;
a frame whose relocalization the backend refused would be put back into
TRACKING, and is counted. Phase 4 is how tracking, keyframing, the backend's
solves and RELOC run as users run them: on the oracle's exact geometry. The
cli phases keep the fixture config's GN iterations: their tracked frames
fail, and the relaxed RELOC gate of the fixture config lets the backend
relocalize the next frame. The training data is synthetic (normal-noise
images and targets), as the train CLI's dry runs use.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import warnings

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
SLEEP_CYCLES = 3_000_000  # about 1.7 ms at 1.75 GHz


def device_ms(fn, torch, launches: int = 20, groups: int = 5,
              sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Device time of one `fn()`: `launches` calls enqueued back to back
    behind a device-side delay of `sleep_cycles`, so the host runs ahead of
    the card and the two events bracket the card's work alone (the delay
    must outlast the host's enqueueing of the calls); median over
    `groups`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def call_ms(fn, torch, reps: int = 30) -> float:
    """Time of one isolated call of `fn()`, Python wrapper included, on an
    empty queue (CUDA events around one call, then a synchronise): what a
    caller with little device work pays. Median over `reps`."""
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


def seeded_scene(torch, hw, seed: int, layers: int = 2):
    """Seeded scene: `layers` pointmap layers of H·W gaussians in front of a
    max(H, W)-focal camera (what render_frame draws per frame, and what a
    training render draws per view) → (means, scales, quats, colors, opa)."""
    H, W = hw
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = layers * H * W
    v, u = torch.meshgrid(torch.arange(H, device="cuda"),
                          torch.arange(W, device="cuda"), indexing="ij")
    uv = torch.stack([u, v], -1).reshape(-1, 2).float().repeat(layers, 1)
    z = 1.0 + 2.0 * torch.rand(G, device="cuda", generator=g)
    f = float(max(H, W))
    means = torch.stack([(uv[:, 0] + 0.5 - W / 2) * z / f,
                         (uv[:, 1] + 0.5 - H / 2) * z / f, z], -1)
    scales = (0.5 + 2.0 * torch.rand(G, 3, device="cuda",
                                     generator=g)) * (z / f)[:, None]
    q = torch.randn(G, 4, device="cuda", generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    colors = torch.rand(G, 3, device="cuda", generator=g)
    opa = 0.3 + 0.7 * torch.rand(G, device="cuda", generator=g)
    return means, scales, q, colors, opa


def bwd_errors(grows, want):
    """(largest |grows - want| over a column's largest |want|, largest
    absolute error): the backward's tolerance is per gradient column."""
    err = (grows - want).abs().amax(0)
    peak = want.abs().amax(0).clamp_min(1e-30)
    return float((err / peak).max()), float(err.max())


def _compare_with_parent(torch, cr, parent, shapes, bg, rounds=7):
    """Build the two sources found in `parent` and time them in turns with
    this checkout's kernels on `shapes` {name: (counts, origins, rows, gout,
    out)} → {kernel: {shape: (parent ms, this checkout's ms)}}, each the
    median over `rounds` of a device-only time of 20 launches."""
    old = {}
    for name, (source, _, _) in cr.KERNELS.items():
        so = cr.BUILD_DIR / f"libparent_{name}.so"
        cr.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cr._nvcc(), *cr.NVCC_FLAGS, "-o", str(so),
                        os.path.join(parent, source.name)], check=True,
                       capture_output=True, timeout=600)
        old[name] = cr._entry(so, name)
    stream = torch.cuda.current_stream().cuda_stream

    def pair(cnt, org, rw, gout, out):
        """((earlier forward, this forward), (earlier backward, this
        backward)) on one shape, each a function that enqueues one run."""
        T, k_max = cnt.shape[0], rw.shape[0] // cnt.shape[0]
        o_buf, g_buf = torch.empty_like(out), torch.empty_like(rw)

        def old_fwd():
            assert old["composite"](
                cnt.data_ptr(), org.data_ptr(), rw.data_ptr(), bg.data_ptr(),
                o_buf.data_ptr(), T, k_max, stream) == 0

        def old_bwd():
            g_buf.zero_()  # the earlier kernel writes live rows only
            assert old["composite_bwd"](
                cnt.data_ptr(), org.data_ptr(), rw.data_ptr(),
                gout.data_ptr(), out.data_ptr(), g_buf.data_ptr(), T, k_max,
                stream) == 0

        old_fwd(), old_bwd()
        assert float((o_buf - out).abs().max()) <= TOL
        assert bwd_errors(g_buf, cr.composite_bwd(cnt, org, rw, gout,
                                                  out))[0] <= BWD_TOL
        return ((old_fwd, lambda: cr.composite(cnt, org, rw, bg)),
                (old_bwd, lambda: cr.composite_bwd(cnt, org, rw, gout, out)))

    runs = {}
    for shape, tensors in shapes.items():
        runs["composite", shape], runs["composite_bwd", shape] = \
            pair(*tensors)
    samples = {key: ([], []) for key in runs}
    for _ in range(rounds):
        for key, fns in runs.items():
            for got, fn in zip(samples[key], fns):
                got.append(device_ms(fn, torch, groups=1))
    found: dict = {}
    for (name, shape), got in samples.items():
        found.setdefault(name, {})[shape] = tuple(
            statistics.median(x) for x in got)
    return found


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


def _profile_frame(torch, run_frame, kernels=None):
    """One frame under torch.profiler → (wall ms, device kernel ms, spans):
    spans maps each `port.*` span to (host ms it was open, device ms of
    the kernels launched inside it). A dict given as `kernels` receives
    each device kernel's name and its device ms."""
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

    by_name = {e.key: dev_ms(e, self_only=True)
               for e in prof.key_averages()
               if on_cuda(e) and not e.key.startswith("port.")}
    if kernels is not None:
        kernels.update(by_name)
    spans: dict = {}
    for e in prof.events():
        if e.name.startswith("port.") and not on_cuda(e):
            host, dev = spans.get(e.name, (0.0, 0.0))
            spans[e.name] = (host + e.cpu_time_total / 1e3, dev + dev_ms(e))
    return wall_ms, sum(by_name.values()), spans


def _profile_kernels(torch, run):
    """`run()` under torch.profiler tracing the device alone (a training
    step's tens of thousands of host ops would cost the trace's processing
    seconds) → (wall ms, device kernel ms, {kernel: (device ms,
    launches)})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            v = getattr(e, "self_device_time_total", None)
            ms = (getattr(e, "self_cuda_time_total", 0) if v is None
                  else v) / 1e3
            kernels[e.key] = (ms, e.count)
    return wall_ms, sum(ms for ms, _ in kernels.values()), kernels


def _boundary_tiles(torch, counts, k_max, seed):
    """Tiles with the given counts and seeded random rows inside each tile
    (rows at and beyond a count hold values too: the kernels must not read
    them) → (counts, origins, rows)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = len(counts)
    n = T * k_max

    def rand(*shape):
        return torch.rand(*shape, device="cuda", generator=g)

    origins = torch.tensor([[16 * (t % 3), 16 * (t // 3)] for t in range(T)],
                           dtype=torch.int32, device="cuda")
    rows = torch.empty(n, 9, device="cuda")
    rows[:, 0:2] = (origins.float().repeat_interleave(k_max, 0)
                    + 16 * rand(n, 2))
    rows[:, 2] = 0.05 + 0.2 * rand(n)
    rows[:, 4] = 0.05 + 0.2 * rand(n)
    rows[:, 3] = 0.01 * (rand(n) - 0.5)
    rows[:, 5] = 0.3 * rand(n)
    rows[:, 6:9] = rand(n, 3)
    return (torch.tensor(counts, dtype=torch.int32, device="cuda"), origins,
            rows)


def _time_calls(torch, owner, name, store, keep=None, key=None):
    """Wrap `owner.name` (a class or an instance attribute) so that each
    call appends its host ms, with a synchronise before and after, to
    store[key or name]; `keep(args, kwargs, result)` may record more.
    Returns a function that restores the original."""
    real = getattr(owner, name)
    own = name in vars(owner)  # else a method found on the instance's class

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        store.setdefault(key or name, []).append(
            (time.perf_counter() - t0) * 1e3)
        if keep is not None:
            keep(a, kw, out)
        return out

    setattr(owner, name, timed)

    def restore():
        if own:
            setattr(owner, name, real)
        else:  # drop the instance attribute (a bound method would keep
            delattr(owner, name)  # the instance alive in a cycle)

    return restore


def _median(xs):
    return statistics.median(xs) if xs else float("nan")


def _keyframe_ate(torch, sysm, oracle, skip=()):
    """Sim(3)-aligned RMSE of the keyframe positions against the oracle's
    ground truth, over the keyframes whose frame id is not in `skip`."""
    import numpy as np

    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.runtime.evaluate import umeyama_alignment

    kfs = [sysm.keyframes[k] for k in range(len(sysm.keyframes))
           if sysm.keyframes[k].frame_id not in skip]
    est = np.stack([sim3.matrix(kf.T_WC).float().cpu().numpy()[:3, 3]
                    for kf in kfs]).astype(np.float64)
    gt = np.stack([oracle.gt[kf.frame_id][:3, 3] for kf in kfs])
    s, R, t = umeyama_alignment(est, gt)
    err = (s * (R @ est.T)).T + t - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def _closed_loop_phase(torch, cr, model, device="cuda"):
    """The SLAM loop closed on the plane-scene oracle at full width (the
    real network runs and is paid for; its outputs are swapped for exact
    geometry), noise-free over a 40-frame pan, then the noisy kidnapped-
    camera variant with an occlusion window → (lines, results, the
    noise-free run's system)."""
    import numpy as np

    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.retrieval import RetrievalDatabase
    from splatt3r_slam_tpu_torch.runtime import oracle as orc
    from splatt3r_slam_tpu_torch.runtime.frame import Mode, create_frame
    from splatt3r_slam_tpu_torch.runtime.fused import FusedTracker
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.splat import GaussianAccumulator
    from splatt3r_slam_tpu_torch.splat.decoder import render_frame

    rng = np.random.default_rng(1)
    texture = (rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8)

    def build(**noise):
        """base.yaml unchanged; oracle around the real engine; backend with
        the oracle's retrieval ranking around the real database."""
        cfgmod.reset_config()
        engine = InferenceEngine(model, H, W)
        oracle = orc.PlaneSceneOracle(H, W, plane_n=(0.12, 0.08, 1.0),
                                      plane_d=2.0, inner=engine,
                                      stride=2, **noise)
        sysm = SLAMSystem(oracle, H, W, gaussian_module=GaussianAccumulator(
            spatial_stride=4, depth_max_percentile=0.98, max_scale=0.5,
            min_confidence=1.5))
        dim = model.cfg.enc_embed_dim  # 1024 for ViT-L, as cli.py sizes it
        retrieval = orc.OracleRetrieval(oracle, inner=RetrievalDatabase(
            feat_dim=dim, proj_dim=min(dim, 1024), device=device))
        sysm.backend = FactorGraph(oracle, sysm.keyframes,
                                   retrieval=retrieval)
        return oracle, sysm

    def drive(oracle, sysm, poses, first, ms, seen):
        """Frames first.. of `poses` as main.py runs them (track, then
        render), no keyframe forced; host ms per frame by kind."""
        for i in range(first, len(poses)):
            oracle.register(i, poses[i])
            j = i % 40
            frame = create_frame(i, texture[j: j + H, 2 * j: 2 * j + W],
                                 img_size=W, device=device)
            was, n_kf = sysm.mode, len(sysm.keyframes)
            torch.cuda.synchronize()
            ta = time.perf_counter()
            mode, ok = sysm.process_frame(frame)
            torch.cuda.synchronize()
            tb = time.perf_counter()
            oracle.ensure_gaussians(frame)
            kf = sysm.keyframes.last_keyframe()
            out = render_frame(frame, kf if kf is not None else frame)
            torch.cuda.synchronize()
            tc = time.perf_counter()
            assert out is not None and out.shape == (H, W, 3), "no render"
            assert torch.isfinite(out).all(), f"render {i} not finite"
            kind = ("reloc" if was == Mode.RELOC else
                    "keyframe" if len(sysm.keyframes) > n_kf else "tracked")
            ms.setdefault(kind, []).append((tb - ta) * 1e3)
            ms.setdefault("render", []).append((tc - tb) * 1e3)
            seen["modes"].append(mode.name)
            seen["reloc_ok"] += int(was == Mode.RELOC and bool(ok))
            seen["last"] = (frame, kf)
            seen["renders"] += 1

    def backend_timers(sysm, ms):
        """Host ms of on_keyframe, relocalize and the solve, and the GN
        iterations of each solve."""
        st = sysm.backend.stats
        return [_time_calls(torch, sysm.backend, "on_keyframe", ms),
                _time_calls(torch, sysm.backend, "relocalize", ms),
                _time_calls(torch, sysm.backend, "solve", ms,
                            lambda a, kw, out: ms.setdefault(
                                "iters_cum", []).append(st["iters"]))]

    def solve_iters(ms):
        cum = [0] + ms.get("iters_cum", [])
        return [b - a for a, b in zip(cum, cum[1:])]

    # -- noise-free pan: 40 frames, then profiled frames ----------------------
    n_frames, n_extra = 40, 12
    poses = orc.pan_trajectory(n_frames + n_extra, W)
    oracle, sysm = build()
    assert isinstance(sysm.tracker, FusedTracker) and \
        sysm.tracker.oracle is oracle, "not the fused oracle frontend"
    ms: dict = {}
    seen = {"modes": [], "reloc_ok": 0, "renders": 0}
    restore = backend_timers(sysm, ms)
    cr.launches = cr.bwd_launches = 0
    t0 = time.perf_counter()
    drive(oracle, sysm, poses[:n_frames], 0, ms, seen)
    run_s = time.perf_counter() - t0
    launches, bwd = cr.launches, cr.bwd_launches
    for r in restore:
        r()
    st = dict(sysm.backend.stats)
    n_kf = len(sysm.keyframes)
    kf_ids = [sysm.keyframes[k].frame_id for k in range(n_kf)]
    iters = solve_iters(ms)
    touched = set(sysm.backend.ii) | set(sysm.backend.jj)
    feat = sysm.keyframes.last_keyframe().feat
    assert "RELOC" not in seen["modes"], f"RELOC: {seen['modes']}"
    assert sysm.tracker.fails == 0, f"{sysm.tracker.fails} GN failures"
    assert 4 <= n_kf <= 10, f"{n_kf} keyframes: {kf_ids}"
    assert all(k in touched for k in range(1, n_kf)), \
        f"a keyframe without an edge: {sorted(touched)} of {n_kf}"
    assert max(iters) > 1, f"no solve ran more than one GN iteration: {iters}"
    assert launches == seen["renders"] == n_frames and bwd == 0, \
        f"{launches} launches, {seen['renders']} renders"
    assert feat.numel() > 1 and float(feat[0, 1:].abs().max()) > 0, \
        "no real encoder features"
    ate = _keyframe_ate(torch, sysm, oracle)
    assert ate < 0.16, f"closed-loop ATE {ate} m"

    # the kernel against its plain version on the last frame's rows (after
    # the count was read)
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.splat.decoder import frame_gaussians

    frame, kf = seen["last"]
    K = torch.tensor([[float(W), 0, W / 2], [0, float(W), H / 2], [0, 0, 1]],
                     device=device)
    view = torch.linalg.inv(sim3.matrix(frame.T_WC)) @ sim3.matrix(frame.T_WC)
    cnt, org, rw = cr.pack_rows(*frame_gaussians(frame, kf), view, K, (H, W))
    zero = torch.zeros(3, device=device)
    err = float((cr.composite(cnt, org, rw, zero)
                 - cr.composite_torch(cnt, org, rw, zero)).abs().max())
    assert err <= TOL, f"closed-loop kernel vs plain {err}"
    k_ms = device_ms(lambda: cr.composite(cnt, org, rw, zero), torch)
    k_call_ms = call_ms(lambda: cr.composite(cnt, org, rw, zero), torch)
    k_plain_ms = call_ms(lambda: cr.composite_torch(cnt, org, rw, zero),
                         torch, 5)
    k_bound_ms, k_bound_by = _bound_ms(cnt)

    # one tracked frame and one keyframe under the profiler
    modes, renders = list(seen["modes"]), seen["renders"]
    profiles = {}
    for i in range(n_frames, n_frames + n_extra):
        n_before = len(sysm.keyframes)
        p_ms: dict = {}
        p = _profile_frame(torch, lambda: drive(
            oracle, sysm, poses[:i + 1], i, p_ms, seen))
        kind = "keyframe" if len(sysm.keyframes) > n_before else "tracked"
        profiles.setdefault(kind, p)
        if len(profiles) == 2:
            break
    assert set(profiles) == {"tracked", "keyframe"}, sorted(profiles)

    med = {k: _median(v) for k, v in ms.items() if k != "iters_cum"}
    line = (
        f"[closed-loop] {n_frames} frames {H}x{W} on PlaneSceneOracle("
        f"inner=engine, stride 2), base.yaml, fused frontend, no keyframe "
        f"forced ({run_s:.1f} s) | modes "
        f"{''.join(m[0] for m in modes)} | keyframes {n_kf} at "
        f"frames {kf_ids}, GN failures 0, edges {len(sysm.backend.ii)} "
        f"(neighbour {st['neighbor_edges']}, matched {st['factor_edges']}), "
        f"solves {st['solves']} with GN iterations {iters} | keyframe ATE "
        f"{ate * 1e3:.2f} mm (Sim(3)-aligned, held < 160 mm; the JAX "
        f"package's TPU-era record at production size, ROADMAP Recent: 3.8 "
        f"mm) | "
        f"median host ms: process_frame tracked "
        f"{med.get('tracked', float('nan')):.2f} "
        f"({len(ms.get('tracked', []))}), keyframe "
        f"{med.get('keyframe', float('nan')):.2f} "
        f"({len(ms.get('keyframe', []))}), on_keyframe "
        f"{med.get('on_keyframe', float('nan')):.2f}, solve "
        f"{med.get('solve', float('nan')):.2f}, render "
        f"{med['render']:.2f} | compositor launches {launches} = renders "
        f"{renders} | last frame: kernel vs plain {err:.2e}, "
        f"{int(cnt.sum())} rows (mean count {float(cnt.float().mean()):.1f}, "
        f"largest {int(cnt.max())}), kernel {k_ms:.4f} ms on the device, "
        f"call_ms {k_call_ms:.4f} vs plain {k_plain_ms:.3f} ms, bound "
        f"{k_bound_ms:.5f} ms by {k_bound_by}")
    prof_lines = []
    for kind in ("tracked", "keyframe"):
        wall, busy, spans = profiles[kind]
        prof_lines.append(
            f"[closed-loop-profile] one {kind} frame (process_frame + "
            f"render): wall {wall:.2f} ms, device kernels {busy:.2f} ms "
            f"(idle {max(0.0, 1 - busy / wall):.1%}) | "
            + ", ".join(f"{k} {h:.2f} ms open / {d:.2f} ms on the device"
                        for k, (h, d) in sorted(spans.items(),
                                                key=lambda kv: -kv[1][0])))
    res = dict(frames=n_frames, modes=modes, keyframes=kf_ids,
               stats=st, solve_iters=iters, ate_m=ate, run_s=run_s,
               ms={k: v for k, v in ms.items()}, launches=launches,
               kernel_vs_plain=err, rows=int(cnt.sum()),
               max_count=int(cnt.max()), kernel_ms=k_ms, call_ms=k_call_ms,
               plain_ms=k_plain_ms, bound_ms=k_bound_ms,
               profiles={k: dict(wall_ms=w, device_ms=b, spans=s)
                         for k, (w, b, s) in profiles.items()})
    kept = sysm  # the viz phase's system
    del oracle, sysm, frame, kf, seen

    # -- the noisy kidnapped-camera run ---------------------------------------
    blackout = (16, 20)
    poses = orc.reloc_pan_trajectory(30, W, blackout)
    oracle, sysm = build(noise=0.01, conf_noise=0.2, blackout=blackout)
    n_ms: dict = {}
    seen = {"modes": [], "reloc_ok": 0, "renders": 0}
    restore = backend_timers(sysm, n_ms)
    cr.launches = 0
    t0 = time.perf_counter()
    drive(oracle, sysm, poses, 0, n_ms, seen)
    n_run_s = time.perf_counter() - t0
    n_launches = cr.launches
    for r in restore:
        r()
    modes = seen["modes"]
    nst = dict(sysm.backend.stats)
    n_ids = [sysm.keyframes[k].frame_id for k in range(len(sysm.keyframes))]
    assert "RELOC" in modes, "the blackout never tripped the tracking gate"
    assert "RELOC" not in modes[:blackout[0]], f"RELOC too early: {modes}"
    assert seen["reloc_ok"] >= 1, "no successful relocalization"
    assert modes[-1] == "TRACKING", "never recovered from RELOC"
    assert 4 <= len(n_ids) <= 12, f"{len(n_ids)} keyframes: {n_ids}"
    assert n_launches == seen["renders"] == len(poses)
    # a blacked-out frame carries no geometry; when it relocalizes onto the
    # last keyframe through the consecutive edge (never gated, as in the
    # reference) its pose is a copy of the seed keyframe's, whatever the
    # camera did: held on the keyframes the camera saw, reported on all
    seen_ate = _keyframe_ate(torch, sysm, oracle, skip=range(*blackout))
    all_ate = _keyframe_ate(torch, sysm, oracle)
    assert seen_ate < 0.25, f"noisy closed-loop ATE {seen_ate} m"
    nmed = {k: _median(v) for k, v in n_ms.items() if k != "iters_cum"}
    n_line = (
        f"[closed-loop-noisy] reloc_pan_trajectory(30, {W}, {blackout}), "
        f"noise 0.01, conf_noise 0.2 ({n_run_s:.1f} s) | modes "
        f"{''.join(m[0] for m in modes)} | keyframes {n_ids}, "
        f"relocalizations {seen['reloc_ok']} ({nst['reloc_ok']}/"
        f"{nst['reloc_tried']} tried), tracking GN failures "
        f"{sysm.tracker.fails}, solves {nst['solves']} with GN iterations "
        f"{solve_iters(n_ms)} | keyframe ATE {seen_ate * 1e3:.2f} mm over "
        f"the keyframes outside the blackout (held < 250 mm), "
        f"{all_ate * 1e3:.2f} mm over all | median host ms: relocalize "
        f"{nmed.get('relocalize', float('nan')):.2f} "
        f"({len(n_ms.get('relocalize', []))} calls), process_frame tracked "
        f"{nmed.get('tracked', float('nan')):.2f}, keyframe "
        f"{nmed.get('keyframe', float('nan')):.2f}, RELOC frame "
        f"{nmed.get('reloc', float('nan')):.2f} | compositor launches "
        f"{n_launches} = renders {seen['renders']}")
    res["noisy"] = dict(modes=modes, keyframes=n_ids, stats=nst,
                        reloc_ok=seen["reloc_ok"], ate_seen_m=seen_ate,
                        ate_all_m=all_ate, run_s=n_run_s,
                        ms={k: v for k, v in n_ms.items()},
                        launches=n_launches,
                        solve_iters=solve_iters(n_ms))
    return [line, *prof_lines, n_line], res, kept


VIZ_MODES = (("splat", dict(gs_on=True, render_mode="rgb")),
             ("depth", dict(gs_on=True, render_mode="depth")),
             ("surfel", dict(gs_on=False, pointmap_mode="surfel",
                             spatial_stride=4)),
             ("scatter", dict(gs_on=False, pointmap_mode="scatter")))
DEMO_VIEWS = 8
WEB_YAWS = (0.0, 0.6, 1.2)
SWEEP_RENDERS = 3 * 3 * 4  # densities x tpg_side x k_max
# The production caps' bar against the exact oracle, at every density
# (PARITY.md:156-170). The port bins each tile's gaussians in exact depth
# order; the JAX package's 18-bit depth keys tie at 150k and 600k, where it
# composites ties in index order (tests/test_torch_port_rasterizer.py::
# test_depth_key_ties_composite_in_depth_order).
FIDELITY_DB = 88.0


def _held_rows(torch, cr, rows, path, timed=False):
    """The forward kernel against its plain version on `rows` (counts,
    origins, rows) with a zero background → dict(err, rows, and with
    `timed` the device ms, call ms, plain ms and bound). Raises past
    TOL."""
    cnt, org, rw = rows
    zero = torch.zeros(3, device=rw.device)
    err = float((cr.composite(cnt, org, rw, zero)
                 - cr.composite_torch(cnt, org, rw, zero)).abs().max())
    assert err <= TOL, f"{path}-path kernel vs plain {err}"
    out = dict(err=err, rows=int(cnt.sum()), max_count=int(cnt.max()))
    if timed:
        out["ms"] = device_ms(lambda: cr.composite(cnt, org, rw, zero), torch)
        out["call_ms"] = call_ms(lambda: cr.composite(cnt, org, rw, zero),
                                 torch)
        out["plain_ms"] = call_ms(
            lambda: cr.composite_torch(cnt, org, rw, zero), torch, 3)
        out["bound_ms"], out["bound_by"] = _bound_ms(cnt)
    return out


def _png_data_url(path):
    import base64

    with open(path, "rb") as f:
        return "data:image/png;base64," + base64.b64encode(f.read()).decode()


def _ply_vertices(data: bytes) -> int:
    head = data[:data.index(b"end_header")].decode()
    return int(next(ln.split()[2] for ln in head.splitlines()
                    if ln.startswith("element vertex")))


def _viz_phase(torch, cr, model, system, work):
    """The viewer, session save and resume, the two-image demo, its web app
    and the fidelity sweep on the card, on phase 3's model and the closed
    loop's system → (lines, results). Each part's compositor counts are set
    to 0 just before it and read just after. Each line is printed as soon
    as its part passes."""
    import numpy as np

    from splatt3r_slam_tpu_torch import demo
    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.runtime import webdemo
    from splatt3r_slam_tpu_torch.runtime.session import (
        load_session,
        save_session,
    )
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.runtime.visualization import Viewer
    from splatt3r_slam_tpu_torch.scripts import sweep_rasterizer_fidelity
    from splatt3r_slam_tpu_torch.utils.image import read_png, write_png

    lines, res, launches = [], {}, {}

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    # -- 1. the viewer: one headless tick in each mode ------------------------
    viewer = Viewer(system, hw=(H, W), headless=True,
                    out_dir=os.path.join(work, "viz"))
    tick_ms, cams = {}, {}
    cr.launches = cr.bwd_launches = 0
    for name, state in VIZ_MODES:
        for k, v in state.items():
            setattr(viewer.state, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        viewer.update()
        torch.cuda.synchronize()
        tick_ms[name] = (time.perf_counter() - t0) * 1e3
        cams[name] = viewer._last_T_cam
    launches["viewer"] = (cr.launches, cr.bwd_launches)
    assert launches["viewer"] == (3, 0), launches["viewer"]  # scatter: none
    pngs = sorted(os.listdir(viewer.out_dir))
    assert len(pngs) == len(VIZ_MODES), pngs
    for f in pngs:
        assert read_png(viewer.out_dir / f).shape == (H, W, 3), f
    Kv = torch.as_tensor(viewer.K, device="cuda")

    def view_of(T):
        return torch.as_tensor(np.linalg.inv(T).astype(np.float32),
                               device="cuda")

    surf = viewer.surfels()
    surfel = _held_rows(torch, cr, cr.pack_rows(
        *surf, view_of(cams["surfel"]), Kv, (H, W), k_max=viewer.k_max),
        "viewer-surfel", timed=True)
    splat = _held_rows(torch, cr, cr.pack_rows(
        *system.pool.get_all(), view_of(cams["splat"]), Kv, (H, W),
        k_max=viewer.k_max), "viewer-splat")
    n_kf = len(system.keyframes)
    emit(
        f"[viz-viewer] Viewer({H}x{W}, headless, k_max {viewer.k_max}) on "
        f"the closed loop's system ({n_kf} keyframes, "
        f"{len(system.backend.ii)} edges, {system.pool.n} pool gaussians) | "
        "tick host ms: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     tick_ms.items())
        + f" | {len(pngs)} PNGs of {H}x{W}x3 | compositor launches "
        f"{launches['viewer'][0]} = renders 3 (scatter renders none), "
        f"backward 0 | surfel rows ({surf[0].shape[0]} surfels from "
        f"{min(n_kf, 16)} keyframes at stride 4, {surfel['rows']} rows, "
        f"largest count {surfel['max_count']}): kernel vs plain "
        f"{surfel['err']:.2e}, {surfel['ms']:.4f} ms on the device, "
        f"call_ms {surfel['call_ms']:.4f} vs plain {surfel['plain_ms']:.3f}"
        f" ms, bound {surfel['bound_ms']:.5f} ms by {surfel['bound_by']} | "
        f"splat rows ({splat['rows']}): kernel vs plain {splat['err']:.2e}")
    res["viewer"] = dict(tick_ms=tick_ms, launches=launches["viewer"][0],
                         surfels=int(surf[0].shape[0]), surfel=surfel,
                         splat=splat)
    del surf

    # -- 2. session save and resume -------------------------------------------
    path = os.path.join(work, "session.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_session(path, system, system.backend)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = SLAMSystem(system.engine, H, W)
    fresh.backend = FactorGraph(system.engine, fresh.keyframes)
    t0 = time.perf_counter()
    load_session(path, fresh, fresh.backend)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    a, b = system, fresh
    assert len(b.keyframes) == n_kf and b.mode == a.mode
    for i in range(n_kf):
        for field in ("T_WC", "X_canon", "C", "feat", "pos"):
            x, y = getattr(a.keyframes[i], field), getattr(b.keyframes[i],
                                                           field)
            assert (x is None and y is None) or (
                y.is_cuda and torch.equal(y, x.to(y.dtype))), (i, field)
    n = a.pool.n
    assert b.pool.n == n and torch.equal(b.pool.data[:n], a.pool.data[:n])
    assert (b.backend.ii, b.backend.jj) == (a.backend.ii, a.backend.jj)
    for name in ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i",
                 "Q_ii2jj", "Q_jj2ii"):
        for x, y in zip(getattr(a.backend, name), getattr(b.backend, name)):
            assert torch.equal(y, x.to(y.dtype)), name
    same_render = bool(np.array_equal(*(
        Viewer(x, hw=(H, W), headless=False).render_gs_view(cams["splat"])
        for x in (system, fresh))))
    assert same_render, "the resumed system renders another image"
    # the solve's index_add_ sums its blocks in no fixed order on the card
    # (equal inputs ended 1.9e-6 apart): both solves run under torch's
    # deterministic algorithms, and the poses are held relative to their
    # largest entry
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a.backend.solve()
            b.backend.solve()
    finally:
        torch.use_deterministic_algorithms(False)
    pose_abs = [float((a.keyframes[i].T_WC - b.keyframes[i].T_WC).abs().max())
                for i in range(n_kf)]
    pose_err = max(e / max(1.0, float(a.keyframes[i].T_WC.abs().max()))
                   for i, e in enumerate(pose_abs))
    assert pose_err <= 1e-6, f"solves after resume differ by {pose_err}"
    mib = os.path.getsize(path) / 2**20
    emit(
        f"[viz-session] {mib:.2f} MiB npz ({n_kf} keyframes, {n} pool rows, "
        f"{len(a.backend.ii)} edges) | save {save_ms:.1f} ms, load "
        f"{load_ms:.1f} ms | poses, X_canon, C, features, pool rows and "
        f"every edge list bit for bit; splat render identical; one solve "
        f"each: poses within {pose_err:.1e} of their largest entry (held "
        f"1e-6), {max(pose_abs):.1e} absolute")
    res["session"] = dict(mib=mib, save_ms=save_ms, load_ms=load_ms,
                          pose_err=pose_err, pose_abs=max(pose_abs))
    del fresh, a, b

    # -- 3. the demo CLI on two panned PNGs -----------------------------------
    rng = np.random.default_rng(7)
    tex = (rng.random((H + 16, W + 32, 3)) * 255).astype(np.uint8)
    imgs = [os.path.join(work, "a.png"), os.path.join(work, "b.png")]
    write_png(imgs[0], tex[:H, :W])
    write_png(imgs[1], tex[8:8 + H, 16:16 + W])
    out = os.path.join(work, "demo")
    ms, seen = {}, {}

    def keep_render(a, kw, img):
        seen["render"] = (a[0].scene, a[1], a[2], a[0].k_max, img)

    restore = [_time_calls(torch, webdemo.DemoEngine, "reconstruct_arrays",
                           ms),
               _time_calls(torch, webdemo.DemoEngine, "render", ms,
                           keep_render)]
    cr.launches = cr.bwd_launches = 0
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            rc = demo.main([*imgs, "--out", out, "--n-views",
                            str(DEMO_VIEWS), "--img-size", str(W),
                            "--device", "cuda"],
                           model=model)
            demo_s = time.perf_counter() - t0
    finally:
        for r in restore:
            r()
    launches["demo"] = (cr.launches, cr.bwd_launches)
    assert rc == 0
    with open(os.path.join(out, "gaussians.ply"), "rb") as f:
        n_ply = _ply_vertices(f.read())
    views = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert n_ply == 2 * H * W, n_ply
    assert len(views) == DEMO_VIEWS and launches["demo"] == (DEMO_VIEWS, 0), \
        (views, launches["demo"])
    scene, yaw, pitch, k_max, last = seen["render"]
    assert (read_png(os.path.join(out, views[-1])) == last).all()
    view, K = webdemo.orbit_view(scene.center, scene.radius, yaw, pitch,
                                 scene.hw, "cuda")
    demo_rows = _held_rows(torch, cr, cr.pack_rows(
        scene.means, scene.cov_triu, scene.colors, scene.opacities, view, K,
        scene.hw, k_max=k_max), "demo", timed=True)
    emit(
        f"[viz-demo] demo.main(2 panned {H}x{W} PNGs, --n-views "
        f"{DEMO_VIEWS}) exit {rc} in {demo_s:.2f} s | reconstruct "
        f"{ms['reconstruct_arrays'][0]:.1f} ms, render median "
        f"{_median(ms['render']):.2f} ms (host, synchronised) | PLY "
        f"{n_ply} vertices, {len(views)} PNGs | compositor launches "
        f"{launches['demo'][0]} = renders {DEMO_VIEWS} | last view's rows "
        f"({demo_rows['rows']}, k_max {k_max}, largest count "
        f"{demo_rows['max_count']}): kernel vs plain {demo_rows['err']:.2e},"
        f" {demo_rows['ms']:.4f} ms on the device, call_ms "
        f"{demo_rows['call_ms']:.4f} vs plain {demo_rows['plain_ms']:.3f} "
        f"ms, bound {demo_rows['bound_ms']:.5f} ms by "
        f"{demo_rows['bound_by']}")
    res["demo"] = dict(seconds=demo_s, reconstruct_ms=ms[
        "reconstruct_arrays"][0], render_ms=ms["render"], ply=n_ply,
        launches=launches["demo"][0], rows=demo_rows)

    # -- 4. the web app -------------------------------------------------------
    engine = webdemo.DemoEngine(model, img_size=W, k_max=256, device="cuda")
    server = webdemo.serve(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(
            url + "/reconstruct", headers={"Content-Type": "application/json"},
            data=json.dumps({"images": [_png_data_url(p) for p in imgs]})
            .encode())
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            rec = json.loads(r.read())
        rec_ms = (time.perf_counter() - t0) * 1e3
        assert rec["ok"] and rec["n_gaussians"] == 2 * H * W, rec
        bodies, get_ms = [], []
        cr.launches = cr.bwd_launches = 0
        for yaw in WEB_YAWS:
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{url}/render?yaw={yaw}&pitch=0.2",
                                        timeout=600) as r:
                assert r.headers.get("Content-Type") == "image/jpeg"
                bodies.append(r.read())
            get_ms.append((time.perf_counter() - t0) * 1e3)
        launches["web"] = (cr.launches, cr.bwd_launches)
        with urllib.request.urlopen(url + "/gaussians.ply",
                                    timeout=600) as r:
            n_web_ply = _ply_vertices(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    from splatt3r_slam_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    assert launches["web"] == (len(WEB_YAWS), 0), launches["web"]
    assert n_web_ply == 2 * H * W, n_web_ply
    for yaw, body in zip(WEB_YAWS, bodies):
        assert body == encode_jpeg(engine.render(yaw, 0.2), 90), yaw
        assert decode_jpeg(body).shape == (H, W, 3), yaw
    emit(
        f"[viz-web] serve(engine, port=0) on a thread | POST /reconstruct "
        f"(2 PNG data URLs) {rec_ms:.1f} ms, {rec['n_gaussians']} gaussians "
        f"| GET /render at yaws {list(WEB_YAWS)}: "
        + ", ".join(f"{m:.2f}" for m in get_ms)
        + f" ms, each JPEG body encode_jpeg's of engine.render's pixels | "
        f"/gaussians.ply {n_web_ply} vertices | compositor launches "
        f"{launches['web'][0]} = renders {len(WEB_YAWS)}")
    res["web"] = dict(reconstruct_ms=rec_ms, render_ms=get_ms,
                      launches=launches["web"][0])
    del engine

    # -- 5. the fidelity sweep ------------------------------------------------
    buf = io.StringIO()
    cr.launches = cr.bwd_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sw = sweep_rasterizer_fidelity.main(["--device", "cuda"])
    sweep_s = time.perf_counter() - t0
    launches["sweep"] = (cr.launches, cr.bwd_launches)
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == sw
    assert launches["sweep"] == (SWEEP_RENDERS, 0), launches["sweep"]
    assert all(np.isfinite(r["psnr"]) for r in sw["results"])
    prod = {r["G"]: r["psnr"] for r in sw["results"]
            if r["tpg_side"] == 4 and r["k_max"] == 512}
    assert len(prod) == 3 and min(prod.values()) >= FIDELITY_DB, prod
    sv, sK = sweep_rasterizer_fidelity.camera("cuda")
    hw = sweep_rasterizer_fidelity.HW
    scene = sweep_rasterizer_fidelity.make_scene(600_000, "cuda")
    sweep_rows = _held_rows(torch, cr, cr.pack_rows(
        *scene, sv, sK, hw, tpg_side=2, k_max=1024), "sweep", timed=True)
    del scene
    emit(
        f"[viz-sweep] sweep_rasterizer_fidelity --device cuda ({sweep_s:.1f} "
        f"s): production caps (tpg_side 4, k_max 512) PSNR "
        + ", ".join(f"{g}: {p}" for g, p in prod.items())
        + f" dB (held >= {FIDELITY_DB:g} at every density) | "
        f"compositor launches "
        f"{launches['sweep'][0]} = renders {SWEEP_RENDERS} | 600k, k_max "
        f"1024, tpg_side 2 rows ({sweep_rows['rows']}, largest count "
        f"{sweep_rows['max_count']}): kernel vs plain "
        f"{sweep_rows['err']:.2e}, {sweep_rows['ms']:.4f} ms on the device,"
        f" call_ms {sweep_rows['call_ms']:.4f} vs plain "
        f"{sweep_rows['plain_ms']:.3f} ms, bound "
        f"{sweep_rows['bound_ms']:.5f} ms by {sweep_rows['bound_by']}")
    emit("[viz-sweep-table] " + json.dumps(sw["results"]))
    res["sweep"] = dict(seconds=sweep_s, results=sw["results"],
                        launches=launches["sweep"][0], rows=sweep_rows)

    assert all(bw == 0 for _, bw in launches.values()), launches
    res["launches"] = sum(f for f, _ in launches.values())
    res["launches_by_part"] = launches
    res["kernel_vs_plain"] = max(surfel["err"], splat["err"],
                                 demo_rows["err"], sweep_rows["err"])
    return lines, res


ENTRY_SYSTEM = ["--frames", "40", "--cadence", "5", "--threaded",
                "--retrieval", "--render-stride", "1"]
ENTRY_ORACLE = ["--frames", "40", "--oracle", "--fused", "--lag"]
ENTRY_RELOC = ["--frames", "8", "--reloc-events", "3"]
ENTRY_SOAK = ["--frames", "120", "--kf-every", "3", "--kf-capacity", "16",
              "--max-edges", "24", "--max-gaussians", "262144"]


def _kept_render(a, kw, out):
    """What `_render_vs_plain` needs of one `render_frame(*a, **kw)` call
    that returned `out`, kept by reference so that the frame may drop its
    buffers afterwards. The callers render from the frame's own pose."""
    frame, ref = a[0], a[1]
    assert kw.get("target_T_WC") is None and len(a) == 2, "a target pose"
    return (frame.gaussian_pred, frame.gaussian_pred_cross, frame.img,
            ref.img, frame.T_WC, tuple(out.shape[:2]), kw.get("K"))


def _render_vs_plain(torch, cr, kept, path):
    """The forward kernel against its plain version on the rows of the
    render `kept` (from `_kept_render`), packed as `render_frame` packs
    them → (max |kernel - plain|, rows). Raises past TOL."""
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.splat.decoder import frame_gaussians

    gp, gpc, img, ref_img, T_WC, hw, K = kept
    fr, ref = types.SimpleNamespace(), types.SimpleNamespace()
    fr.gaussian_pred, fr.gaussian_pred_cross, fr.img = gp, gpc, img
    ref.img = ref_img
    if K is None:  # render_frame's default camera
        focal = float(max(hw))
        K = torch.tensor([[focal, 0, hw[1] / 2], [0, focal, hw[0] / 2],
                          [0, 0, 1]], device=img.device)
    view = torch.linalg.inv(sim3.matrix(T_WC)) @ sim3.matrix(T_WC)
    held = _held_rows(torch, cr, cr.pack_rows(*frame_gaussians(fr, ref),
                                              view, K, hw), path)
    return held["err"], held["rows"]


def _run_entry(main, argv, cr, **kw):
    """One entry point's `main(argv + ["--device", "cuda"], **kw)` (the
    measurement entry points take `model=`) with the compositor's counts
    set to 0 just before and read just after, and its own stdout kept
    apart → (result, seconds, (forward, backward) launches). Its printed
    JSON must be its last line and equal what it returned."""
    buf = io.StringIO()
    cr.launches = cr.bwd_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main(list(argv) + ["--device", "cuda"], **kw)
    secs = time.perf_counter() - t0
    counts = (cr.launches, cr.bwd_launches)
    printed = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert printed == {k: res[k] for k in printed}, "last line != result"
    return res, secs, counts


def _entry_phase(torch, cr, model):
    """The measurement entry points on the card, each through its `main`
    with phase 3's full-width model → (lines, results)."""
    from splatt3r_slam_tpu_torch import bench
    from splatt3r_slam_tpu_torch.runtime import fused
    from splatt3r_slam_tpu_torch.scripts import (
        bench_system,
        profile_keyframe_event,
        profile_stages,
        soak,
    )
    from splatt3r_slam_tpu_torch.splat import decoder

    assert all(p.is_cuda for p in model.parameters()), "model not on cuda"
    lines, res, launches = [], {}, {}

    # bench: every tensor the fused step is given lies on the card
    steps, off = [0], set()
    real_step = fused.fused_track_step

    def checked(m, img, kf, T_WC, idx, *a, **kw):
        steps[0] += 1
        for name, t in (("img", img), ("T_WC", T_WC), *kf._asdict().items()):
            if not t.is_cuda:
                off.add(name)
        return real_step(m, img, kf, T_WC, idx, *a, **kw)

    fused.fused_track_step = checked
    try:
        b, b_s, launches["bench"] = _run_entry(bench.main, [], cr,
                                               model=model)
    finally:
        fused.fused_track_step = real_step
    assert not off, f"fused-step inputs off the card: {sorted(off)}"
    # warm-up frames 1-2, three passes of frames 3-39, two replays of 1-2
    assert len(b["passes"]) == 3 and steps[0] == 2 + 3 * 37 + 2 * 2, steps
    lines.append(
        f"[entry-bench] {b['metric']} {b['value']:.3f} frames/s, the median "
        f"of 3 passes of 37 timed frames ("
        + ", ".join(f"{x:.3f}" for x in b["passes"])
        + f"); {steps[0]} fused steps, every input and parameter on cuda | "
        f"{b['device']}, {b['power_limit_w']} W | {b_s:.1f} s")
    res["bench"] = dict(b, seconds=b_s)

    # bench_system, cadence mode with the threaded backend, retrieval and a
    # render every frame; the warm-up drives the whole length too
    renders, kept = [], {}
    real_render = decoder.render_frame

    def counted(*a, **kw):
        img = real_render(*a, **kw)
        renders.append(img is not None)
        if img is not None:
            kept["render"] = _kept_render(a, kw, img)
        return img

    decoder.render_frame = counted
    try:
        c, c_s, launches["system"] = _run_entry(
            bench_system.main, ENTRY_SYSTEM, cr, model=model)
    finally:
        decoder.render_frame = real_render
    n_kf = 8  # frame 0 and the forced keyframes at frames 5, 10, ..., 35
    assert c["keyframes"] == n_kf, c["keyframes"]
    # one backend task per keyframe, all drained; close() raised none
    assert [k for k, _ in c["backend_task_ms"]] == list(range(n_kf)), \
        c["backend_task_ms"]
    assert c["threaded"] and c["retrieval"] and c["render_stride"] == 1
    assert len(renders) == 80 and all(renders), renders
    assert launches["system"] == (len(renders), 0), launches["system"]
    # the kernel against its plain version on the last render's rows
    # (after the counts were read, so these launches are not counted)
    err, n_rows = _render_vs_plain(torch, cr, kept["render"], "entry")
    lines.append(
        f"[entry-system] {' '.join(ENTRY_SYSTEM)}: loop {c['value']:.3f} "
        f"frames/s (wall with the drain {c['wall_fps_incl_drain']:.3f}), "
        f"fps_effective_p50 {c['fps_effective_p50']}, t_track_p50_ms "
        f"{c['t_track_p50_ms']}, t_kf_event_p50_ms {c['t_kf_event_p50_ms']},"
        f" backend_task_ms {c['backend_task_ms']}, drain {c['t_drain_s']} s"
        f" | keyframes {c['keyframes']}, edges {c['backend_edges']}, "
        f"gaussians {c['gaussians']}, RELOC put back {c['reboots']} | "
        f"renders {len(renders)} (40 warm-up + 40 timed) = compositor "
        f"launches {launches['system'][0]}, backward 0 | last render's "
        f"{n_rows} rows: kernel vs plain {err:.3e} (tol {TOL:g}) | "
        f"{c_s:.1f} s")
    res["system"] = dict(c, seconds=c_s, renders=len(renders))
    res["kernel_vs_plain"], res["rows"] = err, n_rows

    o, o_s, launches["oracle"] = _run_entry(bench_system.main, ENTRY_ORACLE,
                                            cr, model=model)
    assert o["relocs"] == 0, o["relocs"]
    assert 4 <= o["keyframes"] <= 10, o["keyframes"]
    assert o["ate_rmse_m"] < 0.16, o["ate_rmse_m"]
    assert launches["oracle"] == (0, 0), launches["oracle"]
    lines.append(
        f"[entry-oracle] {' '.join(ENTRY_ORACLE)}: {o['metric']} "
        f"{o['value']:.3f} frames/s, t_track_p50_ms {o['t_track_p50_ms']}, "
        f"t_kf_event_p50_ms {o['t_kf_event_p50_ms']} | keyframes "
        f"{o['keyframes']}, edges {o['backend_edges']}, relocs "
        f"{o['relocs']}, keyframe ATE {o['ate_rmse_m'] * 1e3:.2f} mm (held "
        f"< 160 mm) | backend_task_ms {o['backend_task_ms']} | {o_s:.1f} s")
    res["oracle"] = dict(o, seconds=o_s)

    r, r_s, launches["reloc"] = _run_entry(bench_system.main, ENTRY_RELOC,
                                           cr, model=model)
    assert r["reloc_success"] == 3, r["reloc_success"]
    lines.append(
        f"[entry-reloc] {' '.join(ENTRY_RELOC)}: reloc_event_ms_p50 "
        f"{r['reloc_event_ms_p50']}, events {r['reloc_event_ms']}, "
        f"successes {r['reloc_success']}/3 | loop {r['value']:.3f} frames/s"
        f" over 8 frames ({r['keyframes']} keyframes) | {r_s:.1f} s")
    res["reloc"] = dict(r, seconds=r_s)

    s, s_s, launches["soak"] = _run_entry(soak.main, ENTRY_SOAK, cr,
                                          model=model)
    assert s["keyframes_final"] > 16 and s["over_capacity_frames"] > 0, s
    assert s["edges_final"] <= 24 and all(
        t["edges"] <= 24 for t in s["thirds"]), s["thirds"]
    assert s["pool_evictions"] >= 1 and s["gaussians_final"] <= 262144 and \
        all(t["gaussians"] <= 262144 for t in s["thirds"]), s
    lines.append(
        f"[entry-soak] {' '.join(ENTRY_SOAK)}: per third (FPS, MiB "
        f"allocated, peak MiB, keyframes, edges, gaussians) "
        + "; ".join(f"{t['fps']:.3f}, {t['mem_mb']}, {t['peak_mem_mb']}, "
                    f"{t['keyframes']}, {t['edges']}, {t['gaussians']}"
                    for t in s["thirds"])
        + f" | after the warm-up {s['mem_mb_post_warmup']} MiB, peak since "
        f"{s['peak_mem_mb_post_warmup']} MiB | keyframes "
        f"{s['keyframes_final']} ({s['over_capacity_frames']} frames over "
        f"the capacity of 16), pool evictions {s['pool_evictions']} | "
        f"{s_s:.1f} s")
    res["soak"] = dict(s, seconds=s_s)

    p, p_s, launches["stages"] = _run_entry(profile_stages.main, [], cr,
                                            model=model)
    assert p["sum_stages_ms"] > 0 and p["fused_step_gflop"] > 0, p
    lines.append(f"[entry-stages] {json.dumps(p)} | {p_s:.1f} s")
    res["stages"] = dict(p, seconds=p_s)

    k, k_s, launches["kf_event"] = _run_entry(profile_keyframe_event.main,
                                              [], cr, model=model)
    assert k["kf_event_sum_ms"] > 0, k
    lines.append(f"[entry-kf-event] {json.dumps(k)} | {k_s:.1f} s")
    res["kf_event"] = dict(k, seconds=k_s)

    assert all(bw == 0 for _, bw in launches.values()), launches
    res["launches"] = sum(f for f, _ in launches.values())
    res["launches_by_run"] = launches
    return lines, res


def _cli_phase(torch, root, cr, device, seq, config, argv=(),
               profile=True, viz=False):
    """Run the port's CLI on `seq` with `config` in this process from a
    temporary working directory, time its layers (and, for calibrated
    input, count the calibrated solves and time the undistortion), check
    its outputs, and, with `profile`, run one more keyframe through the
    backend under the profiler → (line, results). With `viz` it runs the
    users' default command line: without --no-viz and with DISPLAY unset,
    so that the viewer ticks headless, and checks one viewer PNG a tick."""
    from splatt3r_slam_tpu_torch import cli
    from splatt3r_slam_tpu_torch.backend.factor_graph import FactorGraph
    from splatt3r_slam_tpu_torch.retrieval.database import RetrievalDatabase
    from splatt3r_slam_tpu_torch.runtime import evaluate as ev
    from splatt3r_slam_tpu_torch.runtime import fused
    from splatt3r_slam_tpu_torch.runtime.dataloader import (
        Intrinsics,
        load_dataset,
    )
    from splatt3r_slam_tpu_torch.runtime.frame import create_frame
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem
    from splatt3r_slam_tpu_torch.splat import decoder

    from splatt3r_slam_tpu_torch.runtime.visualization import Viewer

    name = os.path.basename(seq.rstrip(os.sep))
    argv = ["--dataset", seq, "--config", config, "--seed", "0", *argv,
            *(() if viz else ("--no-viz",))]
    ms, seen = {}, {"modes": []}

    def keep_mode(a, kw, out):
        seen["system"] = a[0]
        seen["modes"].append(out[0].name)

    def keep_render(a, kw, out):
        seen["render"] = _kept_render(a, kw, out)

    restore = [
        _time_calls(torch, SLAMSystem, "process_frame", ms, keep_mode),
        _time_calls(torch, FactorGraph, "on_keyframe", ms),
        _time_calls(torch, FactorGraph, "relocalize", ms),
        _time_calls(torch, FactorGraph, "solve", ms),
        _time_calls(torch, FactorGraph, "solve_GN_calib", ms),
        _time_calls(torch, fused, "opt_pose_calib_sim3", ms),
        _time_calls(torch, Intrinsics, "remap", ms),
        _time_calls(torch, RetrievalDatabase, "update", ms),
        _time_calls(torch, decoder, "render_frame", ms, keep_render),
        _time_calls(torch, Viewer, "update", ms, key="viewer_tick")]
    here = os.getcwd()
    display = os.environ.pop("DISPLAY", None) if viz else None
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cr.launches = cr.bwd_launches = 0
    try:
        os.chdir(work)
        t0 = time.perf_counter()
        rc = cli.main(argv)
        run_s = time.perf_counter() - t0
        launches, bwd_launches = cr.launches, cr.bwd_launches
        ticks = len(ms.get("viewer_tick", []))
        viz_dir = os.path.join(work, "logs", f"{name}_viz")
        viz_pngs = len(os.listdir(viz_dir)) if os.path.isdir(viz_dir) else 0
        assert viz_pngs == ticks and (ticks > 0) == viz, \
            f"{viz_pngs} viewer PNGs for {ticks} ticks (viewer on: {viz})"
        logs = os.path.join(work, "logs")
        system = seen["system"]
        backend = system.backend
        n_kf = len(system.keyframes)
        n_frames = len(seen["modes"])
        assert rc == 0, f"cli exit {rc}"
        stamps = {str(t) for t in load_dataset(seq).timestamps}
        rows = open(os.path.join(logs, f"{name}.txt")).read().splitlines()
        assert len(rows) == n_kf, f"{len(rows)} rows for {n_kf} keyframes"
        assert all(r.split()[0] in stamps for r in rows), \
            "a foreign timestamp"
        pts, _ = ev.load_ply(os.path.join(logs, f"{name}.ply"))
        assert len(pts) > 0, "empty PLY"
        kf_pngs = os.listdir(os.path.join(logs, f"{name}_keyframes"))
        assert len(kf_pngs) == n_kf, f"{len(kf_pngs)} keyframe PNGs"
        renders = len(os.listdir(os.path.join(logs, f"{name}_renders")))
        assert renders == n_frames == len(ms["render_frame"]), \
            f"{renders} render PNGs for {n_frames} frames"
        # a tick renders the splat view: one launch each
        assert launches == renders + ticks, \
            f"{launches} launches, {renders} renders, {ticks} viewer ticks"
        assert bwd_launches == 0, "the cli run launched a backward"
        st = backend.stats
        assert st["solves"] >= 1, "no backend solve"
        touched = set(backend.ii) | set(backend.jj)
        assert all(k in touched for k in range(1, n_kf)), \
            f"a keyframe without an edge: {sorted(touched)} of {n_kf}"
        try:
            ate = ev.ate_rmse(os.path.join(seq, "groundtruth.txt"),
                              os.path.join(logs, f"{name}.txt"))
        except (OSError, ValueError, IndexError) as e:  # no ground truth,
            # or too few rows to align
            ate = f"n/a ({type(e).__name__})"
    finally:
        for r in restore:
            r()
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
        if display is not None:
            os.environ["DISPLAY"] = display

    # the kernel against its plain version on the last render's rows
    # (after the counts were read, so these launches are not counted)
    err, n_rows = _render_vs_plain(torch, cr, seen["render"], "cli")

    res = dict(rc=rc, modes=seen["modes"], keyframes=n_kf, frames=n_frames,
               renders=renders, launches=launches, stats=dict(st),
               tracker_fails=getattr(system.tracker, "fails", None),
               ms={k: v for k, v in ms.items()}, run_s=run_s, ate=ate,
               kernel_vs_plain=err, rows=n_rows,
               viewer_ticks=ticks, viewer_pngs=viz_pngs,
               calib_solves=len(ms.get("solve_GN_calib", [])),
               calib_tracking_steps=len(ms.get("opt_pose_calib_sim3", [])),
               undistorted=len(ms.get("remap", [])))
    if profile:
        # one more keyframe through the backend, under the profiler
        hw = seen["render"][5]  # the rendered (h, w)
        ds = load_dataset(seq)
        ds.img_size = int(hw[1])
        _, raw = ds[1]  # a frame the subsampled run skipped
        frame = create_frame(len(ds), raw, img_size=int(hw[1]),
                             device=device)
        X, C = system.engine.inference_mono(frame)
        frame.update_pointmap(X, C)
        system.keyframes.append(frame)
        kf_idx = len(system.keyframes) - 1
        before = (st["solves"], st["factor_edges"])
        wall, busy, spans = _profile_frame(
            torch, lambda: backend.on_keyframe(kf_idx))
        assert st["solves"] == before[0] + 1
        res["profile"] = dict(wall_ms=wall, device_ms=busy, spans=spans,
                              edges_added=st["factor_edges"] - before[1])
    med = {k: _median(v) for k, v in ms.items()}
    line = (
        f"[cli] {name}: {n_frames} frames, exit {rc} in {run_s:.1f} s | "
        + (f"calibrated: {res['undistorted']} frames undistorted "
           f"({med['remap']:.2f} host ms each), "
           f"{res['calib_tracking_steps']} calibrated tracking solves, "
           f"{res['calib_solves']} solve_GN_calib | "
           if res["undistorted"] else "") +
        f"modes "
        f"{','.join(m[0] for m in seen['modes'])} | keyframes {n_kf}, edges "
        f"{len(backend.ii)} (neighbour {st['neighbor_edges']}, matched "
        f"{st['factor_edges']}), solves {st['solves']} ({st['iters']} GN "
        f"iterations, {st['chol_fail']} Cholesky failures), tracking "
        f"Cholesky failures {res['tracker_fails']}, relocalizations "
        f"{st['reloc_ok']}/{st['reloc_tried']} | median host ms: "
        f"process_frame {med['process_frame']:.2f}, on_keyframe "
        f"{med.get('on_keyframe', float('nan')):.2f} "
        f"({len(ms.get('on_keyframe', []))} calls), relocalize "
        f"{med.get('relocalize', float('nan')):.2f} "
        f"({len(ms.get('relocalize', []))} calls), solve "
        f"{med['solve']:.2f}, retrieval update {med['update']:.2f}, "
        f"render_frame {med['render_frame']:.2f}"
        + (f", viewer tick {med['viewer_tick']:.2f} ({ticks} ticks, "
           f"{viz_pngs} viewer PNGs)" if viz else "")
        + f" | renders {renders} + viewer ticks {ticks} = "
        f"launches {launches}, backward 0 | trajectory {len(rows)} rows, "
        f"PLY {len(pts)} vertices, {len(kf_pngs)} keyframe PNGs | kernel vs "
        f"plain on the last render ({n_rows} rows) {err:.2e} | ATE "
        f"{ate if isinstance(ate, str) else f'{ate:.4f} m'} (random "
        f"weights, not held)")
    return line, res


EUROC_SENSOR_YAML = """%YAML:1.0
---
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


def _calibrated_phase(torch, root, cr, device="cuda", argv=()):
    """The CLI with calibrated input: the TUM fixture with `--calib` (fr1's
    calibration halved for its 320x240 frames, fr1's five distortion
    coefficients), then a EuRoC `mav0/cam0` layout of seeded 752x480
    grayscale frames (always undistorted) under the fixture config with
    use_calib on → (lines, results)."""
    import numpy as np

    from splatt3r_slam_tpu_torch.utils.image import write_png

    fixture = os.path.join(root, "tests", "fixtures", "tum")
    config = os.path.join(fixture, "eval_fixture.yaml")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_calib_")
    try:
        calib = os.path.join(tmp, "calib.yaml")
        with open(calib, "w") as f:
            f.write("width: 320\nheight: 240\ncalibration: [258.65, 258.25, "
                    "159.3, 127.65, 0.2624, -0.9531, -0.0054, 0.0026, "
                    "1.1633]\n")
        lines, res = [], {}
        tum_line, res["tum"] = _cli_phase(
            torch, root, cr, device,
            os.path.join(fixture, "rgbd_dataset_freiburg1_fixture"), config,
            ["--calib", calib, *argv], profile=False)
        lines.append(tum_line.replace("[cli]", "[cli-calib]", 1))

        cam = os.path.join(tmp, "euroc", "MH_fab", "mav0", "cam0")
        os.makedirs(os.path.join(cam, "data"))
        rng = np.random.default_rng(2)
        yy, xx = np.mgrid[0:480, 0:752]
        rows = ["#timestamp [ns],filename"]
        for i in range(12):  # a panned grating plus noise, subsample 2
            ts = 1403636579763555584 + 50_000_000 * i
            img = (127 + 60 * np.sin((xx + 9 * i) / 13.0)
                   * np.cos(yy / 17.0) + rng.normal(0, 12, (480, 752)))
            write_png(os.path.join(cam, "data", f"{ts}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
            rows.append(f"{ts},{ts}.png")
        with open(os.path.join(cam, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
        with open(os.path.join(cam, "sensor.yaml"), "w") as f:
            f.write(EUROC_SENSOR_YAML)
        euroc_cfg = os.path.join(tmp, "euroc_calib.yaml")
        with open(euroc_cfg, "w") as f:
            f.write(f"inherit: {config}\nuse_calib: True\n")
        euroc_line, res["euroc"] = _cli_phase(
            torch, root, cr, device, os.path.join(tmp, "euroc", "MH_fab"),
            euroc_cfg, argv, profile=False)
        lines.append(euroc_line.replace("[cli]", "[cli-euroc]", 1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in res.values():
        assert r["undistorted"] == r["frames"], \
            f"{r['undistorted']} frames undistorted of {r['frames']}"
        assert r["calib_tracking_steps"] >= 1 and r["calib_solves"] >= 1, \
            "the calibrated solves did not run"
    return lines, res


JPEG_SIZES = ((240, 320), (480, 640), (480, 752))  # TUM, VGA, EuRoC
JPEG_QUALITY = 95  # the frames' encoding
JPEG_REPS = 10  # timed decodes per size (the plain walk: 2)
JPEG_DEMO_VIEWS = 2
JPEG_BAR = 1  # levels, on every value, against cv2's committed pixels


def _jpeg_phase(torch, root, cr, png_cli, make_model, device="cuda",
                argv=()):
    """6c. JPEG input and output without cv2 (`utils/jpeg.py`), with any
    import of cv2 failing for the whole phase → (lines, results): the
    committed corpus against cv2's pixels; host ms per decode (the C++ and
    the plain entropy walk) beside `decode_png` at three frame sizes; the
    CLI on the TUM fixture's frames written as JPEG; the demo on two JPEG
    files and the web app with a JPEG upload and a JPEG `/render`, on the
    model `make_model()` gives. Each line carries the card's name and
    power limit."""
    had, saved = "cv2" in sys.modules, sys.modules.get("cv2")
    sys.modules["cv2"] = None  # any import of cv2 now raises ImportError
    try:
        return _jpeg_phase_body(torch, root, cr, png_cli, make_model,
                                device, argv)
    finally:
        if had:
            sys.modules["cv2"] = saved
        else:
            sys.modules.pop("cv2", None)


def _jpeg_phase_body(torch, root, cr, png_cli, make_model, device, argv):
    import base64

    import numpy as np

    from splatt3r_slam_tpu_torch import demo
    from splatt3r_slam_tpu_torch.runtime import webdemo
    from splatt3r_slam_tpu_torch.utils import jpeg
    from splatt3r_slam_tpu_torch.utils.image import (
        decode_png,
        encode_png,
        read_png,
        resize_crop_u8,
    )

    card = _smi() if device == "cuda" else "cpu"
    lines, res = [], {}

    def emit(line):
        line = f"{line} | {card}"
        print(line, flush=True)
        lines.append(line)

    # -- held decodes: the committed corpus against cv2's pixels --------------
    fixtures = os.path.join(root, "tests", "fixtures", "jpeg")
    want = np.load(os.path.join(fixtures, "pixels.npz"))
    names = sorted(f[:-4] for f in os.listdir(fixtures) if f.endswith(".jpg"))
    assert names == sorted(want.files), (names, want.files)
    worst, differing, values = 0, 0, 0
    for name in names:
        with open(os.path.join(fixtures, f"{name}.jpg"), "rb") as f:
            data = f.read()
        for walk in ("native", "python"):
            got = jpeg.decode_jpeg(data, name, walk)
            assert got.shape == want[name].shape, (name, got.shape)
            d = np.abs(got.astype(np.int16) - want[name])
            worst = max(worst, int(d.max()))
            differing += int(np.count_nonzero(d))
            values += d.size
    assert worst <= JPEG_BAR, f"a decode {worst} levels from cv2's"
    emit(f"[jpeg-held] {len(names)} committed files (tests/fixtures/jpeg: "
         f"baseline, progressive, every sampling, restart, optimized, gray, "
         f"EXIF), both walks, against cv2's pixels: max |diff| {worst} "
         f"(bar {JPEG_BAR}), {differing} of {values} values differ")
    res["held"] = dict(files=len(names), max_abs_diff=worst,
                       differing=differing, values=values)

    # -- host ms per decode at three frame sizes ------------------------------
    fixture = os.path.join(root, "tests", "fixtures", "tum",
                           "rgbd_dataset_freiburg1_fixture")
    pngs = sorted(os.listdir(os.path.join(fixture, "rgb")))
    frame = read_png(os.path.join(fixture, "rgb", pngs[0]))
    walk_ms = {}

    def timed_walk(name):
        real = getattr(jpeg, name)

        def timed(*a):
            t0 = time.perf_counter()
            out = real(*a)
            walk_ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

        setattr(jpeg, name, timed)
        return lambda: setattr(jpeg, name, real)

    def median_ms(fn, reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return _median(out)

    def decode_ms(data, walk, reps):
        """Median host ms of a whole decode and of its entropy walk."""
        total, walks = [], []
        restore = timed_walk(f"_walk_{walk}")
        try:
            for _ in range(reps):
                walk_ms.clear()
                t0 = time.perf_counter()
                jpeg.decode_jpeg(data, walk=walk)
                total.append((time.perf_counter() - t0) * 1e3)
                walks.append(sum(walk_ms[f"_walk_{walk}"]))
        finally:
            restore()
        return _median(total), _median(walks)

    res["decode"] = {}
    for h, w in JPEG_SIZES:
        img = frame if (h, w) == frame.shape[:2] else resize_crop_u8(
            frame, h, w, h, w)
        t0 = time.perf_counter()
        data = jpeg.encode_jpeg(img, JPEG_QUALITY)
        enc_ms = (time.perf_counter() - t0) * 1e3
        png = encode_png(img)
        row = dict(jpeg_bytes=len(data), png_bytes=len(png), encode_ms=enc_ms)
        for walk, reps in (("native", JPEG_REPS), ("python", 2)):
            row[f"{walk}_ms"], row[f"{walk}_walk_ms"] = decode_ms(
                data, walk, reps)
        assert (jpeg.decode_jpeg(data, walk="python")
                == jpeg.decode_jpeg(data)).all()
        row["png_ms"] = median_ms(lambda: decode_png(png), JPEG_REPS)
        res["decode"][f"{w}x{h}"] = row
        emit(f"[jpeg-decode] {w}x{h} quality {JPEG_QUALITY} "
             f"({row['jpeg_bytes']} bytes; PNG {row['png_bytes']}): host ms "
             f"per decode, median: C++ walk {row['native_ms']:.2f} (walk "
             f"{row['native_walk_ms']:.2f}), plain Python walk "
             f"{row['python_ms']:.1f} (walk {row['python_walk_ms']:.1f}), "
             f"decode_png {row['png_ms']:.2f} | encode_jpeg "
             f"{row['encode_ms']:.2f} ms")

    # -- the CLI on the fixture's frames written as JPEG ----------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jpeg_")
    try:
        seq = os.path.join(tmp, "tum_fixture_jpeg")
        os.makedirs(seq)
        for p in pngs:  # all 24: the fixture config subsamples by 2
            with open(os.path.join(seq, p[:-4] + ".jpg"), "wb") as f:
                f.write(jpeg.encode_jpeg(
                    read_png(os.path.join(fixture, "rgb", p)), JPEG_QUALITY))
        cli_line, cli = _cli_phase(
            torch, root, cr, device, seq,
            os.path.join(root, "tests", "fixtures", "tum",
                         "eval_fixture.yaml"), argv, profile=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert cli["frames"] == png_cli["frames"], (cli["frames"],
                                                png_cli["frames"])
    assert cli["launches"] == cli["renders"] > 0, cli["launches"]
    emit(cli_line.replace("[cli]", "[jpeg-cli]", 1)
         + f" | {cli['run_s']:.1f} s on {len(pngs)} JPEG frames (quality "
         f"{JPEG_QUALITY}, RGBFiles) vs {png_cli['run_s']:.1f} s on the PNG "
         f"frames (rgb.txt)")
    res["cli"] = cli

    # -- the demo on two JPEG files, and the web app --------------------------
    model = make_model()
    rng = np.random.default_rng(7)
    tex = (rng.random((H + 16, W + 32, 3)) * 255).astype(np.uint8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jpeg_demo_")
    try:
        imgs = [os.path.join(tmp, "a.jpg"), os.path.join(tmp, "b.jpg")]
        for path, img in zip(imgs, (tex[:H, :W], tex[8:8 + H, 16:16 + W])):
            with open(path, "wb") as f:
                f.write(jpeg.encode_jpeg(img, JPEG_QUALITY))
        out = os.path.join(tmp, "demo")
        cr.launches = cr.bwd_launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            rc = demo.main([*imgs, "--out", out, "--n-views",
                            str(JPEG_DEMO_VIEWS), "--img-size", str(W),
                            "--device", device], model=model)
            demo_s = time.perf_counter() - t0
        demo_launches = (cr.launches, cr.bwd_launches)
        assert rc == 0
        with open(os.path.join(out, "gaussians.ply"), "rb") as f:
            n_ply = _ply_vertices(f.read())
        views = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        urls = []
        for path in imgs:
            with open(path, "rb") as f:
                urls.append("data:image/jpeg;base64,"
                            + base64.b64encode(f.read()).decode())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert n_ply == 2 * H * W, n_ply
    assert len(views) == JPEG_DEMO_VIEWS, views
    assert demo_launches == (JPEG_DEMO_VIEWS, 0), demo_launches

    engine = webdemo.DemoEngine(model, img_size=W, k_max=256, device=device)
    server = webdemo.serve(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(
            url + "/reconstruct", headers={"Content-Type": "application/json"},
            data=json.dumps({"images": urls}).encode())
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            code, rec = r.status, json.loads(r.read())
        rec_ms = (time.perf_counter() - t0) * 1e3
        assert code == 200 and rec["ok"] and rec["n_gaussians"] == 2 * H * W
        cr.launches = cr.bwd_launches = 0
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"{url}/render?yaw=0.6&pitch=0.2",
                                    timeout=600) as r:
            ctype, body = r.headers.get("Content-Type"), r.read()
        get_ms = (time.perf_counter() - t0) * 1e3
        web_launches = (cr.launches, cr.bwd_launches)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert ctype == "image/jpeg", ctype
    assert web_launches == (1, 0), web_launches
    back = jpeg.decode_jpeg(body, "/render")
    assert back.shape == (H, W, 3), back.shape
    pixels = engine.render(0.6, 0.2)
    t0 = time.perf_counter()
    again = jpeg.encode_jpeg(pixels, 90)
    enc_ms = (time.perf_counter() - t0) * 1e3
    assert again == body, "/render's body is not encode_jpeg's"
    del engine, model
    emit(f"[jpeg-demo] demo.main(2 {H}x{W} JPEG files, --n-views "
         f"{JPEG_DEMO_VIEWS}) exit {rc} in {demo_s:.2f} s, PLY {n_ply} "
         f"vertices, {len(views)} views, compositor launches "
         f"{demo_launches[0]} | web app: POST /reconstruct (2 JPEG data URLs) "
         f"{code} in {rec_ms:.1f} ms, {rec['n_gaussians']} gaussians; GET "
         f"/render {ctype} in {get_ms:.2f} ms ({len(body)} bytes, read back "
         f"{back.shape[1]}x{back.shape[0]}, equal to encode_jpeg of "
         f"engine.render's pixels), compositor launches {web_launches[0]}; "
         f"encode_jpeg of a {W}x{H} render {enc_ms:.2f} ms")
    res["demo"] = dict(seconds=demo_s, launches=demo_launches[0], ply=n_ply)
    res["web"] = dict(reconstruct_ms=rec_ms, render_ms=get_ms,
                      render_bytes=len(body), encode_ms=enc_ms,
                      launches=web_launches[0])
    res["launches"] = cli["launches"] + demo_launches[0] + web_launches[0]
    res["kernel_vs_plain"] = cli["kernel_vs_plain"]
    return lines, res


DIST_STEPS = 2  # mesh trainer against the single-device trainer
DIST_LOSS_RTOL = 1e-4  # relative difference of each step's loss
DIST_PARAM_LR = 2.0  # largest parameter difference, in units of lr
ENTRY_CALLS = 3


def _held_step_rows(torch, cr, args, path):
    """Both kernels against their plain versions on a training step's own
    rows (the backward compositor's arguments: counts, origins, rows,
    output cotangent, forward output) → dict(fwd_err, bwd_rel_err,
    bwd_abs_err, rows). Raises past TOL and BWD_TOL."""
    cnt, org, rw, gout, out = args
    held = _held_rows(torch, cr, (cnt, org, rw), path)
    bwd_rel, bwd_abs = bwd_errors(cr.composite_bwd(cnt, org, rw, gout, out),
                                  cr.composite_bwd_torch(cnt, org, rw, gout,
                                                         out))
    assert bwd_rel <= BWD_TOL, f"{path} backward vs plain {bwd_rel}"
    return dict(fwd_err=held["err"], bwd_rel_err=bwd_rel,
                bwd_abs_err=bwd_abs, rows=held["rows"])


def _smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _dist_phase(torch, cr, train_res, work):
    """5b. The multi-GPU training path at world size 1 over NCCL: the
    flagship forward of `graft_entry.entry()`, `train.main --devices 1`
    through the mesh, the mesh `Trainer` against the single-device one
    from identical weights and batches, and `graft_entry.dryrun_multichip
    (1)`. → (lines, results); results["launches"] is (forward, backward)
    over the three runs through the mesh."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from splatt3r_slam_tpu_torch import graft_entry
    from splatt3r_slam_tpu_torch import train as train_mod
    from splatt3r_slam_tpu_torch.models import TwoViewConfig
    from splatt3r_slam_tpu_torch.parallel import TrainConfig, Trainer
    from splatt3r_slam_tpu_torch.parallel import mesh as pmesh
    from splatt3r_slam_tpu_torch.train import synthetic_batches

    smi = _smi()
    lines, res = [], {"smi": smi}
    th, tw = TRAIN_HW

    # the flagship two-view forward (ViT-L, 384x512, seeded weights)
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    entry_ms = []
    for _ in range(ENTRY_CALLS):
        ta = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        entry_ms.append((time.perf_counter() - ta) * 1e3)
    for r in out:
        assert tuple(r["pts3d"].shape) == (1, H, W, 3), r["pts3d"].shape
        assert torch.isfinite(r["pts3d"]).all(), "entry pts3d not finite"
    lines.append(f"[dist-entry] graft_entry.entry(): TwoViewConfig() "
                 f"{H}x{W}, pts3d {tuple(out[0]['pts3d'].shape)} finite | "
                 f"model built in {build_s:.1f} s | forward ms "
                 + ", ".join(f"{m:.1f}" for m in entry_ms)
                 + f" (the first includes warm-up) | {smi}")
    res["entry"] = dict(build_s=build_s, forward_ms=entry_ms)
    del fn, args, out
    gc.collect()
    torch.cuda.empty_cache()

    # train.main through the mesh at world size 1, over NCCL
    seen = {"step_ms": []}
    real_build = train_mod.build_trainer

    def build(cfg, args, devices=0):
        trainer, model_cfg = real_build(cfg, args, devices)
        seen["backend"] = dist.get_backend()
        seen["mesh"] = pmesh.mesh_shape(trainer.mesh)
        seen["dtensor"] = all(isinstance(p, DTensor)
                              for p in trainer.model.parameters())
        real_make = trainer.make_train_step

        def make():
            step = real_make()

            def timed(batch):
                torch.cuda.synchronize()
                ta = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
                seen["step_ms"].append((time.perf_counter() - ta) * 1e3)
                seen.setdefault("losses", []).append(float(m["loss"]))
                return m

            return timed

        trainer.make_train_step = make
        real_save = trainer.save_params

        def save(path):
            ta = time.perf_counter()
            real_save(path)
            seen["save_s"] = time.perf_counter() - ta

        trainer.save_params = save
        return trainer, model_cfg

    kept = {}
    real_bwd = cr.composite_bwd

    def keep_bwd(*a):
        kept["args"] = tuple(t.detach() for t in a)
        return real_bwd(*a)

    out_dir = os.path.join(work, "train_main")
    t_main = time.perf_counter()
    train_mod.build_trainer = build
    cr.composite_bwd = keep_bwd
    torch.cuda.reset_peak_memory_stats()
    cr.launches = cr.bwd_launches = 0
    try:
        rc = train_mod.main([
            "--devices", "1", "--steps", str(TRAIN_STEPS), "--res", str(th),
            str(tw), "--set", "train.render_loss=true",
            "train.ssim_weight=0.1", "train.mast3r_loss_weight=1.0",
            "train.k_max=256", "--out", out_dir, "--name", "dist"])
    finally:
        train_mod.build_trainer = real_build
        cr.composite_bwd = real_bwd
    main_launches = (cr.launches, cr.bwd_launches)
    main_peak = torch.cuda.max_memory_allocated() / 2**30
    main_s = time.perf_counter() - t_main
    want = TRAIN_STEPS * 1 * 1
    assert rc == 0, rc
    assert seen["backend"] == "nccl", seen["backend"]
    assert seen["dtensor"], "a parameter of the mesh model is no DTensor"
    assert seen["mesh"] == {"dp": 1, "fsdp": 1, "tp": 1}, seen["mesh"]
    assert main_launches == (want, want), \
        f"{main_launches} launches for {want} renders"
    assert all(np.isfinite(v) for v in seen["losses"]), seen["losses"]
    (ws,) = os.listdir(out_dir)
    csv_rows = open(os.path.join(out_dir, ws, "dist_metrics.csv")).read()
    assert len(csv_rows.splitlines()) == TRAIN_STEPS + 1, csv_rows
    assert os.path.exists(os.path.join(out_dir, ws, "params_final.npz"))
    assert not dist.is_initialized(), "train.main left its group open"
    # its last step's own rows, as phase 5 holds its own. The random
    # model's second step puts its gaussians up to 1.4e5 px off screen:
    # the means' gradients peak at 8e-10 there, and the plain version on
    # the card and on the CPU differ by 3.7e-3 of that peak, so no kernel
    # can be held at 1e-4 on those rows
    main_rows = _held_step_rows(torch, cr, kept.pop("args"),
                                "dist train.main")
    lines.append(
        f"[dist-train-main] train.main --devices 1: backend "
        f"{seen['backend']}, mesh {seen['mesh']}, every parameter a "
        f"DTensor | {TRAIN_STEPS} steps {th}x{tw} B=1 V=1 ViT-L bf16, "
        f"gaussian heads only | step ms "
        + ", ".join(f"{m:.1f}" for m in seen["step_ms"])
        + f" (single-device phase 5: "
        + ", ".join(f"{m:.1f}" for m in train_res["step_ms"])
        + f") | loss " + ", ".join(f"{v:.4f}" for v in seen["losses"])
        + f" | peak memory {main_peak:.2f} GiB (phase 5: "
        f"{train_res['peak_gib']:.2f}) | compositor launches forward "
        f"{main_launches[0]} / backward {main_launches[1]} = renders "
        f"{want} | its last step's own rows ({main_rows['rows']} rows): "
        f"kernel vs plain forward {main_rows['fwd_err']:.2e}, backward "
        f"{main_rows['bwd_rel_err']:.2e} of column peak | {main_s:.1f} s "
        f"in all, save_params (whole tensors, np.savez) "
        f"{seen['save_s']:.1f} s of it | {smi}")
    res["train_main"] = dict(step_ms=seen["step_ms"], losses=seen["losses"],
                             s=main_s, save_s=seen["save_s"],
                             peak_gib=main_peak, launches=main_launches,
                             backend=seen["backend"], mesh=seen["mesh"],
                             rows=main_rows)

    # the mesh Trainer against the single-device Trainer: identical seeded
    # weights, identical batches, cuDNN's deterministic algorithms
    tcfg = TrainConfig(render_loss=True, ssim_weight=0.1,
                       mast3r_loss_weight=1.0, k_max=256)
    batches = list(synthetic_batches(DIST_STEPS, 1, th, tw, True, seed=0))
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    runs = {}
    t_cmp = time.perf_counter()
    try:
        for name in ("mesh", "single"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cr.launches = cr.bwd_launches = 0
            group = pmesh.process_group(
                0, 1, f"file://{os.path.join(work, 'store_' + name)}",
                "cuda") if name == "mesh" else contextlib.nullcontext()
            with group:
                mesh = pmesh.make_mesh(1) if name == "mesh" else None
                trainer = Trainer(TwoViewConfig(), tcfg, device="cuda",
                                  mesh=mesh, seed=0)
                step = trainer.make_train_step()
                ms, losses = [], []
                for b in batches:
                    torch.cuda.synchronize()
                    ta = time.perf_counter()
                    m = step(b)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - ta) * 1e3)
                    losses.append(float(m["loss"]))
                params = {k: v.detach().float().cpu() for k, v in
                          pmesh.full_tensors(trainer.model).items()}
                runs[name] = dict(
                    step_ms=ms, losses=losses, params=params,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    launches=(cr.launches, cr.bwd_launches),
                    dtensor=all(isinstance(p, DTensor)
                                for p in trainer.model.parameters()))
                del trainer, step, mesh
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
    cmp_s = time.perf_counter() - t_cmp
    mr, sr = runs["mesh"], runs["single"]
    assert mr["dtensor"] and not sr["dtensor"]
    assert mr["launches"] == sr["launches"] == (DIST_STEPS, DIST_STEPS), \
        (mr["launches"], sr["launches"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(mr["losses"], sr["losses"]))
    assert set(mr["params"]) == set(sr["params"])
    param_diff = max(float((mr["params"][k] - v).abs().max())
                     for k, v in sr["params"].items())
    param_tol = DIST_PARAM_LR * tcfg.lr
    assert loss_rel <= DIST_LOSS_RTOL, f"loss differs by {loss_rel:.3e}"
    assert param_diff <= param_tol, f"parameters differ by {param_diff:.3e}"

    lines.append(
        f"[dist-trainer] mesh Trainer (1, 1, 1) over NCCL vs single-device "
        f"Trainer, {DIST_STEPS} steps from identical weights and batches "
        f"(cuDNN deterministic): loss "
        + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in
                    zip(mr["losses"], sr["losses"]))
        + f", largest relative difference {loss_rel:.3e} (limit "
        f"{DIST_LOSS_RTOL:g}), largest parameter difference "
        f"{param_diff:.3e} (limit {DIST_PARAM_LR:g}·lr = {param_tol:.1e}) | "
        f"step ms mesh " + ", ".join(f"{m:.1f}" for m in mr["step_ms"])
        + " vs single " + ", ".join(f"{m:.1f}" for m in sr["step_ms"])
        + f" | peak memory mesh {mr['peak_gib']:.2f} GiB vs single "
        f"{sr['peak_gib']:.2f} | launches mesh {mr['launches']}, single "
        f"{sr['launches']} | {cmp_s:.1f} s in all | {smi}")
    res["trainer"] = dict(
        loss_rel=loss_rel, param_diff=param_diff, param_tol=param_tol,
        mesh={k: v for k, v in mr.items() if k != "params"},
        single={k: v for k, v in sr.items() if k != "params"}, s=cmp_s)
    mesh_launches = mr["launches"]
    del runs, mr, sr
    gc.collect()
    torch.cuda.empty_cache()

    # one full-loss sharded step (tiny model, every parameter training)
    cr.launches = cr.bwd_launches = 0
    cr.composite_bwd = keep_bwd
    t0 = time.perf_counter()
    try:
        dry = graft_entry.dryrun_multichip(1)
    finally:
        cr.composite_bwd = real_bwd
    dry_s = time.perf_counter() - t0
    dry_launches = (cr.launches, cr.bwd_launches)
    dry_rows = _held_step_rows(torch, cr, kept.pop("args"), "dist dry run")
    for k in ("loss", "mse", "ssim", "lpips", "regr3d"):
        assert np.isfinite(dry[k]), (k, dry)
    assert dry["loss"] != dry["regr3d"], "a loss term is not live"
    assert dry["mesh"] == {"dp": 1, "fsdp": 1, "tp": 1}, dry["mesh"]
    assert dry_launches == (1, 1), dry_launches
    lines.append(
        f"[dist-dryrun] dryrun_multichip(1) on {dry['mesh']}: loss "
        f"{dry['loss']:.4f} = mse {dry['mse']:.4f} + ssim {dry['ssim']:.4f}"
        f" + lpips {dry['lpips']:.4f} + regr3d {dry['regr3d']:.4f}, every "
        f"term finite and live | {dry_s:.1f} s | compositor launches "
        f"{dry_launches} | its step's own rows ({dry_rows['rows']} rows): "
        f"kernel vs plain forward {dry_rows['fwd_err']:.2e}, backward "
        f"{dry_rows['bwd_rel_err']:.2e} of column peak | {smi}")
    res["dryrun"] = dict(metrics=dry, s=dry_s, launches=dry_launches,
                         rows=dry_rows)
    res["launches"] = tuple(
        a + b + c for a, b, c in zip(main_launches, mesh_launches,
                                     dry_launches))
    res["kernel_vs_plain"] = max(main_rows["fwd_err"], dry_rows["fwd_err"])
    res["bwd_rel_err"] = max(main_rows["bwd_rel_err"],
                             dry_rows["bwd_rel_err"])
    return lines, res


# The scripts phase: each script's `main(argv)` as a user runs it
SCRIPT_ARGV = {
    "bench_rasterizer": [],
    "bench_rasterizer_grad": [],
    "bench_attention": [],
    "bench_heads_batched": ["tracking"],
    "sweep_accuracy": [],
    "ablations": [],
}
# the image-level difference of the plain renderer and the kernel's render
# (a·du² against (a·du)·du moves a frame by ~2e-4): the JAX tests'
# compositor bar (tests/test_pallas_rasterizer.py)
IMAGE_BAR = 2e-3
# the vmapped bf16 heads against the sequential ones, of the output's peak:
# a few bf16 steps (2^-8) through a dozen bf16 convolutions and expm1
HEADS_BAR = 2 ** -5
# einsum attention against SDPA, both rounded to bf16, outputs of order 1
# (and against the flash kernel, which rounds p where the einsum path
# rounds the normalised weights)
ATTENTION_BAR = 0.05
# bench_attention's flash calls at each shape: 2 warm-ups, time_calls' own
# warm-up and 30 timed calls, and the difference from the einsum path
ATTENTION_FLASH_LAUNCHES = 3 * (2 + 1 + 30 + 1)
GRAD_FWD_LAUNCHES = 11 + 11 + 8  # value_and_grad, forward alone, FD probe
GRAD_BWD_LAUNCHES = 11


def _vgg_state_dict(torch, seed=0):
    """A fabricated `lpips.LPIPS('vgg')` state dict: the module's keys and
    shapes, seeded values."""
    from splatt3r_slam_tpu_torch.utils.lpips import LIN_CHANNELS, VGG_SLICES

    g = torch.Generator().manual_seed(seed)
    base = [0, 4, 9, 16, 23]
    sd = {}
    for s, block in enumerate(VGG_SLICES):
        for idx, cin, cout in block:
            stem = f"net.slice{s + 1}.{idx - base[s]}"
            sd[stem + ".weight"] = torch.randn(cout, cin, 3, 3, generator=g)
            sd[stem + ".bias"] = torch.randn(cout, generator=g)
        sd[f"lin{s}.model.1.weight"] = torch.rand(
            1, LIN_CHANNELS[s], 1, 1, generator=g)
    return sd


def _scripts_phase(torch, root, cr, work):
    """7b. The kernel, model and accuracy scripts and the ablation runner,
    each through its `main` on the card, the compositor's counts set to 0
    just before each and read just after; both kernels held against their
    plain versions on the scripts' own rows → (lines, results)."""
    import numpy as np

    from splatt3r_slam_tpu_torch import ablations
    from splatt3r_slam_tpu_torch.models import flash_attention as fl
    from splatt3r_slam_tpu_torch.scripts import (
        bench_attention,
        bench_heads_batched,
        bench_rasterizer,
        bench_rasterizer_grad,
        compute_ate,
        convert_lpips,
        make_tum_fixture,
        sweep_accuracy,
    )
    from splatt3r_slam_tpu_torch.utils.image import read_png
    from splatt3r_slam_tpu_torch.utils.lpips import (
        convert_torch_lpips,
        load_lpips_params,
    )

    lines, res, launches = [], {}, {}
    t_phase = time.perf_counter()
    smi = _smi()

    # bench_rasterizer: 400k, 1M, 4M gaussians, one warm-up and 5 timed
    # renders each through the kernel; then the kernel against its plain
    # version on each scene's own rows, timed, with its bound
    torch.cuda.reset_peak_memory_stats()
    r, r_s, launches["bench_rasterizer"] = _run_entry(
        bench_rasterizer.main, SCRIPT_ARGV["bench_rasterizer"], cr)
    counts = bench_rasterizer.COUNTS
    assert launches["bench_rasterizer"] == (
        len(counts) * (1 + bench_rasterizer.ITERS), 0), \
        launches["bench_rasterizer"]
    rows = {}
    for g in counts:
        row = r[str(g)]
        assert isinstance(row["plain_ms"], float) and \
            isinstance(row["cuda_ms"], float), row
        assert row["max_abs_diff"] <= IMAGE_BAR, (g, row)
        scene = bench_rasterizer.scene_tensors(g, "cuda")
        packed = cr.pack_rows(*scene, bench_rasterizer.HW, tpg_side=4,
                              k_max=512)
        rows[g] = _held_rows(torch, cr, packed, f"bench_rasterizer {g}",
                             timed=True)
        rows[g]["capped_tiles"] = int((packed[0] == 512).sum())
        del scene, packed
    lines.append(f"[scripts-bench_rasterizer] {json.dumps(r)} | {r_s:.1f} s")
    lines.append(
        "[scripts-bench_rasterizer-rows] " + "; ".join(
            f"{g}: {h['rows']} rows ({h['capped_tiles']} tiles at the cap), "
            f"kernel vs plain {h['err']:.3e} (tol {TOL:g}), {h['ms']:.4f} ms "
            f"on the device, call_ms {h['call_ms']:.4f}, plain "
            f"{h['plain_ms']:.3f} ms, bound {h['bound_ms']:.4f} ms by "
            f"{h['bound_by']}" for g, h in rows.items()) + f" | {smi}")
    res["bench_rasterizer"] = dict(r, seconds=r_s, rows=rows)

    # bench_rasterizer_grad: the backward kernel's gate at 400k; the
    # arguments of its last backward launch are kept for the hold below
    kept = {}
    real_bwd = cr.composite_bwd

    def keep_bwd(*a):
        kept["args"] = tuple(t.detach() for t in a)
        return real_bwd(*a)

    cr.composite_bwd = keep_bwd
    try:
        gr, gr_s, launches["bench_rasterizer_grad"] = _run_entry(
            bench_rasterizer_grad.main, SCRIPT_ARGV["bench_rasterizer_grad"],
            cr)
    finally:
        cr.composite_bwd = real_bwd
    assert gr["backward_validated_on_hardware"] is True, gr
    assert launches["bench_rasterizer_grad"] == (
        GRAD_FWD_LAUNCHES, GRAD_BWD_LAUNCHES), \
        launches["bench_rasterizer_grad"]
    held = _held_step_rows(torch, cr, kept["args"], "bench_rasterizer_grad")
    cnt, org, rw, gout, out = kept["args"]

    def run_bwd():
        return cr.composite_bwd(cnt, org, rw, gout, out)

    held.update(
        ms=device_ms(run_bwd, torch), call_ms=call_ms(run_bwd, torch),
        plain_ms=call_ms(lambda: cr.composite_bwd_torch(cnt, org, rw, gout,
                                                        out), torch, 3))
    held["bound_ms"], held["bound_by"] = _bound_bwd_ms(cnt)
    lines.append(f"[scripts-bench_rasterizer_grad] {json.dumps(gr)} | "
                 f"{gr_s:.1f} s")
    lines.append(
        f"[scripts-bench_rasterizer_grad-rows] the last backward's "
        f"{held['rows']} rows: forward kernel vs plain {held['fwd_err']:.3e} "
        f"(tol {TOL:g}), backward {held['bwd_rel_err']:.3e} of a column's "
        f"peak (tol {BWD_TOL:g}; {held['bwd_abs_err']:.3e} absolute) | "
        f"backward {held['ms']:.4f} ms on the device, call_ms "
        f"{held['call_ms']:.4f}, plain {held['plain_ms']:.3f} ms, bound "
        f"{held['bound_ms']:.4f} ms by {held['bound_by']} | {smi}")
    res["bench_rasterizer_grad"] = dict(gr, seconds=gr_s, rows=held)
    del kept, cnt, org, rw, gout, out

    # bench_attention: flash and efficient SDPA run at every shape, and so
    # does the port's flash kernel (the only flash launches of the phase)
    _no_flash(fl, "scripts before bench_attention")
    a, a_s, launches["bench_attention"] = _run_entry(
        bench_attention.main, SCRIPT_ARGV["bench_attention"], cr)
    res["flash_launches"] = fl.launches
    fl.launches = 0
    assert res["flash_launches"] == ATTENTION_FLASH_LAUNCHES, \
        res["flash_launches"]
    for label, row in a["results"].items():
        for b in ("flash", "efficient"):
            assert isinstance(row[f"sdpa_{b}_ms"], float), (label, row)
        assert row["max_abs_diff"] <= ATTENTION_BAR, (label, row)
        assert isinstance(row["flash_ms"], float), (label, row)
        assert row["flash_max_abs_diff"] <= ATTENTION_BAR, (label, row)
    lines.append(f"[scripts-bench_attention] {json.dumps(a)} | flash "
                 f"launches {res['flash_launches']} | {a_s:.1f} s")
    res["bench_attention"] = dict(a, seconds=a_s)

    # bench_heads_batched: the vmapped heads equal the sequential ones
    hb, hb_s, launches["bench_heads_batched"] = _run_entry(
        bench_heads_batched.main, SCRIPT_ARGV["bench_heads_batched"], cr)
    assert hb["max_abs_diff"] <= HEADS_BAR * hb["max_abs"], hb
    lines.append(f"[scripts-bench_heads_batched] {json.dumps(hb)} (held "
                 f"<= {HEADS_BAR:g} of the peak) | {hb_s:.1f} s")
    res["bench_heads_batched"] = dict(hb, seconds=hb_s)

    # sweep_accuracy, in the work directory (it writes logs/ there)
    here = os.getcwd()
    os.chdir(work)
    try:
        sw, sw_s, launches["sweep_accuracy"] = _run_entry(
            sweep_accuracy.main, SCRIPT_ARGV["sweep_accuracy"], cr)
        assert os.path.exists(os.path.join("logs", "sweep_accuracy.json"))
    finally:
        os.chdir(here)
    ref = sw["tracking"]["reference-exact"]
    assert ref["fails"] == 0, ref
    lines.append(
        "[scripts-sweep_accuracy] " + "; ".join(
            f"{k}: rot {v['rot_deg_mean']:.4f} deg, t {v['t_err_mean']:.5f},"
            f" fails {v['fails']}, match_frac {v['match_frac']:.3f}"
            for k, v in sw["tracking"].items()) + " | " + "; ".join(
            f"{k}: ATE {v['ate_mean']:.5f} (max {v['ate_max']:.5f})"
            for k, v in sw["backend"].items()) + f" | {sw_s:.1f} s")
    res["sweep_accuracy"] = dict(sw, seconds=sw_s)

    # ablations: six recipes, each a fresh full-width model, 5 steps
    torch.cuda.reset_peak_memory_stats()
    ab, ab_s, launches["ablations"] = _run_entry(
        ablations.main, SCRIPT_ARGV["ablations"]
        + ["--out", os.path.join(work, "ablations")], cr)
    assert list(ab) == list(ablations.ABLATIONS), list(ab)
    assert all(np.isfinite(v) for m in ab.values() for v in m.values()), ab
    n_steps = len(ablations.ABLATIONS) * 5
    assert launches["ablations"] == (n_steps, n_steps), launches["ablations"]
    ab_peak = torch.cuda.max_memory_allocated() / 2**30
    lines.append(f"[scripts-ablations] {json.dumps(ab)} | peak "
                 f"{ab_peak:.2f} GiB | {ab_s:.1f} s")
    res["ablations"] = dict(ab, seconds=ab_s, peak_gib=ab_peak)

    # the host tools
    fx_src = os.path.join(root, "tests", "fixtures", "tum",
                          "rgbd_dataset_freiburg1_fixture")
    fx = os.path.join(work, "fixture")
    f, f_s, launches["make_tum_fixture"] = _run_entry(
        make_tum_fixture.main, ["--out", fx, "--frames", "24"], cr)
    for name in ("rgb.txt", "groundtruth.txt"):
        with open(os.path.join(fx, name), "rb") as x, \
                open(os.path.join(fx_src, name), "rb") as y:
            assert x.read() == y.read(), name
    pngs = sorted(os.listdir(os.path.join(fx_src, "rgb")))
    assert sorted(os.listdir(os.path.join(fx, "rgb"))) == pngs
    for name in pngs:
        assert np.array_equal(read_png(os.path.join(fx, "rgb", name)),
                              read_png(os.path.join(fx_src, "rgb", name))), \
            name
    gt = os.path.join(fx_src, "groundtruth.txt")
    c, c_s, launches["compute_ate"] = _run_entry(compute_ate.main, [gt, gt],
                                                  cr)
    assert c["ate_rmse"] <= 1e-9, c
    sd = _vgg_state_dict(torch)
    pt, npz = os.path.join(work, "lpips_vgg.pt"), os.path.join(work,
                                                              "lpips.npz")
    torch.save(sd, pt)
    lp, lp_s, launches["convert_lpips"] = _run_entry(
        convert_lpips.main, ["--from-file", pt, npz], cr)
    back = load_lpips_params(npz, device="cuda")
    want = convert_torch_lpips(sd, device="cuda")
    assert all(torch.equal(x[k], y[k])
               for bx, by in zip(back["convs"], want["convs"])
               for x, y in zip(bx, by) for k in ("kernel", "bias")), \
        "LPIPS kernels differ after the round trip"
    assert all(torch.equal(x, y) for x, y in zip(back["lins"],
                                                 want["lins"]))
    lines.append(
        f"[scripts-tools] make_tum_fixture {json.dumps(f)}: 24 PNGs with "
        f"the committed fixture's pixels, rgb.txt and groundtruth.txt "
        f"byte-identical ({f_s:.1f} s) | compute_ate of the groundtruth "
        f"against itself {json.dumps(c)} ({c_s:.1f} s) | convert_lpips "
        f"{json.dumps(lp)}: loads back through load_lpips_params equal to "
        f"the converted state dict ({lp_s:.1f} s)")
    res["tools"] = dict(make_tum_fixture=f, compute_ate=c, convert_lpips=lp)

    quiet = [k for k in launches if k not in ("bench_rasterizer",
                                              "bench_rasterizer_grad",
                                              "ablations")]
    assert all(launches[k] == (0, 0) for k in quiet), launches
    res["launches"] = (sum(f for f, _ in launches.values()),
                       sum(b for _, b in launches.values()))
    res["launches_by_script"] = launches
    res["kernel_vs_plain"] = max([h["err"] for h in rows.values()]
                                 + [held["fwd_err"]])
    res["bwd_rel_err"] = held["bwd_rel_err"]
    res["bwd_abs_err"] = held["bwd_abs_err"]
    res["seconds"] = time.perf_counter() - t_phase
    lines.append(f"[scripts] {res['seconds']:.1f} s | compositor launches "
                 f"forward {res['launches'][0]} / backward "
                 f"{res['launches'][1]} ({launches})")
    return lines, res


# -- 7c. the flash-attention path ---------------------------------------------

# (label, B, n_q, n_kv, H, Dh, dtype, v strided as the fused qkv hands it)
FLASH_SHAPES = (
    ("enc_self B2 N768 H16", 2, 768, 768, 16, 64, "bfloat16", False),
    ("dec_self B2 N768 H12", 2, 768, 768, 12, 64, "bfloat16", False),
    ("dec_cross B2 N768 H12", 2, 768, 768, 12, 64, "bfloat16", False),
    ("strided_v B2 N768 H16", 2, 768, 768, 16, 64, "bfloat16", True),
    ("cross B2 Nq768 Nkv1024 H12", 2, 768, 1024, 12, 64, "bfloat16", False),
    ("fp32 B1 N768 H16", 1, 768, 768, 16, 64, "float32", False),
    ("auto B1 N4096 H16", 1, 4096, 4096, 16, 64, "bfloat16", False),
)
# where the main paths call it: each view alone (B=1), the encoder's self
# attention (v strided) and the decoder's; 7c holds the forward and 7d the
# backward pair there
FLASH_STEP_SHAPES = (
    ("train_enc B1 N768 H16", 1, 768, 768, 16, 64, "bfloat16", True),
    ("train_dec B1 N768 H12", 1, 768, 768, 12, 64, "bfloat16", False),
)
# fp32: the fp32 comparison step's own calls (7d's fp32 model: each view
# alone, the encoder's with v strided, the decoder's) and the other head
# dims of the template instances (Dh 128 with v strided)
FLASH_FP32_SHAPES = (
    ("fp32_enc B1 N768 H16", 1, 768, 768, 16, 64, "float32", True),
    ("fp32_dec B1 N768 H12", 1, 768, 768, 12, 64, "float32", False),
) + tuple((f"fp32_dh{d} B1 Nq256 Nkv512 H4", 1, 256, 512, 4, d, "float32",
           d == 128) for d in (128, 256))
# the wide kernels (Dh a multiple of 128 from 384 up, the head dim at run
# time), both dtypes, every row with its residuals: Dh 384 and 512 at the
# Dh 128-256 rows' shape, a B1 N768 H8 row at Dh 512 and a Dh 1024 row
FLASH_WIDE_SHAPES = tuple(
    (f"{tag}_{name}", 1, nq, nk, nh, d, dt, False)
    for tag, dt in (("bf16", "bfloat16"), ("fp32", "float32"))
    for name, nq, nk, nh, d in (
        ("dh384 B1 Nq256 Nkv512 H4", 256, 512, 4, 384),
        ("dh512 B1 Nq256 Nkv512 H4", 256, 512, 4, 512),
        ("dh512n768 B1 N768 H8", 768, 768, 8, 512),
        ("dh1024 B1 Nq256 Nkv512 H2", 256, 512, 2, 1024)))
# above Dh 1024 the wide kernels run passes of clusters, each block
# contracting slices in turn (n = 9 slices: 2 passes of 5 blocks), both
# dtypes; 7c holds the forward there, 7d the fp32 pair
FLASH_WIDE_PASS_SHAPES = tuple(
    (f"{tag}_dh1152 B1 Nq256 Nkv512 H1", 1, 256, 512, 1, 1152, dt, False)
    for tag, dt in (("bf16", "bfloat16"), ("fp32", "float32")))
FLASH_WIDE_HEAD = "bf16_dh512n768 B1 N768 H8"  # their row in the JSON line
# the kernel against its plain version: two bf16 steps of the output's peak
# (both round p to bf16, against running maxima over 64 and 128 kv rows,
# and round the output to bf16); fp32 absolute (sums in another order)
FLASH_BF16_BAR = 2 ** -7
FLASH_FP32_BAR = 1e-5
# the fixture CLI with --flash-attention on and without the flag, in turns;
# with the model in fp32, on and auto once each
FLASH_CLI_RUNS = ("on", "auto", "auto", "on")
FLASH_CLI_FP32_RUNS = ("on", "auto")
PEAK_BF16 = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
PEAK_TF32 = 495e12  # the same, dense TF32


def _no_flash(fl, phase):
    """A phase in the default mode ("auto") launches no flash kernel,
    forward or backward: at the 768-token shape SDPA serves, as the einsum
    path does in the JAX package. The counts are never reset between such
    phases."""
    assert fl.launches == 0 and fl.bwd_launches == 0, \
        f"{phase}: {fl.launches} flash-attention launches, " \
        f"{fl.bwd_launches} backward, in 'auto' mode"


def _flash_bound_ms(B, n_q, n_kv, H, D, itemsize):
    """Least time for one attention: the larger of its two products'
    operations (4·B·H·n_q·n_kv·Dh) over the card's peak for the inputs'
    type and the bytes of q, k and v read once and the output written once
    over the memory rate → (ms, what bounds it). In bf16 the products run
    on the tensor cores; in fp32 they take the faster of two routes that
    keep fp32's accuracy: the fp32 pipes (PEAK_FP32) or the tensor cores
    in split TF32, three TF32 products for each (PEAK_TF32 / 3)."""
    ops = 4 * B * H * n_q * n_kv * D
    t_ops = ops / PEAK_BF16 if itemsize == 2 else min(
        ops / PEAK_FP32, 3 * ops / PEAK_TF32)
    t_bytes = itemsize * B * H * D * (2 * n_q + 2 * n_kv) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _flash_held(torch, fl, q, k, v, scale, what, timed=True):
    """The flash kernel against its plain version on (q, k, v), in their
    working dtype, and with `timed` its device time, one isolated call,
    the plain version's call, SDPA's device time on the same inputs and
    the bound → dict."""
    import torch.nn.functional as F

    got = fl.flash_attention(q, k, v, scale)
    want = fl.flash_attention_torch(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == v.dtype, what
    assert torch.isfinite(got).all(), f"{what}: flash output not finite"
    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    bar = (FLASH_BF16_BAR * peak if v.dtype == torch.bfloat16
           else FLASH_FP32_BAR)
    assert err <= bar, f"{what}: flash kernel vs plain {err} > {bar}"
    B, n_q, H, D = q.shape
    h = dict(shape=[B, n_q, k.shape[1], H, D], dtype=str(v.dtype)[6:],
             v_contiguous=v.is_contiguous(), err=err, bar=bar, peak=peak)
    if timed:
        def run():
            return fl.flash_attention(q, k, v, scale)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                scale=scale)

        h.update(ms=device_ms(run, torch), call_ms=call_ms(run, torch),
                 plain_ms=call_ms(lambda: fl.flash_attention_torch(
                     q, k, v, scale), torch, 5),
                 library_ms=device_ms(sdpa, torch))
        h["bound_ms"], h["bound_by"] = _flash_bound_ms(
            B, n_q, k.shape[1], H, D, v.element_size())
    return h


# the ctypes argument types of the plan entry points: flash_attention_plan
# (dtype, D, B, H, n_q, plan[4]) and flash_attention_bwd_plan (dkv, dtype,
# D, B, H, n_q, n_kv, plan[4]), dtype 0 bf16 and 1 fp32;
# tests/test_torch_port_flash.py holds them against the C signatures
FLASH_PLAN_ARGTYPES = {
    "flash_attention_plan": [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_int)],
    "flash_attention_bwd_plan": [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int)],
}


def _flash_plans(torch, so, log):
    """plan(dtype, B, n_q, H, D) → how the bf16 or fp32 (dtype "bfloat16"
    or "float32") forward of the library `so` runs at that shape: the
    blocks it launches, its blocks an SM (the occupancy API), its
    cluster's blocks (1 without one) and the clusters resident at once
    (cudaOccupancyMaxActiveClusters, 0 without), the waves (over the
    card's SMs, or over the resident clusters), its registers and spill
    bytes (from the library's ptxas log `log`)."""
    fn = ctypes.CDLL(str(so)).flash_attention_plan
    fn.argtypes = FLASH_PLAN_ARGTYPES["flash_attention_plan"]
    fn.restype = ctypes.c_int
    from splatt3r_slam_tpu_torch.models.flash_attention import wide_head_dim

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plan(dtype, B, n_q, H, D):
        out = (ctypes.c_int * 4)()
        fp32 = dtype == "float32"
        assert fn(int(fp32), D, B, H, n_q, out) == 0
        kind = "f32" if fp32 else "bf16"
        key = (f"flash_fwd_wide_{kind}E" if wide_head_dim(D)
               else f"flash_fwd_{kind}ILi{D}EE")
        regs, spill_st, spill_ld = _ptxas_kernel(log, key)
        blocks, per_sm, cluster, clusters = out
        assert per_sm > 0 and clusters >= 0, list(out)
        return dict(blocks=blocks, blocks_per_sm=per_sm, cluster=cluster,
                    max_active_clusters=clusters, registers=regs,
                    spill_stores=spill_st, spill_loads=spill_ld,
                    waves=(blocks / cluster / clusters if clusters
                           else blocks / (sms * per_sm)), sms=sms)

    return plan


def _flash_phase(torch, root, cr, fl, layers, device="cuda"):
    """7c. The flash-attention path at full width → (lines, results): the
    kernel against its plain version at the path's shapes (timed, beside
    SDPA and the bound), `auto` at its threshold, the fixture CLI with
    --flash-attention on and without it in turns (every attend call a
    launch; the kernel held on the last call's own q, k and v), one
    tracked frame under the profiler and `bench` with the mode on."""
    import numpy as np

    from splatt3r_slam_tpu_torch import bench, cuda_build
    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.models import TwoViewConfig, init_model
    from splatt3r_slam_tpu_torch.runtime.frame import create_frame
    from splatt3r_slam_tpu_torch.runtime.inference import InferenceEngine
    from splatt3r_slam_tpu_torch.runtime.system import SLAMSystem

    assert layers.flash_attention_mode() == "auto"
    lines, res = [], {}
    t_phase = time.perf_counter()
    smi = _smi()
    rng = np.random.default_rng(11)

    def rand(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dtype)

    # the kernel against its plain version at the path's shapes
    plan = _flash_plans(torch, *cuda_build.build(
        ["flash_attention"])["flash_attention"])
    shapes = {}
    for label, B, nq, nk, nh, D, dt_name, strided in (
            FLASH_SHAPES + FLASH_STEP_SHAPES + FLASH_FP32_SHAPES
            + FLASH_WIDE_SHAPES + FLASH_WIDE_PASS_SHAPES):
        dt = getattr(torch, dt_name)
        # with `strided`, v as Attention hands it over (n_kv rows)
        q, k, v, _ = _flash_bwd_inputs(torch, rng, B, nq, nk, nh, D, dt,
                                       strided)
        h = shapes[label] = _flash_held(torch, fl, q, k, v, D ** -0.5, label)
        h["plan"] = plan(dt_name, B, nq, nh, D)
        # the residuals of the fp32 step's calls and of the wide kernels
        if dt == torch.float32 or fl.wide_head_dim(D):
            *_, h["l_err"], h["m_err"] = _flash_residuals_held(
                torch, fl, q, k, v, D ** -0.5, label)
        del q, k, v
    for label, h in shapes.items():
        g = h["plan"]
        res_errs = "" if "l_err" not in h else (
            f"; residuals l {h['l_err']:.1e}, m {h['m_err']:.1e} (bar "
            f"{FLASH_RES_BAR:.0e})")
        lines.append(
            f"[flash-kernel] {label} ({h['dtype']}, v "
            f"{'contiguous' if h['v_contiguous'] else 'strided'}): kernel "
            f"vs plain {h['err']:.3e} (bar {h['bar']:.3e}, peak "
            f"{h['peak']:.3f}){res_errs} | {h['ms']:.4f} ms on the device, "
            f"call_ms {h['call_ms']:.4f}, plain {h['plain_ms']:.3f} ms, SDPA "
            f"{h['library_ms']:.4f} ms | bound {h['bound_ms']:.4f} ms by "
            f"{h['bound_by']} | {g['blocks']} blocks, {g['blocks_per_sm']} "
            f"an SM"
            + (f", clusters of {g['cluster']}, {g['max_active_clusters']} "
               f"resident" if g["cluster"] > 1 else "")
            + f", {g['waves']:.2f} waves, {g['registers']} registers | "
            f"{smi}")

    # scales that are not 1/sqrt(64): not a power of two, and negative (the
    # bf16 kernel takes the smallest score of a row there), in both dtypes
    scales = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (rand(2, 768, 12, 64, dtype=dt) for _ in range(3))
        for scale in (0.1, -0.125):
            what = f"B2 N768 H12 {str(dt)[6:]} at scale {scale}"
            h = _flash_held(torch, fl, q, k, v, scale, what, timed=False)
            *_, h["l_err"], h["m_err"] = _flash_residuals_held(
                torch, fl, q, k, v, scale, what)
            scales[what] = h
            lines.append(
                f"[flash-scale] {what}: kernel vs plain {h['err']:.3e} (bar "
                f"{h['bar']:.3e}, peak {h['peak']:.3f}); residuals l "
                f"{h['l_err']:.1e}, m {h['m_err']:.1e} (bar "
                f"{FLASH_RES_BAR:.0e})")
        del q, k, v

    # auto: the kernel at the threshold, SDPA at the tracking shape
    picked = {}
    for n in (4096, 768):
        q, k, v = (rand(1, n, 16, 64, dtype=torch.bfloat16)
                   for _ in range(3))
        fl.launches = 0
        layers.attend(q, k, v, 0.125)
        picked[n] = fl.launches
    fl.launches = 0
    assert picked == {4096: 1, 768: 0}, picked
    lines.append(f"[flash-auto] mode auto: B1 H16 Dh64 at N4096 "
                 f"{picked[4096]} launch, at N768 {picked[768]} (SDPA)")

    # the fixture CLI, --flash-attention on and without it, in turns
    fixture = os.path.join(root, "tests", "fixtures", "tum")
    seq = os.path.join(fixture, "rgbd_dataset_freiburg1_fixture")
    config = os.path.join(fixture, "eval_fixture.yaml")
    real_attend = layers.attend
    seen = {"calls": 0}

    def counted(q, k, v, scale):
        seen["calls"] += 1
        seen["last"] = (q, k, v, scale)
        return real_attend(q, k, v, scale)

    runs, last = [], None
    layers.attend = counted
    try:
        for mode in FLASH_CLI_RUNS:
            seen["calls"] = 0
            fl.launches = 0
            _, r = _cli_phase(torch, root, cr, device, seq, config,
                              argv=["--flash-attention", mode],
                              profile=False)
            n_flash, n_attend = fl.launches, seen["calls"]
            assert layers.flash_attention_mode() == mode
            assert n_attend > 0, f"{mode}: no attention call"
            assert n_flash == (n_attend if mode == "on" else 0), \
                f"{mode}: {n_flash} flash launches, {n_attend} attend calls"
            if mode == "on":
                last = seen.pop("last")
            runs.append(dict(
                mode=mode, run_s=r["run_s"], frames=r["frames"],
                process_frame_ms=_median(r["ms"]["process_frame"]),
                attend_calls=n_attend, launches=n_flash,
                compositor_launches=r["launches"],
                kernel_vs_plain=r["kernel_vs_plain"]))
    finally:
        layers.attend = real_attend
        layers.set_flash_attention("auto")
    held = _flash_held(torch, fl, *last, "the CLI's last attention call")
    del last, seen
    lines.append(
        "[flash-cli] the fixture CLI in turns: " + ", ".join(
            f"{r['mode']} {r['run_s']:.1f} s (process_frame median "
            f"{r['process_frame_ms']:.2f} ms, {r['frames']} frames, "
            f"{r['attend_calls']} attend calls, {r['launches']} flash "
            f"launches)" for r in runs)
        + f" | the kernel vs plain on the last call's own q, k, v "
        f"{held['shape']} (v "
        f"{'contiguous' if held['v_contiguous'] else 'strided'}): "
        f"{held['err']:.3e} (bar {held['bar']:.3e}), "
        f"{held['ms']:.4f} ms on the device, call_ms {held['call_ms']:.4f}, "
        f"SDPA {held['library_ms']:.4f}, bound {held['bound_ms']:.4f} | {smi}")

    # the fixture CLI with the model in fp32 (the config's `model:` dtype
    # and head_dtype, as main.py reads them), --flash-attention on and auto
    # in turns: a serving run at full width through the fp32 kernel
    cfg_dir = tempfile.mkdtemp(prefix="chip_smoke_fp32_")
    config32 = os.path.join(cfg_dir, "eval_fixture_fp32.yaml")
    with open(config32, "w") as f:
        f.write(f'inherit: "{config}"\nmodel:\n  dtype: float32\n'
                "  head_dtype: float32\n")
    runs32, last32 = [], None
    seen = {"calls": 0}
    layers.attend = counted
    try:
        for mode in FLASH_CLI_FP32_RUNS:
            seen["calls"] = 0
            fl.launches = 0
            _, r = _cli_phase(torch, root, cr, device, seq, config32,
                              argv=["--flash-attention", mode],
                              profile=False)
            n_flash, n_attend = fl.launches, seen["calls"]
            assert n_attend > 0, f"fp32 {mode}: no attention call"
            assert seen["last"][0].dtype == torch.float32, \
                f"fp32 {mode}: attention in {seen['last'][0].dtype}"
            assert n_flash == (n_attend if mode == "on" else 0), \
                f"fp32 {mode}: {n_flash} flash launches, {n_attend} attend " \
                f"calls"
            if mode == "on":
                last32 = seen.pop("last")
            runs32.append(dict(
                mode=mode, run_s=r["run_s"], frames=r["frames"],
                process_frame_ms=_median(r["ms"]["process_frame"]),
                attend_calls=n_attend, launches=n_flash,
                compositor_launches=r["launches"],
                kernel_vs_plain=r["kernel_vs_plain"]))
    finally:
        layers.attend = real_attend
        layers.set_flash_attention("auto")
        shutil.rmtree(cfg_dir, ignore_errors=True)
    held32 = _flash_held(torch, fl, *last32,
                         "the fp32 CLI's last attention call")
    del last32, seen
    lines.append(
        "[flash-cli-fp32] the fixture CLI with the model in fp32, in turns: "
        + ", ".join(
            f"{r['mode']} {r['run_s']:.1f} s (process_frame median "
            f"{r['process_frame_ms']:.2f} ms, {r['frames']} frames, "
            f"{r['attend_calls']} attend calls, {r['launches']} flash "
            f"launches)" for r in runs32)
        + f" | the kernel vs plain on the last call's own q, k, v "
        f"{held32['shape']} (v "
        f"{'contiguous' if held32['v_contiguous'] else 'strided'}): "
        f"{held32['err']:.3e} (bar {held32['bar']:.3e}), "
        f"{held32['ms']:.4f} ms on the device, call_ms "
        f"{held32['call_ms']:.4f}, SDPA {held32['library_ms']:.4f}, bound "
        f"{held32['bound_ms']:.4f} | {smi}")

    # one tracked frame with the mode on, under the profiler; then bench
    cfgmod.reset_config()
    cfgmod.config["tracking"]["max_iters"] = 0  # random weights
    cfgmod.config["tracking"]["min_match_frac"] = 0.0
    model = init_model(TwoViewConfig(), seed=0, device=device)
    sysm = SLAMSystem(InferenceEngine(model, H, W), H, W)
    base = (rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8)

    def frame(i):
        return create_frame(i, base[i:i + H, 2 * i:2 * i + W], img_size=W,
                            device=device)

    kernels: dict = {}
    layers.set_flash_attention("on")
    seen = {"calls": 0}
    layers.attend = counted
    try:
        for i in range(3):
            sysm.process_frame(frame(i))
        f = frame(3)
        torch.cuda.synchronize()
        seen["calls"] = 0
        fl.launches = 0
        wall, busy, spans = _profile_frame(
            torch, lambda: sysm.process_frame(f), kernels)
        n_prof, prof_calls = fl.launches, seen["calls"]
        assert n_prof == prof_calls > 0, (n_prof, prof_calls)
        seen.pop("last", None)
        layers.attend = real_attend
        fl.launches = 0
        b, b_s, b_cr = _run_entry(bench.main, [], cr, model=model)
        n_bench = fl.launches
        assert n_bench > 0 and b["metric"] == "tracking_fps_512x384", b
    finally:
        layers.attend = real_attend
        layers.set_flash_attention("auto")
        cfgmod.reset_config()
    flash_dev = sum(v for k, v in kernels.items() if "flash_fwd" in k)
    lines.append(
        f"[flash-profile] one tracked frame with the mode on: wall "
        f"{wall:.2f} ms, device kernels {busy:.2f} ms (idle "
        f"{max(0.0, 1 - busy / wall):.1%}), of which the flash kernel "
        f"{flash_dev:.3f} ms over {n_prof} launches (= attend calls) | "
        + ", ".join(f"{k} {hm:.2f} ms open / {d:.2f} ms on the device"
                    for k, (hm, d) in sorted(spans.items(),
                                             key=lambda kv: -kv[1][0])))
    lines.append(
        f"[flash-bench] bench with the mode on: {b['metric']} "
        f"{b['value']:.3f} frames/s (passes "
        + ", ".join(f"{x:.3f}" for x in b["passes"])
        + f"), {n_bench} flash launches, compositor {b_cr} | {b['device']}, "
        f"{b['power_limit_w']} W | {b_s:.1f} s (times only, no claim)")
    del model, sysm
    gc.collect()
    torch.cuda.empty_cache()

    res.update(
        shapes=shapes, scales=scales, auto=picked, cli=runs, cli_held=held,
        cli_fp32=runs32, cli_fp32_held=held32,
        profile=dict(wall_ms=wall, device_ms=busy, spans=spans,
                     flash_device_ms=flash_dev, launches=n_prof),
        bench=dict(b, seconds=b_s, launches=n_bench, compositor=b_cr),
        launches=dict(cli=sum(r["launches"] for r in runs),
                      cli_fp32=sum(r["launches"] for r in runs32),
                      profile=n_prof, bench=n_bench),
        compositor_launches=sum(r["compositor_launches"]
                                for r in runs + runs32),
        kernel_vs_plain=max(r["kernel_vs_plain"] for r in runs + runs32),
        max_abs_err=max([h["err"] for h in shapes.values()
                         if not fl.wide_head_dim(h["shape"][4])]
                        + [h["err"] for h in scales.values()]
                        + [held["err"], held32["err"]]),
        wide_max_abs_err=max(h["err"] for h in shapes.values()
                             if fl.wide_head_dim(h["shape"][4])),
        seconds=time.perf_counter() - t_phase)
    lines.append(
        f"[flash] {res['seconds']:.1f} s | flash launches on the main paths "
        f"{sum(res['launches'].values())} ({res['launches']}), compositor "
        f"launches {res['compositor_launches']} (CLI renders, bf16 and "
        f"fp32)")
    return lines, res


# -- 7c. flash-route: attend routed as the JAX package routes it ------------

# head dims the TPU kernel refuses (128 or more, no multiple of 128), at
# auto's threshold (B1 N4096 H2) so that either mode would pick the kernel
# by the shape alone; the wide kernels' head dim beside them
FLASH_ROUTE_REFUSED = (192, 320)
FLASH_ROUTE_WIDE = 384
FLASH_ROUTE_N, FLASH_ROUTE_H = 4096, 2
# under autograd with "on": B1 n_q 256 n_kv 512 H4 at the wide head dim
FLASH_ROUTE_GRAD = (1, 256, 512, 4)


def _flash_route_phase(torch, fl, layers):
    """[flash-route]: `attend` on the card, routed as the JAX package's
    `_attend` routes the same shapes → (line, results). With "on" and with
    "auto" at B1 N4096 H2 and Dh 192 and 320, which the TPU kernel refuses:
    no launch, and the output SDPA's bit for bit; at Dh 384 one launch of
    the wide forward in each mode, held against the plain version; then
    with "on" under autograd at Dh 384 one launch of the wide forward and
    one of the wide backward pair, the output and gradients held against
    the plain versions on the kernel forward's own residuals. The counts
    are set to 0 just before each call and read just after it; the launches
    that hold a kernel against its plain version come after and are not
    counted."""
    import numpy as np

    assert layers.flash_attention_mode() == "auto"
    rng = np.random.default_rng(15)
    t0 = time.perf_counter()
    n, nh = FLASH_ROUTE_N, FLASH_ROUTE_H
    calls, fwd_errs, grad_abs = {}, [], {}

    def counts():
        return (fl.launches, fl.wide_launches, fl.bwd_launches,
                fl.wide_bwd_launches)

    def zero():
        fl.launches = fl.wide_launches = 0
        fl.bwd_launches = fl.wide_bwd_launches = 0

    try:
        for d in (*FLASH_ROUTE_REFUSED, FLASH_ROUTE_WIDE):
            q, k, v, _ = _flash_bwd_inputs(torch, rng, 1, n, n, nh, d,
                                           torch.bfloat16, False)
            for mode in ("on", "auto"):
                layers.set_flash_attention(mode)
                zero()
                got = layers.attend(q, k, v, d ** -0.5)
                torch.cuda.synchronize()
                c = counts()
                layers.set_flash_attention("auto")
                if d in FLASH_ROUTE_REFUSED:
                    assert c == (0, 0, 0, 0), f"Dh {d} {mode}: launches {c}"
                    same = torch.equal(got, layers.attend_sdpa(
                        q, k, v, d ** -0.5))
                    assert same, f"Dh {d} {mode}: not SDPA's output"
                    calls[f"dh{d} {mode}"] = dict(launches=c[0], sdpa=same)
                else:
                    assert c == (1, 1, 0, 0), f"Dh {d} {mode}: launches {c}"
                    want = fl.flash_attention_torch(q, k, v, d ** -0.5)
                    err = float((got.float() - want.float()).abs().max())
                    bar = FLASH_BF16_BAR * float(want.float().abs().max())
                    assert err <= bar, f"Dh {d} {mode}: {err} > {bar}"
                    fwd_errs.append(err)
                    calls[f"dh{d} {mode}"] = dict(launches=c[0], err=err,
                                                  bar=bar)
            del q, k, v
        # under autograd with "on": the wide forward, then the wide pair
        B, nq, nk, nh_g = FLASH_ROUTE_GRAD
        d, scale = FLASH_ROUTE_WIDE, FLASH_ROUTE_WIDE ** -0.5
        q, k, v, do = _flash_bwd_inputs(torch, rng, B, nq, nk, nh_g, d,
                                        torch.bfloat16, False)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        layers.set_flash_attention("on")
        zero()
        out = layers.attend(lq, lk, lv, scale)
        grads = torch.autograd.grad(out, (lq, lk, lv), do)
        torch.cuda.synchronize()
        grad_counts = counts()
        layers.set_flash_attention("auto")
        assert grad_counts == (1, 1, 1, 1), \
            f"Dh {d} under autograd: launches {grad_counts}"
        o, l, m = fl.flash_attention(q, k, v, scale, residuals=True)
        assert torch.equal(o, out.detach()), "the forward moved"
        want = fl.flash_attention_bwd_torch(q, k, v, o, l, m, do, scale)
        torch.cuda.synchronize()
        rel = {}
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            rel[name] = float((g.float() - w.float()).abs().max()
                              / w.float().abs().max())
            assert rel[name] <= FLASH_BWD_BF16_BAR, (name, rel[name])
            grad_abs[name] = float((g.float() - w.float()).abs().max())
        del q, k, v, do, lq, lk, lv, out, grads, o, l, m, want
    finally:
        layers.set_flash_attention("auto")
        zero()
    res = dict(calls=calls, grad=dict(launches=grad_counts, rel=rel),
               fwd_launches=sum(x["launches"] for x in calls.values())
               + grad_counts[1],
               bwd_launches=grad_counts[3], fwd_max_abs_err=max(fwd_errs),
               grad_abs=grad_abs,
               seconds=time.perf_counter() - t0)
    line = (
        "[flash-route] attend as the JAX package routes it, bf16: "
        + ", ".join(
            f"{key} {x['launches']} launch"
            + (" (SDPA's output bit for bit)" if "sdpa" in x else
               f" (vs plain {x['err']:.2e}, bar {x['bar']:.2e})")
            for key, x in calls.items())
        + f" at B1 N{n} H{nh} | on under autograd at Dh "
        f"{FLASH_ROUTE_WIDE} B{B} Nq{nq} Nkv{nk} H{nh_g}: forward "
        f"{grad_counts[0]} launch (wide {grad_counts[1]}), backward pairs "
        f"{grad_counts[2]} (wide {grad_counts[3]}); gradients vs plain dq "
        f"{rel['dq']:.2e}, dk {rel['dk']:.2e}, dv {rel['dv']:.2e} of each "
        f"peak (bar {FLASH_BWD_BF16_BAR:.2e}) | {res['seconds']:.1f} s")
    return line, res


# -- 7d. full-finetune training with the mode on ------------------------------

# the backward kernels (and the forward's residuals) at the forward's shapes
# and at every other head dim the kernels are built for, bf16 and fp32:
# (label, B, n_q, n_kv, H, Dh, dtype, v strided as the fused qkv hands it)
FLASH_BWD_SHAPES = (
    FLASH_SHAPES + FLASH_STEP_SHAPES + FLASH_FP32_SHAPES[:2]
    + tuple((f"bf16_dh{d} B1 Nq256 Nkv512 H4", 1, 256, 512, 4, d,
             "bfloat16", d == 128) for d in (128, 256))
    + FLASH_FP32_SHAPES[2:] + FLASH_WIDE_SHAPES
    # the fp32 wide pair's passes of clusters
    + FLASH_WIDE_PASS_SHAPES[1:])
# the kernels against the plain backward, each gradient's largest error over
# its peak: two bf16 steps in bf16 (both round p, ds and the gradients to
# bf16, with fp32 sums in another order: at most 0.52 of it on an H100);
# in fp32 the kernels' split-TF32 products (three TF32 products summed in
# fp32, each operand's split within 2^-22 of it) and sums in another order
# (the FMA kernels before them: at most 1.23e-6 there)
FLASH_BWD_BF16_BAR = 2 ** -7
FLASH_BWD_FP32_BAR = 1e-5
# the forward's residuals against the plain version's: l relative, m over
# its largest value (fp32 sums in another order: at most 2.4e-6 and 6.2e-7
# on an H100)
FLASH_RES_BAR = 1e-5
FLASH_TRAIN_HW = (384, 512)  # 768 tokens: the serving shape, which "on" takes
FLASH_TRAIN_STEPS = 3
FLASH_TRAIN_TURNS = ("on", "auto", "auto", "on")
# a step with "on" against a step with "auto" (SDPA) on the same weights and
# batch, relative to the "auto" step's. bf16 model, render-loss recipe: the
# bf16 trunk rounds the two attentions' outputs differently, 36 random
# blocks carry the difference to the predictions and the capped tile lists
# of the render reorder (loss 1.45e-2, gradient norm 1.49e-2 on an H100,
# "on" against "on" 0); fp32 model, Regr3D alone: fp32 rounding only
# (5.9e-6 and 6.3e-6 there)
FLASH_TRAIN_LOSS_RTOL = 5e-2
FLASH_TRAIN_GNORM_RTOL = 5e-2
FLASH_TRAIN_FP32_LOSS_RTOL = 1e-4
FLASH_TRAIN_FP32_GNORM_RTOL = 1e-4


def _flash_bwd_bound_ms(B, n_q, n_kv, H, D, itemsize, dkv):
    """Least time for one backward kernel: the larger of its products'
    operations (dK/dV: S, dV, dP, dK, 8·B·H·n_q·n_kv·Dh; dQ: S, dP, dQ,
    6·B·H·n_q·n_kv·Dh) over the card's peak for the inputs' type and the
    bytes of q, k, v, do, m, l and di read once and its gradients written
    once over the memory rate → (ms, what bounds it). In fp32 the products
    take the faster of two routes that keep fp32's accuracy: the fp32 pipes
    (PEAK_FP32) or the tensor cores in split TF32, three TF32 products for
    each (PEAK_TF32 / 3)."""
    ops = (8 if dkv else 6) * B * H * n_q * n_kv * D
    t_ops = ops / PEAK_BF16 if itemsize == 2 else min(
        ops / PEAK_FP32, 3 * ops / PEAK_TF32)
    n_out = 2 * n_kv if dkv else n_q
    t_bytes = (itemsize * B * H * D * (2 * n_q + 2 * n_kv + n_out)
               + 3 * 4 * B * H * n_q) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _flash_bwd_inputs(torch, rng, B, nq, nk, nh, D, dtype, strided):
    """Seeded unit-normal (q, k, v, do) of one attention shape on the card;
    with `strided`, v is the strided view Attention hands over (its fused
    qkv projection, row stride 3·H·Dh) and k a contiguous copy (rope gives
    new q and k)."""
    import numpy as np

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dtype)

    if strided:
        qkv = rand(B, nk, 3 * nh * D)
        _, k, v = qkv.reshape(B, nk, 3, nh, D).unbind(2)
        k = k.contiguous()
        assert v.stride(1) == 3 * nh * D, v.stride()
        q = rand(B, nq, nh, D)
    else:
        q, k, v = (rand(B, n, nh, D) for n in (nq, nk, nk))
    return q, k, v, rand(B, nq, nh, D)


def _ptxas_kernels(log):
    """[(mangled kernel name, registers, spill store bytes, spill load
    bytes)] of every entry function of a `ptxas -v` log."""
    out, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "spill stores" in ln:
            spill = tuple(int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", ln))
        elif name and "Used" in ln and "registers" in ln:
            out.append((name, int(ln.split("Used")[1].split("registers")[0]),
                        *spill))
            name = None
    return out


def _ptxas_kernel(log, key):
    """(registers, spill store bytes, spill load bytes) of the one kernel of
    `log` whose mangled name holds `key` (e.g. `flash_fwd_bf16ILi64EE`,
    `flash_bwd_wide_f32ILb1EE`)."""
    (r,) = [tuple(r) for k, *r in _ptxas_kernels(log) if key in k]
    return r


def _flash_bwd_plans(torch, so, log):
    """plan(dkv, dtype, B, n_q, n_kv, H, D) → how the bf16 or fp32 (dtype
    "bfloat16" or "float32") dK/dV (dkv) or dQ kernel of the library `so`
    runs at that shape: the blocks it launches, its blocks an SM (the
    occupancy API), its cluster's blocks (1 without one) and the clusters
    resident at once (cudaOccupancyMaxActiveClusters, 0 without), the waves
    (over the card's SMs, or over the resident clusters), its registers and
    spill bytes (from the library's ptxas log `log`)."""
    fn = ctypes.CDLL(str(so)).flash_attention_bwd_plan
    fn.argtypes = FLASH_PLAN_ARGTYPES["flash_attention_bwd_plan"]
    fn.restype = ctypes.c_int
    from splatt3r_slam_tpu_torch.models.flash_attention import wide_head_dim

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plan(dkv, dtype, B, n_q, n_kv, H, D):
        out = (ctypes.c_int * 4)()
        fp32 = dtype == "float32"
        assert fn(int(dkv), int(fp32), D, B, H, n_q, n_kv, out) == 0
        kind = "f32" if fp32 else "bf16"
        key = (f"flash_bwd_wide_{kind}ILb{int(dkv)}EE" if wide_head_dim(D)
               else f"flash_bwd_{kind}ILi{D}ELb{int(dkv)}EE")
        regs, spill_st, spill_ld = _ptxas_kernel(log, key)
        blocks, per_sm, cluster, clusters = out
        assert per_sm > 0 and clusters >= 0, list(out)
        return dict(blocks=blocks, blocks_per_sm=per_sm, cluster=cluster,
                    max_active_clusters=clusters, registers=regs,
                    spill_stores=spill_st, spill_loads=spill_ld,
                    waves=(blocks / cluster / clusters if clusters
                           else blocks / (sms * per_sm)), sms=sms)

    return plan


def _is_dkv_kernel(name):
    """Whether a profiler kernel name (mangled or not) is the bf16 dK/dV
    kernel rather than the dQ one."""
    return "Lb1E" in name or ", true>" in name


def _flash_bwd_errors(torch, fl, args, scale, what, twice=False):
    """The backward kernels (`flash_attention_bwd`) against the plain
    backward on args = (q, k, v, o, l, m, do), in their working dtype →
    {dq, dk, dv: largest error over the gradient's peak, abs_dq, abs_dk,
    abs_dv: the largest absolute errors, bar}; with `twice` the kernels run
    again and must give the same bits (`same_bits`)."""
    got = fl.flash_attention_bwd(*args, scale)
    want = fl.flash_attention_bwd_torch(*args, scale)
    torch.cuda.synchronize()
    bar = (FLASH_BWD_BF16_BAR if args[0].dtype == torch.bfloat16
           else FLASH_BWD_FP32_BAR)
    h = {"bar": bar}
    if twice:
        again = fl.flash_attention_bwd(*args, scale)
        torch.cuda.synchronize()
        h["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, again))
        assert h["same_bits"], f"{what}: two runs' gradients differ"
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        assert torch.isfinite(g).all(), f"{what}: {name} not finite"
        err = float((g.float() - w.float()).abs().max())
        h[name] = err / float(w.float().abs().max())
        h[f"abs_{name}"] = err
        assert h[name] <= bar, \
            f"{what}: {name} kernel vs plain {h[name]} of its peak > {bar}"
    return h


FLASH_GRADS = {"dkv": ("dk", "dv"), "dq": ("dq",)}  # each kernel's own


def _flash_bwd_kernel_errs(fl, shapes, held):
    """Each backward kernel's errors from 7d's rows ({label: the
    `_flash_bwd_errors` of a row}) → {"dkv", "dq", "dkv_wide", "dq_wide":
    {abs: its largest absolute error on the seeded rows, over_peak: its
    largest error over a gradient's peak there and, for the template
    kernels, on a training call's tensors (`held`)}}."""
    errs = {}
    for kind, grads in FLASH_GRADS.items():
        for wide in (False, True):
            rows = [h for h in shapes.values()
                    if fl.wide_head_dim(h["shape"][4]) == wide]
            errs[kind + "_wide" * wide] = dict(
                abs=max(h[f"abs_{g}"] for h in rows for g in grads),
                over_peak=max(h[g] for h in rows + [held] * (not wide)
                              for g in grads))
    return errs


def _flash_residuals_held(torch, fl, q, k, v, scale, what):
    """The forward with and without its residuals (the same output), and
    the residuals l and m against the plain version's → (o, l, m, l's
    largest relative error, m's largest error over its peak)."""
    o0 = fl.flash_attention(q, k, v, scale)
    o, l, m = fl.flash_attention(q, k, v, scale, residuals=True)
    _, pl, pm = fl.flash_attention_torch(q, k, v, scale, residuals=True)
    torch.cuda.synchronize()
    assert torch.equal(o0, o), f"{what}: the output moves with residuals"
    l_err = float(((l - pl).abs() / pl).max())
    m_err = float((m - pm).abs().max() / pm.abs().max())
    assert l_err <= FLASH_RES_BAR and m_err <= FLASH_RES_BAR, \
        f"{what}: residuals vs plain l {l_err}, m {m_err}"
    return o, l, m, l_err, m_err


def _flash_bwd_held(torch, fl, q, k, v, do, scale, what):
    """The forward with and without its residuals (the same output), the
    residuals against the plain version's, both backward kernels against
    the plain backward, and their times: each kernel alone on the device
    and one isolated call, the plain backward, SDPA's backward on the same
    inputs (one `torch.autograd.grad` of one SDPA output, its forward
    outside the window) and the bounds → dict."""
    import torch.nn.functional as F

    o, l, m, l_err, m_err = _flash_residuals_held(torch, fl, q, k, v,
                                                  scale, what)
    # the fp32 wide pair sums S and dP across a cluster: run it twice
    h = _flash_bwd_errors(torch, fl, (q, k, v, o, l, m, do), scale, what,
                          twice=(q.dtype == torch.float32
                                 and fl.wide_head_dim(q.shape[3])))
    B, n_q, H, D = q.shape
    n_kv = k.shape[1]
    h.update(shape=[B, n_q, n_kv, H, D], dtype=str(q.dtype)[6:],
             v_contiguous=v.is_contiguous(), l_err=l_err, m_err=m_err)
    do = do.contiguous()
    di = fl._di(o, do)

    def dkv():
        return fl._launch_dkv(q, k, v, do, m, l, di, scale)

    def dq():
        return fl._launch_dq(q, k, v, do, m, l, di, scale)

    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(
        lq.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2),
        scale=scale)
    sdpa_do = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (lq, lk, lv), sdpa_do,
                                   retain_graph=True)

    # an autograd.grad costs the host 0.1-0.3 ms and a ctypes launch with
    # its checks some 0.05: ten times the usual delay keeps the host ahead
    # of 20 calls (with the usual one SDPA's backward read 0.08-0.35 ms at
    # one shape between two calls)
    slow = 10 * SLEEP_CYCLES
    h.update(ms_dkv=device_ms(dkv, torch, sleep_cycles=slow),
             ms_dq=device_ms(dq, torch, sleep_cycles=slow),
             call_ms_dkv=call_ms(dkv, torch), call_ms_dq=call_ms(dq, torch),
             plain_ms=call_ms(lambda: fl.flash_attention_bwd_torch(
                 q, k, v, o, l, m, do, scale), torch, 3),
             library_ms=device_ms(sdpa_bwd, torch, sleep_cycles=slow))
    for name, is_dkv in (("dkv", True), ("dq", False)):
        h[f"bound_ms_{name}"], h[f"bound_by_{name}"] = _flash_bwd_bound_ms(
            B, n_q, n_kv, H, D, q.element_size(), is_dkv)
    return h


def _flash_train_turns(torch, fl, layers, model_cfg, render_loss, batch,
                       modes, per_forward):
    """A full-finetune step's forward and backward (no optimiser update)
    of phase 5's recipe (`render_loss`) or of the Regr3D loss alone, on one
    fresh seeded model and `batch`, once per entry of `modes`
    ("on" or "auto"), in that order → ({turns, loss_diff, gnorm_diff,
    repeat, bars}, the last "on" backward call's (q, k, v, o, l, m, do,
    scale)). Each "on" turn must launch the forward twice (remat) and the
    backward pair once per attend call, each "auto" turn none."""
    import numpy as np

    from splatt3r_slam_tpu_torch.parallel import TrainConfig, Trainer

    trainer = Trainer(
        model_cfg, TrainConfig(render_loss=render_loss, ssim_weight=0.1,
                               mast3r_loss_weight=1.0, k_max=256,
                               train_gaussian_heads_only=False),
        device="cuda", seed=0)
    kept = {}
    real_bwd = fl.flash_attention_bwd

    def keep(*a):
        kept["args"] = tuple(t.detach() for t in a[:7]) + a[7:]
        return real_bwd(*a)

    turns = []
    try:
        for mode in modes:
            layers.set_flash_attention(mode)
            trainer.optimizer.zero_grad(set_to_none=True)
            fl.flash_attention_bwd = keep if mode == "on" else real_bwd
            fl.launches = fl.bwd_launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ta = time.perf_counter()
            loss, _ = trainer.loss_fn(batch)
            loss.backward()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - ta) * 1e3
            gnorm = float(torch.stack([p.grad.float().norm()
                                       for p in trainer.trainable
                                       if p.grad is not None]).norm())
            turns.append(dict(
                mode=mode, loss=float(loss.detach()), gnorm=gnorm,
                step_ms=step_ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=(fl.launches, fl.bwd_launches)))
    finally:
        fl.flash_attention_bwd = real_bwd
        layers.set_flash_attention("auto")
    del trainer
    for t in turns:
        assert np.isfinite(t["loss"]) and np.isfinite(t["gnorm"]), t
        assert t["launches"] == ((2 * per_forward, per_forward)
                                 if t["mode"] == "on" else (0, 0)), t
    on = [t for t in turns if t["mode"] == "on"]
    auto = [t for t in turns if t["mode"] == "auto"]

    def rel(a, b, key):
        return abs(a[key] - b[key]) / abs(b[key])

    repeat = {}
    if len(on) > 1 and len(auto) > 1:
        repeat = dict(loss_on=rel(on[0], on[1], "loss"),
                      gnorm_on=rel(on[0], on[1], "gnorm"),
                      loss_auto=rel(auto[0], auto[1], "loss"),
                      gnorm_auto=rel(auto[0], auto[1], "gnorm"))
    bf16 = model_cfg.dtype == "bfloat16"
    return dict(
        turns=turns, repeat=repeat, render=render_loss,
        loss_diff=max(rel(a, b, "loss") for a in on for b in auto),
        gnorm_diff=max(rel(a, b, "gnorm") for a in on for b in auto),
        bars=((FLASH_TRAIN_LOSS_RTOL, FLASH_TRAIN_GNORM_RTOL) if bf16 else
              (FLASH_TRAIN_FP32_LOSS_RTOL, FLASH_TRAIN_FP32_GNORM_RTOL)),
    ), kept["args"]


def _flash_train_phase(torch, cr, fl, layers, work):
    """7d. Full-finetune training with the mode on, at full width →
    (lines, results): the backward kernels (and the forward's residuals)
    against their plain versions at every shape and head dim, timed beside
    SDPA's backward and the bounds; `train.main` with the mode on, every
    parameter training, at 384x512 (every attend call of its steps one
    forward launch, two with remat, and one launch of each backward kernel);
    then a step's forward and backward with "on" and with "auto" in turns
    on the same weights and batch, for the bf16 model and for the same
    model in fp32 (loss and gradient norm within their bars, step ms and
    peak memory), and the kernels held on the last attention call's own q,
    k, v, o, l, m and do."""
    import numpy as np

    from splatt3r_slam_tpu_torch import cuda_build
    from splatt3r_slam_tpu_torch import train as train_mod
    from splatt3r_slam_tpu_torch.models import TwoViewConfig
    from splatt3r_slam_tpu_torch.train import synthetic_batches

    assert layers.flash_attention_mode() == "auto"
    lines, res = [], {}
    t_phase = time.perf_counter()
    smi = _smi()
    rng = np.random.default_rng(12)
    plan = _flash_bwd_plans(torch, *cuda_build.build(
        ["flash_attention_bwd_dkv"])["flash_attention_bwd_dkv"])

    shapes = {}
    for label, B, nq, nk, nh, D, dt, strided in FLASH_BWD_SHAPES:
        q, k, v, do = _flash_bwd_inputs(torch, rng, B, nq, nk, nh, D,
                                        getattr(torch, dt), strided)
        shapes[label] = _flash_bwd_held(torch, fl, q, k, v, do, D ** -0.5,
                                        label)
        shapes[label].update(plan_dkv=plan(True, dt, B, nq, nk, nh, D),
                             plan_dq=plan(False, dt, B, nq, nk, nh, D))
        del q, k, v, do
    for label, h in shapes.items():
        grid = " | " + ", ".join(
            f"{name} {g['blocks']} blocks, {g['blocks_per_sm']} an SM, "
            + (f"clusters of {g['cluster']} ({g['max_active_clusters']} "
               "resident), " if g["max_active_clusters"] else "")
            + f"{g['waves']:.2f} waves, {g['registers']} registers, spills "
            f"{g['spill_stores']}/{g['spill_loads']} bytes"
            for name, g in (("dK/dV", h["plan_dkv"]), ("dQ", h["plan_dq"])))
        if "same_bits" in h:
            grid += " | two runs the same bits"
        lines.append(
            f"[flash-train-kernel] {label} ({h['dtype']}, v "
            f"{'contiguous' if h['v_contiguous'] else 'strided'}): kernels "
            f"vs plain dq {h['dq']:.2e}, dk {h['dk']:.2e}, dv {h['dv']:.2e} "
            f"of each peak (bar {h['bar']:.2e}); residuals l {h['l_err']:.1e}"
            f", m {h['m_err']:.1e}, output unchanged | dK/dV {h['ms_dkv']:.4f}"
            f" ms on the device (call_ms {h['call_ms_dkv']:.4f}, bound "
            f"{h['bound_ms_dkv']:.4f} by {h['bound_by_dkv']}), dQ "
            f"{h['ms_dq']:.4f} (call_ms {h['call_ms_dq']:.4f}, bound "
            f"{h['bound_ms_dq']:.4f} by {h['bound_by_dq']}) | plain backward "
            f"{h['plain_ms']:.3f} ms, SDPA backward {h['library_ms']:.4f} ms"
            f"{grid} | {smi}")
    gc.collect()
    torch.cuda.empty_cache()

    # attend calls of one training forward: the encoder's blocks once per
    # view and, per decoder block, each view's self and cross attention
    mcfg = TwoViewConfig()
    per_forward = 2 * mcfg.enc_depth + 2 * 2 * mcfg.dec_depth
    th, tw = FLASH_TRAIN_HW

    # train.main, the mode on, every parameter training
    seen = {"step_ms": [], "losses": []}
    real_build = train_mod.build_trainer

    def build(cfg, args, devices=0):
        trainer, model_cfg = real_build(cfg, args, devices)
        seen["remat"] = model_cfg.remat
        seen["params"] = (sum(p.numel() for p in trainer.trainable),
                          sum(p.numel() for p in trainer.model.parameters()))
        real_make = trainer.make_train_step

        def make():
            step = real_make()

            def timed(batch):
                torch.cuda.synchronize()
                if len(seen["losses"]) == FLASH_TRAIN_STEPS - 1:
                    # the last step under torch.profiler
                    got = {}
                    wall, busy, kern = _profile_kernels(
                        torch, lambda: got.update(m=step(batch)))
                    seen["profile"] = dict(wall_ms=wall, device_ms=busy,
                                           kernels=kern)
                    m = got["m"]
                else:
                    ta = time.perf_counter()
                    m = step(batch)
                    torch.cuda.synchronize()
                    seen["step_ms"].append((time.perf_counter() - ta) * 1e3)
                seen["losses"].append(float(m["loss"]))
                return m

            return timed

        trainer.make_train_step = make
        return trainer, model_cfg

    out_dir = os.path.join(work, "train_main")
    train_mod.build_trainer = build
    layers.set_flash_attention("on")
    torch.cuda.reset_peak_memory_stats()
    fl.launches = fl.bwd_launches = 0
    fl.wide_launches = fl.wide_bwd_launches = 0
    cr.launches = cr.bwd_launches = 0
    t_main = time.perf_counter()
    try:
        rc = train_mod.main([
            "--steps", str(FLASH_TRAIN_STEPS), "--res", str(th), str(tw),
            "--set", "train.render_loss=true", "train.ssim_weight=0.1",
            "train.mast3r_loss_weight=1.0", "train.k_max=256",
            "train.train_gaussian_heads_only=false", "--out", out_dir,
            "--name", "flash_train"])
    finally:
        train_mod.build_trainer = real_build
        layers.set_flash_attention("auto")
    main_s = time.perf_counter() - t_main
    main_launches = (fl.launches, fl.bwd_launches)
    main_wide = (fl.wide_launches, fl.wide_bwd_launches)  # of main_launches
    main_comp = (cr.launches, cr.bwd_launches)
    main_peak = torch.cuda.max_memory_allocated() / 2**30
    calls = FLASH_TRAIN_STEPS * per_forward
    assert rc == 0, rc
    assert seen["remat"], "the train CLI's model is not rematerialised"
    assert seen["params"][0] == seen["params"][1], \
        f"{seen['params']}: not every parameter trains"
    assert main_launches == (2 * calls, calls), \
        f"{main_launches} flash launches (forward, backward pairs) for " \
        f"{calls} attend calls with remat"
    assert main_comp == (FLASH_TRAIN_STEPS, FLASH_TRAIN_STEPS), main_comp
    assert all(np.isfinite(v) for v in seen["losses"]), seen["losses"]
    (ws,) = os.listdir(out_dir)
    assert os.path.exists(os.path.join(out_dir, ws, "params_final.npz"))
    prof = seen["profile"]
    pair = {}
    for name, (ms, n) in prof["kernels"].items():
        if "flash_bwd_bf16" in name:
            which = "dkv" if _is_dkv_kernel(name) else "dq"
            got_ms, got_n = pair.get(which, (0.0, 0))
            pair[which] = (got_ms + ms, got_n + n)
    fwd = [v for name, v in prof["kernels"].items()
           if "flash_fwd_bf16" in name]
    prof.update(pair_ms=pair["dkv"][0] + pair["dq"][0],
                dkv=pair["dkv"], dq=pair["dq"],
                fwd=(sum(x for x, _ in fwd), sum(n for _, n in fwd)),
                idle=max(0.0, 1 - prof["device_ms"] / prof["wall_ms"]))
    assert pair["dkv"][1] == pair["dq"][1] == per_forward, pair
    assert prof["fwd"][1] == 2 * per_forward, prof["fwd"]
    lines.append(
        f"[flash-train-main] train.main with the mode on, "
        f"train.train_gaussian_heads_only=false ({seen['params'][0]:,} of "
        f"{seen['params'][1]:,} parameters training, remat on) | "
        f"{FLASH_TRAIN_STEPS} steps {th}x{tw} B=1 V=1 ViT-L bf16, render "
        f"loss | step ms " + ", ".join(f"{x:.1f}" for x in seen["step_ms"])
        + f" (step {FLASH_TRAIN_STEPS} under the profiler: "
        f"{prof['wall_ms']:.1f}) | loss "
        + ", ".join(f"{x:.4f}" for x in seen["losses"])
        + f" | peak memory {main_peak:.2f} GiB | flash launches: forward "
        f"{main_launches[0]} = 2 x {calls} attend calls (remat), backward "
        f"pairs {main_launches[1]} = {calls} (dK/dV and dQ each "
        f"{main_launches[1]}), of them on the wide kernels: forward "
        f"{main_wide[0]}, backward pairs {main_wide[1]} | compositor "
        f"{main_comp[0]} / {main_comp[1]} "
        f"| {main_s:.1f} s in all | {smi}")
    lines.append(
        f"[flash-train-profile] train.main's step {FLASH_TRAIN_STEPS} with "
        f"the mode on under torch.profiler: wall {prof['wall_ms']:.1f} ms, "
        f"device kernels {prof['device_ms']:.1f} ms (idle "
        f"{prof['idle']:.1%}) | dK/dV {prof['dkv'][0]:.3f} ms in "
        f"{prof['dkv'][1]} launches, dQ {prof['dq'][0]:.3f} ms in "
        f"{prof['dq'][1]} launches: the pair {prof['pair_ms']:.3f} ms, "
        f"{prof['pair_ms'] / prof['device_ms']:.1%} of the device time | "
        f"flash forward {prof['fwd'][0]:.3f} ms in {prof['fwd'][1]} launches"
        f" | {smi}")
    res["train_profile"] = {k: v for k, v in prof.items()
                            if k != "kernels"}
    res["train_main"] = dict(step_ms=seen["step_ms"], losses=seen["losses"],
                             peak_gib=main_peak, launches=main_launches,
                             wide_launches=main_wide, compositor=main_comp,
                             s=main_s, params=seen["params"],
                             attend_calls=calls)
    gc.collect()
    torch.cuda.empty_cache()

    # a step's forward and backward with "on" and with "auto" in turns, on
    # the same weights and batch (no optimiser update): the bf16 model and
    # recipe of train.main; then the same model in fp32 on the Regr3D loss
    # alone, where the two attentions differ by fp32 rounding only and no
    # capped tile list of the render can reorder
    batch = next(synthetic_batches(1, 1, th, tw, True, seed=0))
    compare, held = {}, None
    for dtype, render, turn_modes in (
            ("bfloat16", True, FLASH_TRAIN_TURNS),
            ("float32", False, ("on", "auto"))):
        c, kept = _flash_train_turns(
            torch, fl, layers, TwoViewConfig(remat=True, dtype=dtype,
                                             head_dtype=dtype),
            render, batch, turn_modes, per_forward)
        compare[dtype] = c
        if dtype == "bfloat16":  # the kernels on a training call's tensors
            (q, k, v, o, l, m, do), scale = kept[:7], kept[7]
            held = _flash_bwd_errors(torch, fl, (q, k, v, o, l, m, do),
                                     scale, "the step's last attention call")
            held["shape"] = [q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                             q.shape[3]]
            held["v_contiguous"] = v.is_contiguous()
            del q, k, v, o, l, m, do
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    for dtype, c in compare.items():
        lines.append(
            f"[flash-train-compare] {dtype} model, "
            f"{'the render-loss recipe' if c['render'] else 'Regr3D alone'}"
            ", a step's forward and backward on the same weights and batch, "
            "in turns: "
            + ", ".join(
                f"{t['mode']} {t['step_ms']:.1f} ms (loss {t['loss']:.6f}, "
                f"gradient norm {t['gnorm']:.6e}, peak {t['peak_gib']:.2f} "
                f"GiB, flash launches {t['launches'][0]} / backward pairs "
                f"{t['launches'][1]})" for t in c["turns"])
            + f" | on vs auto: loss {c['loss_diff']:.2e}, gradient norm "
            f"{c['gnorm_diff']:.2e} (bars {c['bars'][0]:g}, "
            f"{c['bars'][1]:g})"
            + ("" if "loss_on" not in c["repeat"] else
               f"; on vs on {c['repeat']['loss_on']:.1e} / "
               f"{c['repeat']['gnorm_on']:.1e}, auto vs auto "
               f"{c['repeat']['loss_auto']:.1e} / "
               f"{c['repeat']['gnorm_auto']:.1e}")
            + ("" if dtype != "bfloat16" else
               f" | the kernels vs plain on the last call's own q, k, v, o, "
               f"l, m, do {held['shape']} (v "
               f"{'contiguous' if held['v_contiguous'] else 'strided'}): dq "
               f"{held['dq']:.2e}, dk {held['dk']:.2e}, dv {held['dv']:.2e} "
               f"of each peak (bar {held['bar']:.2e})") + f" | {smi}")
    for dtype, c in compare.items():
        assert c["loss_diff"] <= c["bars"][0] and \
            c["gnorm_diff"] <= c["bars"][1], \
            f"{dtype}: on vs auto beyond the bars: {lines[-2:]}"
    turns = [dict(t, dtype=d) for d, c in compare.items() for t in c["turns"]]
    loss_diff = compare["bfloat16"]["loss_diff"]
    gnorm_diff = compare["bfloat16"]["gnorm_diff"]
    repeat = compare["bfloat16"]["repeat"]
    res.update(shapes=shapes, turns=turns, loss_diff=loss_diff,
               gnorm_diff=gnorm_diff, repeat=repeat, held=held,
               compare={d: {k: v for k, v in c.items() if k != "turns"}
                        for d, c in compare.items()},
               compare_launches=tuple(sum(t["launches"][i] for t in turns)
                                      for i in (0, 1)),
               errs=_flash_bwd_kernel_errs(fl, shapes, held),
               seconds=time.perf_counter() - t_phase)
    lines.append(
        f"[flash-train] {res['seconds']:.1f} s | flash launches on the main "
        f"path (train.main): forward {main_launches[0]}, dK/dV "
        f"{main_launches[1]}, dQ {main_launches[1]}; in the comparison "
        f"steps: forward {res['compare_launches'][0]}, each backward kernel "
        f"{res['compare_launches'][1]}")
    return lines, res


# -- 7e. the TUM evaluation script --------------------------------------------

EVAL_TUM_TIMEOUT = 600  # seconds of the evaluation's process


def _eval_tum_phase(root, work):
    """7e. The port's TUM evaluation (`scripts/eval_tum.py`, the counterpart of
    scripts/eval_tum.sh) as users call it, in a process of its own from
    `work`, on the committed fixture at full width: TwoViewConfig() with
    seeded random weights (the CLI's `--seed 0`; EXTRA_ARGS without
    --require-checkpoint), eval_fixture.yaml → (line, results). Its CLI run
    and its ATE are processes of their own; checked: exit 0, one finite
    ATE line, trajectory rows of 8 columns whose stamps lie within 0.02 s
    of the groundtruth's, the PLY, the keyframe and the render PNGs."""
    import numpy as np

    from splatt3r_slam_tpu_torch.runtime.evaluate import load_ply

    fixture = os.path.join(root, "tests", "fixtures", "tum")
    seq = "rgbd_dataset_freiburg1_fixture"
    env = {k: v for k, v in os.environ.items()
           if k not in ("GT_ROOT", "SEQS_OVERRIDE", "EXTRA_ARGS")}
    env.update(DATASET_ROOT=fixture, SEQS_OVERRIDE=seq, SAVE_AS="eval_tum",
               CONFIG=os.path.join(fixture, "eval_fixture.yaml"),
               EXTRA_ARGS="--seed 0", PYTHONPATH=os.pathsep.join(
                   p for p in (root, env.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "splatt3r_slam_tpu_torch.scripts.eval_tum",
         "--device", "cuda"], cwd=work, env=env, capture_output=True,
        text=True, timeout=EVAL_TUM_TIMEOUT)
    seconds = time.perf_counter() - t0
    assert r.returncode == 0, \
        f"eval_tum exit {r.returncode}:\n{r.stdout[-3000:]}\n" \
        f"{r.stderr[-3000:]}"
    ates = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{") and "ate_rmse" in ln]
    assert len(ates) == 1 and np.isfinite(ates[0]["ate_rmse"]), \
        r.stdout[-2000:]
    out = os.path.join(work, "logs", "eval_tum")
    rows = np.atleast_2d(np.loadtxt(os.path.join(out, f"{seq}.txt"),
                                    comments="#"))
    assert rows.shape[1] == 8 and rows.shape[0] >= 3, rows.shape
    gt_ts = np.loadtxt(os.path.join(fixture, seq, "groundtruth.txt"),
                       comments="#")[:, 0]
    gap = max(float(np.min(np.abs(gt_ts - t))) for t in rows[:, 0])
    assert gap < 0.02, f"a stamp {gap} s from the groundtruth's"
    pts, _ = load_ply(os.path.join(out, f"{seq}.ply"))
    kf = len(os.listdir(os.path.join(out, f"{seq}_keyframes")))
    renders = len(os.listdir(os.path.join(out, f"{seq}_renders")))
    assert len(pts) > 0 and kf == rows.shape[0] and renders > 0, \
        (len(pts), kf, renders)
    done = [ln for ln in r.stdout.splitlines() if ln.startswith("done:")]
    res = dict(seconds=seconds, ate_rmse=ates[0]["ate_rmse"],
               rows=int(rows.shape[0]), stamp_gap=gap, ply=len(pts),
               keyframe_pngs=kf, render_pngs=renders, done=done)
    line = (f"[eval-tum] python -m splatt3r_slam_tpu_torch.scripts.eval_tum "
            f"--device cuda on the fixture at full width (TwoViewConfig(), "
            f"seeded random weights): exit 0 in {seconds:.1f} s | "
            f"{' '.join(done)} | ATE {ates[0]['ate_rmse']:.4f} m (random "
            f"weights, not held) | trajectory {rows.shape[0]} rows of 8 "
            f"columns, stamps within {gap:.4f} s of the groundtruth's | PLY "
            f"{len(pts)} vertices, {kf} keyframe PNGs, {renders} render "
            f"PNGs")
    return line, res


def _parent_library(source, parent, tag="parent", flags=()):
    """Build the file of `source`'s name found in `parent` (an earlier
    commit's, with the same C entry points; or this checkout's, with other
    nvcc `flags`) into a library of its own, `lib{tag}_{stem}.so`, in that
    directory's include path → the library's path."""
    from splatt3r_slam_tpu_torch import cuda_build

    so = cuda_build.BUILD_DIR / f"lib{tag}_{source.stem}.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
                    str(so), os.path.join(parent, source.name)], check=True,
                   capture_output=True, timeout=600)
    return so


def _swap_entries(entries, fn):
    """fn with the wrappers' launches going to `entries` ({registry name:
    C entry point}); the entry points in place when this is called are put
    back after each run."""
    from splatt3r_slam_tpu_torch import cuda_build

    own = {n: cuda_build._fns[n] for n in entries}

    def run():
        cuda_build._fns.update(entries)
        try:
            return fn()
        finally:
            cuda_build._fns.update(own)
    return run


def _in_turns(torch, runs, rounds, **device_ms_kw):
    """{key: (parent's fn, this checkout's fn)} → {key: (parent ms, this
    checkout's ms)}: device_ms of each, in turns, the order flipped every
    round, the median over `rounds`."""
    samples = {key: ([], []) for key in runs}
    for r in range(rounds):
        for key, got in samples.items():
            pair = list(zip(got, runs[key]))
            for into, fn in (pair if r % 2 == 0 else pair[::-1]):
                into.append(device_ms(fn, torch, groups=1, **device_ms_kw))
    return {key: tuple(statistics.median(x) for x in got)
            for key, got in samples.items()}


def _compare_flash_with_parent(torch, fl, parent, rounds=7):
    """Build the flash_attention.cu found in `parent` into a library of its
    own and time its forward in turns with this checkout's at every bf16
    Dh-64 shape, every fp32 shape and every wide row (both dtypes) of 7c →
    {shape: {dtype, D, ms: (parent ms, this checkout's ms), call_ms: (...),
    differ: output elements where the two builds differ, elements, diff:
    their largest difference}},
    each ms the median over `rounds` of a device-only time of 20 launches.
    Two fp32 builds may differ by twice the fp32 bar (each is held within
    it of the plain version)."""
    import numpy as np

    from splatt3r_slam_tpu_torch import cuda_build

    name = "flash_attention"
    old = {name: cuda_build._entry(_parent_library(
        cuda_build.KERNELS[name][0], parent), name)}
    new = {name: cuda_build._fns[name]}  # resolved by phase 7c
    rng = np.random.default_rng(14)
    runs, found = {}, {}
    for label, B, nq, nk, nh, D, dt, strided in (
            FLASH_SHAPES + FLASH_STEP_SHAPES + FLASH_FP32_SHAPES
            + FLASH_WIDE_SHAPES + FLASH_WIDE_PASS_SHAPES):
        if dt == "bfloat16" and D != 64 and not fl.wide_head_dim(D):
            continue
        q, k, v, _ = _flash_bwd_inputs(torch, rng, B, nq, nk, nh, D,
                                       getattr(torch, dt), strided)

        def fwd(q=q, k=k, v=v, scale=D ** -0.5):
            return fl.flash_attention(q, k, v, scale)

        runs[label] = tuple(_swap_entries(e, fwd) for e in (old, new))
        a, b = (fn() for fn in runs[label])
        torch.cuda.synchronize()
        d = (a.float() - b.float()).abs()
        found[label] = dict(dtype=dt, D=D, differ=int((d > 0).sum()),
                            elements=d.numel(), diff=float(d.max()))
        bar = (FLASH_BF16_BAR * float(b.float().abs().max())
               if dt == "bfloat16" else 2 * FLASH_FP32_BAR)
        assert found[label]["diff"] <= bar, (label, found[label])
    for label, ms in _in_turns(torch, runs, rounds).items():
        found[label]["ms"] = ms
        found[label]["call_ms"] = tuple(call_ms(fn, torch)
                                        for fn in runs[label])
    return found


def _compare_flash_bwd_with_parent(torch, fl, parent, rounds=7):
    """Build the flash_attention_bwd.cu found in `parent` (an earlier
    commit's, with the same C entry points) into a library of its own and
    time its dK/dV and dQ kernels in turns with this checkout's at every
    shape of FLASH_BWD_SHAPES, the wide kernels' rows only where the
    parent's source has them (`flash_bwd_wide_f32`) → {shape:
    {dtype, D, dkv: (parent ms, this checkout's ms), dq: (...), diff: the
    largest difference of the two builds' gradients over each gradient's
    peak, differ: the gradient elements where the two builds differ}},
    each ms the median over `rounds` of a device-only time of 20 launches.
    Two fp32 builds may differ by twice the fp32 bar (each is held within
    it of the plain backward)."""
    import numpy as np

    from splatt3r_slam_tpu_torch import cuda_build

    names = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    source = cuda_build.KERNELS[names[0]][0]
    so = _parent_library(source, parent)
    with open(os.path.join(parent, source.name)) as f:
        parent_wide = "flash_bwd_wide_f32" in f.read()
    old = {n: cuda_build._entry(so, n) for n in names}
    new = {n: cuda_build._fns[n] for n in names}  # resolved by phase 7d
    rng = np.random.default_rng(13)
    runs, found = {}, {}
    for label, B, nq, nk, nh, D, dt, strided in FLASH_BWD_SHAPES:
        if fl.wide_head_dim(D) and not parent_wide:
            continue
        q, k, v, do = _flash_bwd_inputs(torch, rng, B, nq, nk, nh, D,
                                        getattr(torch, dt), strided)
        scale = D ** -0.5
        o, l, m = fl.flash_attention(q, k, v, scale, residuals=True)
        di = fl._di(o, do)

        def dkv(q=q, k=k, v=v, do=do, m=m, l=l, di=di, scale=scale):
            return fl._launch_dkv(q, k, v, do, m, l, di, scale)

        def dq(q=q, k=k, v=v, do=do, m=m, l=l, di=di, scale=scale):
            return fl._launch_dq(q, k, v, do, m, l, di, scale)

        for kind, fn in (("dkv", dkv), ("dq", dq)):
            runs[label, kind] = tuple(_swap_entries(e, fn)
                                      for e in (old, new))
        got = [(dq_fn(), *dkv_fn()) for dkv_fn, dq_fn in zip(
            runs[label, "dkv"], runs[label, "dq"])]
        torch.cuda.synchronize()
        found[label] = {"dtype": dt, "D": D, "diff": max(
            float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip(*got)), "differ": sum(
            int((a != b).sum()) for a, b in zip(*got))}
        bar = (FLASH_BWD_BF16_BAR if dt == "bfloat16"
               else 2 * FLASH_BWD_FP32_BAR)
        assert found[label]["diff"] <= bar, (label, found)
    slow = 10 * SLEEP_CYCLES  # a ctypes launch with its checks, as in 7d
    for (label, kind), ms in _in_turns(torch, runs, rounds,
                                       sleep_cycles=slow).items():
        found[label][kind] = ms
    return found


# the template instances' rows of 7c and 7d (Dh 128 with v strided, and
# 256, at B1 256x512 H4, both dtypes), where --wide-from-128 times the wide
# kernels beside them
FLASH_INSTANCE_ROWS = tuple(r for r in FLASH_BWD_SHAPES if r[5] in (128, 256))


def _compare_wide_with_instances(torch, fl, rounds=7):
    """--wide-from-128: build both flash sources of this checkout again
    with -DFLASH_WIDE_FROM=128, where the wide kernels take Dh 128 and 256
    in place of the template instances, hold the wide forward (with its
    residuals) and backward pair there against the plain versions at 7c's
    and 7d's bars, and time the forward, dK/dV and dQ in turns with the
    instances at every FLASH_INSTANCE_ROWS row → {row: {fwd, dkv, dq:
    (instance ms, wide ms), err: the forward's error (bf16: over the
    output's peak), grads: the largest gradient error over its peak}},
    each ms the median over `rounds` of a device-only time of 20
    launches."""
    import numpy as np

    from splatt3r_slam_tpu_torch import cuda_build

    names = ("flash_attention", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    own = {n: cuda_build._fns[n] for n in names}  # resolved by 7c and 7d
    sos = {src: _parent_library(src, src.parent, "wide128",
                                ("-DFLASH_WIDE_FROM=128",))
           for src in {cuda_build.KERNELS[n][0] for n in names}}
    wide = {n: cuda_build._entry(sos[cuda_build.KERNELS[n][0]], n)
            for n in names}
    rng = np.random.default_rng(17)
    runs, found = {}, {}
    for label, B, nq, nk, nh, D, dt, strided in FLASH_INSTANCE_ROWS:
        q, k, v, do = _flash_bwd_inputs(torch, rng, B, nq, nk, nh, D,
                                        getattr(torch, dt), strided)
        scale = D ** -0.5
        o, l, m = fl.flash_attention(q, k, v, scale, residuals=True)
        di = fl._di(o, do)

        def fwd(q=q, k=k, v=v, scale=scale):
            return fl.flash_attention(q, k, v, scale, residuals=True)

        def dkv(q=q, k=k, v=v, do=do, m=m, l=l, di=di, scale=scale):
            return fl._launch_dkv(q, k, v, do, m, l, di, scale)

        def dq(q=q, k=k, v=v, do=do, m=m, l=l, di=di, scale=scale):
            return fl._launch_dq(q, k, v, do, m, l, di, scale)

        for kind, fn in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
            runs[label, kind] = tuple(_swap_entries(e, fn)
                                      for e in (own, wide))
        wo, wl, wm = runs[label, "fwd"][1]()
        wdq, (wdk, wdv) = runs[label, "dq"][1](), runs[label, "dkv"][1]()
        po, pl, pm = fl.flash_attention_torch(q, k, v, scale, residuals=True)
        want = fl.flash_attention_bwd_torch(q, k, v, o, l, m, do, scale)
        torch.cuda.synchronize()
        err = float((wo.float() - po.float()).abs().max())
        if dt == "bfloat16":
            err /= float(po.float().abs().max())
        res_err = max(float(((wl - pl).abs() / pl).max()),
                      float((wm - pm).abs().max() / pm.abs().max()))
        grads = max(float((g.float() - w.float()).abs().max()
                          / w.float().abs().max())
                    for g, w in zip((wdq, wdk, wdv), want))
        bars = ((FLASH_BF16_BAR, FLASH_BWD_BF16_BAR) if dt == "bfloat16"
                else (FLASH_FP32_BAR, FLASH_BWD_FP32_BAR))
        assert err <= bars[0] and res_err <= FLASH_RES_BAR and \
            grads <= bars[1], (label, err, res_err, grads)
        found[label] = dict(err=err, res_err=res_err, grads=grads)
    slow = 10 * SLEEP_CYCLES  # a ctypes launch with its checks, as in 7d
    for (label, kind), ms in _in_turns(torch, runs, rounds,
                                       sleep_cycles=slow).items():
        found[label][kind] = ms
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this path")
    ap.add_argument("--parent", default=None,
                    help="directory with an earlier composite.cu and "
                         "composite_bwd.cu, flash_attention.cu and/or "
                         "flash_attention_bwd.cu to time beside this "
                         "checkout's")
    ap.add_argument("--wide-from-128", action="store_true",
                    help="after 7d, also time the wide flash kernels built "
                         "to take Dh 128 and 256 against the template "
                         "instances there")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch import cuda_build, set_fp32_precision
    from splatt3r_slam_tpu_torch.backend import FactorGraph
    from splatt3r_slam_tpu_torch.lie import sim3
    from splatt3r_slam_tpu_torch.models import TwoViewConfig, init_model
    from splatt3r_slam_tpu_torch.models import flash_attention as fl
    from splatt3r_slam_tpu_torch.models import layers
    from splatt3r_slam_tpu_torch.retrieval import RetrievalDatabase
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
    from splatt3r_slam_tpu_torch.utils import jpeg

    results: dict = {}

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build()  # one nvcc a source, all started together
    build_s = time.perf_counter() - t0
    assert set(built) == {"composite", "composite_bwd", "flash_attention",
                          "flash_attention_bwd_dkv",
                          "flash_attention_bwd_dq"}, sorted(built)
    for source, _, _ in cr.KERNELS.values():
        assert '#include "composite_common.cuh"' in source.read_text(), source
    fl.launches = fl.bwd_launches = 0  # read after every phase (`_no_flash`)
    libraries = dict(built.values())  # the two backward kernels share one
    kernel_list = {so: _ptxas_kernels(log) for so, log in libraries.items()}
    print(f"[build] {build_s:.2f} s | " + " | ".join(
        f"{os.path.relpath(so, root)}: {len(ks)} kernels ("
        f"{sum('IL' in k[0] and '_wide_' not in k[0] for k in ks)} template "
        f"instances, {sum('_wide_' in k[0] for k in ks)} wide): "
        + ", ".join(
            f"{k} {r} registers, spill {st}/{ld} B" for k, r, st, ld in ks)
        for so, ks in kernel_list.items()))
    for so, log in libraries.items():  # every kernel of every library
        spills = [ln for ln in log.splitlines() if "spill stores" in ln]
        assert spills and all("0 bytes spill stores, 0 bytes spill loads"
                               in ln for ln in spills), \
            f"a kernel of {so.name} spills registers"
    results["build_s"] = build_s
    results["ptxas"] = {  # each kernel's entry, registers and spills
        so.name: [ln.strip() for ln in log.splitlines()
                  if "Compiling entry" in ln or "registers" in ln
                  or "spill" in ln] for so, log in libraries.items()}
    t0 = time.perf_counter()
    jpeg_so = jpeg.build_native()  # the host JPEG entropy walk (g++)
    results["build_host_s"] = time.perf_counter() - t0
    print(f"[build-host] {os.path.relpath(jpeg_so, root)} from "
          f"{os.path.relpath(jpeg.SOURCE, root)} (g++ "
          f"{' '.join(jpeg.CXX_FLAGS)}) in {results['build_host_s']:.2f} s")

    # -- 2. kernel against its plain version ----------------------------------
    set_fp32_precision()
    K = torch.tensor([[512.0, 0, W / 2], [0, 512.0, H / 2], [0, 0, 1]],
                     device="cuda")
    view = torch.eye(4, device="cuda")
    means, scales, q, colors, opa = seeded_scene(torch, (H, W), seed=0)
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
    # counts on the chunk and ring boundaries, and a k_max that is no
    # multiple of 4 (its tiles' rows are not 16-byte aligned)
    edges = [_boundary_tiles(torch, [0, 1, 127, 128, 129, 256], 256, seed=5),
             _boundary_tiles(torch, [0, 1, 29, 30, 17, 30], 30, seed=6)]
    edge_err = 0.0
    for cnt, org, rw in edges:
        a = cr.composite(cnt, org, rw, bg)
        b = cr.composite_torch(cnt, org, rw, bg)
        edge_err = max(edge_err, float((a - b).abs().max()))
        assert bool((a[:256] == torch.cat([bg, bg.new_ones(1)])).all()), \
            "an empty tile is not the background"
    assert edge_err <= TOL, f"boundary counts/unaligned k_max {edge_err}"

    ms = device_ms(lambda: cr.composite(counts, origins, rows, bg), torch)
    fwd_call_ms = call_ms(lambda: cr.composite(counts, origins, rows, bg),
                          torch)
    plain_ms = call_ms(
        lambda: cr.composite_torch(counts, origins, rows, bg), torch, 5)
    n_rows = int(counts.sum())
    T = counts.shape[0]
    pairs = n_rows * 256
    bound_ms, bound_by = _bound_ms(counts)
    print(f"[kernel] composite_kernel max_abs_err {err:.3e} (production), "
          f"{extra_err:.3e} (multi-chunk + background), {edge_err:.3e} "
          f"(counts 0/1/127/128/129/k_max, and k_max 30), tol {TOL:g} | "
          f"{ms:.4f} ms on the device (20 launches back to back, median of "
          f"5), call_ms {fwd_call_ms:.4f} (one isolated call, wrapper "
          f"included) vs plain {plain_ms:.3f} ms | "
          f"bound {bound_ms:.4f} ms by {bound_by} ({n_rows} rows, "
          f"{pairs} pairs, mean count {n_rows / T:.1f}, "
          f"{int((counts == 512).sum())}/{T} tiles at the cap)")
    results["kernel"] = dict(max_abs_err=err, extra_err=extra_err,
                             edge_err=edge_err, ms=ms, call_ms=fwd_call_ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, rows=n_rows, tiles=T)

    _no_flash(fl, "kernel")

    # -- 2b. backward kernel against its plain version ------------------------
    def bwd_case(cnt, org, rw, seed):
        """→ (gout, out, kernel grows, plain grows) on a seeded cotangent
        whose transmittance column is non-zero."""
        out = cr.composite(cnt, org, rw, bg)
        gg = torch.Generator(device="cuda").manual_seed(seed)
        gout = torch.randn(out.shape, device="cuda", generator=gg)
        gk = cr.composite_bwd(cnt, org, rw, gout, out)
        torch.cuda.synchronize()
        assert torch.isfinite(gk).all(), "backward kernel output not finite"
        k_max = rw.shape[0] // cnt.shape[0]
        dead = (torch.arange(k_max, device="cuda")[None]
                >= cnt[:, None]).reshape(-1)
        assert not bool(gk[dead].any()), \
            "gradient in rows at or beyond a tile's count"
        # the wrapper hands the kernel uninitialised memory: a second run,
        # launched as the wrapper launches it but into memory filled with
        # NaN, must write every row and give the same bits
        again = torch.full_like(rw, float("nan"))
        cuda_build.launch("composite_bwd", rw.device, cnt.data_ptr(),
                          org.data_ptr(), rw.data_ptr(), gout.data_ptr(),
                          out.data_ptr(), again.data_ptr(), cnt.shape[0],
                          k_max)
        assert torch.equal(gk, again), \
            "two runs of the backward kernel differ, or a row is not written"
        return gout, out, gk, cr.composite_bwd_torch(cnt, org, rw, gout, out)

    gout, out_k, gk, gp = bwd_case(counts, origins, rows, 10)
    bwd_rel, bwd_abs = bwd_errors(gk, gp)
    # the deep rows of capped tiles, where (D - A)/(1 - alpha) cancels most
    deep = ((counts == 512)[:, None]
            & (torch.arange(512, device="cuda") >= 384)[None]).reshape(-1)
    assert bool(deep.any()), "no tile at the cap in the production scene"
    deep_rel = float(((gk - gp)[deep].abs().amax(0)
                      / gp.abs().amax(0).clamp_min(1e-30)).max())
    assert bwd_rel <= BWD_TOL, f"backward kernel vs plain {bwd_rel} (cap)"

    # the training shape: one view's render of two 256x384 pointmap layers
    Kt = torch.tensor([[384.0, 0, TRAIN_HW[1] / 2],
                       [0, 384.0, TRAIN_HW[0] / 2], [0, 0, 1]], device="cuda")
    tm, ts, tq, tc, to = seeded_scene(torch, TRAIN_HW, seed=2)
    t_cnt, t_org, t_rows = cr.pack_rows(
        tm, cov_to_triu(build_covariance(ts, tq)), tc, to, view, Kt,
        TRAIN_HW, tpg_side=4, k_max=256)
    t_gout, t_out, t_gk, t_gp = bwd_case(t_cnt, t_org, t_rows, 11)
    train_rel, train_abs = bwd_errors(t_gk, t_gp)
    assert train_rel <= BWD_TOL, f"backward kernel vs plain {train_rel} " \
        "(training shape)"

    small_rel = small_abs = 0.0
    for i, (cnt, org, rw) in enumerate(small):
        s_gout, _, s_gk, s_gp = bwd_case(cnt, org, rw, 12 + i)
        rel, ab = bwd_errors(s_gk, s_gp)
        small_rel, small_abs = max(small_rel, rel), max(small_abs, ab)
    assert not bool(s_gk.any()), "background-only case has a gradient"
    assert small_rel <= BWD_TOL, f"multi-chunk/background backward {small_rel}"
    edge_rel = edge_abs = 0.0
    for i, (cnt, org, rw) in enumerate(edges):
        _, _, e_gk, e_gp = bwd_case(cnt, org, rw, 20 + i)
        rel, ab = bwd_errors(e_gk, e_gp)
        edge_rel, edge_abs = max(edge_rel, rel), max(edge_abs, ab)
    assert edge_rel <= BWD_TOL, \
        f"boundary counts/unaligned k_max backward {edge_rel}"
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
    auto_rel, _ = bwd_errors(rw_k.grad, rw_a.grad)
    auto_bg = float((bg_k.grad - bg_a.grad).abs().max()
                    / bg_a.grad.abs().max())
    assert auto_rel <= BWD_TOL and auto_bg <= BWD_TOL, \
        f"Composite vs autograd: rows {auto_rel}, bg {auto_bg}"

    def run_bwd():
        return cr.composite_bwd(counts, origins, rows, gout, out_k)

    def run_t_fwd():
        return cr.composite(t_cnt, t_org, t_rows, bg)

    def run_t_bwd():
        return cr.composite_bwd(t_cnt, t_org, t_rows, t_gout, t_out)

    bwd_ms = device_ms(run_bwd, torch)
    bwd_call_ms = call_ms(run_bwd, torch)
    bwd_plain_ms = call_ms(
        lambda: cr.composite_bwd_torch(counts, origins, rows, gout, out_k),
        torch, 3)
    bwd_bound_ms, bwd_bound_by = _bound_bwd_ms(counts)
    t_fwd_ms = device_ms(run_t_fwd, torch)
    t_fwd_call_ms = call_ms(run_t_fwd, torch)
    t_bwd_ms = device_ms(run_t_bwd, torch)
    t_bwd_call_ms = call_ms(run_t_bwd, torch)
    t_bwd_plain_ms = call_ms(
        lambda: cr.composite_bwd_torch(t_cnt, t_org, t_rows, t_gout, t_out),
        torch, 3)
    t_bwd_bound_ms, t_bwd_bound_by = _bound_bwd_ms(t_cnt)
    t_fwd_bound_ms, _ = _bound_ms(t_cnt)
    print(f"[kernel-bwd] composite_bwd_kernel max error / column peak "
          f"{bwd_rel:.3e} (production; {deep_rel:.3e} over rows 384-511 of "
          f"the {int((counts == 512).sum())} capped tiles), {train_rel:.3e} "
          f"(training shape), {small_rel:.3e} (multi-chunk + background), "
          f"{edge_rel:.3e} (counts 0/1/127/128/129/k_max, and k_max 30), "
          f"{auto_rel:.3e} rows / {auto_bg:.3e} bg (Composite vs autograd "
          f"through composite_torch), tol {BWD_TOL:g}; rows at and beyond "
          f"each count exactly 0 and two runs bit-identical in every case | "
          f"at the cap {bwd_ms:.4f} ms on the device, call_ms "
          f"{bwd_call_ms:.4f} vs plain {bwd_plain_ms:.3f} ms, "
          f"bound {bwd_bound_ms:.4f} ms by {bwd_bound_by} | training shape "
          f"({int(t_cnt.sum())} rows, mean count "
          f"{float(t_cnt.float().mean()):.1f}, "
          f"{int((t_cnt == 256).sum())}/{t_cnt.shape[0]} tiles at the cap) "
          f"{t_bwd_ms:.4f} ms on the device, call_ms {t_bwd_call_ms:.4f} vs "
          f"plain {t_bwd_plain_ms:.3f} ms, bound {t_bwd_bound_ms:.4f} ms by "
          f"{t_bwd_bound_by}; forward there {t_fwd_ms:.4f} ms on the device, "
          f"call_ms {t_fwd_call_ms:.4f}, bound {t_fwd_bound_ms:.4f} ms")
    results["kernel_bwd"] = dict(
        rel_err=bwd_rel, abs_err=bwd_abs, deep_rel_err=deep_rel,
        train_rel_err=train_rel, train_abs_err=train_abs,
        small_rel_err=small_rel, edge_rel_err=edge_rel,
        autograd_rel_err=auto_rel, autograd_bg_rel_err=auto_bg, ms=bwd_ms,
        call_ms=bwd_call_ms, plain_ms=bwd_plain_ms,
        bound_ms=bwd_bound_ms, bound_by=bwd_bound_by,
        train_shape=dict(rows=int(t_cnt.sum()), tiles=t_cnt.shape[0],
                         ms=t_bwd_ms, call_ms=t_bwd_call_ms,
                         plain_ms=t_bwd_plain_ms,
                         bound_ms=t_bwd_bound_ms, bound_by=t_bwd_bound_by,
                         fwd_ms=t_fwd_ms, fwd_call_ms=t_fwd_call_ms,
                         fwd_bound_ms=t_fwd_bound_ms))
    if args.parent and all(
            os.path.exists(os.path.join(args.parent, source.name))
            for source, _, _ in cr.KERNELS.values()):
        found = _compare_with_parent(
            torch, cr, args.parent,
            {"cap": (counts, origins, rows, gout, out_k),
             "training shape": (t_cnt, t_org, t_rows, t_gout, t_out)}, bg)
        print("[compare] device ms, the sources in --parent → this "
              "checkout's, in turns, median of 7 rounds of 20 launches | "
              + " | ".join(
                  f"{name} {shape}: {a:.4f} → {b:.4f}"
                  for name, by_shape in found.items()
                  for shape, (a, b) in by_shape.items())
              + " (the earlier backward with the memset it needs)")
        results["compare"] = found
    del gk, gp, t_gk, t_gp, gout, out_k, t_gout, t_out

    _no_flash(fl, "kernel-bwd")

    # -- 3. the main path at full width ---------------------------------------
    cfgmod.reset_config()  # config/base.yaml defaults
    # random weights: a GN step always fails (see the module docstring)
    cfgmod.config["tracking"]["max_iters"] = 0
    cfgmod.config["tracking"]["min_match_frac"] = 0.0
    t0 = time.perf_counter()
    model = init_model(TwoViewConfig(), seed=0, device="cuda")
    engine = InferenceEngine(model, H, W)
    retrieval = RetrievalDatabase(feat_dim=1024, proj_dim=1024,
                                  device="cuda")
    sysm = SLAMSystem(engine, H, W, gaussian_module=GaussianAccumulator(
        spatial_stride=4, depth_max_percentile=0.98, max_scale=0.5,
        min_confidence=1.5))
    sysm.backend = FactorGraph(engine, sysm.keyframes, retrieval=retrieval)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    base = (rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8)
    backend_ms: dict = {}
    restore = [_time_calls(torch, sysm.backend, name, backend_ms)
               for name in ("on_keyframe", "solve")]
    restore.append(_time_calls(torch, retrieval, "update", backend_ms))

    cr.launches = cr.bwd_launches = 0
    track_ms, gauss_ms, render_ms, modes, renders = [], [], [], [], 0
    refused = forced = 0
    last = None

    def run_frame(i):
        """One frame as main.py runs it: track (a keyframe forced every
        other frame), then render."""
        nonlocal refused, forced
        img = base[i: i + H, 2 * i: 2 * i + W]
        frame = create_frame(i, img, img_size=W, device="cuda")
        ta = time.perf_counter()
        was = sysm.mode
        n_kf = len(sysm.keyframes)
        mode, _ = sysm.process_frame(frame, force_keyframe=bool(i % 2))
        torch.cuda.synchronize()
        tb = time.perf_counter()
        forced += int(bool(i % 2) and len(sysm.keyframes) > n_kf)
        if was == Mode.RELOC and mode == Mode.RELOC:
            # the backend refused this frame's relocalization
            refused += 1
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
    launches, serving_bwd_launches = cr.launches, cr.bwd_launches
    assert launches == renders, f"{launches} launches for {renders} renders"
    assert serving_bwd_launches == 0, "the serving path launched a backward"
    st = sysm.backend.stats
    n_kf = len(sysm.keyframes)
    assert n_kf >= 2 and st["neighbor_edges"] == n_kf - 1, \
        f"{st['neighbor_edges']} neighbour edges for {n_kf} keyframes"
    assert st["solves"] == n_kf and st["iters"] > 0, st
    assert sysm.backend._stride_params()[0] == 2 and \
        sysm.backend._stride_params()[2] == 4, "not the base.yaml strides"

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
    path_ms = device_ms(lambda: cr.composite(cnt, org, rw, zero), torch)
    path_call_ms = call_ms(lambda: cr.composite(cnt, org, rw, zero), torch)
    path_plain_ms = call_ms(
        lambda: cr.composite_torch(cnt, org, rw, zero), torch, 5)
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
          f"{n_kf} ({forced} forced), edges {len(sysm.backend.ii)} "
          f"(neighbour {st['neighbor_edges']}, matched "
          f"{st['factor_edges']}), solves {st['solves']} ({st['iters']} GN "
          f"iterations, {st['chol_fail']} Cholesky failures), relocalizations "
          f"{st['reloc_ok']}/{st['reloc_tried']}, refused and put back "
          f"{refused} | median host ms: on_keyframe "
          f"{_median(backend_ms['on_keyframe']):.2f}, solve "
          f"{_median(backend_ms['solve']):.2f}, retrieval update "
          f"{_median(backend_ms['update']):.2f} | pool "
          f"{sysm.pool.n} | compositor launches {launches} = renders "
          f"{renders} | modes {','.join(modes)} | last frame: kernel vs "
          f"plain {path_err:.2e}, render vs render_tiles {tiles_err:.2e}, "
          f"mean count {float(cnt.float().mean()):.1f}, largest "
          f"{int(cnt.max())}, kernel "
          f"{path_ms:.4f} ms on the device, call_ms {path_call_ms:.4f} vs "
          f"plain {path_plain_ms:.3f} ms, bound "
          f"{path_bound_ms:.5f} ms by {path_bound_by}")
    results["slice"] = dict(frames=FRAMES, track_ms=track_ms,
                            gauss_ms=gauss_ms, render_ms=render_ms,
                            modes=modes, backend_ms=backend_ms,
                            backend_stats=dict(st), refused=refused,
                            forced=forced,
                            keyframes=len(sysm.keyframes),
                            pool=sysm.pool.n, launches=launches,
                            kernel_vs_plain=path_err,
                            render_vs_render_tiles=tiles_err,
                            mean_count=float(cnt.float().mean()),
                            max_count=int(cnt.max()),
                            kernel_ms=path_ms, call_ms=path_call_ms,
                            plain_ms=path_plain_ms,
                            bound_ms=path_bound_ms)
    # one more (forced keyframe) frame under the profiler, after the launch
    # count is read
    for r in restore:
        r()
    wall, busy, spans = _profile_frame(torch, lambda: run_frame(FRAMES + 1))
    print(f"[profile] one frame: wall {wall:.2f} ms, device kernels "
          f"{busy:.2f} ms (idle {max(0.0, 1 - busy / wall):.1%}) | "
          + ", ".join(f"{k} {h:.2f} ms open / {d:.2f} ms on the device"
                      for k, (h, d) in sorted(spans.items(),
                                              key=lambda kv: -kv[1][0])))
    results["profile"] = dict(wall_ms=wall, device_ms=busy, spans=spans)

    _no_flash(fl, "slice")

    # -- 4. the closed loop on the plane-scene oracle -------------------------
    cl_lines, cl_res, cl_system = _closed_loop_phase(torch, cr, model)
    for ln in cl_lines:
        print(ln)
    results["closed_loop"] = cl_res
    cl_launches = cl_res["launches"] + cl_res["noisy"]["launches"]

    _no_flash(fl, "closed-loop")

    # -- 4c. viewer, session, demo, web app, fidelity sweep -------------------
    viz_work = tempfile.mkdtemp(prefix="chip_smoke_viz_")
    t0 = time.perf_counter()
    try:
        _, viz_res = _viz_phase(torch, cr, model, cl_system, viz_work)
    finally:
        shutil.rmtree(viz_work, ignore_errors=True)
    viz_res["seconds"] = time.perf_counter() - t0
    print(f"[viz] {viz_res['seconds']:.1f} s | compositor launches "
          f"{viz_res['launches']} ({viz_res['launches_by_part']})")
    results["viz"] = viz_res
    viz_launches = viz_res["launches"]

    _no_flash(fl, "viz")

    # -- 4b. the measurement entry points on phase 3's model ------------------
    del engine, sysm, last, frame, kf, cat, retrieval, restore, cl_system
    gc.collect()  # phases 3-4's keyframes and backends: not in the soak's
    torch.cuda.empty_cache()
    entry_lines, entry_res = _entry_phase(torch, cr, model)
    for ln in entry_lines:
        print(ln)
    results["entry"] = entry_res
    entry_launches = entry_res["launches"]
    cfgmod.reset_config()

    _no_flash(fl, "entry")

    # -- 5. the training path at full width -----------------------------------
    from splatt3r_slam_tpu_torch.parallel import TrainConfig, Trainer
    from splatt3r_slam_tpu_torch.train import synthetic_batches

    del model
    gc.collect()  # the entry points' state and the model: not in the peak
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
    s_rel, s_abs = bwd_errors(s_gk, s_gp)
    s_peak = float(s_gp.abs().max())
    assert s_rel <= BWD_TOL, f"training-path backward vs plain {s_rel}"
    # autograd launches the backward's kernels from its own thread, so the
    # profiler attributes none of them to the span: take the remainder
    t_bwd_dev = t_busy - sum(d for k, (_, d) in t_spans.items()
                             if k.startswith("port.train.")
                             and k != "port.train.backward")
    def run_s_bwd():
        return cr.composite_bwd(s_cnt, s_org, s_rows, s_gout, s_out)

    def run_s_fwd():
        return cr.composite(s_cnt, s_org, s_rows, zero)

    s_bwd_ms = device_ms(run_s_bwd, torch)
    s_bwd_call_ms = call_ms(run_s_bwd, torch)
    s_fwd_ms = device_ms(run_s_fwd, torch)
    s_fwd_call_ms = call_ms(run_s_fwd, torch)
    s_bwd_plain_ms = call_ms(
        lambda: cr.composite_bwd_torch(s_cnt, s_org, s_rows, s_gout, s_out),
        torch, 3)
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
          f"{float(s_cnt.float().mean()):.1f}, largest {int(s_cnt.max())}): "
          f"backward {s_bwd_ms:.4f} ms "
          f"on the device, call_ms {s_bwd_call_ms:.4f} vs plain "
          f"{s_bwd_plain_ms:.3f} ms, bound {s_bound_ms:.5f} ms by "
          f"{s_bound_by}, forward {s_fwd_ms:.4f} ms on the device, call_ms "
          f"{s_fwd_call_ms:.4f}; kernel vs plain "
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
        own_rows=dict(rows=int(s_cnt.sum()), max_count=int(s_cnt.max()),
                      bwd_ms=s_bwd_ms,
                      bwd_call_ms=s_bwd_call_ms, fwd_ms=s_fwd_ms,
                      fwd_call_ms=s_fwd_call_ms, bwd_plain_ms=s_bwd_plain_ms,
                      bound_ms=s_bound_ms, bound_by=s_bound_by,
                      fwd_err=s_fwd_err, bwd_rel_err=s_rel,
                      bwd_abs_err=s_abs, bwd_peak=s_peak),
        profile=dict(wall_ms=t_wall, device_ms=t_busy, spans=t_spans,
                     backward_device_ms_by_remainder=t_bwd_dev))

    _no_flash(fl, "train")

    # -- 5b. multi-GPU training at world size 1 over NCCL ---------------------
    del trainer, step, named, batches, seen
    gc.collect()
    torch.cuda.empty_cache()
    dist_work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        dist_lines, dist_res = _dist_phase(torch, cr, results["train"],
                                           dist_work)
    finally:
        shutil.rmtree(dist_work, ignore_errors=True)
    for ln in dist_lines:
        print(ln)
    results["dist"] = dist_res
    dist_launches, dist_bwd_launches = dist_res["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    _no_flash(fl, "dist")

    # -- 6. the CLI's SLAM run at full width ----------------------------------
    fixture = os.path.join(root, "tests", "fixtures", "tum")
    cli_line, cli_res = _cli_phase(
        torch, root, cr, "cuda",
        os.path.join(fixture, "rgbd_dataset_freiburg1_fixture"),
        os.path.join(fixture, "eval_fixture.yaml"))
    cli_launches = cli_res["launches"]
    print(cli_line)
    p = cli_res["profile"]
    print(f"[cli-profile] one more keyframe through the backend "
          f"(on_keyframe: {p['edges_added']} edges matched, one solve): wall "
          f"{p['wall_ms']:.2f} ms, device kernels {p['device_ms']:.2f} ms "
          f"(idle {max(0.0, 1 - p['device_ms'] / p['wall_ms']):.1%}) | "
          + ", ".join(f"{k} {h:.2f} ms open / {d:.2f} ms on the device"
                      for k, (h, d) in sorted(p["spans"].items(),
                                              key=lambda kv: -kv[1][0])))
    results["cli"] = cli_res

    _no_flash(fl, "cli")

    # -- 6b. the same CLI run as users run it: the viewer on, headless --------
    cli_viz_line, cli_viz_res = _cli_phase(
        torch, root, cr, "cuda",
        os.path.join(fixture, "rgbd_dataset_freiburg1_fixture"),
        os.path.join(fixture, "eval_fixture.yaml"), profile=False, viz=True)
    cli_viz_launches = cli_viz_res["launches"]
    print(cli_viz_line.replace("[cli]", "[viz-cli]", 1)
          + f" | {cli_viz_res['run_s']:.1f} s with the viewer vs "
          f"{cli_res['run_s']:.1f} s with --no-viz")
    results["cli_viz"] = cli_viz_res

    _no_flash(fl, "viz-cli")

    # -- 6c. JPEG frames, uploads and /render without cv2 ---------------------
    t0 = time.perf_counter()
    _, jpeg_res = _jpeg_phase(
        torch, root, cr, cli_res,
        lambda: init_model(TwoViewConfig(), seed=0, device="cuda"))
    jpeg_res["seconds"] = time.perf_counter() - t0
    results["jpeg"] = jpeg_res
    jpeg_launches = jpeg_res["launches"]
    print(f"[jpeg] {jpeg_res['seconds']:.1f} s | compositor launches "
          f"{jpeg_launches} (CLI {jpeg_res['cli']['launches']}, demo "
          f"{jpeg_res['demo']['launches']}, web "
          f"{jpeg_res['web']['launches']})")
    gc.collect()
    torch.cuda.empty_cache()

    _no_flash(fl, "jpeg")

    # -- 7. calibrated input through the CLI ----------------------------------
    calib_lines, calib_res = _calibrated_phase(torch, root, cr)
    for ln in calib_lines:
        print(ln)
    results["cli_calibrated"] = calib_res
    calib_launches = sum(r["launches"] for r in calib_res.values())

    _no_flash(fl, "calib")

    # -- 7b. the kernel, model and accuracy scripts; the ablations ----------
    gc.collect()
    torch.cuda.empty_cache()
    scripts_work = tempfile.mkdtemp(prefix="chip_smoke_scripts_")
    try:
        scripts_lines, scripts_res = _scripts_phase(torch, root, cr,
                                                    scripts_work)
    finally:
        shutil.rmtree(scripts_work, ignore_errors=True)
    for ln in scripts_lines:
        print(ln)
    results["scripts"] = scripts_res
    scripts_launches, scripts_bwd_launches = scripts_res["launches"]
    br_rows = scripts_res["bench_rasterizer"]["rows"]
    grad_rows = scripts_res["bench_rasterizer_grad"]["rows"]

    _no_flash(fl, "scripts")

    # -- 7c. the flash-attention path (--flash-attention on) -----------------
    gc.collect()
    torch.cuda.empty_cache()
    flash_lines, flash_res = _flash_phase(torch, root, cr, fl, layers)
    for ln in flash_lines:
        print(ln)
    results["flash"] = flash_res
    flash_launches = sum(flash_res["launches"].values())
    assert layers.flash_attention_mode() == "auto"
    assert fl.bwd_launches == 0, "the serving path launched the backward"
    route_line, route_res = _flash_route_phase(torch, fl, layers)
    print(route_line)
    results["flash_route"] = route_res
    if args.parent and os.path.exists(
            os.path.join(args.parent, "flash_attention.cu")):
        found = _compare_flash_with_parent(torch, fl, args.parent)
        faster = all(f["ms"][1] < f["ms"][0] for f in found.values())
        # the wide forward (redesigned in this checkout's source): faster at
        # B1 N768 H8 Dh 512 in both dtypes and at every fp32 wide row?
        wide = {label: f for label, f in found.items()
                if fl.wide_head_dim(f["D"])}
        head = FLASH_WIDE_HEAD.split("_", 1)[1]
        wide_faster = all(f["ms"][1] < f["ms"][0] for label, f in
                          wide.items() if f["dtype"] == "float32"
                          or label.endswith(head))
        print("[compare-flash] device ms, the flash_attention.cu in --parent "
              "→ this checkout's, in turns, median of 7 rounds of 20 "
              "launches | " + " | ".join(
                  f"{label}: {f['ms'][0]:.4f} → {f['ms'][1]:.4f} (call_ms "
                  f"{f['call_ms'][0]:.4f} → {f['call_ms'][1]:.4f}); "
                  + (f"{f['differ']} of {f['elements']} output elements "
                     f"differ, by at most {f['diff']:.1e}"
                     if f["dtype"] == "bfloat16" else
                     f"the outputs differ by at most {f['diff']:.1e}")
                  for label, f in found.items())
              + f" | this checkout's faster at every shape: {faster}; the "
              f"wide forward faster at {head} (bf16 and fp32) and at every "
              f"fp32 wide row: {wide_faster} | {_smi()}")
        results["compare_flash"] = found

    # -- 7d. full-finetune training with the mode on -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ft_work = tempfile.mkdtemp(prefix="chip_smoke_flash_train_")
    try:
        ft_lines, ft_res = _flash_train_phase(torch, cr, fl, layers, ft_work)
    finally:
        shutil.rmtree(ft_work, ignore_errors=True)
    for ln in ft_lines:
        print(ln)
    results["flash_train"] = ft_res
    # train.main's launches of the template kernels and of the wide ones
    ft_wide_fwd, ft_wide_bwd = ft_res["train_main"]["wide_launches"]
    ft_fwd, ft_bwd = (n - w for n, w in zip(
        ft_res["train_main"]["launches"], (ft_wide_fwd, ft_wide_bwd)))
    if args.parent and os.path.exists(
            os.path.join(args.parent, "flash_attention_bwd.cu")):
        found = _compare_flash_bwd_with_parent(torch, fl, args.parent)
        # the fp32 wide pair (redesigned in this checkout's source): faster
        # at every row?; the pair's sum, this checkout's over the parent's
        wide32 = {label: f for label, f in found.items()
                  if f["dtype"] == "float32" and fl.wide_head_dim(f["D"])}
        faster = all(f[kind][1] < f[kind][0] for f in wide32.values()
                     for kind in ("dkv", "dq"))
        ratios = {label: (f["dkv"][1] + f["dq"][1])
                  / (f["dkv"][0] + f["dq"][0]) for label, f in wide32.items()}
        print("[compare-flash-bwd] device ms, the flash_attention_bwd.cu in "
              "--parent → this checkout's, in turns, median of 7 rounds of "
              "20 launches | " + " | ".join(
                  f"{label}: dK/dV {f['dkv'][0]:.4f} → {f['dkv'][1]:.4f}, dQ "
                  f"{f['dq'][0]:.4f} → {f['dq'][1]:.4f} (gradients differ by "
                  f"{f['diff']:.1e} of their peak, in {f['differ']} "
                  f"elements)"
                  for label, f in found.items())
              + f" | the fp32 wide kernels faster at every wide row: {faster}"
              ", the pair's sum over the parent's: " + ", ".join(
                  f"{label.split()[0]} {r:.3f}" for label, r in ratios.items())
              + f" | {_smi()}")
        results["compare_flash_bwd"] = found
    if args.wide_from_128:
        found = _compare_wide_with_instances(torch, fl)
        print("[wide-vs-instances] device ms, the template instances → the "
              "wide kernels built with -DFLASH_WIDE_FROM=128, in turns, "
              "median of 7 rounds of 20 launches | " + " | ".join(
                  f"{label}: " + ", ".join(
                      f"{kind} {f[kind][0]:.4f} → {f[kind][1]:.4f} "
                      f"({f[kind][1] / f[kind][0]:.2f}x)"
                      for kind in ("fwd", "dkv", "dq"))
                  + f" (wide vs plain: output {f['err']:.1e}, residuals "
                  f"{f['res_err']:.1e}, gradients {f['grads']:.1e} of their "
                  f"peak)" for label, f in found.items())
              + f" | {_smi()}")
        results["wide_vs_instances"] = found
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7e. the TUM evaluation script, in processes of its own --------------
    eval_work = tempfile.mkdtemp(prefix="chip_smoke_eval_tum_")
    try:
        eval_line, eval_res = _eval_tum_phase(root, eval_work)
    finally:
        shutil.rmtree(eval_work, ignore_errors=True)
    print(eval_line)
    results["eval_tum"] = eval_res

    # -- 8. device ------------------------------------------------------------
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    results["seconds"] = time.perf_counter() - t_start
    print(f"[time] {results['seconds']:.1f} s from the start of main, the "
          f"kernels' build included")
    print(f"[device] {kind} | nvidia-smi: {smi}")
    results["device"] = dict(kind=kind, smi=smi)

    kernels = [{
        "name": "composite_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/composite.cu",
        "replaces": "splatt3r_slam_tpu/splat/pallas_rasterizer.py:61",
        "launches": (launches + cl_launches + entry_launches + train_launches
                     + dist_launches + cli_launches + calib_launches
                     + viz_launches + cli_viz_launches + scripts_launches
                     + jpeg_launches + flash_res["compositor_launches"]),
        "max_abs_err": max(err, extra_err, edge_err, path_err, s_fwd_err,
                           dist_res["kernel_vs_plain"],
                           cli_res["kernel_vs_plain"],
                           cl_res["kernel_vs_plain"],
                           entry_res["kernel_vs_plain"],
                           viz_res["kernel_vs_plain"],
                           cli_viz_res["kernel_vs_plain"],
                           scripts_res["kernel_vs_plain"],
                           jpeg_res["kernel_vs_plain"],
                           flash_res["kernel_vs_plain"],
                           *(r["kernel_vs_plain"]
                             for r in calib_res.values())),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "call_ms": fwd_call_ms,
        "ms_training_shape": t_fwd_ms,
        "bound_ms_training_shape": t_fwd_bound_ms,
        "ms_serving_rows": path_ms, "call_ms_serving_rows": path_call_ms,
        "ms_training_rows": s_fwd_ms, "call_ms_training_rows": s_fwd_call_ms,
        "ms_closed_loop_rows": cl_res["kernel_ms"],
        "call_ms_closed_loop_rows": cl_res["call_ms"],
        "bound_ms_closed_loop_rows": cl_res["bound_ms"],
        "launches_serving": launches, "launches_training": train_launches,
        "launches_dist": dist_launches,
        "launches_cli": cli_launches,
        "launches_closed_loop": cl_launches,
        "launches_entry": entry_launches,
        "launches_cli_calibrated": calib_launches,
        "launches_viz": viz_launches,
        "launches_cli_viz": cli_viz_launches,
        "ms_surfel_rows": viz_res["viewer"]["surfel"]["ms"],
        "call_ms_surfel_rows": viz_res["viewer"]["surfel"]["call_ms"],
        "bound_ms_surfel_rows": viz_res["viewer"]["surfel"]["bound_ms"],
        "ms_demo_rows": viz_res["demo"]["rows"]["ms"],
        "call_ms_demo_rows": viz_res["demo"]["rows"]["call_ms"],
        "bound_ms_demo_rows": viz_res["demo"]["rows"]["bound_ms"],
        "ms_sweep_rows": viz_res["sweep"]["rows"]["ms"],
        "call_ms_sweep_rows": viz_res["sweep"]["rows"]["call_ms"],
        "bound_ms_sweep_rows": viz_res["sweep"]["rows"]["bound_ms"],
        "launches_scripts": scripts_launches,
        "launches_jpeg": jpeg_launches,
        "launches_flash": flash_res["compositor_launches"],
        **{f"{k}_bench_rasterizer_{g // 1000}k_rows": h[k]
           for g, h in br_rows.items()
           for k in ("ms", "call_ms", "plain_ms", "bound_ms")},
    }, {
        "name": "composite_bwd_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "splatt3r_slam_tpu/splat/pallas_rasterizer.py:202",
        "launches": (serving_bwd_launches + train_bwd_launches
                     + dist_bwd_launches + scripts_bwd_launches),
        # on the seeded scenes, whose cotangent is unit normal; a training
        # step's own gradients are held relative to their peak (below)
        "max_abs_err": max(bwd_abs, train_abs, small_abs, edge_abs,
                           scripts_res["bwd_abs_err"]),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
        "call_ms": bwd_call_ms,
        "max_err_over_column_peak": max(bwd_rel, train_rel, small_rel,
                                        edge_rel, s_rel,
                                        dist_res["bwd_rel_err"],
                                        scripts_res["bwd_rel_err"]),
        "ms_training_shape": t_bwd_ms,
        "bound_ms_training_shape": t_bwd_bound_ms,
        "ms_training_rows": s_bwd_ms, "call_ms_training_rows": s_bwd_call_ms,
        "launches_serving": serving_bwd_launches,
        "launches_training": train_bwd_launches,
        "launches_dist": dist_bwd_launches,
        "launches_cli": 0,
        "launches_closed_loop": 0,
        "launches_entry": 0,
        "launches_cli_calibrated": 0,
        "launches_viz": 0,
        "launches_cli_viz": 0,
        "launches_scripts": scripts_bwd_launches,
        "launches_jpeg": 0,
        "launches_flash": 0,
        **{f"{k}_bench_rasterizer_grad_rows": grad_rows[k]
           for k in ("ms", "call_ms", "plain_ms", "bound_ms")},
    }, {
        "name": "flash_attention_fwd_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/flash_attention.cu",
        "replaces": "splatt3r_slam_tpu/models/layers.py:126",
        # the CLI with --flash-attention on, the profiled frame and bench
        # with the mode on, bench_attention's flash rows and train.main with
        # the mode on
        "launches": flash_launches + scripts_res["flash_launches"] + ft_fwd,
        "max_abs_err": flash_res["max_abs_err"],
        **{k: flash_res["shapes"][FLASH_SHAPES[0][0]][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "call_ms")},
        # ptxas registers, blocks an SM (occupancy API) and waves there
        **{k: flash_res["shapes"][FLASH_SHAPES[0][0]]["plan"][k]
           for k in ("registers", "blocks_per_sm", "waves")},
        "launches_cli": flash_res["launches"]["cli"],
        "launches_cli_fp32": flash_res["launches"]["cli_fp32"],
        "launches_profile": flash_res["launches"]["profile"],
        "launches_bench": flash_res["launches"]["bench"],
        "launches_scripts": scripts_res["flash_launches"],
        "launches_flash_train": ft_fwd,
        "launches_flash_train_compare": ft_res["compare_launches"][0],
        "launches_other_phases": 0,
        **{f"{k}_{label.split()[0]}": h[k]
           for label, h in flash_res["shapes"].items()
           if not fl.wide_head_dim(h["shape"][4])
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                     "err")},
        **{f"{k}_cli_call": flash_res["cli_held"][k]
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                     "err")},
        **{f"{k}_cli_fp32_call": flash_res["cli_fp32_held"][k]
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                     "err")},
        # ptxas registers, blocks an SM and waves of the fp32 kernel at the
        # fp32 step's encoder shape
        **{f"{k}_fp32": flash_res["shapes"][FLASH_FP32_SHAPES[0][0]]["plan"][k]
           for k in ("registers", "blocks_per_sm", "waves")},
    }] + [{
        "name": f"flash_attention_bwd_{kind}_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:"
                    f"{line}",
        # train.main with the mode on: one launch per attend call
        "launches": ft_bwd,
        # on the seeded unit-normal inputs; a training call's gradients
        # (up to 1e9 on the random model) are held relative to their peak
        "max_abs_err": ft_res["errs"][kind]["abs"],
        "ms": ft_res["shapes"][FLASH_SHAPES[0][0]][f"ms_{kind}"],
        # the plain backward computes dq, dk and dv together; SDPA's
        # backward too (one autograd.grad)
        "plain_ms": ft_res["shapes"][FLASH_SHAPES[0][0]]["plain_ms"],
        "bound_ms": ft_res["shapes"][FLASH_SHAPES[0][0]][f"bound_ms_{kind}"],
        "bound_by": ft_res["shapes"][FLASH_SHAPES[0][0]][f"bound_by_{kind}"],
        "library_ms": ft_res["shapes"][FLASH_SHAPES[0][0]]["library_ms"],
        "call_ms": ft_res["shapes"][FLASH_SHAPES[0][0]][f"call_ms_{kind}"],
        "max_err_over_peak": ft_res["errs"][kind]["over_peak"],
        # ptxas registers, blocks an SM (occupancy API) and waves there
        **{k: ft_res["shapes"][FLASH_SHAPES[0][0]][f"plan_{kind}"][k]
           for k in ("registers", "blocks_per_sm", "waves")},
        "launches_flash_train_compare": ft_res["compare_launches"][1],
        "launches_other_phases": 0,
        **{f"{k}_{label.split()[0]}": h[k if k in ("plain_ms", "library_ms")
                                        else f"{k}_{kind}"]
           for label, h in ft_res["shapes"].items()
           if not fl.wide_head_dim(h["shape"][4])
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")},
    } for kind, line in (("dkv", 796), ("dq", 1146))] + [{
        # the wide kernels: Dh a multiple of 128 from 384 up; their
        # launches are [flash-route]'s (attend at Dh 384) and train.main's
        # (none: ViT-L's heads are 64 wide), their headline numbers the
        # bf16 row at B1 N768 H8 Dh 512
        "name": "flash_attention_fwd_wide_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/flash_attention.cu",
        "replaces": "splatt3r_slam_tpu/models/layers.py:126",
        "launches": route_res["fwd_launches"] + ft_wide_fwd,
        "max_abs_err": max(flash_res["wide_max_abs_err"],
                           route_res["fwd_max_abs_err"]),
        **{k: flash_res["shapes"][FLASH_WIDE_HEAD][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "call_ms")},
        **{k: flash_res["shapes"][FLASH_WIDE_HEAD]["plan"][k]
           for k in ("registers", "blocks_per_sm", "waves")},
        **{f"{k}_{label.split()[0]}": h[k]
           for label, h in flash_res["shapes"].items()
           if fl.wide_head_dim(h["shape"][4])
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                     "err", "l_err", "m_err")},
        # how each wide row ran: clusters along Dh
        **{f"plan_{label.split()[0]}": {
            k: h["plan"][k] for k in (
                "cluster", "max_active_clusters", "blocks", "blocks_per_sm",
                "waves", "registers", "spill_stores", "spill_loads")}
           for label, h in flash_res["shapes"].items()
           if fl.wide_head_dim(h["shape"][4])},
        "launches_flash_route": route_res["fwd_launches"],
        "launches_flash_train": ft_wide_fwd,
        "launches_other_phases": 0,
    }] + [{
        "name": f"flash_attention_bwd_{kind}_wide_kernel", "route": "cuda",
        "source": "splatt3r_slam_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:"
                    f"{line}",
        "launches": route_res["bwd_launches"] + ft_wide_bwd,
        "max_abs_err": max([ft_res["errs"][f"{kind}_wide"]["abs"]]
                           + [route_res["grad_abs"][g]
                              for g in FLASH_GRADS[kind]]),
        "ms": ft_res["shapes"][FLASH_WIDE_HEAD][f"ms_{kind}"],
        "plain_ms": ft_res["shapes"][FLASH_WIDE_HEAD]["plain_ms"],
        "bound_ms": ft_res["shapes"][FLASH_WIDE_HEAD][f"bound_ms_{kind}"],
        "bound_by": ft_res["shapes"][FLASH_WIDE_HEAD][f"bound_by_{kind}"],
        "library_ms": ft_res["shapes"][FLASH_WIDE_HEAD]["library_ms"],
        "call_ms": ft_res["shapes"][FLASH_WIDE_HEAD][f"call_ms_{kind}"],
        "max_err_over_peak": max(
            [ft_res["errs"][f"{kind}_wide"]["over_peak"]]
            + [route_res["grad"]["rel"][g] for g in FLASH_GRADS[kind]]),
        **{k: ft_res["shapes"][FLASH_WIDE_HEAD][f"plan_{kind}"][k]
           for k in ("registers", "blocks_per_sm", "waves")},
        **{f"{k}_{label.split()[0]}": h[k if k in ("plain_ms", "library_ms")
                                        else f"{k}_{kind}"]
           for label, h in ft_res["shapes"].items()
           if fl.wide_head_dim(h["shape"][4])
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")},
        # how each wide row ran: the fp32 kernel on clusters along Dh
        **{f"plan_{label.split()[0]}": {
            k: h[f"plan_{kind}"][k] for k in (
                "cluster", "max_active_clusters", "blocks", "blocks_per_sm",
                "waves", "registers", "spill_stores", "spill_loads")}
           for label, h in ft_res["shapes"].items()
           if fl.wide_head_dim(h["shape"][4])},
        "launches_flash_route": route_res["bwd_launches"],
        "launches_flash_train": ft_wide_bwd,
        "launches_other_phases": 0,
    } for kind, line in (("dkv", 796), ("dq", 1146))]
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
