"""Training experiment runner, on one GPU or a (dp, fsdp, tp) mesh of them.

    python -m splatt3r_slam_tpu_torch.train [--config ws.yaml] [--set k=v ...]
    python -m splatt3r_slam_tpu_torch.train --devices N [--set parallel.fsdp=F
        parallel.tp=T ...]
    torchrun --nproc-per-node N -m splatt3r_slam_tpu_torch.train ...

Counterpart of the repository's root `train.py`, with its flag surface plus
`--device`: builds the model and the trainer from a workspace config, runs
`Trainer.fit` with CSV metrics (`parallel/logging.py`), an optional
profiler trace window, periodic eval, and a parameter checkpoint into a
timestamped workspace (`parallel/workspace.py`, provenance included).
`--test` runs the masked-metric sweep instead of training.

Data: `--data` takes .npz files, each holding one batch dict (img1, img2,
gt1_pts, gt2_pts, valid1, valid2 and, for the photometric loss,
context_pose, target_pose, target_K, target_img[, loss_mask]). Without
`--data`, a synthetic batch generator drives the identical step for
dry-runs; the same seed gives the batches of the root `train.py`.

Devices: without `--devices` (and without `parallel.devices` in the
config, or a torchrun launch) the trainer runs on one device, as before.
`--devices N` (or `parallel.devices: N`) runs on an N-rank mesh of shape
(N / (fsdp·tp), fsdp, tp), with `parallel.fsdp` and `parallel.tp` from
the config or `--set`; `--devices 1` is that mesh at world size 1, in this
process. N above 1 starts N ranks with spawn (rank r on cuda:r over NCCL,
or on the CPU over gloo with `--device cpu`); under torchrun (WORLD_SIZE
in the environment) each process joins torchrun's group instead. On CUDA
with fewer than N GPUs it raises. The global batch is `--batch-size`, by
default one sample per rank; every rank draws the same batches and trains
on its rows of each. Only rank 0 writes the workspace, the metrics and
the checkpoint, which keeps the unsharded layout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_trainer(cfg: dict, args, devices: int = 0):
    """Config dict -> (Trainer, model_cfg); with `devices` a mesh of that
    many ranks (the process group's) from the config's parallel.fsdp and
    parallel.tp."""
    from splatt3r_slam_tpu_torch.models import TwoViewConfig
    from splatt3r_slam_tpu_torch.parallel import TrainConfig, Trainer
    from splatt3r_slam_tpu_torch.parallel.mesh import make_mesh

    mdl = cfg.get("model", {})
    trn = cfg.get("train", {})
    par = cfg.get("parallel", {})

    model_cfg = TwoViewConfig(
        use_offsets=bool(mdl.get("use_offsets", False)),
        remat=bool(mdl.get("remat", True)),  # training default: save memory
    )
    if args.tiny_model:
        tiny = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
        model_cfg = tiny._replace(use_offsets=model_cfg.use_offsets,
                                  remat=model_cfg.remat)

    tcfg = TrainConfig(
        lr=float(trn.get("lr", 1e-5)),
        weight_decay=float(trn.get("weight_decay", 0.0)),
        lr_milestones=tuple(trn.get("lr_milestones", ())),
        lr_gamma=float(trn.get("lr_gamma", 0.1)),
        grad_clip_norm=float(trn.get("gradient_clip_val", 0.5)),
        train_gaussian_heads_only=bool(
            trn.get("train_gaussian_heads_only", True)),
        mast3r_loss_weight=trn.get("mast3r_loss_weight"),
        conf_alpha=float(trn.get("conf_alpha", 0.2)),
        mse_weight=float(trn.get("mse_weight", 1.0)),
        ssim_weight=float(trn.get("ssim_weight", 0.0)),
        lpips_weight=float(trn.get("lpips_weight", 0.0)),
        render_loss=bool(trn.get("render_loss", False)),
        sh_residual=bool(trn.get("learn_residual", True)),
        k_max=int(trn.get("k_max", 256 if not args.tiny_model else 64)),
        accum_steps=int(trn.get("accumulate_grad_batches", 1)),
    )

    lpips_params = None
    lp_path = trn.get("lpips_params")
    if tcfg.lpips_weight and lp_path:
        from splatt3r_slam_tpu_torch.utils.lpips import load_lpips_params

        lpips_params = load_lpips_params(lp_path, device=args.device)

    mesh = make_mesh(devices, fsdp=int(par.get("fsdp", 1)),
                     tp=int(par.get("tp", 1))) if devices else None
    return Trainer(model_cfg, tcfg, device=args.device, mesh=mesh,
                   lpips_params=lpips_params, seed=args.seed), model_cfg


def synthetic_batches(n_steps, B, h, w, render_loss, seed=0,
                      mask_coverage=None):
    """Deterministic random pair batches (numpy) with the full supervision
    dict, drawn in the order of the root `train.py`.

    mask_coverage in (0, 1] adds a 'loss_mask' (B, V, H, W) covering a
    centered box of roughly that area fraction — the test sweep's stand-in
    for a frustum-overlap mask (npz batches can carry a real one)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    eye = np.broadcast_to(np.eye(4, dtype=f32), (B, 4, 4))
    K = np.broadcast_to(
        np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1.0]], f32),
        (B, 1, 3, 3))
    for _ in range(n_steps):
        batch = {
            "img1": rng.normal(size=(B, h, w, 3)).astype(f32),
            "img2": rng.normal(size=(B, h, w, 3)).astype(f32),
            "gt1_pts": rng.normal(size=(B, h, w, 3)).astype(f32),
            "gt2_pts": rng.normal(size=(B, h, w, 3)).astype(f32),
            "valid1": np.ones((B, h, w), bool),
            "valid2": np.ones((B, h, w), bool),
        }
        if render_loss:
            batch.update({
                "context_pose": eye,
                "target_pose": eye[:, None],
                "target_K": K,
                "target_img": rng.random((B, 1, h, w, 3)).astype(f32),
            })
            if mask_coverage is not None:
                frac = float(np.sqrt(mask_coverage))
                mh, mw = max(1, round(h * frac)), max(1, round(w * frac))
                m = np.zeros((h, w), f32)
                y0, x0 = (h - mh) // 2, (w - mw) // 2
                m[y0:y0 + mh, x0:x0 + mw] = 1.0
                batch["loss_mask"] = np.broadcast_to(m, (B, 1, h, w))
        yield batch


def npz_batches(paths, epochs):
    for _ in range(epochs):
        for p in paths:
            z = np.load(p)
            yield {k: z[k] for k in z.files}


def _say(*a):
    from splatt3r_slam_tpu_torch.parallel.mesh import is_rank0

    if is_rank0():
        print(*a)


def run_test_sweep(trainer, args, h, w, ws):
    """Masked-metric test protocol: for each α=β, test batches whose loss
    mask covers ~α·β of the image (real masks come in via --data npz) are
    evaluated under (apply_mask, average_over_mask) ∈ {(True, False),
    (True, True)} with spatial LPIPS and masked SSIM, accumulating one
    `results.json` keyed by the sweep point."""
    from splatt3r_slam_tpu_torch.parallel.mesh import is_rank0

    masking_configs = ((True, False), (True, True))
    eval_fns = {mc: trainer.make_eval_step(apply_mask=mc[0],
                                           average_over_mask=mc[1])
                for mc in masking_configs}
    results = {}
    for alpha in args.alphas:
        beta = alpha
        if args.data:
            batches = list(npz_batches(args.data, 1))
        else:
            batches = list(synthetic_batches(
                2, args.batch_size or 1, h, w, True, seed=args.seed + 17,
                mask_coverage=alpha * beta))
        for apply_mask, average_over_mask in masking_configs:
            eval_fn = eval_fns[(apply_mask, average_over_mask)]
            agg: dict[str, list[float]] = {}
            for b in batches:
                metrics, _rendered = eval_fn(b)
                for k, v in metrics.items():
                    agg.setdefault(k, []).append(float(v))
            res = {f"test/{k}": sum(v) / len(v) for k, v in agg.items()}
            lp = res.get("test/lpips", float("nan"))
            res["test/loss"] = (
                trainer.cfg.mse_weight * res["test/mse"]
                + (trainer.cfg.lpips_weight * lp if lp == lp else 0.0)
            )
            key = (f"alpha: {alpha}, beta: {beta}, "
                   f"apply_mask: {apply_mask}, "
                   f"average_over_mask: {average_over_mask}")
            results[key] = [res]
            _say(f"{key} -> psnr {res['test/psnr']:.2f} "
                 f"ssim {res['test/ssim']:.4f}")
            if is_rank0():
                with open(ws / "results.json", "w") as f:
                    json.dump(results, f, indent=1)
    _say(f"results: {ws / 'results.json'}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default=None,
                   help="workspace YAML (include: list supported)")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   help="dotlist overrides, e.g. train.lr=2e-5")
    p.add_argument("--name", default="experiment")
    p.add_argument("--out", default="logs/train")
    p.add_argument("--data", nargs="*", default=None,
                   help=".npz batch files (see module docstring)")
    p.add_argument("--epochs", type=int, default=1,
                   help="passes over --data files")
    p.add_argument("--steps", type=int, default=10,
                   help="synthetic-batch steps when --data is not given")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks of the (dp, fsdp, tp) mesh (0 = config "
                        "parallel.devices, else one device, no mesh)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="synthetic global batch per step (0 = one sample "
                        "per rank)")
    p.add_argument("--res", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--tiny-model", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="init from a local Splatt3R .ckpt/.pth")
    p.add_argument("--resume", default=None,
                   help="resume params from a save_params .npz")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--trace", type=int, nargs=2, default=None,
                   metavar=("START", "STOP"),
                   help="profiler trace window (step range)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--test", action="store_true",
                   help="masked-metric test sweep instead of training: "
                        "α/β × (apply_mask, average_over_mask) → "
                        "results.json")
    p.add_argument("--alphas", type=float, nargs="*",
                   default=[0.9, 0.7, 0.5, 0.3],
                   help="--test sweep α (=β) values")
    args = p.parse_args(argv)

    from splatt3r_slam_tpu_torch import set_fp32_precision
    from splatt3r_slam_tpu_torch.parallel.workspace import (
        apply_dotlist,
        load_config,
    )

    set_fp32_precision()
    cfg = load_config(args.config, dotlist=args.overrides) \
        if args.config else apply_dotlist({}, args.overrides)
    devices = int(args.devices or cfg.get("parallel", {}).get("devices", 0)
                  or os.environ.get("WORLD_SIZE", 0))
    if not devices:
        return _run(args, cfg, 0)
    import torch
    import torch.distributed as dist

    from splatt3r_slam_tpu_torch.parallel.mesh import launch

    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        # join this process's group, or open torchrun's from its environment
        up = dist.is_initialized()
        world = dist.get_world_size() if up else int(os.environ["WORLD_SIZE"])
        if world != devices:
            raise ValueError(f"--devices {devices} in a process group of "
                             f"{world} ranks")
        rank = dist.get_rank() if up else int(os.environ["RANK"])
        return _train_rank(rank, world, "env://", args, cfg)
    return launch(_train_rank, devices, (args, cfg),
                  device_type=torch.device(args.device).type)


def _train_rank(rank, world, init_method, args, cfg):
    """One rank of a mesh run: every rank runs the whole CLI body."""
    import torch

    from splatt3r_slam_tpu_torch.parallel.mesh import process_group

    with process_group(rank, world, init_method,
                       torch.device(args.device).type):
        return _run(args, cfg, world)


def _run(args, cfg, devices):
    """The CLI body on one device (devices 0) or on this rank of a mesh
    of `devices` ranks."""
    from splatt3r_slam_tpu_torch.parallel.mesh import mesh_shape
    from splatt3r_slam_tpu_torch.parallel.workspace import create_workspace

    trainer, model_cfg = build_trainer(cfg, args, devices)
    h, w = args.res or ((32, 48) if args.tiny_model else (256, 384))

    if args.checkpoint:
        from splatt3r_slam_tpu_torch.models.checkpoint import (
            load_torch_checkpoint,
        )

        _say(f"init from checkpoint: {args.checkpoint}")
        trainer.load_state_dict(load_torch_checkpoint(args.checkpoint))
    elif args.resume:
        _say(f"resume params: {args.resume}")
        trainer.load_params(args.resume)

    ws = create_workspace(args.out, args.name, cfg)
    _say(f"workspace: {ws} (device {trainer.device}"
         + (f", mesh {mesh_shape(trainer.mesh)})" if devices else ")"))

    if args.test:
        return run_test_sweep(trainer, args, h, w, ws)
    B = args.batch_size or (trainer.mesh.size() if devices else 1)
    if args.data:
        batches = npz_batches(args.data, args.epochs)
    else:
        batches = synthetic_batches(args.steps, B, h, w,
                                    trainer.cfg.render_loss, seed=args.seed)

    eval_batches = None
    if args.eval_every:
        # eval_step always renders target views -> pose fields required
        eval_batches = list(synthetic_batches(1, B, h, w, True,
                                              seed=args.seed + 1))

    csv_path = trainer.fit(
        batches, run_dir=ws, run_name=args.name,
        log_every=args.log_every, eval_every=args.eval_every,
        eval_batches=eval_batches,
        trace_steps=tuple(args.trace) if args.trace else None,
        verbose=args.verbose,
    )
    trainer.save_params(ws / "params_final.npz")
    _say(f"metrics: {csv_path}\nparams: {ws / 'params_final.npz'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
