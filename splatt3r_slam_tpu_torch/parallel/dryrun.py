"""One training step of the full loss on a sharded mesh.

Counterpart of `splatt3r_slam_tpu/parallel/dryrun.py`, shared by
`graft_entry.dryrun_multichip` and the tests: ONE step of the full loss
(photometric MSE + SSIM + LPIPS on rendered target views, gradients
through the rasterizer, plus the confidence-weighted Regr3D term) on the
tiny fp32 model, every parameter training, under a `(dp, fsdp, tp)` mesh
with its parameter and batch sharding. A check of the sharded step, not a
benchmark: the shapes are the JAX package's (32x48, one target view,
k_max 32, LPIPS channels divided by 16, one sample per rank).

The ranks are N processes (one GPU each under NCCL, or the CPU over gloo
when the caller asks for it), or this process when N is 1. The JAX
package's XLA:CPU rendezvous flags have no counterpart: every process
group is opened with an explicit timeout instead.
"""

from __future__ import annotations

import numpy as np

from splatt3r_slam_tpu_torch.parallel.mesh import TIMEOUT_S


def pick_mesh_shape(n_devices: int) -> tuple[int, int]:
    """(fsdp, tp) exercising all three axes when the count allows."""
    if n_devices % 8 == 0:
        return 2, 2
    if n_devices % 2 == 0 and n_devices > 1:
        return 2, 1
    return 1, 1


def dryrun_batch(B: int, h: int, w: int, v_targets: int) -> dict:
    """The JAX dry run's batch (numpy, drawn in its order from seed 0)."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    eye = np.broadcast_to(np.eye(4, dtype=f32), (B, 4, 4))
    K = np.broadcast_to(
        np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1.0]], f32),
        (B, v_targets, 3, 3))
    return {
        "img1": rng.normal(size=(B, h, w, 3)).astype(f32),
        "img2": rng.normal(size=(B, h, w, 3)).astype(f32),
        "gt1_pts": rng.normal(size=(B, h, w, 3)).astype(f32),
        "gt2_pts": rng.normal(size=(B, h, w, 3)).astype(f32),
        "valid1": np.ones((B, h, w), bool),
        "valid2": np.ones((B, h, w), bool),
        "context_pose": eye,
        "target_pose": np.broadcast_to(eye[:, None], (B, v_targets, 4, 4)),
        "target_K": K,
        "target_img": rng.random((B, v_targets, h, w, 3)).astype(f32),
    }


def _rank_step(rank, world, init_method, device_type, fsdp, tp, h, w,
               v_targets, k_max, lpips_channel_scale, params):
    from splatt3r_slam_tpu_torch.models import TwoViewConfig
    from splatt3r_slam_tpu_torch.models.checkpoint import params_from_jax
    from splatt3r_slam_tpu_torch.parallel.mesh import (
        make_mesh,
        mesh_shape,
        process_group,
    )
    from splatt3r_slam_tpu_torch.parallel.trainer import (
        TrainConfig,
        Trainer,
    )
    from splatt3r_slam_tpu_torch.utils.lpips import random_params

    with process_group(rank, world, init_method, device_type):
        mesh = make_mesh(world, fsdp=fsdp, tp=tp)
        device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
        cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
        tcfg = TrainConfig(train_gaussian_heads_only=False,
                           render_loss=True, ssim_weight=0.1,
                           lpips_weight=0.25, mast3r_loss_weight=0.1,
                           k_max=k_max)
        trainer = Trainer(cfg, tcfg, device=device, mesh=mesh,
                          lpips_params=random_params(
                              channel_scale=lpips_channel_scale,
                              device=device))
        if params is not None:
            trainer.load_state_dict(params_from_jax(params, cfg))
        metrics = trainer.make_train_step()(
            dryrun_batch(world, h, w, v_targets))
        out = {k: float(v) for k, v in metrics.items()}
        out["mesh"] = mesh_shape(mesh)
        return out


def full_loss_train_step(n_devices: int, *, h: int = 32, w: int = 48,
                         v_targets: int = 1, k_max: int = 32,
                         lpips_channel_scale: int = 16, device="cuda",
                         params=None, timeout_s: float = TIMEOUT_S) -> dict:
    """Build the mesh and the trainer on `n_devices` ranks, run ONE
    full-loss step on a batch of one sample per rank, and return rank 0's
    metrics (floats, taken before the update) with the mesh shape under
    "mesh". `params` is a JAX parameter tree as numpy arrays (carried by
    `params_from_jax`); without it the weights are the port's seeded ones.
    On CUDA it raises unless there is one GPU per rank."""
    from splatt3r_slam_tpu_torch import resolve_device
    from splatt3r_slam_tpu_torch.parallel.mesh import launch

    device_type = resolve_device(device).type
    fsdp, tp = pick_mesh_shape(n_devices)
    return launch(_rank_step, n_devices,
                  (device_type, fsdp, tp, h, w, v_targets, k_max,
                   lpips_channel_scale, params),
                  device_type=device_type, timeout_s=timeout_s)
