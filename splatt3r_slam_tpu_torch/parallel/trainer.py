"""Training harness for the two-view model, on one device or a mesh.

Counterpart of `splatt3r_slam_tpu/parallel/trainer.py`: Adam + MultiStepLR,
gaussian-head-only finetuning with optional full unfreeze, the photometric
MSE (+SSIM, +LPIPS) loss on rendered target views and the optional
confidence-weighted pointmap regression (`conf·‖x−gt‖ − α·log conf`).
Where the JAX trainer is a set of pure functions over (params, opt_state),
this one owns its model and optimiser. Without a mesh it runs on one
device. With a `(dp, fsdp, tp)` mesh (`parallel/mesh.py`) the model is
sharded (tensor parallelism, then FSDP2), each step takes the global batch
and keeps this rank's rows, and every sum and count of the loss is summed
over the ranks that hold the other rows, so that the loss, its gradient
and the step are those of the global batch, as GSPMD makes them in the
JAX trainer. The render loss goes through `DecoderSplatting`, so on CUDA
tensors every render's forward and backward run the hand-written
compositor kernels (`cuda_rasterizer.Composite`), on plain local tensors
under a mesh too.

Freezing is `requires_grad_`: with `train_gaussian_heads_only` only
parameters whose name holds `gaussian_dpt` train, and autograd then builds
no graph for the trunk. The optimiser follows the JAX chain: the global
norm of the trainable gradients is clipped, then coupled weight decay,
then Adam; with `accum_steps` N the clip and the step are applied once on
the mean of N micro-batch gradients. On a mesh the clipped norm is that
of the whole gradient, summed over every mesh its parameters live on.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from splatt3r_slam_tpu_torch import resolve_device
from splatt3r_slam_tpu_torch.models import (
    Splatt3RModel,
    TwoViewConfig,
    init_weights,
)


class TrainConfig(NamedTuple):
    lr: float = 1e-5
    weight_decay: float = 0.0
    lr_milestones: tuple = ()
    lr_gamma: float = 0.1
    grad_clip_norm: float = 0.5  # global-norm ceiling before the step
    train_gaussian_heads_only: bool = True
    mast3r_loss_weight: float | None = None  # extra Regr3D term weight
    conf_alpha: float = 0.2
    mse_weight: float = 1.0
    ssim_weight: float = 0.0
    render_loss: bool = False  # photometric loss on rendered target views
    lpips_weight: float = 0.0  # perceptual term (needs VGG weights)
    sh_residual: bool = True  # SH predicted as a residual over the image
    k_max: int = 256  # rasterizer depth-list cap during training
    # average grads over N consecutive micro-batches, apply the optimiser
    # (incl. the global-norm clip) once on the mean
    accum_steps: int = 1


def regr3d_conf_loss(pred1, pred2, gt1_pts, gt2_pts, valid1, valid2,
                     alpha=0.2, total=None):
    """Confidence-weighted two-view pointmap regression: mean over valid
    pixels of conf·‖pts−gt‖ − α·log conf, each view normalized by its
    average gt distance. `total` (as in `utils/metrics.batch_mean`) makes
    both the normalization and the mean the whole batch's."""

    def summed(*xs):
        s = torch.stack(xs)
        return (s if total is None else total(s)).unbind()

    def one(pred_pts, conf, gt, valid):
        v = valid.float()
        gt_sum, n = summed((torch.linalg.norm(gt, dim=-1) * v).sum(),
                           v.sum())
        nrm = torch.clamp(gt_sum / (n + 1e-8), min=1e-8)
        err = torch.linalg.norm(pred_pts / nrm - gt / nrm, dim=-1)
        l = conf * err - alpha * torch.log(conf)
        (l_sum,) = summed((l * v).sum())
        return l_sum / (n + 1e-8)

    return one(pred1["pts3d"], pred1["conf"], gt1_pts, valid1) + one(
        pred2["pts3d"], pred2["conf"], gt2_pts, valid2)


def _lpips_term(lpips_params, img, gt, mask=None, total=None):
    """LPIPS reduction: the spatial map mask-averaged when a loss mask is
    given, else the plain batch mean (`total` as in `regr3d_conf_loss`).
    Inputs are [0, 1] NHWC."""
    from splatt3r_slam_tpu_torch.utils.lpips import lpips_from_01
    from splatt3r_slam_tpu_torch.utils.metrics import batch_mean

    if mask is not None:
        lp_map = lpips_from_01(lpips_params, img, gt, spatial=True)
        num, den = (lp_map * mask).sum(), mask.sum()
        if total is not None:
            num, den = total(torch.stack([num, den])).unbind()
        return num / torch.clamp(den, min=1.0)
    return batch_mean(lpips_from_01(lpips_params, img, gt, spatial=False),
                      total)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        d = tree
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


class Trainer:
    """Trainer on one device, or on this rank of a `(dp, fsdp, tp)` mesh.

    batch dict: img1, img2 (B,H,W,3); gt1_pts, gt2_pts (B,H,W,3); valid1,
    valid2 (B,H,W); for the render loss also context_pose (B,4,4),
    target_pose (B,V,4,4), target_K (B,V,3,3), target_img (B,V,H,W,3) and
    optionally loss_mask (B,V,H,W). Numpy arrays or tensors. On a mesh
    every rank passes the same global batch; a training step keeps this
    rank's rows (`mesh.batch_rows`), an eval step runs all of them.
    `device` is then this rank's device, and every call is a collective:
    every rank makes it."""

    def __init__(self, model_cfg: TwoViewConfig, train_cfg: TrainConfig,
                 device="cuda", mesh=None, lpips_params=None,
                 seed: int = 0):
        from splatt3r_slam_tpu_torch.parallel.mesh import (
            data_sum,
            shard_model,
        )

        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = init_weights(
            Splatt3RModel(model_cfg).to(self.device), seed).train()
        # LPIPS-VGG calibration tree (utils/lpips.py)
        self.lpips_params = lpips_params
        for name, p in self.model.named_parameters():
            p.requires_grad_(not train_cfg.train_gaussian_heads_only
                             or "gaussian_dpt" in name)
        # sums over the ranks holding the batch's other rows (None: one
        # device, the batch is all here)
        self._total = None
        if mesh is not None:
            shard_model(self.model, mesh)
            self._total = data_sum(mesh)
        self.trainable = [p for p in self.model.parameters()
                          if p.requires_grad]
        self.optimizer = torch.optim.Adam(
            self.trainable, lr=train_cfg.lr, eps=1e-8,
            weight_decay=train_cfg.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, [int(m) for m in train_cfg.lr_milestones],
            gamma=train_cfg.lr_gamma)
        self._micro = 0  # micro-batches accumulated since the last step

    # ------------------------------------------------------------------
    def to_device(self, batch: dict) -> dict:
        """Batch of numpy arrays or tensors → tensors on the device."""
        return {k: (v if torch.is_tensor(v)
                    else torch.from_numpy(np.array(v))).to(self.device)
                for k, v in batch.items()}

    def _render(self, pred1, pred2, batch, sh_residual: bool):
        """Predictions + poses → rendered target views (B, V, H, W, 3);
        `sh_residual` adds the source images' colour to the SH DC term."""
        from splatt3r_slam_tpu_torch.splat.decoder import DecoderSplatting
        from splatt3r_slam_tpu_torch.splat.gaussians import (
            RGB2SH,
            build_covariance,
        )

        def prep(pred, img):
            p = dict(pred)
            p["covariances"] = build_covariance(p["scales"], p["rotations"])
            if img is not None:
                sh = p["sh"]
                p["sh"] = torch.cat(
                    [sh[..., :1] + RGB2SH(img * 0.5 + 0.5)[..., None],
                     sh[..., 1:]], dim=-1)
            return p

        p1 = prep(pred1, batch["img1"] if sh_residual else None)
        p2 = prep(pred2, batch["img2"] if sh_residual else None)
        p2["means_in_other_view"] = p2["means"]
        H, W = batch["img1"].shape[1:3]
        rb = {
            "context": [{"camera_pose": batch["context_pose"]}],
            "target": [{"camera_pose": batch["target_pose"][:, v],
                        "camera_intrinsics": batch["target_K"][:, v]}
                       for v in range(batch["target_pose"].shape[1])],
        }
        color, _ = DecoderSplatting(k_max=self.cfg.k_max)(rb, p1, p2, (H, W))
        return color.permute(0, 1, 3, 4, 2)  # NHWC

    def loss_from_predictions(self, pred1, pred2, batch):
        """The loss recipe on the model's two prediction dicts:
        photometric MSE (+SSIM, +LPIPS) on rendered target views, optional
        confidence-weighted Regr3D term; masked averaging through
        batch['loss_mask']. Returns (loss, metrics)."""
        from splatt3r_slam_tpu_torch.utils.metrics import mse as mse_fn
        from splatt3r_slam_tpu_torch.utils.metrics import ssim_mean

        cfg = self.cfg
        metrics = {}
        loss = 0.0
        if cfg.render_loss:
            with record_function("port.train.render"):
                rendered = self._render(pred1, pred2, batch,
                                        cfg.sh_residual)
            with record_function("port.train.loss"):
                H, W = rendered.shape[2:4]
                gt = batch["target_img"]
                mask = batch.get("loss_mask")
                m = mse_fn(rendered, gt, mask, total=self._total)
                metrics["mse"] = m
                loss = loss + cfg.mse_weight * m
                if cfg.ssim_weight:
                    s = ssim_mean(rendered.reshape(-1, H, W, 3),
                                  gt.reshape(-1, H, W, 3),
                                  total=self._total)
                    metrics["ssim"] = s
                    loss = loss + cfg.ssim_weight * (1.0 - s)
                if cfg.lpips_weight and self.lpips_params is not None:
                    lp = _lpips_term(self.lpips_params,
                                     rendered.reshape(-1, H, W, 3),
                                     gt.reshape(-1, H, W, 3),
                                     None if mask is None
                                     else mask.reshape(-1, H, W),
                                     total=self._total)
                    metrics["lpips"] = lp
                    loss = loss + cfg.lpips_weight * lp

        if (cfg.mast3r_loss_weight is not None) or not cfg.render_loss:
            w = (cfg.mast3r_loss_weight
                 if cfg.mast3r_loss_weight is not None else 1.0)
            with record_function("port.train.loss"):
                r3d = regr3d_conf_loss(
                    pred1, pred2, batch["gt1_pts"], batch["gt2_pts"],
                    batch["valid1"], batch["valid2"], cfg.conf_alpha,
                    total=self._total)
            metrics["regr3d"] = r3d
            loss = loss + w * r3d

        metrics["loss"] = loss
        return loss, metrics

    def loss_fn(self, batch):
        """Model forward + `loss_from_predictions`. Returns (loss, metrics)
        with the graph of every trainable parameter attached. On a mesh
        `batch` is the global batch and this rank takes its rows."""
        if self.mesh is not None:
            from splatt3r_slam_tpu_torch.parallel.mesh import batch_rows

            batch = batch_rows(batch, self.mesh)
        batch = self.to_device(batch)
        with record_function("port.train.forward"):
            pred1, pred2 = self.model(batch["img1"].float(),
                                      batch["img2"].float())
        return self.loss_from_predictions(pred1, pred2, batch)

    # ------------------------------------------------------------------
    def make_train_step(self):
        """→ step(batch) -> metrics (detached scalars). Each call takes one
        micro-batch; the optimiser steps on every `accum_steps`-th call."""
        n = max(1, int(self.cfg.accum_steps))

        def train_step(batch):
            loss, metrics = self.loss_fn(batch)
            with record_function("port.train.backward"):
                if loss.requires_grad:  # else no trainable parameter is reached
                    (loss / n).backward()
            self._micro += 1
            if self._micro == n:
                self._micro = 0
                with record_function("port.train.optimiser"):
                    if self.cfg.grad_clip_norm:
                        self._clip_grads(self.cfg.grad_clip_norm)
                    self.optimizer.step()
                    self.scheduler.step()
                    self.optimizer.zero_grad(set_to_none=True)
            return {k: v.detach() if torch.is_tensor(v) else v
                    for k, v in metrics.items()}

        return train_step

    def _clip_grads(self, max_norm: float):
        """Scale the trainable gradients so that their global 2-norm is
        at most `max_norm` (torch's clip_grad_norm_). On a mesh the
        gradients are DTensors on two meshes (tensor-parallel weights on
        (dp, fsdp, tp), the rest on (dp, fsdp)): the norm is taken per
        mesh, whole, and the two are combined."""
        if self.mesh is None:
            torch.nn.utils.clip_grad_norm_(self.trainable, max_norm)
            return
        by_mesh: dict = {}
        for p in self.trainable:
            if p.grad is not None:
                by_mesh.setdefault(p.grad.device_mesh, []).append(p.grad)
        norms = [torch.nn.utils.get_total_norm(gs).full_tensor()
                 for gs in by_mesh.values()]
        if not norms:
            return
        norm = torch.linalg.vector_norm(torch.stack(norms))
        coef = float(torch.clamp(max_norm / (norm + 1e-6), max=1.0))
        for grads in by_mesh.values():
            for g in grads:
                g.mul_(coef)

    def make_eval_step(self, apply_mask: bool = False,
                       average_over_mask: bool = True):
        """→ eval_step(batch) -> (metrics, rendered): MSE / PSNR / SSIM /
        LPIPS on rendered target views (LPIPS is NaN without a VGG tree).

        `apply_mask` multiplies both rendered and target colours by the
        loss mask before the metrics; `average_over_mask` switches every
        metric from a plain mean to a mask-weighted average. Both are
        no-ops when the batch carries no 'loss_mask'."""
        from splatt3r_slam_tpu_torch.utils.metrics import (
            mse as mse_fn,
            psnr_from_mse,
            ssim_mean,
        )

        @torch.no_grad()
        def eval_step(batch):
            batch = self.to_device(batch)
            pred1, pred2 = self.model(batch["img1"].float(),
                                      batch["img2"].float())
            rendered = self._render(pred1, pred2, batch, True)
            H, W = rendered.shape[2:4]
            gt = batch["target_img"]
            mask = batch.get("loss_mask")
            if mask is not None and apply_mask:
                rendered = rendered * mask[..., None]
                gt = gt * mask[..., None]
            avg_mask = mask if (mask is not None and average_over_mask) \
                else None
            flat_mask = None if avg_mask is None \
                else avg_mask.reshape(-1, H, W)
            m = mse_fn(rendered, gt, avg_mask)
            lp = (_lpips_term(self.lpips_params,
                              rendered.reshape(-1, H, W, 3),
                              gt.reshape(-1, H, W, 3), flat_mask)
                  if self.lpips_params is not None
                  else torch.tensor(float("nan")))  # no VGG weights supplied
            return {
                "mse": m,
                "psnr": psnr_from_mse(m),
                "ssim": ssim_mean(rendered.reshape(-1, H, W, 3),
                                  gt.reshape(-1, H, W, 3), flat_mask),
                "lpips": lp,
            }, rendered

        return eval_step

    # ------------------------------------------------------------------
    def save_params(self, path):
        """Persist the model's parameters as an npz (uncompressed: fp32
        weights barely compress, and zlib on one core takes minutes at
        ViT-L's size), keyed by the state dict's names. On a mesh the whole tensors are gathered (every
        rank calls this) and rank 0 writes them, in the unsharded layout;
        the other ranks may pass None."""
        from splatt3r_slam_tpu_torch.parallel.mesh import (
            full_tensors,
            is_rank0,
        )

        sd = self.model.state_dict() if self.mesh is None \
            else full_tensors(self.model)
        if not is_rank0():
            return
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{
            k: v.detach().cpu().numpy() for k, v in sd.items()})

    def load_state_dict(self, sd: dict) -> list:
        """Load whole tensors in the unsharded layout into the model (on a
        mesh every rank passes the same ones); checked as
        `models/checkpoint.py::load_state_dict` checks them. Returns the
        ignored extra keys."""
        from splatt3r_slam_tpu_torch.models.checkpoint import load_state_dict
        from splatt3r_slam_tpu_torch.parallel.mesh import load_full_state_dict

        load = load_state_dict if self.mesh is None else load_full_state_dict
        return load(self.model, sd)

    def load_params(self, path):
        """Load an npz written by `save_params`, or one written by the JAX
        package's `Trainer.save_params` (flat flax keys joined by '/')."""
        from splatt3r_slam_tpu_torch.models.checkpoint import params_from_jax

        z = np.load(path)
        flat = {k: z[k] for k in z.files}
        if any("/" in k for k in flat):
            sd = params_from_jax(_unflatten(flat), self.model_cfg)
        else:
            sd = {k: torch.from_numpy(v) for k, v in flat.items()}
        self.load_state_dict(sd)

    # ------------------------------------------------------------------
    def fit(self, batches, *, run_dir, run_name="train", log_every=1,
            eval_every=0, eval_batches=None, trace_steps=None,
            verbose=False):
        """Minimal train loop with observability: CSV metrics, periodic
        eval rows (`val_*`), and an optional profiler window.

        batches: iterable of batch dicts; trace_steps: (start, stop) step
        range wrapped in a `torch.profiler` trace (chrome trace under
        run_dir/trace). Returns the CSV path."""
        from splatt3r_slam_tpu_torch.parallel.logging import (
            MetricsLogger,
            TraceWindow,
        )
        from splatt3r_slam_tpu_torch.parallel.mesh import mesh_shape

        step_fn = self.make_train_step()
        eval_fn = self.make_eval_step() if eval_every else None
        meta = {"model_cfg": self.model_cfg._asdict(),
                "train_cfg": self.cfg._asdict(),
                "device": str(self.device)}
        if self.mesh is not None:
            meta["mesh"] = mesh_shape(self.mesh)
        logger = MetricsLogger(run_dir, run_name, meta=meta)
        tracer = (TraceWindow(pathlib.Path(run_dir) / "trace", *trace_steps)
                  if trace_steps else None)
        try:
            for i, batch in enumerate(batches):
                if tracer is not None:
                    tracer.step(i)
                metrics = step_fn(batch)
                if i % log_every == 0:
                    logger.log(i, metrics)
                    if verbose:
                        print(f"step {i}: " + " ".join(
                            f"{k}={float(v):.4f}"
                            for k, v in metrics.items()))
                if eval_every and eval_batches and \
                        i % eval_every == eval_every - 1:
                    agg = {}
                    for eb in eval_batches:
                        emetrics, _rendered = eval_fn(eb)
                        for k, v in emetrics.items():
                            agg.setdefault(f"val_{k}", []).append(float(v))
                    logger.log(i, {k: sum(v) / len(v)
                                   for k, v in agg.items()})
        finally:
            if tracer is not None:
                tracer.close()
        return logger.path
