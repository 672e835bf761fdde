"""Rank functions and inputs for the port's multi-rank tests.

Kept apart from the test files because each rank is a process started
with spawn, which imports the module of the function it runs: this one
imports torch and the port, never jax.

Renders are compared on identical predictions. The tiny random model puts
about 500 gaussians in each 16x16 tile and the trainer keeps the nearest
k_max (64) of them, so a prediction that moves by rounding (another batch
split, a tensor-parallel sum, the other package) can change which
gaussians a tile keeps and so its colour. `substitute_forward` makes the
model return given prediction values while the gradient still flows
through its own graph, as tests/test_torch_port_train.py does; the
predictions themselves are held separately.
"""

from __future__ import annotations

import numpy as np
import torch

H = W = 32
LR = 1e-3


def uneven_batch(B: int, seed: int) -> dict:
    """A render-loss batch whose rows differ in their valid pixel counts
    and loss-mask areas, so that a mean of per-row losses is not the
    global batch's."""
    from splatt3r_slam_tpu_torch.train import synthetic_batches

    b = next(synthetic_batches(1, B, H, W, True, seed=seed))
    rng = np.random.default_rng(seed + 100)
    b["valid1"] = rng.random((B, H, W)) < np.linspace(
        0.2, 0.9, B)[:, None, None]
    b["valid2"] = rng.random((B, H, W)) < np.linspace(
        0.8, 0.3, B)[:, None, None]
    mask = np.zeros((B, 1, H, W), np.float32)
    for i in range(B):
        mask[i, :, :4 + 7 * i] = 1.0
    b["loss_mask"] = mask
    return b


def train_config(**kw):
    from splatt3r_slam_tpu_torch.parallel import TrainConfig

    return TrainConfig(render_loss=True, ssim_weight=0.1,
                       mast3r_loss_weight=1.0, lpips_weight=0.25, k_max=64,
                       lr=LR, **kw)


def make_trainer(tcfg, mesh=None):
    from splatt3r_slam_tpu_torch.models import TwoViewConfig
    from splatt3r_slam_tpu_torch.parallel import Trainer
    from splatt3r_slam_tpu_torch.utils.lpips import random_params

    return Trainer(TwoViewConfig(dtype="float32", head_dtype="float32")
                   .tiny(), tcfg, device="cpu", mesh=mesh,
                   lpips_params=random_params(channel_scale=16))


class _Substitute(torch.autograd.Function):
    """Forward: the given values; backward: the gradient goes to `own`."""

    @staticmethod
    def forward(ctx, own, values):
        return values.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def substitute_forward(calls):
    """Make every `Splatt3RModel` return, on its i-th forward, the
    prediction values calls[i] ((res1, res2) of numpy dicts), with its own
    graph behind them; its own outputs are kept in the returned list."""
    from splatt3r_slam_tpu_torch.models.two_view import Splatt3RModel

    orig = Splatt3RModel.forward
    own_outputs = []

    def forward(self, img1, img2):
        own = orig(self, img1, img2)
        own_outputs.append(own)
        vals = calls[len(own_outputs) - 1]
        return tuple({k: _Substitute.apply(v, torch.from_numpy(
            np.ascontiguousarray(w[k]))) for k, v in p.items()}
            for p, w in zip(own, vals))

    Splatt3RModel.forward = forward
    return own_outputs


def _numpy(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def run_steps(trainer, batches) -> dict:
    """A loss and its gradient on batches[0] (taken apart from the step),
    then two training steps on batches[0] and batches[1]: the metrics,
    the whole gradients and the whole parameters after the steps."""
    from splatt3r_slam_tpu_torch.parallel.mesh import full_tensors

    loss, metrics = trainer.loss_fn(batches[0])
    loss.backward()
    grads = full_tensors(trainer.model, grads=True)
    trainer.optimizer.zero_grad(set_to_none=True)
    step = trainer.make_train_step()
    for b in batches:
        step(b)
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": _numpy(grads),
            "params": _numpy(full_tensors(trainer.model))}


def _recording(fn):
    """→ (fn(), the predictions (numpy) of every `Splatt3RModel` forward
    that fn ran)."""
    from splatt3r_slam_tpu_torch.models.two_view import Splatt3RModel

    orig = Splatt3RModel.forward
    preds = []

    def forward(self, img1, img2):
        out = orig(self, img1, img2)
        preds.append(tuple(_numpy(p) for p in out))
        return out

    Splatt3RModel.forward = forward
    try:
        return fn(), preds
    finally:
        Splatt3RModel.forward = orig


def reference_run(tcfg_kw, batches) -> dict:
    """`run_steps` on one process with the whole batch; also records the
    model's predictions on each forward (numpy)."""
    out, preds = _recording(lambda: run_steps(
        make_trainer(train_config(**tcfg_kw)), batches))
    out["preds"] = preds
    return out


def _eval(trainer, batch):
    """The masked eval protocol's step: (metrics as floats, rendered)."""
    m, rendered = trainer.make_eval_step(apply_mask=True,
                                         average_over_mask=True)(batch)
    return {k: float(v) for k, v in m.items()}, rendered.numpy()


def reference_eval(batch):
    """→ ((metrics, rendered), predictions) of the one-process eval step
    on the whole batch."""
    (res, (preds,)) = _recording(lambda: _eval(
        make_trainer(train_config()), batch))
    return res, preds


def eval_rank(rank, world, init_method, fsdp, tp, batch, preds):
    """The eval step on a (dp, fsdp, tp) mesh: every rank runs the whole
    batch, its forward returning the reference's predictions `preds`.
    → ((metrics, rendered), this rank's own predictions)."""
    from splatt3r_slam_tpu_torch.parallel.mesh import (
        make_mesh,
        process_group,
    )

    torch.set_num_threads(1)
    with process_group(rank, world, init_method, "cpu"):
        own = substitute_forward([preds])
        res = _eval(make_trainer(train_config(), make_mesh(
            world, fsdp=fsdp, tp=tp)), batch)
        return res, tuple(_numpy(p) for p in own[0])


def mesh_rank(rank, world, init_method, fsdp, tp, tcfg_kw, batches,
              preds):
    """One rank of `run_steps` on a (dp, fsdp, tp) mesh over gloo, its
    forwards returning its rows of the reference's predictions `preds`.
    Rank 0 also returns its own predictions of the first forward."""
    from splatt3r_slam_tpu_torch.parallel.mesh import (
        batch_rows,
        make_mesh,
        process_group,
    )

    torch.set_num_threads(1)
    with process_group(rank, world, init_method, "cpu"):
        mesh = make_mesh(world, fsdp=fsdp, tp=tp)
        own = substitute_forward([
            tuple(batch_rows(p, mesh) for p in call) for call in preds])
        out = run_steps(make_trainer(train_config(**tcfg_kw), mesh),
                        batches)
        out["own_preds"] = tuple(_numpy(p) for p in own[0])
        return out


def substituted_dryrun_rank(preds, rank, world, init_method, *args):
    """`parallel/dryrun.py::_rank_step` with the model's forward returning
    this rank's rows of `preds` ((res1, res2) numpy dicts of the global
    batch of `world` rows); `args` as `_rank_step` takes them (the third
    is tp). Rank 0 also returns its own predictions and the whole
    parameters after the step."""
    from splatt3r_slam_tpu_torch.parallel import Trainer, dryrun
    from splatt3r_slam_tpu_torch.parallel.mesh import full_tensors

    torch.set_num_threads(1)
    tp = args[2]
    r = tp  # rows per data rank: world rows over world / tp data ranks
    i = rank // tp  # ranks are laid out (dp, fsdp, tp), row-major
    own = substitute_forward([tuple({k: v[i * r:(i + 1) * r] for k, v in
                                     p.items()} for p in preds)])
    after = {}
    make = Trainer.make_train_step

    def make_train_step(self):
        step = make(self)

        def kept(batch):
            metrics = step(batch)
            after["params"] = _numpy(full_tensors(self.model))
            return metrics

        return kept

    Trainer.make_train_step = make_train_step
    out = dryrun._rank_step(rank, world, init_method, *args)
    out["own_preds"] = tuple(_numpy(p) for p in own[0])
    out["params"] = after["params"]
    return out
