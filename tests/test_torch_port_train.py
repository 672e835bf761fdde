"""The port's trainer (parallel/trainer.py) against the JAX `Trainer`.

The tiny fp32 two-view model at 32x32 with k_max=64; one set of JAX
parameters goes to both packages through `params_from_jax`, and both get
the same numpy batch (the port's `synthetic_batches`, which draws in the
order of the root train.py). The JAX side is `jax.value_and_grad(
trainer.loss_fn)`, jitted once per loss recipe in a module-scoped fixture;
its gradient tree is carried to the port's parameter names by the same
key conversion as the weights (a relabelling and transposition, so it maps
gradients as it maps weights).

Tolerances: losses and metrics 1e-4 relative; gradients 1e-4 of each
tensor's largest entry (fp32 on both sides, sums in another order; the
random model's activations are large, hence relative). The render loss and
its gradients are held on identical predictions: predictions that differ
at 1e-5 can reorder a capped tile list through the 18-bit depth keys (see
tests/test_torch_port_slice.py), so the port's model output is replaced by
the JAX prediction values while its graph is kept, and the predictions
themselves are held at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.parallel import TrainConfig as JTrainConfig
from splatt3r_slam_tpu.parallel import Trainer as JTrainer
from splatt3r_slam_tpu.parallel.mesh import make_mesh
from splatt3r_slam_tpu_torch.models import TwoViewConfig
from splatt3r_slam_tpu_torch.models.checkpoint import (
    load_state_dict,
    params_from_jax,
)
from splatt3r_slam_tpu_torch.parallel import TrainConfig, Trainer
from splatt3r_slam_tpu_torch.splat import cuda_rasterizer as cr
from splatt3r_slam_tpu_torch.splat import rasterizer as t_rast
from splatt3r_slam_tpu_torch.train import synthetic_batches
from test_torch_port_bench import one_torch_thread  # noqa: F401

H = W = 32
CFG = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
RENDER = dict(render_loss=True, ssim_weight=0.1, mast3r_loss_weight=1.0,
              k_max=64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def world():
    """JAX parameters, one batch, the JAX predictions on it, and the JAX
    loss / metrics / gradients of both loss recipes."""
    jcfg = JConfig(dtype="float32", head_dtype="float32").tiny()
    mesh = make_mesh(1)
    batch = next(synthetic_batches(1, 1, H, W, True, seed=0,
                                   mask_coverage=0.3))
    out = {"batch": batch, "mesh": mesh, "jcfg": jcfg}
    for name, tc in (("regr3d", JTrainConfig(render_loss=False)),
                     ("render", JTrainConfig(**RENDER))):
        jt = JTrainer(jcfg, tc, mesh=mesh)
        if "params" not in out:
            out["params"] = jt.init_state(H, W)[0]
            preds = jax.jit(lambda p, a, b: jt.model.apply({"params": p}, a,
                                                           b))(
                out["params"], jnp.asarray(batch["img1"]),
                jnp.asarray(batch["img2"]))
            out["preds"] = _np_tree(preds)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jt.loss_fn, has_aux=True))(out["params"], _jbatch(batch))
        out[name] = (float(loss), {k: float(v) for k, v in metrics.items()},
                     params_from_jax(_np_tree(grads), CFG))
        out[name + "_trainer"] = jt
    out["state_dict"] = params_from_jax(_np_tree(out["params"]), CFG)
    return out


def _trainer(world, model_cfg=CFG, **kw):
    t = Trainer(model_cfg, TrainConfig(**kw), device="cpu")
    assert load_state_dict(t.model, world["state_dict"]) == []
    return t


class _Substitute(torch.autograd.Function):
    """Forward: the given values; backward: the gradient goes to `own`."""

    @staticmethod
    def forward(ctx, own, values):
        return values.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _use_jax_predictions(trainer, world, monkeypatch):
    """Make the port's model return the JAX prediction values, with its
    own graph behind them."""
    orig = trainer.model.forward

    def forward(img1, img2):
        return tuple(
            {k: _Substitute.apply(v, torch.from_numpy(np.array(jp[k])))
             for k, v in p.items()}
            for p, jp in zip(orig(img1, img2), world["preds"]))

    monkeypatch.setattr(trainer.model, "forward", forward)


def _grads(trainer):
    return {k: p.grad for k, p in trainer.model.named_parameters()}


def _close(got, want, name, rtol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=rtol * scale,
                               err_msg=name)


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) - v) <= 1e-4 * max(1.0, abs(v)), (
            k, float(got[k]), v)


def test_predictions_match(world):
    t = _trainer(world)
    with torch.no_grad():
        preds = t.model(torch.from_numpy(world["batch"]["img1"]),
                        torch.from_numpy(world["batch"]["img2"]))
    for p, jp in zip(preds, world["preds"]):
        assert set(p) == set(jp)
        for k in jp:
            _close(p[k].numpy(), jp[k], k)


def test_regr3d_loss_and_gradients(world):
    """(a) Regr3D-only loss: loss, metrics and the gradient of every
    parameter (encoder, decoder and heads; the gaussian DPTs get none from
    this loss in either package)."""
    j_loss, j_metrics, j_grads = world["regr3d"]
    t = _trainer(world, train_gaussian_heads_only=False)
    loss, metrics = t.loss_fn(world["batch"])
    assert abs(float(loss.detach()) - j_loss) <= 1e-4 * abs(j_loss)
    _check_metrics(metrics, j_metrics)
    loss.backward()
    grads = _grads(t)
    seen = set()
    for k, want in j_grads.items():
        if "gaussian_dpt" in k:
            assert not want.any() and (grads[k] is None
                                       or not grads[k].any()), k
        else:
            _close(grads[k].numpy(), want.numpy(), k)
            seen.add(k.split(".")[0])
    assert {"enc_blocks", "dec_blocks", "dec_blocks2", "downstream_head1",
            "downstream_head2", "patch_embed"} <= seen

    # with only the gaussian heads training this loss reaches no trainable
    # parameter: the step is a no-op, as the JAX optimiser's is
    t2 = _trainer(world)
    before = {k: v.clone() for k, v in t2.model.state_dict().items()}
    m = t2.make_train_step()(world["batch"])
    _check_metrics(m, j_metrics)
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("rasterizer", ["torch", "cuda"])
def test_render_loss_and_head_gradients(world, monkeypatch, rasterizer):
    """(b) Render loss (MSE + SSIM + Regr3D, masked) on identical
    predictions: loss, metrics and every gaussian-head gradient. "cuda"
    sends the CPU tensors through `Composite` (plain forward and backward),
    as the card's run does with the kernels."""
    j_loss, j_metrics, j_grads = world["render"]
    monkeypatch.setattr(t_rast, "default_rasterizer", lambda t: rasterizer)
    t = _trainer(world, **RENDER)
    _use_jax_predictions(t, world, monkeypatch)
    before = (cr.launches, cr.bwd_launches)
    loss, metrics = t.loss_fn(world["batch"])
    assert abs(float(loss) - j_loss) <= 1e-4 * abs(j_loss)
    _check_metrics(metrics, j_metrics)
    loss.backward()
    assert (cr.launches, cr.bwd_launches) == before
    grads = _grads(t)
    n = 0
    for k, want in j_grads.items():
        if "gaussian_dpt" in k:
            assert want.abs().max() > 0, k
            _close(grads[k].numpy(), want.numpy(), k)
            n += 1
        else:
            assert grads[k] is None, k  # frozen: no graph, no gradient
    assert n >= 40


def test_optimiser_step_moves_only_gaussian_heads(world):
    """(c) One step: frozen parameters are bit-identical, every gaussian
    DPT parameter moved, and the move is Adam's first step on the clipped
    gradient, lr·g/(|g|+eps), wherever |g| is well above eps."""
    lr, clip = 1e-3, 0.5
    t = _trainer(world, lr=lr, grad_clip_norm=clip, **RENDER)
    loss, _ = t.loss_fn(world["batch"])
    loss.backward()
    g = {k: p.grad.clone() for k, p in t.model.named_parameters()
         if p.grad is not None}
    t.optimizer.zero_grad(set_to_none=True)
    norm = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values()))
    coef = min(1.0, clip / (float(norm) + 1e-6))
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    m = t.make_train_step()(world["batch"])
    assert np.isfinite(float(m["loss"]))
    moved = 0
    for k, v in t.model.state_dict().items():
        if "gaussian_dpt" not in k:
            assert torch.equal(v, before[k]), k
            continue
        if k not in g:
            continue  # the unused refinenet4 residual unit
        gc = g[k] * coef
        big = gc.abs() > 1e-5
        assert big.any(), k
        want = before[k] - lr * gc / (gc.abs() + 1e-8)
        # fp32 parameters near 1: the update lr=1e-3 is resolved to ~1e-7
        np.testing.assert_allclose(v[big].numpy(), want[big].numpy(),
                                   atol=1e-6, err_msg=k)
        moved += 1
    assert moved >= 40


def test_grad_clip_global_norm(world):
    """(d) The clip rescales the trainable gradients to the global-norm
    ceiling before Adam sees them: after one step the first moment
    (1-b1)·g_effective has global norm 0.1·clip with the clip, 0.1·‖g‖
    without (the bar of tests/test_parallel.py::test_grad_clip_global_norm),
    and equals the JAX optimiser's first moment on the same gradients."""
    j_grads = world["regr3d"][2]

    def mu_norm(clip):
        t = _trainer(world, train_gaussian_heads_only=False,
                     grad_clip_norm=clip)
        t.make_train_step()(world["batch"])
        sq = sum(float((s["exp_avg"].double() ** 2).sum())
                 for s in t.optimizer.state.values())
        return np.sqrt(sq)

    raw = np.sqrt(sum(float((v.double() ** 2).sum())
                      for v in j_grads.values()))
    assert raw > 0.5
    # torch's clip divides by (norm + 1e-6): 1e-5 relative covers it
    np.testing.assert_allclose(mu_norm(0.5), 0.1 * 0.5, rtol=1e-5)
    np.testing.assert_allclose(mu_norm(0.0), 0.1 * raw, rtol=1e-4)


def test_grad_accum_matches_single_step(world):
    """(d) accum_steps=2 on two copies of a micro-batch == one step on the
    batch of twice the size made of those copies == one plain step on the
    micro-batch; parameters do not move before the second micro-batch."""
    kw = dict(train_gaussian_heads_only=False, lr=1e-3)
    micro = {k: v for k, v in world["batch"].items()}
    double = {k: np.concatenate([v, v]) for k, v in micro.items()}

    def first_moment(t):
        return {k: t.optimizer.state[p]["exp_avg"]
                for k, p in t.model.named_parameters()
                if p in t.optimizer.state}

    t1 = _trainer(world, **kw)
    t1.make_train_step()(micro)
    tb = _trainer(world, **kw)
    tb.make_train_step()(double)

    t2 = _trainer(world, accum_steps=2, **kw)
    before = {k: v.clone() for k, v in t2.model.state_dict().items()}
    step = t2.make_train_step()
    step(micro)
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not t2.optimizer.state
    step(micro)
    m1, mb, m2 = first_moment(t1), first_moment(tb), first_moment(t2)
    assert len(m2) == len(m1) > 100
    for k in m1:
        # the mean of two equal gradients is the gradient (exact in fp32);
        # the doubled batch sums twice as many terms in another order
        assert torch.equal(m2[k], m1[k]), k
        _close(mb[k].numpy(), m1[k].numpy(), k)
    for (k, a), b in zip(t1.model.state_dict().items(),
                         t2.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_lr_schedule_and_weight_decay(world):
    """MultiStepLR drops the rate by gamma after the milestone's step, and
    weight decay is coupled (added to the clipped gradient before Adam)."""
    t = _trainer(world, lr=1e-3, lr_milestones=(2,), lr_gamma=0.1,
                 weight_decay=0.01, **RENDER)
    step = t.make_train_step()
    rates = []
    for _ in range(3):
        rates.append(t.optimizer.param_groups[0]["lr"])
        step(world["batch"])
    np.testing.assert_allclose(rates, [1e-3, 1e-3, 1e-4])
    assert t.optimizer.param_groups[0]["weight_decay"] == 0.01
    assert type(t.optimizer) is torch.optim.Adam


def test_remat_same_loss_and_gradients(world, monkeypatch):
    """(e) remat=True recomputes each encoder/decoder block in the
    backward pass: the same loss and gradients, the same parameter names.
    Every block goes through torch.utils.checkpoint when the trunk trains,
    and none does when only the gaussian heads train."""
    from splatt3r_slam_tpu_torch.models import two_view

    calls = []
    real = two_view.checkpoint
    monkeypatch.setattr(two_view, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = []
    for remat in (False, True):
        t = _trainer(world, model_cfg=CFG._replace(remat=remat),
                     train_gaussian_heads_only=False, **RENDER)
        loss, _ = t.loss_fn(world["batch"])
        loss.backward()
        out.append((float(loss), _grads(t)))
        # two encodes of enc_depth blocks, and two decoder stacks
        assert len(calls) == (2 * CFG.enc_depth + 2 * CFG.dec_depth
                              if remat else 0)
    _trainer(world, model_cfg=CFG._replace(remat=True),
             **RENDER).loss_fn(world["batch"])
    assert len(calls) == 2 * CFG.enc_depth + 2 * CFG.dec_depth
    assert out[0][0] == out[1][0]
    assert set(out[0][1]) == set(out[1][1])
    n = 0
    for k, g in out[0][1].items():
        if g is None:
            assert out[1][1][k] is None
            continue
        # the recomputed forward is the same fp32 program: 1e-6 of peak
        _close(out[1][1][k].numpy(), g.numpy(), k, rtol=1e-6)
        n += 1
    assert n > 100


@pytest.mark.parametrize("apply_mask,average_over_mask",
                         [(True, False), (True, True)])
def test_eval_step_matches_jax(world, monkeypatch, apply_mask,
                               average_over_mask):
    """(f) `make_eval_step` under both masking configurations of the test
    sweep: the same metric dict (LPIPS NaN without a VGG tree) and render,
    on identical predictions."""
    jt = world["render_trainer"]
    want, j_rendered = jt.make_eval_step(
        apply_mask=apply_mask, average_over_mask=average_over_mask)(
        world["params"], _jbatch(world["batch"]))
    t = _trainer(world, **RENDER)
    _use_jax_predictions(t, world, monkeypatch)
    got, rendered = t.make_eval_step(
        apply_mask=apply_mask, average_over_mask=average_over_mask)(
        world["batch"])
    assert set(got) == set(want) == {"mse", "psnr", "ssim", "lpips"}
    assert np.isnan(float(got["lpips"])) and np.isnan(float(want["lpips"]))
    for k in ("mse", "psnr", "ssim"):
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-4 * max(1.0, abs(w)), k
    # the compositor bar of tests/test_pallas_rasterizer.py
    np.testing.assert_allclose(rendered.numpy(), np.asarray(j_rendered),
                               atol=2e-3)


def test_lpips_term_in_loss_and_eval(world, monkeypatch):
    """With a VGG tree the loss gains the LPIPS term (masked: the spatial
    map averaged over the loss mask), as the JAX trainer's does."""
    from splatt3r_slam_tpu.utils import lpips as j_lpips
    from splatt3r_slam_tpu_torch.utils import lpips as t_lpips

    jp = j_lpips.random_params(1, channel_scale=16)
    kw = dict(render_loss=True, lpips_weight=0.5, k_max=64)
    jt = JTrainer(world["jcfg"], JTrainConfig(**kw), mesh=world["mesh"],
                  lpips_params=jp)
    j_loss, j_metrics = jax.jit(jt.loss_fn)(world["params"],
                                            _jbatch(world["batch"]))
    t = Trainer(CFG, TrainConfig(**kw), device="cpu",
                lpips_params=t_lpips.params_from_hwio(jp))
    load_state_dict(t.model, world["state_dict"])
    _use_jax_predictions(t, world, monkeypatch)
    loss, metrics = t.loss_fn(world["batch"])
    assert "lpips" in metrics and float(metrics["lpips"]) > 0
    _check_metrics(metrics, {k: float(v) for k, v in j_metrics.items()})
    assert abs(float(loss) - float(j_loss)) <= 1e-4 * abs(float(j_loss))


def test_save_load_params_and_jax_resume(world, tmp_path):
    """(g) save_params → load_params round-trips, and load_params reads an
    npz the JAX `Trainer.save_params` wrote (flat flax keys joined by /)."""
    t = _trainer(world)
    t.save_params(tmp_path / "own.npz")
    t2 = Trainer(CFG, TrainConfig(), device="cpu", seed=9)
    assert not torch.equal(t2.model.state_dict()["enc_norm.bias"] + 1,
                           t.model.state_dict()["enc_norm.bias"])
    some = "downstream_head1.gaussian_dpt.dpt.head.4.weight"
    assert not torch.equal(t2.model.state_dict()[some],
                           t.model.state_dict()[some])
    t2.load_params(tmp_path / "own.npz")
    for (k, a), b in zip(t.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), k

    JTrainer.save_params(tmp_path / "jax.npz", world["params"])
    assert any("/" in k for k in np.load(tmp_path / "jax.npz").files)
    t3 = Trainer(CFG, TrainConfig(), device="cpu", seed=9)
    t3.load_params(tmp_path / "jax.npz")
    sd = t3.model.state_dict()
    for k, v in world["state_dict"].items():
        assert torch.equal(sd[k], v), k


def test_bf16_heads_reach_fp32_master_weights(world):
    """The production profile runs trunk and heads in bf16 while parameters
    stay fp32: the render loss's gradient must arrive at the fp32 gaussian
    DPT weights through each layer's per-call bf16 cast."""
    cfg = TwoViewConfig().tiny()
    assert cfg.dtype == cfg.head_dtype == "bfloat16"
    t = Trainer(cfg, TrainConfig(**RENDER), device="cpu")
    loss, _ = t.loss_fn(world["batch"])
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    loss.backward()
    n = 0
    for k, p in t.model.named_parameters():
        assert p.dtype == torch.float32, k
        if "gaussian_dpt" in k and p.grad is not None:
            assert p.grad.dtype == torch.float32
            assert torch.isfinite(p.grad).all(), k
            n += bool(p.grad.any())
        elif "gaussian_dpt" not in k:
            assert p.grad is None, k
    assert n >= 40


def test_trainer_defaults_and_device():
    """TrainConfig carries the JAX package's fields and defaults; the
    trainer defaults to CUDA and raises without a GPU."""
    assert TrainConfig._fields == JTrainConfig._fields
    assert TrainConfig() == tuple(JTrainConfig())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(CFG, TrainConfig())
