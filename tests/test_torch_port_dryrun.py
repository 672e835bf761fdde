"""The port's sharded dry run and integration entry points
(parallel/dryrun.py, graft_entry.py) against the JAX package's.

The JAX step is built as `splatt3r_slam_tpu/parallel/dryrun.py` builds
it, on the 8 virtual CPU devices of tests/conftest.py, and its initial
parameters are kept (with the gaussian heads' last biases drawn, see the
test); the port's `full_loss_train_step(8, device="cpu")`
gets the same parameters (`params_from_jax`) and the same batch, on 8
gloo processes. Both packages take their renders from the same prediction
values, the JAX ones of the initial parameters, with each package's own
graph behind them (tests/torch_dist_helpers.py says why): in the JAX step
through `value + (own - stop_gradient(own))`, in the port's ranks
through `torch_dist_helpers.substituted_dryrun_rank`; the JAX renderer
takes its gaussians in depth order. Metrics agree within
1e-4 relative (1e-4 absolute below 1), the tolerance
tests/test_torch_port_train.py holds the single-device step to. The
weights are held too: rank 0's own predictions, those of the JAX weights
loaded into the tensor-parallel model, agree with the JAX model's within
1e-4 of each output's peak, and every parameter after the step is the
JAX step's within 2·lr and 99.9% of them within 0.01·lr (Adam moves an
entry by about lr, in the sign of its gradient), as
tests/test_torch_port_parallel.py holds the mesh step to the
single-process one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as dh
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.parallel import TrainConfig as JTrainConfig
from splatt3r_slam_tpu.parallel import Trainer as JTrainer
from splatt3r_slam_tpu.parallel.dryrun import pick_mesh_shape as j_pick
from splatt3r_slam_tpu.parallel.mesh import batch_sharding, make_mesh
from splatt3r_slam_tpu.utils.lpips import random_params as j_lpips_random
from splatt3r_slam_tpu_torch import graft_entry
from splatt3r_slam_tpu_torch.models import TwoViewConfig
from splatt3r_slam_tpu_torch.models.checkpoint import params_from_jax
from splatt3r_slam_tpu_torch.parallel import TrainConfig, dryrun
from test_torch_port_bench import one_torch_thread  # noqa: F401

CFG = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
LR = TrainConfig().lr  # the dry run's, in both packages


class _FixedPredictions:
    """A flax model whose apply returns given prediction values, its own
    graph behind them."""

    def __init__(self, model, preds):
        self.model, self.preds = model, preds

    def apply(self, variables, img1, img2):
        own = self.model.apply(variables, img1, img2)
        return tuple({k: jnp.asarray(p[k]) + (o[k] - jax.lax.stop_gradient(
            o[k])) for k in o} for o, p in zip(own, self.preds))


def _depth_ordered_jax_render(monkeypatch):
    """Hand the JAX tile renderer the gaussians in depth order, as
    tests/test_torch_port_slice.py does: the random model's 18-bit depth
    keys tie and composite in index order in the JAX package, in exact
    depth order in the port (ROADMAP's standing differences)."""
    from splatt3r_slam_tpu.splat import decoder as jdec
    from splatt3r_slam_tpu.splat import rasterizer as jr

    def render_tiles(means, covs, cols, opas, view, K, hw, *a, **kw):
        _, _, depth, _, ok = jr.project_gaussians(means, covs, opas, view, K,
                                                  hw)
        o = jnp.argsort(jnp.where(ok, depth, jnp.inf), stable=True)
        return jr.render_tiles(means[o], covs[o], cols[o], opas[o], view, K,
                               hw, *a, **kw)

    monkeypatch.setattr(jdec, "render_tiles", render_tiles)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_full_loss_step_matches_jax(monkeypatch):
    _depth_ordered_jax_render(monkeypatch)
    n = 8
    mesh = make_mesh(n, fsdp=2, tp=2)
    jcfg = JConfig(dtype="float32", head_dtype="float32").tiny()
    jt = JTrainer(jcfg, JTrainConfig(
        train_gaussian_heads_only=False, render_loss=True, ssim_weight=0.1,
        lpips_weight=0.25, mast3r_loss_weight=0.1, k_max=32), mesh=mesh,
        lpips_params=j_lpips_random(channel_scale=16))
    params, opt_state, pshard = jt.init_state(32, 48)
    # copies: the step donates the parameters' buffers. The gaussian
    # heads' last biases are drawn instead of zero: at zero, two pixels of
    # head2 give a quaternion of exactly 0, where the JAX package's
    # gradient is NaN (test_zero_quaternion_gradient) and its clipped step
    # turns every parameter NaN
    np_params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(1)
    for head in ("head1", "head2"):
        bias = np_params[head]["gaussian_dpt"]["head_4"]["bias"]
        bias[...] = rng.normal(0.0, 0.1, bias.shape)
    params = jax.device_put(np_params, pshard)
    batch = dryrun.dryrun_batch(n, 32, 48, 1)
    preds = jax.tree.map(np.asarray, jax.jit(jt.model.apply)(
        {"params": np_params}, jnp.asarray(batch["img1"]),
        jnp.asarray(batch["img2"])))  # on one device
    jt.model = _FixedPredictions(jt.model, preds)
    step = jt.make_train_step(pshard)
    new_params, _, jm = step(params, opt_state, jax.device_put(
        {k: jnp.asarray(v) for k, v in batch.items()},
        batch_sharding(mesh)))
    want = {k: float(v) for k, v in jm.items()}
    want_params = params_from_jax(jax.tree.map(np.asarray, new_params),
                                  CFG)

    monkeypatch.setattr(dryrun, "_rank_step", functools.partial(
        dh.substituted_dryrun_rank, preds))
    got = dryrun.full_loss_train_step(n, device="cpu", params=np_params)
    start = params_from_jax(np_params, CFG)
    got_preds, got_params = got.pop("own_preds"), got.pop("params")
    assert got.pop("mesh") == dict(mesh.shape) == {"dp": 2, "fsdp": 2,
                                                   "tp": 2}
    assert set(got) == set(want) == {"loss", "mse", "ssim", "lpips",
                                     "regr3d"}
    bad = {k: (got[k], w) for k, w in want.items()
           if abs(got[k] - w) > 1e-4 * max(1.0, abs(w))}
    assert not bad, (got, want)

    # the JAX weights as the tp=2 model holds them: its forward, and the
    # weights after the step
    for own, ref in zip(got_preds, preds):
        for k, w in ref.items():  # rank 0 holds rows 0-1
            w = np.asarray(w)[:2]
            assert np.abs(own[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    unused = {k for k in got_params if k not in want_params}
    assert unused and all("refinenet4.resConfUnit1." in k for k in unused)
    diff = np.concatenate([np.abs(v - np.asarray(want_params[k])).ravel()
                           for k, v in got_params.items()
                           if k not in unused])
    assert diff.max() <= 2 * LR, diff.max()
    assert np.mean(diff <= 0.01 * LR) >= 0.999
    # the step moved every tensor but the descriptor MLPs, which no term
    # of the loss reaches
    still = {k for k, v in got_params.items() if k not in unused
             and np.abs(v - np.asarray(start[k])).max() < 0.5 * LR}
    assert still and all("head_local_features" in k for k in still), still


def test_zero_quaternion_gradient():
    """A standing difference: at a raw quaternion of exactly 0 the JAX
    package's rotation normalisation has a NaN gradient (jnp.linalg.norm's
    at 0), the port's a finite one (torch.linalg.norm's is 0 there)."""
    from splatt3r_slam_tpu.models.heads import reg_dense_rotation as j_rot
    from splatt3r_slam_tpu_torch.models.heads import reg_dense_rotation

    q = np.array([[0.0, 0.0, 0.0, 0.0], [0.3, -0.2, 0.5, 0.1]], np.float32)
    w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    jg = np.asarray(jax.grad(lambda x: (j_rot(x) * w).sum())(jnp.asarray(q)))
    t = torch.tensor(q, requires_grad=True)
    (reg_dense_rotation(t) * torch.from_numpy(w)).sum().backward()
    tg = t.grad.numpy()
    assert np.isnan(jg[0]).all() and np.isfinite(tg[0]).all()
    np.testing.assert_allclose(tg[1], jg[1], rtol=1e-5)


def test_pick_mesh_shape_is_jax():
    for n in (1, 2, 3, 4, 6, 8, 16):
        assert dryrun.pick_mesh_shape(n) == j_pick(n)


def test_entry_forward_shapes():
    cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    fn, args = graft_entry.entry(device="cpu", cfg=cfg)
    assert [tuple(a.shape) for a in args] == [(1, 384, 512, 3)] * 2
    res1, res2 = fn(*args)
    for res in (res1, res2):
        assert tuple(res["pts3d"].shape) == (1, 384, 512, 3)
        assert tuple(res["conf"].shape) == (1, 384, 512)
        assert torch.isfinite(res["pts3d"]).all()
        assert not res["pts3d"].requires_grad


def test_dryrun_multichip_two_ranks(capsys):
    m = graft_entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): loss ")
    assert m["mesh"] == {"dp": 1, "fsdp": 2, "tp": 1}
    for k in ("loss", "mse", "ssim", "lpips", "regr3d"):
        assert np.isfinite(m[k]), (k, m)
        assert f"{k} {m[k]:.4f}" in line
    assert m["loss"] != m["regr3d"]  # every term is live


def test_cuda_entry_points_raise_without_gpus():
    """On CUDA without a GPU both entry points raise; nothing runs on the
    CPU instead, and nothing is retried."""
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)
