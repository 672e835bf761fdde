"""Port matching (ops/) and Sim(3) tracking (tracking/) against the JAX
package on the same seeded numpy inputs (CPU, fp32).

Tolerances and reasons:
- ray gradients, pinhole fit, the LM step: 1e-5 (same fp32 closed forms,
  different reduction order);
- integer matches: exact where the scores have no near-ties; on the full
  pipeline ≥ 99.5% of indices agree, because a score that differs in its
  last bit between the two frameworks' reductions can flip an argmax or an
  LM accept decision;
- GN poses: 2e-4, the fused-vs-modular bar of tests/test_fused.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.ops import image as jimg
from splatt3r_slam_tpu.ops import matching as jm
from splatt3r_slam_tpu.runtime.fused import unique_match_count as j_unique
from splatt3r_slam_tpu.tracking import tracker as jt
from splatt3r_slam_tpu_torch.config import DEFAULTS
from splatt3r_slam_tpu_torch.ops import image as timg
from splatt3r_slam_tpu_torch.ops import matching as tm
from splatt3r_slam_tpu_torch.runtime.fused import unique_match_count as t_unique
from splatt3r_slam_tpu_torch.tracking import tracker as tt
from test_torch_port_bench import one_torch_thread  # noqa: F401

H, W = 24, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _pointmaps(rng, b=1, shift=(1.3, -0.7)):
    """Smooth pointmap X11 and the same surface seen at a sub-pixel shift
    (X21), plus smooth unit descriptors for both."""
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")

    def surf(u, v, phase):
        z = 2.0 + 0.3 * np.sin(u / 7.0 + phase) + 0.2 * np.cos(v / 5.0)
        return np.stack([(u - W / 2) / 30.0 * z, (v - H / 2) / 30.0 * z, z],
                        -1)

    X11 = np.stack([surf(uu, vv, i) for i in range(b)]).astype(np.float32)
    X21 = np.stack([surf(uu + shift[0], vv + shift[1], i)
                    for i in range(b)]).astype(np.float32)
    basis = rng.normal(size=(6, 16)).astype(np.float32)

    def desc(u, v):
        f = np.stack([np.sin(u / 3.0), np.cos(v / 4.0), np.sin((u + v) / 5.0),
                      np.cos(u / 2.0 - v / 3.0), u / W, v / H], -1)
        d = f @ basis
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    D11 = np.broadcast_to(desc(uu, vv), (b, H, W, 16)).astype(np.float32)
    D21 = np.broadcast_to(desc(uu + shift[0], vv + shift[1]),
                          (b, H, W, 16)).astype(np.float32)
    return X11, X21, np.ascontiguousarray(D11), np.ascontiguousarray(D21)


def test_gradients_and_rays(rng):
    X11, *_ = _pointmaps(rng)
    gx, gy = jimg.img_gradient(jnp.asarray(X11))
    tx, ty = timg.img_gradient(_t(X11))
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(gy), atol=1e-5)
    np.testing.assert_allclose(tm.prep_rays_with_grad(_t(X11)).numpy(),
                               np.asarray(jm.prep_rays_with_grad(
                                   jnp.asarray(X11))), atol=1e-5)


def test_fit_pinhole(rng):
    X11, *_ = _pointmaps(rng, b=2)
    want = [np.asarray(jm.fit_pinhole(jnp.asarray(x))) for x in X11]
    got = tm.fit_pinhole(_t(X11))
    for i in range(2):
        # fp32 sums over 768 pixels, in another order
        np.testing.assert_allclose([g[i].item() for g in got], want[i],
                                   rtol=1e-4)


def test_iter_proj(rng):
    X11, X21, _, _ = _pointmaps(rng)
    rays = jm.prep_rays_with_grad(jnp.asarray(X11))
    pn = X21.reshape(1, -1, 3)
    pn = pn / np.linalg.norm(pn, axis=-1, keepdims=True)
    p0 = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(
        1, -1, 2).astype(np.float32)
    jp, jc = jm.iter_proj(rays, jnp.asarray(pn), jnp.asarray(p0), 10, 1e-8,
                          1e-6)
    tp, tc = tm.iter_proj(_t(np.asarray(rays)), _t(pn), _t(p0), 10, 1e-8,
                          1e-6)
    agree = (tc.numpy() == np.asarray(jc)).mean()
    assert agree > 0.995, agree
    close = np.isclose(tp.numpy(), np.asarray(jp), atol=1e-3).all(-1).mean()
    assert close > 0.995, close


@pytest.mark.parametrize("case", ["nan_start", "overflow_step"])
def test_iter_proj_nan_coordinates(rng, case):
    """A NaN coordinate (a NaN start, or an LM step whose normal equations
    overflow to inf - inf) samples NaN and is rejected, as in the JAX
    package, where the port once raised on the gather's index."""
    X11, X21, _, _ = _pointmaps(rng)
    rays = np.array(jm.prep_rays_with_grad(jnp.asarray(X11)))
    pn = X21.reshape(1, -1, 3)
    pn = pn / np.linalg.norm(pn, axis=-1, keepdims=True)
    p0 = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(
        1, -1, 2).astype(np.float32)
    if case == "nan_start":
        p0[0, ::7, 0] = np.nan
    else:
        rays[0, 5:9, 10:14, 3:9] = 1e30
    jp, jc = jm.iter_proj(jnp.asarray(rays), jnp.asarray(pn),
                          jnp.asarray(p0), 10, 1e-8, 1e-6)
    tp, tc = tm.iter_proj(_t(rays), _t(pn), _t(p0), 10, 1e-8, 1e-6)
    jp, jc = np.asarray(jp), np.asarray(jc)
    assert np.isnan(jp).any() == (case == "nan_start")
    np.testing.assert_array_equal(np.isnan(tp.numpy()), np.isnan(jp))
    agree = (tc.numpy() == jc).mean()
    assert agree > 0.995, agree
    ok = ~np.isnan(jp).any(-1)
    close = np.isclose(tp.numpy()[ok], jp[ok], atol=1e-3).all(-1).mean()
    assert close > 0.995, close


def test_bilinear_gather(rng):
    img = rng.normal(size=(H, W, 9)).astype(np.float32)
    u = (1 + rng.random(50) * (W - 3)).astype(np.float32)
    v = (1 + rng.random(50) * (H - 3)).astype(np.float32)
    want = jm._bilinear_gather(jm._corner_table(jnp.asarray(img)),
                               jnp.asarray(u), jnp.asarray(v), W, 9)
    got = tm._bilinear_gather(tm._corner_table(_t(img[None])), _t(u[None]),
                              _t(v[None]), W, 9)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("quantize", [True, False])
def test_refine_matches_with_ties(rng, quantize):
    """Exact indices, including windows whose best score is tied (argmax
    takes the first index in both frameworks)."""
    D11 = rng.normal(size=(1, H, W, 8)).astype(np.float32)
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    D11[0, 5:12, 5:12] = D11[0, 8, 8]  # a 7x7 block of equal descriptors
    n = 40
    p1 = np.stack([rng.integers(1, W - 1, n), rng.integers(1, H - 1, n)],
                  -1).astype(np.int32)[None]
    p1[0, :5] = [[8, 8], [7, 9], [10, 6], [6, 11], [9, 9]]
    D21 = D11[0, p1[0, :, 1], p1[0, :, 0]][None]
    want = jm.refine_matches(jnp.asarray(D11), jnp.asarray(D21),
                             jnp.asarray(p1), 3, 5, schedule=(5, 1),
                             quantize=quantize)
    got = tm.refine_matches(_t(D11), _t(D21), _t(p1), 3, 5, schedule=(5, 1),
                            quantize=quantize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fast", [True, False])
def test_match_pipeline(rng, fast):
    X11, X21, D11, D21 = _pointmaps(rng)
    kw = jm.match_kwargs_from_config(DEFAULTS["matching"]) if fast else {}
    assert kw == tm.match_kwargs_from_config(DEFAULTS["matching"]) or not fast
    ji, jv = jm.match(*(jnp.asarray(a) for a in (X11, X21, D11, D21)), **kw)
    ti, tv = tm.match(*(_t(a) for a in (X11, X21, D11, D21)), **kw)
    assert (ti.numpy() == np.asarray(ji)).mean() > 0.995
    assert (tv.numpy() == np.asarray(jv)).mean() > 0.995
    assert np.asarray(jv).mean() > 0.3  # the test exercises real matches


def test_unique_match_count_overflow_slot(rng):
    """Invalid matches go to an overflow slot, so index 0 is not
    miscounted (the case of tests/test_fused.py)."""
    ns = 64
    for _ in range(10):
        idx = rng.integers(0, ns, size=ns).astype(np.int64)
        valid = rng.random(ns) < 0.6
        idx[:3] = 0
        want = int(j_unique(jnp.asarray(idx), jnp.asarray(valid), ns))
        assert int(t_unique(_t(idx), _t(valid), ns)) == want \
            == len(np.unique(idx[valid]))
    idx = np.array([0, 0, 0, 0, 1, 2, 2, 3])
    valid = np.array([True, True, False, False, True, False, True, True])
    assert int(t_unique(_t(idx), _t(valid), 8)) == 4


def _gn_problem(rng, n=500, noise=1e-3):
    Xk = rng.normal(size=(n, 3)).astype(np.float32)
    Xk[:, 2] = np.abs(Xk[:, 2]) + 2.0
    xi = np.array([0.05, -0.03, 0.02, 0.01, -0.02, 0.015, 0.02], np.float32)
    from splatt3r_slam_tpu.lie import sim3 as js

    T_true = np.asarray(js.exp(jnp.asarray(xi)))
    Xf = np.asarray(js.act(js.inverse(jnp.asarray(T_true)), jnp.asarray(Xk)))
    Xf = (Xf + noise * rng.normal(size=Xf.shape)).astype(np.float32)
    Q = (1.0 + 3.0 * rng.random((n, 1))).astype(np.float32)
    valid = rng.random((n, 1)) < 0.9
    ident = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
    return Xf, Xk, ident, ident, Q, valid


def test_gn_ray_dist_matches():
    rng = np.random.default_rng(3)
    args = _gn_problem(rng)
    cfg = jt.TrackingConfig()
    want = jt.opt_pose_ray_dist_sim3(*(jnp.asarray(a) for a in args), cfg)
    got = tt.opt_pose_ray_dist_sim3(*(_t(a) for a in args),
                                    tt.TrackingConfig())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=2e-4)
    assert bool(got[2]) == bool(want[2]) is False


def test_gn_calib_matches():
    rng = np.random.default_rng(4)
    Xf, Xk, Tf, Tk, Q, valid = _gn_problem(rng, noise=0.0)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    uv = Xk[:, :2] / Xk[:, 2:3] * 60.0 + np.array([32, 24], np.float32)
    meas = np.concatenate([uv, np.log(Xk[:, 2:3])], -1).astype(np.float32)
    vm = np.ones((len(Xk), 1), bool)
    cfg = jt.TrackingConfig()
    want = jt.opt_pose_calib_sim3(*(jnp.asarray(a) for a in
                                    (Xf, Xk, Tf, Tk, Q, valid, meas, vm, K)),
                                  (48, 64), cfg)
    got = tt.opt_pose_calib_sim3(*(_t(a) for a in
                                   (Xf, Xk, Tf, Tk, Q, valid, meas, vm, K)),
                                 (48, 64), tt.TrackingConfig())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-4)
    assert bool(got[2]) == bool(want[2])


def test_gn_cholesky_failure_path():
    """No valid residual: H = 0, the Cholesky fails in both, the pose is
    left as it was and `fail` is set (the runtime maps it to RELOC)."""
    rng = np.random.default_rng(5)
    Xf, Xk, Tf, Tk, Q, valid = _gn_problem(rng)
    valid[:] = False
    want = jt.opt_pose_ray_dist_sim3(*(jnp.asarray(a) for a in
                                       (Xf, Xk, Tf, Tk, Q, valid)),
                                     jt.TrackingConfig())
    got = tt.opt_pose_ray_dist_sim3(*(_t(a) for a in
                                      (Xf, Xk, Tf, Tk, Q, valid)),
                                    tt.TrackingConfig())
    assert bool(want[2]) and bool(got[2])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_tracking_config_from_config():
    assert tt.TrackingConfig.from_config(DEFAULTS) == tt.TrackingConfig(
        **{k: v for k, v in jt.TrackingConfig.from_config(
            DEFAULTS)._asdict().items()})
