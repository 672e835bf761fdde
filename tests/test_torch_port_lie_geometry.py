"""Port Sim(3), projective geometry and robust weights against the JAX
package, on the same seeded numpy inputs (CPU, fp32).

Tolerances: both sides evaluate the same fp32 closed forms; 1e-5 absolute
(1e-4 where a value is a product of several of them) covers the different
evaluation order of the two frameworks' elementwise kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.geometry import projective as jproj
from splatt3r_slam_tpu.geometry import robust as jrob
from splatt3r_slam_tpu.lie import sim3 as jsim3
from splatt3r_slam_tpu_torch.geometry import projective as tproj
from splatt3r_slam_tpu_torch.geometry import robust as trob
from splatt3r_slam_tpu_torch.lie import sim3 as tsim3
from test_torch_port_bench import one_torch_thread  # noqa: F401


def _poses(rng, n, small=False):
    xi = rng.normal(size=(n, 7)).astype(np.float32) * (1e-4 if small else 0.5)
    return np.asarray(jsim3.exp(jnp.asarray(xi)), np.float32), xi


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("small", [False, True])
def test_exp_and_retr(rng, small):
    """exp over both branch regimes (|φ|, |σ| above and below 1e-6)."""
    _, xi = _poses(rng, 64, small)
    if small:
        xi[:8] = 0.0  # exact zeros hit every small-angle branch
    _close(tsim3.exp(_t(xi)), jsim3.exp(jnp.asarray(xi)))
    T, _ = _poses(rng, 64)
    _close(tsim3.retr(_t(T), _t(xi)),
           jsim3.retr(jnp.asarray(T), jnp.asarray(xi)))


def test_group_ops(rng):
    Ta, _ = _poses(rng, 32)
    Tb, _ = _poses(rng, 32)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    ja, jb = jnp.asarray(Ta), jnp.asarray(Tb)
    ta, tb = _t(Ta), _t(Tb)
    _close(tsim3.act(ta, _t(x)), jsim3.act(ja, jnp.asarray(x)), 1e-4)
    _close(tsim3.inverse(ta), jsim3.inverse(ja), 1e-4)
    _close(tsim3.multiply(ta, tb), jsim3.multiply(ja, jb), 1e-4)
    _close(tsim3.rel(ta, tb), jsim3.rel(ja, jb), 1e-4)
    _close(tsim3.normalize(ta), jsim3.normalize(ja))
    _close(tsim3.matrix(ta), jsim3.matrix(ja), 1e-4)
    _close(tsim3.se3_matrix(tsim3.to_se3(ta)),
           jsim3.se3_matrix(jsim3.to_se3(ja)), 1e-4)
    x7 = rng.normal(size=(32, 7)).astype(np.float32)
    _close(tsim3.adj_inv_apply_row(ta, _t(x7)),
           jsim3.adj_inv_apply_row(ja, jnp.asarray(x7)), 1e-4)
    _close(tsim3.act_jacobian(_t(x)), jsim3.act_jacobian(jnp.asarray(x)))
    # one pose against many points broadcasts like the JAX functions
    _close(tsim3.act(ta[0], _t(x)), jsim3.act(ja[0], jnp.asarray(x)), 1e-4)
    _close(tsim3.multiply(ta[0], tb), jsim3.multiply(ja[0], jb), 1e-4)
    ident = tsim3.identity((2,), device="cpu")
    _close(ident, jsim3.identity((2,)))


def test_projective(rng):
    X = rng.normal(size=(40, 3)).astype(np.float32)
    X[:, 2] = np.abs(X[:, 2]) + 0.5
    X[:3, 2] = -0.1  # invalid depths
    jx, tx = jnp.asarray(X), _t(X)
    a = jproj.point_to_ray_dist(jx, jacobian=True)
    b = tproj.point_to_ray_dist(tx, jacobian=True)
    for u, v in zip(a, b):
        _close(v, u)
    K = np.array([[60.0, 0, 31.5], [0, 62.0, 23.5], [0, 0, 1]], np.float32)
    a = jproj.project_calib(jx, jnp.asarray(K), (48, 64), jacobian=True,
                            border=-10.0, z_eps=1e-6)
    b = tproj.project_calib(tx, _t(K), (48, 64), jacobian=True,
                            border=-10.0, z_eps=1e-6)
    for u, v in zip(a, b):
        _close(v, u, 1e-4)
    uv = rng.random((40, 2)).astype(np.float32) * 50
    z = rng.random((40, 1)).astype(np.float32) + 0.5
    _close(tproj.backproject(_t(uv), _t(z), _t(K)),
           jproj.backproject(jnp.asarray(uv), jnp.asarray(z),
                             jnp.asarray(K)))
    _close(tproj.get_pixel_coords(2, (5, 7), device="cpu"),
           jproj.get_pixel_coords(2, (5, 7)))
    Xs = rng.normal(size=(1, 35, 3)).astype(np.float32)
    _close(tproj.constrain_points_to_ray((5, 7), _t(Xs), _t(K)),
           jproj.constrain_points_to_ray((5, 7), jnp.asarray(Xs),
                                         jnp.asarray(K)))


def test_robust(rng):
    r = (rng.normal(size=200) * 3).astype(np.float32)
    _close(trob.huber(_t(r)), jrob.huber(jnp.asarray(r)))
    _close(trob.tukey(_t(r)), jrob.tukey(jnp.asarray(r)))
    d = rng.normal(size=7).astype(np.float32) * 1e-3
    for old, new in ((1.0, 0.9999), (1.0, 0.5)):
        want = bool(jrob.check_convergence(1e-3, 1e-3, jnp.float32(old),
                                           jnp.float32(new),
                                           jnp.asarray(d)))
        got = bool(trob.check_convergence(1e-3, 1e-3, torch.tensor(old),
                                          torch.tensor(new), _t(d)))
        assert got == want
