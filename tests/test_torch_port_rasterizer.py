"""Port rasterizer (splatt3r_slam_tpu_torch.splat) against the JAX package.

Binning must agree exactly; the compositor's plain version
(`composite_torch`, also what `render_tiles_cuda` runs for CPU tensors) is
held against the Pallas kernel in interpret mode, the XLA tile compositor
and the brute-force oracle at the JAX package's own bars
(tests/test_pallas_rasterizer.py: 2e-3, and 3e-3 for the multi-chunk
tile). The backward's plain version (`composite_bwd_torch`, what
`Composite.backward` runs for CPU tensors) is held against the Pallas VJP
in interpret mode, torch autograd through `composite_torch` and fp64
finite differences, and the whole render's gradients against `jax.grad` of
`render_tiles_pallas`, at the bar of tests/test_render_loss.py (atol
1e-5·peak, rtol 1e-4). The CUDA kernels themselves run only on the card:
chip_smoke.py holds them against the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.splat import rasterizer as jr
from splatt3r_slam_tpu.splat.gaussians import build_covariance as j_cov
from splatt3r_slam_tpu.splat.gaussians import cov_to_triu as j_triu
from splatt3r_slam_tpu.splat import pallas_rasterizer as jpal
from splatt3r_slam_tpu.splat.pallas_rasterizer import render_tiles_pallas
from splatt3r_slam_tpu_torch.splat import cuda_rasterizer as cr
from splatt3r_slam_tpu_torch.splat import gaussians as tg
from splatt3r_slam_tpu_torch.splat import rasterizer as tr
from test_torch_port_bench import one_torch_thread  # noqa: F401

K = np.array([[80.0, 0, 32], [0, 80, 32], [0, 0, 1]], np.float32)
VIEW = np.eye(4, dtype=np.float32)
HW = (64, 64)


def _scene(rng, G=180):
    means = rng.normal(size=(G, 3)).astype(np.float32) * 2.0
    means[:, 2] = np.abs(means[:, 2]) + 4.0
    scales = (0.05 + 0.1 * rng.random((G, 3))).astype(np.float32)
    q = rng.normal(size=(G, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    covt = np.asarray(j_triu(j_cov(jnp.asarray(scales), jnp.asarray(q))),
                      np.float32)
    colors = rng.random((G, 3)).astype(np.float32)
    opa = (0.3 + 0.7 * rng.random(G)).astype(np.float32)
    return means, covt, colors, opa


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a, jnp.float32) for a in arrs]


def test_covariance_and_triu_match(rng):
    scales = (0.05 + rng.random((50, 3))).astype(np.float32)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    want = np.asarray(j_cov(jnp.asarray(scales), jnp.asarray(q)))
    got = tg.build_covariance(*_t(scales, q))
    # fp32 einsum in both; 1e-5 relative covers summation order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # Σ is symmetric up to fp32 rounding of the two off-diagonal sums
    np.testing.assert_allclose(tg.triu_to_cov(tg.cov_to_triu(got)).numpy(),
                               got.numpy(), atol=1e-7)
    rgb = rng.random((7, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.SH2RGB(tg.RGB2SH(torch.from_numpy(rgb))),
                               rgb, atol=1e-6)


def test_project_gaussians_matches(rng):
    means, covt, colors, opa = _scene(rng)
    a = jr.project_gaussians(*_j(means, covt, opa, VIEW, K), HW)
    b = tr.project_gaussians(*_t(means, covt, opa, VIEW, K), HW)
    for x, y in zip(a, b):
        # component-wise fp32 arithmetic in the same order
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("tiles_hw", [(64, 64), (128, 256)])
def test_bin_tiles_exact(rng, tiles_hw):
    """Identical counts, valid slots and gidx on every valid slot. (A
    padded slot repeats whatever follows the tile in the sorted list, which
    the two packages order differently past the last valid key.)"""
    means, covt, colors, opa = _scene(rng)
    hw = tiles_hw
    Kw = K.copy()
    Kw[0, 2] = hw[1] / 2
    jp = jr.project_gaussians(*_j(means, covt, opa, VIEW, Kw), hw)
    m2, dep, rad, ok = (np.asarray(jp[i]) for i in (0, 2, 3, 4))
    jg, jv, jc = jr.bin_tiles(*_j(m2, dep, rad), jnp.asarray(ok), hw, 4, 128)
    tg_, tv, tc = tr.bin_tiles(*_t(m2, dep, rad), torch.from_numpy(ok), hw, 4,
                               128)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tg_.numpy()[tv.numpy()],
                                  np.asarray(jg)[np.asarray(jv)])


def test_bin_tiles_two_operand_branch(rng):
    """≥ 2^13 tiles: the port's tile-id sort equals the JAX two-key sort
    (the shifted tile id overflows int32 there)."""
    hw = (16 * 64, 16 * 130)  # 8320 tiles
    G = 300
    m2 = np.stack([rng.random(G) * hw[1], rng.random(G) * hw[0]], -1)
    m2 = m2.astype(np.float32)
    dep = rng.random(G).astype(np.float32) + 1.0
    dep[:20] = dep[20:40]  # equal depths must keep index order
    rad = np.ceil(rng.random(G) * 30).astype(np.float32)
    ok = rng.random(G) < 0.9
    jg, jv, jc = jr.bin_tiles(*_j(m2, dep, rad), jnp.asarray(ok), hw, 4, 16)
    tg_, tv, tc = tr.bin_tiles(*_t(m2, dep, rad), torch.from_numpy(ok), hw, 4,
                               16)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tg_.numpy()[tv.numpy()],
                                  np.asarray(jg)[np.asarray(jv)])


def _port(fn, means, covt, colors, opa, **kw):
    return fn(*_t(means, covt, colors, opa, VIEW, K), HW, **kw).numpy()


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 99.0 if mse < 1e-12 else 10 * np.log10(1.0 / mse)


def test_depth_key_ties_composite_in_depth_order():
    """Gaussians of one tile whose 18-bit depth keys tie: the JAX package
    composites them in index order, the port in depth order, as the exact
    oracle does. Eight overlapping gaussians 2e-5 apart in depth (indices
    far to near) sit under one key while two small ones at depths 1 and
    100 set the key's span (quantum 3.8e-4)."""
    n = 8
    means = np.zeros((n + 2, 3), np.float32)
    means[:n, 2] = 5.0 + 2e-5 * np.arange(n)[::-1]
    means[n:] = [[-0.3, -0.3, 1.0], [-30.0, -30.0, 100.0]]
    scales = np.full((n + 2, 3), 0.3, np.float32)
    scales[n:] = 0.001
    q = np.tile(np.float32([1, 0, 0, 0]), (n + 2, 1))
    covt = np.asarray(j_triu(j_cov(jnp.asarray(scales), jnp.asarray(q))),
                      np.float32)
    colors = np.random.default_rng(0).random((n + 2, 3)).astype(np.float32)
    opa = np.full(n + 2, 0.8, np.float32)
    args = (means, covt, colors, opa, VIEW, K)
    exact = np.asarray(jr.render_bruteforce(*_j(*args), HW))
    port = tr.render_tiles(*_t(*args), HW).numpy()
    jax_tiles = np.asarray(jr.render_tiles(*_j(*args), HW))
    assert float(exact.max()) > 0.3, "an empty render"
    assert _psnr(port, exact) >= 88.0
    assert _psnr(jax_tiles, exact) < 88.0
    # the same scene in depth order: no tie left to resolve, so the JAX
    # package agrees with the oracle too
    order = np.argsort(means[:, 2], kind="stable")
    jax_sorted = np.asarray(jr.render_tiles(
        *_j(*(a[order] for a in args[:4]), VIEW, K), HW))
    assert _psnr(jax_sorted, exact) >= 88.0


@pytest.mark.parametrize("port_fn", [tr.render_tiles, cr.render_tiles_cuda])
def test_compositor_matches_pallas_and_xla(rng, port_fn):
    means, covt, colors, opa = _scene(rng)
    pal = np.asarray(render_tiles_pallas(*_j(means, covt, colors, opa, VIEW,
                                             K), HW, interpret=True))
    xla = np.asarray(jr.render_tiles(*_j(means, covt, colors, opa, VIEW, K),
                                     HW, k_max=512))
    got = _port(port_fn, means, covt, colors, opa)
    # the Pallas bar (tests/test_pallas_rasterizer.py:40)
    np.testing.assert_allclose(got, pal, atol=2e-3)
    np.testing.assert_allclose(got, xla, atol=2e-3)


def test_compositor_matches_bruteforce(rng):
    means, covt, colors, opa = _scene(rng, G=120)
    want = np.asarray(jr.render_bruteforce(*_j(means, covt, colors, opa, VIEW,
                                               K), HW))
    port_bf = _port(tr.render_bruteforce, means, covt, colors, opa)
    # the exact oracles agree up to fp32 summation order
    np.testing.assert_allclose(port_bf, want, atol=1e-5)
    for fn in (tr.render_tiles, cr.render_tiles_cuda):
        np.testing.assert_allclose(_port(fn, means, covt, colors, opa), want,
                                   atol=2e-3)


def test_compositor_background(rng):
    means = np.zeros((1, 3), np.float32)
    means[0, 2] = -1.0
    covt = (np.eye(3, dtype=np.float32) * 0.01)[[0, 0, 0, 1, 1, 2],
                                                 [0, 1, 2, 1, 2, 2]][None]
    bg = torch.tensor([0.1, 0.2, 0.3])
    img = cr.render_tiles_cuda(*_t(means, covt, np.ones((1, 3), np.float32),
                                   np.ones(1, np.float32), VIEW, K), HW,
                               bg=bg).numpy()
    np.testing.assert_allclose(img, np.broadcast_to([0.1, 0.2, 0.3],
                                                    img.shape), atol=1e-5)


def test_compositor_many_gaussians_one_tile(rng):
    """A tile list longer than one 128-row chunk."""
    G = 400
    means = np.zeros((G, 3), np.float32)
    means[:, 0] = rng.normal(size=G) * 0.02
    means[:, 1] = rng.normal(size=G) * 0.02
    means[:, 2] = np.linspace(2.0, 6.0, G)
    covt = np.tile(np.array([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (G, 1))
    colors = rng.random((G, 3)).astype(np.float32)
    opa = np.full((G,), 0.05, np.float32)
    want = np.asarray(jr.render_tiles(*_j(means, covt, colors, opa, VIEW, K),
                                      HW, k_max=512))
    pal = np.asarray(render_tiles_pallas(*_j(means, covt, colors, opa, VIEW,
                                             K), HW, interpret=True))
    got = _port(cr.render_tiles_cuda, means, covt, colors, opa)
    # the multi-chunk bar (tests/test_pallas_rasterizer.py:82)
    np.testing.assert_allclose(got, want, atol=3e-3)
    np.testing.assert_allclose(got, pal, atol=3e-3)


def test_composite_torch_against_sequential_loop(rng):
    """The plain version equals a literal per-pixel front-to-back loop
    (what the CUDA kernel does) within fp32 rounding, T_final included."""
    T, k_max = 3, 40
    rows = np.zeros((T * k_max, 9), np.float32)
    rows[:, 0:2] = rng.random((T * k_max, 2)) * 16
    rows[:, 2] = rows[:, 4] = 0.05 + 0.2 * rng.random(T * k_max)
    rows[:, 3] = 0.01 * rng.normal(size=T * k_max)
    rows[:, 5] = rng.random(T * k_max)
    rows[:, 6:9] = rng.random((T * k_max, 3))
    counts = np.array([0, 17, 40], np.int32)
    origins = np.array([[0, 0], [16, 0], [32, 16]], np.int32)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    got = cr.composite(*_t(counts, origins, rows, bg)).numpy()
    want = np.zeros((T * 256, 4), np.float32)
    for t in range(T):
        for p in range(256):
            px = origins[t, 0] + p % 16 + 0.5
            py = origins[t, 1] + p // 16 + 0.5
            c = np.zeros(3, np.float64)
            tr_ = 1.0
            for r in rows[t * k_max: t * k_max + counts[t]]:
                du, dv = px - r[0], py - r[1]
                pw = -0.5 * (r[2] * du * du + r[4] * dv * dv) - r[3] * du * dv
                a = min(0.99, r[5] * np.exp(pw))
                if a < 1 / 255:
                    continue
                c += a * tr_ * r[6:9]
                tr_ *= 1 - a
            want[t * 256 + p, :3] = c + tr_ * bg
            want[t * 256 + p, 3] = tr_
    # fp32 cumprod vs a float64 sequential loop
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_composite_cpu_tensor_runs_plain_version():
    """CPU tensors take the plain version and launch no kernel."""
    counts = torch.zeros(2, dtype=torch.int32)
    origins = torch.zeros(2, 2, dtype=torch.int32)
    rows = torch.zeros(2 * 4, 9)
    bg = torch.zeros(3)
    before = cr.launches
    out = cr.composite(counts, origins, rows, bg)
    assert out.shape == (512, 4) and cr.launches == before
    assert tr.default_rasterizer(rows) == "torch"


# -- the backward compositor ---------------------------------------------


def _multi_chunk_scene(rng, G=400):
    """One tile's list longer than a 128-row chunk."""
    means = np.zeros((G, 3), np.float32)
    means[:, 0] = rng.normal(size=G) * 0.02
    means[:, 1] = rng.normal(size=G) * 0.02
    means[:, 2] = np.linspace(2.0, 6.0, G)
    covt = np.tile(np.array([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (G, 1))
    return (means, covt, rng.random((G, 3)).astype(np.float32),
            np.full((G,), 0.05, np.float32))


def _background_scene(rng):
    """A single gaussian behind the camera: every tile's count is 0."""
    covt = np.array([[0.01, 0, 0, 0.01, 0, 0.01]], np.float32)
    return (np.array([[0.0, 0.0, -1.0]], np.float32), covt,
            np.ones((1, 3), np.float32), np.ones(1, np.float32))


def _clamped_scene(rng, G=100):
    """Wide, fully opaque gaussians: alpha sits on the 0.99 clamp at the
    pixels near each centre, where the chain through alpha must stop."""
    means, _, colors, _ = _scene(rng, G)
    scales = (0.3 + 0.3 * rng.random((G, 3))).astype(np.float32)
    q = rng.normal(size=(G, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    covt = np.asarray(j_triu(j_cov(jnp.asarray(scales), jnp.asarray(q))),
                      np.float32)
    return means, covt, colors, np.ones(G, np.float32)


BWD_CASES = {"scene": (_scene, 256), "multi_chunk": (_multi_chunk_scene, 512),
             "background": (_background_scene, 128),
             "clamped": (_clamped_scene, 128)}


def _bwd_inputs(case):
    """(counts, origins, rows, bg, gout) for a named case; the cotangent's
    transmittance column is non-zero."""
    make, k_max = BWD_CASES[case]
    rng = np.random.default_rng(0)
    counts, origins, rows = cr.pack_rows(
        *_t(*make(rng), VIEW, K), HW, k_max=k_max)
    bg = torch.tensor([0.1, 0.2, 0.3])
    gout = torch.from_numpy(
        rng.normal(size=(counts.shape[0] * 256, 4)).astype(np.float32))
    return counts, origins, rows, bg, gout


def _assert_grad_close(got, want, name):
    """The bar of tests/test_render_loss.py: fp32 on both sides, sums in
    another order."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(
        got, want, atol=1e-5 * (np.abs(want).max() + 1e-8), rtol=1e-4,
        err_msg=f"gradient mismatch for {name}")


COLS = ("u", "v", "conic_a", "conic_b", "conic_c", "opacity", "r", "g", "b")


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_composite_bwd_matches_pallas_vjp(case):
    """Plain backward == the Pallas VJP (`_composite_bwd_kernel` in
    interpret mode) on the transposed rows, column by column, and the
    tensor-code d_bg."""
    counts, origins, rows, bg, gout = _bwd_inputs(case)
    T = counts.shape[0]
    k_max = rows.shape[0] // T
    rows_t = np.zeros((jpal.ROWF, T * k_max), np.float32)
    rows_t[:9] = rows.numpy().T
    j_out, vjp = jax.vjp(
        lambda r, b: jpal._composite(T, k_max // jpal.CHUNK, True,
                                   jnp.asarray(counts.numpy()),
                                   jnp.asarray(origins.numpy()), r, b),
        jnp.asarray(rows_t), jnp.asarray(bg.numpy()).reshape(1, 3))
    j_grows, j_dbg = vjp(jnp.asarray(gout.numpy()))
    out = cr.composite_torch(counts, origins, rows, bg)
    # forward first: the compositor bar of tests/test_pallas_rasterizer.py
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-3)
    grows = cr.composite_bwd(counts, origins, rows, gout, out)
    assert grows.shape == rows.shape
    if case == "background":
        assert int(counts.sum()) == 0 and not grows.any()
    if case == "clamped":
        raw, live = cr._alpha_terms(
            rows.reshape(T, k_max, 9), origins, counts,
            tr._pixel_offsets("cpu"), torch.arange(k_max))[3::2]
        assert int(((raw >= 0.99) & live).sum()) > 100
    for i, name in enumerate(COLS):
        _assert_grad_close(grows[:, i], np.asarray(j_grows)[i], name)
    assert not np.asarray(j_grows)[9:].any()
    d_bg = (gout[:, :3] * out[:, 3:4]).sum(0)
    _assert_grad_close(d_bg, np.asarray(j_dbg).reshape(3), "bg")


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_composite_bwd_matches_torch_autograd(case):
    """Plain backward == torch autograd through `composite_torch`, and
    `Composite` (what training runs) returns exactly the plain backward."""
    counts, origins, rows, bg, gout = _bwd_inputs(case)
    r1 = rows.clone().requires_grad_()
    b1 = bg.clone().requires_grad_()
    out = cr.composite_torch(counts, origins, r1, b1)
    (out * gout).sum().backward()
    grows = cr.composite_bwd_torch(counts, origins, rows, gout, out.detach())
    for i, name in enumerate(COLS):
        _assert_grad_close(grows[:, i], r1.grad[:, i], name)
    # rows at and beyond each tile's count get exactly nothing
    k_max = rows.shape[0] // counts.shape[0]
    dead = (torch.arange(k_max)[None] >= counts[:, None]).reshape(-1)
    assert not grows[dead].any()

    r2 = rows.clone().requires_grad_()
    b2 = bg.clone().requires_grad_()
    before = (cr.launches, cr.bwd_launches)
    (cr.Composite.apply(counts, origins, r2, b2) * gout).sum().backward()
    assert (cr.launches, cr.bwd_launches) == before  # CPU: plain versions
    assert torch.equal(r2.grad, grows)
    _assert_grad_close(b2.grad, b1.grad, "bg")


def test_composite_bwd_finite_differences_fp64():
    """fp64 central differences on a tiny tile where no alpha sits at a
    cut (every raw alpha in (0.02, 0.9): clear of 1/255 and of 0.99)."""
    rng = np.random.default_rng(2)
    T, k_max = 2, 6
    rows = np.zeros((T * k_max, 9))
    rows[:, 0:2] = 4 + 8 * rng.random((T * k_max, 2))
    rows[:, 2] = rows[:, 4] = 0.004 + 0.004 * rng.random(T * k_max)
    rows[:, 3] = 0.001 * rng.normal(size=T * k_max)
    rows[:, 5] = 0.3 + 0.6 * rng.random(T * k_max)
    rows[:, 6:9] = rng.random((T * k_max, 3))
    counts = torch.tensor([6, 4], dtype=torch.int32)
    origins = torch.tensor([[0, 0], [0, 0]], dtype=torch.int32)
    rows = torch.from_numpy(rows)
    bg = torch.tensor([0.2, 0.4, 0.6], dtype=torch.float64)
    gout = torch.from_numpy(rng.normal(size=(T * 256, 4)))
    out = cr.composite_torch(counts, origins, rows, bg)
    assert out.dtype == torch.float64
    grows = cr.composite_bwd_torch(counts, origins, rows, gout, out)
    live = (torch.arange(k_max)[None] < counts[:, None]).reshape(-1)
    eps = 1e-6
    for idx in np.flatnonzero(live.numpy()):
        for col in range(9):
            d = torch.zeros_like(rows)
            d[idx, col] = eps
            hi = (cr.composite_torch(counts, origins, rows + d, bg)
                  * gout).sum()
            lo = (cr.composite_torch(counts, origins, rows - d, bg)
                  * gout).sum()
            fd = float(hi - lo) / (2 * eps)
            # fp64 central difference: truncation error ~eps²
            assert abs(fd - float(grows[idx, col])) <= 1e-6 * max(
                1.0, abs(fd)), (idx, COLS[col], fd, float(grows[idx, col]))
    assert not grows[~live].any()


def test_render_gradients_match_pallas_and_autograd(rng):
    """d(means, cov_triu, colors, opa, bg) of sum(render·cot): the port's
    `render_tiles_cuda` on CPU tensors (`Composite` with its plain forward
    and backward) against `jax.grad` of `render_tiles_pallas` in interpret
    mode, and against torch autograd through the port's `render_tiles`.
    k_max=256 runs the cross-chunk carries."""
    means, covt, colors, opa = _scene(rng)
    cot = rng.normal(size=(64, 64, 3)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    def loss_p(m, c, col, o, b):
        return jnp.sum(render_tiles_pallas(
            m, c, col, o, jnp.asarray(VIEW), jnp.asarray(K), HW, b,
            k_max=256, interpret=True) * jnp.asarray(cot))

    want = jax.grad(loss_p, argnums=(0, 1, 2, 3, 4))(
        *_j(means, covt, colors, opa, bg))

    def port_grads(fn):
        ins = [t.requires_grad_() for t in _t(means, covt, colors, opa, bg)]
        img = fn(*ins[:4], *_t(VIEW, K), HW, ins[4], k_max=256)
        (img * torch.from_numpy(cot)).sum().backward()
        return [t.grad for t in ins]

    got = port_grads(cr.render_tiles_cuda)
    ref = port_grads(tr.render_tiles)
    for name, g, w, r in zip(["means", "cov", "colors", "opa", "bg"], got,
                             want, ref):
        _assert_grad_close(g, w, name + " (vs pallas)")
        _assert_grad_close(g, r, name + " (vs render_tiles autograd)")


def test_composite_bwd_cpu_tensor_runs_plain_version():
    """CPU tensors take the plain backward and launch no kernel; the
    result is zero where no row is live."""
    counts = torch.zeros(2, dtype=torch.int32)
    origins = torch.zeros(2, 2, dtype=torch.int32)
    rows = torch.rand(2 * 4, 9)
    gout = torch.rand(512, 4)
    out = cr.composite(counts, origins, rows, torch.zeros(3))
    before = cr.bwd_launches
    grows = cr.composite_bwd(counts, origins, rows, gout, out)
    assert grows.shape == rows.shape and cr.bwd_launches == before
    assert not grows.any()
