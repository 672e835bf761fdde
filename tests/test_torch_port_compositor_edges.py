"""Edges of the port's tile compositor (`splat/cuda_rasterizer.py`) and the
contract of its CUDA sources that only the card can run.

The plain versions (`composite_torch`, `composite_bwd_torch`, what the
wrappers run for CPU tensors and what chip_smoke.py holds the kernels
against on the card) are held against the JAX package's Pallas kernels in
interpret mode where `k_max` is a multiple of their 128-row chunk, and
against a float64 front-to-back loop and torch autograd otherwise:

- tile counts on the kernels' chunk and ring boundaries (0, 1, 127, 128,
  129, k_max), forward and backward, with exact zeros in the gradient of
  the rows at and beyond each count;
- rows beyond a tile's count never reach a sum, whatever they hold;
- a `k_max` that is no multiple of 4 (the tiles' rows are then not 16-byte
  aligned in memory);
- a tile whose rows all fall under the 1/255 cut: the output is the
  background and the gradient is exactly zero.

Bars: forward 2e-3 against the Pallas kernel (its own bar in
tests/test_pallas_rasterizer.py: it sums log-transmittances through a
matmul) and 1e-5 against the float64 loop; gradients atol 1e-5·peak, rtol
1e-4 (tests/test_render_loss.py), fp32 on both sides.

The source contract: no fast-math flag, no fast exponential and no atomics
in any source, both kernels include the common header, the build's hash
covers that header, and the wrappers refuse what the kernels do not take.
"""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.splat import pallas_rasterizer as jpal
from splatt3r_slam_tpu_torch.splat import cuda_rasterizer as cr
from test_torch_port_bench import one_torch_thread  # noqa: F401

BG = np.array([0.1, 0.2, 0.3], np.float32)
COLS = ("u", "v", "conic_a", "conic_b", "conic_c", "opacity", "r", "g", "b")
BOUNDARY_COUNTS = (0, 1, 127, 128, 129, 256)


def _tiles(counts, k_max, seed, opacity=0.3):
    """(counts, origins, rows, gout) with seeded rows inside each tile; the
    rows at and beyond a tile's count hold values too."""
    rng = np.random.default_rng(seed)
    T = len(counts)
    n = T * k_max
    origins = np.array([[16 * (t % 3), 16 * (t // 3)] for t in range(T)],
                       np.int32)
    rows = np.zeros((n, 9), np.float32)
    rows[:, 0:2] = np.repeat(origins, k_max, 0) + 16 * rng.random((n, 2))
    rows[:, 2] = 0.05 + 0.2 * rng.random(n)
    rows[:, 4] = 0.05 + 0.2 * rng.random(n)
    rows[:, 3] = 0.01 * (rng.random(n) - 0.5)
    rows[:, 5] = opacity * rng.random(n)
    rows[:, 6:9] = rng.random((n, 3))
    gout = rng.normal(size=(T * 256, 4)).astype(np.float32)
    return np.asarray(counts, np.int32), origins, rows, gout


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _pallas(counts, origins, rows, gout, k_max):
    """Forward output and (grows (T·k_max, 9), d_bg) of the JAX package's
    kernels in interpret mode, on the transposed rows they take."""
    T = counts.shape[0]
    rows_t = np.zeros((jpal.ROWF, T * k_max), np.float32)
    rows_t[:9] = rows.T
    out, vjp = jax.vjp(
        lambda r, b: jpal._composite(T, k_max // jpal.CHUNK, True,
                                     jnp.asarray(counts),
                                     jnp.asarray(origins), r, b),
        jnp.asarray(rows_t), jnp.asarray(BG).reshape(1, 3))
    g_rows, g_bg = vjp(jnp.asarray(gout))
    return (np.asarray(out), np.asarray(g_rows)[:9].T,
            np.asarray(g_bg).reshape(3))


def _loop(counts, origins, rows, k_max):
    """A literal front-to-back loop in float64 (what the CUDA kernel does
    per pixel), vectorised over a tile's 256 pixels."""
    T = counts.shape[0]
    out = np.zeros((T * 256, 4))
    p = np.arange(256)
    for t in range(T):
        px = origins[t, 0] + p % 16 + 0.5
        py = origins[t, 1] + p // 16 + 0.5
        c = np.zeros((256, 3))
        tr = np.ones(256)
        for r in rows[t * k_max: t * k_max + counts[t]].astype(np.float64):
            du, dv = px - r[0], py - r[1]
            pw = -0.5 * (r[2] * du * du + r[4] * dv * dv) - r[3] * du * dv
            a = np.minimum(0.99, r[5] * np.exp(pw))
            a = np.where(a < 1 / 255, 0.0, a)
            c += (a * tr)[:, None] * r[6:9]
            tr *= 1 - a
        out[t * 256:(t + 1) * 256, :3] = c + tr[:, None] * BG
        out[t * 256:(t + 1) * 256, 3] = tr
    return out


def _assert_grad_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(
        got, want, atol=1e-5 * (np.abs(want).max() + 1e-8), rtol=1e-4,
        err_msg=f"gradient mismatch for {name}")


@pytest.mark.parametrize("count", BOUNDARY_COUNTS)
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_boundary_counts_match_pallas(direction, count):
    """A tile whose count sits on a chunk or ring boundary, beside a full
    tile and an empty one."""
    k_max = 256
    counts, origins, rows, gout = _tiles([count, k_max, 0], k_max, seed=count)
    want_out, want_rows, want_bg = _pallas(counts, origins, rows, gout, k_max)
    tc, to, tr_, tb, tg = _t(counts, origins, rows, BG, gout)
    out = cr.composite(tc, to, tr_, tb)
    if direction == "forward":
        np.testing.assert_allclose(out.numpy(), want_out, atol=2e-3)
        np.testing.assert_allclose(out.numpy(),
                                   _loop(counts, origins, rows, k_max),
                                   atol=1e-5)
        # the empty tile is the background, exactly
        assert (out[512:] == torch.cat([tb, torch.ones(1)])).all()
        return
    grows = cr.composite_bwd(tc, to, tr_, tg, out)
    for i, name in enumerate(COLS):
        _assert_grad_close(grows[:, i], want_rows[:, i], name)
    dead = (np.arange(k_max)[None] >= counts[:, None]).reshape(-1)
    assert dead.sum() == 2 * k_max - count
    assert not grows.numpy()[dead].any()  # exact zeros in the tail rows
    _assert_grad_close((tg[:, :3] * out[:, 3:4]).sum(0), want_bg, "bg")


def test_rows_beyond_count_never_reach_a_sum():
    """Rows at and beyond a tile's count may hold anything, here a conic so
    large that its power overflows to inf - inf: the Pallas kernels select
    them away and the CUDA kernels never read them, so the plain versions
    must not let them into a sum either."""
    k_max = 128
    counts, origins, rows, gout = _tiles([5, 0, 128], k_max, seed=7)
    clean_out, clean_rows, _ = _pallas(counts, origins, rows, gout, k_max)
    dead = (np.arange(k_max)[None] >= counts[:, None]).reshape(-1)
    rows[dead, 2:5] = [4.8e30, 1.7e30, 5.8e30]
    rows[dead, 0:2] = [1.1e5, -3.2e5]
    rows[dead, 5] = 0.0
    want_out, want_rows, _ = _pallas(counts, origins, rows, gout, k_max)
    np.testing.assert_array_equal(want_out, clean_out)
    np.testing.assert_array_equal(want_rows, clean_rows)
    tc, to, tr_, tb, tg = _t(counts, origins, rows, BG, gout)
    out = cr.composite(tc, to, tr_, tb)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), want_out, atol=2e-3)
    grows = cr.composite_bwd(tc, to, tr_, tg, out)
    for i, name in enumerate(COLS):
        _assert_grad_close(grows[:, i], want_rows[:, i], name)
    assert not grows.numpy()[dead].any()


@pytest.mark.parametrize("k_max", [30, 131])
def test_k_max_not_a_multiple_of_four(k_max):
    """Any k_max is taken: forward against the float64 loop, backward
    against torch autograd through `composite_torch` in float64."""
    counts, origins, rows, gout = _tiles([k_max, 0, 1, k_max - 1, 17, k_max],
                                         k_max, seed=k_max)
    tc, to, tr_, tb, tg = _t(counts, origins, rows, BG, gout)
    out = cr.composite(tc, to, tr_, tb)
    np.testing.assert_allclose(out.numpy(),
                               _loop(counts, origins, rows, k_max), atol=1e-5)
    grows = cr.composite_bwd(tc, to, tr_, tg, out)
    r64 = tr_.double().requires_grad_()
    (cr.composite_torch(tc, to, r64, tb.double()) * tg.double()).sum() \
        .backward()
    for i, name in enumerate(COLS):
        _assert_grad_close(grows[:, i], r64.grad[:, i], name)
    dead = (np.arange(k_max)[None] >= counts[:, None]).reshape(-1)
    assert not grows.numpy()[dead].any()


def test_tile_under_the_cut_is_background_with_zero_gradient():
    """Every row of the tile stays under alpha = 1/255 at every pixel (the
    path on which a CUDA warp skips the row): output = background,
    transmittance 1, gradient exactly 0, also in the Pallas kernels."""
    k_max = 128
    counts, origins, rows, gout = _tiles([128, 40], k_max, seed=3,
                                         opacity=0.0039)  # < 1/255
    assert rows[:, 5].max() < 1 / 255
    want_out, want_rows, _ = _pallas(counts, origins, rows, gout, k_max)
    tc, to, tr_, tb, tg = _t(counts, origins, rows, BG, gout)
    out = cr.composite(tc, to, tr_, tb)
    assert (out == torch.cat([tb, torch.ones(1)])).all()
    np.testing.assert_array_equal(want_out, out.numpy())
    grows = cr.composite_bwd(tc, to, tr_, tg, out)
    assert not grows.any()
    assert not want_rows.any()
    r = tr_.clone().requires_grad_()
    (cr.Composite.apply(tc, to, r, tb) * tg).sum().backward()
    assert not r.grad.any()


# -- what the card cannot be asked about here --------------------------------

CSRC = cr.KERNELS["composite"][0].parent


def _code(path):
    """A source without its comments."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_sources_keep_exact_arithmetic():
    """No fast-math flag, no fast exponential, no atomics, no tensor-core
    product: alpha's 1/255 cut must fall where the plain version's falls,
    and the gradient must have the same bits from run to run."""
    assert not any("fast_math" in f or "fmad" in f for f in cr.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cr.NVCC_FLAGS
    # the compositor's sources and the headers they include (csrc/ also
    # holds the flash-attention kernels and their header, whose bf16
    # products belong on the tensor cores)
    kernels = sorted(s for s, _, _ in cr.KERNELS.values())
    sources = kernels + sorted({CSRC / h for p in kernels for h in
                                re.findall(r'#include "([^"]+)"',
                                           p.read_text())})
    assert {p.name for p in sources} == {
        "composite.cu", "composite_bwd.cu", "composite_common.cuh"}
    for p in sources:
        code = _code(p)
        for banned in ("atomicAdd", "atomic", "__expf", "exp2f", "ex2.approx",
                       "use_fast_math", "wgmma", "mma.sync"):
            assert banned not in code, (p.name, banned)
    common = _code(CSRC / "composite_common.cuh")
    # the power is rounded product by product, and alpha comes from expf
    assert common.count("__fmul_rn") >= 6 and "__fadd_rn" in common
    assert "__fsub_rn" in common and "expf(power)" in common


@pytest.mark.parametrize("name", list(cr.KERNELS))
def test_kernels_share_one_evaluation_of_alpha(name):
    """Both sources include the common header and take power and alpha
    from it, never from a copy of their own."""
    source, entry, _ = cr.KERNELS[name]
    code = _code(source)
    assert '#include "composite_common.cuh"' in code
    assert "alpha_of(" in code and "power_of(" in code
    assert "expf" not in code and "__fmul_rn" not in code
    assert f'extern "C" int {entry}(' in code


def test_build_hash_covers_the_common_header(tmp_path):
    """An edit of the header alone must give another library name, or a
    stale library would be loaded."""
    work = tmp_path / "csrc"
    shutil.copytree(CSRC, work)
    before = {n: cr._digest(work / s.name, cr.NVCC_FLAGS)
              for n, (s, _, _) in cr.KERNELS.items()}
    assert before == {n: cr._digest(s, cr.NVCC_FLAGS)
                      for n, (s, _, _) in cr.KERNELS.items()}
    with open(work / "composite_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: cr._digest(work / s.name, cr.NVCC_FLAGS)
             for n, (s, _, _) in cr.KERNELS.items()}
    assert all(before[n] != after[n] for n in before)
    assert cr._digest(work / "composite.cu", [*cr.NVCC_FLAGS, "-DX=1"]) \
        != after["composite"]


def _good(which):
    counts, origins, rows, gout = _tiles([3, 0], 8, seed=1)
    tc, to, tr_, tb, tg = _t(counts, origins, rows, BG, gout)
    if which == "composite":
        return dict(counts=tc, origins=to, rows=tr_, bg=tb)
    return dict(counts=tc, origins=to, rows=tr_, gout=tg,
                out=cr.composite_torch(tc, to, tr_, tb))


FAULTS = {
    "dtype": lambda a: a.update(counts=a["counts"].long()),
    "shape": lambda a: a.update(origins=a["origins"][:, :1].contiguous()),
    "rows_shape": lambda a: a.update(rows=a["rows"][:, :8].contiguous()),
    "device": lambda a: a.update(origins=a["origins"].to("meta")),
    "non_contiguous": lambda a: a.update(
        rows=a["rows"].t().contiguous().t()),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("which", ["composite", "composite_bwd"])
def test_wrappers_refuse_what_the_kernels_do_not_take(which, fault):
    """A wrong dtype, shape or device or a non-contiguous tensor raises
    ValueError before any kernel or plain version runs."""
    fn = getattr(cr, which)
    args = _good(which)
    fn(**args)  # the unbroken arguments pass
    FAULTS[fault](args)
    with pytest.raises(ValueError, match=which):
        fn(**args)
