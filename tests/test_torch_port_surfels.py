"""Surfels, SH and the exact compositing oracle against the JAX package.

- `splat/gaussians.py::pointmap_to_surfels` (the viewer's surfel mode) at
  strides 1, 3 and 4 and `eval_sh` at degrees 0-3, on seeded inputs,
  within 1e-6 (fp32 on both sides, the same expressions);
- `splat/rasterizer.py::render_bruteforce_scan` (the exact oracle the
  fidelity sweep holds the tile renderer to) within 1e-5, over several
  chunks of gaussians and with a background, and equal to the one-shot
  `render_bruteforce` within 1e-5;
- the fidelity sweep's `--quick` run (one scene of 30k gaussians, tpg_side
  4, k_max 128) gives a PSNR within 0.5 dB of the JAX script's on the
  same run, and the port's SSIM and largest difference within 0.01.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.splat import gaussians as jg
from splatt3r_slam_tpu.splat import rasterizer as jr
from splatt3r_slam_tpu_torch.scripts import sweep_rasterizer_fidelity as sweep
from splatt3r_slam_tpu_torch.splat import gaussians as tg
from splatt3r_slam_tpu_torch.splat import rasterizer as tr
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("stride", [1, 3, 4])
def test_pointmap_to_surfels_matches_jax(stride):
    rng = np.random.default_rng(stride)
    h, w = 18, 26
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = 2.0 + 0.4 * rng.random((h, w))
    X = np.stack([(u - w / 2) * z / w, (v - h / 2) * z / w, z],
                 -1).astype(np.float32)
    col = rng.random((h, w, 3)).astype(np.float32)
    q = rng.normal(size=4)
    T = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q),
                        [1.3]]).astype(np.float32)
    want = jg.pointmap_to_surfels(jnp.asarray(X), jnp.asarray(col),
                                  jnp.asarray(T), stride=stride)
    got = tg.pointmap_to_surfels(torch.as_tensor(X), torch.as_tensor(col),
                                 torch.as_tensor(T), stride=stride)
    n = len(range(stride // 2, h, stride)) * len(range(stride // 2, w,
                                                       stride))
    for g, wnt in zip(got, want):
        assert g.shape[0] == n and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(wnt).max()))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jg.eval_sh(deg, jnp.asarray(sh),
                                 jnp.asarray(d)[:, None, :]))
    got = tg.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(d)[:, None, :])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _scene(G, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, G), rng.uniform(-0.7, 0.7, G),
                      rng.uniform(2, 4, G)], -1).astype(np.float32)
    scales = (0.02 + 0.08 * rng.random((G, 3))).astype(np.float32)
    q = rng.normal(size=(G, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cov = np.asarray(jg.cov_to_triu(jg.build_covariance(jnp.asarray(scales),
                                                        jnp.asarray(q))),
                     np.float32)
    return (means, cov, rng.random((G, 3)).astype(np.float32),
            (0.2 + 0.8 * rng.random(G)).astype(np.float32))


def test_bruteforce_scan_matches_jax():
    hw = (32, 48)
    K = np.array([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]], np.float32)
    view = np.eye(4, dtype=np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    arrays = _scene(700)
    want = np.asarray(jr.render_bruteforce_scan(
        *map(jnp.asarray, arrays), jnp.asarray(view), jnp.asarray(K), hw,
        bg=jnp.asarray(bg), g_chunk=128))
    t = [torch.as_tensor(np.array(a)) for a in (*arrays, view, K)]
    got = tr.render_bruteforce_scan(*t, hw, bg=torch.as_tensor(bg),
                                    g_chunk=128)
    assert got.shape == hw + (3,) and float(got.max()) > 0.2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    one = tr.render_bruteforce(*t, hw, bg=torch.as_tensor(bg))
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=1e-5)


def _jax_sweep_quick(tmp_path):
    """The JAX script's `--quick` run in this process → its result rows."""
    spec = importlib.util.spec_from_file_location(
        "jax_sweep", ROOT / "scripts" / "sweep_rasterizer_fidelity.py")
    mod = importlib.util.module_from_spec(spec)
    path, argv, cwd = list(sys.path), list(sys.argv), os.getcwd()
    try:
        spec.loader.exec_module(mod)
        sys.argv = ["sweep_rasterizer_fidelity.py", "--quick"]
        os.chdir(tmp_path)
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
        return json.loads((tmp_path / "logs" /
                           "sweep_rasterizer_fidelity.json").read_text())
    finally:
        sys.path[:], sys.argv[:] = path, argv
        os.chdir(cwd)


def test_sweep_quick_matches_jax(tmp_path, capsys):
    out = tmp_path / "port.json"
    got = sweep.main(["--quick", "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == got == json.loads(out.read_text())
    assert got["device"] == "cpu" and got["scenes"] == [30_000]
    want = _jax_sweep_quick(tmp_path)
    assert [(r["G"], r["tpg_side"], r["k_max"]) for r in got["results"]] == \
        [(r["G"], r["tpg_side"], r["k_max"]) for r in want["results"]] == \
        [(30_000, 4, 128)]
    a, b = got["results"][0], want["results"][0]
    assert abs(a["psnr"] - b["psnr"]) <= 0.5, (a, b)
    assert abs(a["ssim"] - b["ssim"]) <= 0.01 and \
        abs(a["max_abs"] - b["max_abs"]) <= 0.01, (a, b)
    print(f"quick sweep: port {a}, JAX {b}")
