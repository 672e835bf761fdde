"""The port's viewer (`runtime/visualization.py`) against the JAX package's.

One seeded duck-typed system (three keyframes with pointmaps, poses and
images, a pool of 3,000 world gaussians, three backend edges, the current
frame) goes into both packages' `Viewer`, as numpy data wrapped in each
package's arrays, at 96x128 with the plain rasterizers. Held:
- the splat, depth, surfel and scatter views within 5e-4 (the render-order
  difference between the plain compositors, 2.25e-4, with margin);
- the composed canvas, with its frustum and edge overlays and image
  panels, within one level outside the two text rows (y < 44), the overlay
  pixels of each within 1 px of the other's; the text is the port's bitmap
  font, not cv2's Hershey strokes;
- `_handle_key` for every key, and a scripted `_on_mouse` drag, pan and
  wheel sequence, give both viewers the same state and camera;
- `cli._apply_gui_state` as `tests/test_system_e2e.py::
  test_viewer_overlays_and_gui_state` holds `main._apply_gui_state`;
- a headless tick writes an (h, w, 3) PNG, and the port's CLI on the TUM
  fixture, with `--device cpu` and without `--no-viz`, writes one viewer
  PNG per tick.
"""

import dataclasses
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.runtime import visualization as jviz
from splatt3r_slam_tpu.splat.gaussians import build_covariance, cov_to_triu
from splatt3r_slam_tpu_torch import cli
from splatt3r_slam_tpu_torch.runtime import visualization as tviz
from splatt3r_slam_tpu_torch.utils.image import read_png
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "tum"
HW = (96, 128)
TOL = 5e-4
FRUSTUM, EDGE = (255, 64, 64), (64, 255, 64)


def _scene(seed=0, n_kf=3, h=24, w=32, G=3000):
    rng = np.random.default_rng(seed)
    kfs = []
    for k in range(n_kf):
        ang = 0.05 * k
        q = [0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)]
        T = np.array([0.3 * k, 0.02 * k, 0.0, *q, 1.0], np.float32)
        v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        z = 2.0 + 0.3 * rng.random((h, w))
        X = np.stack([(u - w / 2) * z / w, (v - h / 2) * z / w, z],
                     -1).reshape(-1, 3).astype(np.float32)
        kfs.append(dict(T=T, X=X,
                        uimg=(rng.random((h, w, 3)) * 255).astype(np.uint8),
                        shape=np.array([[h, w]], np.int32)))
    means = np.stack([rng.uniform(-1, 1.5, G), rng.uniform(-0.75, 0.75, G),
                      rng.uniform(1.5, 2.5, G)], -1).astype(np.float32)
    scales = (0.01 + 0.04 * rng.random((G, 3))).astype(np.float32)
    q = rng.normal(size=(G, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cov = np.asarray(cov_to_triu(build_covariance(jnp.asarray(scales),
                                                  jnp.asarray(q))),
                     np.float32)
    pool = np.concatenate([means, cov, rng.random((G, 3)),
                           (0.3 + 0.7 * rng.random(G))[:, None]],
                          -1).astype(np.float32)
    return kfs, pool


def _system(kfs, pool, arr):
    """The duck-typed system with arrays made by `arr`."""
    d = arr(pool)
    return types.SimpleNamespace(
        keyframes=[types.SimpleNamespace(T_WC=arr(k["T"]), X_canon=arr(k["X"]),
                                         uimg=k["uimg"], img_shape=k["shape"])
                   for k in kfs],
        pool=types.SimpleNamespace(
            n=len(pool),
            get_all=lambda: (d[:, 0:3], d[:, 3:9], d[:, 9:12], d[:, 12])),
        backend=types.SimpleNamespace(ii=[0, 1, 0], jj=[1, 2, 2]),
        mode=types.SimpleNamespace(name="TRACKING"),
        current_frame=types.SimpleNamespace(uimg=kfs[-1]["uimg"]))


@pytest.fixture
def viewers(tmp_path):
    kfs, pool = _scene()
    jv = jviz.Viewer(_system(kfs, pool, jnp.asarray), hw=HW,
                     out_dir=str(tmp_path / "jax"), rasterizer="xla")
    tv = tviz.Viewer(_system(kfs, pool, torch.as_tensor), hw=HW,
                     out_dir=str(tmp_path / "torch"), rasterizer="torch")
    return jv, tv


@pytest.mark.parametrize("mode", ["splat", "depth", "surfel", "scatter"])
def test_views_match_jax(viewers, mode):
    jv, tv = viewers
    T = jviz.orbit_pose(np.zeros(3), 4.0, 0.0, 0.3)
    if mode == "scatter":
        view = np.linalg.inv(T).astype(np.float32)
        a = jv.render_pointmap_view(view)
        b = tv.render_pointmap_view(view, tv._kf_mats())
    elif mode == "surfel":
        a, b = jv.render_surfel_view(T), tv.render_surfel_view(T)
    else:
        jv.state.render_mode = tv.state.render_mode = (
            "depth" if mode == "depth" else "rgb")
        a, b = jv.render_gs_view(T), tv.render_gs_view(T)
    assert b.shape == HW + (3,) and b.dtype == np.float32
    assert float(b.max()) > 0.1, "an empty view"
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)


def _colour_mask(img, colour):
    return (img == np.asarray(colour, np.uint8)).all(-1)


def _far(a, b):
    """Largest distance from a pixel set in `a` to the nearest in `b`."""
    pa, pb = np.argwhere(a), np.argwhere(b)
    if len(pa) == 0:
        return 0
    return int(np.abs(pa[:, None] - pb[None]).max(-1).min(1).max()) \
        if len(pb) else np.inf


@pytest.mark.parametrize("gs_on,pointmap_mode", [(True, "surfel"),
                                                 (False, "surfel"),
                                                 (False, "scatter")])
def test_canvas_matches_jax(viewers, gs_on, pointmap_mode):
    jv, tv = viewers
    for v in viewers:
        v.state.gs_on, v.state.pointmap_mode = gs_on, pointmap_mode
    a, b = jv._compose(), tv._compose()
    assert b.shape == HW + (3,) and b.dtype == np.uint8
    for colour in (FRUSTUM, EDGE):
        ma, mb = _colour_mask(a[44:], colour), _colour_mask(b[44:], colour)
        assert mb.any(), f"no {colour} overlay"
        assert _far(ma, mb) <= 1 and _far(mb, ma) <= 1
    lines = (_colour_mask(a, FRUSTUM) | _colour_mask(a, EDGE)
             | _colour_mask(b, FRUSTUM) | _colour_mask(b, EDGE))[44:]
    diff = np.abs(a.astype(int) - b.astype(int)).max(-1)[44:]
    assert int(diff[~lines].max()) <= 1
    # both draw their status text in the top rows
    assert (b[:44] != 0).any() and (a[:44] != 0).any()


KEYS = "qnhadwsoxigpke[],.-= "


def _ui(v):
    return (dataclasses.asdict(v.state), round(v.yaw, 9), round(v.pitch, 9),
            round(v.radius, 9), v.center_offset.round(9).tolist(),
            v.user_cam, v.show_help)


def test_keys_and_mouse_match_jax(viewers):
    import cv2

    jv, tv = viewers
    for key in KEYS + "-==" + "z":  # the max-gaussians cycle, an unbound key
        for v in viewers:
            v._handle_key(ord(key))
        assert _ui(tv) == _ui(jv), key
    events = [
        (cv2.EVENT_LBUTTONDOWN, 10, 10, 0), (cv2.EVENT_MOUSEMOVE, 70, 34, 0),
        (cv2.EVENT_LBUTTONUP, 70, 34, 0), (cv2.EVENT_MOUSEWHEEL, 32, 32, 120),
        (cv2.EVENT_MOUSEWHEEL, 32, 32, -120),
        (cv2.EVENT_RBUTTONDOWN, 20, 20, 0), (cv2.EVENT_MOUSEMOVE, 44, 30, 0),
        (cv2.EVENT_RBUTTONUP, 44, 30, 0),
        (cv2.EVENT_LBUTTONDOWN, 5, 5, 0),
        (cv2.EVENT_MOUSEMOVE, 25, 9, cv2.EVENT_FLAG_SHIFTKEY),
        (cv2.EVENT_MOUSEMOVE, 30, 19, 0), (cv2.EVENT_LBUTTONUP, 30, 19, 0),
        (cv2.EVENT_MOUSEMOVE, 90, 90, 0)]
    for v in viewers:
        v._compose()  # the pan axes come from the last composed camera
    for ev in events:
        for v in viewers:
            v._on_mouse(*ev)
        assert _ui(tv) == _ui(jv), ev
    assert tv.user_cam and float(np.linalg.norm(tv.center_offset)) > 0


def test_apply_gui_state():
    class _Args:
        c_conf_threshold = 1.5

    from splatt3r_slam_tpu_torch.splat import GaussianAccumulator

    sysm = types.SimpleNamespace(
        pool=types.SimpleNamespace(max_gaussians=4096),
        gaussian_module=GaussianAccumulator(spatial_stride=2))
    state = tviz.WindowMsg(max_gaussians=1234, spatial_stride=7,
                           C_conf_threshold=2.5)
    args = _Args()
    cli._apply_gui_state(sysm, args, state)
    assert sysm.pool.max_gaussians == 1234
    assert sysm.gaussian_module.kw["spatial_stride"] == 7
    # C_conf gates the PLY export only; the gaussian filter keeps the flag
    assert sysm.gaussian_module.kw["min_confidence"] == 1.5
    assert args.c_conf_threshold == 2.5
    cli._apply_gui_state(sysm, args, tviz.WindowMsg())  # -1: keep the pool
    assert sysm.pool.max_gaussians == 1234


def test_headless_tick_writes_png(viewers, tmp_path):
    _, tv = viewers
    want = tv._compose()
    state = tv.update()
    assert state is tv.state
    np.testing.assert_array_equal(
        read_png(tmp_path / "torch" / "000000.png"), want)


def test_cli_writes_viewer_pngs(monkeypatch, tmp_path):
    """The default command line: no --no-viz, no DISPLAY."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    ticks = []
    real = tviz.Viewer.update

    def counted(self):
        ticks.append(self.headless)
        return real(self)

    monkeypatch.setattr(tviz.Viewer, "update", counted)
    seq = "rgbd_dataset_freiburg1_fixture"
    assert cli.main(["--dataset", str(FIXTURE / seq), "--config",
                     str(FIXTURE / "eval_fixture.yaml"), "--tiny-model",
                     "--img-size", "64", "--max-frames", "1", "--device",
                     "cpu"]) == 0
    pngs = sorted((tmp_path / "logs" / f"{seq}_viz").glob("*.png"))
    assert ticks == [True] and len(pngs) == 1
    assert read_png(pngs[0]).shape == (48, 64, 3)
