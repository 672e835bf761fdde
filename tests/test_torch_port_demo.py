"""The port's two-image demo (`demo.py`, `runtime/webdemo.py`) against the
JAX package's.

The tiny fp32 model at 64 px, one set of weights in both packages (a
seeded torch state dict converted by the JAX package's converter and
carried back by `params_from_jax`, as `tests/test_torch_port_backend.py`
does). Held:
- `DemoEngine.reconstruct_arrays` gives the same gaussian count and PLY
  arrays within 1e-5 of each array's largest magnitude (fp32 on both
  sides, the model's sums in another order; the random model's means reach
  3e4 and its scales 2e7), 2e-5 for the unit quaternions (normalizing a
  short raw rotation amplifies the rounding: 1.03e-5 seen), on an image
  pair of one size and on a pair whose second image is resampled
  (INTER_AREA in the JAX package, `utils/draw.resize_area` in the port);
- `render` at three orbit poses, on identical gaussians (the JAX scene's
  arrays in both engines: the tile binning's depth order is sensitive to
  the model's fp32 noise, in both packages),
  within 5e-4 on the float images before the uint8 cast (the plain
  compositors' render-order difference, 2.25e-4, with margin) and within
  one level after it;
- the port's HTTP app answers `/`, `/render`, `/gaussians.ply` and the
  404s as `tests/test_webdemo.py` expects of the JAX app; `/render` sends
  the JPEG that the JAX app's `cv2.imencode` (quality 90) writes for
  `engine.render`'s pixels, byte for byte, and a JPEG upload decodes as
  the JAX app's `_decode_image` decodes it, also with cv2 unimportable;
- the demo CLI (`--tiny-model --device cpu`) writes its PLY and its views;
  on the carried weights, its PLY's DC term is the model's raw SH residual
  that the reference `demo.py` writes, within 1e-5 of the JAX model's
  largest value (the web app's PLY holds the image colour there instead).
"""

import base64
import dataclasses
import json
import sys
import threading
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.models import Splatt3RModel as JModel
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
from splatt3r_slam_tpu.runtime import webdemo as jweb
from splatt3r_slam_tpu_torch import demo
from splatt3r_slam_tpu_torch.models import (
    Splatt3RModel,
    TwoViewConfig,
    init_model,
)
from splatt3r_slam_tpu_torch.models.checkpoint import (
    load_state_dict,
    params_from_jax,
)
from splatt3r_slam_tpu_torch.runtime import webdemo
from splatt3r_slam_tpu_torch.utils.image import decode_png, write_png
from splatt3r_slam_tpu_torch.utils.jpeg import decode_jpeg
from test_torch_port_bench import one_torch_thread  # noqa: F401

POSES = ((0.0, 0.2, 0.0), (0.7, -0.1, 0.3), (2.5, 0.4, -0.2))


@pytest.fixture(scope="module")
def engines():
    cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    jcfg_m = JConfig(dtype="float32", head_dtype="float32").tiny()
    seed_model = init_model(cfg, seed=0, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in seed_model.state_dict().items()}, jcfg_m))
    tm = Splatt3RModel(cfg)
    assert load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg)) == []
    return (jweb.DemoEngine(JModel(jcfg_m), jp, img_size=64, k_max=64),
            webdemo.DemoEngine(tm.eval(), img_size=64, k_max=64,
                               device="cpu"))


def _pair(seed, second=(48, 64)):
    rng = np.random.default_rng(seed)
    base = rng.random((60, 80, 3)).astype(np.float32)
    return [base[:48, :64], cv2.resize(np.ascontiguousarray(base[5:53, 4:68]),
                                       second[::-1])]


@pytest.mark.parametrize("second", [(48, 64), (40, 56)])
def test_reconstruct_matches_jax(engines, second):
    je, te = engines
    imgs = _pair(0, second)
    js, ts = je.reconstruct_arrays(imgs), te.reconstruct_arrays(imgs)
    n = ts.ply_arrays["means"].shape[0]
    assert n == js.ply_arrays["means"].shape[0] == 2 * 48 * 64
    assert ts.hw == js.hw == (48, 64)
    for k, want in js.ply_arrays.items():
        tol = 2e-5 if k == "rotations" else 1e-5
        np.testing.assert_allclose(ts.ply_arrays[k], want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=k)
    peak = np.abs(js.ply_arrays["means"]).max()
    np.testing.assert_allclose(ts.center, js.center, rtol=0,
                               atol=1e-5 * peak)
    assert ts.radius == pytest.approx(js.radius, rel=1e-5)
    assert je.ply_bytes()[:200] == te.ply_bytes()[:200]


def test_render_matches_jax(engines):
    """Each engine's orbit camera and plain compositor on the JAX engine's
    scene, its gaussians put in depth order for each pose: the random
    model's depths span ~1e4, so the JAX package's 18-bit depth keys tie
    and composite in index order there, where the port's binning uses the
    exact depth order (`tests/test_torch_port_rasterizer.py::
    test_depth_key_ties_composite_in_depth_order`); in depth order the two
    orders agree."""
    from splatt3r_slam_tpu_torch.splat.rasterizer import project_gaussians

    je, te = engines
    js = je.reconstruct_arrays(_pair(1))
    arrs = [torch.as_tensor(np.array(a)) for a in (
        js.means, js.cov_triu, js.colors, js.opacities)]
    for pose in POSES:
        view, K = webdemo.orbit_view(js.center, max(js.radius + pose[2],
                                                    0.05), pose[0], pose[1],
                                     js.hw, "cpu")
        _, _, depth, _, ok = project_gaussians(arrs[0], arrs[1], arrs[3],
                                               view, K, js.hw)
        order = torch.argsort(torch.where(ok, depth, torch.inf),
                              stable=True)
        sorted_arrs = [a[order] for a in arrs]
        je.scene = dataclasses.replace(
            js, **dict(zip(("means", "cov_triu", "colors", "opacities"),
                           (jnp.asarray(a.numpy()) for a in sorted_arrs))))
        te.scene = webdemo.Scene(
            *sorted_arrs, ply_arrays=js.ply_arrays, hw=js.hw,
            center=js.center, radius=js.radius)
        ja = np.asarray(_jax_float(je, pose))
        tb = _torch_float(te, pose)
        assert float(tb.max()) > 0.05, "an empty render"
        np.testing.assert_allclose(tb, ja, rtol=0, atol=5e-4)
        a, b = je.render(*pose), te.render(*pose)
        assert b.shape == (48, 64, 3) and b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _jax_float(je, pose):
    from splatt3r_slam_tpu.runtime.visualization import (
        orbit_pose,
        vfov_to_intrinsics,
    )
    from splatt3r_slam_tpu.splat.rasterizer import render_tiles

    s = je.scene
    T = orbit_pose(s.center, max(s.radius + pose[2], 0.05), *pose[:2])
    return np.clip(np.asarray(render_tiles(
        s.means, s.cov_triu, s.colors, s.opacities,
        jnp.asarray(np.linalg.inv(T), jnp.float32),
        jnp.asarray(vfov_to_intrinsics(60.0, *s.hw)), s.hw, k_max=je.k_max)),
        0, 1)


def _torch_float(te, pose):
    from splatt3r_slam_tpu_torch.splat.rasterizer import render_tiles

    s = te.scene
    view, K = webdemo.orbit_view(s.center, max(s.radius + pose[2], 0.05),
                                 pose[0], pose[1], s.hw, te.device)
    return np.clip(render_tiles(s.means, s.cov_triu, s.colors, s.opacities,
                                view, K, s.hw, k_max=te.k_max).numpy(), 0, 1)


@pytest.fixture(scope="module")
def server(engines):
    engine = engines[1]
    saved = engine.scene
    engine.scene = None
    srv = webdemo.serve(engine, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", engine
    finally:
        srv.shutdown()
        srv.server_close()
        engine.scene = saved


def _b64(ext, img_u8):
    ok, buf = cv2.imencode(ext, img_u8)
    assert ok
    return f"data:image/{ext[1:]};base64," + base64.b64encode(
        buf.tobytes()).decode()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=600) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def test_http_app(server, monkeypatch):
    url, engine = server
    code, body, ctype = _get(url + "/")
    assert code == 200 and ctype == "text/html" and b"reconstruct" in body
    for path in ("/render", "/gaussians.ply", "/nothing"):
        assert _get(url + path)[0] == 404, path
    assert _post(url + "/nothing", {})[0] == 404

    rng = np.random.default_rng(0)
    base = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    imgs = [_b64(".png", base), _b64(".png", np.roll(base, 5, axis=1))]
    code, out = _post(url + "/reconstruct", {"images": imgs})
    assert code == 200 and out["ok"] and out["n_gaussians"] == 2 * 48 * 64

    def jax_app_jpeg(img):  # what `webdemo.py:264-267` sends
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        return buf.tobytes()

    code, body, ctype = _get(url + "/render?yaw=0.3&pitch=0.1")
    assert code == 200 and ctype == "image/jpeg"
    assert body == jax_app_jpeg(engine.render(0.3, 0.1))
    np.testing.assert_array_equal(
        decode_jpeg(body),
        cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)[
            ..., ::-1])
    code, body, _ = _get(url + "/render?yaw=bad")  # defaults for junk
    assert body == jax_app_jpeg(engine.render())

    code, ply, _ = _get(url + "/gaussians.ply")
    assert code == 200 and ply.startswith(b"ply")
    assert f"element vertex {out['n_gaussians']}".encode() in ply

    # one image is duplicated; bad input and no images are 400s
    code, out = _post(url + "/reconstruct", {"images": imgs[:1]})
    assert code == 200 and out["ok"]
    code, out = _post(url + "/reconstruct",
                      {"images": ["data:image/png;base64,not-base64!"]})
    assert code == 400 and not out["ok"]
    assert _post(url + "/reconstruct", {"images": []})[0] == 400

    # JPEG uploads: decoded as the JAX app decodes them, and without cv2
    jpg = [_b64(".jpg", base)]
    np.testing.assert_array_equal(webdemo._decode_image(jpg[0]),
                                  jweb._decode_image(jpg[0]))
    code, out = _post(url + "/reconstruct", {"images": jpg})
    assert code == 200 and out["ok"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    code, out = _post(url + "/reconstruct", {"images": jpg})
    assert code == 200 and out["ok"] and out["n_gaussians"] == 2 * 48 * 64
    code, body, ctype = _get(url + "/render")
    assert code == 200 and ctype == "image/jpeg"
    assert decode_jpeg(body).shape == (48, 64, 3)


def test_demo_cli(tmp_path):
    rng = np.random.default_rng(2)
    base = (rng.random((60, 80, 3)) * 255).astype(np.uint8)
    write_png(tmp_path / "a.png", base[:48, :64])
    write_png(tmp_path / "b.png", base[4:52, 6:70])
    out = tmp_path / "out"
    assert demo.main([str(tmp_path / "a.png"), str(tmp_path / "b.png"),
                      "--out", str(out), "--n-views", "3", "--img-size",
                      "64", "--tiny-model", "--device", "cpu"]) == 0
    ply = (out / "gaussians.ply").read_bytes()
    assert b"element vertex 6144\n" in ply
    views = sorted(out.glob("view_*.png"))
    assert [p.name for p in views] == [f"view_{i:03d}.png" for i in range(3)]
    assert all(decode_png(p.read_bytes()).shape == (48, 64, 3)
               for p in views)
    with pytest.raises(SystemExit):
        demo.main(["--device", "cpu"])  # two images or --serve


def test_demo_ply_is_reference_demo_residual(engines, tmp_path):
    """The reference `demo.py` writes `res["sh"]` of both views into the
    PLY's f_dc fields; the port's demo CLI writes the same arrays."""
    from splatt3r_slam_tpu.utils.image import resize_img as j_resize

    je, te = engines
    rng = np.random.default_rng(3)
    base = (rng.random((60, 80, 3)) * 255).astype(np.uint8)
    paths = [tmp_path / "a.png", tmp_path / "b.png"]
    write_png(paths[0], base[:48, :64])
    write_png(paths[1], base[5:53, 4:68])
    out = tmp_path / "out"
    assert demo.main([str(paths[0]), str(paths[1]), "--out", str(out),
                      "--n-views", "1", "--img-size", "64", "--device",
                      "cpu"], model=te.model) == 0
    data = (out / "gaussians.ply").read_bytes()
    head, body = data.split(b"end_header\n", 1)
    names = [ln.split()[-1].decode() for ln in head.splitlines()
             if ln.startswith(b"property")]
    rec = np.frombuffer(body, dtype=[(nm, "<f4") for nm in names])
    got = np.stack([rec[f"f_dc_{i}"] for i in range(3)], -1)
    ims = [jnp.asarray(j_resize(decode_png(p.read_bytes()).astype(
        np.float32) / 255.0, 64)["img"]) for p in paths]
    r1, r2 = je.model.apply({"params": je.params}, *ims)
    want = np.concatenate([np.asarray(r["sh"][0]).reshape(-1, 3, 1)[:, :, 0]
                           for r in (r1, r2)])
    assert got.shape == want.shape == (2 * 48 * 64, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # and not the web app's PLY, whose DC term folds in the image colour
    sh = te.reconstruct_arrays([decode_png(p.read_bytes()).astype(
        np.float32) / 255.0 for p in paths]).ply_arrays["sh"][:, :, 0]
    assert np.abs(sh - want).max() > 0.1
