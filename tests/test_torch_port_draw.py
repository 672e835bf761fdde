"""The port's drawing and resampling (`utils/draw.py`) against cv2.

The JAX viewer and web demo draw and resample with OpenCV; the GPU host has
none, so the port does it in numpy. Held here, on seeded inputs:
- `TURBO` equals cv2.COLORMAP_TURBO's table, and `depth2rgb` equals the
  JAX package's exactly;
- `resize_linear_u8` differs from cv2.resize(INTER_LINEAR) in 0 values at
  384x512 → 96x128 and by at most one level at sizes not divisible by 4;
- `resize_area` is within 1e-5 of cv2.resize(INTER_AREA) on float32;
- every pixel `line` / `rectangle` draws lies within 1 px of one cv2
  draws, and the reverse (the count of differing pixels is reported: 0 on
  this cv2);
- `put_text` draws the port's bitmap font (not cv2's Hershey strokes)
  inside the band cv2's text occupies.
"""

import cv2
import numpy as np
import pytest
import torch

from splatt3r_slam_tpu.runtime import visualization as jviz
from splatt3r_slam_tpu_torch.runtime import visualization as tviz
from splatt3r_slam_tpu_torch.utils import draw
from test_torch_port_bench import one_torch_thread  # noqa: F401


def test_turbo_is_cv2s_table():
    ramp = np.arange(256, dtype=np.uint8)[:, None]
    want = cv2.applyColorMap(ramp, cv2.COLORMAP_TURBO)[:, 0, ::-1]
    assert draw.TURBO.shape == (256, 3) and draw.TURBO.dtype == np.uint8
    np.testing.assert_array_equal(draw.TURBO, want)


def test_depth2rgb_matches_jax():
    rng = np.random.default_rng(0)
    d = (rng.random((40, 52)) * 12).astype(np.float32)
    for lo, hi in ((0.1, 10.0), (1.3, 4.2), (2.0, 2.0)):
        np.testing.assert_array_equal(tviz.depth2rgb(d, lo, hi),
                                      jviz.depth2rgb(d, lo, hi))


@pytest.mark.parametrize("src,dst", [((384, 512), (96, 128)),
                                     ((48, 64), (12, 16)),
                                     ((50, 70), (13, 17)),
                                     ((383, 509), (95, 127)),
                                     ((30, 40), (77, 91))])
def test_resize_linear_u8_matches_cv2(src, dst):
    rng = np.random.default_rng(sum(src + dst))
    img = (rng.random(src + (3,)) * 255).astype(np.uint8)
    got = draw.resize_linear_u8(img, dst[::-1])
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    if all(s % d == 0 and s // d == 4 for s, d in zip(src, dst)):
        assert int((diff > 0).sum()) == 0
    assert diff.max() <= 1
    # single channel too
    g = draw.resize_linear_u8(img[..., 0], dst[::-1])
    assert g.shape == dst
    assert np.abs(g.astype(int) - want[..., 0]).max() <= 1


@pytest.mark.parametrize("src,dst", [((48, 64), (12, 16)),
                                     ((50, 70), (13, 17)),
                                     ((100, 100), (37, 61)),
                                     ((30, 40), (77, 91)),
                                     ((48, 64), (60, 50))])
def test_resize_area_matches_cv2(src, dst):
    rng = np.random.default_rng(sum(src + dst))
    img = rng.random(src + (3,)).astype(np.float32)
    got = draw.resize_area(img, dst[::-1])
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _within_1px(a, b):
    """Largest Chebyshev distance from a pixel set in `a` to the nearest
    pixel set in `b` (0 for an empty `a`)."""
    pa, pb = np.argwhere(a), np.argwhere(b)
    if len(pa) == 0:
        return 0
    if len(pb) == 0:
        return np.inf
    return int(np.abs(pa[:, None] - pb[None]).max(-1).min(1).max())


def test_line_and_rectangle_match_cv2():
    rng = np.random.default_rng(3)
    differing = 0
    for t in range(600):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        p0 = tuple(int(v) for v in rng.integers(-300, 300, 2))
        p1 = tuple(int(v) for v in rng.integers(-300, 300, 2))
        if t % 3 == 0:  # one end inside the image
            p0 = tuple(int(v) for v in rng.integers(0, 5, 2))
        got = np.zeros((h, w, 3), np.uint8)
        want = got.copy()
        draw.line(got, p0, p1, (255, 64, 64))
        cv2.line(want, p0, p1, (255, 64, 64), 1)
        a, b = got.any(-1), want.any(-1)
        assert _within_1px(a, b) <= 1 and _within_1px(b, a) <= 1, (p0, p1)
        assert (got[a] == (255, 64, 64)).all()
        differing += int((a != b).sum())
    for corners in (((10, 5), (70, 50)), ((-5, 3), (30, 80)),
                    ((60, 40), (2, 2))):
        got = np.zeros((60, 80, 3), np.uint8)
        want = got.copy()
        draw.rectangle(got, *corners, (255, 255, 255))
        cv2.rectangle(want, *corners, (255, 255, 255), 1)
        a, b = got.any(-1), want.any(-1)
        assert _within_1px(a, b) <= 1 and _within_1px(b, a) <= 1
        differing += int((a != b).sum())
    print(f"pixels differing from cv2's: {differing}")


def test_put_text_draws_in_cv2s_band():
    text = "gaussians: 123  kfs: 4  mode: TRACKING"
    for scale in (0.5, 0.45, 0.4):
        got = np.zeros((40, 320, 3), np.uint8)
        want = got.copy()
        draw.put_text(got, text, (8, 20), scale, (255, 255, 255))
        cv2.putText(want, text, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, scale,
                    (255, 255, 255), 1)
        ys, xs = np.nonzero(got.any(-1))
        wy, wx = np.nonzero(want.any(-1))
        assert len(ys) > 0.5 * len(wy)
        assert abs(int(ys.min()) - int(wy.min())) <= 2
        assert abs(int(ys.max()) - int(wy.max())) <= 2
        assert abs(int(xs.max()) - int(wx.max())) <= len(text) // 2
    # clipped at the border, and unknown characters drawn as '?'
    img = np.zeros((10, 10, 3), np.uint8)
    draw.put_text(img, "é", (-3, 12), 0.5, (1, 2, 3))
    q = np.zeros((10, 10, 3), np.uint8)
    draw.put_text(q, "?", (-3, 12), 0.5, (1, 2, 3))
    np.testing.assert_array_equal(img, q)


def test_viewer_mouse_codes_are_cv2s():
    assert (tviz.EVENT_MOUSEMOVE, tviz.EVENT_LBUTTONDOWN,
            tviz.EVENT_RBUTTONDOWN, tviz.EVENT_MBUTTONDOWN,
            tviz.EVENT_LBUTTONUP, tviz.EVENT_RBUTTONUP,
            tviz.EVENT_MBUTTONUP, tviz.EVENT_MOUSEWHEEL,
            tviz.EVENT_FLAG_SHIFTKEY) == (
        cv2.EVENT_MOUSEMOVE, cv2.EVENT_LBUTTONDOWN, cv2.EVENT_RBUTTONDOWN,
        cv2.EVENT_MBUTTONDOWN, cv2.EVENT_LBUTTONUP, cv2.EVENT_RBUTTONUP,
        cv2.EVENT_MBUTTONUP, cv2.EVENT_MOUSEWHEEL, cv2.EVENT_FLAG_SHIFTKEY)
    assert torch.get_num_threads() == 1
