"""The port's host I/O against the JAX package and the libraries it uses.

Covers `config.py` (its own YAML reader), `utils/image.py` (PNG through
zlib + struct, bilinear resize), `runtime/dataloader.py`,
`runtime/frame.py::create_frame` and `runtime/evaluate.py`.

Tolerances: the YAML reader equals `yaml.load` (with the JAX package's
extended float resolver) exactly; `read_png` equals `cv2.imread` (BGR→RGB)
exactly; the resize is within 1 uint8 step of
`splatt3r_slam_tpu.native.resize_img_native` (g++ -O3 -march=native may
contract the C++ weighted sum into FMAs, so exact equality is not
guaranteed; the share of differing pixels is printed); trajectory text is
equal; point clouds within 1e-6.
"""

import copy
import glob
import pathlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu import native
from splatt3r_slam_tpu.lie import sim3 as jsim3
from splatt3r_slam_tpu.runtime import dataloader as jdl
from splatt3r_slam_tpu.runtime import evaluate as jev
from splatt3r_slam_tpu.runtime.frame import create_frame as j_create_frame
from splatt3r_slam_tpu_torch import config as tcfg
from splatt3r_slam_tpu_torch.lie import sim3
from splatt3r_slam_tpu_torch.runtime import dataloader as tdl
from splatt3r_slam_tpu_torch.runtime import evaluate as tev
from splatt3r_slam_tpu_torch.runtime.frame import create_frame
from splatt3r_slam_tpu_torch.utils.image import read_png, resize_img, write_png
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ = ROOT / "tests" / "fixtures" / "tum" / "rgbd_dataset_freiburg1_fixture"
YAMLS = sorted(str(p.relative_to(ROOT)) for p in
               list((ROOT / "config").glob("*.yaml"))
               + list((ROOT / "tests" / "fixtures").rglob("*.yaml")))
PNGS = sorted(glob.glob(str(SEQ / "rgb" / "*.png")))


@pytest.fixture
def both_configs():
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    yield
    jcfg.set_global_config(saved[0])
    tcfg.set_global_config(saved[1])


def _pyyaml(text):
    class Loader(yaml.SafeLoader):
        pass

    Loader.add_implicit_resolver("tag:yaml.org,2002:float", tcfg._FLOAT_RE,
                                 list("-+0123456789."))
    return yaml.load(text, Loader=Loader)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_reader_matches_pyyaml(path):
    text = (ROOT / path).read_text()
    assert tcfg.parse_yaml(text, path) == _pyyaml(text)


@pytest.mark.parametrize("path", YAMLS)
def test_load_config_matches_jax(path, both_configs):
    want = jcfg.load_config(str(ROOT / path))
    assert tcfg.load_config(str(ROOT / path)) == want
    assert tcfg.config == jcfg.config


def test_yaml_reader_subset():
    text = ("a: 'x # y'  # c\nb: \"q\\tz\"\nc:\nd:\n  e: [1, 2.5, -3e-2]\n"
            "  f: on\n  g: ~\n  h: 1_000\n  i: .5e+3\n  j: -.5\n"
            "  k: [x, y]\n  l: [x, 'y, z', 1, off]\n")
    assert tcfg.parse_yaml(text) == _pyyaml(text)
    for bad in ("- a", "a: &x 1", "a: {b: 1}", "a: 0x10", "a: 010",
                "a: |\n  x", "a: [x, [y]]", "a: 2001-01-01", "a: b: c",
                "a: 1\n  b: 2", "---\na: 1", "a: !!str 1"):
        with pytest.raises(ValueError):
            tcfg.parse_yaml(bad)


def test_read_png_matches_cv2_on_fixture_frames():
    assert len(PNGS) == 24
    for p in PNGS:
        want = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read_png(p), want, err_msg=p)


@pytest.mark.parametrize("mode", ["none", "sub", "up", "avg", "paeth", "all",
                                  "gray", "rgba"])
def test_read_png_matches_cv2_per_filter(mode, tmp_path):
    rng = np.random.default_rng(1)
    # smooth + noise, so that every filter type has something to predict
    yy, xx = np.mgrid[0:29, 0:41]
    img = ((np.stack([yy * 7, xx * 5, yy + xx], -1) % 256)
           + rng.integers(0, 9, (29, 41, 3))).astype(np.uint8)
    flag = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
            "sub": cv2.IMWRITE_PNG_FILTER_SUB,
            "up": cv2.IMWRITE_PNG_FILTER_UP,
            "avg": cv2.IMWRITE_PNG_FILTER_AVG,
            "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}.get(
                mode, cv2.IMWRITE_PNG_ALL_FILTERS)
    if mode == "gray":
        img = img[..., 0]
    elif mode == "rgba":
        img = np.concatenate([img, img[..., :1]], -1)
    path = str(tmp_path / "f.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
    want = cv2.imread(path)  # BGR; alpha dropped, gray replicated
    np.testing.assert_array_equal(read_png(path),
                                  cv2.cvtColor(want, cv2.COLOR_BGR2RGB))


def test_write_png_round_trip(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (13, 17, 3), np.uint8)
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(str(tmp_path / "w.png")), cv2.COLOR_BGR2RGB),
        img)
    with pytest.raises(ValueError):
        (tmp_path / "bad.png").write_bytes(b"not a png")
        read_png(tmp_path / "bad.png")


def _resize_cases():
    fixture = cv2.cvtColor(cv2.imread(PNGS[0]), cv2.COLOR_BGR2RGB)
    seeded = np.random.default_rng(0).integers(0, 256, (480, 640, 3),
                                               np.uint8)
    return {"fixture-512": (fixture, 512), "fixture-64": (fixture, 64),
            "seeded-480x640-512": (seeded, 512),
            "seeded-float-512": (seeded.astype(np.float32) / 255.0, 512)}


@pytest.mark.parametrize("case", ["fixture-512", "fixture-64",
                                  "seeded-480x640-512", "seeded-float-512"])
def test_resize_matches_native(case):
    if not native.available():
        pytest.skip("the JAX package's native helper did not build")
    img, size = _resize_cases()[case]
    got = resize_img(img, size)
    want = native.resize_img_native(img, size)
    np.testing.assert_array_equal(got["true_shape"], want["true_shape"])
    d = np.abs(got["unnormalized_img"].astype(np.int16)
               - want["unnormalized_img"].astype(np.int16))
    print(f"{case}: {(d > 0).mean():.3e} of the uint8 values differ, "
          f"largest difference {d.max()}")
    assert d.max() <= 1
    np.testing.assert_allclose(got["img"], (want["unnormalized_img"][None]
                                            / 255.0 - 0.5) / 0.5,
                               atol=2 / 255 + 1e-6)


def test_resize_geometry_matches_jax():
    """Shapes of the reference geometry: landscape, portrait, square (3:4
    exception) and 224."""
    from splatt3r_slam_tpu.utils.image import resize_img as j_resize

    rng = np.random.default_rng(4)
    for hw, size in (((240, 320), 512), ((320, 240), 512), ((300, 300), 512),
                     ((240, 320), 224), ((77, 131), 64)):
        img = rng.integers(0, 256, hw + (3,), np.uint8)
        np.testing.assert_array_equal(resize_img(img, size)["true_shape"],
                                      j_resize(img, size)["true_shape"])
    with pytest.raises(ValueError, match="multiple of 16"):
        resize_img(img, 100)


def test_create_frame_resizes_fixture_frame():
    img = cv2.cvtColor(cv2.imread(PNGS[3]), cv2.COLOR_BGR2RGB)
    img = img.astype(np.float32) / 255.0  # as the dataset hands it over
    for size in (512, 64):
        f = create_frame(0, img, img_size=size, device="cpu")
        jf = j_create_frame(0, img, img_size=size)
        np.testing.assert_array_equal(f.img_shape, np.asarray(jf.img_shape))
        d = np.abs(f.uimg.astype(np.int16) - np.asarray(jf.uimg, np.int16))
        print(f"create_frame {size}: {(d > 0).mean():.3e} differ")
        assert d.max() <= 1
        np.testing.assert_allclose(f.img.numpy(), np.asarray(jf.img),
                                   atol=2 / 127.5)


def test_tum_dataset_matches_jax(both_configs):
    jcfg.load_config(str(ROOT / "config" / "eval_no_calib.yaml"))
    tcfg.load_config(str(ROOT / "config" / "eval_no_calib.yaml"))
    jds, tds = jdl.load_dataset(str(SEQ)), tdl.load_dataset(str(SEQ))
    assert isinstance(tds, tdl.TUMDataset) and len(tds) == len(jds) == 24
    # timestamps stay the strings of rgb.txt, as the trajectory prints them
    assert all(isinstance(t, str) for t in tds.timestamps)
    assert tds.timestamps == [str(t) for t in jds.timestamps]
    assert tds.timestamps[1] == "1000.033333"
    for ds in (jds, tds):
        ds.img_size = 64
        ds.subsample(2)
    assert tds.get_img_shape() == jds.get_img_shape() == ((48, 64),
                                                          (240, 320))
    for i in (0, 5):
        (tt, ti), (jt, ji) = tds[i], jds[i]
        assert tt == str(jt)
        assert ti.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
    assert tds.camera_intrinsics is None and not tds.has_calib()


def test_dataloader_dispatch_and_unported_inputs(tmp_path, both_configs):
    tcfg.reset_config()
    rgb = tmp_path / "frames"
    rgb.mkdir()
    for i in (10, 2, 1):
        write_png(rgb / f"f{i}.png", np.full((32, 48, 3), i, np.uint8))
    ds = tdl.load_dataset(str(rgb))
    assert isinstance(ds, tdl.RGBFiles)
    assert [p.name for p in ds.rgb_files] == ["f1.png", "f2.png", "f10.png"]
    assert ds[2][1].max() == pytest.approx(10 / 255)
    assert tdl.Intrinsics.from_calib(512, 640, 480, [1, 1, 1, 1]) is None
    # calibrated input is ported (tests/test_torch_port_calib.py)
    tcfg.config["use_calib"] = True
    intr = tdl.Intrinsics.from_calib(512, 640, 480, [500, 500, 320, 240])
    assert intr.mapx.shape == intr.mapy.shape == (480, 640)
    np.testing.assert_allclose(intr.K_frame[0, 0], intr.K[0, 0] * 512 / 640,
                               rtol=1e-6)
    # a EuRoC path goes to the EuRoC reader, which needs mav0/cam0
    with pytest.raises(FileNotFoundError, match="data.csv"):
        tdl.load_dataset(str(tmp_path / "euroc" / "MH_01"))
    with pytest.raises(ImportError, match="pyrealsense2"):
        tdl.load_dataset("realsense")


def _keyframes(rng, n=3, size=64):
    """The same keyframes in both packages: frames of the fixture with
    seeded poses, pointmaps and confidences."""
    jk, tk = [], []
    for i in range(n):
        img = cv2.cvtColor(cv2.imread(PNGS[2 * i]), cv2.COLOR_BGR2RGB)
        jf = j_create_frame(2 * i, img, img_size=size)
        tf = create_frame(2 * i, img, img_size=size, device="cpu")
        xi = (rng.normal(size=7) * 0.3).astype(np.float32)
        T = np.asarray(jsim3.exp(jnp.asarray(xi)))
        N = 48 * 64
        X = rng.normal(size=(N, 3)).astype(np.float32)
        C = (1 + 3 * rng.random((N, 1))).astype(np.float32)
        jf.T_WC, jf.X_canon, jf.C, jf.N = jnp.asarray(T), jnp.asarray(X), \
            jnp.asarray(C), 2
        tf.T_WC, tf.X_canon, tf.C, tf.N = torch.from_numpy(T), \
            torch.from_numpy(X), torch.from_numpy(C), 2
        jk.append(jf)
        tk.append(tf)
    return jk, tk


def test_writers_match_jax(tmp_path, both_configs):
    jcfg.load_config(str(ROOT / "config" / "base.yaml"))
    tcfg.reset_config()
    jk, tk = _keyframes(np.random.default_rng(5))
    ts = [f"1000.{k:06d}" for k in range(6)]
    jev.save_traj(tmp_path / "j", "t.txt", ts, jk)
    tev.save_traj(tmp_path / "t", "t.txt", ts, tk)
    assert (tmp_path / "t" / "t.txt").read_text() == \
        (tmp_path / "j" / "t.txt").read_text()
    jev.save_reconstruction(tmp_path / "j", "r.ply", jk, 1.5)
    tev.save_reconstruction(tmp_path / "t", "r.ply", tk, 1.5)
    jp, jc = jev.load_ply(tmp_path / "j" / "r.ply")
    tp, tc = tev.load_ply(tmp_path / "t" / "r.ply")
    assert len(tp) == len(jp) > 0
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_array_equal(tc, jc)
    jev.save_keyframes(tmp_path / "j" / "k", ts, jk)
    tev.save_keyframes(tmp_path / "t" / "k", ts, tk)
    names = sorted(p.name for p in (tmp_path / "j" / "k").glob("*.png"))
    assert names == sorted(p.name for p in
                           (tmp_path / "t" / "k").glob("*.png"))
    for n in names:
        np.testing.assert_array_equal(read_png(tmp_path / "t" / "k" / n),
                                      read_png(tmp_path / "j" / "k" / n))


def test_ate_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    t_gt = np.arange(0.0, 1.0, 0.05)
    p_gt = np.cumsum(rng.normal(size=(len(t_gt), 3)), axis=0) * 0.1
    keep = np.arange(0, len(t_gt), 3)
    t_es = t_gt[keep] + 0.004
    p_es = p_gt[keep] * 1.7 + rng.normal(size=(len(keep), 3)) * 0.01
    q = np.tile([0, 0, 0, 1.0], (len(t_gt), 1))
    np.savetxt(tmp_path / "gt.txt", np.column_stack([t_gt, p_gt, q]))
    np.savetxt(tmp_path / "es.txt", np.column_stack([t_es, p_es, q[keep]]))
    for a, b in zip(tev.associate(t_gt, t_es), jev.associate(t_gt, t_es)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tev.umeyama_alignment(p_es, p_gt[keep]),
                    jev.umeyama_alignment(p_es, p_gt[keep])):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert tev.ate_rmse(tmp_path / "gt.txt", tmp_path / "es.txt") == \
        jev.ate_rmse(tmp_path / "gt.txt", tmp_path / "es.txt")
    assert sim3.to_se3(sim3.identity(device="cpu")).shape == (7,)
