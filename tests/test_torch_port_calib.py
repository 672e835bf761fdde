"""Calibrated input in the port (`runtime/dataloader.py`, `cli.py --calib`)
against OpenCV and the JAX package.

The port undistorts in numpy, without cv2: `optimal_new_camera_matrix`,
`undistort_rectify_map` and `Intrinsics.remap` are held against the OpenCV
calls the JAX package makes (`getOptimalNewCameraMatrix` with alpha 0,
`initUndistortRectifyMap` with float32 maps, `remap` bilinear with a
constant border of 0) for TUM fr1/fr2/fr3 and EuRoC cam0, both
`centerPrincipalPoint` values: the camera matrix within 1e-6 relative, the
maps within 1e-3 px, and the remap on every value (the port replays
OpenCV's float arithmetic, so all values are equal and the largest
difference is 0). Then `K_frame`, calibrated TUM frames and fabricated EuRoC
frames against the JAX package's datasets, EuRoC's `sensor.yaml`, a
subprocess in which `import cv2` fails, and `--calib` through both CLIs.
"""

import copy
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from splatt3r_slam_tpu import config as jcfg
from splatt3r_slam_tpu.runtime import dataloader as jdl
from splatt3r_slam_tpu_torch import config as tcfg
from splatt3r_slam_tpu_torch.runtime import dataloader as tdl
from splatt3r_slam_tpu_torch.utils.image import read_png, write_png

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_port_cli import ARGS, FIXTURE, SEQ  # noqa: E402
from test_torch_port_cli import fabricated_ckpt  # noqa: E402,F401
from test_torch_port_bench import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
EUROC_K = [458.654, 457.296, 367.215, 248.375]
EUROC_DIST = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
CAMERAS = {
    "fr1": (tdl.TUMDataset._CALIB[1], 640, 480),
    "fr2": (tdl.TUMDataset._CALIB[2], 640, 480),
    "fr3": (tdl.TUMDataset._CALIB[3], 640, 480),
    "euroc": (EUROC_K + EUROC_DIST, 752, 480),
}
# EuRoC MAV cam0's sensor.yaml as the dataset ships it: OpenCV's directive
# line, a nested map whose flow list spans lines, comments after values
SENSOR_YAML = """%YAML:1.0
---
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


def _camera(name):
    calib, W, H = CAMERAS[name]
    fx, fy, cx, cy = calib[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    dist = np.array(calib[4:] or [0.0] * 4, np.float64)
    return K, dist, W, H


@pytest.fixture
def configs():
    """Both packages' global configs, restored afterwards."""
    saved = (copy.deepcopy(jcfg.config), copy.deepcopy(tcfg.config))
    yield jcfg.config, tcfg.config
    jcfg.set_global_config(saved[0])
    tcfg.set_global_config(saved[1])


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_undistortion_matches_opencv(name, center):
    K, dist, W, H = _camera(name)
    want, _ = cv2.getOptimalNewCameraMatrix(K, dist, (W, H), 0, (W, H),
                                            centerPrincipalPoint=center)
    got = tdl.optimal_new_camera_matrix(K, dist, (W, H), center)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    mx, my = cv2.initUndistortRectifyMap(K, dist, None, want, (W, H),
                                         cv2.CV_32FC1)
    gx, gy = tdl.undistort_rectify_map(K, dist, want, (W, H))
    assert gx.dtype == gy.dtype == np.float32
    assert gx.shape == gy.shape == (H, W)
    np.testing.assert_allclose(gx, mx, rtol=0, atol=1e-3)
    np.testing.assert_allclose(gy, my, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["fr1", "euroc"])
def test_remap_matches_opencv(name):
    """Seeded frames through the alpha-0 maps and through maps whose
    sources leave the image (a focal length cut to 0.6, so the constant
    border shows): every value equal to cv2.remap's."""
    K, dist, W, H = _camera(name)
    rng = np.random.default_rng(3)
    K_opt = tdl.optimal_new_camera_matrix(K, dist, (W, H))
    K_wide = K.copy()
    K_wide[:2, :2] *= 0.6
    for K_new in (K_opt, K_wide):
        mx, my = tdl.undistort_rectify_map(K, dist, K_new, (W, H))
        intr = tdl.Intrinsics(512, W, H, K, K_new, dist, mx, my)
        noise = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        ramp = np.broadcast_to(
            (np.arange(W) * 255 // (W - 1)).astype(np.uint8)[None, :, None],
            (H, W, 3))
        for img in (noise, np.ascontiguousarray(ramp)):
            want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
            got = intr.remap(img)
            diff = np.abs(got.astype(np.int32) - want)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert (diff == 0).mean() == 1.0 and diff.max() == 0, \
                f"{(diff == 0).mean():.6f} equal, largest difference " \
                f"{diff.max()}"
    assert (mx < 0).any(), "the wide maps never leave the image"


@pytest.mark.parametrize("img_size", [512, 224, 64])
def test_k_frame_matches_jax(configs, img_size):
    jc, tc = configs
    for center in (True, False):
        jc.setdefault("dataset", {})["center_principle_point"] = center
        tc.setdefault("dataset", {})["center_principle_point"] = center
        for name in sorted(CAMERAS):
            calib, W, H = CAMERAS[name]
            want = jdl.Intrinsics.from_calib(img_size, W, H, calib,
                                             always_undistort=True)
            got = tdl.Intrinsics.from_calib(img_size, W, H, calib,
                                            always_undistort=True)
            assert got.K_frame.dtype == np.float32
            np.testing.assert_allclose(got.K_frame, want.K_frame, rtol=1e-6,
                                       err_msg=f"{name} {center}")
            np.testing.assert_allclose(got.K, want.K, rtol=1e-6)
            np.testing.assert_allclose(got.mapx, want.mapx, rtol=0,
                                       atol=1e-3)
            np.testing.assert_allclose(got.mapy, want.mapy, rtol=0,
                                       atol=1e-3)
    # without use_calib (and not always undistorted) there is none
    jc["use_calib"] = tc["use_calib"] = False
    assert tdl.Intrinsics.from_calib(512, 640, 480, CAMERAS["fr1"][0]) is \
        jdl.Intrinsics.from_calib(512, 640, 480, CAMERAS["fr1"][0]) is None


def _tum_sequence(root, fr, n=2):
    """A TUM layout with `n` seeded 640x480 frames under a freiburg{fr}
    directory, so the readers pick that camera's calibration."""
    seq = root / "tum" / f"rgbd_dataset_freiburg{fr}_calib"
    (seq / "rgb").mkdir(parents=True)
    rng = np.random.default_rng(fr)
    lines = ["# color images", "# timestamp filename"]
    for i in range(n):
        img = (rng.random((480, 640, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(seq / "rgb" / f"{i}.png"), img[..., ::-1])
        lines.append(f"1305031102.{i:06d} rgb/{i}.png")
    (seq / "rgb.txt").write_text("\n".join(lines) + "\n")
    return seq


def _euroc_sequence(root, n=3, directive=True):
    """A EuRoC `mav0/cam0` layout with `n` seeded 752x480 grayscale PNGs."""
    seq = root / "euroc" / "MH_fab"
    cam = seq / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rng = np.random.default_rng(11)
    rows = ["#timestamp [ns],filename"]
    for i in range(n):
        ts = 1403636579763555584 + 50_000_000 * i
        img = (rng.random((480, 752)) * 255).astype(np.uint8)
        cv2.imwrite(str(cam / "data" / f"{ts}.png"), img)
        rows.append(f"{ts},{ts}.png")
    (cam / "data.csv").write_text("\n".join(rows) + "\n")
    text = SENSOR_YAML if directive else SENSOR_YAML.split("\n", 2)[2]
    (cam / "sensor.yaml").write_text(text)
    return seq


@pytest.mark.parametrize("fr", [1, 2, 3])
def test_calibrated_tum_frames_match_jax(configs, tmp_path, fr):
    jc, tc = configs
    jc["use_calib"] = tc["use_calib"] = True
    seq = str(_tum_sequence(tmp_path, fr))
    want, got = jdl.load_dataset(seq), tdl.load_dataset(seq)
    assert type(got).__name__ == "TUMDataset" and got.has_calib()
    np.testing.assert_allclose(got.camera_intrinsics.K_frame,
                               want.camera_intrinsics.K_frame, rtol=1e-6)
    assert len(got) == len(want) == 2
    for i in range(2):
        (gt, gi), (wt, wi) = got[i], want[i]
        assert gt == wt
        np.testing.assert_array_equal(gi, wi)
    assert got.get_img_shape() == want.get_img_shape()


def test_euroc_frames_match_jax(configs, tmp_path):
    """The JAX package's reader parses sensor.yaml with PyYAML, which
    refuses the `%YAML:1.0` line EuRoC's file starts with (ROADMAP Queue
    3), so it reads a copy without that line; the port reads the file as
    shipped."""
    jc, tc = configs
    jc["use_calib"] = tc["use_calib"] = False  # EuRoC undistorts anyway
    got = tdl.load_dataset(str(_euroc_sequence(tmp_path / "t")))
    want = jdl.load_dataset(str(_euroc_sequence(tmp_path / "j",
                                                directive=False)))
    assert type(got).__name__ == "EurocDataset" and got.use_calibration
    assert got.timestamps == want.timestamps and len(got) == 3
    np.testing.assert_allclose(got.camera_intrinsics.K_frame,
                               want.camera_intrinsics.K_frame, rtol=1e-6)
    for i in range(3):
        gi, wi = got.get_image(i), want.get_image(i)
        assert gi.shape == (480, 752, 3) and gi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
    assert got.get_img_shape() == want.get_img_shape()


def test_write_png_gray_round_trip(tmp_path):
    """The port writes grayscale PNGs as EuRoC ships them (chip_smoke.py
    fabricates its EuRoC frames so): cv2 reads them back unchanged."""
    img = np.random.default_rng(5).integers(0, 256, (7, 9), np.uint8)
    write_png(tmp_path / "g.png", img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(read_png(tmp_path / "g.png"),
                                  np.repeat(img[..., None], 3, axis=2))


def test_sensor_yaml(tmp_path):
    path = tmp_path / "sensor.yaml"
    path.write_text(SENSOR_YAML)
    cam0 = tdl.read_sensor_yaml(path)
    assert cam0 == {"resolution": [752, 480], "intrinsics": EUROC_K,
                    "distortion_coefficients": EUROC_DIST}
    assert all(type(v) is int for v in cam0["resolution"])
    path.write_text(SENSOR_YAML.replace("intrinsics:", "focal:"))
    with pytest.raises(ValueError, match="intrinsics"):
        tdl.read_sensor_yaml(path)


CV2_FREE = '''
import sys
sys.modules["cv2"] = None  # any import of cv2 now raises ImportError
sys.path.insert(0, {root!r})
from splatt3r_slam_tpu_torch import config
from splatt3r_slam_tpu_torch.runtime import dataloader
config.config["use_calib"] = True
for path in {paths!r}:
    ds = dataloader.load_dataset(path)
    assert ds.has_calib() and ds.use_calibration, path
    assert ds.get_image(0).shape[2] == 3
    print(type(ds).__name__, ds.camera_intrinsics.K_frame[0, 0])
calib = config.parse_yaml(open({yaml!r}).read())
assert len(calib["calibration"]) == 9
print("cv2" in sys.modules and sys.modules["cv2"] is None)
'''


def test_calibrated_paths_never_import_cv2(tmp_path):
    paths = [str(_tum_sequence(tmp_path, 1, n=1)),
             str(_euroc_sequence(tmp_path, n=1))]
    code = CV2_FREE.format(root=str(ROOT), paths=paths,
                           yaml=str(ROOT / "config" / "intrinsics.yaml"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.split()
    assert out[0] == "TUMDataset" and out[2] == "EurocDataset"
    assert out[-1] == "True"


# --calib through both CLIs: the fixture's 320x240 frames with fr1's
# calibration halved and its five distortion coefficients
CALIB_YAML = ("width: 320\nheight: 240\ncalibration: [258.65, 258.25, "
              "159.3, 127.65, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633]\n")

WRAPPER = '''
import sys
which, argv = sys.argv[1], sys.argv[2:]
sys.path.insert(0, {root!r})
if which == "jax":
    import main as entry
    from splatt3r_slam_tpu.runtime import system
else:
    sys.modules["cv2"] = None  # the port's calibrated run needs no cv2
    from splatt3r_slam_tpu_torch import cli as entry
    from splatt3r_slam_tpu_torch.backend import factor_graph
    from splatt3r_slam_tpu_torch.runtime import fused, system
    solve, track = (factor_graph.FactorGraph.solve_GN_calib,
                    fused.opt_pose_calib_sim3)

    def solve_GN_calib(self):
        print("CALIB_SOLVE", flush=True)
        return solve(self)

    def opt_pose_calib_sim3(*a, **kw):
        print("CALIB_TRACK", flush=True)
        return track(*a, **kw)

    factor_graph.FactorGraph.solve_GN_calib = solve_GN_calib
    fused.opt_pose_calib_sim3 = opt_pose_calib_sim3
step = system.SLAMSystem.process_frame

def process_frame(self, frame, **kw):
    out = step(self, frame, **kw)
    print("MODE", frame.frame_id, out[0].name, len(self.keyframes),
          flush=True)
    return out

system.SLAMSystem.process_frame = process_frame
sys.exit(entry.main(argv))
'''


def _run_calib(which, tmp_path, ckpt, calib):
    cwd = tmp_path / which
    cwd.mkdir()
    wrap = tmp_path / f"wrap_{which}.py"
    wrap.write_text(WRAPPER.format(root=str(ROOT)))
    env = dict(os.environ, HF_HUB_OFFLINE="1", JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if which == "torch" else []
    r = subprocess.run(
        [sys.executable, str(wrap), which, *ARGS, *extra, "--checkpoint",
         str(ckpt), "--calib", str(calib)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, f"{which}:\n{r.stdout[-3000:]}\n" \
        f"{r.stderr[-3000:]}"
    lines = r.stdout.splitlines()
    modes = [ln.split()[1:] for ln in lines if ln.startswith("MODE ")]
    counts = {k: sum(ln == k for ln in lines)
              for k in ("CALIB_SOLVE", "CALIB_TRACK")}
    return modes, cwd / "logs", counts


def test_calib_cli_matches_main(fabricated_ckpt, tmp_path):  # noqa: F811
    calib = tmp_path / "calib.yaml"
    calib.write_text(CALIB_YAML)
    # the two CLIs run side by side, each in its own process
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(_run_calib, which, tmp_path, fabricated_ckpt,
                            calib) for which in ("jax", "torch")]
        (j_modes, j_logs, _), (t_modes, t_logs, counts) = [
            r.result() for r in runs]
    assert len(t_modes) == 8 and t_modes == j_modes
    # the calibrated solves ran: the tracked frames' pose solves and the
    # backend's on keyframes and relocalizations
    assert counts["CALIB_TRACK"] >= 1 and counts["CALIB_SOLVE"] >= 1, counts

    def rows(logs):
        lines = (logs / f"{SEQ}.txt").read_text().splitlines()
        return [ln.split()[0] for ln in lines], np.array(
            [[float(v) for v in ln.split()[1:]] for ln in lines])

    (t_ts, t_T), (j_ts, j_T) = rows(t_logs), rows(j_logs)
    assert t_ts == j_ts and len(t_ts) == int(t_modes[-1][2])
    np.testing.assert_allclose(t_T, j_T, rtol=1e-4, atol=1e-4)
    assert (FIXTURE / SEQ / "rgb.txt").exists()
