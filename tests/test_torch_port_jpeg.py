"""The port's JPEG codec (`utils/jpeg.py`, `csrc/jpeg_huffman.cpp`) against
cv2 and the JAX package.

The corpus is made here from a seed with numpy (smooth ramps, noise and
hard edges) and encoded by `cv2.imencode`: 37x53, 61x83, 240x320 and
480x640 pixels; quality 50, 75, 95 and 100; sampling 4:4:4, 4:2:2, 4:2:0,
4:4:0 and 4:1:1; progressive; optimized Huffman tables; restart intervals;
grayscale; separate luma and chroma quality; sizes of one to a few pixels;
and an EXIF orientation segment (all eight values, little- and big-endian)
spliced into cv2's bytes. Held:
- every file decodes as `cv2.imdecode(..., IMREAD_COLOR)` + BGR→RGB
  decodes it: the bar is one level on every value, and the count of
  differing values is 0 on every file (islow IDCT, fancy upsampling and
  the colour tables are integer arithmetic);
- the C++ entropy walk writes the Python walk's coefficients, on the
  whole corpus, and is the path taken by default; a failed build raises;
- the port's readers against the JAX package's on the same files:
  `RGBFiles.read_img` on a folder of .jpg and .png frames, the web app's
  `_decode_image` on a JPEG data URL, and the root `demo.py`'s read;
- `encode_jpeg` writes `cv2.imencode`'s bytes (baseline 4:2:0 with a
  JFIF APP0), so cv2's decode of both is the same (the bar is one level);
- each refused input raises its ValueError (arithmetic coding, lossless,
  12-bit, four components, Adobe transform 2, a DNL height, truncated data,
  no EOI, a bad Huffman code, progressive scans that leave coefficients
  unrefined); where cv2 decodes such a file, that is held too;
- in a subprocess where `import cv2` fails: `RGBFiles` on a .jpg folder,
  the web app's `_decode_image` and `demo.read_image`;
- `tests/fixtures/jpeg/` (the subset `chip_smoke.py` holds on the card,
  which has no cv2) is this corpus's bytes with cv2's pixels.
"""

import base64
import functools
import importlib.util
import pathlib
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest

from splatt3r_slam_tpu.runtime import dataloader as jdl
from splatt3r_slam_tpu.runtime import webdemo as jweb
from splatt3r_slam_tpu_torch import demo
from splatt3r_slam_tpu_torch.runtime import dataloader as tdl
from splatt3r_slam_tpu_torch.runtime import webdemo
from splatt3r_slam_tpu_torch.utils import jpeg
from splatt3r_slam_tpu_torch.utils.image import (
    decode_image,
    read_image,
    write_png,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_port_bench import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}
Q, SF = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
PROG = cv2.IMWRITE_JPEG_PROGRESSIVE
# the committed subset: every sampling, progressive, restart, optimized
# tables, grayscale, an EXIF rotation, a size below one block
COMMITTED = ("37x53_444_q75", "37x53_422_q75", "37x53_420_q75",
             "37x53_440_q75", "37x53_411_q75", "37x53_420_q95_progressive",
             "61x83_420_q95", "61x83_422_q75_progressive",
             "61x83_restart5", "61x83_optimized", "61x83_gray_progressive",
             "37x53_exif6", "9x17_420")


def image(h, w, seed):
    """Smooth ramps, noise and hard edges (uint8, 3 channels)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                    (xx + yy) * 127 / (h + w)], axis=2)
    img += rng.normal(0, 12, img.shape)
    img[h // 3: h // 2 + 1, w // 4: w // 2 + 1] = (250, 10, 40)
    img[(yy.astype(int) // 3 + xx.astype(int) // 5) % 11 == 0] = 255
    return np.clip(img, 0, 255).astype(np.uint8)


def exif_segment(orientation, little=True):
    """An APP1 Exif segment whose IFD0 holds the orientation tag."""
    e = "<" if little else ">"
    tiff = ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 2)
            + struct.pack(e + "HHIHH", 0x010F, 2, 4, 0x4142, 0x4300)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@functools.lru_cache(maxsize=None)
def corpus() -> dict:
    """name → the bytes cv2 writes."""
    cases = {}

    def enc(name, img, *params):
        ok, buf = cv2.imencode(".jpg", img, list(params))
        assert ok, name
        cases[name] = buf.tobytes()

    small, mid = image(37, 53, 1), image(61, 83, 0)
    for sf, code in SAMPLING.items():
        for q in (50, 75, 95, 100):
            enc(f"61x83_{sf}_q{q}", mid, Q, q, SF, code)
        enc(f"61x83_{sf}_q75_progressive", mid, Q, 75, SF, code, PROG, 1)
        enc(f"37x53_{sf}_q75", small, Q, 75, SF, code)
        enc(f"37x53_{sf}_q95_progressive", small, Q, 95, SF, code, PROG, 1)
    enc("240x320_420_q95", image(240, 320, 2), Q, 95)
    enc("240x320_444_q95_progressive", image(240, 320, 2), Q, 95, SF,
        SAMPLING["444"], PROG, 1)
    enc("480x640_420_q95", image(480, 640, 3), Q, 95)
    enc("480x640_420_q75_progressive", image(480, 640, 3), Q, 75, PROG, 1)
    enc("61x83_optimized", mid, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    enc("61x83_restart1", mid, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    enc("61x83_restart5", mid, cv2.IMWRITE_JPEG_RST_INTERVAL, 5)
    enc("61x83_restart3_progressive", mid, cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
        PROG, 1)
    gray = cv2.cvtColor(mid, cv2.COLOR_BGR2GRAY)
    enc("61x83_gray", gray)
    enc("61x83_gray_progressive", gray, PROG, 1)
    enc("61x83_luma30_chroma90", mid, cv2.IMWRITE_JPEG_LUMA_QUALITY, 30,
        cv2.IMWRITE_JPEG_CHROMA_QUALITY, 90)
    for h, w in ((1, 1), (2, 3), (9, 17)):
        enc(f"{h}x{w}_420", image(h, w, 4))
        enc(f"{h}x{w}_422_progressive", image(h, w, 4), SF,
            SAMPLING["422"], PROG, 1)
    base = cases["37x53_420_q75"]
    for o in range(1, 9):  # after JFIF's APP0, where cameras put it
        cases[f"37x53_exif{o}"] = base[:20] + exif_segment(o) + base[20:]
    cases["37x53_exif6_bigendian"] = (base[:2] + exif_segment(6, False)
                                      + base[2:])
    return cases


def cv2_rgb(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return np.ascontiguousarray(bgr[..., ::-1])


NAMES = sorted(corpus())


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_cv2(name):
    data = corpus()[name]
    got, want = jpeg.decode_jpeg(data), cv2_rgb(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) == 0  # every value equal


@pytest.mark.parametrize("name", NAMES)
def test_native_walk_equals_python_walk(name):
    data = corpus()[name]
    native = jpeg.jpeg_coefficients(data, walk="native")
    plain = jpeg.jpeg_coefficients(data, walk="python")
    assert len(native) == len(plain)
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, walk="python"),
                                  jpeg.decode_jpeg(data))


def test_native_walk_is_the_default_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    data = corpus()["61x83_420_q95"]
    want = cv2_rgb(data)

    def refuse(*a):
        raise AssertionError("the plain walk ran")

    with monkeypatch.context() as m:
        m.setattr(jpeg, "_walk_python", refuse)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
        with pytest.raises(AssertionError, match="plain walk"):
            jpeg.decode_jpeg(data, walk="python")
    broken = tmp_path / "jpeg_huffman.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg, "SOURCE", broken)
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        jpeg.build_native()
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(ValueError, match="walk"):
        jpeg.decode_jpeg(data, walk="cv2")


def test_committed_fixtures_are_the_corpus():
    pixels = np.load(FIXTURES / "pixels.npz")
    files = sorted(p.stem for p in FIXTURES.glob("*.jpg"))
    assert files == sorted(COMMITTED) == sorted(pixels.files)
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total <= 300_000
    for name in COMMITTED:
        data = (FIXTURES / f"{name}.jpg").read_bytes()
        assert data == corpus()[name], name
        np.testing.assert_array_equal(pixels[name], cv2_rgb(data))
        np.testing.assert_array_equal(read_image(FIXTURES / f"{name}.jpg"),
                                      pixels[name])


def write_fixtures(out=FIXTURES):
    """Write the committed subset and cv2's pixels of it (run once, here,
    where cv2 is)."""
    out.mkdir(parents=True, exist_ok=True)
    for name in COMMITTED:
        (out / f"{name}.jpg").write_bytes(corpus()[name])
    np.savez_compressed(out / "pixels.npz", **{
        name: cv2_rgb(corpus()[name]) for name in COMMITTED})


@pytest.mark.parametrize("quality", [90, 50, 95, 100])
@pytest.mark.parametrize("hw", [(37, 53), (1, 1), (61, 83), (240, 320)])
def test_encoder_writes_cv2s_bytes(hw, quality):
    rgb = image(*hw, seed=5)[..., ::-1]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [Q, quality])
    got = jpeg.encode_jpeg(rgb, quality)
    diff = np.abs(cv2_rgb(got).astype(np.int16) - cv2_rgb(buf.tobytes()))
    assert diff.max() <= 1  # the bar
    assert got == buf.tobytes()  # and, measured here, the same bytes
    np.testing.assert_array_equal(jpeg.decode_jpeg(got), cv2_rgb(got))


def test_encoder_on_a_fixture_frame():
    """The TUM fixture's first frame, as the web app's /render sends a
    frame: quality 90, cv2's bytes."""
    frame = read_image(sorted((ROOT / "tests" / "fixtures" / "tum"
                               / "rgbd_dataset_freiburg1_fixture" / "rgb"
                               ).glob("*.png"))[0])
    ok, buf = cv2.imencode(".jpg", frame[..., ::-1].copy(), [Q, 90])
    assert jpeg.encode_jpeg(frame) == buf.tobytes()


def _sof_at(data):
    i = data.find(b"\xff\xc0")
    assert i > 0
    return i


def _patched(data, at, value):
    return data[:at] + bytes([value]) + data[at + 1:]


def _refused():
    base = corpus()["61x83_420_q95"]
    prog = corpus()["61x83_422_q75_progressive"]
    sof = _sof_at(base)
    cmyk = (b"\xff\xd8" + b"\xff\xc0" + struct.pack(">HBHHB", 20, 8, 8, 8, 4)
            + bytes([1, 0x11, 0, 2, 0x11, 0, 3, 0x11, 0, 4, 0x11, 0])
            + b"\xff\xd9")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"
    sos = base.find(b"\xff\xda")
    sos_end = sos + 2 + int.from_bytes(base[sos + 2: sos + 4], "big")
    return {
        # name: (bytes, message, whether cv2 5.0 returns an image: where
        # it does, the refusal is a standing difference)
        "not_jpeg": (b"GIF89a" + bytes(40), "not a JPEG", False),
        "arithmetic_sof9": (_patched(base, sof + 1, 0xC9), "arithmetic",
                            True),
        "arithmetic_sof10": (_patched(base, sof + 1, 0xCA), "arithmetic",
                             False),
        "lossless_sof3": (_patched(base, sof + 1, 0xC3), "lossless", False),
        "hierarchical_sof5": (_patched(base, sof + 1, 0xC5),
                              "hierarchical", False),
        "12_bit": (_patched(base, sof + 4, 12), "12-bit", False),
        "cmyk": (cmyk, "four-component", False),
        "adobe_ycck": (base[:2] + adobe + base[2:], "Adobe transform 2",
                       True),
        "dnl_height": (base[:sof + 5] + b"\x00\x00" + base[sof + 7:],
                       "DNL", False),
        "truncated": (base[:len(base) // 2], "truncated", False),
        "no_eoi": (base[:-2], "truncated", False),
        "bad_huffman_code": (base[:sos_end] + b"\xff\x00" * 64 + b"\xff\xd9",
                             "bad Huffman code", True),
        "unrefined_progressive": (prog[:prog.rfind(b"\xff\xda")]
                                  + b"\xff\xd9", "unrefined", True),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refused_inputs_raise(case):
    data, message, cv2_decodes = _refused()[case]
    for walk in ("native", "python"):
        with pytest.raises(ValueError, match=message):
            jpeg.decode_jpeg(data, walk=walk)
    with pytest.raises(ValueError, match="upload"):
        decode_image(data, "upload")
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert (got is not None) == cv2_decodes


def test_decode_image_goes_by_magic_bytes(tmp_path):
    data = corpus()["61x83_444_q95"]
    (tmp_path / "frame.png").write_bytes(data)  # a JPEG under .png
    np.testing.assert_array_equal(read_image(tmp_path / "frame.png"),
                                  cv2.imread(str(tmp_path / "frame.png"))
                                  [..., ::-1])
    (tmp_path / "x.jpg").write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="x.jpg: not a PNG or JPEG"):
        read_image(tmp_path / "x.jpg")


# -- the port's readers against the JAX package's ---------------------------


def _frames_folder(path):
    """A folder of .jpg frames and one .png, in natural order."""
    path.mkdir()
    names = ("61x83_420_q95", "61x83_444_q75_progressive", "61x83_restart5",
             "61x83_optimized")
    for i, name in zip((1, 2, 10, 11), names):
        (path / f"f{i}.jpg").write_bytes(corpus()[name])
    write_png(path / "f3.png", cv2_rgb(corpus()["61x83_422_q95"]))
    return path


def test_rgb_files_match_jax(tmp_path):
    folder = _frames_folder(tmp_path / "frames")
    tds, jds = tdl.RGBFiles(folder), jdl.RGBFiles(folder)
    assert [p.name for p in tds.rgb_files] == [p.name for p in jds.rgb_files]
    assert len(tds) == 5
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds.read_img(i), jds.read_img(i))
        np.testing.assert_array_equal(tds[i][1], jds[i][1])
    assert tds.get_img_shape() == jds.get_img_shape()
    assert isinstance(tdl.load_dataset(str(folder)), tdl.RGBFiles)


@pytest.mark.parametrize("name", ["61x83_420_q95", "37x53_exif6",
                                  "61x83_gray_progressive"])
def test_web_upload_matches_jax(name):
    url = "data:image/jpeg;base64," + base64.b64encode(
        corpus()[name]).decode()
    got = webdemo._decode_image(url)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jweb._decode_image(url))
    np.testing.assert_array_equal(webdemo._decode_image(url.split(",")[1]),
                                  got)


def _jax_demo_read(path, monkeypatch):
    """The root demo.py's read of `path` (`:67`, cv2.imread + BGR→RGB),
    captured where it hands the image to resize_img."""
    from splatt3r_slam_tpu.utils import image as jimage

    spec = importlib.util.spec_from_file_location("jax_root_demo",
                                                  ROOT / "demo.py")
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    seen = []

    class Stop(Exception):
        pass

    def capture(img, size):
        seen.append(img)
        raise Stop

    monkeypatch.setattr(jimage, "resize_img", capture)
    with pytest.raises(Stop):
        jdemo.main([str(path), str(path), "--tiny-model"])
    return seen[0]


def test_demo_read_matches_jax(tmp_path, monkeypatch):
    for name in ("61x83_411_q100", "37x53_exif8"):
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(corpus()[name])
        np.testing.assert_array_equal(demo.read_image(path),
                                      _jax_demo_read(path, monkeypatch))


def test_demo_cli_on_jpeg_inputs(tmp_path):
    """The demo CLI on two .jpg files writes what it writes on PNG copies
    of cv2's pixels of them."""
    rng = np.random.default_rng(2)
    base = (rng.random((60, 80, 3)) * 255).astype(np.uint8)
    for name, crop in (("a", base[:48, :64]), ("b", base[4:52, 6:70])):
        ok, buf = cv2.imencode(".jpg", crop, [Q, 90])
        (tmp_path / f"{name}.jpg").write_bytes(buf.tobytes())
        write_png(tmp_path / f"{name}.png", cv2_rgb(buf.tobytes()))
    outs = {}
    for ext in ("jpg", "png"):
        out = tmp_path / f"out_{ext}"
        assert demo.main([str(tmp_path / f"a.{ext}"),
                          str(tmp_path / f"b.{ext}"), "--out", str(out),
                          "--n-views", "2", "--img-size", "64",
                          "--tiny-model", "--device", "cpu"]) == 0
        outs[ext] = out
    assert ((outs["jpg"] / "gaussians.ply").read_bytes()
            == (outs["png"] / "gaussians.ply").read_bytes())
    for i in range(2):
        assert ((outs["jpg"] / f"view_{i:03d}.png").read_bytes()
                == (outs["png"] / f"view_{i:03d}.png").read_bytes())


CV2_FREE = '''
import base64, sys
sys.modules["cv2"] = None  # any import of cv2 now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np
from splatt3r_slam_tpu_torch import demo
from splatt3r_slam_tpu_torch.runtime import dataloader, webdemo
want = np.load({want!r})
ds = dataloader.load_dataset({folder!r})
assert type(ds).__name__ == "RGBFiles" and len(ds) == 5
for i, p in enumerate(ds.rgb_files):
    np.testing.assert_array_equal(ds.read_img(i), want[p.stem])
    if p.suffix == ".jpg":
        data = p.read_bytes()
        url = "data:image/jpeg;base64," + base64.b64encode(data).decode()
        f = want[p.stem].astype(np.float32) / 255
        np.testing.assert_array_equal(webdemo._decode_image(url), f)
        np.testing.assert_array_equal(demo.read_image(p), f)
print(sys.modules["cv2"] is None)
'''


def test_jpeg_paths_never_import_cv2(tmp_path):
    folder = _frames_folder(tmp_path / "frames")
    np.savez(tmp_path / "want.npz", **{
        p.stem: cv2.imread(str(p))[..., ::-1] for p in folder.iterdir()})
    code = CV2_FREE.format(root=str(ROOT), folder=str(folder),
                           want=str(tmp_path / "want.npz"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-1] == "True"
