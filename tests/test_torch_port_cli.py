"""The port's CLI (`python -m splatt3r_slam_tpu_torch`, `cli.py`) against
`main.py`.

Both CLIs run on the committed TUM fixture with the tiny model at 64 px,
`--no-viz --max-frames 8`, each in its own working directory with
`HF_HUB_OFFLINE=1` and one fabricated state dict passed to both as
`--checkpoint` (tests/torch_oracle.py, as tests/test_ckpt_e2e.py does).
A small wrapper prints each frame's mode after `SLAMSystem.process_frame`,
which neither CLI prints itself. Held: the mode sequence, the keyframe
count, the trajectory (timestamp strings equal, numbers within 1e-4
relative + 1e-4 absolute), the PLY's vertex count, and the keyframe and
render PNGs.
"""

import argparse
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_oracle import TwoViewOracle  # noqa: E402

from splatt3r_slam_tpu.models import TwoViewConfig  # noqa: E402
from splatt3r_slam_tpu_torch import cli  # noqa: E402
from splatt3r_slam_tpu_torch.runtime.evaluate import load_ply  # noqa: E402
from test_torch_port_bench import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "tum"
SEQ = "rgbd_dataset_freiburg1_fixture"
ARGS = ["--dataset", str(FIXTURE / SEQ),
        "--config", str(FIXTURE / "eval_fixture.yaml"),
        "--no-viz", "--tiny-model", "--img-size", "64", "--max-frames", "8"]

WRAPPER = '''
import sys
which, argv = sys.argv[1], sys.argv[2:]
sys.path.insert(0, {root!r})
if which == "jax":
    import main as entry
    from splatt3r_slam_tpu.runtime import system
else:
    from splatt3r_slam_tpu_torch import cli as entry
    from splatt3r_slam_tpu_torch.runtime import system
step = system.SLAMSystem.process_frame

def process_frame(self, frame, **kw):
    out = step(self, frame, **kw)
    print("MODE", frame.frame_id, out[0].name, len(self.keyframes),
          flush=True)
    return out

system.SLAMSystem.process_frame = process_frame
sys.exit(entry.main(argv))
'''


def _options(parse_args, monkeypatch):
    """{option string: default} of a CLI's parser."""
    seen = {}

    def grab(self, argv=None, namespace=None):
        seen["parser"] = self
        return argparse.Namespace()

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        parse_args([])
    return {opt: a.default for a in seen["parser"]._actions
            for opt in a.option_strings if opt not in ("-h", "--help")}


def test_flag_surface_matches_main(monkeypatch):
    import main

    want = _options(main.parse_args, monkeypatch)
    got = _options(cli.parse_args, monkeypatch)
    assert set(got) == set(want) | {"--device"}
    assert got["--device"] == "cuda"
    for opt, default in want.items():
        assert got[opt] == default, opt
    help_text = subprocess.run(
        [sys.executable, "-m", "splatt3r_slam_tpu_torch", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=300).stdout
    assert "scaled_dot_product_attention" in help_text
    assert "--device" in help_text


def test_cli_refuses_what_is_not_ported(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    # the viewer and --calib are ported (tests/test_torch_port_viewer.py,
    # tests/test_torch_port_calib.py): nothing of main.py's surface is
    # refused any more, and the default command line, without --no-viz,
    # asks for the card
    assert not hasattr(cli, "_VIEWER_TODO")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(ARGS[:4])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(ARGS)  # --device defaults to cuda
    with pytest.raises(SystemExit, match="require-checkpoint"):
        cli.main(ARGS + ["--device", "cpu", "--require-checkpoint"])
    assert not (tmp_path / "logs").exists()


@pytest.fixture(scope="module")
def fabricated_ckpt(tmp_path_factory):
    torch.manual_seed(7)
    cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    oracle = TwoViewOracle(
        enc_dim=cfg.enc_embed_dim, enc_depth=cfg.enc_depth,
        enc_heads=cfg.enc_num_heads, dec_dim=cfg.dec_embed_dim,
        dec_depth=cfg.dec_depth, dec_heads=cfg.dec_num_heads)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.ckpt"
    torch.save({"state_dict": {f"encoder.{k}": v for k, v in
                               oracle.state_dict().items()}}, path)
    return path


def _run(which, tmp_path, ckpt):
    cwd = tmp_path / which
    cwd.mkdir()
    (tmp_path / "wrap.py").write_text(WRAPPER.format(root=str(ROOT)))
    env = dict(os.environ, HF_HUB_OFFLINE="1", JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if which == "torch" else []
    r = subprocess.run(
        [sys.executable, str(tmp_path / "wrap.py"), which, *ARGS, *extra,
         "--checkpoint", str(ckpt)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, f"{which}:\n{r.stdout[-3000:]}\n" \
        f"{r.stderr[-3000:]}"
    assert "Loading Splatt3R checkpoint" in r.stdout
    modes = [ln.split()[1:] for ln in r.stdout.splitlines()
             if ln.startswith("MODE ")]
    return modes, cwd / "logs"


def test_cli_matches_main(fabricated_ckpt, tmp_path):
    j_modes, j_logs = _run("jax", tmp_path, fabricated_ckpt)
    t_modes, t_logs = _run("torch", tmp_path, fabricated_ckpt)
    assert len(t_modes) == 8
    assert t_modes == j_modes
    assert "RELOC" in {m[1] for m in t_modes}

    def rows(logs):
        lines = (logs / f"{SEQ}.txt").read_text().splitlines()
        return [ln.split()[0] for ln in lines], np.array(
            [[float(v) for v in ln.split()[1:]] for ln in lines])

    (t_ts, t_T), (j_ts, j_T) = rows(t_logs), rows(j_logs)
    assert t_ts == j_ts and len(t_ts) == int(t_modes[-1][2])
    rgb = (FIXTURE / SEQ / "rgb.txt").read_text().split()
    assert set(t_ts) <= set(rgb)
    np.testing.assert_allclose(t_T, j_T, rtol=1e-4, atol=1e-4)
    t_pts, _ = load_ply(t_logs / f"{SEQ}.ply")
    j_pts, _ = load_ply(j_logs / f"{SEQ}.ply")
    assert len(t_pts) == len(j_pts) > 0
    for sub in ("keyframes", "renders"):
        names = sorted(p.name for p in (t_logs / f"{SEQ}_{sub}").iterdir())
        assert names == sorted(
            p.name for p in (j_logs / f"{SEQ}_{sub}").iterdir())
    assert len(list((t_logs / f"{SEQ}_renders").iterdir())) == 8
