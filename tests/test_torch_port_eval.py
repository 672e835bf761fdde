"""The port's dataset evaluation scripts against the repository's scripts.

`splatt3r_slam_tpu_torch/scripts/eval_{tum,euroc,7_scenes,eth3d}.py`, the
counterparts of `scripts/eval_*.sh`: their sequence lists and defaults
against the ones the scripts define; the command lines each runs (the
CLI and the ATE stubbed) against the scripts' own, which bash runs here
with a stand-in `python` that records its arguments, the port's CLI in
`main.py`'s place; what a failed ATE does in each; and the TUM evaluation end
to end on the committed fixture (`tests/fixtures/tum`) on the CPU, with
the checks of `tests/test_tum_eval_protocol.py`, its ATE equal to the JAX
package's `runtime/evaluate.ate_rmse` on the same two files within 1e-9
(the same association and alignment in float64).

Random weights decide how often the fixture's run relocalizes, and an ATE
needs three keyframes: the port's own seeded tiny weights relocalize once
in the fixture's 12 frames (2 keyframes), so the end-to-end run loads the
fabricated tiny checkpoint that `test_torch_port_cli.py` hands both CLIs
(6 keyframes).
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from splatt3r_slam_tpu.runtime.evaluate import ate_rmse as j_ate_rmse
from splatt3r_slam_tpu_torch.scripts import (
    _eval,
    eval_7_scenes,
    eval_eth3d,
    eval_euroc,
    eval_tum,
)
from test_torch_port_bench import one_torch_thread  # noqa: F401
from test_torch_port_cli import fabricated_ckpt  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "tum"
SEQ = "rgbd_dataset_freiburg1_fixture"
EVALS = {"tum": eval_tum, "euroc": eval_euroc, "7_scenes": eval_7_scenes,
           "eth3d": eval_eth3d}
SETTINGS = ("DATASET_ROOT", "GT_ROOT", "CONFIG", "SAVE_AS", "EXTRA_ARGS",
            "SEQS_OVERRIDE")


def _script(name):
    return (ROOT / "scripts" / f"eval_{name}.sh").read_text()


@pytest.mark.parametrize("name", list(EVALS))
def test_sequences_and_defaults_are_the_scripts(name):
    """Each evaluation's sequence list and `${VAR:-default}` settings are the
    ones its shell script defines (ETH3D has no list: it takes every
    subfolder of its root)."""
    text = _script(name)
    defaults = dict(re.findall(r"^(\w+)=\$\{\1:-(.*)\}$", text, re.M))
    mod = EVALS[name]
    assert mod.DEFAULTS == defaults
    seqs = re.search(r"^SEQS=\(([^)]*)\)", text, re.M)
    if name == "eth3d":
        assert seqs is None and not hasattr(mod, "SEQS")
    else:
        assert mod.SEQS == tuple(seqs.group(1).replace("\\", " ").split())


def _stand_in(tmp_path):
    """A directory holding a `python` that records its arguments (one JSON
    list a line in $RECORD) and fails as an ATE (exit 1), and a `wget`
    that fails, for PATH."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    py = bin_dir / "python"
    py.write_text(
        f"#!{sys.executable}\nimport json, os, sys\n"
        "with open(os.environ['RECORD'], 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "sys.exit(1 if 'compute_ate' in sys.argv[1] else 0)\n")
    wget = bin_dir / "wget"
    wget.write_text("#!/bin/sh\nexit 9\n")
    for f in (py, wget):
        f.chmod(0o755)
    return bin_dir


def _dataset(tmp_path, name):
    """A dataset root with two sequences (ETH3D: two folders, one with its
    groundtruth; TUM: two override sequences with groundtruth) → the
    settings the shell scripts and the port's evaluations are given."""
    root = tmp_path / "data"
    root.mkdir()
    env = {"DATASET_ROOT": str(root), "SAVE_AS": "run", "CONFIG": "c.yaml"}
    if name == "eth3d":
        for seq in ("sofa_1", "cables_2"):
            (root / seq).mkdir()
        (root / "cables_2" / "groundtruth.txt").write_text("")
    if name == "tum":
        for seq in ("seq_a", "seq_b"):
            (root / seq).mkdir()
            (root / seq / "groundtruth.txt").write_text("")
        env.update(SEQS_OVERRIDE="seq_a seq_b", EXTRA_ARGS="--tiny-model "
                   "--img-size 64")
    return env


@pytest.mark.parametrize("name", list(EVALS))
def test_command_lines_are_the_scripts(name, tmp_path, monkeypatch):
    """The commands each evaluation runs, the CLI and the ATE stubbed (every
    ATE fails), are the lines bash runs from its script with the port's
    CLI and ATE in place of `main.py` and `scripts/compute_ate.py`, and
    `--device` added; a failed ATE ends the TUM run with its exit code
    after the first sequence and is passed over by the other three."""
    env = _dataset(tmp_path, name)
    record = tmp_path / "record.jsonl"
    bin_dir = _stand_in(tmp_path)
    work = tmp_path / "work"
    work.mkdir()
    r = subprocess.run(
        ["bash", str(ROOT / "scripts" / f"eval_{name}.sh")], cwd=work,
        env={**{k: v for k, v in os.environ.items() if k not in SETTINGS},
             **env, "RECORD": str(record),
             "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"},
        capture_output=True, text=True, timeout=120)
    script = [json.loads(ln) for ln in record.read_text().splitlines()]

    ran = []

    def stub(cmd):
        ran.append(list(cmd))
        return 1 if "splatt3r_slam_tpu_torch.scripts.compute_ate" in cmd \
            else 0

    for k in SETTINGS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(_eval, "run", stub)
    monkeypatch.chdir(work)
    rc = EVALS[name].main(["--device", "cpu"])

    assert rc == r.returncode == (1 if name == "tum" else 0), r.stderr
    assert len(ran) == len(script) > 0
    port = {"main.py": ["-m", "splatt3r_slam_tpu_torch"],
            "scripts/compute_ate.py": [
                "-m", "splatt3r_slam_tpu_torch.scripts.compute_ate"]}
    for got, want in zip(ran, script):
        assert got[0] == sys.executable
        assert got[1:3] == port[want[0]]
        assert got[3:] == want[1:] + ["--device", "cpu"]
    n_seq = {"tum": 1, "euroc": 11, "7_scenes": 7, "eth3d": 2}[name]
    slams = [c for c in ran if c[2] == "splatt3r_slam_tpu_torch"]
    assert len(slams) == n_seq
    if name == "eth3d":  # sorted folders, the glob's trailing slash; the
        # ATE only where the groundtruth is
        root = env["DATASET_ROOT"]
        assert [c[4] for c in slams] == [f"{root}/cables_2/",
                                         f"{root}/sofa_1/"]
        assert len(ran) == 3


def test_failed_run_stops_and_missing_root_is_refused(tmp_path, monkeypatch):
    """A failed SLAM run ends every evaluation with its exit code; ETH3D
    without a sequence folder is an error; TUM fetches its sequences only
    without SEQS_OVERRIDE and without DATASET_ROOT (the call is stubbed
    here); asking for CUDA without a GPU raises before anything runs."""
    ran = []

    def stub(cmd):
        ran.append(list(cmd))
        return 3

    monkeypatch.setattr(_eval, "run", stub)
    monkeypatch.chdir(tmp_path)
    for k in SETTINGS:
        monkeypatch.delenv(k, raising=False)
    for name in ("euroc", "7_scenes"):
        ran.clear()
        assert EVALS[name].main(["--device", "cpu"]) == 3
        assert len(ran) == 1 and ran[0][2] == "splatt3r_slam_tpu_torch"
    ran.clear()
    assert eval_eth3d.main(["--device", "cpu"]) == 1 and not ran
    ran.clear()
    assert eval_tum.main(["--device", "cpu"]) == 3  # the fetch failed
    assert ran == [["bash", str(ROOT / "scripts" / "download_tum.sh")]]
    (tmp_path / "datasets" / "tum").mkdir(parents=True)
    ran.clear()
    assert eval_tum.main(["--device", "cpu"]) == 3
    assert len(ran) == 1 and ran[0][2] == "splatt3r_slam_tpu_torch"
    assert ran[0][-3:] == ["--require-checkpoint", "--device", "cpu"]
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    ran.clear()
    with pytest.raises(RuntimeError, match="cuda"):
        eval_tum.main([])
    assert not ran


def test_tum_evaluation_on_the_fixture(tmp_path, fabricated_ckpt):
    """The TUM evaluation as users call it, in a process of its own from a
    scratch directory, on the committed fixture with the tiny model on the
    CPU (the flags of tests/test_tum_eval_protocol.py, and the fabricated
    checkpoint): a finite ATE line,
    TUM rows of 8 columns whose stamps lie within 0.02 s of the
    groundtruth's, the PLY, keyframe and render PNGs; the ATE equals the
    JAX package's on the same two files."""
    env = {k: v for k, v in os.environ.items() if k not in SETTINGS}
    env.update(DATASET_ROOT=str(FIXTURE), SEQS_OVERRIDE=SEQ,
               CONFIG=str(FIXTURE / "eval_fixture.yaml"), SAVE_AS="fixture",
               EXTRA_ARGS="--tiny-model --img-size 64 --render-stride 6 "
               f"--checkpoint {fabricated_ckpt}",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), env.get("PYTHONPATH")) if p))
    r = subprocess.run(
        [sys.executable, "-m", "splatt3r_slam_tpu_torch.scripts.eval_tum",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    assert f"=== {SEQ} ===" in r.stdout
    ate_lines = [json.loads(ln) for ln in r.stdout.splitlines()
                 if ln.startswith("{") and "ate_rmse" in ln]
    assert len(ate_lines) == 1, r.stdout[-2000:]
    ate = ate_lines[0]["ate_rmse"]
    assert np.isfinite(ate)

    out = tmp_path / "logs" / "fixture"
    est, gt = out / f"{SEQ}.txt", FIXTURE / SEQ / "groundtruth.txt"
    assert ate_lines[0]["est"] == f"logs/fixture/{SEQ}.txt"
    assert ate_lines[0]["gt"] == f"{FIXTURE}/{SEQ}/groundtruth.txt"
    rows = np.atleast_2d(np.loadtxt(est, comments="#"))
    assert rows.shape[0] >= 3 and rows.shape[1] == 8, rows.shape
    gt_ts = np.loadtxt(gt, comments="#")[:, 0]
    for t in rows[:, 0]:
        assert np.min(np.abs(gt_ts - t)) < 0.02, f"orphan timestamp {t}"
    assert (out / f"{SEQ}.ply").exists()
    assert any((out / f"{SEQ}_keyframes").glob("*.png"))
    assert any((out / f"{SEQ}_renders").glob("*.png"))
    assert abs(ate - j_ate_rmse(str(gt), str(est))) <= 1e-9
