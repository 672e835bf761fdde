"""CLI tests for `python -m splatt3r_slam_tpu_torch.train`.

The port's train CLI has the flag surface of the root train.py (plus
`--device`); driven whole in a subprocess on the CPU with the tiny model,
as tests/test_train_cli.py drives the JAX CLI, and checked for the same
workspace files and keys. `synthetic_batches` must give the root
train.py's batches for the same seed.
"""

import csv
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from splatt3r_slam_tpu_torch import train as t_train
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(args, tmp_path, timeout=600, ok=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "splatt3r_slam_tpu_torch.train", "--device",
         "cpu", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)
    if ok:
        assert out.returncode == 0, out.stdout + out.stderr
    return out


def _latest_ws(tmp_path, name):
    runs = sorted((tmp_path / "logs" / "train").glob(f"{name}_*"))
    assert runs, list((tmp_path / "logs").rglob("*"))
    return runs[-1]


def test_train_render_loss_eval_resume_and_sweep(tmp_path):
    _run(["--tiny-model", "--steps", "2", "--eval-every", "2", "--name",
          "syn", "--verbose", "--trace", "0", "1", "--set",
          "train.render_loss=true", "train.ssim_weight=0.1",
          "train.lr=1e-4"], tmp_path)
    ws = _latest_ws(tmp_path, "syn")
    assert (ws / "params_final.npz").exists()
    assert set(json.loads((ws / "provenance.json").read_text())) == {
        "commit", "branch", "dirty"}
    rows = list(csv.DictReader(open(ws / "syn_metrics.csv")))
    assert len(rows) == 3  # 2 train rows + 1 eval row
    assert {"step", "wall_time_s", "loss", "mse", "ssim", "val_mse",
            "val_psnr", "val_ssim", "val_lpips"} <= set(rows[0])
    assert float(rows[0]["loss"]) > 0 and rows[2]["val_psnr"] != ""
    meta = json.loads((ws / "syn_meta.json").read_text())
    assert set(meta) == {"model_cfg", "train_cfg", "device"}
    assert meta["train_cfg"]["render_loss"] is True
    # resolved config dumped with the overrides applied
    assert "1e-4" in (ws / "config.yaml").read_text().replace("0.0001",
                                                              "1e-4")
    assert (ws / "trace" / "steps_0_1.json").exists()

    # resume from the saved params, Regr3D loss only
    out = _run(["--tiny-model", "--steps", "1", "--name", "resumed",
                "--resume", str(ws / "params_final.npz")], tmp_path)
    assert "resume params" in out.stdout
    ws2 = _latest_ws(tmp_path, "resumed")
    a = np.load(ws / "params_final.npz")
    b = np.load(ws2 / "params_final.npz")
    # only the gaussian heads train, and this loss does not reach them
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])

    # the masked-metric sweep, with the JAX CLI's keys
    _run(["--tiny-model", "--test", "--alphas", "0.9", "0.3", "--name",
          "sweep"], tmp_path)
    res = json.loads((_latest_ws(tmp_path, "sweep")
                      / "results.json").read_text())
    assert len(res) == 4
    key_a = "alpha: 0.3, beta: 0.3, apply_mask: True, average_over_mask: False"
    key_b = "alpha: 0.3, beta: 0.3, apply_mask: True, average_over_mask: True"
    assert key_a in res and key_b in res
    for k in ("test/loss", "test/mse", "test/psnr", "test/ssim"):
        assert k in res[key_a][0] and np.isfinite(res[key_a][0][k])
    assert "test/lpips" in res[key_a][0]
    a, b = res[key_a][0], res[key_b][0]
    assert abs(a["test/ssim"] - b["test/ssim"]) > 1e-6
    assert abs(a["test/mse"] - b["test/mse"]) > 1e-9


def test_train_from_npz_batches_and_config_file(tmp_path):
    h, w, B = 32, 48, 1
    batch = next(t_train.synthetic_batches(1, B, h, w, False, seed=3))
    np.savez(tmp_path / "b0.npz", **batch)
    (tmp_path / "ws.yaml").write_text(
        "train:\n  train_gaussian_heads_only: false\n  lr: 1.0e-4\n"
        "model:\n  remat: true\n")
    out = _run(["--tiny-model", "--config", "ws.yaml", "--data",
                str(tmp_path / "b0.npz"), "--epochs", "2", "--name", "npz",
                "--verbose"], tmp_path)
    assert "step 1:" in out.stdout  # 1 file x 2 epochs = 2 steps
    ws = _latest_ws(tmp_path, "npz")
    rows = list(csv.DictReader(open(ws / "npz_metrics.csv")))
    # the whole model trains on the same batch twice: the loss goes down
    assert float(rows[1]["regr3d"]) < float(rows[0]["regr3d"])


def test_devices_above_one_and_missing_gpu_raise(tmp_path):
    """`--devices 2` trains on a 2-rank mesh (tests/
    test_torch_port_parallel.py); on CUDA it needs two GPUs and raises
    before anything starts, with no CPU or gloo run in their place and no
    workspace written. Without a GPU the single-device CLI raises too."""
    import torch

    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="2 CUDA ranks need 2 GPUs"):
            t_train.main(["--tiny-model", "--devices", "2", "--steps", "1",
                          "--out", str(tmp_path / "out")])
        assert not (tmp_path / "out").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_train.main(["--tiny-model", "--steps", "1"])


def test_synthetic_batches_match_root_train_py():
    spec = importlib.util.spec_from_file_location("root_train",
                                                  ROOT / "train.py")
    root_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_train)
    args = (2, 2, 16, 32, True)
    for got, want in zip(
            t_train.synthetic_batches(*args, seed=5, mask_coverage=0.3),
            root_train.synthetic_batches(*args, seed=5, mask_coverage=0.3)):
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            # the test harness turns x64 on, so the JAX side's constant
            # poses are float64 here; the port's floats are always float32
            assert got[k].shape == w.shape, k
            assert got[k].dtype == (np.float32 if w.dtype.kind == "f"
                                    else w.dtype), k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
