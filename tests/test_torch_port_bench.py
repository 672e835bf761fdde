"""The port's tracking and system benchmarks on the CPU, tiny form.

`python -m splatt3r_slam_tpu_torch.bench` and
`python -m splatt3r_slam_tpu_torch.scripts.bench_system` are the
counterparts of the repository's `bench.py` and `scripts/bench_system.py`.
Here they run with `--device cpu` (the tiny fp32 model at 48x64):

- `SyntheticDataset` equals the JAX script's bit for bit (the script is
  loaded by path; it imports only numpy at module level);
- `bench` prints its JSON last, with the keys the port's bench defines;
- `bench_system --cadence 4 --render-stride 2` over 12 frames keyframes at
  frames 0, 4 and 8, renders every other frame of the warm-up and the
  timed run (12 renders; on the CPU the plain compositor runs and no
  kernel launch is counted), and prints the JAX script's key set for that
  mode (`scripts/bench_system.py:550-604`, read from its source) plus
  `device` and `power_limit_w`.

The closed loop on the oracle against the JAX script is
`tests/test_torch_port_bench_oracle.py`.
"""

import ast
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from splatt3r_slam_tpu_torch import bench
from splatt3r_slam_tpu_torch.scripts import bench_system
from splatt3r_slam_tpu_torch.splat import cuda_rasterizer as cr
from splatt3r_slam_tpu_torch.splat import decoder

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_SCRIPT = ROOT / "scripts" / "bench_system.py"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the tiny model: its eager ops are too small
    to gain from more, and the test workers share the host's cores (with
    a thread per core in each worker, they slow down many times over).
    Module-scoped, so that it also covers the module's own fixtures, and
    set for the processes a test starts too (OMP_NUM_THREADS)."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def load_jax_script():
    """scripts/bench_system.py as a module, leaving the environment and
    sys.path as they were (it sets defaults in both at import)."""
    env, path = dict(os.environ), list(sys.path)
    spec = importlib.util.spec_from_file_location("jax_bench_system",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


def jax_result_keys(func: str, guards=()) -> set:
    """Keys of the JAX script's result dict in `func`: the `out = {...}`
    literal, plus `out.update({...})` under `if args.<guard>:`."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Attribute)
                and node.test.attr in guards):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "update"
                        and getattr(sub.func.value, "id", None) == "out"):
                    keys |= {k.value for k in sub.args[0].keys}
    return keys


def last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("n,h,w,seed", [(40, 384, 512, 0), (12, 48, 64, 0),
                                        (4, 48, 64, 7), (1, 30, 50, 3)])
def test_synthetic_dataset_bit_equal(n, h, w, seed):
    mine = bench_system.SyntheticDataset(n, h, w, seed=seed)
    theirs = load_jax_script().SyntheticDataset(n, h, w, seed=seed)
    assert len(mine) == len(theirs) == n
    for i in range(n):
        a, b = mine[i], theirs[i]
        assert a[0] == b[0]
        assert a[1].dtype == b[1].dtype and a[1].tobytes() == b[1].tobytes()


def test_bench_cpu_prints_json(capsys, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ret = bench.main(["--device", "cpu"])
    out = last_json(capsys)
    assert out == {k: ret[k] for k in out}
    assert set(out) == {"metric", "value", "unit", "device", "power_limit_w"}
    assert out["metric"] == "tracking_fps_tiny_cpu"
    assert out["unit"] == "frames/s" and out["value"] > 0
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert len(ret["passes"]) == 3
    assert out["value"] == round(float(np.median(ret["passes"])), 3)
    assert torch.backends.cudnn.allow_tf32 is False


def test_bench_system_cadence_cpu(capsys, monkeypatch):
    renders = []
    real = decoder.render_frame

    def counted(*a, **kw):
        img = real(*a, **kw)
        renders.append(img is not None)
        return img

    monkeypatch.setattr(decoder, "render_frame", counted)
    launches0 = cr.launches
    ret = bench_system.main(["--device", "cpu", "--cadence", "4",
                             "--render-stride", "2", "--frames", "12"])
    out = last_json(capsys)
    assert out == ret
    want = jax_result_keys("main", ("cadence",)) | {"device",
                                                    "power_limit_w"}
    assert set(out) == want
    assert out["metric"] == "system_fps_tiny" and out["value"] > 0
    assert out["mode"] == "cadence" and out["cadence"] == 4
    assert out["render_stride"] == 2 and out["frames"] == 12
    # frame 0 (INIT) and the forced keyframes at frames 4 and 8
    assert out["keyframes"] == 3
    assert out["backend_edges"] >= 2
    assert [k for k, _ in out["backend_task_ms"]] == [0, 1, 2]
    assert len(out["frame_ms"]) == 12
    # frames 0, 2, ..., 10 render in the warm-up and in the timed run
    assert renders == [True] * 12
    assert cr.launches == launches0  # the plain compositor on the CPU
    assert out["gaussians"] > 0
