"""Three repairs of the port's entry points, each against what the JAX
package does.

- Precision: every entry point (the SLAM CLI, the train CLI and the five
  measurement entry points) turns TF32 off for cuBLAS and cuDNN before it
  touches the device (`splatt3r_slam_tpu_torch.set_fp32_precision`), so
  the fp32 heads that `config/eval_*.yaml` ask for run in fp32 on the
  card. PyTorch leaves cuDNN's TF32 on by default. Here each entry point
  is called with `--device cuda` on a machine without a GPU: it must turn
  both flags off and then raise, as asking for CUDA without a GPU does.
- Retrieval: a database that cannot be built (a bad `--codebook`) prints
  `retrieval disabled: <error>` and the run goes on without it, as
  `main.py:232-241` does (`cli.build_retrieval`).
- The train CLI's `--config` without PyYAML: `parallel/workspace.py`
  reads files with the port's `config.parse_yaml` (the `include:` list,
  in block or flow style, merged in order) and dotlist values with
  `config.parse_scalar`. With PyYAML unimportable, it must give what the
  JAX package's `load_config` gives with PyYAML on the same files and
  values. The JAX package's loader resolves floats with its extended
  resolver, which `splatt3r_slam_tpu.config` installs on
  `yaml.SafeLoader` when it is imported (it is imported here, so the
  result does not depend on which tests ran before in this process).
"""

import argparse
import builtins

import pytest
import torch

from splatt3r_slam_tpu import config as _jcfg  # noqa: F401  (the resolver)
from splatt3r_slam_tpu.parallel import workspace as j_ws
from splatt3r_slam_tpu_torch import cli, train
from splatt3r_slam_tpu_torch.models import TwoViewConfig
from splatt3r_slam_tpu_torch.parallel import workspace as t_ws
from test_torch_port_bench import one_torch_thread  # noqa: F401


def _entry_points(tmp_path):
    from splatt3r_slam_tpu_torch import bench
    from splatt3r_slam_tpu_torch.scripts import (
        bench_system,
        profile_keyframe_event,
        profile_stages,
        soak,
    )

    return {
        "cli": (cli.main, ["--dataset", str(tmp_path), "--no-viz"]),
        "train": (train.main, ["--tiny-model", "--steps", "1", "--out",
                               str(tmp_path / "train")]),
        "bench": (bench.main, []),
        "bench_system": (bench_system.main, []),
        "soak": (soak.main, []),
        "profile_stages": (profile_stages.main, []),
        "profile_keyframe_event": (profile_keyframe_event.main, []),
    }


NAMES = ["cli", "train", "bench", "bench_system", "soak", "profile_stages",
         "profile_keyframe_event"]


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        saved


@pytest.mark.parametrize("name", NAMES)
def test_entry_point_turns_tf32_off_and_refuses_missing_cuda(
        name, tmp_path, monkeypatch, tf32_on):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv + ["--device", "cuda"])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_failing_retrieval_build_disables_retrieval(tmp_path, capsys):
    args = argparse.Namespace(retrieval_checkpoint=None,
                              codebook=str(tmp_path / "missing.npy"))
    cfg = TwoViewConfig().tiny()
    assert cli.build_retrieval(args, cfg, "cpu") is None
    assert "retrieval disabled: " in capsys.readouterr().out
    # and a good build still returns the database
    ok = argparse.Namespace(retrieval_checkpoint=None, codebook=None)
    db = cli.build_retrieval(ok, cfg, "cpu")
    assert db is not None and db.codebook.size == 65536


def _no_pyyaml(monkeypatch):
    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("no yaml")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)


SCALARS = ["true", "null", "1e-3", "[1, 2]", "0.5", "abc"]


@pytest.mark.parametrize("style", ["block", "flow"])
def test_workspace_load_config_without_pyyaml_matches_jax(
        style, tmp_path, monkeypatch):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "base.yaml").write_text(
        "# the parent\ntrain:\n  lr: 1e-5\n  k_max: 128\n"
        "  lr_milestones: [2, 4]\n  render_loss: false\n"
        "model:\n  remat: no\n  name: 'vit large'\n")
    (tmp_path / "other.yaml").write_text(
        "train:\n  k_max: 256\n  ssim_weight: .1\nparallel:\n  devices: 1\n")
    inc = ("include:\n  - sub/base.yaml\n  - other.yaml\n"
           if style == "block" else "include: [sub/base.yaml, other.yaml]\n")
    (tmp_path / "exp.yaml").write_text(
        inc + "train:\n  k_max: 64\n  lpips_params: ~\n")
    dotlist = [f"train.v{i}={v}" for i, v in enumerate(SCALARS)]
    monkeypatch.chdir(tmp_path / "sub")  # includes resolve next to exp.yaml
    want = j_ws.load_config(str(tmp_path / "exp.yaml"), dotlist=dotlist)
    _no_pyyaml(monkeypatch)
    with pytest.raises(ImportError):
        import yaml  # noqa: F401
    got = t_ws.load_config(str(tmp_path / "exp.yaml"), dotlist=dotlist)
    assert got == want
    assert [got["train"][f"v{i}"] for i in range(len(SCALARS))] == [
        True, None, 1e-3, [1, 2], 0.5, "abc"]
    assert got["train"]["k_max"] == 64 and got["train"]["lr"] == 1e-5
