"""The port's ablation runner (`splatt3r_slam_tpu_torch/ablations.py`)
against the repository's `ablations.py`.

- The `TrainConfig` of each of the six ablations equals the JAX script's,
  field by field, and so do the model's `use_offsets` and the batch each
  run trains on (the JAX side runs with its `Trainer` replaced by one that
  records its arguments and the batch handed to its step).
- The CLI on the CPU (`--tiny --device cpu`, one step each, the mesh at
  world size 1 over gloo) ends every ablation with finite metrics and
  writes each workspace's `metrics.json`; the first step's metrics of two
  ablations (`with_ssim`: MSE + SSIM; `with_mast3r_loss`: MSE + Regr3D)
  equal the JAX `Trainer.loss_fn` on the same weights and batch, at
  test_torch_port_train's bar (1e-4 relative). The weights are the port's
  seeded ones, carried to the JAX model by its `convert_state_dict` (a
  flax init takes ~40 s here).
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splatt3r_slam_tpu_torch import ablations
from splatt3r_slam_tpu_torch.train import synthetic_batches
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMPARED = ("with_ssim", "with_mast3r_loss")


def load_jax_ablations():
    spec = importlib.util.spec_from_file_location("jax_ablations",
                                                  ROOT / "ablations.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recorded(Exception):
    pass


@pytest.fixture(scope="module")
def jax_configs(tmp_path_factory):
    """{name: (TwoViewConfig, TrainConfig, the first step's batch)} as the
    JAX script builds them (full width, no --tiny): its `Trainer` is
    replaced by one that records its arguments and the batch handed to
    its step, and stops there."""
    import splatt3r_slam_tpu.parallel as jpar

    jab = load_jax_ablations()
    got = {}

    class Recorder:
        def __init__(self, model_cfg, tcfg, mesh=None):
            got["cfgs"] = (model_cfg, tcfg)

        def init_state(self, h, w):
            return None, None, None

        def make_train_step(self, pshard):
            def step(params, opt_state, batch):
                got["batch"] = {k: np.asarray(v) for k, v in batch.items()}
                raise _Recorded

            return step

    real = jpar.Trainer
    jpar.Trainer = Recorder
    try:
        ns = type("Args", (), dict(
            config=None, devices=1, tiny=False, res=(32, 48), steps=1,
            out=str(tmp_path_factory.mktemp("jax_ablations"))))
        out = {}
        for name, dotlist in jab.ABLATIONS.items():
            with pytest.raises(_Recorded):
                jab.run_one(name, list(dotlist), ns)
            out[name] = (*got["cfgs"], got["batch"])
    finally:
        jpar.Trainer = real
    return jab, out


@pytest.mark.parametrize("name", list(ablations.ABLATIONS))
def test_train_config_matches_jax(jax_configs, name):
    jab, want = jax_configs
    assert ablations.ABLATIONS == jab.ABLATIONS
    args = type("Args", (), dict(config=None, tiny=False))
    cfg, model_cfg, tcfg = ablations.build_configs(
        ablations.ABLATIONS[name], args)
    j_model, j_tcfg, j_batch = want[name]
    assert tcfg._fields == j_tcfg._fields
    for field in j_tcfg._fields:
        assert getattr(tcfg, field) == getattr(j_tcfg, field), field
    assert model_cfg.use_offsets == j_model.use_offsets
    assert model_cfg.enc_embed_dim == j_model.enc_embed_dim == 1024
    assert model_cfg.head_dtype == "bfloat16"
    # the batch run_one trains on (one sample a device, rng(0))
    batch = next(synthetic_batches(1, 1, 32, 48, True, seed=0))
    assert sorted(batch) == sorted(j_batch)
    for k, v in j_batch.items():  # values: the tests run JAX in x64, where
        # the script's poses and intrinsics are float64
        np.testing.assert_array_equal(batch[k], v, err_msg=k)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ablations")
    res = ablations.main(["--tiny", "--device", "cpu", "--steps", "1",
                          "--out", str(out)])
    return res, out


def test_cli_runs_every_ablation(cli_run):
    res, out = cli_run
    assert list(res) == list(ablations.ABLATIONS)
    for name, m in res.items():
        assert np.isfinite(list(m.values())).all(), (name, m)
        (ws,) = out.glob(f"ablation_{name}_*")
        hist = json.loads((ws / "metrics.json").read_text())
        assert hist == [m]
        assert (ws / "config.yaml").exists()
    assert set(res["with_ssim"]) == {"mse", "ssim", "loss"}
    assert set(res["with_mast3r_loss"]) == {"mse", "regr3d", "loss"}
    assert set(res["baseline"]) == {"mse", "loss"}


@pytest.mark.parametrize("name", COMPARED)
def test_first_step_metrics_match_jax(cli_run, name):
    from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
    from splatt3r_slam_tpu.models.checkpoint import convert_state_dict
    from splatt3r_slam_tpu.parallel import TrainConfig as JTrainConfig
    from splatt3r_slam_tpu.parallel import Trainer as JTrainer
    from splatt3r_slam_tpu.parallel.mesh import make_mesh
    from splatt3r_slam_tpu_torch.models import init_model

    res, _ = cli_run
    args = type("Args", (), dict(config=None, tiny=True))
    _, model_cfg, tcfg = ablations.build_configs(ablations.ABLATIONS[name],
                                                 args)
    model = init_model(model_cfg, seed=0, device="cpu")  # Trainer's seed 0
    jcfg = JConfig(dtype="float32", head_dtype="float32").tiny()
    jp = jax.tree.map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg))

    jt = JTrainer(jcfg, JTrainConfig(**tcfg._asdict()), mesh=make_mesh(1))
    batch = {k: jnp.asarray(v) for k, v in
             next(synthetic_batches(1, 1, 32, 48, True, seed=0)).items()}
    _, want = jax.jit(jt.loss_fn)(jp, batch)
    got = res[name]
    assert set(got) == set(want)
    for k, v in want.items():
        v = float(v)
        assert abs(got[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got[k], v)
