"""The port's mesh trainer (parallel/mesh.py, parallel/trainer.py, the
train CLI) against its single-process trainer and the JAX layout rules.

Each multi-rank world is N gloo processes started with spawn, one torch
thread each, a file store in a fresh temporary directory and a 600 s
timeout on every collective and on the whole run. Worlds:
(dp=4), (dp=2, fsdp=2) and (dp=2, fsdp=2, tp=2) on the tiny fp32 model,
the full render loss (MSE + SSIM + LPIPS + Regr3D) on a batch of 4 rows
whose valid pixels and loss masks differ from row to row. The reference
is the single-process `Trainer` on the whole batch, from the same seeded
weights; renders are held on identical predictions (tests/
torch_dist_helpers.py says why), the predictions themselves at 1e-4.

Tolerances: loss and metrics 1e-5 relative; each gradient (gathered,
before the step) within 1e-4 of its tensor's largest entry; after two
training steps every parameter within 2·lr of the reference and 99.9% of
them within 0.01·lr (Adam moves an entry by up to lr a step, in the sign
of its gradient, wherever that gradient is far above eps: an entry whose
gradient is at rounding level can step the other way, any other entry
cannot). A mean of per-row losses, what averaging each rank's own loss
would give, misses the loss tolerance by more than a hundredfold.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as dh
from splatt3r_slam_tpu.models import Splatt3RModel as JModel
from splatt3r_slam_tpu.models import TwoViewConfig as JConfig
from splatt3r_slam_tpu.parallel.mesh import make_mesh as j_make_mesh
from splatt3r_slam_tpu.parallel.mesh import param_sharding
from splatt3r_slam_tpu_torch.models import Splatt3RModel, TwoViewConfig
from splatt3r_slam_tpu_torch.models.checkpoint import params_from_jax
from splatt3r_slam_tpu_torch.parallel import mesh as pmesh
from splatt3r_slam_tpu_torch.splat import cuda_rasterizer as cr
from test_torch_port_bench import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()


def test_tp_plan_is_the_jax_rules():
    """The parameters split over tp, and their axes, are those of the JAX
    `param_sharding` on a (2, 2, 2) mesh, carried to the port's names by
    the checkpoint conversion: each JAX leaf split over tp holds its index
    along the split axis, and the converted tensor shows which axis (and
    which parameter) that became."""
    jcfg = JConfig(dtype="float32", head_dtype="float32").tiny()
    img = jnp.zeros((1, 32, 48, 3))
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(
        jax.random.PRNGKey(0), img, img))["params"]
    shard = param_sharding(j_make_mesh(8, fsdp=2, tp=2), shapes)

    def marker(s, sh):
        spec = tuple(sh.spec) + (None,) * (len(s.shape) - len(sh.spec))
        if "tp" not in spec:
            return np.zeros(s.shape, np.float32)
        ax = spec.index("tp")
        idx = np.arange(1, s.shape[ax] + 1, dtype=np.float32)
        return np.broadcast_to(
            idx.reshape([-1 if i == ax else 1 for i in range(len(s.shape))]),
            s.shape).copy()

    sd = params_from_jax(jax.tree.map(marker, shapes, shard), CFG)
    want = {}
    for name, t in sd.items():
        t = np.asarray(t)
        if not t.any():
            continue
        varies = [ax for ax in range(t.ndim)
                  if np.ptp(t, axis=ax).any()]
        assert len(varies) == 1, (name, varies)
        want[name] = varies[0]
    assert len(want) == 2 * 4 * 7 + 2 * 4  # decoder blocks, encoder blocks
    assert pmesh.tp_param_axes(Splatt3RModel(CFG)) == want


CASES = {
    "dp4": dict(world=4, fsdp=1, tp=1,
                tcfg=dict(train_gaussian_heads_only=True)),
    "dp2_fsdp2_accum2": dict(world=4, fsdp=2, tp=1,
                             tcfg=dict(train_gaussian_heads_only=False,
                                       accum_steps=2)),
    "dp2_fsdp2_tp2": dict(world=8, fsdp=2, tp=2,
                          tcfg=dict(train_gaussian_heads_only=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_single_process(case):
    c = CASES[case]
    batches = [dh.uneven_batch(4, 0), dh.uneven_batch(4, 1)]
    ref = dh.reference_run(c["tcfg"], batches)
    got = pmesh.launch(dh.mesh_rank, c["world"],
                       (c["fsdp"], c["tp"], c["tcfg"], batches,
                        ref["preds"]), device_type="cpu")

    for k, want in ref["metrics"].items():
        assert abs(got["metrics"][k] - want) <= 1e-5 * abs(want), (
            k, got["metrics"][k], want)
    for own, want in zip(got["own_preds"], ref["preds"][0]):
        for k, w in want.items():  # rank 0 holds row 0
            assert np.abs(own[k] - w[:1]).max() <= 1e-4 * np.abs(w).max(), k

    assert set(got["grads"]) == set(ref["grads"])
    if c["tcfg"]["train_gaussian_heads_only"]:
        assert all("gaussian_dpt" in k for k in ref["grads"])
    else:  # every tensor-parallel weight trains and is held
        assert set(pmesh.tp_param_axes(Splatt3RModel(CFG))) <= set(
            ref["grads"])
    live = 0
    for k, want in ref["grads"].items():
        peak = np.abs(want).max()  # 0 for the unused descriptor heads
        live += peak > 0
        assert np.abs(got["grads"][k] - want).max() <= 1e-4 * peak, k
    assert live >= 0.9 * len(ref["grads"])

    diff = np.concatenate([np.abs(got["params"][k] - v).ravel()
                           for k, v in ref["params"].items()])
    assert set(got["params"]) == set(ref["params"])
    assert diff.max() <= 2 * dh.LR, diff.max()
    assert np.mean(diff <= 0.01 * dh.LR) >= 0.999

    # the same loss as a mean of each row's own loss, as averaging each
    # rank's loss would give it
    t = dh.make_trainer(dh.train_config(**c["tcfg"]))
    with torch.no_grad():
        per_row = [float(t.loss_fn({k: v[i:i + 1] for k, v in
                                    batches[0].items()})[0])
                   for i in range(4)]
    want = ref["metrics"]["loss"]
    assert abs(np.mean(per_row) - want) > 100 * 1e-5 * abs(want)


def test_mesh_eval_step_runs_the_whole_batch_on_every_rank():
    """The masked eval step on a (1, 2, 2) mesh: every rank renders the
    whole batch and its metrics are the one-process eval's (1e-5
    relative), its render equal to 1e-6 and its own predictions to 1e-4
    of each peak."""
    batch = dh.uneven_batch(4, 2)
    (want, want_img), preds = dh.reference_eval(batch)
    (got, img), own = pmesh.launch(dh.eval_rank, 4, (2, 2, batch, preds),
                                   device_type="cpu")
    assert set(got) == set(want) == {"mse", "psnr", "ssim", "lpips"}
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * abs(w), (k, got[k], w)
    assert img.shape == want_img.shape == (4, 1, dh.H, dh.W, 3)
    assert np.abs(img - want_img).max() <= 1e-6
    for mine, ref in zip(own, preds):
        for k, w in ref.items():
            assert np.abs(mine[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def _run_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-m", "splatt3r_slam_tpu_torch.train",
                        "--device", "cpu", "--tiny-model", "--steps", "2",
                        "--set", "train.train_gaussian_heads_only=false",
                        "train.lr=1e-3", "--out", "out", "--name", "run",
                        *args], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    (ws,) = list((cwd / "out").iterdir())
    return ws, p.stdout


def test_train_cli_two_ranks_is_one_process_on_the_global_batch(tmp_path):
    """`--devices 2` trains on a (2, 1, 1) mesh, one sample per rank, and
    writes one workspace, one CSV and one checkpoint (rank 0's); its
    parameters are a one-process run's with `--batch-size 2`."""
    (tmp_path / "mesh").mkdir()
    (tmp_path / "one").mkdir()
    ws, out = _run_cli(["--devices", "2"], tmp_path / "mesh")
    ws1, _ = _run_cli(["--batch-size", "2"], tmp_path / "one")
    assert "mesh {'dp': 2, 'fsdp': 1, 'tp': 1}" in out
    assert out.count("workspace:") == 1
    assert sorted(p.name for p in ws.iterdir()) == sorted(
        p.name for p in ws1.iterdir()) == [
        "config.yaml", "params_final.npz", "provenance.json",
        "run_meta.json", "run_metrics.csv"]
    rows = (ws / "run_metrics.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("step,")  # header + 2
    a, b = np.load(ws / "params_final.npz"), np.load(
        ws1 / "params_final.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(
        Splatt3RModel(CFG).state_dict())
    diff = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in a.files])
    assert diff.max() <= 2 * 1e-3 and np.mean(diff <= 1e-5) >= 0.999


def _world_of_one(tmp_path):
    return pmesh.process_group(0, 1, f"file://{tmp_path / 'store'}", "cpu")


def test_mesh_rules_in_a_world_of_one(tmp_path):
    """make_mesh's divisibility and size checks, batch_rows at world size
    1, and a DTensor refused by the compositor (never its plain path)."""
    from torch.distributed.tensor import DTensor, Replicate

    with _world_of_one(tmp_path):
        with pytest.raises(ValueError, match="not divisible"):
            pmesh.make_mesh(1, fsdp=2)
        with pytest.raises(ValueError, match="has 1 ranks"):
            pmesh.make_mesh(2)
        mesh = pmesh.make_mesh(1)
        assert pmesh.mesh_shape(mesh) == {"dp": 1, "fsdp": 1, "tp": 1}
        b = {"x": np.arange(6).reshape(3, 2)}
        np.testing.assert_array_equal(pmesh.batch_rows(b, mesh)["x"],
                                      b["x"])
        counts = torch.zeros(1, dtype=torch.int32)
        origins = torch.zeros(1, 2, dtype=torch.int32)
        rows = DTensor.from_local(torch.zeros(4, 9), mesh["dp"],
                                  [Replicate()])
        before = cr.launches
        with pytest.raises(TypeError, match="DTensor"):
            cr.composite(counts, origins, rows, torch.zeros(3))
        with pytest.raises(TypeError, match="DTensor"):
            cr.composite_bwd(counts, origins, rows, torch.zeros(256, 4),
                             torch.zeros(256, 4))
        assert cr.launches == before


def _rows_rank(rank, world, init_method):
    with pmesh.process_group(rank, world, init_method, "cpu"):
        mesh = pmesh.make_mesh(world, fsdp=2)
        b = {"x": np.arange(12).reshape(4, 3), "y": np.arange(4)}
        mine = pmesh.batch_rows(b, mesh)["y"].tolist()
        try:
            pmesh.batch_rows({"x": np.zeros((3, 2))}, mesh)
        except ValueError as e:
            odd = str(e)
        got = [None] * world
        torch.distributed.all_gather_object(got, mine)
        return got, odd


def test_batch_rows_split_over_dp_and_fsdp():
    got, odd = pmesh.launch(_rows_rank, 2, device_type="cpu")
    assert got == [[0, 1], [2, 3]]
    assert "do not split over dp x fsdp = 2 ranks" in odd
