"""The network's comparison, as a run makes it, at full widths (ViT-L
1024x24, decoder 768x12, the DPT and gaussian heads) on a small image over
a dozen seeds: the program's readings lie within each cell's limits at
every seed, and the lower-precision control's lie beyond them at every
seed. The seeds include 806870695, at which the first attempt at this
benchmark read its network over its limit."""

import json
import pathlib

import pytest
import torch

from benchmark import run
from benchmark.reference.compare import Judge
from benchmark.reference.geometry import Scene
from benchmark.reference.network import Network, Shape
from benchmark.traffic import Traffic
from benchmark.weights import make_state

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEEDS = [806870695, 0, 1, 2, 3, 4, 5, 6, 7, 2718281828, 3141592653,
         1414213562]
HW = (64, 96)
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _program(cfg: dict, state: dict):
    from splatt3r_slam_tpu_torch.models import Splatt3RModel, TwoViewConfig

    m = dict(cfg["model"], head_layer_dims=tuple(
        cfg["model"]["head_layer_dims"]))
    with torch.device("meta"):
        model = Splatt3RModel(TwoViewConfig(
            **{k: v for k, v in m.items() if k in TwoViewConfig._fields}))
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


@torch.no_grad()
def _capture(model, frames, j: int, k: int) -> dict:
    """What `driver.Session` keeps of a tracking step on frame j against
    keyframe k (whose tokens carry its frame id, as the oracle stamps
    them), and of the gaussian head on the same hooks."""
    f, pos = model.encode(frames[j: j + 1])
    kf, kpos = model.encode(frames[k: k + 1])
    kf = kf.clone()
    kf[0, 0, 0] = float(k)
    d1, d2 = model.decode(f, pos, kf, kpos)
    cap = {"j": j, "kf": k, "encode": (f, pos), "decode": (f, kf, (d1, d2))}
    for num, d in ((1, d1), (2, d2)):
        for mode in ("tracking", "gaussian_only"):
            cap[("head", num, mode)] = (d, model.apply_head(num, d, HW, mode))
    return cap


@pytest.fixture(scope="module")
def shape():
    cfg = run.load_cell(CELLS[0])["config"]
    return Shape.from_dict(cfg["model"])


@pytest.mark.parametrize("seed", SEEDS)
def test_network_readings_hold_and_the_control_fails(seed, shape):
    from splatt3r_slam_tpu_torch import set_fp32_precision

    set_fp32_precision()
    state = make_state(shape, seed, "cpu")
    with torch.device("meta"):
        net = Network(shape)
    net.load_state_dict(state, strict=True, assign=True)
    for name in CELLS:
        cell = run.load_cell(name)
        cfg, limits = cell["config"], cell["limits"]
        assert Shape.from_dict(cfg["model"]) == shape
        tr = Traffic(cell["traffic"], *HW, cfg["slam"]["dataset"][
            "subsample"], seed)
        frames, _ = tr.frames("cpu")
        judge = Judge(net, cfg["slam"], frames,
                      Scene(*HW, tr.plane_n, tr.plane_d), tr.poses, HW,
                      bool(cfg["runtime"]["retrieval"]),
                      run.PRECISION[cfg["model"]["head_dtype"]])
        cap = _capture(_program(cfg, state), frames, 3, 2)
        ctrl = net.with_precision(*run.lower(cfg["model"]))
        prog = {"trunk": judge.trunk(cap)}
        prog["heads"], prog["gauss"] = judge.heads(cap)
        low = {"trunk": judge.trunk(cap, ctrl)}
        low["heads"], low["gauss"] = judge.heads(cap, ctrl)
        for k in prog:
            assert prog[k] <= limits[k], (name, k, prog[k], limits[k])
            assert low[k] > limits[k], (name, k, low[k], limits[k])
