"""A rehearsal of every cell of `BENCHMARK.json` on the CPU, with the
tiny model and the plain kernels: every file is found by name, the result
line has the keys the benchmark's contract asks for, the program's
keyframe decisions and edges are the expected ones, and the traffic's
keyframe cadence and loop edges are what each cell is there for."""

import json
import pathlib

import numpy as np
import pytest

from benchmark import run
from benchmark.reference import geometry
from benchmark.traffic import Traffic

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = (192, 256)


def _expected(name: str, hw=(384, 512)):
    """Keyframes of one session (frame ids) and the backend's edges, as
    the criterion and the gate give them on the true poses."""
    cell = run.load_cell(name)
    slam = cell["config"]["slam"]
    tr = Traffic(cell["traffic"], *hw, slam["dataset"]["subsample"], 0)
    scene = geometry.Scene(*hw, tr.plane_n, tr.plane_d)
    exp = geometry.Expectation(scene, tr.poses, slam,
                               cell["config"]["runtime"]["retrieval"])
    kfs = [0]
    for j in range(1, tr.n):
        if exp.keyframe(j, kfs[-1])[0]:
            kfs.append(j)
    return kfs, exp.edges(kfs)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_from_its_files(name):
    cell = run.load_cell(name)
    for m in cell["per_layer"]:
        assert callable(run.reader(cell["metrics_dir"], m["name"]))
    out = run.execute(cell, 2**31 + 12345, 2.0, False, device="cpu",
                      small=SMALL)
    res = json.loads(json.dumps(out["result"]))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert out["loop"]["keyframes"] == 0 and out["loop"]["edges"] == 0
    for k, v in res["checks"].items():
        assert set(v) == {"value", "limit"}, k


def test_a_traced_run_reports_per_layer_metrics():
    cell = run.load_cell(CELLS[0])
    out = run.execute(cell, 77, 1.0, True, device="cpu", small=(48, 64))
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    names = {m["name"] for m in cell["per_layer"]}
    assert set(res["metrics"]) <= names
    # on the CPU no device operation ran: the device's metrics read nothing
    assert "device.idle_share" not in res["metrics"]
    assert "system.host_self_ms_per_frame" in res["metrics"]
    assert res["device"]["window_s"] > 0


def test_keyframe_cadence_and_loop_edges():
    """live-track-40: a keyframe every 8-9 frames through the whole session;
    eval-exact-40: loop edges in every session (its sessions are alike)."""
    kfs, _ = _expected("live-track-40")
    gaps = np.diff(kfs)
    assert len(kfs) >= 5 and gaps.min() >= 7 and gaps.max() <= 10, kfs
    kfs, edges = _expected("eval-exact-40")
    loops = [(i, j) for i, j in edges if j - i > 1]
    assert len(loops) >= 2, edges
