"""On the card, at each cell's own size: the program's readings hold
within the cell's limits on three seeds, and the lower-precision control
(`run.lower`, each stage one precision lower on the stage's own inputs)
reads beyond the limit of every number it is compared on. Run with
`python3 -m pytest benchmark/tests -m card` on a machine with a CUDA
device; elsewhere each test skips itself."""

import json
import pathlib

import pytest

from benchmark import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_holds_and_control_fails(name, card):
    cell = run.load_cell(name)
    limits = cell["limits"]
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        out = run.execute(cell, seed, 12.0, False, device=card, control=True)
        for number, (value, limit) in out["checks"].items():
            assert value <= limit, (seed, number, value, limit)
        for number, values in out["control"].items():
            if values and number in limits:
                assert max(values) > limits[number], (seed, number, values)
