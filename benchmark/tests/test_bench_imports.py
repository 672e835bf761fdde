"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Modules are compared by their
top-level name, whole: the port's name begins with the JAX package's."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "splatt3r_slam_tpu")


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    """A whole (tiny, CPU) run of a cell, and every module of the
    harness, leave no JAX module and no JAX-package module loaded."""
    names = _loaded(
        "import glob, importlib\n"
        "from benchmark import run, sweep, driver, tracing, flops\n"
        "cell = run.load_cell('live-track-40')\n"
        "for m in cell['per_layer']:\n"
        "    run.reader(cell['metrics_dir'], m['name'])\n"
        "run.execute(cell, 5, 0.5, True, device='cpu', small=(48, 64))\n")
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert "splatt3r_slam_tpu_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded(
        "from benchmark.reference import compare, geometry, matching, "
        "network, render, solve\n"
        "from benchmark import weights, traffic, flops\n")
    assert not names & set(FORBIDDEN + ("splatt3r_slam_tpu_torch",)), names


def test_no_source_of_the_reference_names_the_program():
    """By their text as well: no import of the program, of JAX or of the
    JAX package in the reference, and none of JAX anywhere under
    `benchmark/`."""
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            for top in tops:
                assert top not in FORBIDDEN, (path, top)
                if "reference" in path.parts:
                    assert top != "splatt3r_slam_tpu_torch", (path, top)
