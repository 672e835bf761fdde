"""Shared pieces of the dataset evaluation scripts `eval_tum`, `eval_euroc`,
`eval_7_scenes` and `eval_eth3d`, the counterparts of the repository's
`scripts/eval_*.sh`.

For every sequence an evaluation runs the port's SLAM CLI

    python -m splatt3r_slam_tpu_torch --dataset <root>/<seq> --config C
        --no-viz --save-as S [EXTRA_ARGS] --device D

and then the port's ATE on the trajectory it wrote

    python -m splatt3r_slam_tpu_torch.scripts.compute_ate GT
        logs/<S>/<seq>.txt --device D

each in a process of its own, as the shell scripts run `python main.py`
and `python scripts/compute_ate.py`: nothing of one sequence's run (the
global config, the flash-attention mode, the device's memory) is there
for the next. The child processes find the port through PYTHONPATH, to
which the checkout's root is added. Settings come from the scripts'
environment variables with their defaults, read as bash reads
`${VAR:-default}` (unset or empty takes the default); the word lists
(`EXTRA_ARGS`, `SEQS_OVERRIDE`) split on whitespace. A failed SLAM run
stops the evaluation with its exit code (the scripts' `set -e`); what a
failed ATE does is each evaluation's own, as in its script.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from splatt3r_slam_tpu_torch.scripts._common import ROOT


def setting(name: str, default: str) -> str:
    """The environment variable `name`, or `default` where it is unset or
    empty."""
    return os.environ.get(name) or default


def parse_args(argv, prog: str, doc: str):
    """`--device` (default cuda), resolved at once: asking for CUDA
    without a GPU raises before any sequence runs."""
    from splatt3r_slam_tpu_torch import resolve_device

    ap = argparse.ArgumentParser(
        prog=f"python -m splatt3r_slam_tpu_torch.scripts.{prog}",
        description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the device of every run (default cuda; asking "
                         "for cuda without a GPU raises)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return args


def run(cmd) -> int:
    """`cmd` in a process of its own, its output on this one's → its exit
    code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    sys.stdout.flush()
    return subprocess.run(list(cmd), env=env).returncode


def slam(dataset: str, config: str, save_as: str, extra, device: str):
    """The CLI's command line for one sequence."""
    return [sys.executable, "-m", "splatt3r_slam_tpu_torch", "--dataset",
            dataset, "--config", config, "--no-viz", "--save-as", save_as,
            *extra, "--device", device]


def ate(gt: str, est: str, device: str):
    """The ATE's command line for one trajectory."""
    return [sys.executable, "-m",
            "splatt3r_slam_tpu_torch.scripts.compute_ate", gt, est,
            "--device", device]


def existing(path: str):
    """`path` where it is a file, else None (`[ -f "$gt" ]`)."""
    return path if os.path.isfile(path) else None


def suite(seqs, dataset, gt, config: str, save_as: str, extra,
          device: str, ate_fatal: bool) -> int:
    """Every sequence in turn: its header, the CLI on `dataset(seq)`, then
    the ATE of `logs/<save_as>/<seq>.txt` against `gt(seq)` where that is
    not None (asked after the run) → the exit code. A failed SLAM run
    stops the evaluation with its code, a failed ATE only where
    `ate_fatal`."""
    for seq in seqs:
        print(f"=== {seq} ===", flush=True)
        rc = run(slam(dataset(seq), config, save_as, extra, device))
        if rc:
            return rc
        truth = gt(seq)
        if truth is not None:
            rc = run(ate(truth, f"logs/{save_as}/{seq}.txt", device))
            if rc and ate_fatal:
                return rc
    return 0
