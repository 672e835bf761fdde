"""TUM RGB-D fr1 evaluation: the port's SLAM run on each sequence, then
the Sim(3)-aligned ATE RMSE of its keyframe trajectory.

    python -m splatt3r_slam_tpu_torch.scripts.eval_tum [--device cuda|cpu]

Counterpart of the repository's `scripts/eval_tum.sh`, with the same
settings: DATASET_ROOT (datasets/tum), CONFIG (config/eval_no_calib.yaml),
SAVE_AS (tum_eval), EXTRA_ARGS (--require-checkpoint: the CLI stops
rather than report a random-weights ATE; give other flags to run without
a checkpoint) and SEQS_OVERRIDE (sequences to run in place of the nine fr1
ones, e.g. the committed fixture). Without SEQS_OVERRIDE and without
DATASET_ROOT the sequences are fetched first by `scripts/download_tum.sh`.
The ATE is computed where `<root>/<seq>/groundtruth.txt` exists; a failed
SLAM run or ATE stops the evaluation with its exit code. Each sequence's
run and ATE are processes of their own (`_eval`); `--device` goes to
both.
"""

from __future__ import annotations

import os
import sys

from splatt3r_slam_tpu_torch.scripts import _eval

SEQS = ("rgbd_dataset_freiburg1_360", "rgbd_dataset_freiburg1_desk",
        "rgbd_dataset_freiburg1_desk2", "rgbd_dataset_freiburg1_floor",
        "rgbd_dataset_freiburg1_plant", "rgbd_dataset_freiburg1_room",
        "rgbd_dataset_freiburg1_rpy", "rgbd_dataset_freiburg1_teddy",
        "rgbd_dataset_freiburg1_xyz")
DEFAULTS = {"DATASET_ROOT": "datasets/tum",
            "CONFIG": "config/eval_no_calib.yaml", "SAVE_AS": "tum_eval",
            "EXTRA_ARGS": "--require-checkpoint"}


def main(argv=None) -> int:
    args = _eval.parse_args(argv, "eval_tum", __doc__)
    root, config, save_as, extra = (
        _eval.setting(k, v) for k, v in DEFAULTS.items())
    override = _eval.setting("SEQS_OVERRIDE", "")
    if not override and not os.path.isdir(root):
        rc = _eval.run(["bash", str(_eval.ROOT / "scripts" /
                                    "download_tum.sh")])
        if rc:
            return rc
    return _eval.suite(
        override.split() if override else SEQS, lambda s: f"{root}/{s}",
        lambda s: _eval.existing(f"{root}/{s}/groundtruth.txt"), config,
        save_as, extra.split(), args.device, ate_fatal=True)


if __name__ == "__main__":
    sys.exit(main())
