"""EuRoC MAV evaluation (the frames always undistorted): the port's SLAM
run on each sequence, then the ATE against `<GT_ROOT>/<seq>.txt`.

    python -m splatt3r_slam_tpu_torch.scripts.eval_euroc [--device cuda|cpu]

Counterpart of the repository's `scripts/eval_euroc.sh`, with the same
settings: DATASET_ROOT (datasets/euroc), GT_ROOT (groundtruths/euroc),
CONFIG (config/eval_no_calib.yaml) and SAVE_AS (euroc_eval), and its
eleven sequences. A failed SLAM run stops the evaluation with its exit
code; a failed ATE (a sequence without its groundtruth file) is passed
over, as the script's `|| true` passes it. Each sequence's run and ATE
are processes of their own (`_eval`); `--device` goes to both.
"""

from __future__ import annotations

import sys

from splatt3r_slam_tpu_torch.scripts import _eval

SEQS = ("MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
        "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
        "V2_01_easy", "V2_02_medium", "V2_03_difficult")
DEFAULTS = {"DATASET_ROOT": "datasets/euroc", "GT_ROOT": "groundtruths/euroc",
            "CONFIG": "config/eval_no_calib.yaml", "SAVE_AS": "euroc_eval"}


def main(argv=None) -> int:
    args = _eval.parse_args(argv, "eval_euroc", __doc__)
    root, gt_root, config, save_as = (
        _eval.setting(k, v) for k, v in DEFAULTS.items())
    return _eval.suite(SEQS, lambda s: f"{root}/{s}",
                       lambda s: f"{gt_root}/{s}.txt", config, save_as, (),
                       args.device, ate_fatal=False)


if __name__ == "__main__":
    sys.exit(main())
