"""7-Scenes evaluation: the port's SLAM run on each scene, then the ATE
against `<GT_ROOT>/<seq>.txt`.

    python -m splatt3r_slam_tpu_torch.scripts.eval_7_scenes
        [--device cuda|cpu]

Counterpart of the repository's `scripts/eval_7_scenes.sh`, with the same
settings: DATASET_ROOT (datasets/7-scenes), GT_ROOT
(groundtruths/7-scenes), CONFIG (config/eval_calib.yaml) and SAVE_AS
(7scenes_eval), and its seven scenes. A failed SLAM run stops the
evaluation with its exit code; a failed ATE is passed over, as the
script's `|| true` passes it. Each scene's run and ATE are processes of
their own (`_eval`); `--device` goes to both.
"""

from __future__ import annotations

import sys

from splatt3r_slam_tpu_torch.scripts import _eval

SEQS = ("chess", "fire", "heads", "office", "pumpkin", "redkitchen",
        "stairs")
DEFAULTS = {"DATASET_ROOT": "datasets/7-scenes",
            "GT_ROOT": "groundtruths/7-scenes",
            "CONFIG": "config/eval_calib.yaml", "SAVE_AS": "7scenes_eval"}


def main(argv=None) -> int:
    args = _eval.parse_args(argv, "eval_7_scenes", __doc__)
    root, gt_root, config, save_as = (
        _eval.setting(k, v) for k, v in DEFAULTS.items())
    return _eval.suite(SEQS, lambda s: f"{root}/{s}",
                       lambda s: f"{gt_root}/{s}.txt", config, save_as, (),
                       args.device, ate_fatal=False)


if __name__ == "__main__":
    sys.exit(main())
