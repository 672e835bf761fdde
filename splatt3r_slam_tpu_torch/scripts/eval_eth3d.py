"""ETH3D SLAM evaluation: the port's SLAM run on every sequence folder of
the dataset root, then the ATE against the folder's `groundtruth.txt`.

    python -m splatt3r_slam_tpu_torch.scripts.eval_eth3d [--device cuda|cpu]

Counterpart of the repository's `scripts/eval_eth3d.sh`, with the same
settings: DATASET_ROOT (datasets/eth3d), CONFIG (config/eval_calib.yaml)
and SAVE_AS (eth3d_eval). The sequences are the root's subfolders in
sorted order, each given as the script's glob `"$DATASET_ROOT"/*/` gives
it (with its trailing slash); a root without one is an error, as the
script's run on the unmatched glob is. A failed SLAM run stops the
evaluation with its exit code; the ATE runs where the folder has its
groundtruth, and a failed one is passed over (the script's `|| true`).
Each sequence's run and ATE are processes of their own (`_eval`);
`--device` goes to both.
"""

from __future__ import annotations

import glob
import os
import sys

from splatt3r_slam_tpu_torch.scripts import _eval

DEFAULTS = {"DATASET_ROOT": "datasets/eth3d",
            "CONFIG": "config/eval_calib.yaml", "SAVE_AS": "eth3d_eval"}


def main(argv=None) -> int:
    args = _eval.parse_args(argv, "eval_eth3d", __doc__)
    root, config, save_as = (_eval.setting(k, v) for k, v in DEFAULTS.items())
    dirs = sorted(glob.glob(glob.escape(root) + "/*/"))
    if not dirs:
        print(f"eval_eth3d: no sequence folder under {root}", file=sys.stderr)
        return 1
    # each folder as the glob gives it, with its trailing slash
    return _eval.suite(
        [os.path.basename(d.rstrip("/")) for d in dirs],
        lambda s: f"{root}/{s}/",
        lambda s: _eval.existing(f"{root}/{s}//groundtruth.txt"), config,
        save_as, (), args.device, ate_fatal=False)


if __name__ == "__main__":
    sys.exit(main())
