"""ATE RMSE between a groundtruth and an estimated TUM trajectory.

    python -m splatt3r_slam_tpu_torch.scripts.compute_ate GT EST
        [--max-dt S] [--no-scale] [--device cuda|cpu]

Counterpart of the repository's `scripts/compute_ate.py`, the reference
eval scripts' `evo_ape tum <gt> <est> -as` (Sim(3) alignment; `--no-scale`
aligns in SE(3), `-a`) without the external evo package, through
`runtime/evaluate.py::ate_rmse`. The work is host numpy; like every entry
point of the port it asks for the device first (CUDA unless `--device cpu`
is given, raising without a GPU). Prints {"ate_rmse", "gt", "est"} as JSON.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    """Compute the ATE; returns the printed result."""
    from splatt3r_slam_tpu_torch.runtime.evaluate import ate_rmse
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    p = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.compute_ate",
        description=__doc__.split("\n")[0])
    p.add_argument("gt")
    p.add_argument("est")
    p.add_argument("--max-dt", type=float, default=0.02)
    p.add_argument("--no-scale", action="store_true",
                   help="SE3 alignment instead of Sim3 (-a instead of -as)")
    cm.add_device_args(p, tiny=False)
    args = p.parse_args(argv)
    cm.setup(args)

    rmse = ate_rmse(args.gt, args.est, max_dt=args.max_dt,
                    with_scale=not args.no_scale)
    out = {"ate_rmse": rmse, "gt": args.gt, "est": args.est}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
