"""Fast-path knob sweep on the sub-pixel synthetic oracle.

    python -m splatt3r_slam_tpu_torch.scripts.sweep_accuracy
        [--device cuda|cpu]

Counterpart of the repository's `scripts/sweep_accuracy.py`: the accuracy
cost of the fast-path approximations against reference-exact settings,
    - matching.match_stride   {1, 2}   (subgrid matching and pose GN)
    - local_opt.gn_stride     {1, 4}   (the backend's residual rows)
    - closed_form_init        {off, on} (pinhole seed + short LM polish)
    - refine_quantize         {off, on} (int8 descriptor tables)
on `synthetic_pair`'s textured plane at 96x128: five tracking variants
over 5 seeds x 4 pairs, and the backend's 6-view graph at both strides
over 5 seeds, with config/base.yaml's tracking settings. It writes
logs/sweep_accuracy.json (relative to the working directory) and prints a
markdown table. Runs on CUDA unless `--device cpu` is given and raises
without a GPU. The last line of stdout is the result as JSON.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from splatt3r_slam_tpu_torch.scripts import synthetic_pair as sp

H, W = 96, 128
N_SEEDS = 5
N_PAIRS = 4

VARIANTS = {
    "reference-exact": dict(match_stride=1, closed_form_init=False,
                            max_iter=10, refine_quantize=False),
    "match_stride=2": dict(match_stride=2, closed_form_init=False,
                           max_iter=10, refine_quantize=False),
    "closed_form_init": dict(match_stride=1, closed_form_init=True,
                             polish_iters=2, max_iter=10,
                             refine_quantize=False),
    "refine_quantize": dict(match_stride=1, closed_form_init=False,
                            max_iter=10, refine_quantize=True),
    "tpu-fast (all on)": dict(match_stride=2, closed_form_init=True,
                              polish_iters=2, max_iter=10,
                              refine_quantize=True),
}
GN_STRIDES = (("gn_stride=1", 1), ("gn_stride=4", 4))


def sweep_tracking(device):
    from splatt3r_slam_tpu_torch import config as cfgmod
    from splatt3r_slam_tpu_torch.scripts import _common as cm
    from splatt3r_slam_tpu_torch.tracking.tracker import TrackingConfig

    cm.load_base_config()
    tcfg = TrackingConfig.from_config(cfgmod.config)
    sc = sp.make_scene(H, W)

    results = {}
    for name, kw in VARIANTS.items():
        rot, trn, fails, fracs = [], [], 0, []
        for seed in range(N_SEEDS):
            rng = np.random.default_rng(seed)
            views = sp.make_trajectory(sc, N_PAIRS + 1, rng)
            for k in range(N_PAIRS):
                vk, vf = views[k], views[k + 1]
                Xc = sp.cross_pointmap(sc, vk, vf["T"], rng)
                ang, terr, fail, frac = sp.track_pair(
                    sc, vf, vk, Xc, tcfg, device=device, **kw)
                rot.append(ang)
                trn.append(terr)
                fails += int(fail)
                fracs.append(frac)
        results[name] = dict(
            rot_deg_mean=float(np.mean(rot)), rot_deg_max=float(np.max(rot)),
            t_err_mean=float(np.mean(trn)), t_err_max=float(np.max(trn)),
            fails=fails, match_frac=float(np.mean(fracs)), **kw,
        )
        print(f"[tracking] {name:22s} rot {np.mean(rot):.4f}° "
              f"t {np.mean(trn):.5f} frac {np.mean(fracs):.3f}")
    return results


def sweep_backend(device):
    sc = sp.make_scene(H, W)
    results = {}
    for name, stride in GN_STRIDES:
        ates = []
        for seed in range(N_SEEDS):
            rng = np.random.default_rng(100 + seed)
            views = sp.make_trajectory(sc, 6, rng)
            ates.append(sp.solve_graph(sc, views, rng, gn_stride=stride,
                                       device=device))
        results[name] = dict(ate_mean=float(np.mean(ates)),
                             ate_max=float(np.max(ates)), gn_stride=stride)
        print(f"[backend ] {name:22s} ATE {np.mean(ates):.5f} "
              f"(max {np.max(ates):.5f})")
    return results


def main(argv=None) -> dict:
    """Run the sweep; returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.sweep_accuracy",
        description=__doc__.split("\n")[0])
    cm.add_device_args(ap, tiny=False)
    args = ap.parse_args(argv)
    device, _ = cm.setup(args)

    out = {"scene": f"{H}x{W} textured plane, sigma_x=0.004 rel, "
                    f"sigma_desc=0.05, {N_SEEDS} seeds",
           "tracking": sweep_tracking(device),
           "backend": sweep_backend(device),
           **cm.device_fields(device)}
    path = pathlib.Path("logs/sweep_accuracy.json")
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"\nwrote {path}")

    ref = out["tracking"]["reference-exact"]
    print("\n| variant | rot err (deg, mean) | t err (mean) | vs exact |")
    print("|---|---|---|---|")
    for name, r in out["tracking"].items():
        print(f"| {name} | {r['rot_deg_mean']:.4f} | {r['t_err_mean']:.5f}"
              f" | {r['t_err_mean'] / max(ref['t_err_mean'], 1e-12):.2f}x |")
    b1 = out["backend"]["gn_stride=1"]
    for name, r in out["backend"].items():
        print(f"| {name} | — | ATE {r['ate_mean']:.5f} | "
              f"{r['ate_mean'] / max(b1['ate_mean'], 1e-12):.2f}x |")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
