"""Write the LPIPS-VGG weight file of the trainer's perceptual loss.

    python -m splatt3r_slam_tpu_torch.scripts.convert_lpips
        (--from-file lpips_vgg.pt | --from-lpips) OUT.npz [--device cuda|cpu]

Counterpart of the repository's `scripts/convert_lpips.py`. The reference
trains with `lpips.LPIPS('vgg')`, whose weights are torchvision's
pretrained VGG16 `features.*` and the lpips package's `lin{0..4}`
calibration tensors. Two sources:

  1. a torch state-dict file saved from the reference module:
         torch.save(lpips.LPIPS(net='vgg').state_dict(), 'lpips_vgg.pt')
         python -m ...convert_lpips --from-file lpips_vgg.pt out.npz
  2. `--from-lpips`: instantiate `lpips.LPIPS('vgg')` (needs the lpips
     package and torchvision's weights; run it where they are installed).

The state dict goes through `utils/lpips.py::convert_torch_lpips` on the
device, and the `.npz` holds the layout both packages'
`load_lpips_params` read: `conv_{slice}_{i}_{kernel|bias}` with HWIO
kernels (the JAX package's layout, converted back to OIHW on loading) and
`lin_{slice}`. Then `TrainConfig(lpips_weight=...)` with
`train.lpips_params=out.npz`. Runs on CUDA unless `--device cpu` is given
and raises without a GPU. Prints the result as JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def save_tree(params: dict, out: str) -> int:
    """The parameter tree (OIHW torch kernels) → the `.npz` layout
    `load_lpips_params` reads back; → the number of arrays written."""
    flat = {}
    for s, block in enumerate(params["convs"]):
        for c, p in enumerate(block):
            flat[f"conv_{s}_{c}_kernel"] = (
                p["kernel"].permute(2, 3, 1, 0).cpu().numpy())  # → HWIO
            flat[f"conv_{s}_{c}_bias"] = p["bias"].cpu().numpy()
    for s, lin in enumerate(params["lins"]):
        flat[f"lin_{s}"] = lin.cpu().numpy()
    np.savez(out, **flat)
    return len(flat)


def main(argv=None) -> dict:
    """Convert; returns the printed result."""
    import torch

    from splatt3r_slam_tpu_torch.scripts import _common as cm
    from splatt3r_slam_tpu_torch.utils.lpips import convert_torch_lpips

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.convert_lpips",
        description=__doc__.split("\n")[0])
    ap.add_argument("--from-lpips", action="store_true",
                    help="instantiate lpips.LPIPS('vgg') (needs the "
                         "lpips package + torchvision weights)")
    ap.add_argument("--from-file", default=None,
                    help="torch state-dict file of an lpips.LPIPS('vgg')")
    ap.add_argument("out")
    cm.add_device_args(ap, tiny=False)
    args = ap.parse_args(argv)
    device, _ = cm.setup(args)

    if args.from_lpips:
        import lpips as lpips_pkg  # an environment that has the package

        sd = lpips_pkg.LPIPS(net="vgg").state_dict()
    elif args.from_file:
        sd = torch.load(args.from_file, map_location="cpu",
                        weights_only=True)
    else:
        ap.error("need --from-lpips or --from-file")

    n = save_tree(convert_torch_lpips(sd, device=device), args.out)
    out = {"out": args.out, "arrays": n}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
