"""Two-image Gaussian-splat demo (headless CLI or web app).

    python -m splatt3r_slam_tpu_torch.demo IMAGE1 IMAGE2 [--out DIR]
        [--n-views N] [--checkpoint CKPT] [--device cuda|cpu]
    python -m splatt3r_slam_tpu_torch.demo --serve PORT [--host HOST]

Counterpart of the repository's `demo.py` (the reference's Gradio
two-image app). The CLI runs two-view inference on an image pair, writes
the predicted gaussians as a 3DGS-format PLY (the model's raw SH residual
in the DC term, as the reference demo writes it; the web app's PLY holds
the source images' colours there), and renders an orbit of
`--n-views` novel views through the tile renderer (the hand-written CUDA
compositor on the card) to PNGs, and to an MP4 where cv2 can be imported.
`--serve PORT` runs the web app (`runtime/webdemo.py`) instead. PNG and
JPEG input are read without any image package (`utils/image.py`,
`utils/jpeg.py`); only the MP4 needs cv2. Weights come
from `--checkpoint`, else `checkpoints/` in the repository, else seeded
random weights; nothing is downloaded. It runs on CUDA unless `--device
cpu` is given, and raises without a GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def _parser():
    p = argparse.ArgumentParser(prog="python -m splatt3r_slam_tpu_torch.demo",
                                description=__doc__.split("\n")[0])
    p.add_argument("image1", nargs="?", default=None)
    p.add_argument("image2", nargs="?", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default="demo_out")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--n-views", type=int, default=24)
    p.add_argument("--tiny-model", action="store_true")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="run the web demo on this port instead of the CLI")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


def read_image(path) -> np.ndarray:
    """A PNG or JPEG file → (H, W, 3) float32 RGB in [0, 1], as the
    reference demo's `cv2.imread` + BGR→RGB reads it, without cv2."""
    from splatt3r_slam_tpu_torch.utils import image

    return image.read_image(path).astype(np.float32) / 255.0


def _model(args, device, model):
    """The caller's model, else `cli.load_model_params`' (seed 0)."""
    from splatt3r_slam_tpu_torch.cli import load_model_params
    from splatt3r_slam_tpu_torch.models import TwoViewConfig

    if model is not None:
        return model
    cfg = TwoViewConfig()
    if args.tiny_model:
        cfg = TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    return load_model_params(argparse.Namespace(
        checkpoint=args.checkpoint, seed=0, require_checkpoint=False), cfg,
        device)


def main(argv=None, model=None) -> int:
    """Run the demo; `model` (a `Splatt3RModel` on the device) skips
    loading one."""
    p = _parser()
    args = p.parse_args(argv)
    if not args.serve and not (args.image1 and args.image2):
        p.error("image1 and image2 are required unless --serve is given")

    from splatt3r_slam_tpu_torch import resolve_device, set_fp32_precision
    from splatt3r_slam_tpu_torch.runtime.webdemo import DemoEngine

    set_fp32_precision()
    device = resolve_device(args.device)
    engine = DemoEngine(_model(args, device, model), img_size=args.img_size,
                        device=device)
    if args.serve:
        return serve_web(engine, args)

    from splatt3r_slam_tpu_torch.parallel.export import save_as_ply
    from splatt3r_slam_tpu_torch.utils.image import write_png

    scene = engine.reconstruct_arrays([read_image(args.image1),
                                       read_image(args.image2)])
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    a = scene.ply_arrays
    save_as_ply(out_dir / "gaussians.ply", a["means"], a["scales"],
                a["rotations"], a["sh_residual"], a["opacities"])
    print(f"wrote {out_dir / 'gaussians.ply'} "
          f"({scene.means.shape[0]} gaussians)")

    frames = []
    for i in range(args.n_views):
        u8 = engine.render(2 * np.pi * i / args.n_views, 0.2)
        write_png(out_dir / f"view_{i:03d}.png", u8)
        frames.append(u8)
    try:  # best effort, as the JAX demo's: only where cv2 can encode
        import cv2

        h, w = scene.hw
        vw = cv2.VideoWriter(str(out_dir / "orbit.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 12, (w, h))
        for fimg in frames:
            vw.write(np.ascontiguousarray(fimg[..., ::-1]))
        vw.release()
    except Exception:
        pass
    print(f"wrote {args.n_views} orbit views under {out_dir}")
    return 0


def serve_web(engine, args) -> int:
    from splatt3r_slam_tpu_torch.runtime.webdemo import serve

    server = serve(engine, host=args.host, port=args.serve)
    print(f"web demo on http://{args.host}:{server.server_address[1]}/ "
          "(ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
