"""Integration points: the flagship forward and the sharded dry run.

Counterpart of the repository's root `__graft_entry__.py`:

- `entry()`: (fn, args) for the two-view forward of the production model
  (`TwoViewConfig()`, ViT-L, at the 384x512 working resolution) with
  seeded random weights: LayerNorm scales 1, biases 0, every other weight
  normal / sqrt(fan_in), the JAX entry's rule (`init_weights`);
- `dryrun_multichip(n)`: ONE full-loss training step on an n-rank
  `(dp, fsdp, tp)` mesh (`parallel/dryrun.py`), its terms printed.

Both run on CUDA unless the caller passes device="cpu"; `dryrun_multichip`
needs one GPU per rank and raises otherwise. Nothing is retried and
nothing falls back to the CPU.
"""

from __future__ import annotations

H, W = 384, 512


def entry(device="cuda", cfg=None):
    """(fn, args): fn(img1, img2) → (res1, res2), the full two-view
    forward under no_grad; args two (1, 384, 512, 3) zero images."""
    import torch

    from splatt3r_slam_tpu_torch import resolve_device
    from splatt3r_slam_tpu_torch.models import TwoViewConfig, init_model

    dev = resolve_device(device)
    model = init_model(cfg or TwoViewConfig(), seed=0, device=dev)

    @torch.no_grad()
    def fn(img1, img2):
        return model(img1, img2)

    img = torch.zeros((1, H, W, 3), device=dev)
    return fn, (img, img)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run ONE sharded full-loss training step on an n-rank mesh: batch
    over dp × fsdp, parameters sharded over fsdp (FSDP2), transformer
    projections split over tp. Prints every term and returns the
    metrics."""
    from splatt3r_slam_tpu_torch.parallel.dryrun import full_loss_train_step

    m = full_loss_train_step(n_devices, device=device)
    print(f"dryrun_multichip({n_devices}): "
          f"loss {m['loss']:.4f} = mse {m['mse']:.4f}"
          f" + ssim {m['ssim']:.4f}"
          f" + lpips {m['lpips']:.4f}"
          f" + regr3d {m['regr3d']:.4f}"
          f" on mesh {m['mesh']}")
    return m
