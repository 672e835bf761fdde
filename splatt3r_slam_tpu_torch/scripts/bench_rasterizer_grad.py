"""Validate and time the CUDA rasterizer's backward on the card.

    python -m splatt3r_slam_tpu_torch.scripts.bench_rasterizer_grad
        [--device cuda|cpu] [--tiny]

Counterpart of the repository's `scripts/bench_rasterizer_grad.py`, at its
production caps (400k gaussians of `bench_rasterizer.make_scene`, k_max
512, 384x512). The loss is the mean squared error of the render against a
seeded random target (the trainer's photometric term). Its value and the
gradients in means, cov_triu, colors and opacities go through
`render_tiles_cuda` (the `Composite` autograd Function: forward kernel
`csrc/composite.cu`, backward kernel `csrc/composite_bwd.cu`) and through
torch autograd over the plain renderer `rasterizer.render_tiles` (the JAX
script's XLA autodiff, hence the key `grad_vs_xla_autodiff`); both are
timed (`value_and_grad_ms`), and so are the two forwards alone
(`forward_ms`). Then central differences through the CUDA forward, at the
coordinate of each parameter's largest gradient (`fd_probe_cuda`), check
the backward on its own.

The gate, as in the JAX script: every gradient finite, each within 1% of
its column's largest plain gradient, and each finite-difference relative
error below 0.10 (`backward_validated_on_hardware`). Both renderers are
fp32 here; the JAX script's XLA column composited in bf16.

Runs on CUDA unless `--device cpu` is given and raises without a GPU;
`--tiny` (implied on the CPU) takes 4,000 gaussians at 64x96. The last line
of stdout is the result as JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from splatt3r_slam_tpu_torch.scripts.bench_rasterizer import (
    HW,
    TINY_HW,
    scene_tensors,
)

K_MAX = 512
G = 400_000
TINY_G = 4_000
NAMES = ("means", "cov_triu", "colors", "opacities")


def loss_with(render, view, K, target, hw):
    """→ loss(means, cov, colors, opa): the render's MSE against target."""
    def loss(means, cov, colors, opa):
        img = render(means, cov, colors, opa, view, K, hw, tpg_side=4,
                     k_max=K_MAX)
        return torch.mean((img - target) ** 2)

    return loss


def value_and_grad(loss, arrays):
    """→ (loss value, gradients of the four parameter arrays)."""
    leaves = [a.detach().requires_grad_() for a in arrays]
    value = loss(*leaves)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), grads


def grad_gate(grads, fd_rows) -> bool:
    """The JAX script's validation gate."""
    return bool(
        all(g["finite"] for g in grads.values())
        and all(g["max_rel_diff_vs_peak"] < 0.01 for g in grads.values())
        and all(r["rel_err"] < 0.10 for r in fd_rows))


def compare_grads(got, want) -> dict:
    """Per parameter: the plain gradient's peak, the largest difference,
    that over the peak, and whether `got` is finite."""
    out = {}
    for name, a, b in zip(NAMES, got, want):
        a = a.detach().double().cpu().numpy()
        b = b.detach().double().cpu().numpy()
        scale = np.abs(b).max() + 1e-30
        diff = np.abs(a - b)
        out[name] = {
            "max_abs_plain": float(np.abs(b).max()),
            "max_abs_diff": float(diff.max()),
            "max_rel_diff_vs_peak": float(diff.max() / scale),
            "finite": bool(np.isfinite(a).all()),
        }
    return out


def fd_probe(loss, arrays, grads) -> list:
    """Central differences of `loss` (no graph) at the coordinate of each
    parameter's largest gradient: a step small against the value's scale
    (covariance entries are ~1e-4 and must stay positive definite), yet
    large against the fp32 loss's rounding."""
    rows = []
    for pi, name in enumerate(NAMES):
        g_np = grads[pi].detach().cpu().numpy()
        coord = np.unravel_index(int(np.abs(g_np).argmax()), g_np.shape)
        x0 = float(arrays[pi][coord])
        eps = {"cov_triu": 1e-5}.get(name, 1e-3)

        def at(v):
            a = list(arrays)
            a[pi] = arrays[pi].clone()
            a[pi][coord] = v
            with torch.no_grad():
                return float(loss(*a))

        fd = (at(x0 + eps) - at(x0 - eps)) / (2 * eps)
        an = float(g_np[coord])
        rows.append({"param": name, "coord": [int(c) for c in coord],
                     "fd": fd, "analytic": an,
                     "rel_err": abs(fd - an) / (abs(fd) + 1e-12)})
    return rows


def main(argv=None) -> dict:
    """Run the validation; returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm
    from splatt3r_slam_tpu_torch.splat.cuda_rasterizer import (
        render_tiles_cuda,
    )
    from splatt3r_slam_tpu_torch.splat.rasterizer import render_tiles

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts."
             "bench_rasterizer_grad",
        description=__doc__.split("\n")[0])
    cm.add_device_args(ap)
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)
    hw, g = (TINY_HW, TINY_G) if tiny else (HW, G)

    means, cov, colors, opa, view, K = scene_tensors(g, device, hw=hw)
    arrays = [means, cov, colors, opa]
    rng = np.random.default_rng(3)
    target = torch.from_numpy(
        rng.random((*hw, 3)).astype(np.float32)).to(device)
    loss_plain = loss_with(render_tiles, view, K, target, hw)
    loss_cuda = loss_with(render_tiles_cuda, view, K, target, hw)

    out = {"gaussians": g, "hw": list(hw), "k_max": K_MAX,
           **cm.device_fields(device)}
    ms_p, (lp, gp) = cm.time_calls(lambda: value_and_grad(loss_plain,
                                                          arrays),
                                   device, 10)
    ms_c, (lc, gc) = cm.time_calls(lambda: value_and_grad(loss_cuda,
                                                          arrays),
                                   device, 10)
    out["value_and_grad_ms"] = {"plain": round(ms_p, 2),
                                "cuda": round(ms_c, 2)}
    lp, lc = float(lp), float(lc)
    out["loss"] = {"plain": lp, "cuda": lc,
                   "rel_diff": abs(lp - lc) / (abs(lp) + 1e-12)}
    grads = compare_grads(gc, gp)
    out["grad_vs_xla_autodiff"] = grads

    with torch.no_grad():
        msf_p, _ = cm.time_calls(lambda: loss_plain(*arrays), device, 10)
        msf_c, _ = cm.time_calls(lambda: loss_cuda(*arrays), device, 10)
    out["forward_ms"] = {"plain": round(msf_p, 2), "cuda": round(msf_c, 2)}

    fd_rows = fd_probe(loss_cuda, arrays, gc)
    out["fd_probe_cuda"] = fd_rows
    out["backward_validated_on_hardware"] = grad_gate(grads, fd_rows)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
