"""Micro-benchmark: the two views' heads one after the other, or batched.

    python -m splatt3r_slam_tpu_torch.scripts.bench_heads_batched [MODE]
        [--device cuda|cpu] [--tiny]

Counterpart of the repository's `scripts/bench_heads_batched.py`. The
fused tracking step applies two `GaussianHead`s (view 1 and view 2,
distinct weights) to same-shaped hook tokens, one after the other; most of
their convolutions run on a single image at 24x32 to 192x256. This times
that (`seq_ms`) against the same two heads vectorised over their stacked
parameters (`batched_ms`): `torch.func.stack_module_state` and
`functional_call` under `torch.vmap`, the counterpart of the JAX script's
`vmap` over stacked params, which turns each layer's two convolutions into
one grouped convolution. The stacking is done once, outside the timed
calls, as a production design would do it at load time.

MODE is the head's mode ("tracking" by default; "full" or
"gaussian_only"); the image is BENCH_H x BENCH_W (default 384x512). The
heads are bf16 at full width with seeded random weights (seeds 0 and 1),
the tiny fp32 widths with `--tiny` (implied on the CPU, at 48x64 unless
BENCH_H/BENCH_W say otherwise). Each timing is 30 calls after a warm-up
(`_common.time_calls`: device time on the card). `max_abs_diff` is the
largest difference of the batched result from the sequential one (pts3d,
or scales for "gaussian_only"), `max_abs` the sequential one's peak. Runs
on CUDA unless `--device cpu` is given and raises without a GPU. The last
line of stdout is the result as JSON.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch


def make_head(cfg, seed, device):
    """A `GaussianHead` of the model config's widths, in the heads' dtype,
    with seeded random weights."""
    from splatt3r_slam_tpu_torch.models.heads import GaussianHead
    from splatt3r_slam_tpu_torch.models.two_view import init_weights

    head = GaussianHead(
        cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.local_feat_dim,
        cfg.patch_size, cfg.sh_degree, cfg.use_offsets, cfg.head_dtype,
        feature_dim=cfg.head_feature_dim, layer_dims=cfg.head_layer_dims,
        last_dim=cfg.head_last_dim).to(device)
    return init_weights(head, seed).eval().requires_grad_(False)


def hooks(seed, n, dims, device):
    """Seeded hook tokens [enc_out, dec6, dec9, dec12], each (1, n, c)."""
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=(1, n, c)).astype(np.float32)
                             * np.float32(0.1)).to(device) for c in dims]


def _key(out: dict) -> str:
    return "pts3d" if "pts3d" in out else "scales"


def seq_and_batched(head1, head2, hw, mode):
    """→ (seq(hk1, hk2) → (r1, r2), batched(hks) → (2, ...), stacked
    hooks maker): the two heads applied one after the other, and vmapped
    over their parameters stacked once here."""
    from torch.func import functional_call, stack_module_state, vmap

    params, buffers = stack_module_state([head1, head2])
    base = copy.deepcopy(head1).to("meta")

    def seq(hk1, hk2):
        r1, r2 = head1(hk1, hw, mode), head2(hk2, hw, mode)
        return r1[_key(r1)], r2[_key(r2)]

    def one(p, b, hk):
        out = functional_call(base, (p, b), (hk, hw, mode))
        return out[_key(out)]

    batched_fn = vmap(one)

    def batched(hks):
        return batched_fn(params, buffers, hks)

    def stack(hk1, hk2):
        return [torch.stack([a, b]) for a, b in zip(hk1, hk2)]

    return seq, batched, stack


def main(argv=None) -> dict:
    """Run the benchmark; returns the printed result."""
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.bench_heads_batched",
        description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="tracking")
    cm.add_device_args(ap)
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)
    cfg = cm.model_config(tiny)
    dh, dw = cm.hw(tiny)
    h = int(os.environ.get("BENCH_H", dh))
    w = int(os.environ.get("BENCH_W", dw))
    p = cfg.patch_size
    n = (h // p) * (w // p)
    dims = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3

    head1, head2 = make_head(cfg, 0, device), make_head(cfg, 1, device)
    hk1, hk2 = hooks(1, n, dims, device), hooks(2, n, dims, device)
    seq, batched, stack = seq_and_batched(head1, head2, (h, w), args.mode)
    hks = stack(hk1, hk2)

    with torch.no_grad():
        t_seq, (r1, r2) = cm.time_calls(lambda: seq(hk1, hk2), device, 30)
        t_bat, rb = cm.time_calls(lambda: batched(hks), device, 30)
    d1 = float((rb[0] - r1).abs().max())
    d2 = float((rb[1] - r2).abs().max())
    out = {
        "mode": args.mode,
        "hw": [h, w],
        "seq_ms": round(t_seq, 3),
        "batched_ms": round(t_bat, 3),
        "speedup": round(t_seq / t_bat, 3),
        "max_abs_diff": max(d1, d2),
        "max_abs": max(float(r1.abs().max()), float(r2.abs().max())),
        **cm.device_fields(device),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
