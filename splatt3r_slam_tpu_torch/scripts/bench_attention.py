"""Microbenchmark: einsum-softmax attention, the port's flash-attention
kernel and PyTorch's fused SDPA.

    python -m splatt3r_slam_tpu_torch.scripts.bench_attention
        [--device cuda|cpu] [--tiny]

Counterpart of the repository's `scripts/bench_attention.py`. The two-view
ViT runs ~72 attention ops per tracked frame (24 encoder + 2x12 decoder
blocks, self and cross); at 512x384 each is N = 768 tokens of head dim 64
in bf16. The JAX script weighs the JAX package's einsum path
(`models/layers.py::_attend`: fp32 logits and softmax, the fp32 score
tensor round-tripping through memory) against the Pallas TPU flash kernel
that `_attend_flash` reaches (`flash_ms_b*`, at three block sizes). Here
the einsum path is written in plain torch (`attend_einsum`, `einsum_ms`);
the port's hand-written flash kernel (`models/flash_attention.py`, one
tiling) is `flash_ms`, with `flash_max_abs_diff` its largest difference
from `attend_einsum` (it rounds the unnormalised p to bf16 where the
einsum path rounds the normalised weights, so the two differ by up to
about one bf16 ulp of the output's peak); the library's yardstick is the
SDPA call that `attend` makes outside the flash path (`attend_sdpa`,
`sdpa_ms`), and the same under `torch.nn.attention.sdpa_kernel` with each
backend in turn (`sdpa_flash_ms`, `sdpa_efficient_ms`, `sdpa_cudnn_ms`,
`sdpa_math_ms`). A backend that refuses the shape is printed as "FAIL
...", as the JAX script prints a failing flash configuration.
`max_abs_diff` is |einsum - sdpa| on the shape's inputs (seeded normal,
bf16).

Each timing is 30 calls after 3 warm-ups (`_common.time_calls`: device
time on the card). Runs on CUDA unless `--device cpu` is given and raises
without a GPU; `--tiny` (implied on the CPU) takes N = 64 tokens, where
`flash_ms` times the kernel's plain version (`flash_attention` takes it
for CPU tensors). The last line of stdout is the result as JSON:
{"results": {shape: row}, "device", "power_limit_w"}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

# (label, B, N_q, N_kv, H, Dh): encoder self-attention (two views batched),
# decoder self and cross (two streams batched)
SHAPES = (
    ("enc_self B2 N768 H16", 2, 768, 768, 16, 64),
    ("dec_self B2 N768 H12", 2, 768, 768, 12, 64),
    ("dec_cross B2 N768 H12", 2, 768, 768, 12, 64),
)
TINY_N = 64
BACKENDS = ("flash", "efficient", "cudnn", "math")


def attend_einsum(q, k, v, scale):
    """The JAX package's `_attend` einsum path on (B, N, H, D): logits and
    softmax in fp32 (bf16 products are exact in fp32, so the inputs are
    widened and the sums taken in fp32, as `preferred_element_type`
    asks), the weights rounded to v's dtype, the second product summed in
    fp32 and rounded to v's dtype."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    w = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _sdpa_backend(name):
    from torch.nn.attention import SDPBackend

    return {"flash": SDPBackend.FLASH_ATTENTION,
            "efficient": SDPBackend.EFFICIENT_ATTENTION,
            "cudnn": SDPBackend.CUDNN_ATTENTION,
            "math": SDPBackend.MATH}[name]


def main(argv=None) -> dict:
    """Run the benchmark; returns the printed result."""
    from torch.nn.attention import sdpa_kernel

    from splatt3r_slam_tpu_torch.models.flash_attention import (
        flash_attention,
    )
    from splatt3r_slam_tpu_torch.models.layers import attend_sdpa
    from splatt3r_slam_tpu_torch.scripts import _common as cm

    ap = argparse.ArgumentParser(
        prog="python -m splatt3r_slam_tpu_torch.scripts.bench_attention",
        description=__doc__.split("\n")[0])
    cm.add_device_args(ap)
    args = ap.parse_args(argv)
    device, tiny = cm.setup(args)

    def timeit(fn, q, k, v):
        for _ in range(2):  # time_calls adds the third warm-up
            fn(q, k, v)
        return round(cm.time_calls(lambda: fn(q, k, v), device, 30)[0], 4)

    rng = np.random.default_rng(0)
    results = {}
    for label, b, nq, nk, h, dh in SHAPES:
        if tiny:
            nq = nk = TINY_N
        q, k, v = (torch.from_numpy(
            rng.standard_normal((b, n, h, dh)).astype(np.float32)).to(
            device, torch.bfloat16) for n in (nq, nk, nk))
        scale = dh ** -0.5
        with torch.no_grad():
            row = {"einsum_ms": timeit(
                lambda q, k, v: attend_einsum(q, k, v, scale), q, k, v),
                "flash_ms": timeit(
                    lambda q, k, v: flash_attention(q, k, v, scale), q, k,
                    v),
                "sdpa_ms": timeit(
                    lambda q, k, v: attend_sdpa(q, k, v, scale), q, k, v)}
            for name in BACKENDS:
                key = f"sdpa_{name}_ms"
                try:
                    with sdpa_kernel(_sdpa_backend(name)):
                        row[key] = timeit(
                            lambda q, k, v: attend_sdpa(q, k, v, scale), q,
                            k, v)
                except RuntimeError as e:  # the backend refuses the shape
                    row[key] = f"FAIL {type(e).__name__}: {e}"[:120]
            a = attend_einsum(q, k, v, scale).float()
            row["max_abs_diff"] = float(
                (a - attend_sdpa(q, k, v, scale).float()).abs().max())
            row["flash_max_abs_diff"] = float(
                (a - flash_attention(q, k, v, scale).float()).abs().max())
        results[label] = row
        print(label, row, flush=True)
    out = {"results": results, **cm.device_fields(device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
