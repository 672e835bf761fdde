"""PyTorch/CUDA port of splatt3r_slam_tpu for NVIDIA Hopper GPUs.

The JAX package `splatt3r_slam_tpu` is the reference; this package mirrors
its layout and names (lie/, geometry/, models/, ops/, tracking/, runtime/,
splat/, config.py) so each counterpart is easy to find. It imports torch,
never jax, and nothing of the JAX package.

Entry points take ``device=`` and default to ``"cuda"``; the CPU is used
only when asked for (the CPU tests do). Asking for CUDA where there is no
GPU raises instead of quietly running on the CPU. Each entry point calls
`set_fp32_precision` before it touches the device.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def set_fp32_precision() -> None:
    """Run fp32 matmuls and convolutions in full fp32: TF32 off for cuBLAS
    and cuDNN. PyTorch leaves cuDNN's TF32 on by default, which would run
    the fp32 DPT heads that `config/eval_*.yaml` ask for in TF32. Every
    entry point calls this first; the bf16 trunk is not affected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
