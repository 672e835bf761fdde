"""Shared pieces of the port's measurement entry points (`bench.py` and
`scripts/`): argument handling and device choice, the model at full width
or in its tiny form, seeded random weights, the synthetic frames, timing on
the device, and the card's name and power limit.

Each entry point runs on CUDA unless `--device cpu` is given, and asking
for CUDA without a GPU raises (`resolve_device`). None of them falls back
to the CPU: the JAX `bench.py` does when its accelerator probe fails, so
that a run whose remote chip is down still prints a line, but a line
measured on another device than the one asked for is a wrong number, not
a degraded one. The tiny 48x64 model is used only with `--device cpu` or
`--tiny`.
"""

from __future__ import annotations

import pathlib
import subprocess
import time

import numpy as np
import torch

FULL_HW = (384, 512)
TINY_HW = (48, 64)
ROOT = pathlib.Path(__file__).resolve().parents[2]
SLEEP_CYCLES = 3_000_000  # the device-side delay of `time_calls`, ~1.7 ms


def add_device_args(ap, tiny: bool = True) -> None:
    """`--device` and, unless `tiny` is False (a host tool with no tiny
    form), `--tiny`."""
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; asking for cuda "
                         "without a GPU raises; cpu implies --tiny)")
    if tiny:
        ap.add_argument("--tiny", action="store_true",
                        help="the tiny form: the fp32 model at 48x64, a "
                             "few thousand gaussians (CPU smoke runs)")


def setup(args):
    """TF32 off, the device, and whether the tiny form runs →
    (device, tiny)."""
    from splatt3r_slam_tpu_torch import resolve_device, set_fp32_precision

    set_fp32_precision()
    device = resolve_device(args.device)
    return device, bool(getattr(args, "tiny", False)
                        or device.type == "cpu")


def load_base_config() -> dict:
    """config/base.yaml of the checkout into the global config (its
    built-in copy where the file is absent)."""
    from splatt3r_slam_tpu_torch import config as cfgmod

    path = ROOT / "config" / "base.yaml"
    if path.exists():
        return cfgmod.load_config(str(path))
    return cfgmod.reset_config()


def model_config(tiny: bool, head_dtype: str | None = None):
    """TwoViewConfig(): ViT-L with bf16 trunk and heads; the tiny form is
    fp32. `head_dtype` overrides the heads' dtype at full width."""
    from splatt3r_slam_tpu_torch.models import TwoViewConfig

    if tiny:
        return TwoViewConfig(dtype="float32", head_dtype="float32").tiny()
    cfg = TwoViewConfig()
    return cfg._replace(head_dtype=head_dtype) if head_dtype else cfg


def hw(tiny: bool):
    return TINY_HW if tiny else FULL_HW


def make_model(cfg, device, model=None):
    """The caller's model, else seeded random weights (seed 0; LayerNorm
    scale 1, biases 0, every other weight normal / sqrt(fan_in), as
    `bench.py` fills them)."""
    from splatt3r_slam_tpu_torch.models import init_model

    if model is not None:
        return model
    return init_model(cfg, seed=0, device=device)


def panned_frames(n: int, h: int, w: int, seed: int = 0) -> list:
    """A panning sequence built as `bench.py` builds its own: uniform
    noise of (h + 200, w + 200), cropped 2 px down and 3 px across per
    frame, float32 in [0, 1]. The construction is the same, the pixels are
    not: `bench.py` draws its noise from the generator that filled its
    weights, this draws from a fresh one seeded with `seed`."""
    rng = np.random.default_rng(seed)
    base = rng.random((h + 200, w + 200, 3)).astype(np.float32)
    return [base[2 * i: 2 * i + h, 3 * i: 3 * i + w] for i in range(n)]


def sync(device) -> None:
    """End of a timed window: wait for the device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, device, iters: int):
    """One warm-up `fn()`, then `iters` calls back to back → (ms per call,
    the warm-up's output). On the card the calls are enqueued behind a
    device-side delay and timed by two CUDA events, so that the host can
    run ahead and the time is the device's (the JAX scripts' chained
    dispatch); where the host is slower than the device, the gaps between
    the calls count too. On the CPU a host clock ends in the last call."""
    out = fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3, out
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters, out


def kernel_profile(fn, device, iters: int = 2, top: int = 5):
    """The kernels of one `fn()` under torch.profiler, over `iters` calls →
    {"ms": their device time per call, "launches": kernel launches per
    call, "top": the `top` kernels by device time as [name, ms per call,
    launches per call]}. Unlike two CUDA events around the calls, the
    device time leaves out the time the card waits for the host. None on
    the CPU."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
    kernels = []
    for e in prof.key_averages():
        # the port's `port.*` spans appear on the device timeline too, as
        # ranges over their kernels: counting them would count those twice
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and not e.key.startswith("port."):
            v = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0) if v is None else v
            kernels.append((us / 1e3 / iters, e.count / iters, e.key))
    kernels.sort(reverse=True)
    return {"ms": sum(k[0] for k in kernels),
            "launches": sum(k[1] for k in kernels),
            "top": [[name[:80], round(ms, 3), n]
                    for ms, n, name in kernels[:top]]}


class LatePull:
    """Small device tensors brought to the host one step late: `push(t)`
    starts t's copy and returns the previous one's values (None the first
    time), so the host waits for step i-1 while step i runs. On the card
    the copy goes to pinned memory behind an event; a plain `.cpu()`
    would wait for everything queued after it too."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._pending = None

    def _start(self, t):
        if not self.cuda:
            return t.detach().numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _finish(self, p):
        if not self.cuda:
            return p
        host, ev = p
        ev.synchronize()
        return host.numpy()

    def push(self, t):
        prev, self._pending = self._pending, self._start(t)
        return None if prev is None else self._finish(prev)

    def flush(self):
        prev, self._pending = self._pending, None
        return None if prev is None else self._finish(prev)


def device_fields(device) -> dict:
    """{"device": name, "power_limit_w": W} of the card a CUDA run used,
    from `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    (torch's name for the card and no limit where nvidia-smi cannot
    say); {"device": "cpu", "power_limit_w": None} on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    name, limit = torch.cuda.get_device_name(dev), None
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        name, watts = (s.strip() for s in line.rsplit(",", 1))
        limit = float(watts.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"device": name, "power_limit_w": limit}
