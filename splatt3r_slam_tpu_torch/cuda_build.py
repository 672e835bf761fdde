"""Build and launch the port's hand-written CUDA kernels.

Every kernel of `csrc/` has a plain C entry point and is registered in
`KERNELS`; kernels whose entry points share a source share its library.
`build()` compiles each source with nvcc for sm_90a into a shared library
of its own, one nvcc per source, all started together, into
`splatt3r_slam_tpu_torch/_build/` (git-ignored). A library's name carries a
hash of its source, of every header beside it and of the compiler flags, so
an edit of any of them gives a new library. `launch` loads a library with
ctypes at its first use, calls the entry point on the current CUDA stream
and raises if the launch was refused. The wrappers that call `launch`
(`splat/cuda_rasterizer.py`, `models/flash_attention.py`) keep their own
launch counters and plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# kernel name → (source, C entry point, argument types before the stream)
KERNELS = {
    "composite": (_PKG / "csrc" / "composite.cu", "composite_launch",
                  [_P] * 5 + [_I] * 2),
    "composite_bwd": (_PKG / "csrc" / "composite_bwd.cu",
                      "composite_bwd_launch", [_P] * 6 + [_I] * 2),
    # q, k, v, out, the residuals l and m (or null); dtype, B, H, n_q,
    # n_kv, Dh; the (batch, row, head) strides of q, k, v and out in
    # elements; the softmax scale
    "flash_attention": (_PKG / "csrc" / "flash_attention.cu",
                        "flash_attention_launch",
                        [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F]),
    # q, k, v, do, m, l, di, dk, dv; dtype, B, H, n_q, n_kv, Dh; the
    # strides of q, k, v, do, dk and dv; the softmax scale
    "flash_attention_bwd_dkv": (_PKG / "csrc" / "flash_attention_bwd.cu",
                                "flash_attention_bwd_dkv_launch",
                                [_P] * 9 + [_I] * 6 + [_L] * 18 + [_F]),
    # q, k, v, do, m, l, di, dq; ...; the strides of q, k, v, do and dq
    "flash_attention_bwd_dq": (_PKG / "csrc" / "flash_attention_bwd.cu",
                               "flash_attention_bwd_dq_launch",
                               [_P] * 8 + [_I] * 6 + [_L] * 15 + [_F]),
}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_fns: dict = {}


def _nvcc() -> str:
    for c in (os.environ.get("NVCC"), shutil.which("nvcc"),
              "/usr/local/cuda/bin/nvcc"):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (needs the CUDA toolkit, sm_90a)")


def _digest(source: pathlib.Path, flags) -> str:
    """Hash of a source, of the headers beside it and of the flags."""
    h = hashlib.sha256()
    for p in (source, *sorted(source.parent.glob("*.cuh"))):
        h.update(p.read_bytes())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:12]


def build(names=None) -> dict:
    """Compile the sources of the kernels `names` (default: all of
    `KERNELS`), once per `_digest`, one nvcc a source, all started
    together → {name: (library, ptxas log)}."""
    names = list(KERNELS) if names is None else list(names)
    done, running = {}, []
    for source in dict.fromkeys(KERNELS[n][0] for n in names):
        so = BUILD_DIR / f"lib{source.stem}_{_digest(source, NVCC_FLAGS)}.so"
        log = so.with_suffix(".log")
        if so.exists():
            done[source] = (so, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((source, so, log, tmp, proc))
    for source, so, log, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{stderr}")
        log.write_text(stdout + stderr)
        os.replace(tmp, so)
        done[source] = (so, stdout + stderr)
    return {name: done[KERNELS[name][0]] for name in names}


def _entry(so, name: str):
    """The C entry point of kernel `name` in the library `so`."""
    _, entry, argtypes = KERNELS[name]
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, dev, *args):
    """Launch kernel `name` on `dev`'s current stream; raise if refused.
    The library is built if needed and its entry point resolved once."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _entry(build([name])[name][0], name)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
