"""Flash attention, forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of `splatt3r_slam_tpu/models/layers.py::_attend_flash`, which
calls JAX's bundled Pallas TPU flash attention (non-causal, no bias, no
segment ids). The kernel `csrc/flash_attention.cu` replaces that TPU kernel
(`_flash_attention_kernel`); the note at the top of the source says what
bounds it on the card and how the design answers. Built and launched
through `cuda_build` (nvcc for sm_90a, ctypes).

- `flash_attention_torch(q, k, v, scale)`: the plain version, the TPU
  kernel's algorithm step by step: kv blocks of 128 rows (its default
  `BlockSizes`), s = q·kᵀ in fp32 and then times the scale, an online
  softmax with running max and sum, p rounded to v's dtype before p·v,
  which is summed in fp32, and the fp32 accumulator renormalised by
  l_corr / l_next at every block; the output rounded to v's dtype.
- `flash_attention(q, k, v, scale)`: the kernel for CUDA tensors (it
  launches or raises), the plain version for CPU tensors; no fallback from
  one to the other. `launches` counts kernel launches.
- `FlashAttention`: the `torch.autograd.Function` that `models/layers.py::
  attend` calls. Its backward raises: the TPU package's two backward
  kernels are still to be ported (ROADMAP Queue 2).

Tensors are (B, N, H, Dh), the JAX layout; k and v share their N, which
may differ from q's (cross-attention). The kernel takes Dh in
`HEAD_DIMS`, q, k and v of one dtype (bf16 or fp32), n_q and n_kv
multiples of 64, Dh contiguous and every row 16-byte aligned; a strided
view (v straight from the fused qkv projection) is read in place.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from splatt3r_slam_tpu_torch import cuda_build

BLOCK_K = 128  # the TPU kernel's kv block (BlockSizes.get_default)
HEAD_DIMS = (64, 128, 192, 256)  # the kernel's template instances
ROWS = 64  # n_q and n_kv must be multiples of this
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
BACKWARD_TODO = (
    "flash attention has no backward kernel yet: the TPU package's "
    "_flash_attention_bwd_dkv and _flash_attention_bwd_dq are still to be "
    "ported (ROADMAP Queue 2, the flash backward slice); train with "
    "--flash-attention auto or off")

launches = 0  # kernel launches made by `flash_attention`


def flash_attention_torch(q, k, v, scale, block_k: int = BLOCK_K):
    """Plain PyTorch version of the kernel: (B, n_q, H, D) q and (B, n_kv,
    H, D) k, v → (B, n_q, H, D) in v's dtype, the TPU kernel's steps."""
    qf = q.transpose(1, 2).float()  # (B, H, n_q, D)
    kf = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    B, H, n_q, D = qf.shape
    m = torch.full((B, H, n_q, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, H, n_q, 1), device=q.device)
    acc = torch.zeros((B, H, n_q, D), device=q.device)
    for s0 in range(0, kf.shape[2], block_k):
        # bf16 products are exact in fp32: the widened inputs give the
        # kernel's fp32 sums
        s = torch.matmul(qf, kf[:, :, s0:s0 + block_k].transpose(-1, -2))
        s = s * scale
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0, torch.ones_like(l_next), 1.0 / l_next)
        acc = acc * (l_corr * inv)
        o_curr = torch.matmul(p.to(v.dtype).float(),
                              vt[:, :, s0:s0 + block_k].float())
        acc = acc + o_curr * inv
        m, l = m_next, l_next
    return acc.to(v.dtype).transpose(1, 2).contiguous()


def _check(q, k, v):
    """Raise unless the kernel takes q, k, v (checked on the CPU too, so
    that a shape refused on the card is refused here)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if isinstance(t, DTensor):
            raise TypeError(f"flash_attention: {name} is a DTensor; the "
                            "kernel takes plain local tensors")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, N, H, "
                             f"Dh), got shape {tuple(t.shape)}")
    B, n_q, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"flash_attention: k and v must be (B, n_kv, H, "
                         f"Dh) with q's B, H and Dh; got q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: q, k and v must share one dtype "
                         f"of bfloat16 or float32, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    if n_q % ROWS or k.shape[1] % ROWS or n_q == 0 or k.shape[1] == 0:
        raise ValueError(f"flash_attention: n_q {n_q} and n_kv "
                         f"{k.shape[1]} must be positive multiples of {ROWS}")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention: q, k and v on {q.device}, "
                         f"{k.device}, {v.device}")


def _strides(who, t):
    """(batch, row, head) strides of `t` in elements; raise unless Dh is
    contiguous and every row starts 16 bytes aligned."""
    per = 16 // t.element_size()
    s = t.stride()
    if s[3] != 1 or t.data_ptr() % 16 or any(x % per for x in s[:3]):
        raise ValueError(f"flash_attention: {who} needs a contiguous last "
                         f"dim and 16-byte aligned rows, got strides {s} "
                         f"at offset {t.storage_offset()}")
    return s[0], s[1], s[2]


def flash_attention(q, k, v, scale):
    """Softmax attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. (B, n_q, H, Dh) q, (B, n_kv, H, Dh) k and v
    → (B, n_q, H, Dh) in v's dtype, with no graph (`FlashAttention` is the
    autograd form)."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_torch(q, k, v, scale)
    B, n_q, H, D = q.shape
    out = torch.empty((B, n_q, H, D), dtype=v.dtype, device=q.device)
    cuda_build.launch(
        "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], B, H, n_q,
        k.shape[1], D, *_strides("q", q), *_strides("k", k),
        *_strides("v", v), *_strides("out", out), float(scale))
    global launches
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """`flash_attention` under autograd: forward only. The backward raises
    NotImplementedError (no backward kernel yet) rather than differentiate
    through another attention."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        return flash_attention(q, k, v, scale)

    @staticmethod
    def backward(ctx, gout):
        raise NotImplementedError(BACKWARD_TODO)
