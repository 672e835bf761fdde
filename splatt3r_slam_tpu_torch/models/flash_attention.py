"""Flash attention: the hand-written CUDA kernels, forward and backward,
and their plain PyTorch versions.

Counterpart of `splatt3r_slam_tpu/models/layers.py::_attend_flash`, which
calls JAX's bundled Pallas TPU flash attention (non-causal, no bias, no
segment ids) and, under `jax.grad`, its custom VJP. The kernel
`csrc/flash_attention.cu` replaces the TPU's forward kernel
(`_flash_attention_kernel`); `csrc/flash_attention_bwd.cu` replaces its two
backward kernels (`_flash_attention_dkv_kernel`, `_flash_attention_dq_kernel`).
All three kernels run on the tensor cores in both dtypes: bf16 as it is,
fp32 in split TF32 (each product three TF32 products summed in fp32, so
that an fp32 model keeps fp32's accuracy). The notes at the top of the
sources say what bounds each on the card and how the design answers.
Built and launched through `cuda_build` (nvcc for sm_90a, ctypes).

- `flash_attention_torch(q, k, v, scale)`: the plain forward, the TPU
  kernel's algorithm step by step: kv blocks of 128 rows (its default
  `BlockSizes`), s = q·kᵀ in fp32 and then times the scale, an online
  softmax with running max and sum, p rounded to v's dtype before p·v,
  which is summed in fp32, and the fp32 accumulator renormalised by
  l_corr / l_next at every block; the output rounded to v's dtype. With
  `residuals` it also returns the running sum l and max m after the last
  block, (B, H, n_q) fp32, as the TPU kernel's `save_residuals` does.
- `flash_attention_bwd_torch(q, k, v, o, l, m, do, scale)`: the plain
  backward, the two TPU backward kernels' steps over 128 x 128 blocks (their
  default `BlockSizes`): di = Σ o·do in fp32, p = exp(s - m)·(1/l),
  dv += p_bf16ᵀ·do, dp = do·vᵀ, ds = (dp - di)·p·scale, dk += ds_bf16ᵀ·q,
  dq += ds_bf16·k, the sums in fp32 and each gradient rounded once to its
  input's dtype.
- `flash_attention(q, k, v, scale, residuals=False)` and
  `flash_attention_bwd(q, k, v, o, l, m, do, scale)`: the kernels for CUDA
  tensors (they launch or raise), the plain versions for CPU tensors; no
  fallback from one to the other. `launches` counts forward kernel
  launches; `bwd_launches` counts backward calls that launched the pair
  (the dK/dV kernel, then the dQ kernel); `wide_launches` and
  `wide_bwd_launches` count those of them at a head dim of the wide
  kernels (below).
- `flash_head_dim_ok(dh)`: the TPU kernel's own head-dim rule, which
  `models/layers.py::attend` applies before it picks the kernel.
- `FlashAttention`: the `torch.autograd.Function` that `models/layers.py::
  attend` calls. Its forward asks for l and m only when autograd records
  the call for an input that requires grad (`ctx.needs_input_grad`); its
  backward is `flash_attention_bwd`.

Tensors are (B, N, H, Dh), the JAX layout; k and v share their N, which
may differ from q's (cross-attention). The kernels take Dh 64, 128 and
256 (`HEAD_DIMS`, a template instance each) and every multiple of 128
from 384 up (one wide kernel a dtype and role, the head dim at run time:
the bf16 backward streams the contraction over Dh in chunks of 64
columns; the forward in both dtypes and the fp32 backward split it over a
thread-block cluster of 128-column slices and add the slices' partials
once); a head
dim of 128 or more that is no multiple of 128 is refused with the TPU
kernel's NotImplementedError, as `_attend_flash` refuses it. They take q,
k and v of one dtype (bf16 or fp32), n_q and n_kv multiples of 64, Dh
contiguous and every row 16-byte aligned; a strided view (v straight from
the fused qkv projection) is read in place, forward and backward. The
backward makes its cotangent contiguous once (a no-op for the cotangent
autograd hands over from the output projection).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from splatt3r_slam_tpu_torch import cuda_build

BLOCK_K = 128  # the TPU kernels' blocks (BlockSizes.get_default)
MIN_BLOCK_SIZE = 128  # the TPU kernel's lane width (flash_attention.py:321)
HEAD_DIMS = (64, 128, 256)  # the kernels' template instances
WIDE_MIN = 384  # the wide kernels take every multiple of 128 from here
ROWS = 64  # n_q and n_kv must be multiples of this
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

launches = 0  # forward kernel launches made by `flash_attention`
bwd_launches = 0  # backward kernel pairs launched by `flash_attention_bwd`
wide_launches = 0  # of `launches`, those at a wide kernel's head dim
wide_bwd_launches = 0  # of `bwd_launches`, the same


def flash_head_dim_ok(dh: int) -> bool:
    """The head dims the TPU kernel takes: below its lane width, or a
    multiple of it. `_flash_attention_kernel_single_batch` (JAX's
    jax/experimental/pallas/ops/tpu/flash_attention.py:455-463, JAX 0.9.0)
    raises NotImplementedError for any other, and the JAX package's
    `_attend` then takes its einsum path."""
    return dh < MIN_BLOCK_SIZE or dh % MIN_BLOCK_SIZE == 0


def head_dim_refused(dh: int) -> str:
    """The TPU kernel's words for a head dim it refuses."""
    return f"head_dim={dh} should be a multiple of {MIN_BLOCK_SIZE} if larger"


def wide_head_dim(dh: int) -> bool:
    """Whether head dim `dh` runs on the wide kernels (no template
    instance): a multiple of 128 from 384 up."""
    return dh >= WIDE_MIN and dh % MIN_BLOCK_SIZE == 0


def _heads_first(t):
    """(B, N, H, D) → (B, H, N, D) in fp32."""
    return t.transpose(1, 2).float()


def flash_attention_torch(q, k, v, scale, block_k: int = BLOCK_K,
                          residuals: bool = False):
    """Plain PyTorch version of the forward kernel: (B, n_q, H, D) q and
    (B, n_kv, H, D) k, v → (B, n_q, H, D) in v's dtype, the TPU kernel's
    steps; with `residuals` → (out, l, m), l and m (B, H, n_q) fp32."""
    qf, kf, vt = _heads_first(q), _heads_first(k), v.transpose(1, 2)
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
    out = acc.to(v.dtype).transpose(1, 2).contiguous()
    if not residuals:
        return out
    return out, l[..., 0].contiguous(), m[..., 0].contiguous()


def _di(o, do):
    """di = Σ o·do over Dh in fp32, (B, H, n_q): the TPU backward computes
    it in XLA before its kernels, and so does the wrapper."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_torch(q, k, v, o, l, m, do, scale,
                              block: int = BLOCK_K):
    """Plain PyTorch version of the two backward kernels: (q, k, v) of the
    forward, its output o and residuals l, m ((B, H, n_q) fp32), the
    cotangent do of o → (dq, dk, dv) in the inputs' dtype, the TPU kernels'
    steps over `block` x `block` blocks."""
    dt = q.dtype
    qf, kf, vf, dof = (_heads_first(t) for t in (q, k, v, do))
    di = _di(o, do)[..., None]
    inv_l = (1 / l)[..., None]
    m = m[..., None]
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    n_q, n_kv = qf.shape[2], kf.shape[2]
    for k0 in range(0, n_kv, block):
        ks, vs = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        for q0 in range(0, n_q, block):
            rows = slice(q0, q0 + block)
            s = torch.matmul(qf[:, :, rows], ks.transpose(-1, -2)) * scale
            p = torch.exp(s - m[:, :, rows]) * inv_l[:, :, rows]
            dv[:, :, k0:k0 + block] += torch.matmul(
                p.to(dt).float().transpose(-1, -2), dof[:, :, rows])
            dp = torch.matmul(dof[:, :, rows], vs.transpose(-1, -2))
            ds = (dp - di[:, :, rows]) * p * scale
            ds = ds.to(dt).float()
            dk[:, :, k0:k0 + block] += torch.matmul(ds.transpose(-1, -2),
                                                    qf[:, :, rows])
            dq[:, :, rows] += torch.matmul(ds, ks)
    return tuple(g.to(dt).transpose(1, 2).contiguous() for g in (dq, dk, dv))


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
    if not flash_head_dim_ok(D):
        raise NotImplementedError(head_dim_refused(D))
    if D not in HEAD_DIMS and not wide_head_dim(D):
        raise ValueError(f"flash_attention: head dim {D} is not one the "
                         f"kernels are built for: {HEAD_DIMS} or a multiple "
                         f"of {MIN_BLOCK_SIZE} from {WIDE_MIN} up")
    if n_q % ROWS or k.shape[1] % ROWS or n_q == 0 or k.shape[1] == 0:
        raise ValueError(f"flash_attention: n_q {n_q} and n_kv "
                         f"{k.shape[1]} must be positive multiples of {ROWS}")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention: q, k and v on {q.device}, "
                         f"{k.device}, {v.device}")


def _check_bwd(q, o, l, m, do):
    """Raise unless the backward kernels take the forward's output o, its
    residuals l and m and the cotangent do (beside `_check` of q, k, v)."""
    for name, t in (("o", o), ("l", l), ("m", m), ("do", do)):
        if isinstance(t, DTensor):
            raise TypeError(f"flash_attention backward: {name} is a "
                            "DTensor; the kernels take plain local tensors")
        if t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} on "
                             f"{t.device}, q on {q.device}")
    B, n_q, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or \
            not o.dtype == do.dtype == q.dtype:
        raise ValueError(f"flash_attention backward: o and do must be q's "
                         f"shape and dtype {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}")
    for name, t in (("l", l), ("m", m)):
        if t.shape != (B, H, n_q) or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"contiguous fp32 {(B, H, n_q)}, got "
                             f"{tuple(t.shape)} {t.dtype}")


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


def flash_attention(q, k, v, scale, residuals: bool = False):
    """Softmax attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. (B, n_q, H, Dh) q, (B, n_kv, H, Dh) k and v
    → (B, n_q, H, Dh) in v's dtype, with no graph (`FlashAttention` is the
    autograd form); with `residuals` → (out, l, m), l and m (B, H, n_q)
    fp32 for `flash_attention_bwd`."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_torch(q, k, v, scale, residuals=residuals)
    B, n_q, H, D = q.shape
    out = torch.empty((B, n_q, H, D), dtype=v.dtype, device=q.device)
    l = m = None
    if residuals:
        l, m = (torch.empty((B, H, n_q), dtype=torch.float32,
                            device=q.device) for _ in range(2))
    cuda_build.launch(
        "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), 0 if l is None else l.data_ptr(),
        0 if m is None else m.data_ptr(), _DTYPE_CODE[q.dtype], B, H, n_q,
        k.shape[1], D, *_strides("q", q), *_strides("k", k),
        *_strides("v", v), *_strides("out", out), float(scale))
    global launches, wide_launches
    launches += 1
    if wide_head_dim(D):
        wide_launches += 1
    return (out, l, m) if residuals else out


def flash_attention_bwd(q, k, v, o, l, m, do, scale):
    """Gradient of `flash_attention`: the two CUDA kernels for CUDA tensors
    (dK/dV, then dQ), the plain version for CPU tensors. q, k, v as the
    forward took them, its output o and residuals l, m, the cotangent do
    (B, n_q, H, Dh) → (dq, dk, dv) in the inputs' dtype."""
    _check(q, k, v)
    _check_bwd(q, o, l, m, do)
    if not q.is_cuda:
        return flash_attention_bwd_torch(q, k, v, o, l, m, do, scale)
    do = do.contiguous()
    di = _di(o, do)
    dk, dv = _launch_dkv(q, k, v, do, m, l, di, scale)
    dq = _launch_dq(q, k, v, do, m, l, di, scale)
    global bwd_launches, wide_bwd_launches
    bwd_launches += 1
    if wide_head_dim(q.shape[3]):
        wide_bwd_launches += 1
    return dq, dk, dv


def _bwd_args(q, k, v, do, m, l, di):
    """The arguments both backward kernels take before their outputs, and
    those between their outputs and the outputs' strides."""
    B, n_q, H, D = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             m.data_ptr(), l.data_ptr(), di.data_ptr()),
            (_DTYPE_CODE[q.dtype], B, H, n_q, k.shape[1], D,
             *_strides("q", q), *_strides("k", k), *_strides("v", v),
             *_strides("do", do)))


def _launch_dkv(q, k, v, do, m, l, di, scale):
    """The dK/dV kernel alone on checked CUDA tensors → (dk, dv). The launch
    of `flash_attention_bwd`; `chip_smoke.py` also times it alone."""
    head, tail = _bwd_args(q, k, v, do, m, l, di)
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    cuda_build.launch("flash_attention_bwd_dkv", q.device, *head,
                      dk.data_ptr(), dv.data_ptr(), *tail,
                      *_strides("dk", dk), *_strides("dv", dv),
                      float(scale))
    return dk, dv


def _launch_dq(q, k, v, do, m, l, di, scale):
    """The dQ kernel alone on checked CUDA tensors → dq (as `_launch_dkv`)."""
    head, tail = _bwd_args(q, k, v, do, m, l, di)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    cuda_build.launch("flash_attention_bwd_dq", q.device, *head,
                      dq.data_ptr(), *tail, *_strides("dq", dq),
                      float(scale))
    return dq


class FlashAttention(torch.autograd.Function):
    """`flash_attention` under autograd: the forward kernel, and the two
    backward kernels for the gradient. The forward asks for the residuals
    l and m, and saves q, k, v, the output, l and m, only when autograd
    records the call for an input that requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, scale)
        out, l, m = flash_attention(q, k, v, scale, residuals=True)
        ctx.save_for_backward(q, k, v, out, l, m)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, gout):
        q, k, v, out, l, m = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, l, m, gout,
                                         ctx.scale)
        return dq, dk, dv, None
