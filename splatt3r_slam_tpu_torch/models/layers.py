"""Transformer building blocks for the two-view ViT (torch.nn).

Counterpart of `splatt3r_slam_tpu/models/layers.py`, with the reference
checkpoint's module names (qkv/proj, projq/projk/projv, fc1/fc2, norm1..3,
norm_y) so a reference state dict loads without conversion.

Precision follows the JAX package: parameters stay fp32; each Linear/Conv
casts its input and weights to its compute dtype (bf16 in the production
profile); LayerNorms compute in fp32; attention takes fp32 softmax over
bf16 q/k/v. Token layout at the public functions is (B, N, H, Dh) and
images are NHWC, as in the JAX package.

Attention goes through the hand-written flash-attention kernels
(`models/flash_attention.py`: the forward, and under autograd its two
backward kernels) where the flash-attention mode picks them and the TPU
kernel would take the head dim (below 128 or a multiple of 128), and
through `F.scaled_dot_product_attention` otherwise (the counterpart of the
JAX package's einsum path, which XLA computes).
"""

from __future__ import annotations

import logging

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatt3r_slam_tpu_torch.models.flash_attention import (
    FlashAttention,
    flash_head_dim_ok,
    head_dim_refused,
)


def _dt(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (None: fp32 or the input's wider type)."""

    def __init__(self, i, o, bias=True, dtype=None):
        super().__init__(i, o, bias=bias)
        self.compute_dtype = _dt(dtype)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """NCHW nn.Conv2d computing in `dtype` (None: fp32)."""

    def __init__(self, *a, dtype=None, **kw):
        super().__init__(*a, **kw)
        self.compute_dtype = _dt(dtype)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """NCHW nn.ConvTranspose2d computing in `dtype`."""

    def __init__(self, *a, dtype=None, **kw):
        super().__init__(*a, **kw)
        self.compute_dtype = _dt(dtype)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride)


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm (eps 1e-6) whatever the input dtype."""

    def __init__(self, d):
        super().__init__(d, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def rope_cos_sin(positions, d_half: int, freq: float = 100.0):
    """cos/sin tables at integer (y, x) token positions.

    positions: (B, N, 2) int. Returns cos, sin of shape (B, N, 2, d_half)
    where axis -2 indexes (y, x) (duplicated-half layout).
    """
    d4 = d_half // 2
    inv_freq = 1.0 / (freq ** (torch.arange(0, d4, dtype=torch.float32,
                                            device=positions.device) / d4))
    ang = positions[..., None].float() * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope2d(tokens, cos, sin):
    """2D rotary embedding on (B, N, H, D) tokens: y on the first half of
    each head's features, x on the second. cos/sin: (B, N, 2, D/2)."""
    ty, tx = tokens.chunk(2, dim=-1)
    dt = tokens.dtype
    cy, sy = cos[:, :, None, 0, :].to(dt), sin[:, :, None, 0, :].to(dt)
    cx, sx = cos[:, :, None, 1, :].to(dt), sin[:, :, None, 1, :].to(dt)
    ty = ty * cy + _rotate_half(ty) * sy
    tx = tx * cx + _rotate_half(tx) * sx
    return torch.cat([ty, tx], dim=-1)


# Flash-attention mode, the JAX package's `set_flash_attention` with the
# card in the TPU's place: "auto" picks the kernel for CUDA tensors once
# n_q·n_kv reaches _FLASH_AUTO_MIN_SCORES (the crossover the JAX package
# measured; at the 768-token tracking shape SDPA serves), never for CPU
# tensors; "on" picks it wherever `_flash_shape_ok` admits the shape; "off"
# never. Read at every call: eager PyTorch has no trace to bake it into.
_FLASH_MODE = "auto"
_FLASH_AUTO_MIN_SCORES = 4096 * 4096
FLASH_MODES = ("auto", "on", "off")


def set_flash_attention(mode: str):
    """Select the attention implementation: "auto" | "on" | "off"."""
    global _FLASH_MODE
    if mode not in FLASH_MODES:
        raise ValueError(f"flash-attention mode {mode!r} is not one of "
                         f"{FLASH_MODES}")
    _FLASH_MODE = mode


def flash_attention_mode() -> str:
    return _FLASH_MODE


def _flash_shape_ok(n_q: int, n_kv: int, dh: int) -> bool:
    # the shapes the JAX package hands its flash kernel
    return (n_q % 256 == 0 and n_kv % 256 == 0
            and dh % 64 == 0 and dh >= 64)


def _flash_wanted(n_q: int, n_kv: int, dh: int, device) -> bool:
    if _FLASH_MODE == "off" or not _flash_shape_ok(n_q, n_kv, dh):
        return False
    if _FLASH_MODE == "on":
        return True
    return (torch.device(device).type == "cuda"
            and n_q * n_kv >= _FLASH_AUTO_MIN_SCORES)


def attend_sdpa(q, k, v, scale):
    """Softmax attention on (B, N, H, D) q/k/v through PyTorch's fused
    attention: the JAX package's einsum path (its `_attend` with flash
    off), fp32 logits and weights."""
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)
    return out.transpose(1, 2).to(v.dtype)


_FLASH_ROUTE_LOGGED = False


def attend(q, k, v, scale):
    """Softmax attention on (B, N, H, D) q/k/v: the flash-attention kernel
    where the mode picks it and the TPU kernel takes the head dim
    (`flash_head_dim_ok`), its gradient through the two backward kernels
    (no fallback: each launches or raises), `attend_sdpa` otherwise. The
    head-dim rule is read from the shape before any launch, so a shape
    gets the JAX package's route: its `_attend` tries the TPU kernel, which
    refuses such a head dim, and takes its einsum path, logging once."""
    dh = q.shape[-1]
    if _flash_wanted(q.shape[1], k.shape[1], dh, q.device):
        if flash_head_dim_ok(dh):
            return FlashAttention.apply(q, k, v, scale)
        global _FLASH_ROUTE_LOGGED
        if not _FLASH_ROUTE_LOGGED:
            _FLASH_ROUTE_LOGGED = True
            logging.getLogger(__name__).warning(
                "flash attention unavailable (%s); using einsum path",
                head_dim_refused(dh))
    return attend_sdpa(q, k, v, scale)


class Attention(nn.Module):
    """Self-attention with RoPE on q/k."""

    def __init__(self, dim, num_heads, dtype="bfloat16"):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, rope_cs):
        B, N, C = x.shape
        Dh = C // self.num_heads
        # the head axis is -1: under tensor parallelism `qkv` holds this
        # rank's heads only, as [q, k, v] (parallel/mesh.py)
        qkv = self.qkv(x).reshape(B, N, 3, -1, Dh)
        q, k, v = qkv.unbind(2)
        if rope_cs is not None:
            q = apply_rope2d(q, *rope_cs)
            k = apply_rope2d(k, *rope_cs)
        return self.proj(attend(q, k, v, Dh**-0.5).reshape(B, N, -1))


class CrossAttention(nn.Module):
    """Cross-attention with separate q/k/v projections."""

    def __init__(self, dim, num_heads, dtype="bfloat16"):
        super().__init__()
        self.num_heads = num_heads
        self.projq = Linear(dim, dim, dtype=dtype)
        self.projk = Linear(dim, dim, dtype=dtype)
        self.projv = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, query, key, value, q_cs, k_cs):
        B, Nq, C = query.shape
        Dh = C // self.num_heads
        # local heads under tensor parallelism, as in `Attention`
        q = self.projq(query).reshape(B, Nq, -1, Dh)
        k = self.projk(key).reshape(B, key.shape[1], -1, Dh)
        v = self.projv(value).reshape(B, value.shape[1], -1, Dh)
        if q_cs is not None:
            q = apply_rope2d(q, *q_cs)
            k = apply_rope2d(k, *k_cs)
        return self.proj(attend(q, k, v, Dh**-0.5).reshape(B, Nq, -1))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out, dtype="bfloat16"):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    """Encoder block: x + attn(LN(x)); x + mlp(LN(x))."""

    def __init__(self, dim, num_heads, mlp_ratio=4, dtype="bfloat16"):
        super().__init__()
        self.dtype = _dt(dtype)
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim, dtype)

    def forward(self, x, rope_cs):
        x = x + self.attn(self.norm1(x).to(self.dtype), rope_cs)
        x = x + self.mlp(self.norm2(x).to(self.dtype))
        return x


class DecoderBlock(nn.Module):
    """Decoder block: self-attn + cross-attn + MLP."""

    def __init__(self, dim, num_heads, mlp_ratio=4, dtype="bfloat16"):
        super().__init__()
        self.dtype = _dt(dtype)
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dtype)
        self.cross_attn = CrossAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.norm_y = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim, dtype)

    def forward(self, x, y, x_cs, y_cs):
        x = x + self.attn(self.norm1(x).to(self.dtype), x_cs)
        y_ = self.norm_y(y).to(self.dtype)
        x = x + self.cross_attn(self.norm2(x).to(self.dtype), y_, y_, x_cs,
                                y_cs)
        x = x + self.mlp(self.norm3(x).to(self.dtype))
        return x


class PatchEmbed(nn.Module):
    """16x16 conv patchifier: NHWC image → (B, N, C) tokens + (y, x) pos."""

    def __init__(self, patch_size=16, embed_dim=1024):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, img):
        B, H, W, _ = img.shape
        p = self.patch_size
        x = self.proj(img.permute(0, 3, 1, 2).float())  # (B, C, gh, gw)
        gh, gw = H // p, W // p
        x = x.flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(gh, device=img.device),
                                torch.arange(gw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], dim=-1).reshape(1, gh * gw, 2)
        return x, pos.expand(B, gh * gw, 2)


def interp_matrix(n_in: int, n_out: int, device="cuda"):
    """(n_out, n_in) align-corners linear interpolation matrix."""
    if n_out == 1 or n_in == 1:
        return torch.full((n_out, n_in), 1.0 / n_in, device=device)
    src = (torch.arange(n_out, dtype=torch.float32, device=device)
           * (n_in - 1) / (n_out - 1))
    i0 = torch.clamp(torch.floor(src).long(), 0, n_in - 2)
    frac = src - i0
    A = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    r = torch.arange(n_out, device=device)
    A[r, i0] = 1.0 - frac
    A[r, i0 + 1] += frac
    return A


def bilinear_resize_ac_nchw(x, out_hw):
    """Align-corners bilinear resize of (B, C, H, W) as two fp32 matmuls."""
    H, W = x.shape[-2:]
    Ah = interp_matrix(H, out_hw[0], x.device)
    Aw = interp_matrix(W, out_hw[1], x.device)
    y = torch.einsum("ph,bchw,qw->bcpq", Ah, x.float(), Aw)
    return y.to(x.dtype)


def bilinear_resize_ac(x, out_hw):
    """Align-corners bilinear resize, NHWC (B, H, W, C) → (B, H', W', C)."""
    return bilinear_resize_ac_nchw(x.permute(0, 3, 1, 2), out_hw).permute(
        0, 2, 3, 1)


def pixel_shuffle(x, r: int):
    """torch.pixel_shuffle in NHWC: (B,H,W,C·r²) → (B,H·r,W·r,C).

    Channel index decomposes as c·r² + i·r + j (torch convention)."""
    B, H, W, CRR = x.shape
    C = CRR // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)
