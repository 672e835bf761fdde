"""Two-view ViT: siamese encoder + dual cross-attention decoder + heads.

Counterpart of `splatt3r_slam_tpu/models/two_view.py`. Where the JAX
package scans depth-stacked block parameters, the port keeps one module
per block in an `nn.ModuleList` (enc_blocks, dec_blocks, dec_blocks2), which
is the reference checkpoint's key layout. `encode`, `decode` and
`apply_head` are exposed separately so the SLAM runtime caches keyframe
encoder tokens across frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from splatt3r_slam_tpu_torch.models.heads import GaussianHead
from splatt3r_slam_tpu_torch.models.layers import (
    Block,
    DecoderBlock,
    LayerNorm,
    Linear,
    PatchEmbed,
    _dt,
    rope_cos_sin,
)


class TwoViewConfig(NamedTuple):
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    patch_size: int = 16
    local_feat_dim: int = 24
    sh_degree: int = 1
    use_offsets: bool = False
    rope_freq: float = 100.0
    dtype: str = "bfloat16"  # transformer compute dtype
    head_dtype: str = "bfloat16"  # DPT/MLP head trunk compute dtype
    # recompute each encoder/decoder block on the backward pass instead of
    # storing its activations (torch.utils.checkpoint); only takes effect
    # where a block's parameters train, so inference is unaffected
    remat: bool = False
    head_feature_dim: int = 256
    head_layer_dims: tuple = (96, 192, 384, 768)
    head_last_dim: int = 128

    @property
    def tdtype(self):
        return _dt(self.dtype)

    @property
    def thead_dtype(self):
        return _dt(self.head_dtype)

    def tiny(self):
        """A scaled-down config for tests."""
        return self._replace(
            enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
            dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
            head_feature_dim=16, head_layer_dims=(8, 12, 16, 24),
            head_last_dim=16,
        )


class Splatt3RModel(nn.Module):
    """Full two-view network."""

    def __init__(self, cfg: TwoViewConfig):
        super().__init__()
        self.cfg = c = cfg
        dt = c.dtype
        self.patch_embed = PatchEmbed(c.patch_size, c.enc_embed_dim)
        self.enc_blocks = nn.ModuleList(
            [Block(c.enc_embed_dim, c.enc_num_heads, 4, dt)
             for _ in range(c.enc_depth)])
        self.enc_norm = LayerNorm(c.enc_embed_dim)
        self.decoder_embed = Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(c.dec_embed_dim, c.dec_num_heads, 4, dt)
             for _ in range(c.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [DecoderBlock(c.dec_embed_dim, c.dec_num_heads, 4, dt)
             for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm(c.dec_embed_dim)
        hkw = dict(enc_dim=c.enc_embed_dim, dec_dim=c.dec_embed_dim,
                   local_feat_dim=c.local_feat_dim, patch_size=c.patch_size,
                   sh_degree=c.sh_degree, use_offsets=c.use_offsets,
                   dtype=c.head_dtype, feature_dim=c.head_feature_dim,
                   layer_dims=c.head_layer_dims, last_dim=c.head_last_dim)
        self.downstream_head1 = GaussianHead(**hkw)
        self.downstream_head2 = GaussianHead(**hkw)

    def _block(self, blk, *args):
        """Run one block, rematerialized when `cfg.remat` and it trains."""
        if self.cfg.remat and torch.is_grad_enabled() and any(
                p.requires_grad for p in blk.parameters()):
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def _rope(self, pos, dim, heads):
        return rope_cos_sin(pos, dim // heads // 2, self.cfg.rope_freq)

    def encode(self, img):
        """img (B, H, W, 3) NHWC → (tokens (B,N,C) fp32, pos (B,N,2))."""
        c = self.cfg
        x, pos = self.patch_embed(img)
        cs = self._rope(pos, c.enc_embed_dim, c.enc_num_heads)
        x = x.to(c.tdtype)
        for blk in self.enc_blocks:
            x = self._block(blk, x, cs)
        return self.enc_norm(x), pos

    def decode(self, f1, pos1, f2, pos2):
        """Dual decoder; returns per-view hook lists [enc, d6, d9, d12·LN]."""
        c = self.cfg
        cs1 = self._rope(pos1, c.dec_embed_dim, c.dec_num_heads)
        cs2 = self._rope(pos2, c.dec_embed_dim, c.dec_num_heads)
        x1 = self.decoder_embed(f1).to(c.tdtype)
        x2 = self.decoder_embed(f2).to(c.tdtype)
        h6 = c.dec_depth // 2 - 1
        h9 = 3 * c.dec_depth // 4 - 1
        keep1, keep2 = {}, {}
        for i, (b1, b2) in enumerate(zip(self.dec_blocks, self.dec_blocks2)):
            x1, x2 = (self._block(b1, x1, x2, cs1, cs2),
                      self._block(b2, x2, x1, cs2, cs1))
            if i in (h6, h9):
                keep1[i], keep2[i] = x1.float(), x2.float()
        out1 = [f1, keep1[h6], keep1[h9], self.dec_norm(x1)]
        out2 = [f2, keep2[h6], keep2[h9], self.dec_norm(x2)]
        return out1, out2

    def apply_head(self, head_num, hook_tokens, image_size, mode="full"):
        head = self.downstream_head1 if head_num == 1 else \
            self.downstream_head2
        return head(hook_tokens, image_size, mode)

    def forward(self, img1, img2):
        """Full two-view forward; res2's pts3d live in view1's frame."""
        _, H, W, _ = img1.shape
        f1, pos1 = self.encode(img1)
        f2, pos2 = self.encode(img2)
        d1, d2 = self.decode(f1, pos1, f2, pos2)
        return (self.apply_head(1, d1, (H, W)),
                self.apply_head(2, d2, (H, W)))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights as `main.py` makes them: LayerNorm scale 1,
    every bias 0, every other weight normal / sqrt(fan_in), drawn from a
    torch.Generator on the model's device."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            else:
                fan_in = math.prod(p.shape[1:]) or 1
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
    return model


def init_model(cfg: TwoViewConfig, seed: int = 0, device="cuda"):
    """Random-init model (seeded) on `device`, in eval mode, no grads."""
    from splatt3r_slam_tpu_torch import resolve_device

    model = Splatt3RModel(cfg).to(resolve_device(device))
    init_weights(model, seed)
    return model.eval().requires_grad_(False)
