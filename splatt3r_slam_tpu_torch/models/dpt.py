"""DPT dense-prediction head (torch.nn, NCHW inside, NHWC out).

Counterpart of `splatt3r_slam_tpu/models/dpt.py` (hooks [0, 6, 9, 12],
feature_dim 256, "regression" head, path_4 cropped to layer-3's shape),
with the reference checkpoint's module names (act_postprocess.*,
scratch.layer{k}_rn, scratch.refinenet{k}.*, head.{0,2,4}).

Precision as in the JAX package: convs compute in `dtype` (bf16 in the
production profile), residual adds and the inter-block signal stay fp32,
and the final 1x1 projection (`head.4`) always computes in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatt3r_slam_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    _dt,
    bilinear_resize_ac_nchw,
)


class ResidualConvUnit(nn.Module):
    """x + conv(relu(conv(relu(x)))), convs in `dtype`, residual in x's."""

    def __init__(self, features, dtype="float32"):
        super().__init__()
        self.dtype = _dt(dtype)
        self.conv1 = Conv2d(features, features, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x):
        out = self.conv1(F.relu(x).to(self.dtype))
        out = self.conv2(F.relu(out))
        return out.to(x.dtype) + x


class FeatureFusionBlock(nn.Module):
    """Fusion + 2x align-corners upsample + 1x1 out conv."""

    def __init__(self, features, dtype="float32"):
        super().__init__()
        self.dtype = _dt(dtype)
        self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv2d(features, features, 1, dtype=dtype)

    def forward(self, x, res=None):
        x = x.float()
        if res is not None:
            x = x + self.resConfUnit1(res.float())
        x = self.resConfUnit2(x)
        H, W = x.shape[-2:]
        x = bilinear_resize_ac_nchw(x, (2 * H, 2 * W))
        return self.out_conv(x.to(self.dtype))


class _Scratch(nn.Module):
    def __init__(self, layer_dims, feature_dim, dtype):
        super().__init__()
        for k in range(4):
            setattr(self, f"layer{k + 1}_rn",
                    Conv2d(layer_dims[k], feature_dim, 3, padding=1,
                           bias=False, dtype=dtype))
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", FeatureFusionBlock(feature_dim,
                                                              dtype))


class DPT(nn.Module):
    """4-hook DPT adapter producing a dense (B, H, W, num_channels) map."""

    def __init__(self, num_channels, dim_tokens: Sequence[int] = (1024, 768,
                                                                  768, 768),
                 layer_dims: Sequence[int] = (96, 192, 384, 768),
                 feature_dim: int = 256, last_dim: int = 128,
                 patch_size: int = 16, dtype="float32"):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = _dt(dtype)
        ld = layer_dims
        dt = dtype
        self.act_postprocess = nn.ModuleList([
            nn.ModuleList([Conv2d(dim_tokens[0], ld[0], 1, dtype=dt),
                           ConvTranspose2d(ld[0], ld[0], 4, stride=4,
                                           dtype=dt)]),
            nn.ModuleList([Conv2d(dim_tokens[1], ld[1], 1, dtype=dt),
                           ConvTranspose2d(ld[1], ld[1], 2, stride=2,
                                           dtype=dt)]),
            nn.ModuleList([Conv2d(dim_tokens[2], ld[2], 1, dtype=dt)]),
            nn.ModuleList([Conv2d(dim_tokens[3], ld[3], 1, dtype=dt),
                           Conv2d(ld[3], ld[3], 3, stride=2, padding=1,
                                  dtype=dt)]),
        ])
        self.scratch = _Scratch(ld, feature_dim, dt)
        self.head = nn.ModuleDict({
            "0": Conv2d(feature_dim, feature_dim // 2, 3, padding=1,
                        dtype=dt),
            "2": Conv2d(feature_dim // 2, last_dim, 3, padding=1, dtype=dt),
            "4": Conv2d(last_dim, num_channels, 1, dtype=torch.float32),
        })

    def forward(self, hook_tokens, image_size):
        """hook_tokens: 4 (B, N, C_i) token arrays; image_size (H, W)."""
        H, W = image_size
        nh, nw = H // self.patch_size, W // self.patch_size
        feats = [t.to(self.dtype).transpose(1, 2).reshape(t.shape[0], -1, nh,
                                                            nw)
                 for t in hook_tokens]
        layers = []
        for f, mods in zip(feats, self.act_postprocess):
            for m in mods:
                f = m(f)
            layers.append(f)
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(l) for i, l in enumerate(layers)]
        p4 = s.refinenet4(rn[3])
        p4 = p4[:, :, : rn[2].shape[2], : rn[2].shape[3]]
        p3 = s.refinenet3(p4, rn[2])
        p2 = s.refinenet2(p3, rn[1])
        p1 = s.refinenet1(p2, rn[0])
        x = self.head["0"](p1)
        x = bilinear_resize_ac_nchw(x, (H, W))
        x = F.relu(self.head["2"](x))
        x = self.head["4"](x.float())
        return x.permute(0, 2, 3, 1)
