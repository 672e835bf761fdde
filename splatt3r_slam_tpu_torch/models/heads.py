"""Gaussian prediction head + output activations (torch.nn).

Counterpart of `splatt3r_slam_tpu/models/heads.py`: pts3d DPT (4ch),
local-features MLP (enc+dec → 4x hidden → 25·p²) + NHWC pixel shuffle, and
the "gaussian" DPT (14ch), activated as in the reference:
pts3d = dir·expm1(‖x‖); conf = 1+exp(x); desc L2-normalized;
offsets = dir·(exp(‖x‖−6)−exp(−6)); scales = exp; rotations L2-norm quat
(xyzw); sh reshape to (..., 3, d_sh); opacity = sigmoid.
Module names follow the reference checkpoint (dpt, head_local_features,
gaussian_dpt.dpt).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatt3r_slam_tpu_torch.models.dpt import DPT
from splatt3r_slam_tpu_torch.models.layers import Linear, _dt, pixel_shuffle


def reg_dense_depth_exp(xyz):
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    return xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)


def reg_dense_conf_exp(x, vmin: float = 1.0):
    return vmin + torch.exp(x)


def reg_desc_norm(desc):
    return desc / torch.linalg.norm(desc, dim=-1, keepdim=True)


def reg_dense_offsets(xyz, shift: float = 6.0):
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    dirs = xyz / torch.clamp(d, min=1e-8)
    return dirs * (torch.exp(d - shift) - math.exp(-shift))


def reg_dense_rotation(rot, eps: float = 1e-8):
    return rot / (torch.linalg.norm(rot, dim=-1, keepdim=True) + eps)


def gaussian_postprocess(fmap, desc_dim: int = 24, sh_degree: int = 1,
                         use_offsets: bool = False) -> dict:
    """Split + activate the (B, H, W, 40) head output."""
    fmap = fmap.float()
    (pts3d, conf, desc, desc_conf, offset, scales, rotations, sh, opacities
     ) = torch.split(fmap, [3, 1, desc_dim, 1, 3, 3, 4, 3 * sh_degree, 1],
                     dim=-1)
    pts3d = reg_dense_depth_exp(pts3d)
    return {
        "pts3d": pts3d,
        "conf": reg_dense_conf_exp(conf[..., 0]),
        "desc": reg_desc_norm(desc),
        "desc_conf": reg_dense_conf_exp(desc_conf[..., 0]),
        "scales": torch.exp(scales),
        "rotations": reg_dense_rotation(rotations),
        "sh": sh.reshape(sh.shape[:-1] + (3, sh_degree)),
        "opacities": torch.sigmoid(opacities),
        "means": (pts3d + reg_dense_offsets(offset) if use_offsets
                  else pts3d),
    }


def gaussian_postprocess_tracking(fmap, desc_dim: int = 24) -> dict:
    """Activate the tracking subset [3 pts3d | 1 conf | desc | 1 desc_conf]."""
    fmap = fmap.float()
    pts3d, conf, desc, desc_conf = torch.split(fmap, [3, 1, desc_dim, 1],
                                               dim=-1)
    pts3d = reg_dense_depth_exp(pts3d)
    return {
        "pts3d": pts3d,
        "conf": reg_dense_conf_exp(conf[..., 0]),
        "desc": reg_desc_norm(desc),
        "desc_conf": reg_dense_conf_exp(desc_conf[..., 0]),
        "means": pts3d,
    }


def gaussian_postprocess_gauss_only(fmap, sh_degree: int = 1) -> dict:
    """Activate the gaussian-DPT subset [3 offset | 3 scales | 4 rot |
    3·sh | 1 opacity]."""
    fmap = fmap.float()
    offset, scales, rotations, sh, opacities = torch.split(
        fmap, [3, 3, 4, 3 * sh_degree, 1], dim=-1)
    return {
        "offset_raw": offset,
        "scales": torch.exp(scales),
        "rotations": reg_dense_rotation(rotations),
        "sh": sh.reshape(sh.shape[:-1] + (3, sh_degree)),
        "opacities": torch.sigmoid(opacities),
    }


def combine_gaussians(gauss: dict, pts3d, conf, use_offsets: bool = False):
    """Merge a gaussian_only head output with the tracking pass's
    pts3d/conf into the full Gaussian prediction dict."""
    means = pts3d
    if use_offsets:
        means = pts3d + reg_dense_offsets(gauss["offset_raw"])
    return {
        "means": means,
        "scales": gauss["scales"],
        "rotations": gauss["rotations"],
        "sh": gauss["sh"],
        "opacities": gauss["opacities"],
        "conf": conf,
    }


class _LocalFeatures(nn.Module):
    def __init__(self, idim, odim, dtype):
        super().__init__()
        self.fc1 = Linear(idim, 4 * idim, dtype=dtype)
        self.fc2 = Linear(4 * idim, odim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _GaussianDPT(nn.Module):
    def __init__(self, dpt):
        super().__init__()
        self.dpt = dpt


class GaussianHead(nn.Module):
    """pts3d DPT + local-feature MLP + gaussian DPT."""

    def __init__(self, enc_dim=1024, dec_dim=768, local_feat_dim=24,
                 patch_size=16, sh_degree=1, use_offsets=False,
                 dtype="float32", feature_dim=256,
                 layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768),
                 last_dim=128):
        super().__init__()
        self.local_feat_dim = local_feat_dim
        self.patch_size = patch_size
        self.sh_degree = sh_degree
        self.use_offsets = use_offsets
        self.dtype = _dt(dtype)
        toks = (enc_dim, dec_dim, dec_dim, dec_dim)
        kw = dict(dim_tokens=toks, layer_dims=layer_dims,
                  feature_dim=feature_dim, last_dim=last_dim,
                  patch_size=patch_size, dtype=dtype)
        self.dpt = DPT(4, **kw)
        self.head_local_features = _LocalFeatures(
            enc_dim + dec_dim, (local_feat_dim + 1) * patch_size**2, dtype)
        self.gaussian_dpt = _GaussianDPT(
            DPT(3 + 3 + 4 + 3 * sh_degree + 1, **kw))

    def forward(self, hook_tokens, image_size, mode: str = "full") -> dict:
        """hook_tokens: [enc_out, dec6, dec9, dec12] (B, N, C_i).

        mode: "full" (everything), "tracking" (skip the gaussian DPT) or
        "gaussian_only" (just the gaussian DPT; see combine_gaussians).
        """
        H, W = image_size
        p = self.patch_size
        if mode == "gaussian_only":
            gauss = self.gaussian_dpt.dpt(hook_tokens, image_size)
            return gaussian_postprocess_gauss_only(gauss, self.sh_degree)

        pts3d = self.dpt(hook_tokens, image_size)
        cat = torch.cat([hook_tokens[0].float(), hook_tokens[-1].float()],
                        dim=-1).to(self.dtype)
        h = self.head_local_features(cat)
        B = h.shape[0]
        local = pixel_shuffle(h.reshape(B, H // p, W // p, -1), p)
        if mode == "tracking":
            fmap = torch.cat([pts3d.float(), local.float()], dim=-1)
            return gaussian_postprocess_tracking(fmap, self.local_feat_dim)

        gauss = self.gaussian_dpt.dpt(hook_tokens, image_size)
        fmap = torch.cat([pts3d.float(), local.float(), gauss.float()], dim=-1)
        return gaussian_postprocess(fmap, self.local_feat_dim, self.sh_degree,
                                    self.use_offsets)
