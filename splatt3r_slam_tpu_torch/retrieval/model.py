"""Retrieval feature head: whitening + projector + attention top-k.

Counterpart of `splatt3r_slam_tpu/retrieval/model.py`: a whitener (centre
and PCA matrix), an MLP projector (Linear[/LN/GELU]*, optional residual),
attention as the per-token L2 norm, top-`nfeat` token selection, then
post-whitening. Parameters are numpy arrays in the reference layout;
`prep_features` takes them as tensors on the features' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def init_retrieval_params(dim: int = 1024, hdims=(1024,), seed: int = 0,
                          residual: bool = False) -> dict:
    """Random-init params with the reference layout (no checkpoint)."""
    rng = np.random.default_rng(seed)
    params = {
        "prewhiten": {"m": np.zeros((1, dim), np.float32),
                      "p": np.eye(dim, dtype=np.float32)},
        "postwhiten": {"m": np.zeros((1, hdims[-1]), np.float32),
                       "p": np.eye(hdims[-1], dtype=np.float32)},
        "projector": [],
        "residual": residual,
    }
    d = dim
    for i, hd in enumerate(hdims):
        layer = {"w": rng.standard_normal((d, hd)).astype(np.float32)
                 / np.sqrt(d), "b": np.zeros(hd, np.float32)}
        if i < len(hdims) - 1:
            layer["ln_scale"] = np.ones(hd, np.float32)
            layer["ln_bias"] = np.zeros(hd, np.float32)
        params["projector"].append(layer)
        d = hd
    return params


def load_retrieval_checkpoint(path: str) -> dict:
    """A local reference retrieval `.pth` (RetrievalModel state dict) →
    the params dict. Nothing is downloaded."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().float().numpy() for k, v in ckpt["model"].items()}
    args = ckpt.get("args")
    params = {
        "prewhiten": {"m": sd["prewhiten.m"], "p": sd["prewhiten.p"]},
        "postwhiten": {"m": sd["postwhiten.m"], "p": sd["postwhiten.p"]},
        "projector": [],
        "residual": bool(getattr(args, "residual", False)) if args else False,
    }
    i = 0
    layers = []
    while f"projector.{i}.weight" in sd:
        w = sd[f"projector.{i}.weight"]
        if w.ndim == 2:  # Linear
            layers.append({"w": w.T, "b": sd[f"projector.{i}.bias"]})
        else:  # LayerNorm folded into the previous layer's entry
            layers[-1]["ln_scale"] = w
            layers[-1]["ln_bias"] = sd[f"projector.{i}.bias"]
        i += 1
    params["projector"] = layers
    params["nfeat"] = int(getattr(args, "nfeat", 300)) if args else 300
    return params


def params_to_device(params: dict, device) -> dict:
    """The array leaves of `params` as float32 tensors on `device`."""
    def put(v):
        if isinstance(v, dict):
            return {k: put(x) for k, x in v.items()}
        if isinstance(v, list):
            return [put(x) for x in v]
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v, dtype=torch.float32, device=device)
        return v

    return put(params)


def _whiten(x, m, p):
    return (x - m) @ p


@torch.no_grad()
def prep_features(params, backbone_feat, nfeat: int = 300,
                  residual: bool = False):
    """(B, N, C) encoder tokens → (B, nfeat, D) retrieval descriptors.
    `params` holds tensors on the features' device (`params_to_device`)."""
    x = _whiten(backbone_feat.float(), params["prewhiten"]["m"],
                params["prewhiten"]["p"])
    h = x
    n_layers = len(params["projector"])
    for i, layer in enumerate(params["projector"]):
        h = h @ layer["w"] + layer["b"]
        if i < n_layers - 1:
            mu = h.mean(-1, keepdim=True)
            var = h.var(-1, keepdim=True, unbiased=False)
            h = (h - mu) / torch.sqrt(var + 1e-5)
            h = F.gelu(h * layer["ln_scale"] + layer["ln_bias"])
    proj = h + x if residual else h
    attention = torch.linalg.norm(proj, dim=-1)  # (B, N)
    whitened = _whiten(proj, params["postwhiten"]["m"],
                       params["postwhiten"]["p"])
    k = min(nfeat, attention.shape[1])
    idx = torch.topk(attention, k, dim=1).indices
    return torch.gather(whitened, 1,
                        idx[..., None].expand(-1, -1, whitened.shape[-1]))
