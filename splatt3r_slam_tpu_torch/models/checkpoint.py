"""Carry weights into the port's model.

- `params_from_jax`: the JAX package's flax parameter tree (as numpy
  arrays) → this model's `state_dict`. It inverts
  `splatt3r_slam_tpu/models/checkpoint.py::convert_state_dict`: flax Dense
  kernels (in, out) → torch Linear weights (out, in); flax Conv kernels
  HWIO → OIHW; flax ConvTranspose kernels (kh, kw, O, I) → torch (I, O,
  kh, kw); depth-stacked scanned block leaves → one entry per block.
- `load_torch_checkpoint`: a local reference checkpoint (`.pth`, or
  Lightning `.ckpt` with its `encoder.` wrapper removed). The port's module
  keys ARE the reference key layout, so it loads without conversion.

Nothing is downloaded.
"""

from __future__ import annotations

import numpy as np
import torch

from splatt3r_slam_tpu_torch.models.two_view import TwoViewConfig

# refinenet4 never receives a residual input, so its resConfUnit1 is unused
# (the flax tree has no such leaves; reference checkpoints carry them)
_UNUSED = ("scratch.refinenet4.resConfUnit1.",)


def _lin(p, pre, out):
    out[pre + ".weight"] = np.asarray(p["kernel"]).T
    out[pre + ".bias"] = np.asarray(p["bias"])


def _ln(p, pre, out):
    out[pre + ".weight"] = np.asarray(p["scale"])
    out[pre + ".bias"] = np.asarray(p["bias"])


def _conv(p, pre, out):
    # HWIO → OIHW; ConvTranspose (kh, kw, O, I) → (I, O, kh, kw): same perm
    out[pre + ".weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[pre + ".bias"] = np.asarray(p["bias"])


def _attn(p, pre, out, names):
    for n in names:
        _lin(p[n], f"{pre}.{n}", out)


def _block(p, pre, out, dec):
    for n in (("norm1", "norm2", "norm3", "norm_y") if dec
              else ("norm1", "norm2")):
        _ln(p[n], f"{pre}.{n}", out)
    _attn(p["attn"], f"{pre}.attn", out, ("qkv", "proj"))
    if dec:
        _attn(p["cross_attn"], f"{pre}.cross_attn", out,
              ("projq", "projk", "projv", "proj"))
    _attn(p["mlp"], f"{pre}.mlp", out, ("fc1", "fc2"))


def _dpt(p, pre, out):
    for src, dst in (("act_0_conv", "act_postprocess.0.0"),
                     ("act_0_deconv", "act_postprocess.0.1"),
                     ("act_1_conv", "act_postprocess.1.0"),
                     ("act_1_deconv", "act_postprocess.1.1"),
                     ("act_2_conv", "act_postprocess.2.0"),
                     ("act_3_conv", "act_postprocess.3.0"),
                     ("act_3_down", "act_postprocess.3.1"),
                     ("head_0", "head.0"), ("head_2", "head.2"),
                     ("head_4", "head.4")):
        _conv(p[src], f"{pre}.{dst}", out)
    for k in range(1, 5):
        _conv(p[f"layer_{k}_rn"], f"{pre}.scratch.layer{k}_rn", out)
        rf = p[f"refinenet{k}"]
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in rf:
                for c in ("conv1", "conv2"):
                    _conv(rf[unit][c],
                          f"{pre}.scratch.refinenet{k}.{unit}.{c}", out)
        _conv(rf["out_conv"], f"{pre}.scratch.refinenet{k}.out_conv", out)


def _unstack(tree, i):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(params_np, cfg: TwoViewConfig) -> dict:
    """flax parameter tree (numpy leaves) → torch state_dict (CPU tensors)."""
    out: dict = {}
    p = params_np
    _conv(p["patch_embed"]["proj"], "patch_embed.proj", out)
    _ln(p["enc_norm"], "enc_norm", out)
    _lin(p["decoder_embed"], "decoder_embed", out)
    _ln(p["dec_norm"], "dec_norm", out)
    for i in range(cfg.enc_depth):
        _block(_unstack(p["enc_blocks"]["block"], i), f"enc_blocks.{i}", out,
               dec=False)
    for i in range(cfg.dec_depth):
        _block(_unstack(p["dec_blocks"]["blk1"], i), f"dec_blocks.{i}", out,
               dec=True)
        _block(_unstack(p["dec_blocks"]["blk2"], i), f"dec_blocks2.{i}", out,
               dec=True)
    for h in (1, 2):
        hp = p[f"head{h}"]
        pre = f"downstream_head{h}"
        _dpt(hp["dpt"], f"{pre}.dpt", out)
        _lin(hp["hlf_fc1"], f"{pre}.head_local_features.fc1", out)
        _lin(hp["hlf_fc2"], f"{pre}.head_local_features.fc2", out)
        _dpt(hp["gaussian_dpt"], f"{pre}.gaussian_dpt.dpt", out)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def _normalise_keys(sd: dict) -> dict:
    """Reference naming variants → the port's keys."""
    out = {}
    for k, v in sd.items():
        if k.startswith("encoder."):
            k = k[len("encoder."):]
        for i in range(4):
            k = k.replace(f"scratch.layer_rn.{i}.", f"scratch.layer{i + 1}_rn.")
        out[k] = v
    if not any(k.startswith("dec_blocks2.") for k in out):
        # checkpoints without a second decoder stack share the first
        for k, v in list(out.items()):
            if k.startswith("dec_blocks."):
                out[k.replace("dec_blocks.", "dec_blocks2.", 1)] = v
    return out


def checked_state_dict(model: torch.nn.Module, sd: dict):
    """→ ({key: array} of `sd`'s entries that `model` holds, the ignored
    extra keys). Every model key but the unused refinenet4 residual unit
    must be present, at its shape."""
    sd = _normalise_keys(sd)
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not any(u in k for u in
                                                         _UNUSED)]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors, e.g. "
                       f"{missing[:5]}")
    bad = [k for k in own if k in sd and tuple(sd[k].shape) != own[k].shape]
    if bad:
        raise ValueError(f"shape mismatch for {bad[:5]}")
    return ({k: sd[k] for k in own if k in sd},
            [k for k in sd if k not in own])


def load_state_dict(model: torch.nn.Module, sd: dict) -> list:
    """Load `sd` into `model` (checked by `checked_state_dict`). Returns
    the ignored extra keys. A model sharded on a mesh loads through
    `parallel/mesh.py::load_full_state_dict`."""
    sd, extra = checked_state_dict(model, sd)
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if k in sd:
                t.copy_(torch.as_tensor(sd[k]).to(t.dtype))
    return extra


def load_torch_checkpoint(path: str) -> dict:
    """Read a local .pth/.ckpt into a flat state dict of float32 tensors.

    Handles raw state dicts, {'model': sd} and Lightning
    {'state_dict': {'encoder.<k>': ...}}."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and "model" in ckpt:
        sd = ckpt["model"]
    else:
        sd = ckpt
    return {k: v.detach().to(torch.float32) for k, v in sd.items()
            if torch.is_tensor(v)}
