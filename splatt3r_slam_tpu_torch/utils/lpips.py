"""LPIPS perceptual metric (VGG16 backbone).

Counterpart of `splatt3r_slam_tpu/utils/lpips.py`: images are shifted and
scaled per channel, passed through a VGG16 trunk, the features at relu1_2 /
relu2_2 / relu3_3 / relu4_3 / relu5_3 are channel-unit-normalized, squared
differences are reduced by learned 1x1 calibration weights, and the five
layer maps are spatially averaged (or, with `spatial=True`, bilinearly
upsampled to the input size) and added. Functions on a parameter dict
{"convs": [[{"kernel" (O, I, 3, 3), "bias" (O,)}, ...] x5], "lins":
[(C,) x5]} of torch tensors; images are NHWC as in the JAX package. The
convolutions are cuDNN's (the JAX package leaves them to XLA).

Weights: `convert_torch_lpips` maps the torch `lpips.LPIPS('vgg')` state
dict; `load_lpips_params` reads a torch file of that module or the `.npz`
that scripts/convert_lpips.py writes (HWIO kernels, converted here).
Without a weights file, `random_params` gives a shape-faithful tree (the
same numbers as the JAX package's for the same seed); the trainer only
reports LPIPS when real weights are supplied. Nothing is downloaded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: (torchvision `features` index, in, out) per conv, grouped
# by the LPIPS slice that consumes the block's final ReLU; maxpool between
VGG_SLICES = (
    ((0, 3, 64), (2, 64, 64)),
    ((5, 64, 128), (7, 128, 128)),
    ((10, 128, 256), (12, 256, 256), (14, 256, 256)),
    ((17, 256, 512), (19, 512, 512), (21, 512, 512)),
    ((24, 512, 512), (26, 512, 512), (28, 512, 512)),
)
LIN_CHANNELS = (64, 128, 256, 512, 512)

# lpips.ScalingLayer constants (ImageNet statistics in [-1, 1] space)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def params_from_hwio(tree, device="cpu") -> dict:
    """A tree with HWIO conv kernels (the JAX package's layout, numpy or
    array leaves) → this module's tree (OIHW torch tensors)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return {
        "convs": [[{"kernel": t(np.transpose(np.asarray(c["kernel"]),
                                             (3, 2, 0, 1))),
                    "bias": t(c["bias"])} for c in block]
                  for block in tree["convs"]],
        "lins": [t(lin) for lin in tree["lins"]],
    }


def random_params(seed: int = 0, channel_scale: int = 1,
                  device="cpu") -> dict:
    """Shape-faithful random parameter tree (tests / dry runs), drawn in
    the JAX package's order so the same seed gives the same numbers.

    channel_scale > 1 divides every channel count (min 4): the functions
    read layer widths from the tree."""
    rng = np.random.default_rng(seed)

    def ch(c):
        return max(4, c // channel_scale)

    tree = {"convs": [], "lins": []}
    for s, block in enumerate(VGG_SLICES):
        convs = []
        for i, (_, cin, cout) in enumerate(block):
            cin_s = 3 if (s == 0 and i == 0) else ch(cin)
            w = rng.standard_normal((3, 3, cin_s, ch(cout))).astype(
                np.float32)
            w *= np.sqrt(2.0 / (9 * cin_s))
            convs.append({"kernel": w,
                          "bias": np.zeros(ch(cout), np.float32)})
        tree["convs"].append(convs)
        tree["lins"].append(
            rng.uniform(0, 1, (ch(LIN_CHANNELS[s]),)).astype(np.float32))
    return params_from_hwio(tree, device)


def convert_torch_lpips(sd: dict, device="cpu") -> dict:
    """torch `lpips.LPIPS('vgg')` state dict → parameter tree.

    Accepts either full-module keys (`net.slice{k}.{i}.weight`,
    `lin{k}.model.1.weight`) or raw torchvision keys
    (`features.{i}.weight`) plus `lin{k}` tensors."""

    def fetch(names):
        for n in names:
            if n in sd:
                return torch.as_tensor(sd[n]).detach().to(
                    device=device, dtype=torch.float32)
        raise KeyError(f"none of {names} in state dict")

    params = {"convs": [], "lins": []}
    slice_base = [0, 4, 9, 16, 23]  # first features-index of each slice
    for s, block in enumerate(VGG_SLICES):
        convs = []
        for idx, _, _ in block:
            stems = (f"net.slice{s + 1}.{idx - slice_base[s]}",
                     f"features.{idx}", f"net.features.{idx}")
            convs.append({
                "kernel": fetch([f"{p}.weight" for p in stems]),
                "bias": fetch([f"{p}.bias" for p in stems]),
            })
        params["convs"].append(convs)
        lin = fetch([f"lin{s}.model.1.weight", f"lins.{s}.model.1.weight"])
        params["lins"].append(lin.reshape(-1))
    return params


def load_lpips_params(path: str, device="cpu") -> dict:
    """Load LPIPS weights: a `.npz` written by scripts/convert_lpips.py, or
    a torch-saved LPIPS module / state-dict file."""
    if str(path).endswith(".npz"):
        z = np.load(path)
        return params_from_hwio({
            "convs": [[{"kernel": z[f"conv_{s}_{c}_kernel"],
                        "bias": z[f"conv_{s}_{c}_bias"]}
                       for c in range(len(block))]
                      for s, block in enumerate(VGG_SLICES)],
            "lins": [z[f"lin_{s}"] for s in range(len(VGG_SLICES))],
        }, device)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return convert_torch_lpips(obj, device)


def _vgg_features(params, x):
    """x: (B, 3, H, W) in scaled space → 5 post-ReLU feature maps."""
    feats = []
    for s, convs in enumerate(params["convs"]):
        if s > 0:  # maxpool 2x2/2 between blocks
            x = F.max_pool2d(x, 2)
        for p in convs:
            x = F.relu(F.conv2d(x, p["kernel"], p["bias"], padding=1))
        feats.append(x)
    return feats


def _unit_norm(f, eps=1e-10):
    return f * torch.rsqrt((f * f).sum(1, keepdim=True) + eps)


def lpips(params, img0, img1, spatial: bool = False):
    """LPIPS distance between (B, H, W, 3) images in [-1, 1].

    spatial=False → (B,); spatial=True → (B, H, W) per-pixel map (layer
    maps bilinearly upsampled to the input size, half-pixel centres)."""
    dev = img0.device
    shift = torch.tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=dev)[None, :, None, None]

    def feats(img):
        x = img.float().permute(0, 3, 1, 2)
        return _vgg_features(params, (x - shift) / scale)

    f0, f1 = feats(img0), feats(img1)
    B, H, W = img0.shape[:3]
    total = torch.zeros((B, H, W) if spatial else (B,), device=dev)
    for s in range(len(f0)):
        d = (_unit_norm(f0[s]) - _unit_norm(f1[s])) ** 2
        m = torch.einsum("bchw,c->bhw", d, params["lins"][s])
        if spatial:
            m = F.interpolate(m[:, None], size=(H, W), mode="bilinear",
                              align_corners=False)[:, 0]
        else:
            m = m.mean(dim=(1, 2))
        total = total + m
    return total


def lpips_from_01(params, img0_01, img1_01, spatial: bool = False):
    """`normalize=True` entry point: inputs in [0, 1]."""
    return lpips(params, img0_01 * 2.0 - 1.0, img1_01 * 2.0 - 1.0,
                 spatial=spatial)
