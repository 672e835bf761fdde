"""Image-quality metrics: SSIM (optionally masked), PSNR, MSE.

Counterpart of `splatt3r_slam_tpu/utils/metrics.py`: an 11x11 gaussian
window (sigma 1.5), the standard C1/C2 constants, optional mask averaging,
and PSNR from MSE for images in [0, 1]. Images are NHWC in and out, as in
the JAX package; the depthwise blur is `F.conv2d(groups=C)`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 11, sigma: float = 1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def ssim(img1, img2, window_size: int = 11):
    """Per-pixel SSIM map of (..., H, W, C) images in [0, 1]."""
    img1, img2 = img1.float(), img2.float()
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    c = img1.shape[-1]
    k = _gaussian_window(window_size).to(img1.device)[None, None].expand(
        c, 1, window_size, window_size)
    pad = window_size // 2

    def filt(x):  # depthwise gaussian blur, zero padded
        return F.conv2d(x.permute(0, 3, 1, 2), k, padding=pad,
                        groups=c).permute(0, 2, 3, 1)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    C1, C2 = 0.01**2, 0.03**2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m[0] if squeeze else m


def batch_mean(x, total=None):
    """Mean of every element of x. `total`, where given, sums a tensor
    over the ranks that hold the batch's other rows (`parallel/mesh.py::
    data_sum`), and the mean is then the whole batch's."""
    if total is None:
        return x.mean()
    num, den = total(torch.stack([x.sum(), x.new_tensor(float(x.numel()))
                                  ])).unbind()
    return num / den


def _masked_mean(x, mask, total=None):
    mask = mask[..., None].to(x.dtype).expand_as(x)
    if total is None:
        return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    num, den = total(torch.stack([(x * mask).sum(), mask.sum()])).unbind()
    return num / torch.clamp(den, min=1.0)


def ssim_mean(img1, img2, mask=None, window_size: int = 11, total=None):
    """Scalar SSIM, optionally averaged over a validity mask (`total` as
    in `batch_mean`)."""
    m = ssim(img1, img2, window_size)
    return batch_mean(m, total) if mask is None \
        else _masked_mean(m, mask, total)


def mse(img1, img2, mask=None, total=None):
    d = (img1 - img2) ** 2
    return batch_mean(d, total) if mask is None \
        else _masked_mean(d, mask, total)


def psnr_from_mse(m):
    """PSNR in dB for images in [0, 1]."""
    return -10.0 * torch.log10(torch.clamp(m, min=1e-12))


def psnr(img1, img2, mask=None):
    return psnr_from_mse(mse(img1, img2, mask))
