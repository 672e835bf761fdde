"""Image-space ops: Scharr-like gradients (3x3 kernels / 32, reflect pad).

Counterpart of `splatt3r_slam_tpu/ops/image.py`; NHWC layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 3x3 kernel taps: (dy, dx) → (gx weight, gy weight)
_TAPS = [
    (-1, -1, -3.0, -3.0),
    (-1, 0, 0.0, -10.0),
    (-1, 1, 3.0, -3.0),
    (0, -1, -10.0, 0.0),
    (0, 1, 10.0, 0.0),
    (1, -1, -3.0, 3.0),
    (1, 0, 0.0, 10.0),
    (1, 1, 3.0, 3.0),
]


def img_gradient(img):
    """Per-channel x/y gradients of (b, h, w, c) images → (gx, gy)."""
    p = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    p = p.permute(0, 2, 3, 1)
    h, w = img.shape[1], img.shape[2]
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    for dy, dx, wx, wy in _TAPS:
        tile = p[:, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w, :]
        if wx:
            gx = gx + (wx / 32.0) * tile
        if wy:
            gy = gy + (wy / 32.0) * tile
    return gx, gy
