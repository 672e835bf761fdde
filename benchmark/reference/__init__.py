"""The benchmark's plain reference: the network (`network.py`), the plane
scene's geometry and poses (`geometry.py`), the matcher (`matching.py`),
the gaussians and their render (`render.py`), and the comparisons that
decide `correct` (`compare.py`). Plain PyTorch and NumPy; nothing here
imports the program under test.
"""

import torch


def precise() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
