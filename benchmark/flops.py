"""Operations of the network's dispatches, from its shapes, and the table of
peaks.

A dispatch's count follows from the configuration's widths and the
tensors' sizes alone (two operations a multiply-add), whatever computes
it, so a later change that replaces a library call by a hand-written
kernel keeps the same count. Element-wise work (norms, activations,
softmax) is left out: it is a few percent of the products.
"""

from __future__ import annotations

from benchmark.reference.network import Shape

# Dense peaks of the card (NVIDIA's H100 SXM data sheet, at the 700 W
# limit), by `torch.cuda.get_device_name()`.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                              "fp32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def _conv(cin, cout, k, h_out, w_out):
    return 2 * cin * cout * k * k * h_out * w_out


def _resize(c, h, w, ho, wo):
    # align-corners resize as two products: rows, then columns
    return 2 * c * ho * h * w + 2 * c * ho * wo * w


def encoder(s: Shape, batch: int, h: int, w: int) -> int:
    n = (h // s.patch_size) * (w // s.patch_size)
    c = s.enc_embed_dim
    embed = 2 * n * 3 * s.patch_size ** 2 * c
    block = 24 * n * c * c + 4 * n * n * c
    return batch * (embed + s.enc_depth * block)


def decoder(s: Shape, batch: int, n1: int, n2: int) -> int:
    c, ce = s.dec_embed_dim, s.enc_embed_dim
    embed = 2 * (n1 + n2) * ce * c

    def view(nq, nk):
        self_attn = 8 * nq * c * c + 4 * nq * nq * c
        cross = 4 * nq * c * c + 4 * nk * c * c + 4 * nq * nk * c
        return self_attn + cross + 16 * nq * c * c

    return batch * (embed + s.dec_depth * (view(n1, n2) + view(n2, n1)))


def dpt(s: Shape, h: int, w: int, channels: int) -> int:
    p, ld, f = s.patch_size, s.head_layer_dims, s.head_feature_dim
    toks = (s.enc_embed_dim,) + (s.dec_embed_dim,) * 3
    nh, nw = h // p, w // p
    ops = _conv(toks[0], ld[0], 1, nh, nw) + _conv(ld[0], ld[0], 4, nh, nw)
    ops += _conv(toks[1], ld[1], 1, nh, nw) + _conv(ld[1], ld[1], 2, nh, nw)
    ops += _conv(toks[2], ld[2], 1, nh, nw)
    h4, w4 = (nh + 1) // 2, (nw + 1) // 2
    ops += _conv(toks[3], ld[3], 1, nh, nw) + _conv(ld[3], ld[3], 3, h4, w4)
    scales = [(4 * nh, 4 * nw), (2 * nh, 2 * nw), (nh, nw), (h4, w4)]
    for k, (a, b) in enumerate(scales):
        ops += _conv(ld[k], f, 3, a, b)
    rcu = 2 * _conv(f, f, 3, 1, 1)
    # refinenet4 at 1/32 (one unit), then 3, 2, 1 (two units each)
    for k, (a, b) in enumerate(reversed(scales)):
        if k == 1:
            a, b = nh, nw  # path 4 cropped to layer 3's shape
        units = 1 if k == 0 else 2
        ops += units * rcu * a * b
        ops += _resize(f, a, b, 2 * a, 2 * b) + _conv(f, f, 1, 2 * a, 2 * b)
    a, b = 8 * nh, 8 * nw
    ops += _conv(f, f // 2, 3, a, b) + _resize(f // 2, a, b, h, w)
    ops += _conv(f // 2, s.head_last_dim, 3, h, w)
    ops += _conv(s.head_last_dim, channels, 1, h, w)
    return ops


def local_features(s: Shape, h: int, w: int) -> int:
    n = (h // s.patch_size) * (w // s.patch_size)
    c = s.enc_embed_dim + s.dec_embed_dim
    out = (s.local_feat_dim + 1) * s.patch_size ** 2
    return 2 * n * c * 4 * c + 2 * n * 4 * c * out


def head(s: Shape, batch: int, h: int, w: int, mode: str) -> int:
    ops = 0
    if mode in ("tracking", "full"):
        ops += dpt(s, h, w, 4) + local_features(s, h, w)
    if mode in ("gaussian_only", "full"):
        ops += dpt(s, h, w, 3 + 3 + 4 + 3 * s.sh_degree + 1)
    return batch * ops
