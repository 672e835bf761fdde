"""Plain PyTorch forward of MASt3R's two-view network with Splatt3R's heads.

MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric (naver/mast3r): a ViT-L
encoder (patch 16, RoPE2D at frequency 100), the CroCo dual decoder (two
stacks of self-attention, cross-attention and MLP blocks), and on each view
a DPT head (hooks: encoder output, decoder blocks 6 and 9, the normed last
block) beside the "catmlp" local-feature MLP; Splatt3R (btsmart/splatt3r)
adds a second DPT that predicts the gaussian parameters. The activations
are MASt3R's: points `dir * expm1(|x|)`, confidences `1 + exp(x)`, unit
descriptors; Splatt3R's: `exp` scales, unit quaternions, sigmoid
opacities.

The parameter names are the checkpoints' (`enc_blocks.0.attn.qkv.weight`,
`downstream_head1.dpt.scratch.refinenet4.out_conv.weight`, ...), so one
state dict fills this module and the program under test alike. Nothing here
imports the program.

Precision. `Network(shape, trunk="fp32", heads="fp32")` computes every
product in float32 (TF32 must be off: `reference.precise()`), which is the
reference. The two precisions take one of:
- "fp32": operands and results in float32;
- "bf16": operands rounded to bfloat16, products in bfloat16 as a bfloat16
  GEMM gives them (float32 accumulation), the trunk's residual stream in
  bfloat16; this is a plain bfloat16 forward;
- "fp8": operands quantized to float8 e4m3 with one scale a tensor (its
  largest magnitude onto 448), products accumulated in float32 and rounded
  to bfloat16, as an fp8 GEMM gives them; the lower-precision control.
Whatever the precision, layer norms and softmax run in float32, the patch
embedding and `decoder_embed` in float32 and the heads' last 1x1
projection in float32, where the program keeps them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

PRECISIONS = ("fp32", "bf16", "fp8")
_E4M3_MAX = 448.0


class Shape(NamedTuple):
    """The network's widths and depths (a configuration file's `model`)."""

    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    patch_size: int = 16
    local_feat_dim: int = 24
    sh_degree: int = 1
    head_feature_dim: int = 256
    head_layer_dims: tuple = (96, 192, 384, 768)
    head_last_dim: int = 128
    rope_freq: float = 100.0

    @classmethod
    def from_dict(cls, d: dict) -> "Shape":
        kw = {k: d[k] for k in cls._fields if k in d}
        if "head_layer_dims" in kw:
            kw["head_layer_dims"] = tuple(kw["head_layer_dims"])
        return cls(**kw)


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x's operand in `prec`, returned in the dtype the product runs in."""
    if prec == "fp32":
        return x.float()
    if prec == "bf16":
        return x.to(torch.bfloat16)
    if prec == "fp8":
        x = x.float()
        amax = x.abs().amax().clamp(min=1e-30)
        scale = amax / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision {prec!r} is not one of {PRECISIONS}")


def _out(y: torch.Tensor, prec: str) -> torch.Tensor:
    return y.float() if prec == "fp32" else y.to(torch.bfloat16)


def linear(x, w, b, prec: str):
    y = F.linear(_round(x, prec), _round(w, prec),
                 None if b is None else _round(b, prec))
    return _out(y, prec)


def conv2d(x, w, b, prec: str, stride=1, padding=0):
    y = F.conv2d(_round(x, prec), _round(w, prec),
                 None if b is None else _round(b, prec), stride, padding)
    return _out(y, prec)


def conv_transpose2d(x, w, b, prec: str, stride):
    y = F.conv_transpose2d(_round(x, prec), _round(w, prec),
                           None if b is None else _round(b, prec), stride)
    return _out(y, prec)


def layer_norm(x, ln: nn.LayerNorm):
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), 1e-6)


def rope_tables(pos, head_dim: int, freq: float):
    """cos, sin (B, N, 2, head_dim/2) at integer (y, x) token positions."""
    d4 = head_dim // 4
    inv = 1.0 / (freq ** (torch.arange(0, d4, dtype=torch.float32,
                                       device=pos.device) / d4))
    ang = pos[..., None].float() * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def rope(t, cos, sin):
    """RoPE2D on (B, N, H, D): y on the first half of each head, x on the
    second, in the dtype of `t`."""
    dt = t.dtype
    ty, tx = t.chunk(2, dim=-1)
    cy, sy = cos[:, :, None, 0].to(dt), sin[:, :, None, 0].to(dt)
    cx, sx = cos[:, :, None, 1].to(dt), sin[:, :, None, 1].to(dt)
    return torch.cat([ty * cy + _rotate_half(ty) * sy,
                      tx * cx + _rotate_half(tx) * sx], dim=-1)


def attention(q, k, v, prec: str):
    """Softmax attention on (B, N, H, D): scores and weights in float32,
    the two products on operands in `prec`."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", _round(q, prec).float(),
                     _round(k, prec).float()) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", _round(p, prec).float(),
                     _round(v, prec).float())
    return _out(o, prec)


def _lin(m: nn.Module):
    return m.weight, m.bias


class _Linear(nn.Module):
    def __init__(self, i, o, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None


class _Conv(nn.Module):
    def __init__(self, i, o, k, bias=True, transposed=False):
        super().__init__()
        shape = (i, o, k, k) if transposed else (o, i, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None


def _ln(d):
    return nn.LayerNorm(d, eps=1e-6)


class _Attn(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.qkv = _Linear(d, 3 * d)
        self.proj = _Linear(d, d)


class _Cross(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.projq, self.projk = _Linear(d, d), _Linear(d, d)
        self.projv, self.proj = _Linear(d, d), _Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, d, hidden, out):
        super().__init__()
        self.fc1, self.fc2 = _Linear(d, hidden), _Linear(hidden, out)


class _EncBlock(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.norm1, self.attn = _ln(d), _Attn(d)
        self.norm2, self.mlp = _ln(d), _Mlp(d, 4 * d, d)


class _DecBlock(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.norm1, self.attn = _ln(d), _Attn(d)
        self.cross_attn = _Cross(d)
        self.norm2, self.norm3, self.norm_y = _ln(d), _ln(d), _ln(d)
        self.mlp = _Mlp(d, 4 * d, d)


class _PatchEmbed(nn.Module):
    def __init__(self, p, d):
        super().__init__()
        self.proj = _Conv(3, d, p)


class _RCU(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1, self.conv2 = _Conv(f, f, 3), _Conv(f, f, 3)


class _Fusion(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.resConfUnit1, self.resConfUnit2 = _RCU(f), _RCU(f)
        self.out_conv = _Conv(f, f, 1)


class _Scratch(nn.Module):
    def __init__(self, ld, f):
        super().__init__()
        for k in range(4):
            setattr(self, f"layer{k + 1}_rn", _Conv(ld[k], f, 3, bias=False))
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", _Fusion(f))


class _DPT(nn.Module):
    def __init__(self, ch, toks, ld, f, last):
        super().__init__()
        self.act_postprocess = nn.ModuleList([
            nn.ModuleList([_Conv(toks[0], ld[0], 1),
                           _Conv(ld[0], ld[0], 4, transposed=True)]),
            nn.ModuleList([_Conv(toks[1], ld[1], 1),
                           _Conv(ld[1], ld[1], 2, transposed=True)]),
            nn.ModuleList([_Conv(toks[2], ld[2], 1)]),
            nn.ModuleList([_Conv(toks[3], ld[3], 1),
                           _Conv(ld[3], ld[3], 3)]),
        ])
        self.scratch = _Scratch(ld, f)
        self.head = nn.ModuleDict({"0": _Conv(f, f // 2, 3),
                                   "2": _Conv(f // 2, last, 3),
                                   "4": _Conv(last, ch, 1)})


class _GaussianDPT(nn.Module):
    def __init__(self, dpt):
        super().__init__()
        self.dpt = dpt


class _Head(nn.Module):
    def __init__(self, s: Shape):
        super().__init__()
        toks = (s.enc_embed_dim,) + (s.dec_embed_dim,) * 3
        kw = (toks, s.head_layer_dims, s.head_feature_dim, s.head_last_dim)
        self.dpt = _DPT(4, *kw)
        c = s.enc_embed_dim + s.dec_embed_dim
        self.head_local_features = _Mlp(
            c, 4 * c, (s.local_feat_dim + 1) * s.patch_size ** 2)
        self.gaussian_dpt = _GaussianDPT(
            _DPT(3 + 3 + 4 + 3 * s.sh_degree + 1, *kw))


def _interp(n_in: int, n_out: int, device):
    """(n_out, n_in) align-corners linear interpolation matrix."""
    if n_out == 1 or n_in == 1:
        return torch.full((n_out, n_in), 1.0 / n_in, device=device)
    src = (torch.arange(n_out, dtype=torch.float32, device=device)
           * (n_in - 1) / (n_out - 1))
    i0 = torch.clamp(torch.floor(src).long(), 0, n_in - 2)
    frac = src - i0
    A = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    r = torch.arange(n_out, device=device)
    A[r, i0] = 1.0 - frac
    A[r, i0 + 1] += frac
    return A


def resize_ac(x, out_hw):
    """Align-corners bilinear resize of (B, C, H, W), in float32."""
    Ah = _interp(x.shape[-2], out_hw[0], x.device)
    Aw = _interp(x.shape[-1], out_hw[1], x.device)
    return torch.einsum("ph,bchw,qw->bcpq", Ah, x.float(), Aw)


def pixel_shuffle_nhwc(x, r: int):
    B, H, W, CRR = x.shape
    C = CRR // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)


class Network(nn.Module):
    """The reference network. `trunk` and `heads` are precisions of
    `PRECISIONS`; the reference is ("fp32", "fp32")."""

    def __init__(self, shape: Shape, trunk: str = "fp32",
                 heads: str = "fp32"):
        super().__init__()
        for p in (trunk, heads):
            if p not in PRECISIONS:
                raise ValueError(f"precision {p!r} not in {PRECISIONS}")
        self.shape, self.trunk, self.heads = shape, trunk, heads
        s = shape
        self.patch_embed = _PatchEmbed(s.patch_size, s.enc_embed_dim)
        self.enc_blocks = nn.ModuleList(
            [_EncBlock(s.enc_embed_dim) for _ in range(s.enc_depth)])
        self.enc_norm = _ln(s.enc_embed_dim)
        self.decoder_embed = _Linear(s.enc_embed_dim, s.dec_embed_dim)
        self.dec_blocks = nn.ModuleList(
            [_DecBlock(s.dec_embed_dim) for _ in range(s.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [_DecBlock(s.dec_embed_dim) for _ in range(s.dec_depth)])
        self.dec_norm = _ln(s.dec_embed_dim)
        self.downstream_head1 = _Head(s)
        self.downstream_head2 = _Head(s)

    def with_precision(self, trunk: str, heads: str) -> "Network":
        """A view of this network (the same parameters) in other
        precisions."""
        other = Network.__new__(Network)
        nn.Module.__init__(other)
        other.__dict__.update(self.__dict__)
        other.trunk, other.heads = trunk, heads
        return other

    # -- trunk -------------------------------------------------------------
    def _stream(self):
        return torch.float32 if self.trunk == "fp32" else torch.bfloat16

    def _self_attn(self, m: _Attn, x, cs, heads: int):
        B, N, C = x.shape
        qkv = linear(x, *_lin(m.qkv), self.trunk).reshape(B, N, 3, heads, -1)
        q, k, v = qkv.unbind(2)
        q, k = rope(q, *cs), rope(k, *cs)
        o = attention(q, k, v, self.trunk).reshape(B, N, C)
        return linear(o, *_lin(m.proj), self.trunk)

    def _cross_attn(self, m: _Cross, x, y, xcs, ycs, heads: int):
        B, N, C = x.shape
        q = linear(x, *_lin(m.projq), self.trunk).reshape(B, N, heads, -1)
        k = linear(y, *_lin(m.projk), self.trunk).reshape(
            B, y.shape[1], heads, -1)
        v = linear(y, *_lin(m.projv), self.trunk).reshape(
            B, y.shape[1], heads, -1)
        q, k = rope(q, *xcs), rope(k, *ycs)
        o = attention(q, k, v, self.trunk).reshape(B, N, C)
        return linear(o, *_lin(m.proj), self.trunk)

    def _mlp(self, m: _Mlp, x, prec):
        h = F.gelu(linear(x, *_lin(m.fc1), prec), approximate="none")
        return linear(h, *_lin(m.fc2), prec)

    def encode(self, img):
        """img (B, H, W, 3) NHWC in [-1, 1] → (tokens (B, N, C) float32,
        pos (B, N, 2))."""
        s = self.shape
        B, H, W, _ = img.shape
        p = s.patch_size
        w, b = _lin(self.patch_embed.proj)
        x = F.conv2d(img.permute(0, 3, 1, 2).float(), w.float(), b.float(),
                     stride=p)
        gh, gw = H // p, W // p
        x = x.flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(gh, device=img.device),
                                torch.arange(gw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], -1).reshape(1, gh * gw, 2).expand(
            B, gh * gw, 2)
        cs = rope_tables(pos, s.enc_embed_dim // s.enc_num_heads,
                         s.rope_freq)
        x = x.to(self._stream())
        for blk in self.enc_blocks:
            x = x + self._self_attn(blk.attn, layer_norm(x, blk.norm1), cs,
                                    s.enc_num_heads).to(x.dtype)
            x = x + self._mlp(blk.mlp, layer_norm(x, blk.norm2),
                              self.trunk).to(x.dtype)
        return layer_norm(x, self.enc_norm), pos

    def _dec_block(self, blk: _DecBlock, x, y, xcs, ycs):
        h = self.shape.dec_num_heads
        x = x + self._self_attn(blk.attn, layer_norm(x, blk.norm1), xcs,
                                h).to(x.dtype)
        y_ = layer_norm(y, blk.norm_y)
        x = x + self._cross_attn(blk.cross_attn, layer_norm(x, blk.norm2),
                                 y_, xcs, ycs, h).to(x.dtype)
        return x + self._mlp(blk.mlp, layer_norm(x, blk.norm3),
                             self.trunk).to(x.dtype)

    def decode(self, f1, pos1, f2, pos2):
        """The dual decoder → per-view hook lists [f, block 6, block 9, the
        normed last block], float32."""
        s = self.shape
        hd = s.dec_embed_dim // s.dec_num_heads
        cs1 = rope_tables(pos1, hd, s.rope_freq)
        cs2 = rope_tables(pos2, hd, s.rope_freq)
        w, b = _lin(self.decoder_embed)
        x1 = F.linear(f1.float(), w.float(), b.float()).to(self._stream())
        x2 = F.linear(f2.float(), w.float(), b.float()).to(self._stream())
        h6, h9 = s.dec_depth // 2 - 1, 3 * s.dec_depth // 4 - 1
        keep1, keep2 = {}, {}
        for i, (b1, b2) in enumerate(zip(self.dec_blocks, self.dec_blocks2)):
            x1, x2 = (self._dec_block(b1, x1, x2, cs1, cs2),
                      self._dec_block(b2, x2, x1, cs2, cs1))
            if i in (h6, h9):
                keep1[i], keep2[i] = x1.float(), x2.float()
        return ([f1.float(), keep1[h6], keep1[h9],
                 layer_norm(x1, self.dec_norm)],
                [f2.float(), keep2[h6], keep2[h9],
                 layer_norm(x2, self.dec_norm)])

    # -- heads -------------------------------------------------------------
    def _rcu(self, m: _RCU, x):
        hp = self.heads
        out = conv2d(F.relu(x), *_lin(m.conv1), hp, padding=1)
        out = conv2d(F.relu(out), *_lin(m.conv2), hp, padding=1)
        return out.float() + x

    def _fusion(self, m: _Fusion, x, res=None):
        x = x.float()
        if res is not None:
            x = x + self._rcu(m.resConfUnit1, res.float())
        x = self._rcu(m.resConfUnit2, x)
        x = resize_ac(x, (2 * x.shape[-2], 2 * x.shape[-1]))
        return conv2d(x, *_lin(m.out_conv), self.heads)

    def dpt(self, m: _DPT, hooks, image_size):
        """DPT on the four hooks → (B, H, W, channels) float32."""
        H, W = image_size
        p, hp = self.shape.patch_size, self.heads
        nh, nw = H // p, W // p
        layers = []
        for t, mods in zip(hooks, m.act_postprocess):
            f = t.transpose(1, 2).reshape(t.shape[0], -1, nh, nw)
            f = conv2d(f, *_lin(mods[0]), hp)
            if len(mods) > 1:
                w, b = _lin(mods[1])
                if w.shape[-1] == 3:  # the 3x3 stride-2 conv of hook 4
                    f = conv2d(f, w, b, hp, stride=2, padding=1)
                else:
                    f = conv_transpose2d(f, w, b, hp, stride=w.shape[-1])
            layers.append(f)
        s = m.scratch
        rn = [conv2d(l, getattr(s, f"layer{i + 1}_rn").weight, None, hp,
                     padding=1) for i, l in enumerate(layers)]
        p4 = self._fusion(s.refinenet4, rn[3])
        p4 = p4[:, :, : rn[2].shape[2], : rn[2].shape[3]]
        p3 = self._fusion(s.refinenet3, p4, rn[2])
        p2 = self._fusion(s.refinenet2, p3, rn[1])
        p1 = self._fusion(s.refinenet1, p2, rn[0])
        x = conv2d(p1, *_lin(m.head["0"]), hp, padding=1)
        x = _out(resize_ac(x, (H, W)), hp)
        x = F.relu(conv2d(x, *_lin(m.head["2"]), hp, padding=1))
        w, b = _lin(m.head["4"])
        x = F.conv2d(x.float(), w.float(), b.float())
        return x.permute(0, 2, 3, 1)

    def head(self, num: int, hooks, image_size, mode: str = "tracking"):
        """The heads of view `num` on its hooks. mode "tracking": pts3d,
        conf, desc, desc_conf; "gaussian_only": offset_raw, scales,
        rotations, sh, opacities; "full": both, and means."""
        m = self.downstream_head1 if num == 1 else self.downstream_head2
        s = self.shape
        H, W = image_size
        out = {}
        if mode in ("tracking", "full"):
            pts = self.dpt(m.dpt, hooks, image_size)
            cat = torch.cat([hooks[0].float(), hooks[-1].float()], -1)
            h = self._mlp(m.head_local_features, cat, self.heads)
            B, p = h.shape[0], s.patch_size
            local = pixel_shuffle_nhwc(h.reshape(B, H // p, W // p, -1),
                                       p).float()
            xyz = pts[..., :3]
            d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
            out["pts3d"] = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
            out["conf"] = 1.0 + torch.exp(pts[..., 3])
            desc = local[..., : s.local_feat_dim]
            out["desc"] = desc / torch.linalg.norm(desc, dim=-1,
                                                   keepdim=True)
            out["desc_conf"] = 1.0 + torch.exp(local[..., s.local_feat_dim])
        if mode in ("gaussian_only", "full"):
            g = self.dpt(m.gaussian_dpt.dpt, hooks, image_size)
            n_sh = 3 * s.sh_degree
            off, sc, rot, sh, op = torch.split(g, [3, 3, 4, n_sh, 1], -1)
            out["offset_raw"] = off
            out["scales"] = torch.exp(sc)
            out["rotations"] = rot / (torch.linalg.norm(rot, dim=-1,
                                                        keepdim=True) + 1e-8)
            out["sh"] = sh.reshape(sh.shape[:-1] + (3, s.sh_degree))
            out["opacities"] = torch.sigmoid(op)
        if mode == "full":
            out["means"] = out["pts3d"]
        return out


def state_shapes(shape: Shape) -> dict:
    """{name: (shape, kind)} of every parameter, kind "ln" (layer-norm
    scale), "bias" or "weight", built on the meta device."""
    with torch.device("meta"):
        net = Network(shape)
    out = {}
    for mname, mod in net.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(mod, nn.LayerNorm):
                kind = "ln" if pname == "weight" else "bias"
            else:
                kind = "bias" if pname == "bias" else "weight"
            out[name] = (tuple(p.shape), kind)
    return out


def fan_in(shape) -> int:
    return math.prod(shape[1:]) or 1
