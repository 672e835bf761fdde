"""Drawing and resampling on uint8 / float32 numpy images, without cv2.

The viewer and the web demo of the JAX package draw and resample with
OpenCV, which the port's GPU host does not have. This module holds what
they use, each written to give cv2's pixels where that is cheap:

- `line` (cv2.line with LINE_8 and thickness 1: cv2's integer clipping to
  the image, then Bresenham's steps) and `rectangle` (the outline,
  thickness 1);
- `resize_linear_u8` (cv2.resize INTER_LINEAR on uint8: 11-bit
  fixed-point weights, a horizontal then a vertical pass, the vertical
  one rounded as cv2's vectorised loop rounds it) and `resize_area`
  (cv2.resize INTER_AREA on float32);
- `put_text`, a bitmap font of the port's own: the 95 printable ASCII
  glyphs rasterized once from OpenCV's Hershey simplex font at scale 0.5
  and thickness 1, kept as data with their advances, drawn at other
  scales by nearest neighbour;
- `TURBO`, the 256x3 uint8 RGB table of cv2.COLORMAP_TURBO, kept as data.
"""

from __future__ import annotations

import numpy as np

_TURBO_HEX = (
    "30123b32154333184a341b51351e5836215f37246638276d392a733a2d793b2f803c3286"
    "3d358b3e38913f3b973f3e9c4040a24143a74146ac4249b1424bb5434eba4451bf4454c3"
    "4456c74559cb455ccf455ed34661d64664da4666dd4669e0466be3476ee64771e94773eb"
    "4776ee4778f0477bf2467df44680f64682f84685fa4687fb458afc458cfd448ffe4391fe"
    "4294ff4196ff4099ff3e9bfe3d9efe3ba0fd3aa3fc38a5fb37a8fa35abf833adf731aff5"
    "2fb2f42eb4f22cb7f02ab9ee28bceb27bee925c0e723c3e422c5e220c7df1fc9dd1ecbda"
    "1ccdd81bd0d51ad2d21ad4d019d5cd18d7ca18d9c818dbc518ddc218dec018e0bd19e2bb"
    "19e3b91ae4b61ce6b41de7b21fe9af20eaac22ebaa25eca727eea42aefa12cf09e2ff19b"
    "32f29835f39438f4913cf58e3ff68a43f78746f8844af8804ef97d52fa7a55fa7659fb73"
    "5dfc6f61fc6c65fd6969fd666dfe6271fe5f75fe5c79fe597dff5680ff5384ff5188ff4e"
    "8bff4b8fff4992ff4796fe4499fe429cfe409ffd3fa1fd3da4fc3ca7fc3aa9fb39acfb38"
    "affa37b1f936b4f836b7f735b9f635bcf534bef434c1f334c3f134c6f034c8ef34cbed34"
    "cdec34d0ea34d2e935d4e735d7e535d9e436dbe236dde037dfdf37e1dd37e3db38e5d938"
    "e7d739e9d539ebd339ecd13aeecf3aefcd3af1cb3af2c93af4c73af5c53af6c33af7c13a"
    "f8be39f9bc39faba39fbb838fbb637fcb336fcb136fdae35fdac34fea933fea732fea431"
    "fea130fe9e2ffe9b2dfe992cfe962bfe932afe9029fd8d27fd8a26fc8725fc8423fb8122"
    "fb7e21fa7b1ff9781ef9751df8721cf76f1af66c19f56918f46617f36315f26014f15d13"
    "f05b12ef5811ed5510ec530feb500eea4e0de84b0ce7490ce5470be4450ae2430ae14109"
    "df3f08dd3d08dc3b07da3907d83706d63506d43305d23105d02f05ce2d04cc2b04ca2a04"
    "c82803c52603c32503c12302be2102bc2002b91e02b71d02b41b01b21a01af1801ac1701"
    "a91601a71401a41301a112019e10019b0f01980e01950d01920b018e0a018b0902880802"
    "8507028106027e05027a0403"
)
_GLYPHS_HEX = (
    "30000000000000000000000000000000000000000000000000000000000000000000000000",
    "30000000000000300030003000300030003000300030003000300030000000000000000000",
    "500000000000007c007c007c003c0000000000000000000000000000000000000000000000",
    "a000000000000000000dc00dc03fe03fe01d801d807fe07fe01b801b000000000000000000",
    "90000000000e001f003f8033c071c03c003f800fc001c071c07fc03f800e000e0000000000",
    "b00000000000003c707ce06ee06fc07f803fe007f00fb01db039b039f00040000000000000",
    "a00000000000001f003f003b803b803f001e603f6077e073c03fe03fe00c00000000000000",
    "30000000000000700070007000300000000000000000000000000000000000000000000000",
    "900000030007000f000c000c001c001c001c001c001c000c000c000e000f00070000000000",
    "90000018001e000e0006000700070007000300030007000700070006001e001c0000000000",
    "600000000000001c007e007e003e003e000000000000000000000000000000000000000000",
    "90000000000000000000000600060006007fc07fc07fc00600060006000000000000000000",
    "30000000000000000000000000000000000000000000000000300070007000600000000000",
    "70000000000000000000000000000000003f003f003f000000000000000000000000000000",
    "30000000000000000000000000000000000000000000000000300030000000000000000000",
    "700000000003000700070006000e000c001c001c0018003800300070007000600000000000",
    "900000000000001f003f803bc077c077c077c07dc07dc07dc03f803f800e00000000000000",
    "900000000000000e001e003e003e00060006000600060006003fc03fc00000000000000000",
    "900000000000001f003f803b8031c0038007800f001e003c003fc07fc00000000000000000",
    "900000000000003f803f80078007000e001f800fc001c071c07fc03f800e00000000000000",
    "90000000000000078007800f801f801f803b8073807fc07fc0038003800000000000000000",
    "900000000000003f803f80380030003f003f8031c021c071c03f803f800e00000000000000",
    "9000000000000007000f000e001c003f803fc071c071c071c03fc01f800600000000000000",
    "900000000000003fc03fc0018003800380070007000e000e000c001c000000000000000000",
    "900000000000001f003f8039c031c03f803f803fc071c071c07fc03f800e00000000000000",
    "900000000000001f003f807bc071c071c07bc03f801f000f000e001c000000000000000000",
    "30000000000000000000000000000030003000000000000000300030000000000000000000",
    "40000000000000000000000000000030003000000000000000300030007000200000000000",
    "700000000000000000000007000f003e007c0070007c001e000f0003000000000000000000",
    "8000000000000000000000000000003f803f8000003f803f80000000000000000000000000",
    "7000000000000000000000300038003e000f0007000f003e00380030000000000000000000",
    "700000000000001f003f807380738007800f000e000c000c000c000c000000000000000000",
    "c000000000000000000fe03ff03bf837f87fd86cd86cd87ff837f038301ff00fe000000000",
    "a00000000000000f000f000f001f801f80198039c03fc07fe070e060600000000000000000",
    "a00000000000003f803fc031c030c03fc03fc03fc030e030e03fc03fc00000000000000000",
    "900000000000001f803fc039e030e070407000700070e038e03fc01fc00600000000000000",
    "a00000000000003f803fc033c030e030e030e030e030e030e03fc03fc00000000000000000",
    "900000000000003fc03fc03000300030003f803f80300030003fc03fc00000000000000000",
    "800000000000003fc03fc03000300030003f803f8030003000300030000000000000000000",
    "a00000000000001f803fc039e030e0700073e073e070e038e03fc01f800600000000000000",
    "a000000000000030e030e030e030e030e03fe03fe030e030e030e030e00000000000000000",
    "40000000000000300030003000300030003000300030003000300030000000000000000000",
    "900000000000003fc03fc001c001c001c001c001c071c071c07f803f800c00000000000000",
    "9000000000000031c033c037803f003e003c003e003f00378033c031c00000000000000000",
    "800000000000003000300030003000300030003000300030003fc03fc00000000000000000",
    "b00000000000003030387038f03cf03df03ff037b037b03330303030300000000000000000",
    "a000000000000030e038e03ce03ce03ee03fe037e033e033e031e030e00000000000000000",
    "a00000000000001f803fc039c030e070e070e070e070e038c03fc01f800600000000000000",
    "900000000000003f803fc031c030e030c03fc03f8030003000300030000000000000000000",
    "a00000000000001f803fc039c030e070e070e070e070e038e03fc01fc006e0000000000000",
    "900000000000003f003fc031c030c031c03fc03f80338031c031c030e00000000000000000",
    "900000000000001f003f803bc071c03c003f800fc001c071c07fc03f800e00000000000000",
    "800000000000007fc07fc00e000e000e000e000e000e000e000e000e000000000000000000",
    "a000000000000030e030e030e030e030e030e030e030e038e03fc01fc00600000000000000",
    "9000000000000060e070e070c039c039c039801f801f801f000f000f000000000000000000",
    "b0000000000000703870387338333037b03ff03ff03ff01ce01ce01ce00000000000000000",
    "9000000000000070c071c03bc01f801f000f001f001f803b8079c070e00000000000000000",
    "9000000000000070e070e039c03b801f801f000f0006000600060006000000000000000000",
    "800000000000007fc07fc003c0078007000e001e003c0038007fc07fc00000000000000000",
    "40000000003c003c00300030003000300030003000300030003000300030003c003c000000",
    "70000000006000700070003800380018001c000c000e000e00060007000300030000000000",
    "40000000007800780018001800180018001800180018001800180018001800780078000000",
    "600000000000001c003e003600000000000000000000000000000000000000000000000000",
    "b000000000000000000000000000000000000000000000000000007ff07ff0000000000000",
    "5000000000000038003c000800000000000000000000000000000000000000000000000000",
    "800000000000000000000000003f003f8033801f803f8073807f807f801c00000000000000",
    "800000000000003000300030003f803f8039c031c031c031c03f803f800600000000000000",
    "800000000000000000000000003f003f8073807000700073803f803f000e00000000000000",
    "800000000000000180018001803f803f8073807180718073803f803f800c00000000000000",
    "800000000000000000000000001f003f8073807f807f8071803f803f000e00000000000000",
    "500000000006001e003e0038007e007e003800380038003800380038000000000000000000",
    "800000000000000000000000003f803f8073807180718073803f803f807d807b803f801e00",
    "900000000000003000300030003f803f80398031c031c031c031c031c00000000000000000",
    "30000000000000700070000000300030003000300030003000300030000000000000000000",
    "30000000000000300030000000300030003000300030003000300030003000f000f0000000",
    "7000000000000030003000300037803f003e003c003c003e00370033800000000000000000",
    "30000000000000300030003000300030003000300030003000300030000000000000000000",
    "d00000000000000000000000003ff83ff8339c339c319c319c319c319c0000000000000000",
    "900000000000000000000000003f803f80398031c031c031c031c031c00000000000000000",
    "800000000000000000000000003f003f8073807180718073803f803f000c00000000000000",
    "800000000000000000000000003f803f8039c031c031c031c03f803f803600300030000000",
    "800000000000000000000000003f803f8073807180718071803f803f800d80018001800000",
    "500000000000000000000000003e003e003000300030003000300030000000000000000000",
    "700000000000000000000000003f007f0073003e003f0007007f003f001c00000000000000",
    "500000000000003800380038007e007e0038003800380038003e001e000000000000000000",
    "900000000000000000000000003180318031803180318031803f803f800c00000000000000",
    "800000000000000000000000007180738033803b003f001f001e000e000000000000000000",
    "c0000000000000000000000000633877b837b037b03ff03ff01ce01ce00000000000000000",
    "8000000000000000000000000073807f803f001e001e003f007f8073800000000000000000",
    "800000000000000000000000007180738033803b003f001e001e000e001c001c0018000000",
    "700000000000000000000000007f007f000f001e001c0038007f007f800000000000000000",
    "50000000001e001e0038003800380038007000700070003800380038003c001e000e000000",
    "30300030003000300030003000300030003000300030003000300030003000300030003000",
    "50000000007000780038001800180018001c000e001c001800180018003800780070000000",
    "80000000000000000000000000000000003d803f803f000000000000000000000000000000",
)

TURBO = np.frombuffer(bytes.fromhex("".join(_TURBO_HEX)),
                      np.uint8).reshape(256, 3)

# each glyph: its advance in 1/16 px (two hex digits), then 18 rows of 16
# columns (four hex digits a row); row 14 is the row below the baseline's
# and column 1 the pen's column
_CELL_H, _CELL_W, _ASCENT, _PEN_X = 18, 16, 14, 1
_FONT_SCALE = 0.5


def _glyphs():
    out = {}
    for i, g in enumerate(_GLYPHS_HEX):
        rows = [int(g[2 + 4 * r: 6 + 4 * r], 16) for r in range(_CELL_H)]
        bits = np.array([[(v >> (15 - c)) & 1 for c in range(_CELL_W)]
                         for v in rows], bool)
        out[chr(32 + i)] = (int(g[:2], 16) / 16, bits)
    return out


_FONT = _glyphs()


def _clip(p0, p1, w, h):
    """cv2's clipLine: the segment's end points moved onto the image's
    border in integer arithmetic (each step truncated toward zero, the
    second point's from the first point's moved position) → the clipped
    (x, y) end points, or None if the segment misses the image."""
    (x1, y1), (x2, y2) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    right, bottom = w - 1, h - 1

    def code(x, y, ys=True):
        return (x < 0) + (x > right) * 2 + ((y < 0) * 4 + (y > bottom) * 8
                                            if ys else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, code(x1, 0, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, code(x2, 0, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def line(img, p0, p1, color):
    """Draw the segment p0-p1 ((x, y) integer points) in place as
    cv2.line(img, p0, p1, color, 1) draws it with LINE_8: clipped to the
    image as cv2 clips it, then Bresenham's steps from the left end point,
    one pixel per step along the major axis (computed in closed form:
    after k steps the minor axis has moved ceil((2·dy·k − dx) / (2·dx))).
    Returns img."""
    h, w = img.shape[:2]
    seg = _clip(p0, p1, w, h)
    if seg is None:
        return img
    (x1, y1), (x2, y2) = seg
    if x2 < x1:  # cv2 draws left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    k = np.arange(dx + 1)
    m = -((dx - 2 * dy * k) // (2 * dx)) if dx else k
    xs, ys = (x1 + m, y1 + sy * k) if steep else (x1 + k, y1 + sy * m)
    img[ys, xs] = color
    return img


def rectangle(img, p0, p1, color):
    """The outline of the rectangle with corners p0, p1, one pixel thick,
    in place (cv2.rectangle with thickness 1). Returns img."""
    (x0, y0), (x1, y1) = p0, p1
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                 ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        line(img, a, b, color)
    return img


def put_text(img, text, org, scale, color):
    """Draw `text` with its baseline's left end at org (x, y), in place, in
    the port's bitmap font at `scale` (cv2.putText's fontScale for the
    Hershey simplex font). Characters outside printable ASCII draw as '?'.
    Returns img."""
    h, w = img.shape[:2]
    k = scale / _FONT_SCALE
    ch = max(1, int(round(_CELL_H * k)))
    cw = max(1, int(round(_CELL_W * k)))
    rows = np.minimum((np.arange(ch) / k).astype(np.int64), _CELL_H - 1)
    cols = np.minimum((np.arange(cw) / k).astype(np.int64), _CELL_W - 1)
    x = int(org[0]) - _PEN_X * k
    top = int(org[1]) - int(round(_ASCENT * k))
    for c in text:
        adv, bits = _FONT.get(c, _FONT["?"])
        ys, xs = np.nonzero(bits[rows][:, cols])
        ys, xs = ys + top, xs + int(round(x))
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color
        x += adv * k
    return img


def _linear_taps(n_out, n_src):
    """cv2's INTER_LINEAR source index and fractional weight per output
    sample along one axis (half-pixel centres; edges clamped)."""
    scale = n_src / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(np.float32)).astype(np.float32)
    return i, f


def _fixed(f):
    """cv2's 11-bit weights (1 - f, f), each rounded to nearest."""
    one = np.float32(1.0)
    return (np.rint((one - f) * np.float32(2048)).astype(np.int64),
            np.rint(f * np.float32(2048)).astype(np.int64))


def resize_linear_u8(src, dsize):
    """cv2.resize(src, dsize, interpolation=INTER_LINEAR) for a uint8
    (H, W) or (H, W, C) image; dsize is (width, height)."""
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = src.shape[:2]
    s = src.astype(np.int64).reshape(sh, sw, -1)
    sx, fx = _linear_taps(dw, sw)
    lo = sx < 0
    sx[lo], fx[lo] = 0, 0
    hi = sx >= sw - 1
    sx[hi], fx[hi] = sw - 1, 0
    a0, a1 = _fixed(fx)
    sx1 = np.minimum(sx + 1, sw - 1)
    rows = s[:, sx] * a0[None, :, None] + s[:, sx1] * a1[None, :, None]
    sy, fy = _linear_taps(dh, sh)
    b0, b1 = _fixed(fy)
    y0 = np.clip(sy, 0, sh - 1)
    y1 = np.clip(sy + 1, 0, sh - 1)
    # cv2's vectorised vertical pass: each row sum >> 4 times its 11-bit
    # weight >> 16 (a 16-bit high product), then (sum + 2) >> 2
    v = ((((rows[y0] >> 4) * b0[:, None, None]) >> 16)
         + (((rows[y1] >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape(
        (dh, dw) + src.shape[2:])


def _area_weights(n_out, n_src, shrink: bool):
    """(n_out, n_src) float64 weights of cv2's INTER_AREA along one axis.
    Where both axes shrink, each output cell averages the source cells it
    covers, by covered length; otherwise cv2 takes two linear taps with
    its area-mode weights on both axes."""
    scale = n_src / n_out
    Wt = np.zeros((n_out, n_src))
    if shrink:
        for d in range(n_out):
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, n_src - f1)
            s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
            s2 = min(s2, n_src - 1)
            s1 = min(s1, s2)
            if s1 - f1 > 1e-3:
                Wt[d, s1 - 1] += np.float32((s1 - f1) / cell)
            for s in range(s1, s2):
                Wt[d, s] += np.float32(1.0 / cell)
            if f2 - s2 > 1e-3:
                Wt[d, s2] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
        return Wt
    inv = 1.0 / scale
    for d in range(n_out):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if s < 0:
            s, f = 0, np.float32(0.0)
        if s >= n_src - 1:
            s, f = n_src - 1, np.float32(0.0)
        Wt[d, s] += np.float32(1.0) - f
        Wt[d, min(s + 1, n_src - 1)] += f
    return Wt


def resize_area(src, dsize):
    """cv2.resize(src, dsize, interpolation=INTER_AREA) for a float32
    (H, W) or (H, W, C) image; dsize is (width, height). Computed in
    float64 from cv2's float32 weights."""
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = src.shape[:2]
    s = np.asarray(src, np.float64).reshape(sh, sw, -1)
    shrink = dw <= sw and dh <= sh
    Wx, Wy = _area_weights(dw, sw, shrink), _area_weights(dh, sh, shrink)
    out = np.einsum("yh,hwc,xw->yxc", Wy, s, Wx)
    return out.astype(np.float32).reshape((dh, dw) + src.shape[2:])
