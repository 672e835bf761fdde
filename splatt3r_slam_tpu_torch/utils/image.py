"""Host-side image I/O and resizing without cv2 or PIL.

Counterpart of `splatt3r_slam_tpu/utils/image.py` and of the native resize
the JAX `create_frame` uses where g++ is present
(`splatt3r_slam_tpu/native/impre.cpp`):

- `read_png` / `write_png` (and `decode_png` / `encode_png` on bytes):
  8-bit PNG through `zlib` and `struct` (gray, RGB and RGBA read,
  non-interlaced, all five row filters; RGB written);
- `read_image` / `decode_image`: PNG or JPEG (`utils/jpeg.py`), chosen by
  the magic bytes as cv2 chooses, not by the file's suffix;
- `resize_img`: the reference geometry (long side to `size`, centre crop
  to multiples of 16, the square 3:4 exception; short side to 224 and a
  square crop for `size == 224`), with the pixels of the native helper:
  bilinear with half-pixel centres and edge clamps, rounded by +0.5 and
  truncated to uint8. It runs vectorised in float32 numpy, in the
  arithmetic order of the C++ loop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # gray, RGB, RGBA


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body))


def encode_png(rgb_u8) -> bytes:
    """(H, W, 3) uint8 RGB, or (H, W) uint8 gray → the bytes of an 8-bit
    truecolour (or grayscale) PNG (filter 0)."""
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = rgb_u8.shape[:2]
    c = 1 if rgb_u8.ndim == 2 else 3
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb_u8.reshape(h, w * c)], axis=1).tobytes()
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          0 if c == 1 else 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def write_png(path, rgb_u8):
    """`encode_png` into the file `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))


def _unfilter(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters. filt (H, W, bpp) uint8, types (H,).

    Every filter reads at most the left pixel, the pixel above and the one
    above-left, so the pixels of one anti-diagonal r + x = d depend only
    on earlier diagonals: the loop runs over the H + W - 1 diagonals and
    each step is vectorised over the rows it crosses, whatever filter each
    row uses."""
    H, W, bpp = filt.shape
    if not np.isin(types, (0, 1, 2, 3, 4)).all():
        raise ValueError(f"PNG row filter {sorted(set(types.tolist()))}")
    rec = np.zeros((H + 1, W + 1, bpp), np.int32)  # zero row/column pad
    f32 = filt.astype(np.int32)
    rows = np.arange(H)
    for d in range(H + W - 1):
        r = rows[max(0, d - W + 1): min(H, d + 1)]
        x = d - r
        a = rec[r + 1, x]  # left
        b = rec[r, x + 1]  # above
        c = rec[r, x]  # above-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        t = types[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (f32[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """8-bit non-interlaced gray / RGB / RGBA PNG file → (H, W, 3) uint8
    RGB (gray replicated, alpha dropped), as `cv2.imread` + BGR→RGB gives."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path="PNG data") -> np.ndarray:
    """`read_png` on the bytes of a PNG; `path` names it in errors."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        tag, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); 8-bit gray, RGB or RGBA "
            "without interlacing only")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: image data of the wrong size")
    raw = raw.reshape(h, w * bpp + 1)
    img = _unfilter(raw[:, 1:].reshape(h, w, bpp), raw[:, 0])
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def decode_image(data: bytes, what="image data") -> np.ndarray:
    """The bytes of a PNG or JPEG file → (H, W, 3) uint8 RGB, as
    `cv2.imdecode(..., IMREAD_COLOR)` + BGR→RGB gives; a ValueError that
    names `what` for any other format."""
    from splatt3r_slam_tpu_torch.utils.jpeg import decode_jpeg

    if data[:8] == _PNG_SIG:
        return decode_png(data, what)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, what)
    raise ValueError(f"{what}: not a PNG or JPEG file")


def read_image(path) -> np.ndarray:
    """`decode_image` on the file `path` (what `cv2.imread` + BGR→RGB
    gives for PNG and JPEG files)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def _axis(n_out: int, offset: int, n_src: int, scale: np.float32):
    """Source index and weight of each output sample along one axis, as
    impre.cpp computes them (float32; trunc toward 0; edge clamps)."""
    f = ((np.arange(n_out, dtype=np.float32) + np.float32(offset)
          + np.float32(0.5)) * scale - np.float32(0.5)).astype(np.float32)
    i = f.astype(np.int64)  # C's (int) cast truncates toward zero
    d = (f - i.astype(np.float32)).astype(np.float32)
    neg = f < 0
    i[neg], d[neg] = 0, np.float32(0.0)
    hi = i >= n_src - 1
    i[hi], d[hi] = n_src - 2, np.float32(1.0)
    return i, d


def resize_crop_u8(img_u8: np.ndarray, rh: int, rw: int, ch: int,
                   cw: int) -> np.ndarray:
    """uint8 (H, W, 3) → bilinear resize to (rh, rw) with half-pixel
    centres, centre crop to (ch, cw) → uint8 (ch, cw, 3)."""
    sh, sw = img_u8.shape[:2]
    if sh < 2 or sw < 2:
        raise ValueError(f"image of shape {(sh, sw)} is too small to resize")
    iy, dy = _axis(ch, (rh - ch) // 2, sh, np.float32(sh) / np.float32(rh))
    ix, dx = _axis(cw, (rw - cw) // 2, sw, np.float32(sw) / np.float32(rw))
    one = np.float32(1.0)
    dy, dx = dy[:, None, None], dx[None, :, None]
    w00, w01 = (one - dy) * (one - dx), (one - dy) * dx
    w10, w11 = dy * (one - dx), dy * dx
    src = img_u8.astype(np.float32)
    r0, r1 = src[iy], src[iy + 1]
    v = (w00 * r0[:, ix] + w01 * r0[:, ix + 1] + w10 * r1[:, ix]
         + w11 * r1[:, ix + 1])
    return np.minimum(np.float32(255.0),
                      np.maximum(np.float32(0.0), v + np.float32(0.5))
                      ).astype(np.uint8)


def resize_img(img: np.ndarray, size: int):
    """img: (H, W, 3) float [0,1] or uint8 → dict with
    {'img': (1, h, w, 3) float32 in [-1, 1] NHWC,
     'true_shape': [[h, w]] int32, 'unnormalized_img': (h, w, 3) uint8}."""
    if size != 224 and size % 16:
        raise ValueError(f"img_size {size}: 224 or a multiple of 16")
    if img.dtype != np.uint8:  # the reference's truncating conversion
        img = np.uint8(np.clip(img, 0, 1) * 255)
    H1, W1 = img.shape[:2]
    if (size != 224 and max(H1, W1) == size and H1 % 16 == 0
            and W1 % 16 == 0 and H1 != W1):
        arr = img  # already at the target geometry
    elif size == 224:
        long_edge = round(size * max(W1 / H1, H1 / W1))
        W, H = (int(round(x * long_edge / max(W1, H1))) for x in (W1, H1))
        halfw = halfh = min(W // 2, H // 2)
        arr = resize_crop_u8(img, H, W, 2 * halfh, 2 * halfw)
    else:
        # native/__init__.py::resize_img_native's arithmetic
        scale = size / max(W1, H1)
        W, H = int(round(W1 * scale)), int(round(H1 * scale))
        halfw, halfh = ((2 * (W // 2)) // 16) * 8, ((2 * (H // 2)) // 16) * 8
        if W == H:
            halfh = int(3 * halfw / 4)
        arr = resize_crop_u8(img, H, W, 2 * halfh, 2 * halfw)
    return dict(img=((arr.astype(np.float32) / 255.0 - 0.5) / 0.5)[None],
                true_shape=np.int32([arr.shape[:2]]),
                unnormalized_img=arr)
