"""JPEG decoding and encoding without cv2 or PIL.

The JAX package reads `.jpg` frames with `cv2.imread`
(`splatt3r_slam_tpu/runtime/dataloader.py:57-58`), decodes web uploads with
`cv2.imdecode(..., IMREAD_COLOR)` (`runtime/webdemo.py:221-230`) and sends
`/render` through `cv2.imencode(".jpg", ..., [IMWRITE_JPEG_QUALITY, 90])`
(`runtime/webdemo.py:264-267`). The GPU host has no cv2, so this module
does the same work with what libjpeg-turbo (cv2's bundled codec) computes:

- `decode_jpeg`: baseline (SOF0), extended sequential (SOF1)
  and progressive (SOF2) Huffman JPEG, 8-bit, one or three components with
  any sampling factors up to 4, restart intervals, 8- and 16-bit
  quantization tables. The sample path is libjpeg's: the integer islow
  IDCT (`jidctint.c`), "fancy" triangular chroma upsampling for 2:1 ratios
  (`jdsample.c`: h2v1, h1v2, h2v2; replication otherwise and for
  components of at most 2 samples across), and the fixed-point YCbCr→RGB
  tables of `jdcolor.c`, all vectorised in numpy. The colour space follows
  `jdapimin.c` (JFIF → YCbCr; Adobe transform 0 or component ids 'R','G','B'
  → RGB; otherwise YCbCr). A grayscale file comes out replicated to three
  channels, and the EXIF orientation (APP1 tag 0x0112) is applied as cv2 5
  applies it in both `imread` and `imdecode` with IMREAD_COLOR. The result
  is (H, W, 3) uint8 RGB.
- `encode_jpeg`: what `cv2.imencode` writes at a given quality: baseline,
  4:2:0 with libjpeg's `h2v2_downsample` (alternating rounding bias), the
  islow forward DCT (`jfdctint.c`), libjpeg-turbo's reciprocal
  quantization, the Annex K tables scaled by `jpeg_quality_scaling`, the
  standard Huffman tables and a JFIF APP0, packed and byte-stuffed in numpy.

The entropy walk is bit-serial. It exists twice: `_walk_python`, the plain
version over 16-bit lookup tables, and `csrc/jpeg_huffman.cpp`, the same
walk in C++, built at first use with `g++ -O2 -shared` into `_build/` and
called through ctypes (which releases the GIL, so a prefetch thread does not
hold the main loop). The C++ walk is the path whenever `walk` is not given;
a failed build raises. Both write the same coefficients.

What libjpeg decodes and this module refuses, each with a ValueError that
names it: arithmetic coding (SOF9-SOF15, DAC), lossless and hierarchical
frames, precision other than 8 bits, four components (CMYK, YCCK) and Adobe
transform 2, progressive files whose scans leave a coefficient unrefined
(libjpeg smooths those), and corrupt, truncated or unterminated data (no
EOI), where libjpeg warns and fills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import threading

import numpy as np

# -- tables -----------------------------------------------------------------


def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zigzag position."""
    cells = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([r * 8 + c for r, c in cells], np.int64)


_ZIGZAG = _zigzag()
# libjpeg's jpeg_natural_order: 16 guard entries absorb a corrupt run
_NATURAL = tuple(_ZIGZAG.tolist()) + (63,) * 16

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)  # natural order (Annex K.1)
_STD_CHROMA_Q = np.full(64, 99, np.int64)
_STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

# Annex K.3: (bits, values) of the four standard Huffman tables
_STD_HUFF = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
             bytes.fromhex(
                 "01020300041105122131410613516107227114328191a1082342b1c1"
                 "1552d1f02433627282090a161718191a25262728292a343536373839"
                 "3a434445464748494a535455565758595a636465666768696a737475"
                 "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
                 "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
                 "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
             bytes.fromhex(
                 "000102031104052131061241510761711322328108144291a1b1c109"
                 "233352f0156272d10a162434e125f11718191a262728292a35363738"
                 "393a434445464748494a535455565758595a636465666768696a7374"
                 "75767778797a82838485868788898a92939495969798999aa2a3a4a5"
                 "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6"
                 "d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def _canonical_codes(bits, what):
    """Code and length of each symbol slot of a Huffman table (Annex C),
    or a ValueError where the counts overflow the code space."""
    codes, lengths, code = [], [], 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            codes.append(code)
            lengths.append(n)
            code += 1
        if code > (1 << n):
            raise ValueError(f"{what}: bad Huffman table")
        code <<= 1
    return codes, lengths


def _lookup_table(bits, values, what) -> np.ndarray:
    """16-bit lookahead table: entry (length << 8 | symbol) for every
    16-bit window whose prefix is a code, 0 where none is."""
    lut = np.zeros(1 << 16, np.uint16)
    codes, lengths = _canonical_codes(bits, what)
    for code, n, sym in zip(codes, lengths, values):
        lo = code << (16 - n)
        lut[lo: lo + (1 << (16 - n))] = (n << 8) | sym
    return lut


# jidctint.c's output range limit: the IDCT's value masked to 10 bits
# indexes `sample_range_limit + CENTERJSAMPLE` (jdmaster.c)
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255),
                              np.zeros(384), np.arange(0, 128)]
                             ).astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16), folded into lookup
    tables: R = r[y << 8 | cr] and B = b[y << 8 | cb] (uint8, clamped),
    and G = clamp(y + g[cb << 8 | cr]) (int16)."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    g = (-fix(0.34414) * x[:, None] + half - fix(0.71414) * x[None, :]) >> 16
    y = np.arange(256, dtype=np.int64)[:, None]
    return (np.clip(y + cr_r, 0, 255).astype(np.uint8).ravel(),
            np.clip(y + cb_b, 0, 255).astype(np.uint8).ravel(),
            g.astype(np.int16).ravel())


_YCR_R, _YCB_B, _CBCR_G = _ycc_tables()
_CLAMP = np.clip(np.arange(-512, 768), 0, 255).astype(np.uint8)
# |input| up to which every intermediate of an IDCT pass fits in int32
# (each is a sum of at most three terms bounded by 61,214·|input|)
_INT32_SAFE = (2 ** 31 - 1) // (3 * 61214 + 1)


# -- markers ----------------------------------------------------------------

_SOF_REFUSED = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)",
    0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCC: "arithmetic-coded JPEG (DAC)",
    0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)",
    0xCF: "arithmetic-coded JPEG (SOF15)",
}


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "pw", "ph", "cw", "ch",
                 "q", "coef", "bits")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None  # quantization table, latched at the first scan
        self.bits = [-1] * 64  # progressive: Al of the last scan per k


class _Scan:
    """One SOS: its components, tables, spectral band and the entropy
    data cut at its restart markers into unstuffed segments."""

    __slots__ = ("comps", "dc", "ac", "ss", "se", "ah", "al", "restart",
                 "segments", "interleaved", "mcux", "n_mcus")


def _orientation(app1: bytes) -> int:
    """EXIF orientation (tag 0x0112 of IFD0) of an APP1 body, 1 if none."""
    if app1[:6] != b"Exif\0\0" or len(app1) < 14:
        return 1
    tiff = app1[6:]
    e = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if e is None:
        return 1
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(e + "H", tiff[ifd: ifd + 2])
    for i in range(n):
        p = ifd + 2 + 12 * i
        if p + 12 > len(tiff):
            break
        tag, typ = struct.unpack(e + "HH", tiff[p: p + 4])
        if tag == 0x0112 and typ == 3:
            (val,) = struct.unpack(e + "H", tiff[p + 8: p + 10])
            return val if 1 <= val <= 8 else 1
    return 1


def _entropy_segments(arr: np.ndarray, start: int, what):
    """Entropy-coded data of a scan from byte `start` → (unstuffed
    segments split at RSTn, index of the marker that ends the scan)."""
    ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
    nxt = arr[ff + 1]
    marker = (nxt != 0) & (nxt != 0xFF)
    rst = marker & (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[marker & ~rst]
    if not len(ends):
        raise ValueError(f"{what}: truncated JPEG (a scan runs to the end "
                         "of the data)")
    end = int(ends[0])
    sel = ff < end
    ff, nxt, rst = ff[sel] - start, nxt[sel], rst[sel]
    keep = np.ones(end - start, bool)
    keep[ff[nxt == 0] + 1] = False  # stuffed 0x00 after 0xFF
    keep[ff[nxt == 0xFF]] = False  # fill bytes
    keep[ff[rst]] = False
    keep[ff[rst] + 1] = False
    clean = arr[start:end][keep]
    cuts = np.cumsum(keep)[ff[rst]] if rst.any() else []
    return [s.tobytes() for s in np.split(clean, cuts)], end


class _Decoder:
    """Parses the markers and walks each scan as it comes (tables may be
    redefined between scans), then reconstructs the pixels."""

    def __init__(self, data: bytes, what, walk):
        self.data, self.what, self.walk = data, what, walk
        self.comps: list[_Component] = []
        self.qt = [None] * 4
        self.huff = {}  # (class, id) → (lookup table, max symbol)
        self.restart = 0
        self.progressive = False
        self.jfif = False
        self.adobe = None
        self.orientation = None
        self.size = None

    def fail(self, why):
        raise ValueError(f"{self.what}: {why}")

    def run(self):
        data = self.data
        if data[:3] != b"\xff\xd8\xff":
            self.fail("not a JPEG file")
        arr = np.frombuffer(data, np.uint8)
        n, pos = len(data), 2
        while True:
            pos = data.find(b"\xff", pos)  # libjpeg skips stray bytes
            if pos < 0:
                self.fail("truncated JPEG (no EOI marker)")
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                self.fail("truncated JPEG (no EOI marker)")
            m = data[pos]
            pos += 1
            if m == 0xD9:  # EOI
                break
            if m == 0x01 or 0xD0 <= m <= 0xD7:  # standalone markers
                continue
            if m == 0xD8:
                self.fail("a second SOI marker")
            if pos + 2 > n:
                self.fail("truncated JPEG (inside a marker)")
            length = (data[pos] << 8) | data[pos + 1]
            if length < 2 or pos + length > n:
                self.fail("truncated JPEG (inside a marker segment)")
            body = data[pos + 2: pos + length]
            pos += length
            if m in (0xC0, 0xC1, 0xC2):
                self.frame(m, body)
            elif m in _SOF_REFUSED:
                self.fail(f"{_SOF_REFUSED[m]} is not supported")
            elif m == 0xC4:
                self.define_huffman(body)
            elif m == 0xDB:
                self.define_quant(body)
            elif m == 0xDD:
                if len(body) < 2:
                    self.fail("bad DRI marker")
                self.restart = (body[0] << 8) | body[1]
            elif m == 0xDA:
                scan = self.scan_header(body)
                scan.segments, pos = _entropy_segments(arr, pos, self.what)
                self.walk_scan(scan)
            elif m == 0xE0 and body[:5] == b"JFIF\0":
                self.jfif = True
            elif m == 0xE1 and self.orientation is None \
                    and body[:6] == b"Exif\0\0":
                self.orientation = _orientation(body)
            elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                self.adobe = body[11]
        if self.size is None:
            self.fail("no frame header (SOF)")
        for c in self.comps:
            if c.q is None:
                self.fail(f"component {c.cid} is in no scan")
            if self.progressive and any(c.bits):
                self.fail("progressive scans leave coefficients unrefined "
                          "(libjpeg smooths such images; not supported)")
        return self.pixels()

    # -- marker segments ----------------------------------------------------
    def frame(self, m, b):
        if self.size is not None:
            self.fail("more than one frame header")
        if len(b) < 6:
            self.fail("bad SOF marker")
        prec, H, W, nc = b[0], (b[1] << 8) | b[2], (b[3] << 8) | b[4], b[5]
        if prec != 8:
            self.fail(f"{prec}-bit JPEG is not supported (8-bit only)")
        if H == 0 or W == 0:
            self.fail(f"image size {W}x{H} (a DNL height is not supported)")
        if nc == 4:
            self.fail("four-component (CMYK/YCCK) JPEG is not supported")
        if nc not in (1, 3) or len(b) < 6 + 3 * nc:
            self.fail(f"{nc} components (1 or 3 supported)")
        for i in range(nc):
            cid, hv, tq = b[6 + 3 * i: 9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                self.fail(f"bad sampling factors {h}x{v} or table {tq}")
            self.comps.append(_Component(cid, h, v, tq))
        self.size = (H, W)
        self.progressive = m == 0xC2
        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)
        for c in self.comps:
            if hmax % c.h or vmax % c.v:
                self.fail("fractional sampling factors are not supported")
        self.mcux = -(-W // (8 * hmax))
        self.mcuy = -(-H // (8 * vmax))
        for c in self.comps:
            c.cw = -(-W * c.h // hmax)  # samples across (downsampled)
            c.ch = -(-H * c.v // vmax)
            c.bw, c.bh = -(-c.cw // 8), -(-c.ch // 8)
            c.pw, c.ph = self.mcux * c.h, self.mcuy * c.v
            if nc == 1:  # one component: the MCU is a block
                c.pw, c.ph = c.bw, c.bh
            c.coef = np.zeros((c.ph, c.pw, 64), np.int16)

    def define_huffman(self, b):
        p = 0
        while p < len(b):
            if p + 17 > len(b):
                self.fail("bad DHT marker")
            tc, th = b[p] >> 4, b[p] & 15
            bits = tuple(b[p + 1: p + 17])
            total = sum(bits)
            vals = b[p + 17: p + 17 + total]
            if tc > 1 or th > 3 or total > 256 or len(vals) < total:
                self.fail("bad DHT marker")
            self.huff[(tc, th)] = (_lookup_table(bits, vals, self.what),
                                   max(vals, default=0))
            p += 17 + total

    def define_quant(self, b):
        p = 0
        while p < len(b):
            pq, tq = b[p] >> 4, b[p] & 15
            size = 128 if pq else 64
            if pq > 1 or tq > 3 or p + 1 + size > len(b):
                self.fail("bad DQT marker")
            vals = np.frombuffer(b[p + 1: p + 1 + size],
                                 ">u2" if pq else np.uint8)
            q = np.zeros(64, np.int64)
            q[_ZIGZAG] = vals
            self.qt[tq] = q
            p += 1 + size

    def scan_header(self, b):
        if self.size is None:
            self.fail("SOS before SOF")
        ns = b[0] if b else 0
        if not 1 <= ns <= 4 or len(b) < 4 + 2 * ns:
            self.fail("bad SOS marker")
        byid = {c.cid: c for c in self.comps}
        s = _Scan()
        s.comps, s.dc, s.ac = [], [], []
        for i in range(ns):
            c = byid.get(b[1 + 2 * i])
            if c is None:
                self.fail(f"scan names component {b[1 + 2 * i]}")
            s.comps.append(c)
            s.dc.append(b[2 + 2 * i] >> 4)
            s.ac.append(b[2 + 2 * i] & 15)
        s.ss, s.se = b[1 + 2 * ns], b[2 + 2 * ns]
        s.ah, s.al = b[3 + 2 * ns] >> 4, b[3 + 2 * ns] & 15
        if self.progressive:
            bad = (s.se < s.ss or s.se > 63 or s.al > 13
                   or (s.ss == 0 and s.se != 0)
                   or (s.ss > 0 and ns != 1))
        else:
            bad = s.ss != 0 or s.se != 63
        if bad:
            self.fail(f"bad scan parameters Ss={s.ss} Se={s.se} "
                      f"Ah={s.ah} Al={s.al}")
        if self.adobe == 2:
            self.fail(f"Adobe transform {self.adobe} (YCCK) is not supported")
        for c in s.comps:
            if c.q is None:  # libjpeg latches the table at the first scan
                if self.qt[c.tq] is None:
                    self.fail(f"no quantization table {c.tq}")
                c.q = self.qt[c.tq].copy()
        s.interleaved = ns > 1
        s.mcux = self.mcux
        c0 = s.comps[0]
        s.n_mcus = self.mcux * self.mcuy if s.interleaved else c0.bw * c0.bh
        s.restart = self.restart
        return s

    def tables(self, s):
        """Lookup tables the scan uses → (list of tables, dc index per
        component, ac index per component); -1 where none is used."""
        luts, dc_idx, ac_idx = [], [], []
        first = not self.progressive or s.ah == 0
        for dc, ac in zip(s.dc, s.ac):
            di = ai = -1
            if s.ss == 0 and first:
                if (0, dc) not in self.huff:
                    self.fail(f"no DC Huffman table {dc}")
                lut, top = self.huff[(0, dc)]
                if top > 15:
                    self.fail("bad Huffman table (DC symbol above 15)")
                luts.append(lut)
                di = len(luts) - 1
            if s.se > 0:
                if (1, ac) not in self.huff:
                    self.fail(f"no AC Huffman table {ac}")
                luts.append(self.huff[(1, ac)][0])
                ai = len(luts) - 1
            dc_idx.append(di)
            ac_idx.append(ai)
        return luts, dc_idx, ac_idx

    def walk_scan(self, s):
        expect = -(-s.n_mcus // s.restart) if s.restart else 1
        if len(s.segments) != expect:
            self.fail(f"{len(s.segments)} restart segments in a scan that "
                      f"needs {expect} (corrupt data)")
        luts, dc_idx, ac_idx = self.tables(s)
        err = (_walk_native if self.walk == "native" else _walk_python)(
            s, luts, dc_idx, ac_idx, self.progressive)
        if err == 1:
            self.fail("corrupt JPEG data (bad Huffman code)")
        if err == 2:
            self.fail("corrupt or truncated JPEG data (a scan runs past "
                      "its segment)")
        if self.progressive:
            for c in s.comps:
                for k in range(s.ss, s.se + 1):
                    c.bits[k] = s.al

    # -- samples ------------------------------------------------------------
    def pixels(self) -> np.ndarray:
        H, W = self.size
        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)
        planes = []
        for c in self.comps:
            blocks = c.coef[:c.bh, :c.bw].reshape(-1, 64)
            px = _idct_islow(blocks, c.q).reshape(c.bh, c.bw, 8, 8)
            plane = px.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
            planes.append(_upsample(plane[:c.ch, :c.cw], hmax // c.h,
                                    vmax // c.v)[:H, :W])
        if len(planes) == 1:
            rgb = np.repeat(planes[0][..., None], 3, axis=2)
        elif self.color_space() == "rgb":
            rgb = np.stack(planes, axis=2)
        else:
            rgb = _ycc_to_rgb(*planes)
        return _orient(rgb, self.orientation or 1)

    def color_space(self):
        """jdapimin.c default_decompress_parms for three components."""
        if self.jfif:
            return "ycc"
        if self.adobe is not None:
            return "rgb" if self.adobe == 0 else "ycc"
        ids = tuple(c.cid for c in self.comps)
        return "rgb" if ids == (82, 71, 66) else "ycc"


# -- entropy walk: plain version --------------------------------------------

_PY_PAD = bytes(4096)  # zeros past a segment, more than an MCU can read


def _walk_python(s: _Scan, luts, dc_idx, ac_idx, progressive) -> int:
    """Decode one scan's coefficients into each component's `coef`, in
    Python: 0, or 1 for a bad Huffman code, 2 for data past a segment."""
    luts = [lut.tolist() for lut in luts]
    coefs = [c.coef.reshape(-1).tolist() for c in s.comps]
    nat = _NATURAL
    ss, se, ah, al = s.ss, s.se, s.ah, s.al
    if s.interleaved:  # blocks of an MCU: (component, offset from base)
        layout = [(i, (by * c.pw + bx) * 64)
                  for i, c in enumerate(s.comps)
                  for by in range(c.v) for bx in range(c.h)]
    c0 = s.comps[0]
    per = s.restart or s.n_mcus
    mode = ("seq" if not progressive else
            ("dc_first" if ah == 0 else "dc_refine") if ss == 0 else
            ("ac_first" if ah == 0 else "ac_refine"))
    p1, m1 = 1 << al, -1 << al
    state = {}

    for seg_i, seg in enumerate(s.segments):
        buf = seg + _PY_PAD
        nbits = 8 * len(seg)
        state["pos"] = 0
        dc_pred = [0] * len(s.comps)
        eobrun = 0

        def huff(lut):
            pos = state["pos"]
            i = pos >> 3
            e = lut[(((buf[i] << 16) | (buf[i + 1] << 8) | buf[i + 2])
                     >> (8 - (pos & 7))) & 0xFFFF]
            if not e:
                raise _BadCode
            state["pos"] = pos + (e >> 8)
            return e & 0xFF

        def get(n):
            pos = state["pos"]
            i = pos >> 3
            w = ((buf[i] << 24) | (buf[i + 1] << 16) | (buf[i + 2] << 8)
                 | buf[i + 3])
            state["pos"] = pos + n
            return (w >> (32 - (pos & 7) - n)) & ((1 << n) - 1)

        def extend(v, n):
            return v - (1 << n) + 1 if v < (1 << (n - 1)) else v

        def refine(blk, off, k, stop, r):
            """Correction bits of the nonzero coefficients from k on;
            stops at the r-th zero (r < 0: runs to `stop`) → k."""
            while k <= stop:
                j = off + nat[k]
                v = blk[j]
                if v:
                    if get(1) and not v & p1:
                        blk[j] = _wrap16(v + (p1 if v >= 0 else m1))
                elif r >= 0:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            return k

        first = seg_i * per
        try:
            for m in range(first, min(first + per, s.n_mcus)):
                if s.interleaved:
                    my, mx = divmod(m, s.mcux)
                    blocks = [(i, (my * s.comps[i].v * s.comps[i].pw
                                   + mx * s.comps[i].h) * 64 + d)
                              for i, d in layout]
                else:
                    by, bx = divmod(m, c0.bw)
                    blocks = [(0, (by * c0.pw + bx) * 64)]
                for ci, off in blocks:
                    blk = coefs[ci]
                    if mode == "dc_refine":
                        if get(1):
                            blk[off] = blk[off] | p1
                        continue
                    if mode in ("seq", "dc_first"):
                        t = huff(luts[dc_idx[ci]])
                        d = extend(get(t), t) if t else 0
                        d = _wrap32(dc_pred[ci] + d)
                        dc_pred[ci] = d
                        blk[off] = _wrap16(d << al if progressive else d)
                        if mode == "dc_first":
                            continue
                        lut, k = luts[ac_idx[ci]], 1
                        while k < 64:
                            rs = huff(lut)
                            r, t = rs >> 4, rs & 15
                            if t:
                                k += r
                                blk[off + nat[k]] = extend(get(t), t)
                                k += 1
                            elif r != 15:
                                break
                            else:
                                k += 16
                        continue
                    lut = luts[ac_idx[ci]]
                    if mode == "ac_first":
                        if eobrun:
                            eobrun -= 1
                            continue
                        k = ss
                        while k <= se:
                            rs = huff(lut)
                            r, t = rs >> 4, rs & 15
                            if t:
                                k += r
                                blk[off + nat[k]] = _wrap16(
                                    extend(get(t), t) << al)
                            elif r == 15:
                                k += 15
                            else:
                                eobrun = (1 << r) - 1
                                if r:
                                    eobrun += get(r)
                                break
                            k += 1
                        continue
                    # ac_refine (jdphuff.c decode_mcu_AC_refine)
                    k = ss
                    if not eobrun:
                        while k <= se:
                            rs = huff(lut)
                            r, t = rs >> 4, rs & 15
                            if t:
                                t = p1 if get(1) else m1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += get(r)
                                break
                            k = refine(blk, off, k, se, r)
                            if t:
                                blk[off + nat[k]] = t
                            k += 1
                    if eobrun:
                        refine(blk, off, k, se, -1)
                        eobrun -= 1
                if state["pos"] > nbits:
                    return 2
        except _BadCode:
            return 1
    for c, flat in zip(s.comps, coefs):
        c.coef[...] = np.asarray(flat, np.int64).astype(np.int16).reshape(
            c.coef.shape)
    return 0


class _BadCode(Exception):
    pass


def _wrap16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _wrap32(v: int) -> int:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


# -- entropy walk: C++ ------------------------------------------------------

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "jpeg_huffman.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_NATIVE_PAD = bytes(4)  # the C++ reader looks at most 4 bytes ahead
_native_fn = None
_native_lock = threading.Lock()


def build_native() -> pathlib.Path:
    """Compile `csrc/jpeg_huffman.cpp` (once per hash of the source and
    flags) with g++ into `_build/` → the library; raise if it fails."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libjpeg_huffman_{h.hexdigest()[:12]}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the JPEG entropy walk "
                           f"({SOURCE.name}) needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _native():
    global _native_fn
    with _native_lock:
        if _native_fn is None:
            fn = ctypes.CDLL(str(build_native())).jpeg_walk_scan
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int64, ctypes.c_int]
            fn.restype = ctypes.c_int
            _native_fn = fn
    return _native_fn


def _walk_native(s: _Scan, luts, dc_idx, ac_idx, progressive) -> int:
    """`_walk_python` in C++ (`csrc/jpeg_huffman.cpp`)."""
    fn = _native()
    data = b"".join(seg + _NATIVE_PAD for seg in s.segments)
    seg = np.zeros((len(s.segments), 2), np.int64)
    seg[:, 1] = [len(x) for x in s.segments]
    seg[1:, 0] = np.cumsum(seg[:-1, 1] + len(_NATIVE_PAD))
    lut = (np.ascontiguousarray(np.stack(luts)) if luts
           else np.zeros((1, 1 << 16), np.uint16))
    comp = np.array([[c.h, c.v, c.pw, c.bw, c.bh, di, ai, c.coef.ctypes.data]
                     for c, di, ai in zip(s.comps, dc_idx, ac_idx)],
                    np.int64)
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(4, np.uint8)
    return fn(buf.ctypes.data, seg.ctypes.data, len(s.segments),
              lut.ctypes.data, comp.ctypes.data, len(s.comps), s.mcux,
              s.n_mcus, s.ss, s.se, s.ah, s.al, s.restart or s.n_mcus,
              int(progressive))


# -- sample path ------------------------------------------------------------


def _idct_pass(i0, i1, i2, i3, i4, i5, i6, i7, shift):
    """One 1-D pass of jidctint.c's jpeg_idct_islow (CONST_BITS 13),
    descaled by `shift` with rounding."""
    z1 = (i2 + i6) * 4433
    tmp2 = z1 + i6 * -15137
    tmp3 = z1 + i2 * 6270
    tmp0 = (i0 + i4) << 13
    tmp1 = (i0 - i4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = i7, i5, i3, i1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    rnd = 1 << (shift - 1)
    return [(a + rnd) >> shift for a in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_islow(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 64) quantized coefficients (natural order) and their table →
    (N, 8, 8) uint8 samples, as jpeg_idct_islow computes them (its
    all-zero shortcuts give the same values as the full pass). Each pass
    runs in int32 where its inputs are small enough to never overflow it,
    as with every 8-bit image's coefficients, else in int64 (libjpeg's
    JLONG); the results are the same."""
    big = int(np.abs(blocks).max(initial=0)) * int(q.max()) > _INT32_SAFE
    dt = np.int64 if big else np.int32
    x = (blocks.astype(dt) * q.astype(dt)).reshape(-1, 8, 8)
    ws = np.empty(x.shape, np.int32)  # jidctint.c's int workspace
    for k, v in enumerate(_idct_pass(*(x[:, k] for k in range(8)),
                                     shift=11)):  # columns
        ws[:, k] = v
    if int(np.abs(ws).max(initial=0)) > _INT32_SAFE:
        ws = ws.astype(np.int64)
    ws = ws.transpose(0, 2, 1).copy()  # rows, contiguous per position
    out = np.empty(x.shape, np.uint8)
    for k, v in enumerate(_idct_pass(*(ws[:, k] for k in range(8)),
                                     shift=18)):  # rows
        out[:, :, k] = _IDCT_LIMIT[v & 1023]
    return out


def _edge(x, axis, before):
    """x shifted by one sample along `axis`, the edge sample repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + (-1 if before else 1), 0, n - 1)
    return np.take(x, idx, axis=axis)


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane: np.ndarray, rx: int, ry: int) -> np.ndarray:
    """A component's samples → full size, as jdsample.c upsamples them:
    fancy (triangular) for h2v1, h1v2 and h2v2, replication otherwise and
    where fewer than 3 samples run across (h2v1, h2v2)."""
    x = plane.astype(np.int32)
    cw = x.shape[1]
    if (rx, ry) == (1, 1):
        return plane
    if (rx, ry) == (2, 1) and cw > 2:
        out = _interleave((3 * x + _edge(x, 1, True) + 1) >> 2,
                          (3 * x + _edge(x, 1, False) + 2) >> 2, 1)
    elif (rx, ry) == (1, 2):
        out = _interleave((3 * x + _edge(x, 0, True) + 1) >> 2,
                          (3 * x + _edge(x, 0, False) + 2) >> 2, 0)
    elif (rx, ry) == (2, 2) and cw > 2:
        rows = []
        for near in (3 * x + _edge(x, 0, True), 3 * x + _edge(x, 0, False)):
            rows.append(_interleave(
                (3 * near + _edge(near, 1, True) + 8) >> 4,
                (3 * near + _edge(near, 1, False) + 7) >> 4, 1))
        out = _interleave(rows[0], rows[1], 0)
    else:
        return np.repeat(np.repeat(plane, ry, axis=0), rx, axis=1)
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on uint8 planes, through the tables."""
    y16 = y.astype(np.intp) << 8
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _YCR_R[y16 | cr]
    out[..., 1] = _CLAMP[_CBCR_G[(cb.astype(np.intp) << 8) | cr] + y
                         + 512]
    out[..., 2] = _YCB_B[y16 | cb]
    return out


def _orient(img: np.ndarray, o: int) -> np.ndarray:
    """cv2's ExifTransform for orientation o (1-8)."""
    if o >= 5:
        img = img.transpose(1, 0, 2)
    if o in (2, 3, 6, 7):
        img = img[:, ::-1]
    if o in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


# -- public decoder ---------------------------------------------------------


def decode_jpeg(data: bytes, what="JPEG data", walk: str = "native"
                ) -> np.ndarray:
    """The bytes of a JPEG file → (H, W, 3) uint8 RGB, as
    `cv2.imdecode(..., IMREAD_COLOR)` + BGR→RGB gives. `walk` is "native"
    (the C++ entropy walk, built at first use) or "python" (the plain
    version); `what` names the data in errors."""
    if walk not in ("native", "python"):
        raise ValueError(f"walk {walk!r}: 'native' or 'python'")
    return _Decoder(bytes(data), what, walk).run()


def jpeg_coefficients(data: bytes, walk: str = "native") -> list:
    """The quantized DCT coefficients of each component after every scan
    ((blocks down, blocks across, 64) int16, natural order, padded to the
    MCU grid): what the entropy walk writes."""
    d = _Decoder(bytes(data), "JPEG data", walk)
    d.run()
    return [c.coef for c in d.comps]


# -- encoder ----------------------------------------------------------------


def _quant_tables(quality: int):
    """jpeg_set_quality(quality, force_baseline=TRUE) → (luma, chroma)
    tables, natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert → Y, Cb, Cr int64 planes."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half, off = 1 << 15, 128 << 16
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half
          - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half
          - 1) >> 16
    return y, cb, cr


def _fdct_pass(d0, d1, d2, d3, d4, d5, d6, d7, first):
    """One 1-D pass of jfdctint.c's jpeg_fdct_islow (CONST_BITS 13,
    PASS1_BITS 2); `first` is the row pass."""
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    sh = 11 if first else 15  # CONST_BITS -/+ PASS1_BITS

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    o = [None] * 8
    if first:
        o[0], o[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
    else:
        o[0], o[4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
    z1 = (tmp12 + tmp13) * 4433
    o[2] = descale(z1 + tmp13 * 6270, sh)
    o[6] = descale(z1 + tmp12 * -15137, sh)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = (tmp4 * 2446, tmp5 * 16819, tmp6 * 25172,
                              tmp7 * 12299)
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    o[7] = descale(tmp4 + z1 + z3, sh)
    o[5] = descale(tmp5 + z2 + z4, sh)
    o[3] = descale(tmp6 + z2 + z3, sh)
    o[1] = descale(tmp7 + z1 + z4, sh)
    return o


def _fdct_quantize(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 8, 8) samples 0-255 → (N, 64) quantized coefficients, natural
    order: jpeg_fdct_islow, then libjpeg-turbo's reciprocal quantization
    (jcdctmgr.c compute_reciprocal / quantize). Samples of 8 bits keep
    every intermediate of both passes within int32."""
    x = blocks.astype(np.int32) - 128
    rows = np.stack(_fdct_pass(*(x[:, :, k] for k in range(8)), True), 2)
    cols = np.stack(_fdct_pass(*(rows[:, k] for k in range(8)), False), 1)
    coef = cols.reshape(-1, 64).astype(np.int64)
    d = (q.astype(np.int64) << 3)
    b = np.floor(np.log2(d)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // d, (1 << r) % d
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr <= d // 2, fq, fq + 1))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag)


def _huffman_codes(bits, values):
    """(code, length) per symbol value of a standard table."""
    codes, lengths = _canonical_codes(bits, "encoder")
    co, si = np.zeros(256, np.int64), np.zeros(256, np.int64)
    co[list(values)], si[list(values)] = codes, lengths
    return co, si


_ENC_TABLES = {k: _huffman_codes(*v) for k, v in _STD_HUFF.items()}


def _symbols(zz: np.ndarray, comp: np.ndarray):
    """Blocks in coding order ((N, 64) zigzag) and each block's table
    (0 luma, 1 chroma) → (code values, lengths) of the whole scan in
    order, as jchuff.c encode_one_block emits them (DC differences per
    component in `comp`'s order)."""
    n = len(zz)
    keys, vals, lens = [], [], []

    def emit(key, val, ln):
        keys.append(key)
        vals.append(val)
        lens.append(ln)

    def mag(v):
        a = np.abs(v)
        nb = np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))) + 1, 0)
        nb = nb.astype(np.int64)
        return nb, np.where(v < 0, v - 1, v) & ((1 << nb) - 1)

    tbl = comp[1]  # table per block
    # DC: difference to the previous block of the same component
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for cid in np.unique(comp[0]):
        sel = np.flatnonzero(comp[0] == cid)
        diff[sel] = np.diff(dc[sel], prepend=0)
    nb, extra = mag(diff)
    blk = np.arange(n)
    dco = np.where(tbl == 0, _ENC_TABLES[(0, 0)][0][nb],
                   _ENC_TABLES[(0, 1)][0][nb])
    dsi = np.where(tbl == 0, _ENC_TABLES[(0, 0)][1][nb],
                   _ENC_TABLES[(0, 1)][1][nb])
    emit(blk * 1024, dco, dsi)
    emit(blk * 1024 + 1, extra, nb)
    # AC: runs of zeros, ZRL per 16, EOB after the last nonzero
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    first = np.r_[True, b[1:] != b[:-1]] if len(b) else np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    aco = [_ENC_TABLES[(1, t)][0] for t in (0, 1)]
    asi = [_ENC_TABLES[(1, t)][1] for t in (0, 1)]
    t = tbl[b]
    for j in range(3):  # a run of at most 62 zeros: up to 3 ZRLs
        z = np.flatnonzero(run >= 16 * (j + 1))
        emit(b[z] * 1024 + 2 + k[z] * 8 + j,
             np.where(t[z] == 0, aco[0][0xF0], aco[1][0xF0]),
             np.where(t[z] == 0, asi[0][0xF0], asi[1][0xF0]))
    v = zz[b, k]
    nb, extra = mag(v)
    sym = ((run % 16) << 4) | nb
    emit(b * 1024 + 2 + k * 8 + 4, np.where(t == 0, aco[0][sym],
                                            aco[1][sym]),
         np.where(t == 0, asi[0][sym], asi[1][sym]))
    emit(b * 1024 + 2 + k * 8 + 5, extra, nb)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    e = np.flatnonzero(last < 63)
    emit(e * 1024 + 1000, np.where(tbl[e] == 0, aco[0][0], aco[1][0]),
         np.where(tbl[e] == 0, asi[0][0], asi[1][0]))
    keys, vals, lens = (np.concatenate(a) for a in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    vals, lens = vals[order], lens[order]
    live = lens > 0
    return vals[live], lens[live]


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Codes of the given lengths, MSB first, padded with 1-bits to a
    byte, with a 0x00 stuffed after every 0xFF."""
    total = int(lens.sum())
    start = np.cumsum(lens) - lens
    idx = np.arange(total) - np.repeat(start, lens)
    shift = np.repeat(lens, lens) - 1 - idx
    bits = ((np.repeat(vals, lens) >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(rgb_u8, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 RGB → the bytes of the baseline 4:2:0 JFIF file
    that `cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, quality])`
    writes."""
    rgb = np.ascontiguousarray(rgb_u8, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) RGB, not {rgb.shape}")
    H, W = rgb.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"image size {W}x{H} outside 1-65535")
    qy, qc = _quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(rgb)
    mcux, mcuy = -(-W // 16), -(-H // 16)
    # luma: edge rows to the iMCU height, edge columns to whole blocks
    ybw, ybh = -(-W // 8), -(-H // 8)
    yp = np.pad(y, ((0, mcuy * 16 - H), (0, ybw * 8 - W)), mode="edge")
    # chroma: an even number of rows, columns to 2·blocks·8, then
    # h2v2_downsample (bias 1, 2, 1, 2, ... along each row)
    bias = np.tile([1, 2], mcux * 4)
    chroma = []
    for p in (cb, cr):
        p = np.pad(p, ((0, H % 2), (0, mcux * 16 - W)), mode="edge")
        d = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
             + bias) >> 2
        chroma.append(np.pad(d, ((0, mcuy * 8 - d.shape[0]), (0, 0)),
                             mode="edge"))

    def blocks(p, bh, bw):
        return p[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)

    yq = np.zeros((mcuy * 2, mcux * 2, 64), np.int64)
    yq[:ybh, :ybw] = _fdct_quantize(
        blocks(yp, ybh, ybw).reshape(-1, 8, 8), qy).reshape(ybh, ybw, 64)
    # jccoefct.c's dummy blocks past the edges: zero AC, the DC of the
    # block before them in the MCU
    if ybw % 2:
        yq[:, ybw, 0] = yq[:, ybw - 1, 0]
    if ybh % 2:
        yq[ybh, :, 0] = np.repeat(yq[ybh - 1, 1::2, 0], 2)
    cq = [_fdct_quantize(blocks(p, mcuy, mcux).reshape(-1, 8, 8),
                         qc).reshape(mcuy, mcux, 64) for p in chroma]
    # coding order: per MCU Y00 Y01 Y10 Y11 Cb Cr
    ym = yq.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        mcuy, mcux, 4, 64)
    mcu = np.concatenate([ym, cq[0][:, :, None], cq[1][:, :, None]], axis=2)
    zz = mcu.reshape(-1, 64)[:, _ZIGZAG]
    comp_of = np.tile([0, 0, 0, 0, 1, 2], mcuy * mcux)
    table_of = np.tile([0, 0, 0, 0, 1, 1], mcuy * mcux)
    scan = _pack(*_symbols(zz, np.stack([comp_of, table_of])))

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate((qy, qc)):
        out.append(_segment(0xDB, bytes([i]) + q[_ZIGZAG].astype(
            np.uint8).tobytes()))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc, th in ((0, 0), (1, 0), (0, 1), (1, 1)):
        bits, vals = _STD_HUFF[(tc, th)]
        out.append(_segment(0xC4, bytes([tc << 4 | th, *bits]) + vals))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                     0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)
