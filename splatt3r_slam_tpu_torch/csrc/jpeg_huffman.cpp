// Huffman entropy walk of one JPEG scan (host C++, called through ctypes).
//
// The C++ form of `utils/jpeg.py::_walk_python`: baseline / extended
// sequential blocks, and the four progressive scan kinds (DC first and
// refine, AC first and refine with EOB runs), over the same 16-bit lookahead
// tables (entry = code length << 8 | symbol, 0 where no code matches) and
// the same unstuffed restart segments, each followed by 4 zero bytes (the
// reader looks at most 4 bytes past its position; libjpeg feeds zeros past
// a segment too). The semantics are libjpeg-turbo's jdhuff.c decode_mcu and
// jdphuff.c decode_mcu_*, coefficient for coefficient, with JCOEF = int16
// storage. The walk is bit-serial, one table lookup a symbol: in Python it
// costs about 1 us a symbol, here a few ns.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libjpeg_huffman.so
// jpeg_huffman.cpp (done by `utils/jpeg.py::build_native`).

#include <cstdint>

namespace {

// jpeg_natural_order with libjpeg's 16 guard entries for corrupt runs
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { kOk = 0, kBadCode = 1, kOverrun = 2 };

struct Reader {
  const uint8_t* p = nullptr;
  int64_t nbits = 0;
  int64_t pos = 0;
  int status = kOk;

  // 32 bits from `pos` on, MSB first (at least 25 of them valid)
  inline uint32_t window() const {
    const uint8_t* q = p + (pos >> 3);
    uint32_t w = (uint32_t(q[0]) << 24) | (uint32_t(q[1]) << 16) |
                 (uint32_t(q[2]) << 8) | uint32_t(q[3]);
    return w << (pos & 7);
  }
  inline bool huff(const uint16_t* lut, int* sym) {
    if (pos > nbits) {
      status = kOverrun;
      return false;
    }
    uint16_t e = lut[window() >> 16];
    if (!e) {
      status = kBadCode;
      return false;
    }
    pos += e >> 8;
    *sym = e & 0xFF;
    return true;
  }
  inline bool get(int n, int* v) {
    if (pos > nbits) {
      status = kOverrun;
      return false;
    }
    *v = n ? int(window() >> (32 - n)) : 0;
    pos += n;
    return true;
  }
};

inline int extend(int v, int n) {
  return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

inline int16_t wrap16(int64_t v) { return int16_t(uint16_t(uint64_t(v))); }

struct Comp {
  int64_t h, v, pw, bw, bh, dc, ac;
  int16_t* coef;
};

struct Scan {
  const uint16_t* luts;
  int ss, se, ah, al, progressive;
  int32_t dc_pred[4];
  int64_t eobrun;
};

bool seq_block(Reader& r, Scan& s, const Comp& c, int ci, int16_t* blk) {
  int t, v;
  if (!r.huff(s.luts + (c.dc << 16), &t)) return false;
  int d = 0;
  if (t) {
    if (!r.get(t, &v)) return false;
    d = extend(v, t);
  }
  int32_t dc = int32_t(uint32_t(s.dc_pred[ci]) + uint32_t(d));
  s.dc_pred[ci] = dc;
  blk[0] = wrap16(dc);
  const uint16_t* lut = s.luts + (c.ac << 16);
  for (int k = 1; k < 64; ++k) {
    int rs;
    if (!r.huff(lut, &rs)) return false;
    int run = rs >> 4;
    t = rs & 15;
    if (t) {
      k += run;
      if (!r.get(t, &v)) return false;
      blk[kNatural[k]] = int16_t(extend(v, t));
    } else {
      if (run != 15) break;
      k += 15;
    }
  }
  return true;
}

bool dc_first(Reader& r, Scan& s, const Comp& c, int ci, int16_t* blk) {
  int t, v;
  if (!r.huff(s.luts + (c.dc << 16), &t)) return false;
  int d = 0;
  if (t) {
    if (!r.get(t, &v)) return false;
    d = extend(v, t);
  }
  int32_t dc = int32_t(uint32_t(s.dc_pred[ci]) + uint32_t(d));
  s.dc_pred[ci] = dc;
  blk[0] = wrap16(int64_t(dc) * (int64_t(1) << s.al));
  return true;
}

bool dc_refine(Reader& r, Scan& s, int16_t* blk) {
  int v;
  if (!r.get(1, &v)) return false;
  if (v) blk[0] = int16_t(blk[0] | (1 << s.al));
  return true;
}

bool ac_first(Reader& r, Scan& s, const Comp& c, int16_t* blk) {
  if (s.eobrun > 0) {
    --s.eobrun;
    return true;
  }
  const uint16_t* lut = s.luts + (c.ac << 16);
  for (int k = s.ss; k <= s.se; ++k) {
    int rs, v;
    if (!r.huff(lut, &rs)) return false;
    int run = rs >> 4, t = rs & 15;
    if (t) {
      k += run;
      if (!r.get(t, &v)) return false;
      blk[kNatural[k]] = wrap16(int64_t(extend(v, t)) * (int64_t(1) << s.al));
    } else if (run == 15) {
      k += 15;
    } else {
      s.eobrun = int64_t(1) << run;
      if (run) {
        if (!r.get(run, &v)) return false;
        s.eobrun += v;
      }
      --s.eobrun;
      break;
    }
  }
  return true;
}

// correction bit of a nonzero coefficient (jdphuff.c decode_mcu_AC_refine)
inline bool correct(Reader& r, int16_t* coef, int p1, int m1) {
  int v;
  if (!r.get(1, &v)) return false;
  if (v && !(*coef & p1))
    *coef = wrap16(int64_t(*coef) + (*coef >= 0 ? p1 : m1));
  return true;
}

bool ac_refine(Reader& r, Scan& s, const Comp& c, int16_t* blk) {
  const int p1 = 1 << s.al, m1 = -(1 << s.al);
  const uint16_t* lut = s.luts + (c.ac << 16);
  int k = s.ss;
  if (s.eobrun == 0) {
    for (; k <= s.se; ++k) {
      int rs, v;
      if (!r.huff(lut, &rs)) return false;
      int run = rs >> 4, t = rs & 15;
      if (t) {
        if (!r.get(1, &v)) return false;
        t = v ? p1 : m1;
      } else if (run != 15) {
        s.eobrun = int64_t(1) << run;
        if (run) {
          if (!r.get(run, &v)) return false;
          s.eobrun += v;
        }
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (!correct(r, coef, p1, m1)) return false;
        } else {
          if (--run < 0) break;
        }
        ++k;
      } while (k <= s.se);
      if (t) blk[kNatural[k]] = int16_t(t);
    }
  }
  if (s.eobrun > 0) {
    for (; k <= s.se; ++k) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0 && !correct(r, coef, p1, m1)) return false;
    }
    --s.eobrun;
  }
  return true;
}

}  // namespace

// Walk one scan. data: the unstuffed restart segments, each followed by 4
// zero bytes; seg: n_seg rows of (byte offset, byte length); luts: tables
// of 65536 uint16; comp: n_comp rows of (h, v, blocks per coefficient row,
// blocks across, blocks down, DC table, AC table, address of the int16
// coefficients (rows, cols, 64) in natural order); mcux: MCUs across
// (interleaved scans); n_mcus: MCUs in the scan; per: MCUs per restart
// segment. Returns 0, 1 on a bad Huffman code, 2 when a segment's data runs
// out.
extern "C" int jpeg_walk_scan(const uint8_t* data, const int64_t* seg,
                              int64_t n_seg, const uint16_t* luts,
                              const int64_t* comp, int n_comp, int64_t mcux,
                              int64_t n_mcus, int ss, int se, int ah, int al,
                              int64_t per, int progressive) {
  Comp cs[4];
  for (int i = 0; i < n_comp; ++i) {
    const int64_t* c = comp + 8 * i;
    cs[i] = Comp{c[0], c[1], c[2], c[3], c[4], c[5], c[6],
                 reinterpret_cast<int16_t*>(c[7])};
  }
  Scan s{luts, ss, se, ah, al, progressive, {0, 0, 0, 0}, 0};
  const int kind = !progressive ? 0 : ss == 0 ? (ah == 0 ? 1 : 2)
                                              : (ah == 0 ? 3 : 4);
  Reader r;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (m % per == 0) {  // a restart segment begins
      int64_t i = m / per;
      if (i >= n_seg) return kOverrun;
      r.p = data + seg[2 * i];
      r.nbits = 8 * seg[2 * i + 1];
      r.pos = 0;
      s.dc_pred[0] = s.dc_pred[1] = s.dc_pred[2] = s.dc_pred[3] = 0;
      s.eobrun = 0;
    }
    for (int ci = 0; ci < n_comp; ++ci) {
      const Comp& c = cs[ci];
      int64_t base, nv = c.v, nh = c.h;
      if (n_comp > 1) {
        base = ((m / mcux) * c.v * c.pw + (m % mcux) * c.h) * 64;
      } else {
        base = ((m / c.bw) * c.pw + m % c.bw) * 64;
        nv = nh = 1;
      }
      for (int64_t by = 0; by < nv; ++by) {
        for (int64_t bx = 0; bx < nh; ++bx) {
          int16_t* blk = c.coef + base + (by * c.pw + bx) * 64;
          bool ok;
          switch (kind) {
            case 0: ok = seq_block(r, s, c, ci, blk); break;
            case 1: ok = dc_first(r, s, c, ci, blk); break;
            case 2: ok = dc_refine(r, s, blk); break;
            case 3: ok = ac_first(r, s, c, blk); break;
            default: ok = ac_refine(r, s, c, blk); break;
          }
          if (!ok) return r.status;
        }
      }
    }
    if (r.pos > r.nbits) return kOverrun;
  }
  return kOk;
}
