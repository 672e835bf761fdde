// Flash attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_attention_kernel`
// (jax/experimental/pallas/ops/tpu/flash_attention.py, body
// `_flash_attention_kernel_single_batch`, launched by its pallas_call) that
// `splatt3r_slam_tpu/models/layers.py::_attend_flash` reaches when the
// flash-attention mode asks for it. What it computes, per (batch, head), on
// q (n_q, Dh), k and v (n_kv, Dh), non-causal, no bias, no segment ids:
//   s = q k^T summed in fp32, THEN times the softmax scale;
//   an online softmax over kv tiles: running max m, running sum l of the
//   fp32 p = exp(s - m); p rounded to v's dtype before p v, which is summed
//   in fp32; the output rounded to v's dtype.
// The TPU kernel walks kv in blocks of 128 and renormalises its fp32
// accumulator by l_corr / l_next at every block. This kernel walks kv in
// tiles of 64 (bf16) or 32 (fp32) rows, rescales the accumulator by
// exp(m_old - m_new) at every tile and divides by l once, at the end. The
// two differ only in rounding: where p is rounded to bf16 relative to
// another running max, and the order of the fp32 sums.
//
// Layout. q, k, v and the output are in the JAX layout (B, N, H, Dh) with
// Dh contiguous; the kernel takes each tensor's batch, row and head strides
// (in elements), so that v can be the strided view that the fused qkv
// projection gives (row stride 3·H·Dh) and no copy is made. Every row
// start must be 16-byte aligned (the wrapper checks). n_q and n_kv are
// multiples of 64 (the selection rule admits multiples of 256); cross
// attention has its own n_kv.
//
// Residuals. Under autograd the TPU kernel runs with save_residuals and
// also writes, for every query row, the final running max m and running
// sum l (fp32; l is the sum of the fp32 p = exp(s - m) before any
// division). Given non-null `l` and `m` pointers ((B, H, n_q) fp32,
// contiguous) this kernel writes the same two values after its last tile;
// with null pointers it writes neither, and the output is the same either
// way. The backward (flash_attention_bwd.cu) reads them.
//
// What bounds it on an H100 (bf16, Dh 64; per 64 x 64 tile of q rows and kv
// rows): the two products are 1.05 MFLOP, 256 clocks of one SM's tensor
// cores at the dense bf16 peak (989 TFLOP/s over 132 SMs); the 4,096
// exponentials run on the special function units, 16 a clock per SM, also
// 256 clocks; the fp32 work around them (scale, maxima, shift, sums,
// rescale, bf16 packing) is ~6 instructions an element, ~200 clocks of
// issue. Bytes are no limit (ViT-L's B 2, N 768, H 16: 4.83 GFLOP, 4.9 us
// at the peak; 6.3 MB, 1.9 us at 3.35 TB/s). So a tile costs an SM at least
// ~256 clocks, and only if products, exponentials and the rest overlap.
// The main paths call it at B 1 (one view at a time): N 768 gives 144
// (H 12) or 192 (H 16) blocks of 64 query rows for 132 SMs, one block an SM
// for most, so each block's chain of 12 tiles is the kernel's time. There a
// tile takes several times its throughput cost (clock64 probes on an H100
// put most of it in the softmax): one warp a sub-partition runs the
// softmax of its 16 rows, and each instruction waits out its latency with
// no other warp to hide it. The design therefore overlaps the
// tensor work with the softmax and keeps the softmax's instructions few.
//
// Design, bf16. A block is one warpgroup (128 threads) and owns 64 query
// rows (the M of wgmma) and 64 output columns; Dh above 64 splits the
// output's columns over Dh/64 blocks that share their query rows and each
// compute S whole, so that every instance holds one 64 x 64 accumulator of
// O and nothing spills. Tiles arrive by TMA (4-d (Dh, N, H, B) tensor maps
// made in the entry point from the strides it is given, boxes of 64 x 64,
// 128-byte rows, 128-byte swizzle: the layout wgmma's descriptors read),
// issued by one thread: the q tile once, then kv tiles of 64 rows (k whole,
// v's 64 columns of the block) through a ring of 4 stages (Dh 64) or 3
// completing on one mbarrier each. S = Q K^T is wgmma m64n64k16 with both
// operands K-major in shared memory, Dh/16 steps. O += P V is wgmma
// m64n64k16 with A from registers: the fp32 accumulator of S holds, pair by
// pair, the bf16 A fragment, so p goes to the tensor cores rounded to bf16
// while the row sums take it in fp32; B is the v tile as it lies, read
// transposed by the wgmma (MN-major), so no thread loads v. The tiles are
// software-pipelined within the warpgroup, with two S accumulators and two
// P fragment buffers: while the exponentials of tile j run, S of tile j + 1
// and O += P V of tile j - 1 are in flight on the tensor cores; P of tile j
// is packed as it is computed; the accumulator is rescaled once P V of
// tile j - 1 retires, and P V of tile j is issued behind it. A stage is
// handed back to the copy engine (one __syncthreads a tile) as soon as its
// v has been read, three (Dh 64) or two tiles before it is needed again;
// deeper rings measured no faster. The softmax's instructions: the
// exponential is ex2.approx of x log2 e with denormal results flushed to
// zero (__expf's steps without their denormal fix-up, three instructions an
// element fewer); a p below 2^-126 becomes 0, which changes no l and no
// bf16 output unless the larger terms of an output element cancel. The
// largest score of a row is taken before the scale: rounding is monotonic,
// so its scaled value is the largest scaled score, and the scale folds
// into one fma with the shift, exp(s scale - m). A negative scale is made
// positive by flipping the signs of the q tile once in shared memory: s
// scale = ((-q) k^T) |scale|, since a flipped sign rounds alike. Where the
// scale is a power of two (1/sqrt(Dh) at Dh 64 and 256) that product is
// exact short of underflow, and the fma gives the bits of scaling first;
// at other scales the shift can differ from them by one rounding.
// The arithmetic is fixed step by step, so that the output does not depend
// on the schedule: 64-row kv tiles; each thread owns 2 rows and 16 columns
// of S and of O (the layout of mma.sync m16n8's tiles); the scale on the
// summed product, in the shift; each thread's row sums in column order,
// its 4 lanes added once at the end; the rescale before P V; one division
// by l and one rounding.
// fp32: the same blocking with 8 warps and kv tiles of 32 rows on
// the fp32 FMA pipes (no tensor cores, so no TF32): 4 threads a query row,
// each owning 8 of a tile's scores and Dh/4 of the row's output columns,
// P passing through shared memory within the 4 lanes of its row.

#include <type_traits>

#include "flash_common.cuh"  // cp.async, mbarrier, TMA and wgmma helpers

namespace flash {

using namespace flash_common;

constexpr int BQ = 64;  // query rows a block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;  // (B, H, n_q) residuals, or null
  float* m;
  int n_q, n_kv;
  long long q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, o_b, o_n, o_h;
  float scale;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// ---------------------------------------------------------------- bf16 ----

constexpr int WG = 128;           // threads a block: one warpgroup
constexpr int BK = 64;            // kv rows a tile
constexpr int BOX = 64 * 64 * 2;  // bytes of a 64 x 64 box (128-byte rows)

template <int D>
struct Ring {
  static constexpr int NSUB = D / 64;             // boxes of a q or k tile
  static constexpr int QTILE = NSUB * BOX;        // bytes of the q tile
  static constexpr int STAGE = QTILE + BOX;       // a k tile and a v box
  static constexpr int STAGES = D == 64 ? 4 : 3;  // kv tiles a ring
};

// 1024 bytes to align the swizzled tiles, the q tile, the ring and the
// barriers (one a stage, one for q)
template <int D>
constexpr int smem_bf16() {
  using R = Ring<D>;
  return 1024 + R::QTILE + R::STAGES * R::STAGE + 8 * (R::STAGES + 1);
}

struct TmaParams {
  CUtensorMap q, k, v;
  Params p;
};

// Keep the compiler from moving the writes of P's A fragments past the
// wgmma.fence that must follow them.
__device__ __forceinline__ void hold_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4]) :: "memory");
}

// Accumulator element i of m64n64 lies at row 16 warp + g + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 c + (i & 1) (g = lane / 4, c = lane % 4), as
// element (i >> 2, i & 3) of mma.sync m16n8's tiles; the A fragment of the
// k-step kk (columns 16 kk to 16 kk + 15) is elements 8 kk to 8 kk + 7,
// paired in order.
template <int D>
__global__ void __launch_bounds__(WG, 3)
    flash_fwd_bf16(const __grid_constant__ TmaParams tp) {
  static_assert(D % 64 == 0, "Dh must be a multiple of 64");
  using R = Ring<D>;
  constexpr int ST = R::STAGES;
  // tile j + ST is copied while tile j + 1's S is issued: fewer stages and
  // the copy would wait on the wait for it
  static_assert(ST >= 3, "the pipeline needs three stages");
  const Params& p = tp.p;
  const float scale = fabsf(p.scale);  // q negated below where it is < 0
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qs = base, ring = base + R::QTILE;  // stage s: k, then v
  const uint32_t bars = ring + ST * R::STAGE;        // ST stages, then q

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int sub = blockIdx.x % R::NSUB;  // the block's 64 output columns
  const int q0 = (blockIdx.x / R::NSUB) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tiles = p.n_kv / BK;

  // kv tile j into its stage, by thread 0
  auto load = [&](int j) {
    const int s = j % ST;
    const uint32_t bar = bars + 8 * s, dst = ring + s * R::STAGE;
    bar_expect(bar, R::STAGE);
#pragma unroll
    for (int x = 0; x < R::NSUB; ++x)
      tma_box(dst + x * BOX, &tp.k, 64 * x, j * BK, h, b, bar);
    tma_box(dst + R::QTILE, &tp.v, 64 * sub, j * BK, h, b, bar);
  };

  if (tid == 0) {
    for (int s = 0; s <= ST; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bar = bars + 8 * ST;
    bar_expect(bar, R::QTILE);
#pragma unroll
    for (int x = 0; x < R::NSUB; ++x)
      tma_box(qs + x * BOX, &tp.q, 64 * x, q0, h, b, bar);
    for (int j = 0; j < ST && j < tiles; ++j) load(j);
  }
  __syncwarp();

  // issue S = Q K_j^T into d, one commit group
  auto scores = [&](float (&d)[32], int j) {
    const uint32_t kt = ring + (j % ST) * R::STAGE;
    bar_wait(bars + 8 * (j % ST), (j / ST) & 1);
    hold(d);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      mma_ss(d, desc(qs + off), desc(kt + off), kk);
    }
    wg_commit();
  };

  float o[32], sa[32], sb[32];  // O, and S of two tiles
  uint32_t pa[4][4], pb[4][4];  // P of two tiles, bf16 A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sa[i] = sb[i] = 0.f;
  // rows g and g + 8 of the warp's 16: running max and this lane's share
  // of the running sum
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  // Tile j, with its S complete in `cur` and O += P V of tile j - 1 in
  // flight (reading the other fragment buffer): S of tile j + 1 (if `more`)
  // into `nxt`, the online softmax of tile j into `pw`, then, once tile
  // j - 1's product is done, the rescale of O and O += P V of tile j, left
  // in flight.
  auto step = [&](float (&cur)[32], float (&nxt)[32], uint32_t (&pw)[4][4],
                  int j, auto more) {
    constexpr bool MORE = decltype(more)::value;
    if constexpr (MORE) scores(nxt, j + 1);

    // online softmax, the scale folded into the max and the shift
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      tmax[0] = fmaxf(tmax[0], fmaxf(cur[4 * nt], cur[4 * nt + 1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(cur[4 * nt + 2], cur[4 * nt + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]) * scale);
      alpha[r] = exp_ftz(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = exp_ftz(fmaf(cur[4 * nt], scale, -m[0]));
      const float p1 = exp_ftz(fmaf(cur[4 * nt + 1], scale, -m[0]));
      const float p2 = exp_ftz(fmaf(cur[4 * nt + 2], scale, -m[1]));
      const float p3 = exp_ftz(fmaf(cur[4 * nt + 3], scale, -m[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pw[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pw[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];

    // O += P V of tile j - 1 is done (S of tile j + 1 may still run): its
    // stage goes to the copy of tile j - 1 + ST
    if constexpr (MORE) wg_wait<1>(); else wg_wait<0>();
    hold(o);
    __syncthreads();  // no warp reads tile j - 1 any more
    if (tid == 0 && j >= 1 && j - 1 + ST < tiles) load(j - 1 + ST);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V of tile j: v's 64 columns of the block, MN-major
    hold(o);
    hold_frag(pw);
    wg_fence();
    const uint32_t vt = ring + (j % ST) * R::STAGE + R::QTILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(o, pw[kk], desc(vt + kk * 16 * 128));
    wg_commit();
    if constexpr (MORE) {
      wg_wait<1>();  // S of tile j + 1 is done; P V of tile j runs on
      hold(nxt);
    }
  };

  bar_wait(bars + 8 * ST, 0);  // the q tile
  if (p.scale < 0.f) {
    // s scale = ((-q) k^T) |scale|: q's signs flipped once in shared
    // memory, so that every tile takes its max
    uint4* qv = reinterpret_cast<uint4*>(smem_raw + (qs - raw));
#pragma unroll
    for (int i = tid; i < R::QTILE / 16; i += WG) {
      uint4 x = qv[i];
      x.x ^= 0x80008000u;
      x.y ^= 0x80008000u;
      x.z ^= 0x80008000u;
      x.w ^= 0x80008000u;
      qv[i] = x;
    }
    // the writes, seen by the wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  scores(sa, 0);
  wg_wait<0>();
  hold(sa);
  // two tiles an iteration, so that the two S accumulators and the two
  // fragment buffers keep their registers; the last tile issues no S
  int j = 0;
  for (; j + 2 < tiles; j += 2) {
    step(sa, sb, pa, j, std::true_type{});
    step(sb, sa, pb, j + 1, std::true_type{});
  }
  if (j + 1 < tiles) {
    step(sa, sb, pa, j, std::true_type{});
    step(sb, sa, pb, j + 1, std::false_type{});
  } else {
    step(sa, sb, pa, j, std::false_type{});
  }
  wg_wait<0>();
  hold(o);

  float sum[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = quad_sum(l[r]);
    inv[r] = 1.f / sum[r];
  }
  const int row = q0 + warp * 16 + g;  // and row + 8
  if (p.l != nullptr && sub == 0 && c == 0) {
    const long long i =
        (static_cast<long long>(b) * gridDim.y + h) * p.n_q + row;
    p.l[i] = sum[0];
    p.l[i + 8] = sum[1];
    p.m[i] = m[0];
    p.m[i + 8] = m[1];
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_b +
                      h * p.o_h + row * p.o_n + sub * 64 + 2 * c;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    *reinterpret_cast<__nv_bfloat162*>(og + t * 8) =
        __floats2bfloat162_rn(o[4 * t] * inv[0], o[4 * t + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_n + t * 8) =
        __floats2bfloat162_rn(o[4 * t + 2] * inv[1], o[4 * t + 3] * inv[1]);
  }
}

// ---------------------------------------------------------------- fp32 ----

constexpr int F_THREADS = 256;  // 4 threads a query row
constexpr int F_BK = 32;        // kv rows a tile
constexpr int F_PAD = 4;        // floats of padding a row
constexpr int F_LDP = F_BK + F_PAD;

template <int D>
constexpr int smem_f32() {
  return ((BQ + 4 * F_BK) * (D + F_PAD) + BQ * F_LDP) * 4;
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32(const Params p) {
  constexpr int LD = D + F_PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BQ * LD;        // [2][F_BK][LD]
  float* vs = ks + 2 * F_BK * LD;  // [2][F_BK][LD]
  float* ps = vs + 2 * F_BK * LD;  // [BQ][F_LDP]

  const int tid = threadIdx.x, row = tid >> 2, c4 = tid & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h + q0 * p.q_n;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_b + h * p.k_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_b + h * p.v_h;

  stage_rows<D, F_THREADS>(qs, LD, qg, p.q_n, BQ, tid);
  stage_rows<D, F_THREADS>(ks, LD, kg, p.k_n, F_BK, tid);
  stage_rows<D, F_THREADS>(vs, LD, vg, p.v_n, F_BK, tid);
  cp_async_commit();

  float o[D / 4];  // columns c4 + 4 i of the row
#pragma unroll
  for (int i = 0; i < D / 4; ++i) o[i] = 0.f;
  float m = neg_inf(), l = 0.f;  // l: this lane's share of the sum
  const float* qr = qs + row * LD;
  float* pr = ps + row * F_LDP;
  const int tiles = p.n_kv / F_BK;
  for (int j = 0; j < tiles; ++j) {
    const int s = j & 1;
    if (j + 1 < tiles) {
      const long long r = static_cast<long long>(j + 1) * F_BK;
      stage_rows<D, F_THREADS>(ks + (s ^ 1) * F_BK * LD, LD, kg + r * p.k_n,
                               p.k_n, F_BK, tid);
      stage_rows<D, F_THREADS>(vs + (s ^ 1) * F_BK * LD, LD, vg + r * p.v_n,
                               p.v_n, F_BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + s * F_BK * LD;
    const float* vt = vs + s * F_BK * LD;

    float sc[F_BK / 4];  // kv columns c4 + 4 i of the tile
#pragma unroll
    for (int i = 0; i < F_BK / 4; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int i = 0; i < F_BK / 4; ++i)
        sc[i] = fmaf(qd, kt[(c4 + 4 * i) * LD + d], sc[i]);
    }
    float tmax = neg_inf();
#pragma unroll
    for (int i = 0; i < F_BK / 4; ++i) {
      sc[i] *= p.scale;
      tmax = fmaxf(tmax, sc[i]);
    }
    const float mn = fmaxf(m, quad_max(tmax));
    const float alpha = expf(m - mn);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < F_BK / 4; ++i) {
      const float e = expf(sc[i] - mn);
      rs += e;
      pr[c4 + 4 * i] = e;
    }
    l = l * alpha + rs;
    __syncwarp();  // the row's p, written by its 4 lanes
#pragma unroll
    for (int i = 0; i < D / 4; ++i) o[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < F_BK; ++c) {
      const float pc = pr[c];
      const float* vrow = vt + c * LD + c4;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) o[i] = fmaf(pc, vrow[4 * i], o[i]);
    }
    __syncthreads();  // the ring buffer and p are refilled by the next tile
  }

  const float sum = quad_sum(l);
  const float inv = 1.f / sum;
  if (p.l != nullptr && c4 == 0) {
    const long long i =
        (static_cast<long long>(b) * gridDim.y + h) * p.n_q + q0 + row;
    p.l[i] = sum;
    p.m[i] = m;
  }
  float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h +
              (q0 + row) * p.o_n + c4;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) og[4 * i] = o[i] * inv;
}

// Blocks of the bf16 kernel that fit on one SM, as the occupancy API counts
// them from its registers, threads and shared memory; -1 if refused.
template <int D>
int blocks_per_sm() {
  int n = -1;
  if (cudaFuncSetAttribute(flash_fwd_bf16<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bf16<D>()) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_fwd_bf16<D>, WG, smem_bf16<D>()) != cudaSuccess)
    return -1;
  return n;
}

template <int D>
int launch(int dtype, int B, int H, const Params& p, cudaStream_t st) {
  cudaError_t e;
  if (dtype == 0) {
    if (p.n_kv % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
    TmaParams tp;
    tp.p = p;
    if (!tensor_map(&tp.q, p.q, D, p.n_q, H, B, p.q_n, p.q_h, p.q_b) ||
        !tensor_map(&tp.k, p.k, D, p.n_kv, H, B, p.k_n, p.k_h, p.k_b) ||
        !tensor_map(&tp.v, p.v, D, p.n_kv, H, B, p.v_n, p.v_h, p.v_b))
      return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bf16<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_bf16<D><<<dim3(p.n_q / BQ * Ring<D>::NSUB, H, B), WG,
                        smem_bf16<D>(), st>>>(tp);
  } else if (dtype == 1) {
    if (p.n_kv % F_BK != 0) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(flash_fwd_f32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_f32<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_f32<D><<<dim3(p.n_q / BQ, H, B), F_THREADS, smem_f32<D>(),
                       st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// How the bf16 kernel runs at this shape: plan[0] the blocks it launches,
// plan[1] its blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// -1 if refused).
template <int D>
int plan_for(int B, int H, int n_q, int* plan) {
  plan[0] = n_q / BQ * Ring<D>::NSUB * H * B;
  plan[1] = blocks_per_sm<D>();
  return 0;
}

}  // namespace flash

// dtype 0: bf16, 1: fp32 (q, k, v and the output alike). Strides in
// elements: (batch, row, head) of q, k, v and the output; Dh is contiguous.
// l and m: the residuals, (B, H, n_q) fp32, both or neither (null).
// Returns a cudaError_t: not 0 if the shape is refused or the launch
// failed.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* l, float* m,
    int dtype, int B, int H, int n_q, int n_kv, int D, long long q_b,
    long long q_n, long long q_h, long long k_b, long long k_n, long long k_h,
    long long v_b, long long v_n, long long v_h, long long o_b, long long o_n,
    long long o_h, float scale, void* stream) {
  if (B < 1 || H < 1 || n_q < flash::BQ || n_q % flash::BQ != 0 ||
      n_kv < 1 || (l == nullptr) != (m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Params p{q,   k,   v,   o,   l,   m,   n_q, n_kv, q_b, q_n,
                        q_h, k_b, k_n, k_h, v_b, v_n, v_h,  o_b,  o_n, o_h,
                        scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return flash::launch<64>(dtype, B, H, p, st);
    case 128: return flash::launch<128>(dtype, B, H, p, st);
    case 192: return flash::launch<192>(dtype, B, H, p, st);
    case 256: return flash::launch<256>(dtype, B, H, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_plan(int D, int B, int H, int n_q,
                                    int* plan) {
  using flash::plan_for;
  switch (D) {
    case 64: return plan_for<64>(B, H, n_q, plan);
    case 128: return plan_for<128>(B, H, n_q, plan);
    case 192: return plan_for<192>(B, H, n_q, plan);
    case 256: return plan_for<256>(B, H, n_q, plan);
    default: return -1;
  }
}
