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
// tiles of 64 rows (32 in fp32 above Dh 64), rescales the accumulator by
// exp(m_old - m_new) at every tile and divides by l once, at the end. The
// two differ only in rounding: where p is rounded to bf16 relative to
// another running max, and the order of the fp32 sums; in fp32 the
// kernel's products are split TF32 (below), within about 2^-20 of fp32's.
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
//
// What bounds it in fp32, and the design. On the fp32 pipes (67 TFLOP/s) the
// two products take 15 times the bf16 tensor cores' time; the tensor cores take
// TF32 (10 mantissa bits), which alone misses fp32's accuracy. So the products
// are split TF32 (3xTF32): every operand x is hi + lo, hi = tf32(x), lo =
// tf32(x - hi), both rounded to nearest as cvt.rna.tf32.f32 rounds but by two
// integer operations (flash_common.cuh), and x y = hi hi' + hi lo' + lo hi'
// summed in fp32: three TF32 products, 495 / 3 = 165 TFLOP/s of fp32-accurate
// products. ViT-L's fp32 step at B 1, N 768, H 16: 3 x 2.4 GFLOP, 14.6 us at
// the TF32 peak; 12.6 MB, 3.8 us at 3.35 TB/s: bound by operations. On an H100
// a tf32 wgmma (k = 8) costs a warpgroup about the same time at N 32 and 64,
// and no less when its products go to independent accumulators (clock64
// probes), so the design makes its wgmmas few and wide. The blocks are bf16's:
// one warpgroup, 64 q rows, 64 output columns (Dh/64 blocks above Dh 64). q, k
// and v arrive by TMA (boxes of 32 fp32 columns, 128-byte swizzle); q is split
// once, hi in place and lo beside it; kv tiles are 64 rows at Dh 64 (one stage,
// two blocks an SM) and 32 above (3 and 1 stages at Dh 128 and 256), each
// split after it lands: k's hi in place and lo beside, v's 64 columns written
// transposed (VT, hi and lo), the rows of each 8 in the order 0, 2, 4, 6, 1, 3,
// 5, 7. S = Q K^T is wgmma m64nRSk8 .tf32 with both operands K-major by
// descriptor. O += P V contracts over the kv rows, and wgmma takes no
// transposed tf32 operand: on VT it is wgmma m64n64k8 with P from registers,
// since S's accumulator elements (columns 2 c and 2 c + 1 of each 8) are P's A
// fragment (k = c and c + 4) once VT's rows are in that order. (P V by mma.sync
// m16n8k8 .tf32 on V split in place, the fp32 dQ kernel's route, measured
// slower.) The tensor cores' fp32 sums do not round to nearest, so S is summed
// in chains of 24 products, P V a tile at a time, and the FMA pipes add them: O
// = O exp(m_old - m_new) + P V. The softmax is the fp32 backward's, s scale
// rounded and then exp_ftz(s scale - m), so that the p the forward sums is the
// p the backward recomputes; the largest scaled score is taken, so a negative
// scale needs no sign flip.
//
// Head dims. The TPU kernel takes Dh below 128 or a multiple of 128 (the
// wrapper refuses the others with its error, and `attend` routes them to
// SDPA as the JAX package routes them to einsum). Dh 64, 128 and 256 are
// template instances of the kernels above, whose tiles span Dh; every
// multiple of 128 from 384 up runs on one wide kernel a dtype that takes
// Dh at run time and streams S over it in 64-column chunks (the "wide head
// dims" section below), so that shared memory does not grow with Dh. The
// instances stay: on an H100 the wide kernels, built to take Dh 128 and 256
// too, are slower there at every row timed (chip_smoke.py --wide-from-128;
// the times in PERF.md).

#include <type_traits>

#include "flash_common.cuh"  // mbarrier, TMA, wgmma and split-TF32 helpers

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

// kv rows a tile, ring stages and byte sizes of the fp32 kernel, by head
// dim. Boxes are 32 fp32 columns (128 bytes) wide, 128-byte swizzled. The
// q tile is split once, hi in place and lo beside it; a stage holds a raw k
// tile (all of Dh) and the block's 64 columns of v; the tile in work has
// k's lo beside it, and v's hi and lo transposed (VT). A wgmma costs about
// the same at N 32 and 64, so the kv tiles are as tall as shared memory
// allows: 64 rows at Dh 64 (one stage; two blocks an SM only without the
// 1024 bytes of alignment slack, so the kernel declares its shared memory
// 1024-byte aligned there and traps if it is not), 32 above with 3 and 1
// stages at Dh 128 and 256.
constexpr int VTBOX = 64 * 128;  // 32 kv rows of v's 64 columns, transposed

template <int D>
struct F32 {
  static constexpr int RS = D == 64 ? 64 : 32;  // kv rows a tile
  static constexpr int NB = D / 32;             // boxes of a q or k row
  static constexpr int STAGES = D == 128 ? 3 : 1;
  static constexpr int SLACK = D == 64 ? 0 : 1024;
  static constexpr int FBOX = BQ * 128;  // a box of the q tile
  static constexpr int SBOX = RS * 128;  // a box of a k or v tile
  static constexpr int QTILE = NB * FBOX;
  static constexpr int KTILE = NB * SBOX;
  static constexpr int STAGE = KTILE + 2 * SBOX;  // k, then v's 64 columns
  static constexpr int VT = RS / 32 * VTBOX;      // v's 64 columns, transposed
  // S's products go to SC accumulators in turn, each summed by the tensor
  // cores from 0 (their fp32 sums do not round to nearest): 24 products a
  // chain; P V's 3 RS / 8 are one chain
  static constexpr int SC = NB / 2;
};

// the alignment slack, q's hi and lo, the ring, k's lo, VT's hi and lo,
// and the barriers (one a stage, one for q)
template <int D>
constexpr int smem_f32() {
  using R = F32<D>;
  return R::SLACK + 2 * R::QTILE + R::STAGES * R::STAGE + R::KTILE +
         2 * R::VT + 8 * (R::STAGES + 1);
}

// v's 64 columns of a tile of RS rows (two boxes of RS rows, as TMA lays
// them), split into tf32 hi and lo and written transposed: row n of VT is
// column n of v, its positions the tile's rows, 32 a box of VTBOX bytes,
// each 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 (P's accumulator elements
// hold columns 2 c and 2 c + 1 of each 8, the k = c and c + 4 of its A
// fragment), 128-byte swizzled: the K-major B operand of wgmma. Each
// thread writes 16-byte pieces of one row; a warp's reads fall in one
// 128-byte row of v.
template <int RS>
__device__ __forceinline__ void split_vt(const unsigned char* v,
                                         unsigned char* hi,
                                         unsigned char* lo, int tid) {
  constexpr int SBOX = RS * 128;
  const int n = tid & 63, cc = n & 31;
  const unsigned char* col = v + (n >> 5) * SBOX + ((cc & 3) << 2);
#pragma unroll
  for (int u = 0; u < RS / 8; ++u) {
    const int piece = (tid >> 6) + 2 * u;  // positions 4 piece to + 3
    const int pc = piece & 7;              // its place in a box of VT
    const int r0 = 32 * (piece >> 3) + 8 * (pc >> 1) + (pc & 1);
    uint32_t hv[4], lv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // rows r0 + 2 e
      const int r = r0 + 2 * e;
      split_tf32(*reinterpret_cast<const float*>(
                     col + r * 128 + (((cc >> 2) ^ (r & 7)) << 4)),
                 hv[e], lv[e]);
    }
    const int off = (piece >> 3) * VTBOX + n * 128 + ((pc ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) =
        make_uint4(hv[0], hv[1], hv[2], hv[3]);
    *reinterpret_cast<uint4*>(lo + off) =
        make_uint4(lv[0], lv[1], lv[2], lv[3]);
  }
}

// The accumulators are those of the bf16 kernel: element i of m64nN at row
// 16 warp + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 c + (i & 1).
template <int D>
__global__ void __launch_bounds__(WG, 1)
    flash_fwd_f32(const __grid_constant__ TmaParams tp) {
  static_assert(D % 64 == 0, "Dh must be a multiple of 64");
  using R = F32<D>;
  constexpr int RS = R::RS, ST = R::STAGES, NB = R::NB, NSUB = D / 64;
  constexpr int SC = R::SC;
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_addr(f32_smem);
  if constexpr (R::SLACK == 0) {
    if (raw & 1023) __trap();
  }
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = f32_smem + (base - raw);
  // byte offsets: q (hi in place), its lo, the ring (stage s: k, then v),
  // k's lo, VT's hi and lo, the barriers
  constexpr int QLO = R::QTILE, RING = 2 * R::QTILE,
                KLO = RING + ST * R::STAGE, VTH = KLO + R::KTILE,
                VTL = VTH + R::VT, BARS = VTL + R::VT;
  const uint32_t bars = base + BARS;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int sub = blockIdx.x % NSUB;  // the block's 64 output columns
  const int q0 = (blockIdx.x / NSUB) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tiles = p.n_kv / RS;

  // kv tile j into its stage, by thread 0
  auto load = [&](int j) {
    const int s = j % ST;
    const uint32_t bar = bars + 8 * s, dst = base + RING + s * R::STAGE;
    bar_expect(bar, R::STAGE);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      tma_box(dst + x * R::SBOX, &tp.k, 32 * x, j * RS, h, b, bar);
#pragma unroll
    for (int x = 0; x < 2; ++x)
      tma_box(dst + R::KTILE + x * R::SBOX, &tp.v, 64 * sub + 32 * x,
              j * RS, h, b, bar);
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
    for (int x = 0; x < NB; ++x)
      tma_box(base + x * R::FBOX, &tp.q, 32 * x, q0, h, b, bar);
    for (int j = 0; j < ST && j < tiles; ++j) load(j);
  }
  __syncwarp();

  float o[32], pv[32];      // O, and P V of one tile
  float sp[SC][RS / 2];     // the chains of S; S, then P, in sp[0]
  uint32_t ph[RS / 8][4], pl[RS / 8][4];  // P's A fragments, hi and lo
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // rows g and g + 8 of the warp's 16: running max and this lane's share
  // of the running sum
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const uint64_t qh = desc(base), ql = desc(base + QLO),
                 kl = desc(base + KLO), vth = desc(base + VTH),
                 vtl = desc(base + VTL);
  bar_wait(bars + 8 * ST, 0);
  split_pass<R::QTILE>(sm, sm + QLO, tid);  // made visible in tile 0

  for (int j = 0; j < tiles; ++j) {
    const int s = j % ST;
    unsigned char* kt = sm + RING + s * R::STAGE;
    // every warp is done with tile j - 1: k's lo and VT are free
    __syncthreads();
    bar_wait(bars + 8 * s, (j / ST) & 1);

    // the split pass: k's hi in place and lo beside, v's transposed
    split_pass<R::KTILE>(kt, sm + KLO, tid);
    split_vt<RS>(kt + R::KTILE, sm + VTH, sm + VTL, tid);
    fence_async_smem();
    __syncthreads();

    // S = Q K^T, three tf32 products a k-step (hi lo', lo hi', hi hi'),
    // product n to chain n % SC, the chains added in fp32 by the FMA pipes
    const uint64_t kh = desc(smem_addr(kt));
#pragma unroll
    for (int ch = 0; ch < SC; ++ch) hold(sp[ch]);
    wg_fence();
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t fo = (x * R::FBOX + kk * 32) / 16,
                       so = (x * R::SBOX + kk * 32) / 16;
        const int n = 3 * (4 * x + kk);
        mma_tf32_ss(sp[n % SC], qh + fo, kl + so, n >= SC);
        mma_tf32_ss(sp[(n + 1) % SC], ql + fo, kh + so, n + 1 >= SC);
        mma_tf32_ss(sp[(n + 2) % SC], qh + fo, kh + so, n + 2 >= SC);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int ch = 0; ch < SC; ++ch) hold(sp[ch]);
    // k's hi and v are read: the stage goes to the copy of tile j + ST,
    // which runs under this tile's softmax and P V
    __syncthreads();
    if (tid == 0 && j + ST < tiles) load(j + ST);
    float (&sc)[RS / 2] = sp[0];
#pragma unroll
    for (int ch = 1; ch < SC; ++ch)
#pragma unroll
      for (int i = 0; i < RS / 2; ++i) sc[i] += sp[ch][i];

    // online softmax: s scale as the backward recomputes it, then
    // exp(s scale - m)
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < RS / 2; ++i) {
      sc[i] = __fmul_rn(sc[i], p.scale);
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      alpha[r] = exp_ftz(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < RS / 2; ++i) {
      sc[i] = exp_ftz(sc[i] - m[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    // P as A fragments: k = c is column 2 c of each 8, k = c + 4 is 2 c + 1
#pragma unroll
    for (int kk = 0; kk < RS / 8; ++kk) {
      split_tf32(sc[4 * kk], ph[kk][0], pl[kk][0]);
      split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // P V: wgmma m64n64k8 with P from registers and VT by descriptor,
    // summed from 0 and added to the rescaled O in fp32
    hold(pv);
    hold(ph);
    hold(pl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < RS / 8; ++kk) {
      const uint32_t vo = ((kk >> 2) * VTBOX + (kk & 3) * 32) / 16;
      mma_tf32<64>(pv, ph[kk], vtl + vo, kk > 0);
      mma_tf32<64>(pv, pl[kk], vth + vo, 1);
      mma_tf32<64>(pv, ph[kk], vth + vo, 1);
    }
    wg_commit();
    wg_wait<0>();
    hold(pv);
    hold(ph);
    hold(pl);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = o[i] * alpha[(i >> 1) & 1] + pv[i];
  }

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
  float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h +
              row * p.o_n + sub * 64 + 2 * c;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    *reinterpret_cast<float2*>(og + t * 8) =
        make_float2(o[4 * t] * inv[0], o[4 * t + 1] * inv[0]);
    *reinterpret_cast<float2*>(og + 8 * p.o_n + t * 8) =
        make_float2(o[4 * t + 2] * inv[1], o[4 * t + 3] * inv[1]);
  }
}

// ------------------------------------------------------ wide head dims ----

// Dh a multiple of 128 from 384 up, the head dim at run time: one kernel a
// dtype. A block owns 64 q rows and 64 output columns, as above (n_q/64 x
// Dh/64 blocks a head), but no tile spans Dh: S = Q K^T is summed over Dh
// in chunks of 64 columns, each a pair of 64-column boxes (q's rows, the kv
// tile's rows) that TMA brings into a ring of its own, and every block of a
// q tile computes S whole, (Dh/64) times the S work of one block. The
// block's 64 columns of v come by TMA into a second ring. Each chunk is
// waited for before the next starts and each stage is refilled once its
// products have retired: simple, not fast.
constexpr int WST = 4;   // chunk pairs a ring, bf16
constexpr int WVST = 2;  // v tiles a ring

// 1024 bytes of alignment slack, the pair ring (q box, then k box), the v
// ring, the barriers (a pair stage each, then a v stage each)
constexpr int smem_wide_bf16() {
  return 1024 + WST * 2 * BOX + WVST * BOX + 8 * (WST + WVST);
}

// The softmax is the fp32 kernel's: s scale rounded, its row maximum, then
// exp(s scale - m), as the plain version takes them (no sign flip of q).
__global__ void __launch_bounds__(WG, 2)
    flash_fwd_wide_bf16(const __grid_constant__ TmaParams tp, int D) {
  const Params& p = tp.p;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t pairs = base, vring = base + WST * 2 * BOX;
  const uint32_t bars = vring + WVST * BOX;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int nc = D / 64;  // chunks of the contraction
  const int sub = blockIdx.x % nc;
  const int q0 = (blockIdx.x / nc) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tiles = p.n_kv / BK, items = tiles * nc;

  // item u (chunk u % nc of kv tile u / nc) into its pair stage, by thread 0
  auto load_pair = [&](int u) {
    const int s = u % WST, x = u % nc;
    const uint32_t bar = bars + 8 * s, dst = pairs + s * 2 * BOX;
    bar_expect(bar, 2 * BOX);
    tma_box(dst, &tp.q, 64 * x, q0, h, b, bar);
    tma_box(dst + BOX, &tp.k, 64 * x, (u / nc) * BK, h, b, bar);
  };
  auto load_v = [&](int j) {
    const uint32_t bar = bars + 8 * (WST + j % WVST);
    bar_expect(bar, BOX);
    tma_box(vring + (j % WVST) * BOX, &tp.v, 64 * sub, j * BK, h, b, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < WST + WVST; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int u = 0; u < WST && u < items; ++u) load_pair(u);
    for (int j = 0; j < WVST && j < tiles; ++j) load_v(j);
  }
  __syncwarp();

  float o[32], sc[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  for (int j = 0; j < tiles; ++j) {
    // S = Q K_j^T, chunk by chunk
    for (int x = 0; x < nc; ++x) {
      const int u = j * nc + x, s = u % WST;
      const uint32_t st = pairs + s * 2 * BOX;
      bar_wait(bars + 8 * s, (u / WST) & 1);
      hold(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss(sc, desc(st + kk * 32), desc(st + BOX + kk * 32),
               x > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      hold(sc);
      __syncthreads();  // no warp reads the stage any more
      if (tid == 0 && u + WST < items) load_pair(u + WST);
      __syncwarp();
    }

    // online softmax
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = __fmul_rn(sc[i], p.scale);
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      alpha[r] = exp_ftz(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = exp_ftz(sc[4 * nt] - m[0]);
      const float p1 = exp_ftz(sc[4 * nt + 1] - m[0]);
      const float p2 = exp_ftz(sc[4 * nt + 2] - m[1]);
      const float p3 = exp_ftz(sc[4 * nt + 3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V_j: v's 64 columns of the block, MN-major
    bar_wait(bars + 8 * (WST + j % WVST), (j / WVST) & 1);
    const uint32_t vt = vring + (j % WVST) * BOX;
    hold(o);
    hold_frag(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(o, pa[kk], desc(vt + kk * 16 * 128));
    wg_commit();
    wg_wait<0>();
    hold(o);
    __syncthreads();
    if (tid == 0 && j + WVST < tiles) load_v(j + WVST);
    __syncwarp();
  }

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

// fp32: split TF32 as above, kv tiles of 64 rows. A pair stage holds q's and
// k's 64 columns of the chunk (two 32-column boxes each); once it lands one
// pass rounds both to hi in place and writes lo beside them (one lo pair
// for the chunk in work), and the chunk's 24 products (8 k-steps, each hi
// lo', lo hi', hi hi') are one chain, summed by the tensor cores from 0 and
// added to S by the FMA pipes. v's 64 columns are split transposed (VT) as
// at Dh 64, and P V is one chain a tile, as there.
constexpr int WST32 = 3;                // chunk pairs a ring, fp32
constexpr int WBOX = 64 * 128;          // 64 rows of 32 fp32 columns
constexpr int WPAIR = 4 * WBOX;         // q's and k's 64 columns
constexpr int WVTILE = 2 * WBOX;        // v's 64 columns of a 64-row tile

// the slack, the pair ring, the chunk's lo pair, the v ring, VT's hi and
// lo, the barriers
constexpr int smem_wide_f32() {
  return 1024 + (WST32 + 1) * WPAIR + WVST * WVTILE + 2 * 2 * VTBOX +
         8 * (WST32 + WVST);
}

__global__ void __launch_bounds__(WG, 1)
    flash_fwd_wide_f32(const __grid_constant__ TmaParams tp, int D) {
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_addr(f32_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = f32_smem + (base - raw);
  // byte offsets: the pair ring (stage s: q's two boxes, then k's), the
  // lo pair, the v ring, VT's hi and lo, the barriers
  constexpr int LO = WST32 * WPAIR, VRING = LO + WPAIR,
                VTH = VRING + WVST * WVTILE, VTL = VTH + 2 * VTBOX,
                BARS = VTL + 2 * VTBOX;
  const uint32_t bars = base + BARS;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int nc = D / 64;
  const int sub = blockIdx.x % nc;
  const int q0 = (blockIdx.x / nc) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tiles = p.n_kv / 64, items = tiles * nc;

  auto load_pair = [&](int u) {
    const int s = u % WST32, x = u % nc;
    const uint32_t bar = bars + 8 * s, dst = base + s * WPAIR;
    bar_expect(bar, WPAIR);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      tma_box(dst + y * WBOX, &tp.q, 64 * x + 32 * y, q0, h, b, bar);
      tma_box(dst + (2 + y) * WBOX, &tp.k, 64 * x + 32 * y, (u / nc) * 64,
              h, b, bar);
    }
  };
  auto load_v = [&](int j) {
    const uint32_t bar = bars + 8 * (WST32 + j % WVST),
                   dst = base + VRING + (j % WVST) * WVTILE;
    bar_expect(bar, WVTILE);
#pragma unroll
    for (int y = 0; y < 2; ++y)
      tma_box(dst + y * WBOX, &tp.v, 64 * sub + 32 * y, j * 64, h, b, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < WST32 + WVST; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int u = 0; u < WST32 && u < items; ++u) load_pair(u);
    for (int j = 0; j < WVST && j < tiles; ++j) load_v(j);
  }
  __syncwarp();

  float o[32], pv[32], sc[32], part[32];  // O, P V of a tile, S, a chunk of S
  uint32_t ph[8][4], pl[8][4];            // P's A fragments, hi and lo
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = part[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const uint64_t ql = desc(base + LO), kl = desc(base + LO + 2 * WBOX),
                 vth = desc(base + VTH), vtl = desc(base + VTL);

  for (int j = 0; j < tiles; ++j) {
    for (int x = 0; x < nc; ++x) {
      const int u = j * nc + x, s = u % WST32;
      unsigned char* st = sm + s * WPAIR;
      bar_wait(bars + 8 * s, (u / WST32) & 1);
      split_pass<WPAIR>(st, sm + LO, tid);  // hi in place, lo beside
      fence_async_smem();
      __syncthreads();
      const uint64_t qh = desc(smem_addr(st)),
                     kh = desc(smem_addr(st) + 2 * WBOX);
      hold(part);
      wg_fence();
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = (y * WBOX + kk * 32) / 16;
          mma_tf32_ss(part, qh + off, kl + off, y > 0 || kk > 0);
          mma_tf32_ss(part, ql + off, kh + off, 1);
          mma_tf32_ss(part, qh + off, kh + off, 1);
        }
      wg_commit();
      wg_wait<0>();
      hold(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = x == 0 ? part[i] : sc[i] + part[i];
      __syncthreads();  // the stage and the lo pair are free
      if (tid == 0 && u + WST32 < items) load_pair(u + WST32);
      __syncwarp();
    }

    // v's 64 columns, split transposed; the raw stage goes back to TMA
    bar_wait(bars + 8 * (WST32 + j % WVST), (j / WVST) & 1);
    split_vt<64>(sm + VRING + (j % WVST) * WVTILE, sm + VTH, sm + VTL, tid);
    fence_async_smem();
    __syncthreads();
    if (tid == 0 && j + WVST < tiles) load_v(j + WVST);
    __syncwarp();

    // online softmax: s scale, then exp(s scale - m)
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = __fmul_rn(sc[i], p.scale);
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      alpha[r] = exp_ftz(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp_ftz(sc[i] - m[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split_tf32(sc[4 * kk], ph[kk][0], pl[kk][0]);
      split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // P V from 0, added to the rescaled O in fp32
    hold(pv);
    hold(ph);
    hold(pl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t vo = ((kk >> 2) * VTBOX + (kk & 3) * 32) / 16;
      mma_tf32<64>(pv, ph[kk], vtl + vo, kk > 0);
      mma_tf32<64>(pv, pl[kk], vth + vo, 1);
      mma_tf32<64>(pv, ph[kk], vth + vo, 1);
    }
    wg_commit();
    wg_wait<0>();
    hold(pv);
    hold(ph);
    hold(pl);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = o[i] * alpha[(i >> 1) & 1] + pv[i];
  }

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
  float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h +
              row * p.o_n + sub * 64 + 2 * c;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    *reinterpret_cast<float2*>(og + t * 8) =
        make_float2(o[4 * t] * inv[0], o[4 * t + 1] * inv[0]);
    *reinterpret_cast<float2*>(og + 8 * p.o_n + t * 8) =
        make_float2(o[4 * t + 2] * inv[1], o[4 * t + 3] * inv[1]);
  }
}

// Blocks of the bf16 (dtype 0) or fp32 kernel that fit on one SM, as the
// occupancy API counts them from its registers, threads and shared memory;
// -1 if refused.
template <typename Fn>
int occupancy(Fn fn, int smem) {
  int n = -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, WG, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

template <int D>
int blocks_per_sm(int dtype) {
  return dtype == 0 ? occupancy(flash_fwd_bf16<D>, smem_bf16<D>())
                    : occupancy(flash_fwd_f32<D>, smem_f32<D>());
}

int blocks_per_sm_wide(int dtype) {
  return dtype == 0 ? occupancy(flash_fwd_wide_bf16, smem_wide_bf16())
                    : occupancy(flash_fwd_wide_f32, smem_wide_f32());
}

// q, k, v's TMA maps: bf16 boxes of 64 columns, fp32 of 32; q tiles of 64
// rows, kv tiles of `rows`
bool maps(TmaParams& tp, int D, int B, int H, int esize, int rows) {
  const Params& p = tp.p;
  return tensor_map(&tp.q, p.q, D, p.n_q, H, B, p.q_n, p.q_h, p.q_b, esize,
                    BQ) &&
         tensor_map(&tp.k, p.k, D, p.n_kv, H, B, p.k_n, p.k_h, p.k_b, esize,
                    rows) &&
         tensor_map(&tp.v, p.v, D, p.n_kv, H, B, p.v_n, p.v_h, p.v_b, esize,
                    rows);
}

template <int D>
int launch(int dtype, int B, int H, const Params& p, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // bf16: tiles of 64 rows, boxes of 64 columns; fp32: q tiles of 64 rows,
  // kv tiles of F32<D>::RS, boxes of 32 columns
  const int rows = dtype == 0 ? BK : F32<D>::RS;
  TmaParams tp;
  tp.p = p;
  if (p.n_kv % rows != 0 || !maps(tp, D, B, H, dtype == 0 ? 2 : 4, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.n_q / BQ * (D / 64), H, B);
  cudaError_t e;
  if (dtype == 0) {
    e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bf16<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_bf16<D><<<grid, WG, smem_bf16<D>(), st>>>(tp);
  } else {
    e = cudaFuncSetAttribute(flash_fwd_f32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_f32<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_f32<D><<<grid, WG, smem_f32<D>(), st>>>(tp);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dh a multiple of 128 from 384 up: kv tiles of 64 rows in both dtypes
int launch_wide(int dtype, int B, int H, int D, const Params& p,
                cudaStream_t st) {
  if ((dtype != 0 && dtype != 1) || p.n_kv % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TmaParams tp;
  tp.p = p;
  if (!maps(tp, D, B, H, dtype == 0 ? 2 : 4, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.n_q / BQ * (D / 64), H, B);
  const int smem = dtype == 0 ? smem_wide_bf16() : smem_wide_f32();
  void (*fn)(TmaParams, int) =
      dtype == 0 ? flash_fwd_wide_bf16 : flash_fwd_wide_f32;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fn<<<grid, WG, smem, st>>>(tp, D);
  return static_cast<int>(cudaGetLastError());
}

bool wide(int D) { return D >= FLASH_WIDE_FROM && D % 128 == 0; }

}  // namespace flash

// dtype 0: bf16, 1: fp32 (q, k, v and the output alike). Dh 64, 128 and 256
// take a template instance each, every multiple of 128 from 384 up the
// wide kernel. Strides in elements: (batch, row, head) of q, k, v and the
// output; Dh is contiguous. l and m: the residuals, (B, H, n_q) fp32, both
// or neither (null). Returns a cudaError_t: not 0 if the shape is refused
// or the launch failed.
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
  if (flash::wide(D)) return flash::launch_wide(dtype, B, H, D, p, st);
  switch (D) {
    case 64: return flash::launch<64>(dtype, B, H, p, st);
    case 128: return flash::launch<128>(dtype, B, H, p, st);
    case 256: return flash::launch<256>(dtype, B, H, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How the bf16 (dtype 0) or fp32 kernel runs at this shape: plan[0] the
// blocks it launches, plan[1] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, -1 if refused).
extern "C" int flash_attention_plan(int dtype, int D, int B, int H, int n_q,
                                    int* plan) {
  if (dtype != 0 && dtype != 1) return -1;
  if (flash::wide(D)) {
    plan[1] = flash::blocks_per_sm_wide(dtype);
  } else {
    switch (D) {
      case 64: plan[1] = flash::blocks_per_sm<64>(dtype); break;
      case 128: plan[1] = flash::blocks_per_sm<128>(dtype); break;
      case 256: plan[1] = flash::blocks_per_sm<256>(dtype); break;
      default: return -1;
    }
  }
  plan[0] = n_q / flash::BQ * (D / 64) * H * B;
  return 0;
}
