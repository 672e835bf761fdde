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
// Dh at run time, on a thread-block cluster along Dh: each block holds a
// 128-column slice of q, k, v and O, the blocks' partials of S are added
// once through distributed shared memory and the softmax formed once an
// element by the rows' owners (the "wide head dims" section below), so
// that shared memory does not grow with Dh and S is computed once a pair
// of tiles. The instances stay where they are: the wide kernels built to
// take Dh 128 and 256 too (chip_smoke.py --wide-from-128) measured slower
// there than the instances (PERF.md).

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
// dtype, on a thread-block cluster along Dh, so that S is computed once for
// each (q tile, kv tile) (a block for each 64 output columns that
// contracts S over all of Dh does Dh/64 times the S work: 4.5x the tensor
// work of a tile at Dh 512).
//
// Slices and clusters. Dh is cut into slices of WC = 128 columns, n = Dh /
// 128 of them. The blocks of one q tile (64 rows) form a cluster of cs = n
// blocks (up to the portable limit of 8: Dh 1024), block r at slice r: it
// holds q's slice r (loaded once; in fp32 split hi/lo once), streams the kv
// tiles' slices r, forms its partial of S over its 128 columns and
// accumulates O at them. Above Dh 1024 the kernel runs `rounds` = ceil(n /
// 8) passes of clusters of cs = ceil(n / rounds) blocks a q tile, as the
// fp32 backward does: block r of pass p writes O at slice r + p cs (none
// past n) and contracts slices r, r + cs, ... each kv tile, each slice's q
// and k loaded together into one stage and contracted before the next
// loads (no overlap there); each pass computes S whole, `rounds` times the
// least work, which no Dh up to 1024 pays.
//
// The exchange, one cluster barrier a tile (barrier.cluster.arrive.release
// / wait.acquire). Each block owns a fixed 1/cs of the q tile's rows (rows
// 64 q / cs up to 64 (q + 1) / cs for rank q), a row held by eight "units",
// halves of what the row's four accumulator threads hold (8 scores a unit
// in bf16, 4 in fp32), so that every thread of a block owns a unit from cs
// 4 up (bf16) or 2 up (fp32). Once a barrier has shown every block's
// partial of tile j (each block writes it to its shared memory in the
// accumulator's order), the owner of a unit reads the cs partials of its
// scores through distributed shared memory (mapa once a rank,
// ld.shared::cluster; up to four ranks' loads before their adds), adds
// them in rank order, and forms the online softmax once an element: s
// scale rounded, the row's running max (over its eight units), exp(m_old -
// m_new), p = exp(s scale - m) and the unit's share of the running sum l,
// held by the owner across the tiles. It writes p into every block's
// shared memory (st.shared::cluster) where that block's accumulator thread
// of those scores reads it, in the form its wgmma takes (bf16 packed as
// the A fragment; fp32 as it is, split hi/lo by the reader), and the row's
// rescale factor. The next barrier shows P to every block, which reads its
// rows' P and rescale factors from its own shared memory and adds P·V at
// its 128 columns; the same barrier shows tile j + 1's partials, written
// before it. The partials, P and the rescale factors are double-buffered
// (by the tile's parity), so that one barrier a tile orders every read
// before the write that reuses its buffer. So each element of S is summed
// once, in one order, and every block uses the same bits of p. At the end
// the owners publish each row's l and m: every block divides its O by l,
// and rank 0 of the first pass writes l and m. Measured slower on an H100
// and not kept: every block reading every partial (bf16, one barrier a
// tile, the softmax formed cs times, cs times the remote bytes;
// scripts/probe_wide_forward.py builds it and times it beside this one,
// PERF.md); two barriers a tile (the partials, then P, each read through
// distributed shared memory after its barrier); owners of whole
// quarter-rows whose loads are waited for in place.
//
// Order. A tile's owner loads are issued right after the barrier that
// shows its partials and land under the previous tile's P·V issue and the
// contraction of the tile after it; tile j + 2's contraction is issued
// after tile j's P·V and runs on the tensor cores under tile j + 1's owner
// work. A block's contraction is one group of wgmmas a tile: no chunk of
// Dh is waited for before the next issues. k's slice streams through one
// stage, refilled as soon as its products retire (it lands under the
// barrier and the next owner loads); v's through a ring of two, refilled
// once the P·V that read it has retired (or, in fp32, once it is split
// transposed). One k stage, not two: in bf16 a second (16 KiB) takes a
// block to 131,616 bytes, past the 115,712 at which two blocks fit an SM
// (not tried); in fp32 a second with its lo (32 KiB) does not fit beside
// the 213,536 bytes.
//
// Rounding. bf16: a slice's partial is one wgmma chain (8 k-steps) and the
// partials are added in fp32 in rank order (above Dh 1024 the block's own
// slices in one chain). fp32: S is formed as the fp32 wide backward forms
// it (flash_attention_bwd.cu): a slice's partial is two chains of 24 TF32
// products (its 32-column boxes 0 and 2, and 1 and 3; one a warpgroup),
// each summed by the tensor cores from 0, the two added in fp32, and the
// slices' partials added in rank order, then s scale rounded: the p that
// the forward sums is the p that the backward recomputes from the same m
// and l. Above Dh 1024 the orders part: each warpgroup adds its chain's
// sums over the block's slices r, r + cs, ... in turn, then the owner adds
// the two chains, where the backward adds each slice's two chains first
// and takes the slices from the one after its pass; so there the two may
// form S apart in its last bits (each is held at its bar at Dh 1152,
// chip_smoke.py 7c and 7d). The softmax's steps are the plain version's:
// s scale rounded, its row maximum, then exp(s scale - m); O is rescaled
// by exp(m_old - m_new) each tile and divided by l once.

// The rank of a cluster of cs that owns row r of the q tile.
__device__ __forceinline__ int row_owner(int r, int cs) {
  return ((r + 1) * cs - 1) >> 6;
}

// The exchange's buffers, both dtypes, two of each (a tile's parity): the
// partials (bf16 one chain of 64 x 64 fp32, fp32 two of 64 x 32), P (64
// rows of 64 bf16 or 32 fp32) and the rows' rescale factors.
constexpr int WPARTB = 16384, WPB = 8192, WALB = BQ * 4;

// A unit is half of a row's scores as one accumulator thread holds them:
// unit u of the q tile is row r = u / 8, c = u / 2 % 4 and half i = u % 2,
// the row's columns 8 nt + 2 c and + 1 for nt = NH i to NH i + NH - 1 (NH:
// bf16 4, fp32 2): in every block's partial, elements 4 nt + 2 h and + 1 of
// accumulator thread t = 32 (r / 16) + 4 (r % 8) + c (h = r / 8 % 2), the
// float2 at (2 nt + h) 128 + t of each chain (bf16 one, fp32 two). Eight
// lanes in a row hold a row's units.
template <bool F32>
struct Unit {
  static constexpr int NH = F32 ? 2 : 4, CH = F32 ? 2 : 1, RB = 4;
  static constexpr int CHB = 4 * NH * 128 * 8;  // bytes of a chain's partial
  using Loads = float2[RB][CH][NH];  // RB ranks' loads before their adds
};

__device__ __forceinline__ float oct_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 4));
}

__device__ __forceinline__ float oct_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x + __shfl_xor_sync(FULL, x, 4);
}

// The unit's scores in the partials (at byte offset `part` of each block's
// shared memory, whose address is `base`) of ranks q0 to q0 + RB - 1
// (zeros past cs, and everywhere with `on` false: a thread with no unit,
// which still takes part in its row's shuffles)
template <bool F32>
__device__ __forceinline__ void own_load(typename Unit<F32>::Loads& x,
                                         uint32_t base, int part, int unit,
                                         bool on, int cs, int q0) {
  using U = Unit<F32>;
  const int r = unit >> 3, c = (unit >> 1) & 3, i = unit & 1;
  const int t = 32 * (r >> 4) + 4 * (r & 7) + c, h = (r >> 3) & 1;
#pragma unroll
  for (int qq = 0; qq < U::RB; ++qq) {
    const bool here = on && q0 + qq < cs;
    const uint32_t at =
        (here ? cluster_map(base, q0 + qq) : 0) + part + (h * 128 + t) * 8;
#pragma unroll
    for (int ch = 0; ch < U::CH; ++ch)
#pragma unroll
      for (int n = 0; n < U::NH; ++n) {
        const int nt = U::NH * i + n;
        x[qq][ch][n] = here ? ld_dsmem(at + ch * U::CHB + nt * 2048)
                            : make_float2(0.f, 0.f);
      }
  }
}

// One tile's softmax for a unit the block owns, from the loads of ranks 0
// to RB - 1 (`x`; the others are loaded here): the cs partials added in
// rank order (fp32: each rank's two chains first), s scale rounded, the
// row's running max m over its eight lanes, exp(m_old - m_new), p = exp(s
// scale - m) and the unit's share l of the running sum; p goes to byte
// offset `pout` of every block of the cluster, the 16-byte piece i of
// thread t's row half h at ((2 h + i) 128 + t) 16 (bf16 packed pairs, fp32
// as it is), and the rescale factor to row r at offset `arow`.
template <bool F32>
__device__ __forceinline__ void own_finish(const typename Unit<F32>::Loads& x,
                                           uint32_t base, int part, int pout,
                                           int arow, int unit, bool on,
                                           int cs, float scale, float& m,
                                           float& l) {
  using U = Unit<F32>;
  const int r = unit >> 3, c = (unit >> 1) & 3, i = unit & 1;
  const int t = 32 * (r >> 4) + 4 * (r & 7) + c, h = (r >> 3) & 1;
  float2 a[U::NH];
  auto add = [&](const typename Unit<F32>::Loads& y, int q0) {
#pragma unroll
    for (int qq = 0; qq < U::RB; ++qq)
      if (q0 + qq < cs) {
#pragma unroll
        for (int n = 0; n < U::NH; ++n) {
          float2 v = y[qq][0][n];
          if constexpr (U::CH == 2)
            v = make_float2(v.x + y[qq][1][n].x, v.y + y[qq][1][n].y);
          a[n] = q0 + qq == 0 ? v : make_float2(a[n].x + v.x, a[n].y + v.y);
        }
      }
  };
  add(x, 0);
#pragma unroll
  for (int q0 = U::RB; q0 < WCLUSTER; q0 += U::RB)
    if (q0 < cs) {
      typename Unit<F32>::Loads y;
      own_load<F32>(y, base, part, unit, on, cs, q0);
      add(y, q0);
    }
  float s[2 * U::NH], tmax = neg_inf();
#pragma unroll
  for (int n = 0; n < U::NH; ++n) {
    s[2 * n] = __fmul_rn(a[n].x, scale);
    s[2 * n + 1] = __fmul_rn(a[n].y, scale);
    tmax = fmaxf(tmax, fmaxf(s[2 * n], s[2 * n + 1]));
  }
  const float mn = fmaxf(m, oct_max(tmax));
  const float alpha = exp_ftz(m - mn);  // 0 on the first tile
  m = mn;
  float rs = 0.f;
#pragma unroll
  for (int n = 0; n < U::NH; ++n) {
    const float p0 = exp_ftz(s[2 * n] - m), p1 = exp_ftz(s[2 * n + 1] - m);
    rs += p0 + p1;
    s[2 * n] = p0;
    s[2 * n + 1] = p1;
  }
  l = l * alpha + rs;
  if (!on) return;
  uint4 v;
  if constexpr (F32)
    v = make_uint4(__float_as_uint(s[0]), __float_as_uint(s[1]),
                   __float_as_uint(s[2]), __float_as_uint(s[3]));
  else
    v = make_uint4(pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]),
                   pack_bf16(s[4], s[5]), pack_bf16(s[6], s[7]));
#pragma unroll
  for (int q = 0; q < WCLUSTER; ++q)
    if (q < cs) {
      const uint32_t at = cluster_map(base, q);
      st_dsmem(at + pout + ((2 * h + i) * 128 + t) * 16, v);
      if (c == 0 && i == 0) st_dsmem(at + arow + 4 * r, alpha);
    }
}

// bf16: kv tiles of 64 rows, one warpgroup a block. The block's q slice is
// two 64 x 64 boxes; a k or v slice of a tile two more (16 KiB each). S's
// partial is wgmma m64n64k16 over the slice's 128 columns (8 k-steps, both
// operands K-major in shared memory); O at the block's 128 columns is
// wgmma m64n128k16 with P from registers (the owner writes it packed as
// the A fragment) and v's slice read transposed (MN-major, its two boxes
// 8 KiB apart). Shared memory: 115,232 bytes, two blocks an SM only without
// alignment slack, so the kernel declares it 1024-byte aligned and traps if
// it is not.
constexpr int WSL = 2 * BOX;  // a 64-row slice (16 KiB)
// byte offsets: q's slice, the k stage, the v ring, the partials, P, the
// rescale factors, the barriers (the k stage's, the v ring's, q's)
constexpr int WB_K = WSL, WB_V = WB_K + WSL, WB_PART = WB_V + 2 * WSL,
              WB_P = WB_PART + 2 * WPARTB, WB_AL = WB_P + 2 * WPB,
              WB_BARS = WB_AL + 2 * WALB;
constexpr int smem_wide_bf16() { return WB_BARS + 8 * 4; }

__global__ void __launch_bounds__(WG, 2)
    flash_fwd_wide_bf16(const __grid_constant__ TmaParams tp, int D) {
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  const uint32_t base = smem_addr(wide_smem);
  if (base & 1023) __trap();
  unsigned char* sm = wide_smem;
  const uint32_t kbar = base + WB_BARS, vbars = kbar + 8, qbar = kbar + 24;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const WidePlan w = wide_plan(D);
  const int rank = static_cast<int>(cluster_rank()),
            cs = static_cast<int>(cluster_blocks());
  const int pass = static_cast<int>(blockIdx.x) / cs % w.rounds;
  const int q0 = static_cast<int>(blockIdx.x) / (cs * w.rounds) * BQ,
            h = blockIdx.y, b = blockIdx.z;
  const int gs = rank + pass * cs;  // O's slice (none past n)
  const bool out = gs < w.n;
  const int items = (w.n - rank + cs - 1) / cs;  // slices contracted a tile
  const bool multi = w.rounds > 1;
  const int tiles = p.n_kv / BK;

  // k's slice of tile j into the k stage, v's into the v ring, by thread 0
  auto load_k = [&](int j) {
    bar_expect(kbar, WSL);
#pragma unroll
    for (int x = 0; x < 2; ++x)
      tma_box(base + WB_K + x * BOX, &tp.k, WC * rank + 64 * x, j * BK, h,
              b, kbar);
  };
  auto load_v = [&](int j) {
    const uint32_t bar = vbars + 8 * (j & 1),
                   dst = base + WB_V + (j & 1) * WSL;
    bar_expect(bar, WSL);
#pragma unroll
    for (int x = 0; x < 2; ++x)
      tma_box(dst + x * BOX, &tp.v, WC * gs + 64 * x, j * BK, h, b, bar);
  };
  // with passes, item u (slice rank + (u % items) cs of tile u / items):
  // its q and k slices into q's place and the k stage
  auto load_pair = [&](int u) {
    const int sl = rank + u % items * cs, j = u / items;
    bar_expect(kbar, 2 * WSL);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tma_box(base + x * BOX, &tp.q, WC * sl + 64 * x, q0, h, b, kbar);
      tma_box(base + WB_K + x * BOX, &tp.k, WC * sl + 64 * x, j * BK, h, b,
              kbar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 4; ++s) bar_init(kbar + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (multi) {
      load_pair(0);
    } else {
      bar_expect(qbar, WSL);
#pragma unroll
      for (int x = 0; x < 2; ++x)
        tma_box(base + x * BOX, &tp.q, WC * rank + 64 * x, q0, h, b, qbar);
      load_k(0);
    }
    if (out)
      for (int j = 0; j < 2 && j < tiles; ++j) load_v(j);
  }
  __syncwarp();

  float o[64], sc[32];  // O at the block's 128 columns; S's partial
  uint32_t pa[4][4];    // P's A fragments
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  // the block's partial of tile j's S into sc: one chain, issued and left
  // in flight; with passes every item in turn, each waited for
  auto scores = [&](int j) {
    if (!multi) {
      bar_wait(kbar, j & 1);
      hold(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
        mma_ss(sc, desc(base + off), desc(base + WB_K + off), kk);
      }
      wg_commit();
      return;
    }
    for (int k = 0; k < items; ++k) {
      const int u = j * items + k;
      bar_wait(kbar, u & 1);
      hold(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
        mma_ss(sc, desc(base + off), desc(base + WB_K + off), k > 0 || kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      hold(sc);
      __syncthreads();  // no warp reads the pair any more
      if (tid == 0 && u + 1 < tiles * items) load_pair(u + 1);
      __syncwarp();
    }
  };

  // tile j's partial (its products retired) into its buffer: float2 k of
  // thread tid at k 128 + tid (elements 2 k and 2 k + 1)
  auto publish = [&](int j) {
    float2* pw = reinterpret_cast<float2*>(sm + WB_PART + (j & 1) * WPARTB);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      pw[k * WG + tid] = make_float2(sc[2 * k], sc[2 * k + 1]);
  };

  // the units the block owns (eight a row): at most 512 (cs 1) over 128
  // threads, in turns; the first turn's loads are issued ahead (all of
  // them from cs 4 up; a second turn's, at cs 3, would spill registers)
  constexpr int IT = 4;
  const int lo_u = 8 * (rank * BQ / cs), hi_u = 8 * ((rank + 1) * BQ / cs);
  float om[IT], ol[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    om[it] = neg_inf();
    ol[it] = 0.f;
  }
  typename Unit<false>::Loads xo;
  auto own_pref = [&](int j) {
    const int u = lo_u + tid;
    own_load<false>(xo, base, WB_PART + (j & 1) * WPARTB, u, u < hi_u, cs, 0);
  };
  auto own_fin = [&](int j) {
    const int part = WB_PART + (j & 1) * WPARTB, pout = WB_P + (j & 1) * WPB,
              arow = WB_AL + (j & 1) * WALB;
    own_finish<false>(xo, base, part, pout, arow, lo_u + tid,
                      lo_u + tid < hi_u, cs, p.scale, om[0], ol[0]);
#pragma unroll
    for (int it = 1; it < IT; ++it)
      if (lo_u + it * WG < hi_u) {
        const int u = lo_u + it * WG + tid;
        typename Unit<false>::Loads y;
        own_load<false>(y, base, part, u, u < hi_u, cs, 0);
        own_finish<false>(y, base, part, pout, arow, u, u < hi_u, cs, p.scale,
                          om[it], ol[it]);
      }
  };

  // P and the rescale factors of the warp's rows (g and g + 8), from this
  // block's shared memory; O rescaled and O += P V_j, left in flight
  auto consume = [&](int j) {
    if (!out) return;
    const uint4* pr =
        reinterpret_cast<const uint4*>(sm + WB_P + (j & 1) * WPB);
    const float* ar =
        reinterpret_cast<const float*>(sm + WB_AL + (j & 1) * WALB);
    float al[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 x = pr[(2 * hh + i) * WG + tid];
        const uint32_t v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nt = 4 * i + e;
          pa[nt >> 1][(nt & 1) * 2 + hh] = v[e];
        }
      }
      al[hh] = ar[16 * warp + g + 8 * hh];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= al[(i >> 1) & 1];
    bar_wait(vbars + 8 * (j & 1), (j >> 1) & 1);
    const uint32_t vt = base + WB_V + (j & 1) * WSL;
    hold(o);
    hold(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs128(o, pa[kk], desc_mn(vt + kk * 16 * 128, BOX));
    wg_commit();
  };

  if (!multi) bar_wait(qbar, 0);
  scores(0);
  wg_wait<0>();
  hold(sc);
  publish(0);
  __syncthreads();  // no warp reads the k stage: it takes tile 1
  if (tid == 0 && !multi && tiles > 1) load_k(1);
  __syncwarp();
  cluster_sync();  // every block has started and written tile 0's partial
  if (tiles > 1) scores(1);
  own_pref(0);
  own_fin(0);
  wg_wait<0>();
  hold(sc);
  if (tiles > 1) publish(1);
  __syncthreads();
  if (tid == 0 && !multi && tiles > 2) load_k(2);
  __syncwarp();
  cluster_sync();  // P of tile 0 and the partials of tile 1 are seen
  for (int j = 0; j < tiles; ++j) {
    // tile j + 1's remote loads are in flight under P V's issue and tile j
    // + 2's contraction
    if (j + 1 < tiles) own_pref(j + 1);
    consume(j);
    if (j + 2 < tiles) scores(j + 2);
    if (j + 1 < tiles) own_fin(j + 1);
    // P V of tile j and S of tile j + 2 have retired
    wg_wait<0>();
    hold(o);
    hold(pa);
    hold(sc);
    if (j + 2 < tiles) publish(j + 2);
    __syncthreads();  // the k stage takes tile j + 3, v's of j tile j + 2
    if (tid == 0) {
      if (!multi && j + 3 < tiles) load_k(j + 3);
      if (out && j + 2 < tiles) load_v(j + 2);
    }
    __syncwarp();
    cluster_sync();  // P of tile j + 1 and the partials of tile j + 2 seen
  }

  // each row's l and m from its owner (in the partials' place, read by no
  // block after the last barrier); O / l; rank 0 of the first pass writes
  // l and m
  float* lm = reinterpret_cast<float*>(sm + WB_PART);
#pragma unroll
  for (int it = 0; it < IT; ++it)
    if (lo_u + it * WG < hi_u) {
      const int u = lo_u + it * WG + tid;
      const float ls = oct_sum(ol[it]);
      if (u < hi_u && (u & 7) == 0) {
        lm[u >> 3] = ls;
        lm[BQ + (u >> 3)] = om[it];
      }
    }
  cluster_sync();
  const int row = q0 + warp * 16 + g;  // and row + 8
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh, ow = row_owner(r, cs);
    const float ls = ld_cluster_f(base + WB_PART + 4 * r, ow);
    inv[hh] = 1.f / ls;
    if (p.l != nullptr && rank == 0 && pass == 0 && c == 0) {
      const long long i =
          (static_cast<long long>(b) * gridDim.y + h) * p.n_q + row + 8 * hh;
      p.l[i] = ls;
      p.m[i] = ld_cluster_f(base + WB_PART + 4 * (BQ + r), ow);
    }
  }
  if (out) {
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_b +
                        h * p.o_h + row * p.o_n + WC * gs + 2 * c;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(og + t * 8) =
          __floats2bfloat162_rn(o[4 * t] * inv[0], o[4 * t + 1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_n + t * 8) =
          __floats2bfloat162_rn(o[4 * t + 2] * inv[1],
                                o[4 * t + 3] * inv[1]);
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

// fp32: split TF32, kv tiles of WRS = 32 rows, two warpgroups a block. The
// q slice (four 64 x 32 boxes, 32 KiB) is split once, hi in place and lo
// beside. Warpgroup w forms chain w of the block's partial (boxes w and w +
// 2 of the slice: 8 k-steps, each hi lo', lo hi', hi hi', by wgmma
// m64n32k8 .tf32 with both operands K-major in shared memory), splitting
// those two boxes of the k slice (hi in place, lo beside) once they land,
// and O's 64 columns 64 w to 64 w + 63 of the slice: v's slice at them
// split and written transposed (VT, hi and lo, each 8 rows in the order 0,
// 2, 4, 6, 1, 3, 5, 7, as at Dh 64) and P V by wgmma m64n64k8 with P's A
// fragments, split in registers, from the owner's fp32 p. P V is summed by
// the tensor cores from 0 each tile and added to the rescaled O by the FMA
// pipes once it retires. 64-row kv tiles do not fit: q's hi and lo (64
// KiB), the k stage and its lo, two stages of v (64 KiB together), VT's hi
// and lo (32 KiB) and the exchange (48 KiB) take 209 KiB at 32 rows; at 64
// the kv tiles, VT and the exchange double (353 KiB).
constexpr int WRS = 32;          // kv rows a tile
constexpr int WT = 2 * WG;       // threads a block
constexpr int WFB = BQ * 128;    // a q box: 64 rows x 32 columns
constexpr int WSB = WRS * 128;   // a k or v box: 32 rows x 32 columns
constexpr int WQS = 4 * WFB;     // q's slice
constexpr int WKS = 4 * WSB;     // a k or v slice
constexpr int WVT = WC * 128;    // v's slice transposed: 128 rows of 32
// byte offsets: q's slice (hi in place), its lo, the k stage (hi in place
// once split), k's lo, the v ring, VT's hi and lo, the partials, P, the
// rescale factors, the barriers (the k stage's, the v ring's, q's)
constexpr int WF_QLO = WQS, WF_K = 2 * WQS, WF_KLO = WF_K + WKS,
              WF_V = WF_KLO + WKS, WF_VT = WF_V + 2 * WKS,
              WF_PART = WF_VT + 2 * WVT, WF_P = WF_PART + 2 * WPARTB,
              WF_AL = WF_P + 2 * WPB, WF_BARS = WF_AL + 2 * WALB;
constexpr int smem_wide_f32() { return WF_BARS + 8 * 4; }
static_assert(smem_wide_f32() <= 232448, "more than a block's shared memory");

__global__ void __launch_bounds__(WT, 1)
    flash_fwd_wide_f32(const __grid_constant__ TmaParams tp, int D) {
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  const uint32_t base = smem_addr(wide_smem);
  if (base & 1023) __trap();
  unsigned char* sm = wide_smem;
  const uint32_t kbar = base + WF_BARS, vbars = kbar + 8, qbar = kbar + 24;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & (WG - 1);
  const int warp = t >> 5, g = (t & 31) >> 2, c = t & 3;
  const WidePlan w = wide_plan(D);
  const int rank = static_cast<int>(cluster_rank()),
            cs = static_cast<int>(cluster_blocks());
  const int pass = static_cast<int>(blockIdx.x) / cs % w.rounds;
  const int q0 = static_cast<int>(blockIdx.x) / (cs * w.rounds) * BQ,
            h = blockIdx.y, b = blockIdx.z;
  const int gs = rank + pass * cs;  // O's slice (none past n)
  const bool out = gs < w.n;
  const int items = (w.n - rank + cs - 1) / cs;  // slices contracted a tile
  const bool multi = w.rounds > 1;
  const int tiles = p.n_kv / WRS;

  auto load_k = [&](int j) {
    bar_expect(kbar, WKS);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      tma_box(base + WF_K + x * WSB, &tp.k, WC * rank + 32 * x, j * WRS, h,
              b, kbar);
  };
  auto load_v = [&](int j) {
    const uint32_t bar = vbars + 8 * (j & 1),
                   dst = base + WF_V + (j & 1) * WKS;
    bar_expect(bar, WKS);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      tma_box(dst + x * WSB, &tp.v, WC * gs + 32 * x, j * WRS, h, b, bar);
  };
  auto load_pair = [&](int u) {
    const int sl = rank + u % items * cs, j = u / items;
    bar_expect(kbar, WQS + WKS);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      tma_box(base + x * WFB, &tp.q, WC * sl + 32 * x, q0, h, b, kbar);
      tma_box(base + WF_K + x * WSB, &tp.k, WC * sl + 32 * x, j * WRS, h, b,
              kbar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 4; ++s) bar_init(kbar + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (multi) {
      load_pair(0);
    } else {
      bar_expect(qbar, WQS);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        tma_box(base + x * WFB, &tp.q, WC * rank + 32 * x, q0, h, b, qbar);
      load_k(0);
    }
    if (out)
      for (int j = 0; j < 2 && j < tiles; ++j) load_v(j);
  }
  __syncwarp();

  // the warpgroup's boxes (wg and wg + 2) of q's slice and of the k slice,
  // split: hi in place, lo beside
  auto split_q = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = wg + 2 * i;
      split_pass<WFB>(sm + x * WFB, sm + WF_QLO + x * WFB, t);
    }
  };
  auto split_k = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = wg + 2 * i;
      split_pass<WSB>(sm + WF_K + x * WSB, sm + WF_KLO + x * WSB, t);
    }
  };
  // the warpgroup's chain of S's partial (boxes wg and wg + 2, 24
  // products) into d from 0, one commit group
  const uint64_t qh = desc(base), ql = desc(base + WF_QLO),
                 kh = desc(base + WF_K), kl = desc(base + WF_KLO);
  auto chain = [&](float (&d)[WRS / 2]) {
    hold(d);
    wg_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int x = wg + 2 * i;
        const uint32_t fo = (x * WFB + kk * 32) / 16,
                       so = (x * WSB + kk * 32) / 16;
        mma_tf32_ss(d, qh + fo, kl + so, i > 0 || kk > 0);
        mma_tf32_ss(d, ql + fo, kh + so, 1);
        mma_tf32_ss(d, qh + fo, kh + so, 1);
      }
    wg_commit();
  };

  float o[32], pv[32], sc[WRS / 2];  // O, P V of a tile, S's chain
  uint32_t ph[WRS / 8][4], pl[WRS / 8][4];  // P's A fragments, hi and lo
  float al[2] = {0.f, 0.f};  // the rescale of the tile whose P V runs
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = pv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WRS / 2; ++i) sc[i] = 0.f;

  // the warpgroup's chain of tile j's S into sc, left in flight; with
  // passes every item in turn (q and k split), each waited for and added
  auto scores = [&](int j) {
    if (!multi) {
      bar_wait(kbar, j & 1);
      split_k();
      fence_async_smem();
      named_sync(1 + wg, WG);
      chain(sc);
      return;
    }
    for (int k = 0; k < items; ++k) {
      const int u = j * items + k;
      bar_wait(kbar, u & 1);
      split_q();
      split_k();
      fence_async_smem();
      named_sync(1 + wg, WG);
      float part[WRS / 2];
#pragma unroll
      for (int i = 0; i < WRS / 2; ++i) part[i] = 0.f;
      chain(part);
      wg_wait<0>();
      hold(part);
#pragma unroll
      for (int i = 0; i < WRS / 2; ++i)
        sc[i] = k == 0 ? part[i] : sc[i] + part[i];
      __syncthreads();  // no warp reads the pair any more
      if (tid == 0 && u + 1 < tiles * items) load_pair(u + 1);
      __syncwarp();
    }
  };

  // tile j's chains (their products retired) into their buffer: chain wg's
  // float2 k of thread t at (8 wg + k) 128 + t
  auto publish = [&](int j) {
    float2* pw = reinterpret_cast<float2*>(sm + WF_PART + (j & 1) * WPARTB) +
                 wg * 8 * WG;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      pw[k * WG + t] = make_float2(sc[2 * k], sc[2 * k + 1]);
  };

  // the units the block owns (eight a row): at most 512 (cs 1) over 256
  // threads, in turns, a turn's 64-unit groups spread over both
  // warpgroups; the first turn's loads are issued ahead
  constexpr int IT = 2;
  const int lo_u = 8 * (rank * BQ / cs), hi_u = 8 * ((rank + 1) * BQ / cs);
  const int ku = (tid & 63) + 64 * ((tid >> 7) & 1) + 128 * ((tid >> 6) & 1);
  float om[IT] = {neg_inf(), neg_inf()}, ol[IT] = {0.f, 0.f};
  typename Unit<true>::Loads xo;
  auto own_pref = [&](int j) {
    const int u = lo_u + ku;
    own_load<true>(xo, base, WF_PART + (j & 1) * WPARTB, u, u < hi_u, cs, 0);
  };
  auto own_fin = [&](int j) {
    const int part = WF_PART + (j & 1) * WPARTB, pout = WF_P + (j & 1) * WPB,
              arow = WF_AL + (j & 1) * WALB;
    own_finish<true>(xo, base, part, pout, arow, lo_u + ku, lo_u + ku < hi_u,
                     cs, p.scale, om[0], ol[0]);
    if (lo_u + WT < hi_u) {
      const int u = lo_u + WT + ku;
      typename Unit<true>::Loads y;
      own_load<true>(y, base, part, u, u < hi_u, cs, 0);
      own_finish<true>(y, base, part, pout, arow, u, u < hi_u, cs, p.scale,
                       om[1], ol[1]);
    }
  };

  // P and the rescale factors of the warp's rows, from this block's shared
  // memory; v's slice at the warpgroup's columns split transposed; P V
  // from 0, left in flight
  const uint64_t vth = desc(base + WF_VT + 64 * wg * 128),
                 vtl = vth + WVT / 16;
  auto consume = [&](int j) {
    if (!out) return;
    const uint4* pr =
        reinterpret_cast<const uint4*>(sm + WF_P + (j & 1) * WPB);
    const float* ar =
        reinterpret_cast<const float*>(sm + WF_AL + (j & 1) * WALB);
    // element 4 nt + 2 hh + e: row hh of the warp's, column 8 nt + 2 c + e
    float pf[WRS / 2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 x = pr[(2 * hh + i) * WG + t];
        const uint32_t v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pf[4 * (2 * i + (e >> 1)) + 2 * hh + (e & 1)] =
              __uint_as_float(v[e]);
      }
      al[hh] = ar[16 * warp + g + 8 * hh];
    }
    bar_wait(vbars + 8 * (j & 1), (j >> 1) & 1);
    split_vt<WRS>(sm + WF_V + (j & 1) * WKS + 2 * wg * WSB,
                  sm + WF_VT + 64 * wg * 128,
                  sm + WF_VT + WVT + 64 * wg * 128, t);
    fence_async_smem();
    named_sync(1 + wg, WG);
    // k = c is column 2 c of each 8, k = c + 4 is 2 c + 1
#pragma unroll
    for (int kk = 0; kk < WRS / 8; ++kk) {
      split_tf32(pf[4 * kk], ph[kk][0], pl[kk][0]);
      split_tf32(pf[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split_tf32(pf[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split_tf32(pf[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    hold(pv);
    hold(ph);
    hold(pl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WRS / 8; ++kk) {
      mma_tf32<64>(pv, ph[kk], vtl + kk * 2, kk > 0);
      mma_tf32<64>(pv, pl[kk], vth + kk * 2, 1);
      mma_tf32<64>(pv, ph[kk], vth + kk * 2, 1);
    }
    wg_commit();
  };

  if (!multi) {
    bar_wait(qbar, 0);
    split_q();  // seen by tile 0's products after scores' fence and sync
  }
  scores(0);
  wg_wait<0>();
  hold(sc);
  publish(0);
  __syncthreads();  // no warp reads the k stage: it takes tile 1
  if (tid == 0 && !multi && tiles > 1) load_k(1);
  __syncwarp();
  cluster_sync();  // every block has started and written tile 0's partial
  if (tiles > 1) scores(1);
  own_pref(0);
  own_fin(0);
  wg_wait<0>();
  hold(sc);
  if (tiles > 1) publish(1);
  __syncthreads();
  if (tid == 0 && !multi && tiles > 2) load_k(2);
  __syncwarp();
  cluster_sync();  // P of tile 0 and the partials of tile 1 are seen
  for (int j = 0; j < tiles; ++j) {
    // tile j + 1's remote loads are in flight under P V and tile j + 2's
    // contraction
    if (j + 1 < tiles) own_pref(j + 1);
    consume(j);
    if (j + 2 < tiles) scores(j + 2);
    if (j + 1 < tiles) own_fin(j + 1);
    // P V of tile j and S of tile j + 2 have retired: O = O exp(m_old -
    // m_new) + P V
    wg_wait<0>();
    hold(pv);
    hold(ph);
    hold(pl);
    hold(sc);
    if (out) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = o[i] * al[(i >> 1) & 1] + pv[i];
    }
    if (j + 2 < tiles) publish(j + 2);
    __syncthreads();  // the k stage takes tile j + 3, v's of j tile j + 2
    if (tid == 0) {
      if (!multi && j + 3 < tiles) load_k(j + 3);
      if (out && j + 2 < tiles) load_v(j + 2);
    }
    __syncwarp();
    cluster_sync();  // P of tile j + 1 and the partials of tile j + 2 seen
  }

  // each row's l and m from its owner (in the partials' place, read by no
  // block after the last barrier); O / l; rank 0 of the first pass writes
  // l and m
  float* lm = reinterpret_cast<float*>(sm + WF_PART);
#pragma unroll
  for (int it = 0; it < IT; ++it)
    if (lo_u + it * WT < hi_u) {
      const int u = lo_u + it * WT + ku;
      const float ls = oct_sum(ol[it]);
      if (u < hi_u && (u & 7) == 0) {
        lm[u >> 3] = ls;
        lm[BQ + (u >> 3)] = om[it];
      }
    }
  cluster_sync();
  const int row = q0 + warp * 16 + g;  // and row + 8
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh, ow = row_owner(r, cs);
    const float ls = ld_cluster_f(base + WF_PART + 4 * r, ow);
    inv[hh] = 1.f / ls;
    if (p.l != nullptr && rank == 0 && pass == 0 && wg == 0 && c == 0) {
      const long long i =
          (static_cast<long long>(b) * gridDim.y + h) * p.n_q + row + 8 * hh;
      p.l[i] = ls;
      p.m[i] = ld_cluster_f(base + WF_PART + 4 * (BQ + r), ow);
    }
  }
  if (out) {
    float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h +
                row * p.o_n + WC * gs + 64 * wg + 2 * c;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      *reinterpret_cast<float2*>(og + q * 8) =
          make_float2(o[4 * q] * inv[0], o[4 * q + 1] * inv[0]);
      *reinterpret_cast<float2*>(og + 8 * p.o_n + q * 8) =
          make_float2(o[4 * q + 2] * inv[1], o[4 * q + 3] * inv[1]);
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

// Blocks of the kernel `fn` that fit on one SM with `smem` bytes of shared
// memory and `threads` a block, as the occupancy API counts them from its
// registers, threads and shared memory; -1 if refused.
template <typename Fn>
int occupancy(Fn fn, int smem, int threads = WG) {
  int n = -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

template <int D>
int blocks_per_sm(int dtype) {
  return dtype == 0 ? occupancy(flash_fwd_bf16<D>, smem_bf16<D>())
                    : occupancy(flash_fwd_f32<D>, smem_f32<D>());
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

// The wide kernel's launch (dtype 0 bf16, 1 fp32) at a shape of n_q query
// rows: a cluster of cs blocks along Dh for each q tile and pass, one
// warpgroup a block in bf16 and two in fp32, its shared memory, on stream
// `st`.
inline void wide_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& at,
                        int dtype, int n_q, int B, int H, int D,
                        cudaStream_t st) {
  wide_launch_config(cfg, at, n_q / BQ, B, H, D, dtype == 0 ? WG : WT,
                     dtype == 0 ? smem_wide_bf16() : smem_wide_f32(), st);
}

using WideFn = void (*)(TmaParams, int);

inline WideFn wide_kernel(int dtype) {
  return dtype == 0 ? flash_fwd_wide_bf16 : flash_fwd_wide_f32;
}

// Dh a multiple of 128 from 384 up: kv tiles of 64 rows (bf16) or WRS
// (fp32), on clusters along Dh
int launch_wide(int dtype, int B, int H, int D, const Params& p,
                cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = dtype == 0 ? BK : WRS;
  TmaParams tp;
  tp.p = p;
  if (p.n_kv % rows != 0 || !maps(tp, D, B, H, dtype == 0 ? 2 : 4, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at;
  wide_config(cfg, at, dtype, p.n_q, B, H, D, st);
  const WideFn fn = wide_kernel(dtype);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, fn, tp, D);
  if (e != cudaSuccess) return static_cast<int>(e);
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

// How the bf16 (dtype 0) or fp32 kernel runs at this shape, four ints:
// plan[0] the blocks it launches, plan[1] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, -1 if refused), plan[2]
// its cluster's blocks (1 without a cluster), plan[3] its clusters resident
// at once (cudaOccupancyMaxActiveClusters, 0 without a cluster, -1 if
// refused).
extern "C" int flash_attention_plan(int dtype, int D, int B, int H, int n_q,
                                    int* plan) {
  if (dtype != 0 && dtype != 1) return -1;
  plan[0] = n_q / flash::BQ * (D / 64) * H * B;
  plan[2] = 1;
  plan[3] = 0;
  if (flash::wide(D)) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at;
    flash::wide_config(cfg, at, dtype, n_q, B, H, D, nullptr);
    const flash::WideFn fn = flash::wide_kernel(dtype);
    plan[0] = static_cast<int>(cfg.gridDim.x * cfg.gridDim.y * cfg.gridDim.z);
    plan[1] = flash::occupancy(fn, static_cast<int>(cfg.dynamicSmemBytes),
                               static_cast<int>(cfg.blockDim.x));
    plan[2] = static_cast<int>(at.val.clusterDim.x);
    if (cudaOccupancyMaxActiveClusters(&plan[3], fn, &cfg) != cudaSuccess)
      plan[3] = -1;
    return 0;
  }
  switch (D) {
    case 64: plan[1] = flash::blocks_per_sm<64>(dtype); break;
    case 128: plan[1] = flash::blocks_per_sm<128>(dtype); break;
    case 256: plan[1] = flash::blocks_per_sm<256>(dtype); break;
    default: return -1;
  }
  return 0;
}
