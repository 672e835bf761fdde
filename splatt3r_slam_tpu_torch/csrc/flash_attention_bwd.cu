// Flash attention, backward, for NVIDIA Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels that the backward of JAX's Pallas flash
// attention runs (jax/experimental/pallas/ops/tpu/flash_attention.py, the
// custom_vjp rule `_flash_attention_bwd`), which
// `splatt3r_slam_tpu/models/layers.py::_attend_flash` reaches under
// jax.grad when the flash-attention mode asks for it:
//   flash_bwd_*<D, true>  for `_flash_attention_dkv_kernel` (dK and dV,
//                         launched by `_flash_attention_bwd_dkv`);
//   flash_bwd_*<D, false> for `_flash_attention_dq_kernel` (dQ, launched by
//                         `_flash_attention_bwd_dq`).
// What they compute, per (batch, head), non-causal, no bias, no segment
// ids, from q, do (n_q, Dh), k, v (n_kv, Dh), the forward's residuals m and
// l and di = sum(o * do) over Dh (fp32, (B, H, n_q) each), in the TPU
// kernels' steps:
//   s  = q k^T summed in fp32, then times the softmax scale;
//   p  = exp(s - m) * (1 / l) in fp32;
//   dv = sum over q of p^T do, p rounded to do's dtype, summed in fp32;
//   dp = do v^T in fp32;  ds = (dp - di) * p * scale;
//   dk = sum over q of ds^T q and dq = sum over kv of ds k, ds rounded to
//        the inputs' dtype, summed in fp32;
//   each gradient rounded once to its input's dtype at the end.
// As on the TPU the two are separate kernels: each gradient row is summed
// by one block in one order (the streamed tiles in turn, 64 rows each),
// with no atomics, so the gradients are the same bits from run to run.
// The TPU walks 128 x 128 blocks: only the order of the fp32 sums differs.
//
// Layout. q, k, v, do and the gradients are in the JAX layout (B, N, H,
// Dh) with Dh contiguous, each given by its (batch, row, head) strides in
// elements, so that v can be the strided view of the fused qkv projection
// (row stride 3·H·Dh) and no copy is made; every row start 16-byte
// aligned. n_q and n_kv are multiples of 64.
//
// What bounds them on an H100 (bf16, ViT-L's shapes: B 2, N 768, H 16, Dh
// 64; B·H·n_q·n_kv·Dh = 1.21e9): dK/dV makes four products (S, dV, dP, dK),
// 9.66 GFLOP, 9.8 us at the dense bf16 tensor-core peak (989 TFLOP/s); dQ
// three (S, dP, dQ), 7.25 GFLOP, 7.3 us. Each also evaluates B·H·n_q·n_kv
// exponentials (18.9 M) on the special function units, about 4.7 us, and
// moves a few MB (under 3 us at 3.35 TB/s): both are bound by operations,
// so the design is about keeping the tensor cores fed. In fp32 each product
// is three TF32 products (split TF32, below) on the tensor cores: 495 / 3
// = 165 TFLOP/s of fp32-accurate products, against 67 on the fp32 pipes.
//
// Design, bf16. A block is one warpgroup (128 threads). It owns a tile of
// 64 "fixed" rows and 64 columns of the gradients it writes, and walks the
// other side's rows in tiles of 64 "streamed" rows:
//   dK/dV: fixed rows are kv rows (k and v); streamed rows are q rows (q,
//          do and their m, l, di). S^T = K Q^T and dP^T = V dO^T, so that
//          P^T and dS^T come out of the accumulators already transposed,
//          as the A operands of dV += P^T dO and dK += dS^T Q.
//   dQ:    fixed rows are q rows (q, do; m, 1/l, di in registers);
//          streamed rows are kv rows (k, v). S = Q K^T, dP = dO V^T,
//          dQ += dS K.
// The products are wgmma m64n64k16 (bf16 in, fp32 accumulate). S and dP read
// both operands from shared memory (K-major). The fp32 accumulator of m64n64
// holds, pair by pair, the bf16 A-register fragment of the next wgmma, so P
// and dS go from registers to the tensor cores rounded to bf16, and the
// second products read their B operand (the streamed tile that entered S, or
// dO) from the same shared tile, transposed by the wgmma itself (MN-major,
// tnspB): no shared-memory transpose and no scalar loads. Tiles arrive by TMA
// (cuTensorMapEncodeTiled on the host, from the strides the entry point is
// given; a 4-d (Dh, N, H, B) map, boxes of 64 rows x 64 columns, 128 bytes a
// row, 128-byte swizzle, which is the layout wgmma's descriptors read),
// completing on an mbarrier: the fixed tiles once, the streamed tiles (and,
// for dK/dV, m, l and di by a bulk copy) through a ring of 3 stages (Dh 64)
// or 2 (Dh above 64). One thread issues each tile's copies, so no thread
// spends registers or instructions on addresses. For dK/dV, 1/l is computed
// once per tile into shared memory. Within a tile, S and dP are two commit
// groups: P is formed while dP runs. dQ leaves its product dQ += dS K in
// flight over the next tile's S and dP; dK/dV retires dV and dK within the
// tile, because with them in flight ptxas serialised every wgmma of the
// kernel (C7515; measurably slower on an H100).
// Occupancy: one warpgroup a block and no producer warp, so the registers
// go to the accumulators (S, dP and the gradients, 32 fp32 registers each
// a thread): at Dh 64, 158 registers (dK/dV) and 138 (dQ), 3 blocks an
// SM, and the blocks on one SM overlap one's exponentials with another's
// products. ViT-L's grids are 144 to 384 blocks of 64 rows, 0.36 to 0.97
// waves of 396 slots. A cluster of two blocks splitting the streamed tiles
// of the small B1 grids (and adding its halves through distributed shared
// memory) measured no faster and is not kept. For Dh above 64 the
// gradient's columns are split over Dh/64 blocks that share their fixed
// rows and each recompute S and dP (every block holds 64 accumulator
// columns a gradient, whatever Dh, and nothing spills).
// The exponential is __expf's (ex2.approx of x log2 e) with denormal
// results flushed to zero.
//
// Design, fp32: split TF32 on the tensor cores, the same blocks, rows and
// columns as bf16, the same steps and no rounding to a narrower type: every
// operand x of every product, p and ds included, is hi + lo (hi = tf32(x),
// lo = tf32(x - hi), rounded to nearest as cvt.rna.tf32.f32 rounds) and
// x y = hi hi' + hi lo' + lo hi' in fp32 (flash_common.cuh). wgmma takes no transposed tf32 operand, so:
//   S and dP are wgmma m64nRSk8 .tf32 with the streamed tile as B, K-major
//   as TMA lays it (boxes of 32 fp32 columns, 128-byte swizzle; the same
//   byte layout as bf16's boxes, a k-step is 32 bytes): after each tile
//   lands, one pass of the warpgroup rounds it to hi in place and writes
//   lo beside it (fence.proxy.async before the wgmmas read them). At Dh 64
//   and 128 the fixed tiles are split once the same way and are A by
//   descriptor; above 128 their hi and lo do not fit beside the ring, so
//   they stay raw and each box's A fragments are split in registers (S's
//   and dP's groups alternate, one's fragments loaded while the other's
//   run).
//   dV += P^T dO, dK += dS^T Q and dQ += dS K contract over the streamed
//   rows, the B operand's strided index, so they are mma.sync m16n8k8
//   .tf32: P and dS are already A fragments in the accumulator's
//   registers once the contraction index of each 8 is permuted (k = c is
//   column 2 c, k = c + 4 is 2 c + 1), and B's hi and lo come from the
//   split tile by address, 16 bytes a load, with the n-tiles' columns
//   interleaved so that a quarter warp's loads fall in distinct banks.
// The tensor cores sum in fp32 but do not round to nearest, so a long
// chain drifts (one chain over all 768 streamed rows of ViT-L's shapes
// missed the 1e-5 bar on an H100): S and dP are summed from 0 in parts
// (half of the boxes each at Dh 64 and 128, 12 or 24 products; one box,
// 12, above) and each tile of a gradient (RS / 8 x 3 products) from 0,
// and the parts added in fp32 by the FMA pipes. A wgmma's time grows less than its N, so the
// streamed tiles (RS rows, the N of S and dP) are as tall as shared
// memory allows: RS 32 with a 2-stage ring at Dh 64 (the fixed hi and lo,
// the ring and the lo tiles take 113 KB, two blocks an SM) and 128 (225
// KB), RS 16 with two stages at 256. RS 64 at Dh 64
// made S and dP cheaper a row but leaves one block an SM, slower at
// ViT-L's B1 grids. The exponential is bf16's (ex2.approx, flushed).
//
// Head dims: those of the forward (flash_attention.cu). Dh 64, 128 and 256
// are template instances of the kernels above; every multiple of 128 from
// 384 up runs on one wide kernel a dtype and gradient, Dh at run time
// ("wide head dims" below), in both dtypes on a thread-block cluster along
// Dh: each block contracts its own 128 columns and the cluster adds the
// partials of S and dP through distributed shared memory, so that they are
// computed once for each pair of tiles.

#include "flash_common.cuh"  // mbarrier, TMA, wgmma and split-TF32 helpers

namespace flash_bwd {

using namespace flash_common;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* m;   // (B, H, n_q)
  const float* l;   // (B, H, n_q)
  const float* di;  // (B, H, n_q)
  void* g1;         // dK (dK/dV kernel) or dQ (dQ kernel)
  void* g2;         // dV, or null
  int n_q, n_kv;
  long long q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, d_b, d_n, d_h;
  long long g1_b, g1_n, g1_h, g2_b, g2_n, g2_h;
  float scale;
};

// ---------------------------------------------------------------- bf16 ----

constexpr int ROWS = 64;             // rows of every tile, fixed or streamed
constexpr int BOX = ROWS * 64 * 2;   // bytes of a 64 x 64 box (128-byte rows)
constexpr int WG = 128;              // threads a block: one warpgroup

template <int D>
struct Ring {
  static constexpr int NSUB = D / 64;             // boxes a tile
  static constexpr int TILE = NSUB * BOX;         // bytes of a 64-row tile
  static constexpr int STAGES = D == 64 ? 3 : 2;  // streamed tiles a ring
};

// 1024 bytes to align the swizzled tiles, the two fixed tiles, the ring
// (two tiles a stage), for dK/dV m, l, di and 1/l of each stage, and the
// barriers (one a stage, one for the fixed tiles)
template <int D, bool DKV>
constexpr int smem_bf16() {
  using R = Ring<D>;
  return 1024 + (2 + 2 * R::STAGES) * R::TILE +
         (DKV ? R::STAGES * 4 * ROWS * 4 : 0) + 8 * (R::STAGES + 1);
}

struct TmaParams {
  CUtensorMap f1, f2;  // fixed rows: k, v (dK/dV) or q, do (dQ)
  CUtensorMap s1, s2;  // streamed rows: q, do (dK/dV) or k, v (dQ)
  Params p;
};

// Accumulator element i of m64n64 lies at row 16 warp + g + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 c + (i & 1) (g = lane / 4, c = lane % 4); the
// A fragment of the k-step kk (columns 16 kk to 16 kk + 15) is elements
// 8 kk to 8 kk + 7, paired in order.
template <int D, bool DKV>
__global__ void __launch_bounds__(WG, DKV ? 2 : 3)
    flash_bwd_bf16(const __grid_constant__ TmaParams tp) {
  static_assert(D % 64 == 0, "Dh must be a multiple of 64");
  using R = Ring<D>;
  constexpr int ST = R::STAGES;
  constexpr uint32_t STAGE_BYTES = 2 * R::TILE + (DKV ? 3 * ROWS * 4 : 0);
  const Params& p = tp.p;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t f1 = base, f2 = base + R::TILE;  // fixed tiles
  const uint32_t ring = base + 2 * R::TILE;       // stage s: s1, then s2
  float* stats = reinterpret_cast<float*>(sm + (2 + 2 * ST) * R::TILE);
  float* inv = stats + ST * 3 * ROWS;  // [ST][64] 1 / l (dK/dV)
  const uint32_t bars = smem_addr(stats) + (DKV ? ST * 4 * ROWS * 4 : 0);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int sub = blockIdx.x % R::NSUB;  // the block's 64 gradient columns
  const int r0 = (blockIdx.x / R::NSUB) * ROWS, h = blockIdx.y,
            b = blockIdx.z;
  const int tiles = (DKV ? p.n_q : p.n_kv) / ROWS;
  const long long sbase =
      (static_cast<long long>(b) * gridDim.y + h) * p.n_q;  // m, l, di

  // streamed tile j into its stage, by thread 0
  auto load = [&](int j) {
    const int s = j % ST;
    const uint32_t bar = bars + 8 * s, dst = ring + 2 * s * R::TILE;
    bar_expect(bar, STAGE_BYTES);
#pragma unroll
    for (int x = 0; x < R::NSUB; ++x) {
      tma_box(dst + x * BOX, &tp.s1, 64 * x, j * ROWS, h, b, bar);
      tma_box(dst + R::TILE + x * BOX, &tp.s2, 64 * x, j * ROWS, h, b, bar);
    }
    if constexpr (DKV) {
      const long long i = sbase + static_cast<long long>(j) * ROWS;
      const uint32_t st = smem_addr(stats + s * 3 * ROWS);
      bulk_copy(st, p.m + i, ROWS * 4, bar);
      bulk_copy(st + ROWS * 4, p.l + i, ROWS * 4, bar);
      bulk_copy(st + 2 * ROWS * 4, p.di + i, ROWS * 4, bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= ST; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bar = bars + 8 * ST;
    bar_expect(bar, 2 * R::TILE);
#pragma unroll
    for (int x = 0; x < R::NSUB; ++x) {
      tma_box(f1 + x * BOX, &tp.f1, 64 * x, r0, h, b, bar);
      tma_box(f2 + x * BOX, &tp.f2, 64 * x, r0, h, b, bar);
    }
    for (int j = 0; j < ST && j < tiles; ++j) load(j);
  }
  __syncwarp();

  // dQ: m, 1 / l and di of the thread's rows g and g + 8 of its warp's 16
  float rm[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f}, rdi[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = sbase + r0 + warp * 16 + g + 8 * r;
      rm[r] = p.m[i];
      rinv[r] = 1.f / p.l[i];
      rdi[r] = p.di[i];
    }
  }

  float acc1[32], acc2[32], sc[32], dp[32];  // dK | dQ, dV, S, dP
  uint32_t pa[4][4], da[4][4];               // P and dS as A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = sc[i] = dp[i] = 0.f;
  bar_wait(bars + 8 * ST, 0);

  for (int j = 0; j < tiles; ++j) {
    const int s = j % ST;
    const uint32_t t1 = ring + 2 * s * R::TILE, t2 = t1 + R::TILE;
    const float* tm = stats + s * 3 * ROWS;
    const float* ti = inv + s * ROWS;
    bar_wait(bars + 8 * s, (j / ST) & 1);
    if constexpr (DKV) {
      if (tid < ROWS) inv[s * ROWS + tid] = 1.f / tm[ROWS + tid];
    }

    // S = F1 S1^T and dP = F2 S2^T, one commit group each
    hold(sc);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      mma_ss(sc, desc(f1 + off), desc(t1 + off), kk);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      mma_ss(dp, desc(f2 + off), desc(t2 + off), kk);
    }
    wg_commit();
    wg_wait<1>();  // S is done (and dQ: tile j - 1's product)
    hold(sc);
    __syncthreads();  // 1 / l is written; no warp reads tile j - 1 any more
    // thread 0 refills tile j - 1's stage: dQ here, dK/dV while its
    // gradient products run (below), where the warpgroup waits anyway
    if constexpr (!DKV) {
      if (tid == 0 && j >= 1 && j - 1 + ST < tiles) load(j - 1 + ST);
      __syncwarp();
    }

    // P, in fp32; as A fragments rounded to bf16
    float pv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float mm, iv;
      if constexpr (DKV) {
        const int col = 8 * (i >> 2) + 2 * c + (i & 1);
        mm = tm[col];
        iv = ti[col];
      } else {
        mm = rm[(i >> 1) & 1];
        iv = rinv[(i >> 1) & 1];
      }
      pv[i] = exp_ftz(__fmul_rn(sc[i], p.scale) - mm) * iv;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(pv[8 * kk + 2 * r], pv[8 * kk + 2 * r + 1]);
    wg_wait<0>();
    hold(dp);

    // dS = (dP - di) P scale; acc1 += dS S1[:, sub]
    float dsv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float dd = DKV ? tm[2 * ROWS + 8 * (i >> 2) + 2 * c + (i & 1)]
                           : rdi[(i >> 1) & 1];
      dsv[i] = (dp[i] - dd) * pv[i] * p.scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack_bf16(dsv[8 * kk + 2 * r], dsv[8 * kk + 2 * r + 1]);
    hold(acc1);
    if constexpr (DKV) hold(acc2);
    wg_fence();
    if constexpr (DKV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(acc2, pa[kk], desc(t2 + sub * BOX + kk * 16 * 128));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(acc1, da[kk], desc(t1 + sub * BOX + kk * 16 * 128));
    wg_commit();
    // dK/dV retires its two products within the tile: left in flight over
    // the next tile's S and dP, ptxas serialises every wgmma of the kernel
    if constexpr (DKV) {
      if (tid == 0 && j >= 1 && j - 1 + ST < tiles) load(j - 1 + ST);
      __syncwarp();
      wg_wait<0>();
    }
  }
  wg_wait<0>();
  hold(acc1);
  if constexpr (DKV) hold(acc2);

  // rows g and g + 8 of the warp's 16, columns 8 t + 2 c (+1) of the 64
  const int row = r0 + warp * 16 + g, col = sub * 64 + 2 * c;
  __nv_bfloat16* o1 = static_cast<__nv_bfloat16*>(p.g1) + b * p.g1_b +
                      h * p.g1_h + row * p.g1_n + col;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    *reinterpret_cast<__nv_bfloat162*>(o1 + t * 8) =
        __floats2bfloat162_rn(acc1[4 * t], acc1[4 * t + 1]);
    *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * p.g1_n + t * 8) =
        __floats2bfloat162_rn(acc1[4 * t + 2], acc1[4 * t + 3]);
  }
  if constexpr (DKV) {
    __nv_bfloat16* o2 = static_cast<__nv_bfloat16*>(p.g2) + b * p.g2_b +
                        h * p.g2_h + row * p.g2_n + col;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(o2 + t * 8) =
          __floats2bfloat162_rn(acc2[4 * t], acc2[4 * t + 1]);
      *reinterpret_cast<__nv_bfloat162*>(o2 + 8 * p.g2_n + t * 8) =
          __floats2bfloat162_rn(acc2[4 * t + 2], acc2[4 * t + 3]);
    }
  }
}

// ---------------------------------------------------------------- fp32 ----

// Streamed rows a tile and ring stages of the fp32 kernels, by head dim.
// A stage holds the two raw streamed tiles; one pair of lo tiles serves the
// tile in work. At Dh 64 and 128 the fixed tiles are split once, hi in
// place and lo beside (FIXED_LO), and S and dP read both operands by
// descriptor; above, their hi and lo do not fit beside the ring, so the
// fixed tiles stay raw and are split into A fragments in registers, box by
// box. Boxes are 32 fp32 columns (128 bytes) wide, 128-byte swizzled.
template <int D>
struct F32 {
  static constexpr int RS = D <= 128 ? 32 : 16;  // streamed rows a tile
  static constexpr int STAGES = 2;
  static constexpr bool FIXED_LO = D <= 128;
  static constexpr int NB = D / 32;              // boxes a row
  static constexpr int FBOX = ROWS * 128;        // a 64-row box
  static constexpr int SBOX = RS * 128;          // a streamed box
  static constexpr int FTILE = NB * FBOX;
  static constexpr int STILE = NB * SBOX;
  // with the fixed tiles' lo (two blocks an SM at Dh 64, the whole SM at
  // 128) there is no room for 1024 bytes of alignment slack: the kernel
  // declares its shared memory 1024-byte aligned there (and traps if it is
  // not)
  static constexpr int SLACK = FIXED_LO ? 0 : 1024;
};

// the alignment slack, the two fixed tiles (and their lo), the ring (two
// tiles a stage), the lo of the tile in work, for dK/dV m, l (then 1/l)
// and di of each stage, and the barriers (one a stage, one for the fixed
// tiles)
template <int D, bool DKV>
constexpr int smem_f32() {
  using R = F32<D>;
  return R::SLACK + (R::FIXED_LO ? 4 : 2) * R::FTILE +
         (2 * R::STAGES + 2) * R::STILE +
         (DKV ? R::STAGES * 3 * R::RS * 4 : 0) + 8 * (R::STAGES + 1);
}

// The A fragments of k-steps 4 x to 4 x + 3 (the 32 columns of box x) of a
// fixed 64-row tile, split into tf32 hi and lo: the warp's rows 16 warp + g
// and + 8, columns c and c + 4 of each k-step. Row r's 16-byte piece q lies
// at piece q ^ (r % 8) of its 128 bytes, and r % 8 = g for both rows.
__device__ __forceinline__ void fixed_frags(const unsigned char* tile, int x,
                                            int warp, int g, int c,
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
  const unsigned char* row = tile + x * ROWS * 128 + (16 * warp + g) * 128 +
                             4 * c;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = ((2 * kk + half) ^ g) << 4;
      split_tf32(*reinterpret_cast<const float*>(row + off),
                 hi[kk][2 * half], lo[kk][2 * half]);
      split_tf32(*reinterpret_cast<const float*>(row + 8 * 128 + off),
                 hi[kk][2 * half + 1], lo[kk][2 * half + 1]);
    }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc += v w: v the warp's 16 rows x RS columns of an m64nRS accumulator
// (rows g and g + 8; columns 8 i + 2 c and + 1), w the RS x 64 block at
// column 64 sub of a split streamed tile (hi, lo), by mma.sync m16n8k8 in
// three tf32 products (hi lo', lo hi', hi hi'). The contraction index k of
// each 8 is permuted (k = c is column 2 c, k = c + 4 is 2 c + 1), so that
// v's accumulator elements are already the A fragment; n-tile t (of 8)
// holds columns 4 n + t of the block (32 + 4 n + t - 4 for t >= 4), so
// that a thread's B values for all eight n-tiles are one 16-byte piece a
// box (piece g of rows 8 i + 2 c and + 1; the pieces of a quarter warp
// fall in distinct banks). acc[4 t + e] is row g + 8 (e >> 1) at logical
// column n = 2 c + (e & 1) of n-tile t.
template <int RS>
__device__ __forceinline__ void grad_mma(float (&acc)[32],
                                         const float (&v)[RS / 2],
                                         const unsigned char* hi,
                                         const unsigned char* lo, int sub,
                                         int g, int c) {
  constexpr int SBOX = RS * 128;
  float part[32];  // this tile's sum, added to acc in fp32 below
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
#pragma unroll
  for (int i = 0; i < RS / 8; ++i) {
    uint32_t ah[4], al[4];
    split_tf32(v[4 * i], ah[0], al[0]);
    split_tf32(v[4 * i + 2], ah[1], al[1]);
    split_tf32(v[4 * i + 1], ah[2], al[2]);
    split_tf32(v[4 * i + 3], ah[3], al[3]);
    float4 bh[2][2], bl[2][2];  // [row 8 i + 2 c + r][box 2 sub + x]
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = 8 * i + 2 * c + r;
        const int off =
            (2 * sub + x) * SBOX + row * 128 + ((g ^ (row & 7)) << 4);
        bh[r][x] = *reinterpret_cast<const float4*>(hi + off);
        bl[r][x] = *reinterpret_cast<const float4*>(lo + off);
      }
    // pass by pass over the eight n-tiles, so that no product waits on
    // the one before it
#pragma unroll
    for (int t = 0; t < 8; ++t)
      mma_tf32_m16n8(part + 4 * t, ah,
                     __float_as_uint(lane(bl[0][t >> 2], t & 3)),
                     __float_as_uint(lane(bl[1][t >> 2], t & 3)));
#pragma unroll
    for (int t = 0; t < 8; ++t)
      mma_tf32_m16n8(part + 4 * t, al,
                     __float_as_uint(lane(bh[0][t >> 2], t & 3)),
                     __float_as_uint(lane(bh[1][t >> 2], t & 3)));
#pragma unroll
    for (int t = 0; t < 8; ++t)
      mma_tf32_m16n8(part + 4 * t, ah,
                     __float_as_uint(lane(bh[0][t >> 2], t & 3)),
                     __float_as_uint(lane(bh[1][t >> 2], t & 3)));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
}

// acc (grad_mma's layout) into the fp32 gradient at rows `row` and + 8,
// columns col0 + 8 c + 4 (e & 1) + 32 x, four n-tiles a 16-byte store.
__device__ __forceinline__ void store_f32(float* out, long long n_stride,
                                          const float (&acc)[32], int c) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * x + e;
      *reinterpret_cast<float4*>(out + (e >> 1) * 8 * n_stride + 32 * x +
                                 8 * c + 4 * (e & 1)) =
          make_float4(acc[t], acc[t + 4], acc[t + 8], acc[t + 12]);
    }
}

template <int D, bool DKV>
__global__ void __launch_bounds__(WG, 1)
    flash_bwd_f32(const __grid_constant__ TmaParams tp) {
  static_assert(D % 64 == 0, "Dh must be a multiple of 64");
  using R = F32<D>;
  constexpr int RS = R::RS, ST = R::STAGES, NB = R::NB, NSUB = D / 64;
  constexpr uint32_t STAGE_BYTES = 2 * R::STILE + (DKV ? 3 * RS * 4 : 0);
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_addr(f32_smem);
  if constexpr (R::SLACK == 0) {
    if (raw & 1023) __trap();
  }
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = f32_smem + (base - raw);
  // byte offsets: the fixed tiles (hi in place at Dh 64), their lo (Dh 64),
  // the ring (stage s: s1, then s2; hi after the split pass) and the lo of
  // the tile in work (s1, then s2)
  constexpr int F1 = 0, F2 = R::FTILE,
                FLO = 2 * R::FTILE,  // Dh 64: lo of F1, then of F2
                RING = (R::FIXED_LO ? 4 : 2) * R::FTILE,
                LO = RING + 2 * ST * R::STILE;
  float* stats = reinterpret_cast<float*>(sm + LO + 2 * R::STILE);
  const uint32_t bars = smem_addr(stats) + (DKV ? ST * 3 * RS * 4 : 0);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int sub = blockIdx.x % NSUB;  // the block's 64 gradient columns
  const int r0 = (blockIdx.x / NSUB) * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (DKV ? p.n_q : p.n_kv) / RS;
  const long long sbase =
      (static_cast<long long>(b) * gridDim.y + h) * p.n_q;  // m, l, di

  // streamed tile j into its stage, by thread 0
  auto load = [&](int j) {
    const int s = j % ST;
    const uint32_t bar = bars + 8 * s, dst = base + RING + 2 * s * R::STILE;
    bar_expect(bar, STAGE_BYTES);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_box(dst + x * R::SBOX, &tp.s1, 32 * x, j * RS, h, b, bar);
      tma_box(dst + R::STILE + x * R::SBOX, &tp.s2, 32 * x, j * RS, h, b,
              bar);
    }
    if constexpr (DKV) {
      const long long i = sbase + static_cast<long long>(j) * RS;
      const uint32_t st = smem_addr(stats + s * 3 * RS);
      bulk_copy(st, p.m + i, RS * 4, bar);
      bulk_copy(st + RS * 4, p.l + i, RS * 4, bar);
      bulk_copy(st + 2 * RS * 4, p.di + i, RS * 4, bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= ST; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bar = bars + 8 * ST;
    bar_expect(bar, 2 * R::FTILE);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_box(base + F1 + x * R::FBOX, &tp.f1, 32 * x, r0, h, b, bar);
      tma_box(base + F2 + x * R::FBOX, &tp.f2, 32 * x, r0, h, b, bar);
    }
    for (int j = 0; j < ST && j < tiles; ++j) load(j);
  }
  __syncwarp();

  // dQ: m, 1 / l and di of the thread's rows g and g + 8 of its warp's 16
  float rm[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f}, rdi[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = sbase + r0 + warp * 16 + g + 8 * r;
      rm[r] = p.m[i];
      rinv[r] = 1.f / p.l[i];
      rdi[r] = p.di[i];
    }
  }

  float acc1[32], acc2[32];      // dK | dQ, dV (grad_mma's layout)
  float sc[RS / 2], dp[RS / 2];  // S, dP (m64nRS); then P, dS
  float sp[RS / 2], dpp[RS / 2];  // partial sums of one box of S, dP
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = 0.f;
  bar_wait(bars + 8 * ST, 0);
  if constexpr (R::FIXED_LO) {  // the fixed tiles, split once
    split_pass<2 * R::FTILE>(sm + F1, sm + FLO, tid);
    fence_async_smem();
  }

  for (int j = 0; j < tiles; ++j) {
    const int s = j % ST;
    unsigned char* t1 = sm + RING + 2 * s * R::STILE;
    unsigned char* t2 = t1 + R::STILE;
    float* tm = stats + s * 3 * RS;  // m, 1 / l, di of the stage's rows
    // every warp is done with tile j - 1: its stage and the lo tiles are free
    __syncthreads();
    if (tid == 0 && j >= 1 && j - 1 + ST < tiles) load(j - 1 + ST);
    bar_wait(bars + 8 * s, (j / ST) & 1);

    // the split pass: hi in place, lo beside, both streamed tiles
    split_pass<2 * R::STILE>(t1, sm + LO, tid);
    if constexpr (DKV) {
      if (tid < RS) tm[RS + tid] = 1.f / tm[RS + tid];
    }
    fence_async_smem();
    __syncthreads();

    // S = F1 S1^T and dP = F2 S2^T, three tf32 products a k-step, each box
    // of 32 columns summed by the tensor cores from 0 and added to S (dP)
    // in fp32 by the FMA pipes
    // descriptors of the tiles' starts; a k-step's adds its byte offset
    // over 16 (the start address field, 14 bits, never carries)
    const uint32_t b1a = smem_addr(t1);
    const uint64_t b1 = desc(b1a), b2 = desc(b1a + R::STILE),
                   l1 = desc(base + LO), l2 = desc(base + LO + R::STILE);
    if constexpr (R::FIXED_LO) {
      // both operands by descriptor, the first half of the boxes in sc and
      // the second in sp (dp, dpp), all the products in one group
      const uint64_t a1 = desc(base + F1), a2 = desc(base + F2),
                     al1 = desc(base + FLO), al2 = desc(base + FLO + R::FTILE);
      hold(sc);
      hold(sp);
      hold(dp);
      hold(dpp);
      wg_fence();
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t fo = x * R::FBOX + kk * 32,
                         so = x * R::SBOX + kk * 32;
          const int first = x % (NB / 2) == 0 && kk == 0;
          float (&d)[RS / 2] = x < NB / 2 ? sc : sp;
          mma_tf32_ss(d, a1 + fo / 16, l1 + so / 16, !first);
          mma_tf32_ss(d, al1 + fo / 16, b1 + so / 16, 1);
          mma_tf32_ss(d, a1 + fo / 16, b1 + so / 16, 1);
        }
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t fo = x * R::FBOX + kk * 32,
                         so = x * R::SBOX + kk * 32;
          const int first = x % (NB / 2) == 0 && kk == 0;
          float (&d)[RS / 2] = x < NB / 2 ? dp : dpp;
          mma_tf32_ss(d, a2 + fo / 16, l2 + so / 16, !first);
          mma_tf32_ss(d, al2 + fo / 16, b2 + so / 16, 1);
          mma_tf32_ss(d, a2 + fo / 16, b2 + so / 16, 1);
        }
      wg_commit();
      wg_wait<0>();
      hold(sc);
      hold(sp);
      hold(dp);
      hold(dpp);
#pragma unroll
      for (int i = 0; i < RS / 2; ++i) {
        sc[i] += sp[i];
        dp[i] += dpp[i];
      }
    } else {
      // the fixed rows' A fragments from registers, box by box; S's and
      // dP's groups alternate, so that one's fragments are loaded while the
      // other's products run
      uint32_t fh[4][4], fl[4][4], gh[4][4], gl[4][4];
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        if (x > 0) {  // S's box x - 1 has retired: add it, free fh and fl
          wg_wait<1>();
          hold(sp);
          hold(fh);
          hold(fl);
#pragma unroll
          for (int i = 0; i < RS / 2; ++i)
            sc[i] = x == 1 ? sp[i] : sc[i] + sp[i];
        }
        fixed_frags(sm + F1, x, warp, g, c, fh, fl);
        hold(fh);
        hold(fl);
        hold(sc);
        hold(sp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = x * R::SBOX + kk * 32;
          mma_tf32<RS>(sp, fh[kk], l1 + off / 16, kk > 0);
          mma_tf32<RS>(sp, fl[kk], b1 + off / 16, 1);
          mma_tf32<RS>(sp, fh[kk], b1 + off / 16, 1);
        }
        wg_commit();
        if (x > 0) {  // dP's box x - 1 has retired
          wg_wait<1>();
          hold(dpp);
          hold(gh);
          hold(gl);
#pragma unroll
          for (int i = 0; i < RS / 2; ++i)
            dp[i] = x == 1 ? dpp[i] : dp[i] + dpp[i];
        }
        fixed_frags(sm + F2, x, warp, g, c, gh, gl);
        hold(gh);
        hold(gl);
        hold(dp);
        hold(dpp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = x * R::SBOX + kk * 32;
          mma_tf32<RS>(dpp, gh[kk], l2 + off / 16, kk > 0);
          mma_tf32<RS>(dpp, gl[kk], b2 + off / 16, 1);
          mma_tf32<RS>(dpp, gh[kk], b2 + off / 16, 1);
        }
        wg_commit();
      }
      wg_wait<1>();
      hold(sp);
#pragma unroll
      for (int i = 0; i < RS / 2; ++i) sc[i] += sp[i];
      wg_wait<0>();
      hold(dpp);
      hold(fh);
      hold(fl);
      hold(gh);
      hold(gl);
#pragma unroll
      for (int i = 0; i < RS / 2; ++i) dp[i] += dpp[i];
    }

    // P = exp(S scale - m) / l and dS = (dP - di) P scale, in place, fp32
#pragma unroll
    for (int i = 0; i < RS / 2; ++i) {
      float mm, iv, dd;
      if constexpr (DKV) {
        const int col = 8 * (i >> 2) + 2 * c + (i & 1);
        mm = tm[col];
        iv = tm[RS + col];
        dd = tm[2 * RS + col];
      } else {
        mm = rm[(i >> 1) & 1];
        iv = rinv[(i >> 1) & 1];
        dd = rdi[(i >> 1) & 1];
      }
      sc[i] = exp_ftz(__fmul_rn(sc[i], p.scale) - mm) * iv;
      dp[i] = (dp[i] - dd) * sc[i] * p.scale;
    }

    // acc1 += dS S1[:, sub]; dK/dV: acc2 += P S2[:, sub]; each tile's
    // products are summed by the tensor cores from 0 and added to the
    // gradient in fp32 by the FMA pipes
    grad_mma<RS>(acc1, dp, t1, sm + LO, sub, g, c);
    if constexpr (DKV)
      grad_mma<RS>(acc2, sc, t2, sm + LO + R::STILE, sub, g, c);
  }

  const int row = r0 + warp * 16 + g, col = sub * 64;
  store_f32(static_cast<float*>(p.g1) + b * p.g1_b + h * p.g1_h +
                row * p.g1_n + col,
            p.g1_n, acc1, c);
  if constexpr (DKV)
    store_f32(static_cast<float*>(p.g2) + b * p.g2_b + h * p.g2_h +
                  row * p.g2_n + col,
              p.g2_n, acc2, c);
}

// ------------------------------------------------------ wide head dims ----

// Dh a multiple of 128 from 384 up, the head dim at run time: one kernel a
// dtype and gradient, each on a thread-block cluster along Dh. No tile spans
// Dh, whose 64-row tiles outgrow shared memory (at Dh 512 in fp32 q's hi and
// lo alone would be 256 KiB).
//
// fp32: split TF32 as above, on a thread-block cluster along Dh, so that S
// and dP are computed once for each (fixed tile, streamed tile) pair (a
// block for each 64 gradient columns that sums them over all of Dh does
// Dh/64 times the work: at Dh 512, 4.5x and 5.7x the pair's tensor work).
//
// Slices and clusters. Dh is cut into slices of WC = 128 columns, n = Dh /
// 128 of them. The blocks of one fixed tile (64 rows) form a cluster of cs
// = n blocks (up to the portable limit of 8: Dh 1024), block r at slice r.
// A block holds the fixed rows at its slice and streams the other side's
// tiles at the same columns, and those boxes serve both of its products:
// its partial of S and dP (the contraction over its 128 columns) and its
// gradients at its 128 columns (dK and dV, or dQ): one stage, no second
// ring for the gradients. Why 128 columns: 64 fixed rows x 128 columns of
// a gradient are 64 accumulator registers a thread of a warpgroup, and
// with the contraction's chains and A fragments beside them the dK/dV
// kernel takes 249 registers; the buffers below take 231,184 of the
// 232,448 bytes of shared memory a block may have at 128 columns. dQ has
// one gradient but the same shared memory, so its slices are 128 columns
// too. Above Dh 1024 (n > 8) the kernel runs `rounds` = ceil(n / 8) passes
// of clusters of cs = ceil(n / rounds) blocks a fixed tile: block r of pass
// p writes the gradients of slice r + p cs (none past n) and contracts its
// slices r, r + cs, ... in turn each streamed tile, reloading the fixed
// slices for each and the gradients' slice last; each pass computes S and
// dP whole, `rounds` times the least work, which no Dh up to 1024 pays.
//
// A block is two warpgroups. Warpgroup 0 forms the block's partial of S
// (S^T = K Q^T for dK/dV, S = Q K^T for dQ), warpgroup 1 that of dP, by
// wgmma m64n32k8 .tf32 from the fixed slice (A fragments split hi/lo in
// registers box by box, as the Dh-256 instance does: the fixed hi and lo
// do not fit) and the streamed slice, which the warpgroup that reads it
// splits hi/lo in place once it lands. A partial is two chains of 24
// products (the slice's 32-column boxes 0 and 2, and 1 and 3), each summed
// by the tensor cores from 0 and the two added in fp32; one box's group
// stays in flight while the next box's fragments are split (wg_wait<1>).
//
// The exchange, two cluster barriers a tile (barrier.cluster.arrive.release
// / wait.acquire). The partials go to the block's shared memory. After the
// first barrier each block owns a contiguous 1/cs of the 64 x 32 elements:
// it reads the cs partials of those through distributed shared memory
// (mapa, ld.shared::cluster; all loads of a unit before its adds), adds
// them in rank order (slice 0, 1, ...; with rounds, each block's slices in
// its own order first) and forms P = exp(s scale - m) (1 / l) (s scale
// rounded first) and dS = (dP - di) P scale in fp32 once for them. After
// the second barrier every warpgroup reads the P or dS of its own
// accumulator elements from their owners. So each element of S and dP is
// summed once, in one order, every block uses the same bits of P and dS,
// and the gradients are the same bits from run to run, with no atomics.
// Every block reading every partial instead (one barrier a tile, the
// exponentials formed cs times) reads cs times the bytes and measured
// slower at every row, the more so the larger the cluster.
//
// The gradients by wgmma from registers: dK/dV, warpgroup 0 dK += dS^T Q
// and warpgroup 1 dV += P^T dO at all 128 columns (m64n128k8); dQ, each
// warpgroup dQ += dS K at 64 of them (m64n64k8). The A operand is P^T or
// dS^T as the accumulator of S^T holds it, the contraction index of each 8
// permuted (k = c is column 2 c, k = c + 4 is 2 c + 1); the B operand is
// the streamed slice's hi and lo transposed (wgmma takes no transposed
// tf32 operand), rows the gradient's columns, positions the tile's rows in
// the same order (transpose_t). Each tile's 12 products are summed by the
// tensor cores from 0 and added in fp32. mma.sync m16n8k8 (grad_mma) in
// their place measured no faster, nor with the warps splitting the
// columns instead of the rows.
//
// Buffers and order. The fixed slices (64 KiB) load once. A streamed tile
// of 32 rows (both tensors' slices, 32 KiB, with m, l and di for dK/dV)
// lands in the one stage; its lo (32 KiB) and the transposed hi and lo (64
// KiB) lie beside it. The stage and its lo serve the contraction only, so
// once the block has contracted tile j and transposed it, tile j + 1 loads
// into the stage, behind tile j's exchange and gradients. Per tile: split,
// contract, write the partial, arrive at the first barrier; while it
// completes, transpose and issue the next tile's copies (a copy a warp);
// then the exchange and the gradients. RS = 32 because 64-row tiles do not
// fit (the tf32 wgmma costs about as much at N 32 as at 64, so S and dP run
// at half their rate). Two stages, to overlap one tile's exchange with the
// next tile's contraction, do not fit either. Shared memory: 231,184
// bytes, one block an SM. A cluster's blocks share a GPC, so fewer than 132
// blocks may be resident at once: the plan reports
// cudaOccupancyMaxActiveClusters beside the grid.
// The k-th slice that block `rank` of pass `pass` of a wide kernel's
// cluster contracts each streamed tile: its rounds in turn from the one
// after its pass, so that the gradients' slice comes last.
__device__ __forceinline__ int wide_slice(const WidePlan& w, int rank,
                                          int pass, int cs, int k) {
  for (int x = 0, seen = 0; x < w.rounds; ++x) {
    const int sl = rank + (pass + 1 + x) % w.rounds * cs;
    if (sl < w.n && seen++ == k) return sl;
  }
  return 0;
}

constexpr int WRS = 32;                // streamed rows a tile
constexpr int WT = 2 * WG;             // threads a block
constexpr int WFBOX = ROWS * 128;      // 64 fixed rows x 32 columns
constexpr int WSBOX = WRS * 128;       // a streamed box
constexpr int WFIX = 4 * WFBOX;        // one fixed tensor's slice
constexpr int WHALF = 4 * WSBOX;       // one streamed tensor's slice
constexpr int WTB = WC * 128;          // a streamed slice transposed
constexpr int WMAT = ROWS * WRS * 4;   // a 64 x 32 fp32 matrix (S, dP, P, dS)
constexpr int WU = WMAT / 8;           // its 8-byte units (element pairs)
// byte offsets: the fixed slices (f1, then f2), the stage (s1's slice, then
// s2's; hi in place after the split), its lo, the transposed slices (s1's
// hi and lo, then s2's), the partials (S, then dP), their sums' P and dS,
// the stats (dK/dV: m, l, di of even and odd tiles; dQ: m, 1/l, di of the
// fixed rows), the barriers (the stage's, the fixed slices'), and 1024
// bytes of alignment slack
constexpr int WFIXO = 0, WSTG = 2 * WFIX, WLO = WSTG + 2 * WHALF,
              WTT = WLO + 2 * WHALF, WPART = WTT + 4 * WTB,
              WFIN = WPART + 2 * WMAT, WSTATS = WFIN + 2 * WMAT,
              WBARS = WSTATS + 2 * 3 * WRS * 4;
constexpr int smem_wide_f32() { return WBARS + 2 * 8 + 1024; }
static_assert(2 * 3 * WRS == 3 * ROWS, "the stats hold either layout");
static_assert(smem_wide_f32() <= 232448, "more than a block's shared memory");

// Column n of a streamed slice already split (hi in place, lo beside it,
// four boxes of WRS rows as TMA lays them), written transposed: row n of
// the result, its 32 positions the tile's rows, each 8 in the order 0, 2,
// 4, 6, 1, 3, 5, 7 (the accumulators of S and dP hold columns 2 c and 2 c
// + 1 of each 8, the k = c and c + 4 of the gradient products' A
// fragments), 128-byte swizzled: the K-major B operand of wgmma; positions
// 4 p0 to 4 p1 - 1, a 16-byte piece at a time. A warp's reads of a row fall
// in one 128-byte row of the slice.
__device__ __forceinline__ void transpose_t(const unsigned char* hi,
                                            const unsigned char* lo,
                                            unsigned char* th,
                                            unsigned char* tl, int n, int p0,
                                            int p1) {
  const int cc = n & 31;
  const int col = (n >> 5) * WSBOX + ((cc & 3) << 2);
#pragma unroll
  for (int pc = 0; pc < WRS / 4; ++pc) {  // positions 4 pc to + 3
    if (pc < p0 || pc >= p1) continue;
    const int r0 = 8 * (pc >> 1) + (pc & 1);
    uint32_t hv[4], lv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // rows r0 + 2 e
      const int r = r0 + 2 * e;
      const int off = col + r * 128 + (((cc >> 2) ^ (r & 7)) << 4);
      hv[e] = *reinterpret_cast<const uint32_t*>(hi + off);
      lv[e] = *reinterpret_cast<const uint32_t*>(lo + off);
    }
    const int off = n * 128 + ((pc ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(th + off) =
        make_uint4(hv[0], hv[1], hv[2], hv[3]);
    *reinterpret_cast<uint4*>(tl + off) =
        make_uint4(lv[0], lv[1], lv[2], lv[3]);
  }
}

template <bool DKV>
__global__ void __launch_bounds__(WT, 1)
    flash_bwd_wide_f32(const __grid_constant__ TmaParams tp, int D) {
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_addr(f32_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = f32_smem + (base - raw);
  float* stats = reinterpret_cast<float*>(sm + WSTATS);
  const uint32_t bars = base + WBARS;  // the stage, the fixed slices

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & (WG - 1);
  const int warp = t >> 5, g = (t & 31) >> 2, c = t & 3;
  const WidePlan w = wide_plan(D);
  const int rank = static_cast<int>(cluster_rank()),
            cs = static_cast<int>(cluster_blocks());
  const int pass = static_cast<int>(blockIdx.x) / cs % w.rounds;
  const int r0 = static_cast<int>(blockIdx.x) / (cs * w.rounds) * ROWS,
            h = blockIdx.y, b = blockIdx.z;
  const int gs = rank + pass * cs;  // the gradients' slice (none past n)
  const int items = (w.n - rank + cs - 1) / cs;  // slices contracted a tile
  const int tiles = (DKV ? p.n_q : p.n_kv) / WRS, total = tiles * items;
  const long long sbase =
      (static_cast<long long>(b) * gridDim.y + h) * p.n_q;  // m, l, di

  auto slice = [&](int k) { return wide_slice(w, rank, pass, cs, k); };
  auto load_fixed = [&](int sl) {
    const uint32_t bar = bars + 8;
    bar_expect(bar, 2 * WFIX);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      tma_box(base + WFIXO + x * WFBOX, &tp.f1, WC * sl + 32 * x, r0, h, b,
              bar);
      tma_box(base + WFIXO + WFIX + x * WFBOX, &tp.f2, WC * sl + 32 * x, r0,
              h, b, bar);
    }
  };
  // item u: streamed tile u / items at its (u % items)-th slice. Copy x
  // of its 8 is box x & 3 of s1 (x < 4) or s2; copy 0 also sets the bytes
  // the barrier expects (a copy may land before it), copies 1 to 3 of dK/dV
  // also bring m, l and di of the tile's rows (the stats of its parity)
  auto load_copy = [&](int u, int x) {
    const int j = u / items, sl = w.rounds == 1 ? rank : slice(u % items);
    const uint32_t dst = base + WSTG + (x >> 2) * WHALF;
    if (x == 0) bar_expect(bars, 2 * WHALF + (DKV ? 3 * WRS * 4 : 0));
    tma_box(dst + (x & 3) * WSBOX, x < 4 ? &tp.s1 : &tp.s2,
            WC * sl + 32 * (x & 3), j * WRS, h, b, bars);
    if (DKV && x >= 1 && x <= 3) {
      const float* src = x == 1 ? p.m : (x == 2 ? p.l : p.di);
      bulk_copy(smem_addr(stats + (j & 1) * 3 * WRS + (x - 1) * WRS),
                src + sbase + static_cast<long long>(j) * WRS, WRS * 4, bars);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!DKV) {  // m, 1 / l and di of the fixed rows
    if (tid < ROWS) {
      const long long i = sbase + r0 + tid;
      stats[tid] = p.m[i];
      stats[ROWS + tid] = 1.f / p.l[i];
      stats[2 * ROWS + tid] = p.di[i];
    }
  }
  __syncthreads();
  if (tid == 0) {
    load_fixed(slice(0));
    for (int x = 0; x < 8; ++x) load_copy(0, x);
  }
  __syncwarp();

  // S (warpgroup 0) or dP (warpgroup 1) of one item, from 0: boxes 0 and 2
  // one chain, 1 and 3 another; box x's group in flight while box x + 1's
  // fragments are split
  const unsigned char* fix = sm + WFIXO + wg * WFIX;
  auto contract = [&](float (&out)[WRS / 2], uint64_t bh, uint64_t bl) {
    float ca[WRS / 2], cb[WRS / 2];
    uint32_t fh[2][4][4], fl[2][4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int f = x & 1;
      float (&d)[WRS / 2] = f == 0 ? ca : cb;
      if (x >= 2) {  // box x - 2 has retired: its chain and fragments free
        wg_wait<1>();
        hold(d);
        hold(fh[f]);
        hold(fl[f]);
      }
      fixed_frags(fix, x, warp, g, c, fh[f], fl[f]);
      hold(fh[f]);
      hold(fl[f]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = (x * WSBOX + kk * 32) / 16;
        mma_tf32<WRS>(d, fh[f][kk], bl + off, x >= 2 || kk > 0);
        mma_tf32<WRS>(d, fl[f][kk], bh + off, 1);
        mma_tf32<WRS>(d, fh[f][kk], bh + off, 1);
      }
      wg_commit();
    }
    wg_wait<0>();
    hold(ca);
    hold(cb);
    hold(fh[0]);
    hold(fl[0]);
    hold(fh[1]);
    hold(fl[1]);
#pragma unroll
    for (int i = 0; i < WRS / 2; ++i) out[i] = ca[i] + cb[i];
  };

  // the warpgroup's gradient (wgmma's accumulator layout): dK/dV, all 128
  // columns of the slice (warpgroup 0 dK, 1 dV); dQ, 64 of them
  constexpr int GN = DKV ? WC : WC / 2;
  float acc[GN / 2];
  float sc[WRS / 2];  // the block's partial of S or dP
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WRS / 2; ++i) sc[i] = 0.f;
  const bool reload = items > 1;
  // the transposed tensor the warpgroup writes (dK/dV: its own, all 128
  // columns; dQ: s1's, half the positions each) and reads (dQ: s1's rows
  // 64 wg on)
  unsigned char* th = sm + WTT + (DKV ? wg : 0) * 2 * WTB;
  const uint64_t gth = desc(smem_addr(th) + (DKV ? 0 : wg * GN * 128)),
                 gtl = gth + WTB / 16;
  int u = 0;
  for (int j = 0; j < tiles; ++j) {
    for (int k = 0; k < items; ++k, ++u) {
      unsigned char* hi = sm + WSTG + wg * WHALF;
      unsigned char* lo = sm + WLO + wg * WHALF;
      bar_wait(bars, u & 1);
      if (u == 0 || reload) bar_wait(bars + 8, u & 1);
      split_pass<WHALF>(hi, lo, t);  // the warpgroup's tensor: hi, lo
      fence_async_smem();
      named_sync(2 + wg, WG);
      float part[WRS / 2];
      contract(part, desc(smem_addr(hi)), desc(smem_addr(lo)));
#pragma unroll
      for (int i = 0; i < WRS / 2; ++i)
        sc[i] = k == 0 ? part[i] : sc[i] + part[i];
      // the block is done with the fixed slices and the stage's products
      // (and with the last tile's gradients); item u + 1 comes into the
      // stage here if it is of this tile, else under the exchange
      named_sync(1, WT);
      if (tid == 0 && reload && u + 1 < total)
        load_fixed(slice((u + 1) % items));
      if ((tid & 31) == 0 && k + 1 < items) load_copy(u + 1, tid >> 5);
      __syncwarp();
    }

    // the partials into the block's shared memory, S's then dP's, in the
    // accumulator's order (unit 2 (i2 * 128 + t) + e: elements 4 i2 + 2 e
    // and + 1); while the cluster barrier completes, the gradients' slice
    // transposed, then the next tile's first item into the stage, a copy a
    // warp, behind the exchange and the gradients
    float4* pw = reinterpret_cast<float4*>(sm + WPART + wg * WMAT);
#pragma unroll
    for (int i2 = 0; i2 < WRS / 8; ++i2)
      pw[i2 * WG + t] = make_float4(sc[4 * i2], sc[4 * i2 + 1],
                                    sc[4 * i2 + 2], sc[4 * i2 + 3]);
    cluster_arrive();
    transpose_t(sm + WSTG + (DKV ? wg : 0) * WHALF,
                sm + WLO + (DKV ? wg : 0) * WHALF, th, th + WTB, t,
                DKV ? 0 : 4 * wg, DKV ? WRS / 4 : 4 * wg + 4);
    fence_async_smem();  // before the gradients' wgmma read it
    named_sync(1, WT);
    if ((tid & 31) == 0 && u < total) load_copy(u, tid >> 5);
    __syncwarp();
    cluster_wait();

    // the block's units [lo_u, hi_u), one a thread: the cs partials added
    // in rank order, then P and dS
    const float* st = DKV ? stats + (j & 1) * 3 * WRS : stats;
    const int lo_u = rank * WU / cs, hi_u = (rank + 1) * WU / cs;
    for (int x = lo_u + tid; x < hi_u; x += WT) {
      const uint32_t at = base + WPART + 8 * x;
      float2 sq[WCLUSTER], dq[WCLUSTER];  // all loads before the adds
#pragma unroll
      for (int q = 0; q < WCLUSTER; ++q)
        if (q < cs) {
          sq[q] = ld_cluster(at, q);
          dq[q] = ld_cluster(at + WMAT, q);
        }
      float2 sv = sq[0], dv = dq[0];
#pragma unroll
      for (int q = 1; q < WCLUSTER; ++q)
        if (q < cs) {
          sv = make_float2(sv.x + sq[q].x, sv.y + sq[q].y);
          dv = make_float2(dv.x + dq[q].x, dv.y + dq[q].y);
        }
      // unit x holds elements 4 (x / 256) + 2 (x & 1) and + 1 of
      // accumulator thread (x / 2) % 128: row row0, columns col0 and + 1
      const int wt = (x >> 1) & (WG - 1);
      const int row0 = 16 * (wt >> 5) + ((wt & 31) >> 2) + 8 * (x & 1),
                col0 = 8 * (x >> 8) + 2 * (wt & 3);
      const float sa[2] = {sv.x, sv.y}, da[2] = {dv.x, dv.y};
      float pa[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // dK/dV: the streamed (q) row is the column; dQ: the fixed row
        const int r = DKV ? col0 + e : row0;
        const float mm = st[r];
        const float iv = DKV ? 1.f / st[WRS + r] : st[ROWS + r];
        const float dd = DKV ? st[2 * WRS + r] : st[2 * ROWS + r];
        pa[e] = exp_ftz(__fmul_rn(sa[e], p.scale) - mm) * iv;
        ds[e] = (da[e] - dd) * pa[e] * p.scale;
      }
      float2* fw = reinterpret_cast<float2*>(sm + WFIN);
      fw[x] = make_float2(pa[0], pa[1]);
      fw[WU + x] = make_float2(ds[0], ds[1]);
    }
    cluster_sync();

    // the gradients by wgmma m64nGNk8 .tf32, P^T or dS^T from registers
    // (its contraction index permuted as the transposed slice's positions)
    // on the transposed slice: dK/dV, warpgroup 0 dK += dS^T S1 and 1 dV
    // += P^T S2; dQ, dQ += dS S1 at the warpgroup's 64 columns. The tile's
    // 12 products are summed by the tensor cores from 0 and added to the
    // gradient in fp32.
    if (gs < w.n) {
      const uint32_t src =
          base + WFIN + (DKV && wg == 1 ? 0 : WMAT);  // P or dS
      float v[WRS / 2];
#pragma unroll
      for (int i2 = 0; i2 < WRS / 4; ++i2) {  // elements 2 i2 and + 1
        const int x = 2 * ((i2 >> 1) * WG + t) + (i2 & 1);
        const float2 y = ld_cluster(src + 8 * x, ((x + 1) * cs - 1) / WU);
        v[2 * i2] = y.x;
        v[2 * i2 + 1] = y.y;
      }
      uint32_t ah[WRS / 8][4], al[WRS / 8][4];
#pragma unroll
      for (int kk = 0; kk < WRS / 8; ++kk) {
        split_tf32(v[4 * kk], ah[kk][0], al[kk][0]);
        split_tf32(v[4 * kk + 2], ah[kk][1], al[kk][1]);
        split_tf32(v[4 * kk + 1], ah[kk][2], al[kk][2]);
        split_tf32(v[4 * kk + 3], ah[kk][3], al[kk][3]);
      }
      float part[GN / 2];
      hold(ah);
      hold(al);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WRS / 8; ++kk) {
        mma_tf32<GN>(part, ah[kk], gtl + kk * 2, kk > 0);
        mma_tf32<GN>(part, al[kk], gth + kk * 2, 1);
        mma_tf32<GN>(part, ah[kk], gth + kk * 2, 1);
      }
      wg_commit();
      wg_wait<0>();
      hold(part);
      hold(ah);
      hold(al);
#pragma unroll
      for (int i = 0; i < GN / 2; ++i) acc[i] += part[i];
    }
  }
  cluster_sync();  // no block of the cluster reads this one's units now

  if (gs < w.n) {  // rows 16 warp + g and + 8, columns 8 q + 2 c and + 1
    const bool second = DKV && wg == 1;  // dV
    const long long n_stride = second ? p.g2_n : p.g1_n;
    float* out = (second ? static_cast<float*>(p.g2) + b * p.g2_b +
                               h * p.g2_h
                         : static_cast<float*>(p.g1) + b * p.g1_b +
                               h * p.g1_h) +
                 (r0 + 16 * warp + g) * n_stride + WC * gs +
                 (DKV ? 0 : GN * wg) + 2 * c;
#pragma unroll
    for (int q = 0; q < GN / 8; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + r * 8 * n_stride + 8 * q) =
            make_float2(acc[4 * q + 2 * r], acc[4 * q + 2 * r + 1]);
  }
}

// bf16 on the same clusters, so that S and dP are computed once for each
// (fixed tile, streamed tile) pair: a block for each 64 gradient columns
// that sums them over all of Dh in 64-column chunks does Dh/64 times the
// work (at Dh 512 the dK/dV kernel's 18 products a pair of tiles where 4
// do, 4.5x, and dQ's 17 where 3 do, 5.7x), and waits for each chunk.
//
// Slices and clusters as the fp32 pair's (wide_plan): block r of a fixed
// tile's cluster holds the fixed rows at slice r (k and v for dK/dV, q and
// do for dQ: two 64 x 128 slices, 32 KiB, loaded once by TMA) and streams
// the other side's tiles of 64 rows at the same columns, whose boxes serve
// both of its products: its partials of S and dP (the contraction over its
// 128 columns) and its gradients at its 128 columns. Above Dh 1024 block r
// of pass p writes the gradients of slice r + p cs and contracts its slices
// r, r + cs, ... in turn each streamed tile, the fixed slices reloaded with
// each and the gradients' slice last (the fp32 pair's order), so that the
// stage then holds the streamed tile at the gradients' columns; each pass
// computes S and dP whole, `rounds` times the least work, which no Dh up to
// 1024 pays.
//
// A block is two warpgroups. Warpgroup 0 forms the block's partial of S
// (S^T = K Q^T for dK/dV, S = Q K^T for dQ), warpgroup 1 that of dP (dP^T =
// V dO^T, dP = dO V^T), each by one chain of 8 wgmma m64n64k16 with both
// operands K-major in shared memory (the fixed slice and the streamed
// slice as TMA lays them), left in flight.
//
// The exchange, one cluster barrier a tile (barrier.cluster.arrive.release
// / wait.acquire). Each warpgroup writes its partial to the block's shared
// memory in the accumulator's order. A tile's 64 x 64 elements are 1024
// "units" of four, n-tile nt (8 columns) of accumulator thread t, both of
// its row halves; block r owns units 1024 r / cs up to 1024 (r + 1) / cs,
// one a thread (two turns at cs 3). Once a barrier has shown every block's
// partials of tile j, the owner of a unit reads the cs partials of its S
// and dP through distributed shared memory (mapa, ld.shared::cluster; the
// first four ranks' loads issued a tile ahead, the others before their
// adds), adds them in rank order, and forms in fp32 once an element p =
// exp(s scale - m) (1 / l), s scale rounded first (the steps of the bf16
// wide forward, which forms S from the same partials in the same order at
// dQ's operands: given its m and l, the p recomputed here is the p it
// formed), and dS = (dP - di) p scale. It pushes P and dS rounded to bf16
// into every block (st.shared::cluster) where that block's gradient
// warpgroup reads its A fragments: dK/dV P and dS as one 16-byte piece, dQ
// dS alone. Partials are read and fragments written 16 bytes at a time
// where they can be (a unit's four elements lie together in both). The next
// barrier shows them to every block, and with them tile j + 2's partials.
// The partials and the fragments are double-buffered by the tile's parity,
// so that one barrier a tile orders every read before the write that
// reuses its buffer. So each element of S and dP is summed once, in one
// order, every block uses the same bits of P and dS, and the gradients are
// the same bits from run to run, with no atomics.
//
// The gradients by wgmma m64nNk16 with A from registers (the owners'
// fragments) and the streamed slice read transposed (MN-major, tnspB; its
// two boxes 8 KiB apart): dK/dV, warpgroup 0 dK += dS^T Q and warpgroup 1
// dV += P^T dO at all 128 columns of the slice (m64n128k16); dQ, each
// warpgroup dQ += dS K at its 64 of them (m64n64k16). bf16 wgmma takes a
// transposed B operand, so no transposed copy of the streamed slice is
// made (the fp32 pair's transpose_t).
//
// Buffers and order. Streamed tiles of 64 rows (the slices of both
// tensors, 32 KiB a stage, with m, l and di for dK/dV) in a ring of three
// stages: a tile's stage lives from its contraction to its gradients two
// tiles later, and the third takes the next copy. Per tile j: tile j + 1's
// owner loads issued; tile j's gradients issued; tile j + 2's contraction
// issued; tile j + 1's owners' adds, P and dS, pushed; both groups retired;
// tile j + 2's partial written; tile j + 3's copies into tile j's stage;
// the cluster barrier. So the tensor cores run tile j's gradients and tile
// j + 2's contraction under tile j + 1's owner work. Shared memory: the
// fixed slices (32 KiB), the ring (96 KiB), the partials (2 x 2 x 16 KiB),
// the fragments (2 x 2 x 8 KiB) and the stats: 231,712 bytes, one block an
// SM, no alignment slack, so the kernel declares it 1024-byte aligned and
// traps if it is not.
//
// Rounding: S and dP are one wgmma chain a block (8 k-steps a slice; above
// Dh 1024 the block's slices in one chain, in its order) and the cs
// partials are added in fp32 in rank order; P and dS are rounded to bf16
// for their products, each gradient summed by the tensor cores over the
// streamed tiles and rounded once to bf16 (the plain backward's steps).
//
// What sets its time (scripts/probe_wide_backward.py: cycles a block per
// tile on an H100 at B1 N768 H8 Dh 512): the exchange with its cluster
// barrier, over half of a tile's, not the tensor cores, whose four
// products of 64 x 64 x 128 a block and tile take about a fifth of it.
// Measured and not kept (the probe's variants, in turns with this kernel
// at the bf16 wide rows of chip_smoke.py, two runs, the same bits): the
// exchange in 8-byte pieces (a unit's float2s 1 KiB apart in the
// partials, P and dS pushed apart), 1.03-1.19x its time; the block's own
// partials and fragments by plain shared-memory accesses in place of the
// cluster's, 1.01-1.07x; the next copies issued after the cluster
// barrier, a copy a warp, with no block barrier before them, 0.96-0.97x
// at B1 N768 H8 Dh 512 but 0.99-1.03x at the other rows (not worth its
// extra code); each warpgroup's copies after a barrier of its own warps,
// 0.98-1.02x. Not
// built: streamed tiles of 32 rows for two blocks an SM (about 100 KiB
// each), which would leave 128 registers a thread where dK/dV's gradient
// alone takes 64 and the exchange's loads 32.
constexpr int BW_ST = 3;                // streamed tiles a ring
constexpr int BW_SLICE = 2 * BOX;       // a 64 x 128 slice: two boxes
constexpr int BW_PM = ROWS * ROWS * 4;  // a 64 x 64 fp32 partial
constexpr int BW_FM = ROWS * ROWS * 2;  // a 64 x 64 bf16 A-fragment matrix
constexpr int BW_UNITS = 1024;          // units of four a tile
// byte offsets: the fixed slices (f1's, then f2's), the ring (stage s: s1's
// slice, then s2's), the partials (parity: S's, then dP's), the fragments
// (parity: P's, then dS's), the stats (dK/dV: m, l, di of each stage's
// rows; dQ: m, 1 / l, di of the fixed rows), the barriers (a stage each,
// then the fixed slices')
constexpr int BW_FIX = 0, BW_STG = 2 * BW_SLICE,
              BW_PART = BW_STG + BW_ST * 2 * BW_SLICE,
              BW_FRAG = BW_PART + 2 * 2 * BW_PM,
              BW_STATS = BW_FRAG + 2 * 2 * BW_FM,
              BW_BARS = BW_STATS + BW_ST * 3 * ROWS * 4;
constexpr int smem_wide_bf16() { return BW_BARS + 8 * (BW_ST + 1); }
static_assert(smem_wide_bf16() <= 232448, "more than a block's shared memory");

template <bool DKV>
__global__ void __launch_bounds__(WT, 1)
    flash_bwd_wide_bf16(const __grid_constant__ TmaParams tp, int D) {
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  const uint32_t base = smem_addr(bw_smem);
  if (base & 1023) __trap();
  unsigned char* sm = bw_smem;
  float* stats = reinterpret_cast<float*>(sm + BW_STATS);
  const uint32_t bars = base + BW_BARS, fbar = bars + 8 * BW_ST;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & (WG - 1);
  const int warp = t >> 5, g = (t & 31) >> 2, c = t & 3;
  const WidePlan w = wide_plan(D);
  const int rank = static_cast<int>(cluster_rank()),
            cs = static_cast<int>(cluster_blocks());
  const int pass = static_cast<int>(blockIdx.x) / cs % w.rounds;
  const int r0 = static_cast<int>(blockIdx.x) / (cs * w.rounds) * ROWS,
            h = blockIdx.y, b = blockIdx.z;
  const int gs = rank + pass * cs;  // the gradients' slice (none past n)
  const bool out = gs < w.n;
  const int items = (w.n - rank + cs - 1) / cs;  // slices contracted a tile
  const bool multi = w.rounds > 1;
  const int tiles = (DKV ? p.n_q : p.n_kv) / ROWS;
  const long long sbase =
      (static_cast<long long>(b) * gridDim.y + h) * p.n_q;  // m, l, di

  auto slice = [&](int k) { return wide_slice(w, rank, pass, cs, k); };
  // the fixed slices of f1 and f2 at slice sl, by thread 0
  auto load_fixed = [&](int sl, uint32_t bar) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tma_box(base + BW_FIX + x * BOX, &tp.f1, WC * sl + 64 * x, r0, h, b,
              bar);
      tma_box(base + BW_FIX + BW_SLICE + x * BOX, &tp.f2, WC * sl + 64 * x,
              r0, h, b, bar);
    }
  };
  // item k of streamed tile j into its stage, by thread 0: the slices of s1
  // and s2 (with passes also those of f1 and f2) at the item's slice and,
  // for dK/dV with the first item, m, l and di of the tile's rows
  auto load_item = [&](int j, int k) {
    const int s = j % BW_ST, sl = slice(k);
    const uint32_t bar = bars + 8 * s, dst = base + BW_STG + s * 2 * BW_SLICE;
    bar_expect(bar, (multi ? 4 : 2) * BW_SLICE +
                        (DKV && k == 0 ? 3 * ROWS * 4 : 0));
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tma_box(dst + x * BOX, &tp.s1, WC * sl + 64 * x, j * ROWS, h, b, bar);
      tma_box(dst + BW_SLICE + x * BOX, &tp.s2, WC * sl + 64 * x, j * ROWS,
              h, b, bar);
    }
    if (multi) load_fixed(sl, bar);
    if (DKV && k == 0) {
      const long long i = sbase + static_cast<long long>(j) * ROWS;
      const uint32_t st = smem_addr(stats + s * 3 * ROWS);
      bulk_copy(st, p.m + i, ROWS * 4, bar);
      bulk_copy(st + ROWS * 4, p.l + i, ROWS * 4, bar);
      bulk_copy(st + 2 * ROWS * 4, p.di + i, ROWS * 4, bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= BW_ST; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!DKV) {  // m, 1 / l and di of the fixed rows
    if (tid < ROWS) {
      const long long i = sbase + r0 + tid;
      stats[tid] = p.m[i];
      stats[ROWS + tid] = 1.f / p.l[i];
      stats[2 * ROWS + tid] = p.di[i];
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (!multi) {
      bar_expect(fbar, 2 * BW_SLICE);
      load_fixed(rank, fbar);
    }
    for (int j = 0; j < (multi ? 1 : BW_ST) && j < tiles; ++j)
      load_item(j, 0);
  }
  __syncwarp();

  // the warpgroup's gradient (wgmma's accumulator layout): dK/dV, all 128
  // columns of the slice (warpgroup 0 dK, 1 dV); dQ, 64 of them
  constexpr int GN = DKV ? WC : WC / 2;
  float acc[GN / 2], sc[32];  // the gradient; the partial of S or dP
  uint32_t fa[4][4];          // P^T or dS^T (dS) as A fragments
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) fa[i / 4][i % 4] = 0u;

  // the warpgroup's partial of tile j's S (warpgroup 0) or dP (1) into sc:
  // one chain, issued and left in flight; with passes each item in turn,
  // each waited for before the next is loaded
  const uint32_t fix = base + BW_FIX + wg * BW_SLICE;
  auto contract = [&](int j) {
    const int s = j % BW_ST;
    const uint32_t st = base + BW_STG + s * 2 * BW_SLICE + wg * BW_SLICE;
    for (int k = 0; k < items; ++k) {
      if (!multi && j == 0) bar_wait(fbar, 0);
      bar_wait(bars + 8 * s, ((j / BW_ST) * items + k) & 1);
      hold(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
        mma_ss(sc, desc(fix + off), desc(st + off), k > 0 || kk > 0);
      }
      wg_commit();
      if (k + 1 < items) {
        wg_wait<0>();
        hold(sc);
        __syncthreads();  // no warp reads the item's slices any more
        if (tid == 0) load_item(j, k + 1);
        __syncwarp();
      }
    }
  };

  // tile j's partial (its products retired) into its buffer: the float4
  // nt 128 + t holds accumulator thread t's elements 4 nt to 4 nt + 3
  // (n-tile nt: columns 8 nt + 2 c and + 1 of rows 16 warp + g and + 8)
  auto publish = [&](int j) {
    float4* pw = reinterpret_cast<float4*>(sm + BW_PART +
                                           (j & 1) * 2 * BW_PM + wg * BW_PM);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      pw[nt * WG + t] = make_float4(sc[4 * nt], sc[4 * nt + 1],
                                    sc[4 * nt + 2], sc[4 * nt + 3]);
  };

  // The exchange. Unit u is n-tile nt = u / 128 of accumulator thread at =
  // u % 128 (rows 16 (at / 32) + (at % 32) / 4 and + 8, columns 8 nt + 2
  // (at % 4) and + 1): in every block's partial of S (and of dP) the
  // float4 nt 128 + at.
  constexpr int RB = 4;         // ranks loaded before their adds
  using Loads = float4[RB][2];  // [rank][S, dP]
  const int lo_u = rank * BW_UNITS / cs, hi_u = (rank + 1) * BW_UNITS / cs;
  // the unit's S and dP in the partials at byte offset `part` of ranks q0
  // to q0 + RB - 1 (zeros past cs and with `on` false)
  auto own_load = [&](Loads& x, int part, int u, bool on, int q0) {
    const int at = u & (WG - 1), nt = u >> 7;
#pragma unroll
    for (int qq = 0; qq < RB; ++qq) {
      const bool here = on && q0 + qq < cs;
      const uint32_t a = (here ? cluster_map(base, q0 + qq) : 0) + part +
                         (nt * WG + at) * 16;
#pragma unroll
      for (int mat = 0; mat < 2; ++mat)
        x[qq][mat] = here ? ld_dsmem4(a + mat * BW_PM)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // a unit's tile j from the loads of ranks 0 to RB - 1 (the others are
  // loaded here): the cs partials added in rank order, then P and dS in
  // fp32, rounded to bf16 and pushed to every block as the A-fragment
  // registers 2 (nt % 2) and + 1 of k-step nt / 2 of thread at: dK/dV P's
  // and dS's in one 16-byte piece, dQ dS's in an 8-byte one
  auto own_finish = [&](const Loads& x, int j, int u) {
    const int part = BW_PART + (j & 1) * 2 * BW_PM;
    const int at = u & (WG - 1), nt = u >> 7;
    float2 a[2][2];  // [S, dP][row half]
    auto add = [&](const Loads& y, int q0) {
#pragma unroll
      for (int qq = 0; qq < RB; ++qq)
        if (q0 + qq < cs) {
#pragma unroll
          for (int mat = 0; mat < 2; ++mat) {
            const float4 v = y[qq][mat];
            a[mat][0] = q0 + qq == 0 ? make_float2(v.x, v.y)
                                     : make_float2(a[mat][0].x + v.x,
                                                   a[mat][0].y + v.y);
            a[mat][1] = q0 + qq == 0 ? make_float2(v.z, v.w)
                                     : make_float2(a[mat][1].x + v.z,
                                                   a[mat][1].y + v.w);
          }
        }
    };
    add(x, 0);
#pragma unroll
    for (int q0 = RB; q0 < WCLUSTER; q0 += RB)
      if (q0 < cs) {
        Loads y;
        own_load(y, part, u, true, q0);
        add(y, q0);
      }
    // dK/dV: the streamed (q) row of an element is its column; dQ: the
    // fixed row
    const float* st = DKV ? stats + (j % BW_ST) * 3 * ROWS : stats;
    const int col0 = 8 * nt + 2 * (at & 3),
              row0 = 16 * (at >> 5) + ((at & 31) >> 2);
    uint32_t pv[2], dv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float pe[2], de[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = DKV ? col0 + e : row0 + 8 * hh;
        const float s = e ? a[0][hh].y : a[0][hh].x,
                    d = e ? a[1][hh].y : a[1][hh].x;
        const float iv = DKV ? 1.f / st[ROWS + r] : st[ROWS + r];
        pe[e] = exp_ftz(__fmul_rn(s, p.scale) - st[r]) * iv;
        de[e] = (d - st[2 * ROWS + r]) * pe[e] * p.scale;
      }
      pv[hh] = pack_bf16(pe[0], pe[1]);
      dv[hh] = pack_bf16(de[0], de[1]);
    }
    const uint32_t off = BW_FRAG + (j & 1) * 2 * BW_FM +
                         (nt * WG + at) * (DKV ? 16 : 8);
#pragma unroll
    for (int q = 0; q < WCLUSTER; ++q)
      if (q < cs) {
        const uint32_t rb = cluster_map(base, q) + off;
        if constexpr (DKV)
          st_dsmem(rb, make_uint4(pv[0], pv[1], dv[0], dv[1]));
        else
          st_dsmem(rb, make_uint2(dv[0], dv[1]));
      }
  };
  Loads xo;  // the first turn's loads, issued a tile ahead
  auto own_pref = [&](int j) {
    own_load(xo, BW_PART + (j & 1) * 2 * BW_PM, lo_u + tid,
             lo_u + tid < hi_u, 0);
  };
  auto own_fin = [&](int j) {
    if (lo_u + tid < hi_u) own_finish(xo, j, lo_u + tid);
    for (int u0 = lo_u + WT; u0 < hi_u; u0 += WT)
      if (u0 + tid < hi_u) {
        Loads y;
        own_load(y, BW_PART + (j & 1) * 2 * BW_PM, u0 + tid, true, 0);
        own_finish(y, j, u0 + tid);
      }
  };

  // tile j's gradient products from the fragments in this block's shared
  // memory (dK/dV: warpgroup 0 dS, 1 P) and the tile's stage, left in
  // flight
  auto consume = [&](int j) {
    if (!out) return;
    const unsigned char* fr = sm + BW_FRAG + (j & 1) * 2 * BW_FM +
                              (DKV && wg == 0 ? 8 : 0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint2 x = *reinterpret_cast<const uint2*>(
          fr + (nt * WG + t) * (DKV ? 16 : 8));
      fa[nt >> 1][2 * (nt & 1)] = x.x;
      fa[nt >> 1][2 * (nt & 1) + 1] = x.y;
    }
    const uint32_t st = base + BW_STG + (j % BW_ST) * 2 * BW_SLICE +
                        (DKV ? wg * BW_SLICE : 0);
    hold(acc);
    hold(fa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DKV)
        mma_rs128(acc, fa[kk], desc_mn(st + kk * 16 * 128, BOX));
      else
        mma_rs(acc, fa[kk], desc(st + wg * BOX + kk * 16 * 128));
    }
    wg_commit();
  };

  contract(0);
  wg_wait<0>();
  hold(sc);
  publish(0);
  __syncthreads();
  if (tid == 0 && multi && tiles > 1) load_item(1, 0);
  __syncwarp();
  cluster_sync();  // every block has started and written tile 0's partials
  if (tiles > 1) contract(1);
  own_pref(0);
  own_fin(0);
  wg_wait<0>();
  hold(sc);
  if (tiles > 1) publish(1);
  __syncthreads();
  if (tid == 0 && multi && tiles > 2) load_item(2, 0);
  __syncwarp();
  cluster_sync();  // P and dS of tile 0 and the partials of tile 1 seen
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) own_pref(j + 1);
    consume(j);
    if (j + 2 < tiles) contract(j + 2);
    if (j + 1 < tiles) own_fin(j + 1);
    wg_wait<0>();  // tile j's gradients and tile j + 2's contraction
    hold(acc);
    hold(fa);
    hold(sc);
    if (j + 2 < tiles) publish(j + 2);
    __syncthreads();  // tile j's stage takes tile j + 3
    if (tid == 0 && j + 3 < tiles) load_item(j + 3, 0);
    __syncwarp();
    cluster_sync();  // P and dS of tile j + 1, partials of tile j + 2 seen
  }

  if (out) {  // rows 16 warp + g and + 8, columns 8 q + 2 c and + 1
    const bool second = DKV && wg == 1;  // dV
    const long long n_stride = second ? p.g2_n : p.g1_n;
    __nv_bfloat16* o = (second ? static_cast<__nv_bfloat16*>(p.g2) +
                                     b * p.g2_b + h * p.g2_h
                               : static_cast<__nv_bfloat16*>(p.g1) +
                                     b * p.g1_b + h * p.g1_h) +
                       (r0 + 16 * warp + g) * n_stride + WC * gs +
                       (DKV ? 0 : GN * wg) + 2 * c;
#pragma unroll
    for (int q = 0; q < GN / 8; ++q)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<__nv_bfloat162*>(o + rr * 8 * n_stride + 8 * q) =
            __floats2bfloat162_rn(acc[4 * q + 2 * rr],
                                  acc[4 * q + 2 * rr + 1]);
  }
}

// The bf16 (dtype 0) or fp32 wide kernel's launch at a shape with `fixed`
// fixed rows: its grid (a cluster of cs blocks along Dh for each fixed tile
// and pass), two warpgroups a block, its shared memory, on stream `st`.
inline void wide_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& at,
                        int dtype, int fixed, int B, int H, int D,
                        cudaStream_t st) {
  wide_launch_config(cfg, at, fixed / ROWS, B, H, D, WT,
                     dtype == 0 ? smem_wide_bf16() : smem_wide_f32(), st);
}

template <bool DKV>
auto wide_kernel(int dtype) {
  return dtype == 0 ? flash_bwd_wide_bf16<DKV> : flash_bwd_wide_f32<DKV>;
}

// Blocks of the kernel `fn` that fit on one SM with `smem` bytes of shared
// memory, as the occupancy API counts them from its registers, threads and
// shared memory; -1 if refused.
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

// of the bf16 (dtype 0) or fp32 kernel
template <int D, bool DKV>
int blocks_per_sm(int dtype) {
  return dtype == 0 ? occupancy(flash_bwd_bf16<D, DKV>, smem_bf16<D, DKV>())
                    : occupancy(flash_bwd_f32<D, DKV>, smem_f32<D, DKV>());
}

template <bool DKV>
int blocks_per_sm_wide(int dtype) {
  return occupancy(wide_kernel<DKV>(dtype),
                   dtype == 0 ? smem_wide_bf16() : smem_wide_f32(), WT);
}

// The four TMA maps: fixed tiles of 64 rows, streamed tiles of `rs` rows,
// boxes of 128 bytes of columns (64 bf16 or 32 fp32, by `esize`); false if
// the streamed or fixed rows are no multiple of their tiles or a map is
// refused.
template <bool DKV>
bool maps(TmaParams& tp, int D, int B, int H, int esize, int rs) {
  const Params& p = tp.p;
  const int fixed = DKV ? p.n_kv : p.n_q, streamed = DKV ? p.n_q : p.n_kv;
  if (fixed % ROWS != 0 || streamed % rs != 0) return false;
  const int q_rows = DKV ? rs : ROWS, kv_rows = DKV ? ROWS : rs;
  CUtensorMap q, k, v, d;
  if (!tensor_map(&q, p.q, D, p.n_q, H, B, p.q_n, p.q_h, p.q_b, esize,
                  q_rows) ||
      !tensor_map(&k, p.k, D, p.n_kv, H, B, p.k_n, p.k_h, p.k_b, esize,
                  kv_rows) ||
      !tensor_map(&v, p.v, D, p.n_kv, H, B, p.v_n, p.v_h, p.v_b, esize,
                  kv_rows) ||
      !tensor_map(&d, p.dout, D, p.n_q, H, B, p.d_n, p.d_h, p.d_b, esize,
                  q_rows))
    return false;
  tp.f1 = DKV ? k : q;
  tp.f2 = DKV ? v : d;
  tp.s1 = DKV ? q : k;
  tp.s2 = DKV ? d : v;
  return true;
}

template <int D, bool DKV>
int launch(int dtype, int B, int H, const Params& p, cudaStream_t st) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // bf16: 64-row tiles of 64 columns; fp32: fixed tiles of 64 rows and
  // streamed tiles of F32<D>::RS rows, 32 columns a box
  TmaParams tp;
  tp.p = p;
  if (!maps<DKV>(tp, D, B, H, dtype == 0 ? 2 : 4,
                 dtype == 0 ? ROWS : F32<D>::RS))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((DKV ? p.n_kv : p.n_q) / ROWS * (D / 64), H, B);
  cudaError_t e;
  if (dtype == 0) {
    e = cudaFuncSetAttribute(flash_bwd_bf16<D, DKV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bf16<D, DKV>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_bf16<D, DKV><<<grid, WG, smem_bf16<D, DKV>(), st>>>(tp);
  } else {
    e = cudaFuncSetAttribute(flash_bwd_f32<D, DKV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_f32<D, DKV>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_f32<D, DKV><<<grid, WG, smem_f32<D, DKV>(), st>>>(tp);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dh a multiple of 128 from 384 up, on clusters along Dh: bf16, streamed
// tiles of 64 rows; fp32, of WRS rows
template <bool DKV>
int launch_wide(int dtype, int B, int H, int D, const Params& p,
                cudaStream_t st) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TmaParams tp;
  tp.p = p;
  if (!maps<DKV>(tp, D, B, H, dtype == 0 ? 2 : 4, dtype == 0 ? ROWS : WRS))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = wide_kernel<DKV>(dtype);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dtype == 0 ? smem_wide_bf16() : smem_wide_f32());
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at;
  wide_config(cfg, at, dtype, DKV ? p.n_kv : p.n_q, B, H, D, st);
  e = cudaLaunchKernelEx(&cfg, fn, tp, D);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool wide(int D) { return D >= FLASH_WIDE_FROM && D % 128 == 0; }

template <bool DKV>
int dispatch(int dtype, int B, int H, int D, const Params& p,
             cudaStream_t st) {
  if (B < 1 || H < 1 || p.n_q < 1 || p.n_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide(D)) return launch_wide<DKV>(dtype, B, H, D, p, st);
  switch (D) {
    case 64: return launch<64, DKV>(dtype, B, H, p, st);
    case 128: return launch<128, DKV>(dtype, B, H, p, st);
    case 256: return launch<256, DKV>(dtype, B, H, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How the bf16 (dtype 0) or fp32 kernel runs at this shape: plan[0] the
// blocks it launches, plan[1] its blocks an SM (-1 if refused), plan[2] the
// blocks of its clusters (1: no cluster), plan[3] the clusters that fit on
// the card at once (cudaOccupancyMaxActiveClusters; 0: no cluster)
template <bool DKV>
int plan_for(int dtype, int D, int B, int H, int n_q, int n_kv, int* plan) {
  if (dtype != 0 && dtype != 1) return -1;
  const int fixed = DKV ? n_kv : n_q;
  plan[0] = fixed / ROWS * (D / 64) * H * B;
  plan[2] = 1;
  plan[3] = 0;
  if (wide(D)) {
    plan[1] = blocks_per_sm_wide<DKV>(dtype);
    cudaLaunchConfig_t cfg;  // the cluster kernels: their own grid
    cudaLaunchAttribute at;
    wide_config(cfg, at, dtype, fixed, B, H, D, nullptr);
    plan[0] = static_cast<int>(cfg.gridDim.x * cfg.gridDim.y * cfg.gridDim.z);
    plan[2] = static_cast<int>(at.val.clusterDim.x);
    if (cudaOccupancyMaxActiveClusters(&plan[3], wide_kernel<DKV>(dtype),
                                       &cfg) != cudaSuccess)
      plan[3] = -1;
  } else {
    switch (D) {
      case 64: plan[1] = blocks_per_sm<64, DKV>(dtype); break;
      case 128: plan[1] = blocks_per_sm<128, DKV>(dtype); break;
      case 256: plan[1] = blocks_per_sm<256, DKV>(dtype); break;
      default: return -1;
    }
  }
  return 0;
}

}  // namespace flash_bwd

// dtype 0: bf16, 1: fp32 (q, k, v, do and the gradients alike). Dh 64, 128
// and 256 take a template instance each, every multiple of 128 from 384 up
// the wide kernels. m, l, di: (B, H, n_q) fp32, contiguous. Strides in
// elements: (batch, row, head) of q, k, v, do and the gradients; Dh is
// contiguous. Each returns a cudaError_t: not 0 if the shape is refused or
// the launch failed.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* m, const float* l, const float* di, void* dk, void* dv,
    int dtype, int B, int H, int n_q, int n_kv, int D, long long q_b,
    long long q_n, long long q_h, long long k_b, long long k_n, long long k_h,
    long long v_b, long long v_n, long long v_h, long long d_b, long long d_n,
    long long d_h, long long dk_b, long long dk_n, long long dk_h,
    long long dv_b, long long dv_n, long long dv_h, float scale,
    void* stream) {
  const flash_bwd::Params p{q,    k,    v,    dout, m,    l,    di,
                            dk,   dv,   n_q,  n_kv, q_b,  q_n,  q_h,
                            k_b,  k_n,  k_h,  v_b,  v_n,  v_h,  d_b,
                            d_n,  d_h,  dk_b, dk_n, dk_h, dv_b, dv_n,
                            dv_h, scale};
  return flash_bwd::dispatch<true>(dtype, B, H, D, p,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* m, const float* l, const float* di, void* dq, int dtype,
    int B, int H, int n_q, int n_kv, int D, long long q_b, long long q_n,
    long long q_h, long long k_b, long long k_n, long long k_h, long long v_b,
    long long v_n, long long v_h, long long d_b, long long d_n, long long d_h,
    long long dq_b, long long dq_n, long long dq_h, float scale,
    void* stream) {
  const flash_bwd::Params p{q,    k,    v,    dout, m,   l,   di,  dq,
                            nullptr, n_q, n_kv, q_b, q_n, q_h, k_b, k_n,
                            k_h,  v_b,  v_n,  v_h,  d_b, d_n, d_h, dq_b,
                            dq_n, dq_h, 0,    0,    0,   scale};
  return flash_bwd::dispatch<false>(dtype, B, H, D, p,
                                    static_cast<cudaStream_t>(stream));
}

// How the bf16 (dtype 0) or fp32 dK/dV (dkv != 0) or dQ kernel runs at
// this shape, four ints: plan[0] the blocks it launches, plan[1] its blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, -1 if refused),
// plan[2] its cluster's blocks (1 without a cluster), plan[3] its clusters
// resident at once (cudaOccupancyMaxActiveClusters, 0 without a cluster).
extern "C" int flash_attention_bwd_plan(int dkv, int dtype, int D, int B,
                                        int H, int n_q, int n_kv,
                                        int* plan) {
  return dkv ? flash_bwd::plan_for<true>(dtype, D, B, H, n_q, n_kv, plan)
             : flash_bwd::plan_for<false>(dtype, D, B, H, n_q, n_kv, plan);
}
