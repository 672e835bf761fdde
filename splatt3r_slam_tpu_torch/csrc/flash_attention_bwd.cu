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
// so the design is about keeping the tensor cores fed. In fp32 (no TF32)
// the products run on the fp32 pipes (67 TFLOP/s).
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
// fp32: the fp32 FMA pipes (no tensor cores, so no TF32); 8 threads a
// fixed row, 32 fixed rows a block, streamed tiles of 32 rows through a
// two-stage 16-byte cp.async ring; a thread owns 4 of the tile's scores
// and Dh/8 columns of each gradient; P and dS pass through shared memory
// within the 8 lanes of their row.

#include <cuda.h>          // CUtensorMap and its enums (declarations only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled, as declared here
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_bwd {

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

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copy of `rows` rows of D elements (row stride `stride` in
// device memory, `ld` in shared memory) in 16-byte pieces.
template <int D, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long stride, int rows,
                                           int tid) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int PIECES = D / PER;
  for (int i = tid; i < rows * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * PER;
    cp_async_16(dst + r * ld + c, src + r * stride + c);
  }
}

// Start the copy of m, l and di for streamed q rows [q0, q0 + rows) into
// dst[0, rows), dst[rows, 2 rows), dst[2 rows, 3 rows).
template <int THREADS>
__device__ __forceinline__ void stage_stats(float* dst, const Params& p,
                                            long long base, int q0, int rows,
                                            int tid) {
  const int pieces = rows / 4;
  for (int i = tid; i < 3 * pieces; i += THREADS) {
    const int which = i / pieces, c = (i % pieces) * 4;
    const float* src = which == 0 ? p.m : (which == 1 ? p.l : p.di);
    cp_async_16(dst + which * rows + c, src + base + q0 + c);
  }
}

// __expf's steps (ex2.approx of x times log2 e) with denormals flushed
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(bar) : "memory");
}

// The one arrival of the barrier's phase, with the bytes its copies bring.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred ready;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n"
        "selp.u32 %0, 1, 0, ready;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One 64 x 64 box of a (Dh, N, H, B) tensor map, at column `col` and row
// `row` of head h of batch b, into shared memory at `dst`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int col, int row, int h, int b,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(h), "r"(b), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma's descriptor of an operand in shared memory in the 128-byte
// swizzled layout that TMA writes (rows of 128 bytes, 1024-byte aligned
// groups of 8 rows): the start address, both byte offsets 1024 (the next
// group of 8 rows; the other offset is not stepped by a 64-wide operand
// in either major order) and layout 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define FLASH_BWD_ACC32(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define FLASH_BWD_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, fp32) = a b^T (+ d if `accumulate`): a (64 x 16) and b
// (64 x 16) both K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_BWD_D32
      ", %32, %33, acc, 1, 1, 0, 0;\n}\n"
      : FLASH_BWD_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += a b: a (64 x 16, bf16) from registers, b (16 x 64)
// MN-major in shared memory (the streamed tile's rows as they lie).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_BWD_D32
      ", {%32, %33, %34, %35}, %36, acc, 1, 1, 1;\n}\n"
      : FLASH_BWD_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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

constexpr int F_THREADS = 256;
constexpr int F_R = 8;                     // threads a fixed row
constexpr int F_BR = F_THREADS / F_R;      // fixed rows a block
constexpr int F_BC = 32;                   // streamed rows a tile
constexpr int F_PAD = 4;                   // floats of padding a row
constexpr int F_LDP = F_BC + F_PAD;

template <int D, bool DKV>
constexpr int smem_f32() {
  return ((2 * F_BR + 4 * F_BC) * (D + F_PAD) + 2 * F_BR * F_LDP +
          (DKV ? 2 * 3 * F_BC : 0)) * 4;
}

template <int D, bool DKV>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_f32(const Params p) {
  constexpr int LD = D + F_PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* f1 = reinterpret_cast<float*>(smem);  // [F_BR][LD] k | q
  float* f2 = f1 + F_BR * LD;                  // v | do
  float* s1 = f2 + F_BR * LD;                  // [2][F_BC][LD] q | k
  float* s2 = s1 + 2 * F_BC * LD;              // do | v
  float* ps = s2 + 2 * F_BC * LD;              // [F_BR][F_LDP] P
  float* ds = ps + F_BR * F_LDP;               // [F_BR][F_LDP] dS
  float* st = ds + F_BR * F_LDP;               // [2][3][F_BC] m, l, di

  const int tid = threadIdx.x, row = tid / F_R, c8 = tid % F_R;
  const int r0 = blockIdx.x * F_BR, h = blockIdx.y, b = blockIdx.z;
  const long long sbase =
      (static_cast<long long>(b) * gridDim.y + h) * p.n_q;
  const float* q = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* k = static_cast<const float*>(p.k) + b * p.k_b + h * p.k_h;
  const float* v = static_cast<const float*>(p.v) + b * p.v_b + h * p.v_h;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.d_b + h * p.d_h;
  const float* fg1 = DKV ? k + r0 * p.k_n : q + r0 * p.q_n;
  const float* fg2 = DKV ? v + r0 * p.v_n : dout + r0 * p.d_n;
  const long long fn1 = DKV ? p.k_n : p.q_n, fn2 = DKV ? p.v_n : p.d_n;
  const float* sg1 = DKV ? q : k;
  const float* sg2 = DKV ? dout : v;
  const long long sn1 = DKV ? p.q_n : p.k_n, sn2 = DKV ? p.d_n : p.v_n;
  const int tiles = (DKV ? p.n_q : p.n_kv) / F_BC;

  stage_rows<D, F_THREADS>(f1, LD, fg1, fn1, F_BR, tid);
  stage_rows<D, F_THREADS>(f2, LD, fg2, fn2, F_BR, tid);
  stage_rows<D, F_THREADS>(s1, LD, sg1, sn1, F_BC, tid);
  stage_rows<D, F_THREADS>(s2, LD, sg2, sn2, F_BC, tid);
  if constexpr (DKV) stage_stats<F_THREADS>(st, p, sbase, 0, F_BC, tid);
  cp_async_commit();

  float rm = 0.f, rinv = 0.f, rdi = 0.f;  // dQ: the row's m, 1 / l, di
  if constexpr (!DKV) {
    const long long i = sbase + r0 + row;
    rm = p.m[i];
    rinv = 1.f / p.l[i];
    rdi = p.di[i];
  }
  float acc1[D / F_R], acc2[DKV ? D / F_R : 1];  // columns c8 + 8 i
#pragma unroll
  for (int i = 0; i < D / F_R; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKV ? D / F_R : 1); ++i) acc2[i] = 0.f;

  const float* fr1 = f1 + row * LD;
  const float* fr2 = f2 + row * LD;
  float* pr = ps + row * F_LDP;
  float* dr = ds + row * F_LDP;
  for (int j = 0; j < tiles; ++j) {
    const int s = j & 1;
    if (j + 1 < tiles) {
      const long long r = static_cast<long long>(j + 1) * F_BC;
      stage_rows<D, F_THREADS>(s1 + (s ^ 1) * F_BC * LD, LD, sg1 + r * sn1,
                               sn1, F_BC, tid);
      stage_rows<D, F_THREADS>(s2 + (s ^ 1) * F_BC * LD, LD, sg2 + r * sn2,
                               sn2, F_BC, tid);
      if constexpr (DKV)
        stage_stats<F_THREADS>(st + (s ^ 1) * 3 * F_BC, p, sbase,
                               (j + 1) * F_BC, F_BC, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* t1 = s1 + s * F_BC * LD;
    const float* t2 = s2 + s * F_BC * LD;
    const float* tm = st + s * 3 * F_BC;

    // the row's scores and dP at streamed columns c8 + 8 i
    float sc[F_BC / F_R], dp[F_BC / F_R];
#pragma unroll
    for (int i = 0; i < F_BC / F_R; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float x1 = fr1[d], x2 = fr2[d];
#pragma unroll
      for (int i = 0; i < F_BC / F_R; ++i) {
        sc[i] = fmaf(x1, t1[(c8 + F_R * i) * LD + d], sc[i]);
        dp[i] = fmaf(x2, t2[(c8 + F_R * i) * LD + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < F_BC / F_R; ++i) {
      const int col = c8 + F_R * i;
      const float mm = DKV ? tm[col] : rm;
      const float inv = DKV ? 1.f / tm[F_BC + col] : rinv;
      const float dd = DKV ? tm[2 * F_BC + col] : rdi;
      const float pv = expf(__fmul_rn(sc[i], p.scale) - mm) * inv;
      pr[col] = pv;
      dr[col] = (dp[i] - dd) * pv * p.scale;
    }
    __syncwarp();  // the row's P and dS, written by its 8 lanes

#pragma unroll 4
    for (int c = 0; c < F_BC; ++c) {
      const float dc = dr[c];
      const float* b1 = t1 + c * LD + c8;
#pragma unroll
      for (int i = 0; i < D / F_R; ++i)
        acc1[i] = fmaf(dc, b1[F_R * i], acc1[i]);
      if constexpr (DKV) {
        const float pc = pr[c];
        const float* b2 = t2 + c * LD + c8;
#pragma unroll
        for (int i = 0; i < D / F_R; ++i)
          acc2[i] = fmaf(pc, b2[F_R * i], acc2[i]);
      }
    }
    __syncthreads();  // the ring buffer, P and dS are refilled next tile
  }

  float* o1 = static_cast<float*>(p.g1) + b * p.g1_b + h * p.g1_h +
              (r0 + row) * p.g1_n + c8;
#pragma unroll
  for (int i = 0; i < D / F_R; ++i) o1[F_R * i] = acc1[i];
  if constexpr (DKV) {
    float* o2 = static_cast<float*>(p.g2) + b * p.g2_b + h * p.g2_h +
                (r0 + row) * p.g2_n + c8;
#pragma unroll
    for (int i = 0; i < D / F_R; ++i) o2[F_R * i] = acc2[i];
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query, so that the library needs no link against libcuda.
using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The TMA map of one bf16 tensor in the JAX layout, as a 4-d (Dh, N, H, B)
// tensor with the given strides (elements), boxes of 64 x 64 and 128-byte
// swizzle. A dimension of size 1 is never stepped: it takes the row stride.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int D, int N,
                       int H, int B, long long s_n, long long s_h,
                       long long s_b) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(s_n) * 2,
      static_cast<cuuint64_t>(H > 1 ? s_h : s_n) * 2,
      static_cast<cuuint64_t>(B > 1 ? s_b : s_n) * 2};
  const cuuint32_t box[4] = {64, ROWS, 1, 1}, step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Blocks of a bf16 kernel that fit on one SM, as the occupancy API counts
// them from its registers, threads and shared memory; -1 if refused.
template <int D, bool DKV>
int blocks_per_sm() {
  int n = -1;
  if (cudaFuncSetAttribute(flash_bwd_bf16<D, DKV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bf16<D, DKV>()) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_bwd_bf16<D, DKV>, WG, smem_bf16<D, DKV>()) !=
          cudaSuccess)
    return -1;
  return n;
}

template <int D, bool DKV>
int launch(int dtype, int B, int H, const Params& p, cudaStream_t st) {
  const int fixed = DKV ? p.n_kv : p.n_q, streamed = DKV ? p.n_q : p.n_kv;
  cudaError_t e;
  if (dtype == 0) {
    if (fixed % ROWS != 0 || streamed % ROWS != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    TmaParams tp;
    tp.p = p;
    CUtensorMap q, k, v, d;
    if (!tensor_map(&q, p.q, D, p.n_q, H, B, p.q_n, p.q_h, p.q_b) ||
        !tensor_map(&k, p.k, D, p.n_kv, H, B, p.k_n, p.k_h, p.k_b) ||
        !tensor_map(&v, p.v, D, p.n_kv, H, B, p.v_n, p.v_h, p.v_b) ||
        !tensor_map(&d, p.dout, D, p.n_q, H, B, p.d_n, p.d_h, p.d_b))
      return static_cast<int>(cudaErrorInvalidValue);
    tp.f1 = DKV ? k : q;
    tp.f2 = DKV ? v : d;
    tp.s1 = DKV ? q : k;
    tp.s2 = DKV ? d : v;
    e = cudaFuncSetAttribute(flash_bwd_bf16<D, DKV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bf16<D, DKV>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_bf16<D, DKV><<<dim3(fixed / ROWS * Ring<D>::NSUB, H, B), WG,
                             smem_bf16<D, DKV>(), st>>>(tp);
  } else if (dtype == 1) {
    if (fixed % F_BR != 0 || streamed % F_BC != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(flash_bwd_f32<D, DKV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_f32<D, DKV>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_f32<D, DKV><<<dim3(fixed / F_BR, H, B), F_THREADS,
                            smem_f32<D, DKV>(), st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// How the bf16 dK/dV (dkv != 0) or dQ kernel runs at this shape: plan[0]
// the blocks it launches, plan[1] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, -1 if refused).
template <int D, bool DKV>
int plan_for(int B, int H, int n_q, int n_kv, int* plan) {
  plan[0] = (DKV ? n_kv : n_q) / ROWS * Ring<D>::NSUB * H * B;
  plan[1] = blocks_per_sm<D, DKV>();
  return 0;
}

template <bool DKV>
int dispatch(int dtype, int B, int H, int D, const Params& p,
             cudaStream_t st) {
  if (B < 1 || H < 1 || p.n_q < 1 || p.n_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return launch<64, DKV>(dtype, B, H, p, st);
    case 128: return launch<128, DKV>(dtype, B, H, p, st);
    case 192: return launch<192, DKV>(dtype, B, H, p, st);
    case 256: return launch<256, DKV>(dtype, B, H, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash_bwd

// dtype 0: bf16, 1: fp32 (q, k, v, do and the gradients alike). m, l, di:
// (B, H, n_q) fp32, contiguous. Strides in elements: (batch, row, head) of
// q, k, v, do and the gradients; Dh is contiguous. Each returns a
// cudaError_t: not 0 if the shape is refused or the launch failed.
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

extern "C" int flash_attention_bwd_plan(int dkv, int D, int B, int H,
                                        int n_q, int n_kv, int* plan) {
  using flash_bwd::plan_for;
  switch (D) {
    case 64: return dkv ? plan_for<64, true>(B, H, n_q, n_kv, plan)
                        : plan_for<64, false>(B, H, n_q, n_kv, plan);
    case 128: return dkv ? plan_for<128, true>(B, H, n_q, n_kv, plan)
                         : plan_for<128, false>(B, H, n_q, n_kv, plan);
    case 192: return dkv ? plan_for<192, true>(B, H, n_q, n_kv, plan)
                         : plan_for<192, false>(B, H, n_q, n_kv, plan);
    case 256: return dkv ? plan_for<256, true>(B, H, n_q, n_kv, plan)
                         : plan_for<256, false>(B, H, n_q, n_kv, plan);
    default: return -1;
  }
}
