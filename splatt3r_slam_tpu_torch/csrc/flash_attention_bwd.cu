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
// by one block in one order, with no atomics, so the gradients are the
// same bits from run to run. The TPU walks 128 x 128 blocks; these kernels
// walk tiles of 64 rows (bf16) or 32 (fp32): only the order of the fp32
// sums differs.
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
// moves a few MB (under 3 us at 3.35 TB/s): both are bound by operations.
// In fp32 (no TF32) the products run on the fp32 pipes (67 TFLOP/s).
//
// Design (simple first; wgmma, TMA and warp specialisation come later).
// Both kernels have one shape: a block owns a tile of "fixed" rows and
// walks the other side's rows in tiles of "streamed" rows.
//   dK/dV: fixed rows are kv rows (k and v); streamed rows are q rows (q,
//          do and their m, l, di). The warp computes S^T = K Q^T and
//          dP^T = V dO^T, so that P^T and dS^T come out of the
//          accumulators already transposed, as A fragments of
//          dV += P^T dO and dK += dS^T Q: no transpose through shared
//          memory.
//   dQ:    fixed rows are q rows (q, do, m, l, di); streamed rows are kv
//          rows (k, v). S = Q K^T, dP = dO V^T, dQ += dS K.
// In both, acc1 += dS' B1 and (dK/dV only) acc2 += P' B2, where B1 is the
// streamed tile that entered S (Q or K) and B2 the one that entered dP (dO).
// bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate), as the forward. A
// warp owns 16 fixed rows and 64 output columns; the S and dP tiles
// (16 x 64) are accumulators whose neighbouring 8-column pairs are, element
// for element, the A fragments of the next product, so P and dS go from
// registers to the tensor cores rounded to bf16. For Dh above 64 the
// output columns are split over Dh / 64 warps that share their fixed rows
// and each recompute S and dP: every warp then holds 64 accumulator
// columns (32 registers a gradient), whatever Dh, and nothing spills.
// Blocks of 64 fixed rows (4 row groups) for Dh 64 and 128, 32 (2 row
// groups) for Dh 192 and 256, so a block has at most 8 warps. The fixed
// rows stay in shared memory; the streamed rows (and m, l, di for dK/dV)
// pass through a two-stage 16-byte cp.async ring, tile j + 1 in flight
// while tile j is consumed; rows are padded by 16 bytes so that every
// fragment load is free of bank conflicts. fp32: the fp32 FMA pipes (no
// tensor cores, so no TF32); 8 threads a fixed row, 32 fixed rows a block,
// streamed tiles of 32 rows; a thread owns 4 of the tile's scores and Dh/8
// columns of each gradient; P and dS pass through shared memory within the
// 8 lanes of their row.

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

// d += a b, one m16n8k16 tile: bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- bf16 ----

constexpr int BC = 64;  // streamed rows a tile
constexpr int PAD = 8;  // bf16 elements of padding a row

template <int D>
struct Shape {
  static constexpr int SPLIT = D / 64;         // warps sharing a row group
  static constexpr int WR = D <= 128 ? 4 : 2;  // row groups of 16 rows
  static constexpr int THREADS = 32 * WR * SPLIT;
  static constexpr int BR = 16 * WR;  // fixed rows a block
};

template <int D, bool DKV>
constexpr int smem_bf16() {
  return (2 * Shape<D>::BR + 4 * BC) * (D + PAD) * 2 +
         (DKV ? 2 * 3 * BC * 4 : 0);
}

// One block an SM at least: ptxas may then take up to 255 registers a
// thread (with the thread count alone it capped them at 168 and spilled).
template <int D, bool DKV>
__global__ void __launch_bounds__(Shape<D>::THREADS, 1)
    flash_bwd_bf16(const Params p) {
  static_assert(D % 64 == 0, "Dh must be a multiple of 64");
  using S = Shape<D>;
  constexpr int LD = D + PAD;  // bf16 elements a shared row
  constexpr int LDW = LD / 2;  // 32-bit words a shared row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* f1 = reinterpret_cast<__nv_bfloat16*>(smem);  // k | q
  __nv_bfloat16* f2 = f1 + S::BR * LD;                          // v | do
  __nv_bfloat16* s1 = f2 + S::BR * LD;      // [2][BC][LD] q | k
  __nv_bfloat16* s2 = s1 + 2 * BC * LD;     // [2][BC][LD] do | v
  float* st = reinterpret_cast<float*>(s2 + 2 * BC * LD);  // [2][3][BC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp / S::SPLIT, c0 = (warp % S::SPLIT) * 64;
  const int r0 = blockIdx.x * S::BR, h = blockIdx.y, b = blockIdx.z;
  const long long sbase =
      (static_cast<long long>(b) * gridDim.y + h) * p.n_q;  // m, l, di
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_b + h * p.q_h;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_b + h * p.k_h;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_b + h * p.v_h;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.d_b + h * p.d_h;
  // fixed rows (r0 on), streamed rows (from 0), their row strides
  const __nv_bfloat16* fg1 = DKV ? k + r0 * p.k_n : q + r0 * p.q_n;
  const __nv_bfloat16* fg2 = DKV ? v + r0 * p.v_n : dout + r0 * p.d_n;
  const long long fn1 = DKV ? p.k_n : p.q_n, fn2 = DKV ? p.v_n : p.d_n;
  const __nv_bfloat16* sg1 = DKV ? q : k;
  const __nv_bfloat16* sg2 = DKV ? dout : v;
  const long long sn1 = DKV ? p.q_n : p.k_n, sn2 = DKV ? p.d_n : p.v_n;
  const int tiles = (DKV ? p.n_q : p.n_kv) / BC;

  stage_rows<D, S::THREADS>(f1, LD, fg1, fn1, S::BR, tid);
  stage_rows<D, S::THREADS>(f2, LD, fg2, fn2, S::BR, tid);
  stage_rows<D, S::THREADS>(s1, LD, sg1, sn1, BC, tid);
  stage_rows<D, S::THREADS>(s2, LD, sg2, sn2, BC, tid);
  if constexpr (DKV) stage_stats<S::THREADS>(st, p, sbase, 0, BC, tid);
  cp_async_commit();

  // dQ: m, 1 / l and di of the warp's rows g and g + 8
  float rm[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f}, rdi[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = sbase + r0 + rg * 16 + g + 8 * r;
      rm[r] = p.m[i];
      rinv[r] = 1.f / p.l[i];
      rdi[r] = p.di[i];
    }
  }

  float acc1[8][4], acc2[DKV ? 8 : 1][4];  // dK | dQ, and dV
#pragma unroll
  for (int t = 0; t < 8; ++t)
    acc1[t][0] = acc1[t][1] = acc1[t][2] = acc1[t][3] = 0.f;
#pragma unroll
  for (int t = 0; t < (DKV ? 8 : 1); ++t)
    acc2[t][0] = acc2[t][1] = acc2[t][2] = acc2[t][3] = 0.f;

  const uint32_t* fw1 =
      reinterpret_cast<const uint32_t*>(f1) + (rg * 16) * LDW;
  const uint32_t* fw2 =
      reinterpret_cast<const uint32_t*>(f2) + (rg * 16) * LDW;
  for (int j = 0; j < tiles; ++j) {
    const int s = j & 1;
    if (j + 1 < tiles) {
      const long long r = static_cast<long long>(j + 1) * BC;
      stage_rows<D, S::THREADS>(s1 + (s ^ 1) * BC * LD, LD, sg1 + r * sn1,
                                sn1, BC, tid);
      stage_rows<D, S::THREADS>(s2 + (s ^ 1) * BC * LD, LD, sg2 + r * sn2,
                                sn2, BC, tid);
      if constexpr (DKV)
        stage_stats<S::THREADS>(st + (s ^ 1) * 3 * BC, p, sbase,
                                (j + 1) * BC, BC, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* t1 = s1 + s * BC * LD;
    const __nv_bfloat16* t2 = s2 + s * BC * LD;
    const uint32_t* sw1 = reinterpret_cast<const uint32_t*>(t1);
    const uint32_t* sw2 = reinterpret_cast<const uint32_t*>(t2);

    // S = F1 S1^T and dP = F2 S2^T: 16 fixed rows x 64 streamed columns
    float sc[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], c[4];
      a[0] = fw1[g * LDW + kk * 8 + t4];
      a[1] = fw1[(g + 8) * LDW + kk * 8 + t4];
      a[2] = fw1[g * LDW + kk * 8 + 4 + t4];
      a[3] = fw1[(g + 8) * LDW + kk * 8 + 4 + t4];
      c[0] = fw2[g * LDW + kk * 8 + t4];
      c[1] = fw2[(g + 8) * LDW + kk * 8 + t4];
      c[2] = fw2[g * LDW + kk * 8 + 4 + t4];
      c[3] = fw2[(g + 8) * LDW + kk * 8 + 4 + t4];
#pragma unroll
      for (int nt = 0; nt < BC / 8; ++nt) {
        const uint32_t* r1 = sw1 + (nt * 8 + g) * LDW + kk * 8 + t4;
        mma_bf16(sc[nt], a, r1[0], r1[4]);
        const uint32_t* r2 = sw2 + (nt * 8 + g) * LDW + kk * 8 + t4;
        mma_bf16(dp[nt], c, r2[0], r2[4]);
      }
    }

    // P and dS, element for element; as A fragments, rounded to bf16.
    // Accumulator element e sits at fixed row g + 8 (e >> 1) and streamed
    // column nt * 8 + 2 t4 + (e & 1).
    const float* tm = st + s * 3 * BC;
    uint32_t pa[BC / 16][4], da[BC / 16][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float mm, inv, dd;
        if constexpr (DKV) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          mm = tm[col];
          inv = 1.f / tm[BC + col];
          dd = tm[2 * BC + col];
        } else {
          mm = rm[e >> 1];
          inv = rinv[e >> 1];
          dd = rdi[e >> 1];
        }
        const float pv = __expf(__fmul_rn(sc[nt][e], p.scale) - mm) * inv;
        sc[nt][e] = pv;
        dp[nt][e] = (dp[nt][e] - dd) * pv * p.scale;
      }
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(sc[nt][0], sc[nt][1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(sc[nt][2], sc[nt][3]);
      da[nt / 2][(nt & 1) * 2] = pack_bf16(dp[nt][0], dp[nt][1]);
      da[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dp[nt][2], dp[nt][3]);
    }

    // acc1 += dS S1[:, c0:c0+64] and (dK/dV) acc2 += P S2[:, c0:c0+64]:
    // a B fragment pairs streamed rows 2 t4 and 2 t4 + 1 of a column
    const uint16_t* h1 = reinterpret_cast<const uint16_t*>(t1);
    const uint16_t* h2 = reinterpret_cast<const uint16_t*>(t2);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint16_t* r1 = h1 + (kk * 16 + 2 * t4) * LD + c0 + g;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint32_t b0 = r1[t * 8] | (uint32_t(r1[LD + t * 8]) << 16);
        const uint32_t b1 =
            r1[8 * LD + t * 8] | (uint32_t(r1[9 * LD + t * 8]) << 16);
        mma_bf16(acc1[t], da[kk], b0, b1);
      }
      if constexpr (DKV) {
        const uint16_t* r2 = h2 + (kk * 16 + 2 * t4) * LD + c0 + g;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const uint32_t b0 = r2[t * 8] | (uint32_t(r2[LD + t * 8]) << 16);
          const uint32_t b1 =
              r2[8 * LD + t * 8] | (uint32_t(r2[9 * LD + t * 8]) << 16);
          mma_bf16(acc2[t], pa[kk], b0, b1);
        }
      }
    }
    __syncthreads();  // the ring buffer is refilled by the next tile
  }

  // rows g and g + 8 of the warp's 16, columns c0 + t * 8 + 2 t4 (+1)
  const int row = r0 + rg * 16 + g;
  __nv_bfloat16* o1 = static_cast<__nv_bfloat16*>(p.g1) + b * p.g1_b +
                      h * p.g1_h + row * p.g1_n + c0 + 2 * t4;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    *reinterpret_cast<__nv_bfloat162*>(o1 + t * 8) =
        __floats2bfloat162_rn(acc1[t][0], acc1[t][1]);
    *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * p.g1_n + t * 8) =
        __floats2bfloat162_rn(acc1[t][2], acc1[t][3]);
  }
  if constexpr (DKV) {
    __nv_bfloat16* o2 = static_cast<__nv_bfloat16*>(p.g2) + b * p.g2_b +
                        h * p.g2_h + row * p.g2_n + c0 + 2 * t4;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(o2 + t * 8) =
          __floats2bfloat162_rn(acc2[t][0], acc2[t][1]);
      *reinterpret_cast<__nv_bfloat162*>(o2 + 8 * p.g2_n + t * 8) =
          __floats2bfloat162_rn(acc2[t][2], acc2[t][3]);
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

template <int D, bool DKV>
int launch(int dtype, int B, int H, const Params& p, cudaStream_t st) {
  const int fixed = DKV ? p.n_kv : p.n_q, streamed = DKV ? p.n_q : p.n_kv;
  cudaError_t e;
  if (dtype == 0) {
    using S = Shape<D>;
    if (fixed % S::BR != 0 || streamed % BC != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(flash_bwd_bf16<D, DKV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bf16<D, DKV>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_bf16<D, DKV><<<dim3(fixed / S::BR, H, B), S::THREADS,
                             smem_bf16<D, DKV>(), st>>>(p);
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
