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
// What bounds it on an H100 (bf16, ViT-L's shapes: B 2, N 768, H 16 or 12,
// Dh 64): the two products are 4·B·H·n_q·n_kv·Dh operations, 4.83 GFLOP at
// H 16, 4.9 us at the dense bf16 tensor-core peak (989 TFLOP/s), while q,
// k, v and the output are 6.3 MB, 1.9 us at 3.35 TB/s: operations bound.
// The B·H·n_q·n_kv exponentials (18.9 M at H 16) run on the special
// function units, 16 a clock per SM, about 4.7 us on their own: about as
// long as the products, and they do not overlap with them inside one warp.
// In fp32 (no TF32) the products run on the fp32 pipes (67 TFLOP/s).
//
// Design (simple first; wgmma, TMA and warp specialisation come later).
// bf16: one block of 4 warps per (b, h, 64 query rows), each warp 16 rows.
// The block's q rows and a ring of two k/v tiles of 64 rows are staged in
// shared memory with 16-byte cp.async, rows padded by 16 bytes so that
// every fragment load below is free of bank conflicts; tile j+1 is in
// flight while tile j is consumed. S = Q K^T and O += P V are
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). The S accumulator of two
// neighbouring 8-column tiles is, element for element, the A fragment of
// P V, so P goes from registers to the tensor cores without shared memory:
// the fp32 row sums take p as it is, the product takes it rounded to bf16.
// Row maxima and sums are reduced over the 4 lanes that share a row with
// two shuffles; the sums are reduced once, at the end. Dh is a template
// parameter (64, 128, 192, 256): the accumulator is Dh/2 fp32 registers a
// thread. fp32: the same blocking with 8 warps and kv tiles of 32 rows on
// the fp32 FMA pipes (no tensor cores, so no TF32): 4 threads a query row,
// each owning 8 of a tile's scores and Dh/4 of the row's output columns,
// P passing through shared memory within the 4 lanes of its row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;  // query rows a block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int n_q, n_kv;
  long long q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, o_b, o_n, o_h;
  float scale;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
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

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;  // 16 query rows a warp
constexpr int BK = 64;               // kv rows a tile
constexpr int PAD = 8;               // bf16 elements of padding a row

template <int D>
constexpr int smem_bf16() {
  return (BQ + 4 * BK) * (D + PAD) * 2;  // q, and a ring of two k and v
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(const Params p) {
  static_assert(D % 16 == 0, "Dh must be a multiple of 16");
  constexpr int LD = D + PAD;  // bf16 elements a shared row
  constexpr int LDW = LD / 2;  // 32-bit words a shared row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BQ * LD;      // [2][BK][LD]
  __nv_bfloat16* vs = ks + 2 * BK * LD;  // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_b + h * p.q_h + q0 * p.q_n;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_b + h * p.k_h;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_b + h * p.v_h;

  stage_rows<D, THREADS>(qs, LD, qg, p.q_n, BQ, tid);
  stage_rows<D, THREADS>(ks, LD, kg, p.k_n, BK, tid);
  stage_rows<D, THREADS>(vs, LD, vg, p.v_n, BK, tid);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  // rows g and g + 8 of the warp's 16: running max and this lane's share
  // of the running sum
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  const uint32_t* q32 =
      reinterpret_cast<const uint32_t*>(qs) + (warp * 16) * LDW;
  const int tiles = p.n_kv / BK;
  for (int j = 0; j < tiles; ++j) {
    const int s = j & 1;
    if (j + 1 < tiles) {
      const long long r = static_cast<long long>(j + 1) * BK;
      stage_rows<D, THREADS>(ks + (s ^ 1) * BK * LD, LD, kg + r * p.k_n,
                             p.k_n, BK, tid);
      stage_rows<D, THREADS>(vs + (s ^ 1) * BK * LD, LD, vg + r * p.v_n,
                             p.v_n, BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(ks + s * BK * LD);
    const uint16_t* v16 = reinterpret_cast<const uint16_t*>(vs + s * BK * LD);

    // S = Q K^T: 16 rows x 64 kv columns, 8 tiles of 16x8
    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a[0] = q32[g * LDW + kk * 8 + t4];
      a[1] = q32[(g + 8) * LDW + kk * 8 + t4];
      a[2] = q32[g * LDW + kk * 8 + 4 + t4];
      a[3] = q32[(g + 8) * LDW + kk * 8 + 4 + t4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const uint32_t* kr = k32 + (nt * 8 + g) * LDW + kk * 8 + t4;
        mma_bf16(sc[nt], a, kr[0], kr[4]);
      }
    }

    // online softmax; the scale after the product, as the TPU kernel does
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= p.scale;
      tmax[0] = fmaxf(tmax[0], fmaxf(sc[nt][0], sc[nt][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(sc[nt][2], sc[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      alpha[r] = __expf(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
    }
    uint32_t pa[BK / 16][4];  // P, rounded to bf16, as A fragments
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = __expf(sc[nt][0] - m[0]);
      const float p1 = __expf(sc[nt][1] - m[0]);
      const float p2 = __expf(sc[nt][2] - m[1]);
      const float p3 = __expf(sc[nt][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // O += P V: V's B fragments pair rows 2·t4 and 2·t4 + 1 of a column
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint16_t* vr = v16 + (kk * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const uint32_t b0 = vr[t * 8] | (uint32_t(vr[LD + t * 8]) << 16);
        const uint32_t b1 =
            vr[8 * LD + t * 8] | (uint32_t(vr[9 * LD + t * 8]) << 16);
        mma_bf16(o[t], pa[kk], b0, b1);
      }
    }
    __syncthreads();  // the ring buffer is refilled by the next tile
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_b +
                      h * p.o_h + (q0 + warp * 16 + g) * p.o_n + 2 * t4;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<__nv_bfloat162*>(og + t * 8) =
        __floats2bfloat162_rn(o[t][0] * inv[0], o[t][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_n + t * 8) =
        __floats2bfloat162_rn(o[t][2] * inv[1], o[t][3] * inv[1]);
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

  const float inv = 1.f / quad_sum(l);
  float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h +
              (q0 + row) * p.o_n + c4;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) og[4 * i] = o[i] * inv;
}

template <int D>
int launch(int dtype, int B, int H, const Params& p, cudaStream_t st) {
  const dim3 grid(p.n_q / BQ, H, B);
  cudaError_t e;
  if (dtype == 0) {
    if (p.n_kv % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bf16<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_bf16<D><<<grid, THREADS, smem_bf16<D>(), st>>>(p);
  } else if (dtype == 1) {
    if (p.n_kv % F_BK != 0) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(flash_fwd_f32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_f32<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_f32<D><<<grid, F_THREADS, smem_f32<D>(), st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// dtype 0: bf16, 1: fp32 (q, k, v and the output alike). Strides in
// elements: (batch, row, head) of q, k, v and the output; Dh is contiguous.
// Returns a cudaError_t: not 0 if the shape is refused or the launch
// failed.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int n_q, int n_kv, int D, long long q_b, long long q_n,
    long long q_h, long long k_b, long long k_n, long long k_h, long long v_b,
    long long v_n, long long v_h, long long o_b, long long o_n, long long o_h,
    float scale, void* stream) {
  if (B < 1 || H < 1 || n_q < flash::BQ || n_q % flash::BQ != 0 || n_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Params p{q,   k,   v,   o,   n_q, n_kv, q_b, q_n, q_h,
                        k_b, k_n, k_h, v_b, v_n, v_h,  o_b, o_n, o_h, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return flash::launch<64>(dtype, B, H, p, st);
    case 128: return flash::launch<128>(dtype, B, H, p, st);
    case 192: return flash::launch<192>(dtype, B, H, p, st);
    case 256: return flash::launch<256>(dtype, B, H, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
