// What the forward tile compositor (composite.cu) and its backward
// (composite_bwd.cu) share: the tile geometry, the pixels a thread owns,
// the asynchronous two-stage staging of a tile's rows into shared memory,
// and the one evaluation of power -> alpha. Both kernels take their alpha
// from `alpha_of(power_of(...))`, so the backward's `active` mask falls
// where the forward's 1/255 cut fell by construction, not by two copies of
// the same expression staying in step.
//
// Thread layout. One CTA per 16x16 tile, NPIX / P threads, and thread `tid`
// owns the P = 2 neighbouring pixels tid*P, tid*P+1 of one pixel row. A row
// [u v conic_a conic_b conic_c opacity r g b] is read from shared memory
// once into registers and used for both pixels, and what depends only on
// the pixel row (dv, (cc*dv)*dv) is computed once: same operands, same bits.
// P = 2 measured fastest for both kernels on an NVIDIA H100 80GB HBM3
// (PERF.md): the cap has only 768 tiles, so at 8 pixels a thread they are
// 768 warps on the card's 528 schedulers, and at 4 the training shape (384
// tiles) has the same problem.
//
// Staging. A tile's rows are contiguous in device memory, 36 bytes each,
// and are consumed in chunks of CHUNK rows through a ring of two buffers:
// chunk c+1 is in flight (cp.async) while chunk c is consumed, with one
// __syncthreads() a chunk. Two ways to fill a buffer:
//   stage_rows_16: 16-byte cp.async of the chunk as it lies in memory (row
//         stride 9 floats in shared memory too). Needs the tile's rows
//         16-byte aligned (k_max % 4 == 0 and an aligned base pointer). A
//         partial last piece reads at most 12 bytes past the live rows and
//         never past the tile's own k_max rows.
//   stage_rows: 4-byte cp.async, for any k_max, into a row stride of RS
//         floats.
// Staging is about 1% of the instructions either way; what the stride
// decides is the shared-memory loads per row. The forward, which takes four
// rows at a time and so has their loads in flight together, measured
// fastest with the memory layout (stride 9, nine 4-byte loads a row, 16-byte
// staging where the alignment allows it); the backward, one row at a time,
// with rows padded to 12 floats (two 16-byte loads and one 4-byte load a
// row), which only the element-wise staging can fill (PERF.md).
//
// Tensor cores are not used: the quadratic form is a matrix product in
// shape, but TF32 or bf16 would move `power` by far more than the one ulp
// that is enough to move alpha across the 1/255 cut. For the same reason
// there is no -use_fast_math, no fast exponential and no FMA contraction of
// `power`: every product and sum of it is rounded on its own (_rn
// intrinsics are never contracted), in the order of the plain PyTorch
// version and of the TPU kernel.

#pragma once

#include <cuda_runtime.h>

namespace compositor {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int P = 2;          // pixels a thread owns, in one pixel row
constexpr int NT = NPIX / P;  // threads a tile
static_assert(TILE % P == 0, "a thread's pixels lie in one pixel row");
constexpr int CHUNK = 128;
constexpr int ROWF = 9;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_CUT = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of rows src[0 .. m) into one ring buffer, element by
// element into a row stride of RS floats.
template <int RS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int m, int tid) {
  for (int i = tid; i < m * ROWF; i += NT) {
    cp_async_4(dst + (i / ROWF) * RS + (i % ROWF), src + i);
  }
  cp_async_commit();
}

// The same in 16-byte pieces, as the rows lie in memory (row stride ROWF);
// `src` must be 16-byte aligned.
__device__ __forceinline__ void stage_rows_16(float* dst, const float* src,
                                              int m, int tid) {
  const int pieces = (m * ROWF + 3) >> 2;
  for (int i = tid; i < pieces; i += NT) {
    cp_async_16(dst + 4 * i, src + 4 * i);
  }
  cp_async_commit();
}

// power = -0.5 (a du du + c dv dv) - b du dv, left to right, each product
// and sum rounded on its own; cdv2 = (c dv) dv is shared by a thread's
// pixels. With a contracted FMA the power differs by an ulp, and where that
// moves alpha across the 1/255 cut the pixel changes by up to 1/255 times
// its transmittance.
__device__ __forceinline__ float row_cdv2(float cc, float dv) {
  return __fmul_rn(__fmul_rn(cc, dv), dv);
}

__device__ __forceinline__ float power_of(float ca, float cb, float du,
                                          float dv, float cdv2) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, du), du), cdv2);
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cb, du), dv));
}

// A power under this floor leaves opacity * exp(power) under the 1/255 cut
// for certain: ln(1/255) = -5.5413, less the opacity's logarithm, less a
// margin of 0.02 that is a thousand times the error of the approximate
// logarithm and of expf. It only lets a warp skip a row that none of its
// pixels can reach before it pays for the exponentials; every pixel that is
// not skipped takes its alpha from `alpha_of`, so the cut itself never
// moves. The floor is capped at 0, so a row is never skipped at a power
// >= 0, and a zero, denormal or negative opacity (alpha under the cut
// whatever the power) gives the cap.
__device__ __forceinline__ float power_floor(float opacity) {
  float lg2;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg2) : "f"(opacity));
  return fminf(0.0f, fmaf(lg2, -0.69314718f, -5.5613f));
}

struct Alpha {
  float e;      // exp(power)
  float raw;    // opacity * e
  float alpha;  // min(0.99, raw), and 0 below the 1/255 cut
  bool hit;     // the pixel is touched: min(0.99, raw) >= 1/255
};

__device__ __forceinline__ Alpha alpha_of(float power, float opacity) {
  Alpha a;
  a.e = expf(power);
  a.raw = __fmul_rn(opacity, a.e);
  const float clamped = fminf(ALPHA_MAX, a.raw);
  a.hit = !(clamped < ALPHA_CUT);
  a.alpha = a.hit ? clamped : 0.0f;
  return a;
}

// Centre of a thread's first pixel row and pixels: py, px[0 .. P).
__device__ __forceinline__ void pixel_centres(const int* origins, int t,
                                              int tid, float (&px)[P],
                                              float& py) {
  const int p0 = tid * P;
  const int x0 = origins[2 * t] + (p0 % TILE);
  py = static_cast<float>(origins[2 * t + 1] + (p0 / TILE)) + 0.5f;
#pragma unroll
  for (int k = 0; k < P; ++k) px[k] = static_cast<float>(x0 + k) + 0.5f;
}

}  // namespace compositor
