// Per-tile front-to-back alpha compositing of depth-sorted Gaussian splats
// (forward), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_composite_kernel` of
// splatt3r_slam_tpu/splat/pallas_rasterizer.py (called through
// `_composite_fwd_call` / `render_tiles_pallas`). Same function: for each
// 16x16 tile t, walk its first counts[t] (<= k_max) depth-ordered rows
//   row = [u, v, conic_a, conic_b, conic_c, opacity, r, g, b]
// and for each pixel centre p and row i
//   power = -0.5 (a du^2 + c dv^2) - b du dv,   du = p.x - u, dv = p.y - v
//   alpha = min(0.99, opacity * exp(power)), zeroed below 1/255
//   rgb  += alpha * T * colour;   T *= (1 - alpha)
// out[t*256 + p] = [rgb + T * bg, T].  No `power > 0` skip and no early
// exit: the clamps are the JAX kernel's, and T_final is an output.
//
// What bounds it. Per render the work is sum(counts) * 256 pixel-row
// pairs, each 25 fp32 operations counting the exp as 2 (OPS_PER_PAIR in
// chip_smoke.py); the bytes are the rows (36 B each, sum(counts) of them)
// plus 16 B of output per pixel. At the cap (768 tiles * 512 rows) that is
// 1.0e8 pairs, ~2.5e9 fp32 operations (~38 us at 67 TFLOP/s) against
// ~14 MB of rows and 3 MB of output (~5 us at 3.35 TB/s): bound by
// operations. The bound counts every operation at the FMA rate (two a lane
// a clock); `power` is kept in single multiplies and adds (see
// composite_common.cuh) and the exponential is a handful of instructions,
// so a pair runs about as many instructions as the bound counts
// operations and the kernel cannot come closer to it than about 2x.
// chip_smoke.py recomputes the bound from the counts the run measures.
//
// What the design does about it. One CTA per tile; a thread owns P = 2
// pixels of one pixel row, reads a row from shared memory once into
// registers and uses it for both, and computes what depends only on the
// pixel row (dv, (cc*dv)*dv) once. Rows are staged through a two-buffer
// ring with cp.async, chunk c+1 in flight while chunk c is consumed, one
// __syncthreads() a chunk (composite_common.cuh): in 16-byte pieces where
// every tile's rows are 16-byte aligned (k_max % 4 == 0), element by
// element for any other input, into the same layout. A thread takes ROWS =
// 4 rows at a time through their loads and `power`, which do not depend on
// one another, and a warp skips a row, before any exponential, when every
// one of its pixels lies under a floor that leaves alpha under the 1/255
// cut for certain (`power_floor`). The rows that are left are composited in
// order; each pixel takes its alpha from `alpha_of`, and a pixel under the
// cut composites with alpha = 0, which leaves its sums and its
// transmittance bit for bit as they were, so the body has no divergent
// branch. The TPU kernel's log-cumsum-by-triangular-matmul (a workaround
// for Mosaic's missing cumsum) is gone: each pixel's transmittance is a
// sequential carry. The loop runs ceil(count / CHUNK) chunks, so sparse
// tiles finish early, as on the TPU.
//
// What limits it now, by instruction count (cuobjdump -sass): a step of
// four rows runs 272 instructions per thread for its eight pixel-row
// pairs, 34 a pair: 14 before the skip (the row's loads, du, dv, `power`,
// the floor, the test and the vote) and 20 after it (8 for expf, 12 for
// alpha, the weight, the three sums and the transmittance). At four
// warp-instructions a clock on each of 132 SMs the cap's 1.0e8 pairs need
// 0.10-0.12 ms at 1.98-1.75 GHz if no row is skipped; the kernel is at that
// limit, and what it gains on it is the rows it skips. Measured slower on
// an NVIDIA H100 80GB HBM3 (PERF.md): 1, 4 and 8 pixels a thread, one row a
// step, no skip, and rows padded to 12 floats in shared memory.
// ptxas -v (sm_90a): 48 registers and 9,216 bytes of shared memory with
// either staging; no spills.

#include "composite_common.cuh"

#include <cstdint>

using namespace compositor;

namespace {

constexpr int ROWS = 4;  // rows a thread takes through `power` together

// Composite rows j .. j+R-1 of a ring buffer onto a thread's P pixels. The
// loads, the powers and the skip votes of the R rows do not depend on one
// another and overlap; the rows that are needed are then composited in
// order, each pixel's transmittance carried from one to the next.
template <int R>
__device__ __forceinline__ void rows_step(const float* s, int j,
                                          const float (&px)[P], float py,
                                          float (&r)[P], float (&g)[P],
                                          float (&b)[P], float (&T)[P]) {
  float row[R][ROWF], power[R][P];
  bool need[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int f = 0; f < ROWF; ++f) row[q][f] = s[(j + q) * ROWF + f];
    const float dv = py - row[q][1];
    const float cdv2 = row_cdv2(row[q][4], dv);
    // can a pixel of this warp reach the cut?
    const float lowest = power_floor(row[q][5]);
    bool mine = false;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      power[q][k] = power_of(row[q][2], row[q][3], px[k] - row[q][0], dv,
                             cdv2);
      mine |= !(power[q][k] < lowest);
    }
    need[q] = __any_sync(FULL, mine);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (!need[q]) continue;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float alpha = alpha_of(power[q][k], row[q][5]).alpha;
      const float w = alpha * T[k];
      r[k] = fmaf(w, row[q][6], r[k]);
      g[k] = fmaf(w, row[q][7], g[k]);
      b[k] = fmaf(w, row[q][8], b[k]);
      T[k] *= (1.0f - alpha);
    }
  }
}

// VEC: stage in 16-byte pieces (the launcher has checked the alignment).
template <bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* src, int m,
                                      int tid) {
  if constexpr (VEC) {
    stage_rows_16(dst, src, m, tid);
  } else {
    stage_rows<ROWF>(dst, src, m, tid);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
composite_kernel(const int* __restrict__ counts,
                 const int* __restrict__ origins,
                 const float* __restrict__ rows,
                 const float* __restrict__ bg,
                 float* __restrict__ out,
                 int k_max) {
  __shared__ __align__(16) float sbuf[2][CHUNK * ROWF];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(counts[t], k_max);
  const float* base = rows + static_cast<size_t>(t) * k_max * ROWF;
  float px[P], py;
  pixel_centres(origins, t, tid, px, py);

  float r[P], g[P], b[P], T[P];
#pragma unroll
  for (int k = 0; k < P; ++k) r[k] = g[k] = b[k] = 0.f, T[k] = 1.f;

  if (n > 0) stage<VEC>(sbuf[0], base, min(CHUNK, n), tid);
  int buf = 0;
  for (int c0 = 0; c0 < n; c0 += CHUNK, buf ^= 1) {
    // this chunk has landed for every thread, and every thread is done
    // with the other buffer, which the next chunk now overwrites
    cp_async_wait_all();
    __syncthreads();
    const int next = c0 + CHUNK;
    if (next < n) {
      stage<VEC>(sbuf[buf ^ 1], base + static_cast<size_t>(next) * ROWF,
                 min(CHUNK, n - next), tid);
    }
    const float* s = sbuf[buf];
    const int m = min(CHUNK, n - c0);
    int j = 0;
    for (; j + ROWS <= m; j += ROWS) rows_step<ROWS>(s, j, px, py, r, g, b, T);
    for (; j < m; ++j) rows_step<1>(s, j, px, py, r, g, b, T);
  }
  const float b0 = bg[0], b1 = bg[1], b2 = bg[2];
  float4* o = reinterpret_cast<float4*>(out)
      + static_cast<size_t>(t) * NPIX + tid * P;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    o[k] = make_float4(r[k] + T[k] * b0, g[k] + T[k] * b1, b[k] + T[k] * b2,
                       T[k]);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() so the caller can raise on a refused launch. Rows that
// are 16-byte aligned tile by tile take the 16-byte staging, any other
// k_max or base pointer the element-wise staging of the same kernel.
extern "C" int composite_launch(const int* counts, const int* origins,
                                const float* rows, const float* bg,
                                float* out, int num_tiles, int k_max,
                                void* stream) {
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k_max % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0) {
      composite_kernel<true><<<num_tiles, NT, 0, st>>>(
          counts, origins, rows, bg, out, k_max);
    } else {
      composite_kernel<false><<<num_tiles, NT, 0, st>>>(
          counts, origins, rows, bg, out, k_max);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
