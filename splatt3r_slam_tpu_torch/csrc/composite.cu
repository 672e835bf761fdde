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
// ~14 MB of rows and 3 MB of output (~5 us at 3.35 TB/s): compute-bound.
// chip_smoke.py recomputes the bound from the counts the run measures.
//
// What the design does about it. One CTA per tile, one thread per pixel
// (256 threads). Rows are staged through shared memory in chunks of 128,
// loaded cooperatively and coalesced (a chunk is 1152 contiguous floats)
// and stored structure-of-arrays so each broadcast read is one bank. Each
// thread keeps its transmittance as a sequential carry, so the TPU
// kernel's log-cumsum-by-triangular-matmul (a workaround for Mosaic's
// missing cumsum) is gone: per pair there is one exp and a handful of
// FMAs, nothing else. The loop runs ceil(count / CHUNK) chunks, so sparse
// tiles finish early, as on the TPU. The power is computed without FMA
// contraction so that alpha's 1/255 cut falls where the plain version's
// does; only the colour and transmittance sums are taken in another order.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int ROWF = 9;

__global__ void __launch_bounds__(NPIX)
composite_kernel(const int* __restrict__ counts,
                 const int* __restrict__ origins,
                 const float* __restrict__ rows,
                 const float* __restrict__ bg,
                 float* __restrict__ out,
                 int k_max) {
  __shared__ float s[ROWF][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n = counts[t];
  const float px = static_cast<float>(origins[2 * t] + (p % TILE)) + 0.5f;
  const float py = static_cast<float>(origins[2 * t + 1] + (p / TILE)) + 0.5f;
  const float* base = rows + static_cast<size_t>(t) * k_max * ROWF;

  float r = 0.f, g = 0.f, b = 0.f, T = 1.f;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = p; i < m * ROWF; i += NPIX) {
      s[i % ROWF][i / ROWF] = base[static_cast<size_t>(c0) * ROWF + i];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float du = px - s[0][j];
      const float dv = py - s[1][j];
      // -0.5 (a du du + c dv dv) - b du dv, left to right with every
      // product and sum rounded on its own (the _rn intrinsics are never
      // contracted into FMAs), as the plain version and the TPU kernel
      // evaluate it. With a contracted FMA the power differs by an ulp,
      // and where that moves alpha across the 1/255 cut the pixel changes
      // by up to 1/255 times its transmittance.
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(s[2][j], du), du),
                                __fmul_rn(__fmul_rn(s[4][j], dv), dv));
      const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                    __fmul_rn(__fmul_rn(s[3][j], du), dv));
      float alpha = fminf(0.99f, s[5][j] * expf(power));
      if (alpha < (1.0f / 255.0f)) continue;
      const float w = alpha * T;
      r = fmaf(w, s[6][j], r);
      g = fmaf(w, s[7][j], g);
      b = fmaf(w, s[8][j], b);
      T *= (1.0f - alpha);
    }
  }
  float* o = out + (static_cast<size_t>(t) * NPIX + p) * 4;
  o[0] = r + T * bg[0];
  o[1] = g + T * bg[1];
  o[2] = b + T * bg[2];
  o[3] = T;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int composite_launch(const int* counts, const int* origins,
                                const float* rows, const float* bg,
                                float* out, int num_tiles, int k_max,
                                void* stream) {
  if (num_tiles > 0) {
    composite_kernel<<<num_tiles, NPIX, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        counts, origins, rows, bg, out, k_max);
  }
  return static_cast<int>(cudaGetLastError());
}
