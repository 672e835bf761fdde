// Backward of the per-tile front-to-back alpha compositor (composite.cu),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_composite_bwd_kernel` of
// splatt3r_slam_tpu/splat/pallas_rasterizer.py (called through
// `_composite_bwd_call` from the custom VJP of `_composite`). Same function:
// given the forward's inputs, its saved output out = [rgb + T·bg, T_final]
// and the output cotangent gout, both (T·256, 4), it returns grows with the
// layout of rows, (T·k_max, 9):
//   d[u, v, conic_a, conic_b, conic_c, opacity, r, g, b]
// summed over the tile's 256 pixels. Per pixel, front to back over the
// tile's first counts[t] rows, with D = gout·out (which folds the background
// and the final-transmittance terms) and the carries
//   T_i = prod_{j<i} (1 - alpha_j),   A_i = sum_{j<=i} (g_rgb·c_j) alpha_j T_j:
//   dL/dalpha_i = (g_rgb·c_i) T_i - (D - A_i) / (1 - alpha_i)
//   dL/dc_i     = g_rgb alpha_i T_i
// and the chain through alpha = min(0.99, opacity·exp(power)) is taken only
// where 1/255 <= opacity·exp(power) < 0.99 (elsewhere alpha is constant):
//   dL/dpower = dL/dalpha · alpha,  dL/dopacity = dL/dalpha · exp(power),
//   power = -0.5 (a du^2 + c dv^2) - b du dv,  du = px - u,  dv = py - v.
// d_bg is taken outside the kernel (cuda_rasterizer.py::Composite), as the
// JAX package does. Rows at and beyond counts[t] are not written: the
// wrapper hands in a zeroed grows.
//
// What bounds it. Per live pixel-row pair it does 62 fp32 operations
// (OPS_PER_PAIR_BWD in chip_smoke.py, the exp counted as 2, the nine sums
// over pixels as one add each) against 72 B per live row (read rows, write
// grows) and 32 B per pixel (gout, out): at the cap (768 tiles x 512 rows)
// 6.2e9 operations (~93 us at 67 TFLOP/s) against ~35 MB (~10 us at
// 3.35 TB/s), so it is bound by operations. chip_smoke.py recomputes the
// bound from the counts the run measures.
//
// What the design does about it. The forward's shape: one CTA per tile,
// one thread per pixel, rows staged through shared memory in chunks of 128
// (structure-of-arrays, broadcast reads). Each thread carries T and A
// front to back in registers, so the TPU kernel's triangular matmuls (its
// stand-in for a cumulative sum), its transposed (16, T·k_max) layout and
// its (tile, chunk) grid with carries in scratch memory are all gone. The
// power is evaluated with the forward's uncontracted multiply/add sequence,
// so alpha's 1/255 cut falls exactly where the forward's fell and no row
// gets gradient for a pixel it never touched. The nine per-row partials are
// summed over a warp's 32 pixels by shuffles, written to that warp's own
// slot in shared memory, and the 8 warps' slots are added in a fixed order
// when the chunk is written out. Each (tile, row) belongs to one CTA, so
// there are no global atomics and the result is deterministic. A row that
// no pixel of a warp reaches (alpha under the cut for all 32) contributes
// exact zeros and the warp skips its reduction.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NWARP = NPIX / 32;
constexpr int CHUNK = 128;
constexpr int ROWF = 9;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(NPIX)
composite_bwd_kernel(const int* __restrict__ counts,
                     const int* __restrict__ origins,
                     const float* __restrict__ rows,
                     const float* __restrict__ gout,
                     const float* __restrict__ out,
                     float* __restrict__ grows,
                     int k_max) {
  __shared__ float s[ROWF][CHUNK];
  __shared__ float part[NWARP][ROWF][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n = counts[t];
  const float px = static_cast<float>(origins[2 * t] + (p % TILE)) + 0.5f;
  const float py = static_cast<float>(origins[2 * t + 1] + (p / TILE)) + 0.5f;
  const size_t tile_off = static_cast<size_t>(t) * k_max * ROWF;
  const float* base = rows + tile_off;
  float* gbase = grows + tile_off;

  const float4 g4 =
      reinterpret_cast<const float4*>(gout)[static_cast<size_t>(t) * NPIX + p];
  const float4 o4 =
      reinterpret_cast<const float4*>(out)[static_cast<size_t>(t) * NPIX + p];
  const float D = g4.x * o4.x + g4.y * o4.y + g4.z * o4.z + g4.w * o4.w;

  float T = 1.f;  // transmittance in front of the current row
  float A = 0.f;  // sum over the rows so far of (g_rgb·c) alpha T
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    __syncthreads();  // previous chunk's rows and partials fully consumed
    for (int i = p; i < m * ROWF; i += NPIX) {
      s[i % ROWF][i / ROWF] = base[static_cast<size_t>(c0) * ROWF + i];
    }
    float* pz = &part[0][0][0];
    for (int i = p; i < NWARP * ROWF * CHUNK; i += NPIX) pz[i] = 0.f;
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float ca = s[2][j], cb = s[3][j], cc = s[4][j];
      const float du = px - s[0][j];
      const float dv = py - s[1][j];
      // the forward's sequence, product by product (see composite.cu)
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, du), du),
                                __fmul_rn(__fmul_rn(cc, dv), dv));
      const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                    __fmul_rn(__fmul_rn(cb, du), dv));
      const float e = expf(power);
      const float raw = s[5][j] * e;
      const float alpha = fminf(0.99f, raw);
      const bool hit = !(alpha < (1.0f / 255.0f));
      if (!__any_sync(FULL, hit)) continue;  // exact zeros from this warp
      float v[ROWF];
#pragma unroll
      for (int f = 0; f < ROWF; ++f) v[f] = 0.f;
      if (hit) {
        const float w = alpha * T;
        const float gc = g4.x * s[6][j] + g4.y * s[7][j] + g4.z * s[8][j];
        const float one_m = 1.0f - alpha;
        A = fmaf(gc, w, A);
        v[6] = g4.x * w;
        v[7] = g4.y * w;
        v[8] = g4.z * w;
        if (raw < 0.99f) {  // alpha == raw: the clamp passes the gradient
          const float d_alpha = gc * T - (D - A) / one_m;
          const float pg = d_alpha * alpha;
          v[0] = pg * (ca * du + cb * dv);
          v[1] = pg * (cc * dv + cb * du);
          v[2] = pg * (-0.5f * du * du);
          v[3] = pg * (-du * dv);
          v[4] = pg * (-0.5f * dv * dv);
          v[5] = d_alpha * e;
        }
        T *= one_m;
      }
#pragma unroll
      for (int f = 0; f < ROWF; ++f) {
        const float r = warp_sum(v[f]);
        if (lane == 0) part[warp][f][j] = r;
      }
    }
    __syncthreads();
    for (int i = p; i < m * ROWF; i += NPIX) {
      const int f = i % ROWF, j = i / ROWF;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) acc += part[w][f][j];
      gbase[static_cast<size_t>(c0) * ROWF + i] = acc;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int composite_bwd_launch(const int* counts, const int* origins,
                                    const float* rows, const float* gout,
                                    const float* out, float* grows,
                                    int num_tiles, int k_max, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, NPIX, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        counts, origins, rows, gout, out, grows, k_max);
  }
  return static_cast<int>(cudaGetLastError());
}
