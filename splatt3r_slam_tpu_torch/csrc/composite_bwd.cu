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
// JAX package does. The kernel writes every row of its tile: the gradient
// of the first counts[t] rows and exact zeros in rows counts[t] .. k_max-1,
// so the wrapper hands it uninitialised memory.
//
// What bounds it. Per live pixel-row pair it does 62 fp32 operations
// (OPS_PER_PAIR_BWD in chip_smoke.py, the exp counted as 2, the nine sums
// over pixels as one add each) against 72 B per live row (read rows, write
// grows) and 32 B per pixel (gout, out): at the cap (768 tiles x 512 rows)
// 6.2e9 operations (~93 us at 67 TFLOP/s) against ~35 MB (~10 us at
// 3.35 TB/s), so it is bound by operations. As in the forward, `power` is
// kept in single multiplies and adds, so the bound, which counts every
// operation at the FMA rate, cannot be approached closer than about 2x.
// chip_smoke.py recomputes the bound from the counts the run measures.
//
// What the design does about it. What held the first version back was the
// sum over the tile's 256 pixels: 45 shuffles, 9 shared loads and 9 shared
// stores per row per warp, all on pipes that take one warp-instruction a
// clock, against arithmetic that takes four, and 36 KB of partial sums in
// shared memory that were zeroed for every chunk. Here a thread owns P = 2
// pixels of one pixel row (the forward's layout, staging ring and one
// evaluation of alpha, composite_common.cuh) and reduces in registers
// before any lane talks to another:
//  - per pixel it adds into nine per-thread sums: the u and v gradients,
//    pg, pg·du, pg·du·du (pg = dL/dpower), dL/dopacity and the three
//    colour gradients; dv is the same for both of a thread's pixels, so the
//    three conic columns are formed from those sums once per thread per
//    row, not per pixel (u and v are not: ca·du and cb·dv can cancel, and
//    the plain version lets them cancel before the sum over pixels);
//  - the nine per-thread columns are summed over the warp by a transposing
//    butterfly: at each of the steps 16, 8, 4, 2 a lane keeps half of its
//    values and hands the other half to its partner, 5 + 3 + 2 + 1
//    shuffles, and one more at step 1: 12 shuffles a row instead of 45, and
//    nine lanes end with one column each;
//  - each of the tile's four warps writes its row to its own slot in shared
//    memory (zeros where it skipped, so nothing is zeroed beforehand) and
//    the slots are added in a fixed order when the chunk is written out.
// Rows are staged element by element into a stride of 12 floats, so that a
// row is two 16-byte loads and one 4-byte load. As in the forward, a warp
// skips a row before any exponential when all of its pixels lie under
// `power_floor`, and again (`__any_sync`) when none of them reaches the
// cut; a skipped row gets exact zeros. A pixel under the cut runs the same
// instructions with alpha = 0 and its gradients selected to 0, so the body
// has no divergent branch. (D - A)/(1 - alpha) uses the fast division:
// 1 - alpha lies in [0.01, 1], it moves gradients by an ulp or two and
// never the cut. Each (tile, row) belongs to one CTA and every sum has a
// fixed order: no global atomics, the same bits from run to run.
//
// What limits it now, by instruction count (cuobjdump -sass): a row that is
// not skipped runs 206 instructions per thread for its two pixels, 103 a
// pair, of which about 50 are the butterfly (12 shuffles, 24 selects, 12
// adds) and about 35 the row's own loads, votes and column sums; a row
// that is skipped runs 37. With 8 pixels a thread a tile would be one
// warp, shared memory would fall to 9-12 KB and the pass across warps would
// go, but 768 tiles are then 768 warps on the card's 528 schedulers and the
// dependent chain of shuffles is not hidden: on an NVIDIA H100 80GB HBM3
// that measured 40% slower than P = 2 at the cap, and 4 pixels a thread 3%
// faster at the cap but 28% slower at the training shape (PERF.md). Also
// measured slower: 1 pixel a thread, no skip, 16-byte staging and a row
// stride of 9.
// ptxas -v (sm_90a): 72 registers, 30,720 bytes of shared memory (12,288
// of rows, 18,432 of per-warp slots), no spills.

#include "composite_common.cuh"

using namespace compositor;

namespace {

constexpr int RS = 12;          // row stride of the ring buffers, in floats
constexpr int NWARP = NT / 32;  // warps a tile
static_assert(NT % 32 == 0 && NWARP > 1,
              "a tile is a whole number of warps, more than one");

// One step of the transposing butterfly over lane bit `mask`: of N values a
// lane keeps ceil(N/2), the low half if its bit is clear and the high half
// (padded with a zero when N is odd) if it is set, and adds its partner's
// copies of them.
template <int N>
__device__ __forceinline__ void butterfly(const float (&in)[N],
                                          float (&out)[(N + 1) / 2],
                                          int lane, int mask) {
  constexpr int H = (N + 1) / 2;
  const bool up = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = in[i];
    const float hi = (i + H < N) ? in[i + H] : 0.f;
    const float got = __shfl_xor_sync(FULL, up ? lo : hi, mask);
    out[i] = (up ? hi : lo) + got;
  }
}

// Sum each of nine per-lane values over the warp, 12 shuffles. Returns the
// sum of column `warp_column(lane)` on the lanes where that is >= 0.
__device__ __forceinline__ float warp_sum9(const float (&v)[ROWF], int lane) {
  float a5[5], a3[3], a2[2], a1[1];
  butterfly<9>(v, a5, lane, 16);
  butterfly<5>(a5, a3, lane, 8);
  butterfly<3>(a3, a2, lane, 4);
  butterfly<2>(a2, a1, lane, 2);
  return a1[0] + __shfl_xor_sync(FULL, a1[0], 1);
}

// The column whose sum `warp_sum9` leaves on this lane, or -1: follows the
// halves the lane kept. Odd lanes hold their even neighbour's sum again and
// padded slots hold nothing, so nine lanes of the warp own a column.
__device__ __forceinline__ int warp_column(int lane) {
  int col = 0, n = ROWF, real = ROWF;
  for (int mask = 16; mask >= 2; mask >>= 1) {
    const int h = (n + 1) / 2;
    if (lane & mask) {
      col += h;
      real -= h;
    } else {
      real = min(real, h);
    }
    n = h;
  }
  return (real >= 1 && !(lane & 1)) ? col : -1;
}

__global__ void __launch_bounds__(NT)
composite_bwd_kernel(const int* __restrict__ counts,
                     const int* __restrict__ origins,
                     const float* __restrict__ rows,
                     const float* __restrict__ gout,
                     const float* __restrict__ out,
                     float* __restrict__ grows,
                     int k_max) {
  __shared__ __align__(16) float sbuf[2][CHUNK * RS];
  __shared__ float part[NWARP][CHUNK * ROWF];  // a slot of reduced rows a warp
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(counts[t], k_max);
  const size_t tile_off = static_cast<size_t>(t) * k_max * ROWF;
  const float* base = rows + tile_off;
  float* gbase = grows + tile_off;
  const int col = warp_column(lane);

  if (n > 0) stage_rows<RS>(sbuf[0], base, min(CHUNK, n), tid);
  // rows at and beyond the tile's count get exact zeros
  for (int i = n * ROWF + tid; i < k_max * ROWF; i += NT) gbase[i] = 0.f;

  float px[P], py;
  pixel_centres(origins, t, tid, px, py);
  float gx[P], gy[P], gz[P], D[P], T[P], A[P];
  {
    const float4* g4 = reinterpret_cast<const float4*>(gout)
        + static_cast<size_t>(t) * NPIX + tid * P;
    const float4* o4 = reinterpret_cast<const float4*>(out)
        + static_cast<size_t>(t) * NPIX + tid * P;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float4 gk = g4[k], ok = o4[k];
      gx[k] = gk.x, gy[k] = gk.y, gz[k] = gk.z;
      D[k] = gk.x * ok.x + gk.y * ok.y + gk.z * ok.z + gk.w * ok.w;
      T[k] = 1.f;  // transmittance in front of the current row
      A[k] = 0.f;  // sum over the rows so far of (g_rgb·c) alpha T
    }
  }

  int buf = 0;
  for (int c0 = 0; c0 < n; c0 += CHUNK, buf ^= 1) {
    // this chunk has landed for every thread, and every thread is done
    // with the other buffer and with the previous chunk's partial sums
    cp_async_wait_all();
    __syncthreads();
    const int next = c0 + CHUNK;
    if (next < n) {
      stage_rows<RS>(sbuf[buf ^ 1], base + static_cast<size_t>(next) * ROWF,
                     min(CHUNK, n - next), tid);
    }
    const float* s = sbuf[buf];
    const int m = min(CHUNK, n - c0);
    for (int j = 0; j < m; ++j) {
      // row j -> registers (a broadcast: every lane reads the same row)
      const float4* q4 = reinterpret_cast<const float4*>(s + j * RS);
      const float4 r0 = q4[0], r1 = q4[1];
      const float row[ROWF] = {r0.x, r0.y, r0.z, r0.w, r1.x,
                               r1.y, r1.z, r1.w, s[j * RS + 8]};
      const float ca = row[2], cb = row[3], cc = row[4];
      const float dv = py - row[1];
      const float cdv2 = row_cdv2(cc, dv);
      // can a pixel of this warp reach the cut?
      const float lowest = power_floor(row[5]);
      float du[P], power[P];
      bool need = false;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        du[k] = px[k] - row[0];
        power[k] = power_of(ca, cb, du[k], dv, cdv2);
        need |= !(power[k] < lowest);
      }
      float* dst = &part[warp][j * ROWF];  // this warp's reduced row
      if (!__any_sync(FULL, need)) {
        if (lane < ROWF) dst[lane] = 0.f;
        continue;
      }
      Alpha a[P];
      bool hit = false;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        a[k] = alpha_of(power[k], row[5]);
        hit |= a[k].hit;
      }
      if (!__any_sync(FULL, hit)) {  // exact zeros from this warp
        if (lane < ROWF) dst[lane] = 0.f;
        continue;
      }
      // per-thread sums over its P pixels; cb·dv and cc·dv are the
      // thread's own
      const float cbdv = cb * dv, ccdv = cc * dv;
      float s_u = 0.f, s_v = 0.f, s_pg = 0.f, s_pgdu = 0.f, s_pgdu2 = 0.f;
      float s_opa = 0.f, s_r = 0.f, s_g = 0.f, s_b = 0.f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float alpha = a[k].alpha;  // 0 where the pixel is not hit
        const float w = alpha * T[k];
        const float gc = gx[k] * row[6] + gy[k] * row[7] + gz[k] * row[8];
        const float one_m = 1.0f - alpha;
        A[k] = fmaf(gc, w, A[k]);
        s_r = fmaf(gx[k], w, s_r);
        s_g = fmaf(gy[k], w, s_g);
        s_b = fmaf(gz[k], w, s_b);
        const float d_alpha = gc * T[k] - __fdividef(D[k] - A[k], one_m);
        // alpha == raw: the clamp and the cut pass the gradient
        const bool active = a[k].hit && a[k].raw < ALPHA_MAX;
        const float pg = active ? d_alpha * alpha : 0.f;
        const float pgdu = pg * du[k];
        // u and v: per pixel, as the plain version, because ca·du and
        // cb·dv can cancel and must do so before the sum over pixels
        s_u = fmaf(pg, fmaf(ca, du[k], cbdv), s_u);
        s_v = fmaf(pg, fmaf(cb, du[k], ccdv), s_v);
        s_pg += pg;
        s_pgdu += pgdu;
        s_pgdu2 = fmaf(pgdu, du[k], s_pgdu2);
        s_opa += active ? d_alpha * a[k].e : 0.f;
        T[k] *= one_m;
      }
      const float v[ROWF] = {s_u,
                             s_v,
                             -0.5f * s_pgdu2,
                             -(s_pgdu * dv),
                             -0.5f * (s_pg * dv * dv),
                             s_opa,
                             s_r,
                             s_g,
                             s_b};
      const float sum = warp_sum9(v, lane);
      if (col >= 0) dst[col] = sum;
    }
    __syncthreads();
    for (int i = tid; i < m * ROWF; i += NT) {
      float acc = part[0][i];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) acc += part[w][i];
      gbase[static_cast<size_t>(c0) * ROWF + i] = acc;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() so the caller can raise on a refused launch. Any k_max
// and any base pointer are taken: the staging is element-wise.
extern "C" int composite_bwd_launch(const int* counts, const int* origins,
                                    const float* rows, const float* gout,
                                    const float* out, float* grows,
                                    int num_tiles, int k_max, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, NT, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        counts, origins, rows, gout, out, grows, k_max);
  }
  return static_cast<int>(cudaGetLastError());
}
