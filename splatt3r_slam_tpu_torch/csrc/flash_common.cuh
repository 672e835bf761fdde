// Device and host helpers shared by the flash-attention sources
// (flash_attention.cu, flash_attention_bwd.cu), each included once per
// library: bf16 packing, the mbarrier, TMA, thread-block cluster and wgmma
// primitives of Hopper (sm_90a), the split-TF32 (3xTF32) pieces of the
// fp32 kernels, and the host-side TMA tensor map of a tensor in the JAX
// layout.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (declarations only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled, as declared here
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The least head dim of the wide kernels (every multiple of 128 from it up;
// the template instances take 64, 128 and 256). A build with
// -DFLASH_WIDE_FROM=128 runs the wide kernels at 128 and 256 too, in place
// of the instances, to time the two there (chip_smoke.py --wide-from-128).
#ifndef FLASH_WIDE_FROM
#define FLASH_WIDE_FROM 384
#endif

namespace flash_common {

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

// ---- thread-block clusters ----
// This block's rank in its cluster and the cluster's block count.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The cluster barrier, every thread of every block: after the wait, this
// thread's writes to shared memory before its arrival are seen by every
// read in the cluster. Work between the two is not ordered by it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The address in distributed shared memory of the shared-memory address
// `addr` (this block's layout) of the cluster's block `rank`; an offset
// added to it steps through that block's shared memory.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// 8, 16 or 4 bytes from, and 16, 8 or 4 bytes to, a `cluster_map` address
// (stores are seen there after the next cluster barrier).
__device__ __forceinline__ float2 ld_dsmem(uint32_t remote) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_dsmem4(uint32_t remote) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_dsmem_f(uint32_t remote) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void st_dsmem(uint32_t remote, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(remote), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_dsmem(uint32_t remote, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n"
               :: "r"(remote), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ void st_dsmem(uint32_t remote, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(remote), "f"(v) : "memory");
}

// 8 or 4 bytes at the shared-memory address `addr` (this block's layout) of
// the cluster's block `rank`.
__device__ __forceinline__ float2 ld_cluster(uint32_t addr, uint32_t rank) {
  return ld_dsmem(cluster_map(addr, rank));
}

__device__ __forceinline__ float ld_cluster_f(uint32_t addr, uint32_t rank) {
  return ld_dsmem_f(cluster_map(addr, rank));
}

// The wide kernels' slices and clusters (Dh a multiple of 128 from 384 up,
// both sources): Dh is cut into n = Dh / WC slices of 128 columns; the
// blocks of one 64-row tile form a cluster along Dh, one slice a block, of
// cs = n blocks up to the portable limit of 8, and above it `rounds` =
// ceil(n / 8) passes of clusters of cs = ceil(n / rounds) blocks.
constexpr int WC = 128;      // columns a slice
constexpr int WCLUSTER = 8;  // the portable cluster limit

struct WidePlan {
  int n, rounds, cs;
};

__host__ __device__ inline WidePlan wide_plan(int D) {
  const int n = D / WC, rounds = (n + WCLUSTER - 1) / WCLUSTER;
  return {n, rounds, (n + rounds - 1) / rounds};
}

// A wide kernel's launch over `tiles` 64-row tiles of B x H heads at head
// dim D: a cluster of cs blocks along Dh for each tile and pass (the
// cluster attribute in `at`), `threads` a block, `smem` bytes of shared
// memory, on stream `st`; for cudaLaunchKernelEx and
// cudaOccupancyMaxActiveClusters.
inline void wide_launch_config(cudaLaunchConfig_t& cfg,
                               cudaLaunchAttribute& at, int tiles, int B,
                               int H, int D, int threads, int smem,
                               cudaStream_t st) {
  const WidePlan w = wide_plan(D);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(tiles * w.rounds * w.cs, H, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = w.cs;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
}

// The named barrier `id` of `count` threads (ids 1 up; 0 is
// __syncthreads's).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
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
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The same for A fragments written by ordinary instructions: they are
// complete before the wgmma.fence that follows.
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r]) :: "memory");
}

#define FLASH_ACC32(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define FLASH_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, fp32) = a b^T (+ d if `accumulate`): a (64 x 16) and b
// (64 x 16) both K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32
      ", %32, %33, acc, 1, 1, 0, 0;\n}\n"
      : FLASH_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += a b: a (64 x 16, bf16) from registers, b (16 x 64)
// MN-major in shared memory (the streamed tile's rows as they lie).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32
      ", {%32, %33, %34, %35}, %36, acc, 1, 1, 1;\n}\n"
      : FLASH_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- split TF32 (3xTF32) ----
// An fp32 value x is hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest, ties away from zero (cvt.rna.tf32.f32's rounding), so
// that their low 13 bits are 0 and no product depends on how the tensor
// cores read the bits below TF32's; a b is then hi hi' + hi lo' + lo hi'
// summed in fp32, each product exact, the dropped lo lo' and the roundings
// within about 2^-20 of |a b|. The rounding is two integer operations on
// the bits (half of TF32's last place added to the magnitude, the low 13
// bits cleared): cvt.rna.tf32.f32 compiles to several more on sm_90a, and
// the operands are finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Order this thread's ordinary writes to shared memory before later reads
// of it by the async proxy (wgmma's descriptors, TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// hi in place and lo at `lo` (the same layout) of N bytes of fp32 values
// in shared memory, by the 128 threads of a warpgroup; N a multiple of
// 16 x 128
template <int N>
__device__ __forceinline__ void split_pass(unsigned char* hi,
                                           unsigned char* lo, int tid) {
  float4* hv = reinterpret_cast<float4*>(hi);
  float4* lv = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int r = 0; r < N / 16 / 128; ++r) {
    const int i = tid + r * 128;
    const float4 v = hv[i];
    uint32_t hx, lx, hy, ly, hz, lz, hw, lw;
    split_tf32(v.x, hx, lx);
    split_tf32(v.y, hy, ly);
    split_tf32(v.z, hz, lz);
    split_tf32(v.w, hw, lw);
    hv[i] = make_float4(__uint_as_float(hx), __uint_as_float(hy),
                        __uint_as_float(hz), __uint_as_float(hw));
    lv[i] = make_float4(__uint_as_float(lx), __uint_as_float(ly),
                        __uint_as_float(lz), __uint_as_float(lw));
  }
}

#define FLASH_ACC8(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7])

#define FLASH_ACC16(d)                                                   \
  FLASH_ACC8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x N, fp32) = a b^T (+ d if `accumulate`), tf32 in: a (64 x 8) from
// registers (a warp's rows 16 warp + g and + 8, columns c and c + 4, in
// that order: g = lane / 4, c = lane % 4), b (N x 8) K-major in shared
// memory (wgmma takes no transposed tf32 operand). N is 16, 32, 64 or 128.
template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void mma_tf32<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, acc, 1, "
      "1;\n}\n"
      : FLASH_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_tf32<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, acc, 1, 1;\n}\n"
      : FLASH_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_tf32<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FLASH_D32
      ", {%32, %33, %34, %35}, %36, acc, 1, 1;\n}\n"
      : FLASH_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#define FLASH_ACC64(d)                                                   \
  FLASH_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define FLASH_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// The descriptor of an MN-major operand 128 wide that lies in two 64-wide
// 128-byte-swizzled boxes `lbo` bytes apart (each as `desc` reads one): the
// leading byte offset steps from one 64-wide half to the other, the stride
// byte offset (1024) from one group of 8 rows of the contraction to the next.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, fp32) += a b: a (64 x 16, bf16) from registers, b (16 x 128)
// MN-major in shared memory by `desc_mn` (the streamed tile's rows as they
// lie).
__device__ __forceinline__ void mma_rs128(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLASH_D64
      ", {%64, %65, %66, %67}, %68, acc, 1, 1, 1;\n}\n"
      : FLASH_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, acc, 1, "
      "1;\n}\n"
      : FLASH_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x N, fp32) = a b^T (+ d if `accumulate`), tf32 in: a (64 x 8)
// and b (N x 8) both K-major in shared memory; N = 2 R, 32 or 64.
template <int R>
__device__ __forceinline__ void mma_tf32_ss(float (&d)[R], uint64_t a,
                                            uint64_t b, int accumulate) {
  static_assert(R == 16 || R == 32, "N is 32 or 64");
  if constexpr (R == 16) {
    asm volatile(
        "{\n.reg .pred acc;\nsetp.ne.b32 acc, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, acc, 1, 1;\n}\n"
        : FLASH_ACC16(d)
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred acc;\nsetp.ne.b32 acc, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FLASH_D32
        ", %32, %33, acc, 1, 1;\n}\n"
        : FLASH_ACC32(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (16 x 8, fp32) += a (16 x 8) b (8 x 8), tf32 in, one warp (mma.sync):
// a (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4); b (c, g), (c + 4, g);
// d (g, 2 c), (g, 2 c + 1), (g + 8, 2 c), (g + 8, 2 c + 1).
__device__ __forceinline__ void mma_tf32_m16n8(float* d, const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The TMA map of one tensor in the JAX layout, as a 4-d (Dh, N, H, B)
// tensor with the given strides (elements), 128-byte swizzle and boxes of
// 128 bytes of columns (64 bf16 or 32 fp32, by `esize`) x `rows` rows. A
// dimension of size 1 is never stepped: it takes the row stride.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int D, int N,
                       int H, int B, long long s_n, long long s_h,
                       long long s_b, int esize = 2, int rows = 64) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(s_n) * esize,
      static_cast<cuuint64_t>(H > 1 ? s_h : s_n) * esize,
      static_cast<cuuint64_t>(B > 1 ? s_b : s_n) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(rows), 1, 1},
                   step[4] = {1, 1, 1, 1};
  return encode(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash_common
