// What the BDC pool's kernels share (bdc_pool.cu, the forward, and
// bdc_pool_backward.cu, its gradient), sm_90a: the phase clocks of the
// profiling build, the TMA and mbarrier primitives, 4-byte cp.async, the
// split-TF32 mma, and the tensor-map encoder of the libcuda the process has
// loaded.  ops/build.py hashes this header with the sources beside it, so an
// edit here rebuilds both libraries.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

// -- phase clocks, compiled in only for profile_bdc_pool.py ------------------
// With -DBDC_POOL_PROFILE every warp of the first kProfiledBlocks blocks adds
// up the SM cycles it spends in each phase of a kernel, and every block
// records its SM; the card has no other profiler for the inside of a kernel.
// A source declares its phases with PHASE_CLOCKS(n) and exports them like
// bdc_pool_read_phases.
#ifdef BDC_POOL_PROFILE
constexpr int kProfiledBlocks = 128;
constexpr int kProfiledWarps = 8;  // the warps of a block, in both kernels
constexpr int kMaxProfiledGrid = 4096;
__device__ unsigned g_block_sm[kMaxProfiledGrid];  // the SM each block ran on
#define PHASE_CLOCKS(n)                                                   \
  constexpr int kPhases = n;                                              \
  __device__ long long g_phase_cycles[kPhases][kProfiledBlocks * kProfiledWarps]; \
  __device__ int g_profiled_grid;  // gridDim.x of the last launch
#define PHASES_BEGIN                    \
  long long phase_cycles[kPhases] = {}; \
  long long phase_clock = clock64();
#define PHASE_END(k)                               \
  {                                                \
    const long long now = clock64();               \
    phase_cycles[k] += now - phase_clock;          \
    phase_clock = now;                             \
  }
#define PHASES_WRITE(warp, lane)                                         \
  if (threadIdx.x == 0 && blockIdx.x == 0) g_profiled_grid = gridDim.x;  \
  if (threadIdx.x == 0 && blockIdx.x < kMaxProfiledGrid)                 \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(g_block_sm[blockIdx.x]));  \
  if (lane == 0 && blockIdx.x < kProfiledBlocks)                         \
    for (int k = 0; k < kPhases; ++k)                                    \
      g_phase_cycles[k][blockIdx.x * kProfiledWarps + warp] = phase_cycles[k];
#else
#define PHASE_CLOCKS(n)
#define PHASES_BEGIN
#define PHASE_END(k)
#define PHASES_WRITE(warp, lane)
#endif

template <int V>
struct Int {
  static constexpr int value = V;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- the two load paths -------------------------------------------------------
// Tensor map: an x whose rows start on 16-byte boundaries is described to
// the TMA unit as [B][d][M]; one thread asks for a box, the unit computes
// the addresses, zero-fills what lies beyond row d or column M, and counts
// the bytes that land on an mbarrier every thread waits on.
// Scalar: any other x is copied by 4-byte cp.async from all threads into
// the same layout and waited for by commit groups.

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// One arrival that also announces `bytes` of copies still to land.
__device__ __forceinline__ void mbarrier_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Order this thread's earlier shared-memory accesses (and those it has
// synchronised with) before its later copies through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The box at (column c0, row 0, element b) of the tensor map into `dst`.
__device__ __forceinline__ void tma_load_box(float* dst, const CUtensorMap* map,
                                             int c0, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(0), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// 4 bytes to shared memory asynchronously; with `bytes` = 0 nothing is read
// and the destination is zero-filled.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- split-TF32 mma -------------------------------------------------------------
// v = hi + lo up to 2^-21 |v|: hi is v rounded to TF32 (10 mantissa bits,
// to nearest, ties away: what cvt.rna.tf32.f32 gives, by two integer
// operations instead of the slower conversion), lo = v - hi is exact in
// fp32, and the tensor core reads only the upper 19 bits of a TF32 operand,
// which truncates lo by at most 2^-10 |lo|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// -- tensor maps ------------------------------------------------------------------
// cuTensorMapEncodeTiled of the libcuda the process has loaded, or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return reinterpret_cast<EncodeTiled>(
        lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr);
  }();
  return fn;
}

// x as [batch][d][m] fp32 in boxes of [1][box_rows][box_cols], zeros beyond
// the edges.
cudaError_t make_x_map(CUtensorMap* map, const float* x, int batch, int d,
                       int m, int box_cols, int box_rows,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)m, (cuuint64_t)d,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)m * sizeof(float),
                                 (cuuint64_t)d * m * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether x can be described by a tensor map: its base and every row on
// 16-byte boundaries.
inline bool tma_aligned(const float* x, int m) {
  return m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace
