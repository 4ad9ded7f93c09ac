// Backward of the fused BDC pool (DeepBDC head) for Hopper, sm_90a.
//
// Replaces the gradient that XLA derives for audio_fewshot_tpu/ops/bdc.py
// (bdc_pool, followed by triuvec): the JAX package trains through that XLA
// graph, and the port's forward is the CUDA kernel of bdc_pool.cu, so its
// gradient is a kernel too.  For each batch element x[b] of shape [d, M] and
// the incoming gradient gy[b] of the upper-triangle vector (np.triu_indices
// order) it computes, without leaving the SM:
//   dist2 = |x_i - x_j|^2          summed over M in order in fp32
//   t = exp(log_t),  D = sqrt(t dist2 + 1e-5)
//   Dbar  = Ybar - rowmean(Ybar) - colmean(Ybar) + mean(Ybar)
//           (Ybar = gy scattered into the upper triangle; double centring is
//            self-adjoint)
//   A     = Dbar * t / (2 D) * [dist2 > 0],   S = A + A^T
//   xbar_i = 2 sum_j S_ij (x_i - x_j)          (= 2 (diag(S 1) - S) x)
//   part  = sum_ij Dbar_ij t dist2_ij / (2 D_ij) = 1/2 sum_ij S_ij dist2_ij
// and writes xbar [B, d, M] and the log_t partial of each element [B] (the
// caller sums the B partials: deterministic, no atomics).
//
// Accuracy.  The forward forms dist2 from the gram, g_ii + g_jj - 2 g_ij,
// whose rounding (~eps |x|^2) swamps the distance of nearly equal rows.  In
// the gradient those pairs weigh most (t / (2D) is largest where D is
// smallest), so the kernel sums the squared differences instead, which
// keeps small distances to relative precision and gives 0 exactly for
// equal rows and on the diagonal; and it forms xbar from the differences
// x_i - x_j, not as diag(S 1) x - S x, which cancels.  The plain autograd
// version keeps both cancellations (ops/bdc.py::bdc_pool_triu_vjp_direct
// repeats this kernel's arithmetic in PyTorch).
//
// S only needs the symmetric part of Dbar, which the triu vector gives
// directly: with Ysym_ij = gy(min(i,j), max(i,j)) off the diagonal and
// 2 gy(i,i) on it, rowmean(Ybar)_i + colmean(Ybar)_i = rowsum(Ysym)_i / d and
// Dbar_ij + Dbar_ji = Ysym_ij - (rowsum_i + rowsum_j) / d + sum(Ysym) / d^2.
//
// The [dist2 > 0] mask differs from JAX's tie rule (jnp.maximum splits the
// gradient at 0) only where dist2 == 0: on the diagonal and for identical
// rows, where the derivative of dist2 by x is 0 either way.
//
// Bound on this card at the training shape (75, 64, 304): ~11.7 MB of x in
// and xbar out (about 3.7 us at 3.35 TB/s) against ~0.28 GFLOP of gram and
// product (about 4.2 us at 67 TFLOP/s fp32); at this B the launch latency
// dominates.  The design is the simple one: one block per batch element, x
// streamed through a shared-memory tile of kChunk columns twice (once for
// the distances, once for the product), every thread owning an NB x NB
// tile of the d x d matrices in registers (rows ty + 16a, columns tx + 16c)
// and an NB x 4 tile of each xbar chunk, fp32 on the CUDA cores.  All d^2
// distances are summed, not only the upper half (twice the operations of
// the bound); (x_i - x_j)^2 and (x_j - x_i)^2 are the same number, so the
// matrix is bitwise symmetric.  Tensor cores, TMA and persistent blocks
// wait for a later redesign.
//
// 1 <= d <= 128 (padded with zero rows to Dp = 16 NB; padded rows carry no
// gradient and the means divide by the true d); any M >= 1.  log_t is read
// through a device pointer, so a call never synchronises with the host.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;
constexpr int kChunk = 64;                // columns of x per tile
constexpr int kTileStride = kChunk + 1;   // odd: rows fall on distinct banks
constexpr int kColsPerThread = kChunk / 16;

// Dynamic shared memory of a block at Dp = 16 nb: the d x d matrix (Ysym,
// then S) [Dp][Dp + 1], the x tile [Dp][kChunk + 1], the row sums [Dp], and
// one partial sum per warp.
constexpr size_t smem_bytes(int nb) {
  return (size_t)(16 * nb * (16 * nb + 1) + 16 * nb * kTileStride + 16 * nb +
                  kWarps) *
         sizeof(float);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Columns [m0, m0 + kChunk) of x's d rows into tile, zero beyond d and M.
template <int DP>
__device__ __forceinline__ void load_tile(const float* __restrict__ xb,
                                          float* tile, int d, int m,
                                          int m0) {
  for (int e = threadIdx.x; e < DP * kChunk; e += kThreads) {
    const int r = e / kChunk, c = e % kChunk;
    float v = 0.f;
    if (r < d && m0 + c < m) v = __ldg(xb + (size_t)r * m + m0 + c);
    tile[r * kTileStride + c] = v;
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
    bdc_pool_backward_kernel(const float* __restrict__ x,
                             const float* __restrict__ log_t,
                             const float* __restrict__ grad_triu,
                             float* __restrict__ grad_x,
                             float* __restrict__ grad_log_t_part, int d,
                             int m) {
  constexpr int Dp = 16 * NB;
  constexpr int kMatStride = Dp + 1;
  extern __shared__ float smem[];
  float* mat = smem;                        // [Dp][Dp + 1]: Ysym, then S
  float* tile = mat + Dp * kMatStride;      // [Dp][kChunk + 1]
  float* rsum = tile + Dp * kTileStride;    // [Dp]
  float* wpart = rsum + Dp;                 // [kWarps]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const float* xb = x + (size_t)b * d * m;
  float* gxb = grad_x + (size_t)b * d * m;
  const float* gy = grad_triu + (size_t)b * (d * (d + 1) / 2);

  // -- 1. squared distances, summed over k in order in fp32 ----------------
  float acc[NB][NB];
#pragma unroll
  for (int a = 0; a < NB; ++a)
#pragma unroll
    for (int c = 0; c < NB; ++c) acc[a][c] = 0.f;
  for (int m0 = 0; m0 < m; m0 += kChunk) {
    load_tile<Dp>(xb, tile, d, m, m0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float xr[NB], xc[NB];
#pragma unroll
      for (int a = 0; a < NB; ++a) xr[a] = tile[(ty + 16 * a) * kTileStride + k];
#pragma unroll
      for (int c = 0; c < NB; ++c) xc[c] = tile[(tx + 16 * c) * kTileStride + k];
#pragma unroll
      for (int a = 0; a < NB; ++a)
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const float diff = xr[a] - xc[c];
          acc[a][c] = fmaf(diff, diff, acc[a][c]);
        }
    }
    __syncthreads();
  }

  // -- 2. Ysym from the triu gradient and its row sums ---------------------
  for (int e = tid; e < Dp * Dp; e += kThreads) {
    const int i = e / Dp, j = e % Dp;
    float v = 0.f;
    if (i < d && j < d) {
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      v = __ldg(gy + lo * d - lo * (lo - 1) / 2 + (hi - lo));
      if (i == j) v *= 2.f;
    }
    mat[i * kMatStride + j] = v;
  }
  __syncthreads();
  for (int i = warp; i < Dp; i += kWarps) {
    float s = 0.f;
    for (int j = lane; j < Dp; j += 32) s += mat[i * kMatStride + j];
    s = warp_sum(s);
    if (lane == 0) rsum[i] = s;
  }
  __syncthreads();

  // -- 3. S in place of Ysym, and this thread's share of the log_t partial --
  const float t = expf(__ldg(log_t));
  const float inv_d = 1.f / (float)d;
  float total = 0.f;
  for (int i = 0; i < d; ++i) total += rsum[i];
  const float grand2 = total * inv_d * inv_d;  // 2 mean(Ybar)
  float part = 0.f;
#pragma unroll
  for (int a = 0; a < NB; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int j = tx + 16 * c;
      float s = 0.f;
      if (i < d && j < d) {
        const float dist2 = acc[a][c];
        if (dist2 > 0.f) {
          const float dcov = sqrtf(t * dist2 + 1e-5f);
          const float dsym =
              mat[i * kMatStride + j] - (rsum[i] + rsum[j]) * inv_d + grand2;
          s = dsym * t / (2.f * dcov);
          part = fmaf(s, dist2, part);
        }
      }
      mat[i * kMatStride + j] = s;
    }
  }
  part = warp_sum(part);
  if (lane == 0) wpart[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += wpart[w];
    grad_log_t_part[b] = 0.5f * sum;
  }

  // -- 4. xbar_i = 2 sum_j S_ij (x_i - x_j), chunk by chunk ------------------
  for (int m0 = 0; m0 < m; m0 += kChunk) {
    load_tile<Dp>(xb, tile, d, m, m0);
    __syncthreads();
    float out[NB][kColsPerThread], own[NB][kColsPerThread];
#pragma unroll
    for (int a = 0; a < NB; ++a)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        out[a][c] = 0.f;
        own[a][c] = tile[(ty + 16 * a) * kTileStride + tx + 16 * c];
      }
#pragma unroll 4
    for (int j = 0; j < Dp; ++j) {
      float sv[NB], xv[kColsPerThread];
#pragma unroll
      for (int a = 0; a < NB; ++a) sv[a] = mat[(ty + 16 * a) * kMatStride + j];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        xv[c] = tile[j * kTileStride + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < NB; ++a)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          out[a][c] = fmaf(sv[a], own[a][c] - xv[c], out[a][c]);
    }
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = m0 + tx + 16 * c;
        if (i < d && col < m) gxb[(size_t)i * m + col] = 2.f * out[a][c];
      }
    }
    __syncthreads();
  }
}

// Opt in to the kernel's dynamic shared memory, once per device.
template <int NB>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};  // every writer stores the same value
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    err = cudaFuncSetAttribute(bdc_pool_backward_kernel<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(NB));
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

template <int NB>
cudaError_t launch(const float* x, const float* log_t, const float* gy,
                   float* gx, float* part, int batch, int d, int m,
                   cudaStream_t stream) {
  cudaError_t err = prepare<NB>();
  if (err != cudaSuccess) return err;
  bdc_pool_backward_kernel<NB><<<batch, kThreads, smem_bytes(NB), stream>>>(
      x, log_t, gy, gx, part, d, m);
  return cudaGetLastError();
}

}  // namespace

// x [batch, d, m] fp32 contiguous; log_t one fp32 on the device;
// grad_triu [batch, d(d+1)/2] fp32 contiguous; grad_x [batch, d, m] fp32;
// grad_log_t_part [batch] fp32.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int bdc_pool_backward_launch(const void* x, const void* log_t,
                                        const void* grad_triu, void* grad_x,
                                        void* grad_log_t_part, int batch,
                                        int d, int m, void* stream) {
  if (batch < 0 || d < 1 || d > kMaxDim || m < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const float* xp = static_cast<const float*>(x);
  const float* lp = static_cast<const float*>(log_t);
  const float* gyp = static_cast<const float*>(grad_triu);
  float* gxp = static_cast<float*>(grad_x);
  float* pp = static_cast<float*>(grad_log_t_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return (int)launch<1>(xp, lp, gyp, gxp, pp, batch, d, m, s);
    case 2: return (int)launch<2>(xp, lp, gyp, gxp, pp, batch, d, m, s);
    case 3: return (int)launch<3>(xp, lp, gyp, gxp, pp, batch, d, m, s);
    case 4: return (int)launch<4>(xp, lp, gyp, gxp, pp, batch, d, m, s);
    case 5: return (int)launch<5>(xp, lp, gyp, gxp, pp, batch, d, m, s);
    case 6: return (int)launch<6>(xp, lp, gyp, gxp, pp, batch, d, m, s);
    case 7: return (int)launch<7>(xp, lp, gyp, gxp, pp, batch, d, m, s);
    default: return (int)launch<8>(xp, lp, gyp, gxp, pp, batch, d, m, s);
  }
}
