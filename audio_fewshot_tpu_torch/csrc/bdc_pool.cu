// Fused BDC pooling (DeepBDC head) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel audio_fewshot_tpu/ops/bdc_pallas.py
// (_bdc_kernel / bdc_pool_fused).  For each batch element x[b] of shape
// [d, M] (d channels, M = H*W positions) it computes, without leaving the
// SM:
//   gram  = x x^T                                  (fp32 FMAs, no TF32)
//   dist2 = max(gram_ii + gram_jj - 2 gram_ij, 0)  (diagonal read from gram)
//   dcov  = sqrt(exp(log_t) * dist2 + 1e-5)
//   out   = dcov - row_mean - col_mean + grand_mean
// and writes the upper triangle row-major ([B, d(d+1)/2], np.triu_indices
// order, i.e. triuvec fused) and, when `full` is not null, the whole [B, d, d].
//
// Design: one block of 256 threads per batch element.  The 16x16 thread grid
// owns a register tile of (d/16)^2 gram entries per thread (rows ty+16i,
// cols tx+16j); x streams through shared memory in chunks of 32 columns,
// stored transposed with an odd row stride so both the stores and the
// broadcast reads are free of bank conflicts.  The gram then overwrites the
// chunk buffer and the epilogue runs in shared memory.  The gram is
// bitwise symmetric (fmaf is commutative and every entry sums over the same
// k order), so dcov is too and the column means equal the row means.
//
// d <= 128 (d padded up to a multiple of 16); any M.  log_t is read through
// a device pointer so a call never synchronises with the host.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;   // the thread grid is kTile x kTile
constexpr int kChunk = 32;  // columns of x staged per step
constexpr int kMaxDim = 128;

template <int R>
__host__ __device__ constexpr int padded_dim() { return kTile * R; }

template <int R>
__host__ __device__ constexpr int row_stride() { return padded_dim<R>() + 1; }

template <int R>
constexpr size_t smem_bytes() {
  // [max(Dp, kChunk)][S] chunk / gram buffer, then diag[Dp], mean[Dp], grand
  return (size_t)((padded_dim<R>() > kChunk ? padded_dim<R>() : kChunk) *
                      row_stride<R>() +
                  2 * padded_dim<R>() + 1) *
         sizeof(float);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
bdc_pool_kernel(const float* __restrict__ x, const float* __restrict__ log_t,
                float* __restrict__ triu, float* __restrict__ full, int d,
                int m) {
  constexpr int Dp = padded_dim<R>();
  constexpr int S = row_stride<R>();
  constexpr int base = (Dp > kChunk ? Dp : kChunk) * S;
  extern __shared__ float smem[];
  float* buf = smem;               // x chunk [kChunk][S], later gram/dcov [Dp][S]
  float* diag = smem + base;       // [Dp]
  float* mean = diag + Dp;         // [Dp] row (= column) means of dcov
  float* grand = mean + Dp;        // [1]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % kTile;
  const int ty = tid / kTile;
  const float* xb = x + (size_t)b * d * m;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < m; m0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < Dp * kChunk; e += kThreads) {
      const int row = e / kChunk;
      const int k = e % kChunk;
      float v = 0.f;
      if (row < d && m0 + k < m) v = xb[(size_t)row * m + m0 + k];
      buf[k * S + row] = v;
    }
    __syncthreads();
    const int kn = min(kChunk, m - m0);
    for (int k = 0; k < kn; ++k) {
      float a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = buf[k * S + ty + kTile * i];
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = buf[k * S + tx + kTile * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }
  __syncthreads();  // the last chunk is consumed before the gram replaces it

#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
      buf[(ty + kTile * i) * S + tx + kTile * j] = acc[i][j];
  __syncthreads();

  for (int i = tid; i < d; i += kThreads) diag[i] = buf[i * S + i];
  __syncthreads();

  const float scale = expf(__ldg(log_t));
  for (int e = tid; e < d * d; e += kThreads) {
    const int i = e / d;
    const int j = e % d;
    const float dist2 = fmaxf(diag[i] + diag[j] - 2.f * buf[i * S + j], 0.f);
    buf[i * S + j] = sqrtf(scale * dist2 + 1e-5f);
  }
  __syncthreads();

  for (int i = tid; i < d; i += kThreads) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s += buf[i * S + j];
    mean[i] = s / (float)d;
  }
  __syncthreads();

  if (tid < 32) {
    float s = 0.f;
    for (int i = tid; i < d; i += 32) s += mean[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (tid == 0) *grand = s / (float)d;
  }
  __syncthreads();

  const float g = *grand;
  const size_t n_triu = (size_t)d * (d + 1) / 2;
  float* tri = triu + (size_t)b * n_triu;
  float* out = full ? full + (size_t)b * d * d : nullptr;
  for (int e = tid; e < d * d; e += kThreads) {
    const int i = e / d;
    const int j = e % d;
    const float v = buf[i * S + j] - mean[i] - mean[j] + g;
    if (out) out[e] = v;
    if (j >= i) tri[i * d - i * (i - 1) / 2 + (j - i)] = v;
  }
}

template <int R>
cudaError_t launch(const float* x, const float* log_t, float* triu,
                   float* full, int batch, int d, int m,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<R>();
  cudaError_t err = cudaFuncSetAttribute(
      bdc_pool_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  bdc_pool_kernel<R><<<batch, kThreads, smem, stream>>>(x, log_t, triu, full,
                                                       d, m);
  return cudaGetLastError();
}

}  // namespace

// x [batch, d, m] fp32 contiguous; log_t one fp32 on the device;
// triu [batch, d(d+1)/2] fp32; full [batch, d, d] fp32 or null.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int bdc_pool_launch(const void* x, const void* log_t, void* triu,
                               void* full, int batch, int d, int m,
                               void* stream) {
  if (batch < 0 || d < 1 || d > kMaxDim || m < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const float* xp = static_cast<const float*>(x);
  const float* lp = static_cast<const float*>(log_t);
  float* tp = static_cast<float*>(triu);
  float* fp = static_cast<float*>(full);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + kTile - 1) / kTile) {
    case 1: return (int)launch<1>(xp, lp, tp, fp, batch, d, m, s);
    case 2: return (int)launch<2>(xp, lp, tp, fp, batch, d, m, s);
    case 3: return (int)launch<3>(xp, lp, tp, fp, batch, d, m, s);
    case 4: return (int)launch<4>(xp, lp, tp, fp, batch, d, m, s);
    case 5: return (int)launch<5>(xp, lp, tp, fp, batch, d, m, s);
    case 6: return (int)launch<6>(xp, lp, tp, fp, batch, d, m, s);
    case 7: return (int)launch<7>(xp, lp, tp, fp, batch, d, m, s);
    default: return (int)launch<8>(xp, lp, tp, fp, batch, d, m, s);
  }
}
