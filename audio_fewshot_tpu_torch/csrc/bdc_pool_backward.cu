// Backward of the fused BDC pool (DeepBDC head) for Hopper, sm_90a.
//
// Replaces the gradient that XLA derives for audio_fewshot_tpu/ops/bdc.py
// (bdc_pool, followed by triuvec): the JAX package trains through that XLA
// graph, and the port's forward is the CUDA kernel of bdc_pool.cu, so its
// gradient is a kernel too.  For each batch element x[b] of shape [d, M] and
// the incoming gradient gy[b] of the upper-triangle vector (np.triu_indices
// order) it computes:
//   dist2 = |x_i - x_j|^2          summed over M in fp32
//   t = exp(log_t),  D = sqrt(t dist2 + 1e-5)
//   Dbar  = Ybar - rowmean(Ybar) - colmean(Ybar) + mean(Ybar)
//           (Ybar = gy scattered into the upper triangle; double centring is
//            self-adjoint)
//   S     = (Dbar + Dbar^T) * t / (2 D) * [dist2 > 0]
//   xbar_i = 2 sum_j S_ij (x_i - x_j)          (= 2 (diag(S 1) - S) x)
//   part  = 1/2 sum_ij S_ij dist2_ij
// and writes xbar [B, d, M] and one log_t partial per block, as fp64, which
// a second kernel (bdc_pool_backward_sum_log_t) sums in a fixed order into
// the fp32 gradient of log_t (deterministic, no atomics).
//
// Accuracy.  The forward forms dist2 from the gram, g_ii + g_jj - 2 g_ij,
// whose rounding (~eps |x|^2) swamps the distance of nearly equal rows.  In
// the gradient those pairs weigh most (t / (2D) is largest where D is
// smallest), so the kernel sums the squared differences instead, which
// keeps small distances to relative precision and gives 0 exactly for equal
// rows and on the diagonal; and it forms xbar from the differences
// x_i - x_j.  The product diag(S 1) x - S x (on the tensor cores by split
// TF32, or on the CUDA cores) cancels in fp32 where S is large, i.e. at
// nearly equal rows: 2.2e-5 of the gradient's max abs against float64 at
// d = 16, against 2e-7 for the differences (tests/test_torch_port_train.py),
// so the product stays on the CUDA cores.  Dsym = Dbar + Dbar^T, and the
// log_t terms Dsym_ij t dist2_ij / (2 D_ij), are formed in fp64: the centred
// terms cancel to a sum ~1e-4 of their magnitudes, and fp32 terms leave up
// to 3e-5 of it.  ops/bdc.py::bdc_pool_triu_vjp_cluster repeats this
// arithmetic in PyTorch.
//
// S only needs the symmetric part of Dbar, which the triu vector gives
// directly: with Ysym_ij = gy(min(i,j), max(i,j)) off the diagonal and
// 2 gy(i,i) on it, rowmean(Ybar)_i + colmean(Ybar)_i = rowsum(Ysym)_i / d and
// Dbar_ij + Dbar_ji = Ysym_ij - (rowsum_i + rowsum_j) / d + sum(Ysym) / d^2.
// The [dist2 > 0] mask differs from JAX's tie rule (jnp.maximum splits the
// gradient at 0) only where dist2 == 0: on the diagonal and for identical
// rows, where the derivative of dist2 by x is 0 either way.
//
// Bound on this card at the training shape (75, 64, 304): ~0.28 GFLOP of
// distances (upper triangle) and product at 67 TFLOP/s fp32 (4.2 us)
// against ~11.7 MB of x in and xbar out (3.5 us): operations.  Design:
//
// * Clusters over M.  Each element gets a thread-block cluster of C blocks
//   (cudaLaunchKernelEx with a cluster dimension); block r owns the
//   contiguous columns [r w, (r+1) w), w = M / C rounded up to 4.  C is the
//   smallest count up to 8 with B C >= 1.5 x the SMs, while every block
//   keeps at least 4 columns: C = 3 at B = 75 (225 blocks of 104 columns,
//   at most two an SM); C = 1 from B = 198 on; C = 8 for B <= 28.  The time
//   follows the columns of the busiest SM, and C = 4 puts three blocks (228
//   columns) on many SMs where C = 3 puts two (208 columns); C = 5 puts
//   four on some (PERF.md, profile_bdc_pool --backward --cluster).  d does
//   not enter: a block's shared memory holds its slice at any d <= 128.
// * x loaded once.  A block's [d, w] slice lands in shared memory once, by
//   one TMA box from a [B][d][M] tensor map (4-byte cp.async when x is not
//   16-byte aligned or M % 4 != 0), and serves both passes.  The load is
//   asked for first; the row sums of the incoming gradient are computed
//   while it is in flight.  A slice wider than kMaxCols columns (M > 8 x 124
//   at small B) is walked in chunks and loaded again for the product.
// * Distances, upper 16x16 units only.  The row blocks are paired (I,
//   NB-1-I) so that every warp group owns NB + 1 units; which ones is a
//   template parameter, so nothing in the k-loop branches.  A lane owns 4
//   rows x 2 columns of each unit (40 partial sums at d = 64) and reads
//   float2 pairs of columns: 16 shared loads for 80 FMA-pairs a k-pair.
//   The warps of a group split the columns; their partial sums meet in
//   shared memory in a fixed order.
// * Deterministic cluster reduction.  After barrier.cluster each block
//   owns whole rows of the triu, about 1/C of its entries: it adds the C
//   partial distances in rank order through distributed shared memory
//   (mapa), forms S and its log_t terms, and stores S into the shared memory
//   of every block of the cluster; after a second barrier every block holds
//   all of S and none reads a peer again.  Every block copies the incoming
//   triu gradient into shared memory (cp.async, beside the x load) and
//   computes its row sums.
// * Product on the CUDA cores: a thread owns 16 rows of one column, keeps
//   x[rows, m] in registers and runs j over d with S[j, rows] read as four
//   broadcast float4 (S is symmetric) and x[j, m] by consecutive lanes;
//   rows of xbar leave as coalesced runs of columns.
// * Phase clocks (-DBDC_POOL_PROFILE, profile_bdc_pool.py --backward):
//   row sums and load wait, distances, cluster reduce, S, product, store.
//
// 1 <= d <= 128 (padded with zero rows to Dp = 16 NB; padded rows carry no
// gradient and the means divide by the true d); any M >= 1; any B >= 0.
// log_t is read through a device pointer, so a call never synchronises
// with the host.

#include <cstddef>
#include <cstdint>

#include "bdc_common.cuh"

namespace {

PHASE_CLOCKS(6)  // row sums + wait, distances, reduce, S, product, store

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxCols = 124;   // columns of a chunk (124 / 4 odd, see pitch)
constexpr int kRowGroup = 16;   // rows of xbar a thread owns in the product

// Row pitch of the x tile for a chunk of `cols` columns: the TMA box (or the
// copies) write rows of `pitch` floats; with pitch / 4 odd, the float2 reads
// of 8 consecutive rows at one column fall on distinct banks.
inline int pitch_for(int cols) { return (cols / 4) % 2 ? cols : cols + 4; }

// Dynamic shared memory at Dp = 16 nb: room to align the tile to 128 bytes,
// the x tile [Dp][pitch], the partial distances and then S [Dp][Dp + 8],
// the incoming triu gradient [Dp (Dp + 1) / 2], the row sums [Dp], the
// warps' log_t sums [kWarps] and the grand sum (fp64), the first triu row of
// every block of the cluster [kMaxCluster + 1], and the mbarrier.
inline size_t smem_bytes(int nb, int pitch) {
  const size_t dp = 16 * (size_t)nb;
  const size_t triu = (dp * (dp + 1) / 2 + 1) / 2 * 2;  // keeps fp64 aligned
  return 128 + sizeof(float) * (dp * pitch + dp * (dp + 8) + triu) +
         sizeof(double) * (dp + kWarps + 1) + sizeof(int) * (kMaxCluster + 2) +
         sizeof(uint64_t);
}

template <int NB>
struct Shape {
  static constexpr int Dp = 16 * NB;
  static constexpr int kSS = Dp + 8;  // = 8 or 24 mod 32
  // row blocks are paired (I, NB-1-I); with NB odd the middle one is alone
  static constexpr int kGroups = (NB + 1) / 2;
  // warps of one group split the column pairs of a chunk
  static constexpr int kSplit = kWarps / kGroups >= 8 ? 8
                                : kWarps / kGroups >= 4 ? 4 : 2;
  // Resident blocks an SM the registers are capped for: two hold the
  // training batch (225 blocks on 124 SMs) up to d = 64.
  static constexpr int kMinBlocks = NB > 4 ? 1 : 2;
};

// What group G owns: row block rb1 = G against the column blocks
// J = rb1 .. NB-1 (n1 units, slots J - rb1) and row block rb2 = NB-1-G
// against J = rb2 .. NB-1 (n2 units, slots n1 + J - rb2); the middle block
// of an odd NB has n2 = 0.
template <int NB, int G>
struct Owned {
  static constexpr int rb1 = G;
  static constexpr int rb2 = NB - 1 - G;
  static constexpr int n1 = NB - rb1;
  static constexpr int n2 = rb2 > rb1 ? NB - rb2 : 0;
};

// f(Int<G>{}) for the warp's group G
template <int NB, int G = 0, class F>
__device__ __forceinline__ void for_group(int group, F f) {
  if (group == G) {
    f(Int<G>{});
  } else if constexpr (G + 1 < Shape<NB>::kGroups) {
    for_group<NB, G + 1>(group, f);
  }
}

// f(slot, first row, first column) for every unit of group G
template <int NB, int G, class F>
__device__ __forceinline__ void for_units(F f) {
  using O = Owned<NB, G>;
#pragma unroll
  for (int J = O::rb1; J < NB; ++J) f(J - O::rb1, 16 * O::rb1, 16 * J);
#pragma unroll
  for (int J = O::rb2; J < NB; ++J)
    if (O::n2 > 0) f(O::n1 + J - O::rb2, 16 * O::rb2, 16 * J);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float add_sq2(float2 a, float2 b, float acc) {
  const float d0 = a.x - b.x, d1 = a.y - b.y;
  return fmaf(d1, d1, fmaf(d0, d0, acc));
}

// Squared differences over the column pairs k = k0, k0 + kstep, ... < k1 of
// the tile, for every unit of group G.  A lane (ly = lane / 8, lx = lane % 8)
// owns rows ly + 4a (a < 4) and columns lx + 8c (c < 2) of each unit:
// acc[slot][2a + c].
template <int NB, int G>
__device__ __forceinline__ void distance_steps(const float* xs, int pitch,
                                               int k0, int k1, int kstep,
                                               int ly, int lx,
                                               float (&acc)[NB + 1][8]) {
  using O = Owned<NB, G>;
  const float* row1 = xs + (16 * O::rb1 + ly) * pitch;
  const float* row2 = xs + (16 * O::rb2 + ly) * pitch;
  const float* col = xs + lx * pitch;
  for (int k = k0; k < k1; k += kstep) {
    float2 r1[4], r2[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      r1[a] = ld2(row1 + 4 * a * pitch + k);
      if (O::n2 > 0) r2[a] = ld2(row2 + 4 * a * pitch + k);
    }
#pragma unroll
    for (int J = O::rb1; J < NB; ++J) {
      float2 cv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) cv[c] = ld2(col + (16 * J + 8 * c) * pitch + k);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          acc[J - O::rb1][2 * a + c] = add_sq2(r1[a], cv[c], acc[J - O::rb1][2 * a + c]);
          if (O::n2 > 0 && J >= O::rb2)
            acc[O::n1 + J - O::rb2][2 * a + c] =
                add_sq2(r2[a], cv[c], acc[O::n1 + J - O::rb2][2 * a + c]);
        }
    }
  }
}

// One round of the in-block reduction of the warps' partial distances:
// every round but the first adds what the rounds before left in `part`.
template <int NB, int G>
__device__ __forceinline__ void reduce_owned(const float (&acc)[NB + 1][8],
                                             float* part, int ly, int lx,
                                             bool first) {
  constexpr int SS = Shape<NB>::kSS;
  for_units<NB, G>([&](int slot, int row0, int col0) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float* e = part + (row0 + ly + 4 * a) * SS + col0 + lx + 8 * c;
        *e = first ? acc[slot][2 * a + c] : *e + acc[slot][2 * a + c];
      }
  });
}

// -- the cluster ----------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic address of `p` (in this block's shared memory) in the shared
// memory of block `rank` of the cluster: plain loads and stores through it
// pipeline.
__device__ __forceinline__ float* peer_w(float* p, int rank) {
  uint64_t remote;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(remote)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<float*>(remote);
}

__device__ __forceinline__ const float* peer(const float* p, int rank) {
  return peer_w(const_cast<float*>(p), rank);
}

// The triu vector's row i starts at i d - i (i - 1) / 2.
__device__ __forceinline__ int triu_start(int i, int d) {
  return i * d - i * (i - 1) / 2;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NB, bool TMA>
__global__ void __launch_bounds__(kThreads, Shape<NB>::kMinBlocks)
    bdc_pool_backward_kernel(const __grid_constant__ CUtensorMap x_map,
                             const float* __restrict__ x,
                             const float* __restrict__ log_t,
                             const float* __restrict__ grad_triu,
                             float* __restrict__ grad_x,
                             double* __restrict__ grad_log_t_part, int d,
                             int m, int slice, int chunk, int pitch) {
  using Sh = Shape<NB>;
  constexpr int Dp = Sh::Dp;
  constexpr int SS = Sh::kSS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(
      smem_raw + (128 - smem_addr(smem_raw) % 128) % 128);  // [Dp][pitch]
  float* ps = xs + Dp * pitch;  // [Dp][SS]: partial distances, then S
  float* gys = ps + Dp * SS;    // [Dp (Dp + 1) / 2]: the triu gradient
  double* rs = reinterpret_cast<double*>(gys + (Dp * (Dp + 1) / 2 + 1) / 2 * 2);
  double* wsum = rs + Dp;         // [kWarps]
  double* grand = wsum + kWarps;  // sum(Ysym) / d^2
  int* row_begin = reinterpret_cast<int*>(grand + 1);  // [kMaxCluster + 1]
  uint64_t* landed = reinterpret_cast<uint64_t*>(row_begin + kMaxCluster + 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int ly = lane >> 3, lx = lane & 7;
  const int group = warp % Sh::kGroups;
  const int kpart = warp / Sh::kGroups;
  const bool active = kpart < Sh::kSplit;  // false for leftover warps
  const int n_cluster = cluster_size();
  const int rank = cluster_rank();
  const int b = blockIdx.x / n_cluster;
  const float* xb = x + (size_t)b * d * m;
  const float* gy = grad_triu + (size_t)b * (d * (d + 1) / 2);

  // this block's columns, in chunks of `chunk`
  const int col_begin = min(m, rank * slice);
  const int col_end = min(m, col_begin + slice);
  const int n_chunks = (col_end - col_begin + chunk - 1) / chunk;
  int parity = 0;
  auto request = [&](int q) {  // chunk q of the slice into the tile
    const int c0 = col_begin + q * chunk;
    if constexpr (TMA) {
      if (tid == 0) {
        fence_proxy_async();  // the tile's readers are done (barrier before)
        mbarrier_expect(landed, Dp * pitch * (int)sizeof(float));
        tma_load_box(xs, &x_map, c0, b, landed);
      }
    } else {
      const int cols = min(chunk, col_end - c0);
      for (int e = tid; e < d * chunk; e += kThreads) {
        const int row = e / chunk, col = e % chunk;
        const bool inside = col < cols;
        cp_async_4(xs + row * pitch + col,
                   xb + (size_t)row * m + (inside ? c0 + col : 0),
                   inside ? 4 : 0);
      }
      cp_async_commit();
    }
  };
  auto wait_landed = [&]() {
    if constexpr (TMA) {
      mbarrier_wait(landed, parity);
      parity ^= 1;
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  PHASES_BEGIN
  if (TMA && tid == 0) {
    mbarrier_init(landed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!TMA)  // rows d..Dp of the tile stay zero: no copy writes them
    for (int e = d * pitch + tid; e < Dp * pitch; e += kThreads) xs[e] = 0.f;
  const int n_pairs = d * (d + 1) / 2;
  for (int p = tid; p < n_pairs; p += kThreads) cp_async_4(gys + p, gy + p, 4);
  cp_async_commit();
  if (n_chunks > 0) request(0);

  // -- row sums of Ysym (fp64), while x is in flight -------------------------
  // kRowLanes consecutive lanes share a row: all their loads are in flight
  // together, then a fixed-order shuffle tree adds them
  constexpr int kRowLanes = Dp <= 16 ? 16 : Dp <= 32 ? 8 : Dp <= 64 ? 4 : 2;
  if (!TMA && n_chunks > 0)
    cp_async_wait<1>();  // the gradient's group; x's may still be in flight
  else
    cp_async_wait<0>();
  __syncthreads();
  for (int i0 = 0; i0 < d; i0 += kThreads / kRowLanes) {  // warp-uniform
    const int i = i0 + tid / kRowLanes;
    double s = 0.0;
#pragma unroll 8
    for (int j = tid % kRowLanes; i < d && j < d; j += kRowLanes) {
      const int lo = min(i, j), hi = max(i, j);
      const float v = gys[triu_start(lo, d) + hi - lo];
      s += i == j ? 2.0 * v : (double)v;
    }
#pragma unroll
    for (int off = kRowLanes / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (i < d && tid % kRowLanes == 0) rs[i] = s;
  }
  __syncthreads();
  if (warp == 0) {
    double s = 0.0;
    for (int i = lane; i < d; i += 32) s += rs[i];
    s = warp_sum(s);
    if (lane == 0) *grand = s / ((double)d * d);
    // block r of the cluster owns the triu rows [row_begin[r], row_begin[r+1]),
    // about n_pairs / C entries
    if (lane <= n_cluster) {
      const int target = (int)((long long)lane * n_pairs / n_cluster);
      int i = 0;
      while (i < d && triu_start(i, d) < target) ++i;
      row_begin[lane] = i;
    }
  }

  // -- 1. partial squared distances over this block's columns ---------------
  float acc[NB + 1][8];
#pragma unroll
  for (int u = 0; u < NB + 1; ++u)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[u][r] = 0.f;
  for (int q = 0; q < n_chunks; ++q) {
    if (q > 0) {
      __syncthreads();  // every warp is done with the tile
      request(q);
    }
    wait_landed();
    PHASE_END(0)
    const int width = min(chunk, col_end - col_begin - q * chunk);  // % 4 == 0 or tail
    const int pairs_end = 2 * ((width + 1) / 2);  // past M the tile holds zeros
    if (active)
      for_group<NB>(group, [&](auto G) {
        distance_steps<NB, decltype(G)::value>(xs, pitch, 2 * kpart, pairs_end,
                                               2 * Sh::kSplit, ly, lx, acc);
      });
    PHASE_END(1)
  }
#pragma unroll 1
  for (int p = 0; p < Sh::kSplit; ++p) {
    if (active && kpart == p)
      for_group<NB>(group, [&](auto G) {
        reduce_owned<NB, decltype(G)::value>(acc, ps, ly, lx, p == 0);
      });
    __syncthreads();
  }
  PHASE_END(1)

  // -- 2. this block's rows of the triu: C partials in rank order ---------
  cluster_arrive();
  cluster_wait();  // every block's partial distances are complete
  const int row0 = row_begin[rank], row1 = row_begin[rank + 1];
  const float t = expf(__ldg(log_t));
  const double g2 = *grand;
  const double inv_d = 1.0 / d;
  double part = 0.0;
  // entries (i, j), i <= j < d, of this block's rows; e walks [row0, row1) x Dp
  // in batches whose remote loads are all in flight together
  constexpr int kBatch = 4;
  for (int base = 0; base < (row1 - row0) * Dp; base += kBatch * kThreads) {
    float dist2[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + tid;
      const int i = row0 + e / Dp, j = e % Dp;
      float part_c[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        part_c[c] = c < n_cluster && i < row1 && i <= j && j < d
                        ? *peer(ps + i * SS + j, c) : 0.f;
      dist2[u] = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) dist2[u] += part_c[c];  // rank order
    }
    PHASE_END(2)
    // -- 3. S and the log_t terms of these entries, into every block --------
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + tid;
      const int i = row0 + e / Dp, j = e % Dp;
      if (i >= row1 || j < i || j >= d) continue;
      const float y = gys[triu_start(i, d) + j - i];
      const double dsym = (i == j ? 2.0 * y : (double)y) - (rs[i] + rs[j]) * inv_d + g2;
      float s = 0.f;
      if (dist2[u] > 0.f) {
        const float q = t / (2.f * sqrtf(t * dist2[u] + 1e-5f));
        s = (float)(dsym * q);
        part += dsym * q * dist2[u];
      }
      // the partials at (i, j) are read (above, by this thread) before any
      // block writes S there; (j, i) lies below the diagonal, which no block
      // reads before the barrier
      for (int c = 0; c < n_cluster; ++c) {
        *peer_w(ps + i * SS + j, c) = s;
        *peer_w(ps + j * SS + i, c) = s;
      }
    }
    PHASE_END(3)
  }
  part = warp_sum(part);
  if (lane == 0) wsum[warp] = part;
  cluster_arrive();
  cluster_wait();  // S is complete in every block; no block reads a peer after
  if (tid == 0) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += wsum[w];
    grad_log_t_part[blockIdx.x] = sum;
  }
  PHASE_END(3)

  // -- 4. xbar_i = 2 sum_j S_ij (x_i - x_j), 8 rows of one column a thread ---
  const int n_groups = (d + kRowGroup - 1) / kRowGroup;
  float* gxb = grad_x + (size_t)b * d * m;
  for (int q = 0; q < n_chunks; ++q) {
    const int c0 = col_begin + q * chunk;
    const int cols = min(chunk, col_end - c0);
    if (n_chunks > 1) {
      __syncthreads();
      request(q);
      wait_landed();
    }
    for (int it = tid; it < n_groups * cols; it += kThreads) {
      const int i0 = kRowGroup * (it / cols), col = it % cols;
      float own[kRowGroup], out[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        own[r] = xs[(i0 + r) * pitch + col];
        out[r] = 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < d; ++j) {
        const float xj = xs[j * pitch + col];
        float sv[kRowGroup];
#pragma unroll
        for (int r = 0; r < kRowGroup; r += 4)
          *reinterpret_cast<float4*>(sv + r) =
              *reinterpret_cast<const float4*>(ps + j * SS + i0 + r);
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) out[r] = fmaf(sv[r], own[r] - xj, out[r]);
      }
      PHASE_END(4)
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r)
        if (i0 + r < d) gxb[(size_t)(i0 + r) * m + c0 + col] = 2.f * out[r];
      PHASE_END(5)
    }
  }
  if constexpr (!TMA) cp_async_wait<0>();
  PHASE_END(5)
  PHASES_WRITE(warp, lane)
}

// The gradient of log_t: the n fp64 partials summed in a fixed order (one
// block; each thread a strided run, then a tree), written as fp32.  n = 0
// writes 0.
__global__ void __launch_bounds__(kThreads)
    sum_log_t_kernel(const double* __restrict__ part, int n, float* __restrict__ out) {
  __shared__ double sums[kThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += part[i];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k /= 2) {
    if (threadIdx.x < k) sums[threadIdx.x] += sums[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (float)sums[0];
}

// The blocks of a cluster for this batch and M (see the design notes).
int cluster_blocks(int batch, int m, int sms) {
  const int max_by_cols = (m + 3) / 4;  // every block keeps >= 4 columns
  int c = 1;
  while (c < kMaxCluster && c < max_by_cols && 2LL * batch * c < 3LL * sms) ++c;
  return c;
}

int device_sms() {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};  // every writer stores the same value
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return 0;
  if (cached[device] == 0 &&
      cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return cached[device];
}

// Opt in to the kernel's largest dynamic shared memory, once per device.
template <int NB, bool TMA>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};  // every writer stores the same value
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    err = cudaFuncSetAttribute(bdc_pool_backward_kernel<NB, TMA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(NB, kMaxCols));
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

template <int NB, bool TMA>
cudaError_t launch(const float* x, const float* log_t, const float* gy,
                   float* gx, double* part, int batch, int d, int m,
                   int n_cluster, cudaStream_t stream) {
  cudaError_t err = prepare<NB, TMA>();
  if (err != cudaSuccess) return err;
  const int slice = 4 * ((m + 4 * n_cluster - 1) / (4 * n_cluster));
  const int n_chunks = (slice + kMaxCols - 1) / kMaxCols;
  const int chunk = 4 * ((slice + 4 * n_chunks - 1) / (4 * n_chunks));
  const int pitch = pitch_for(chunk);
  alignas(64) CUtensorMap x_map = {};
  if (TMA && (err = make_x_map(&x_map, x, batch, d, m, pitch, 16 * NB,
                                CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * n_cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes(NB, pitch);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, bdc_pool_backward_kernel<NB, TMA>, x_map,
                           x, log_t, gy, gx, part, d, m, slice, chunk, pitch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();  // a refused cluster launch shows here
}

template <int NB>
cudaError_t launch_for_alignment(const float* x, const float* log_t,
                                 const float* gy, float* gx, double* part,
                                 int batch, int d, int m, int n_cluster,
                                 cudaStream_t stream) {
  return tma_aligned(x, m)
             ? launch<NB, true>(x, log_t, gy, gx, part, batch, d, m, n_cluster, stream)
             : launch<NB, false>(x, log_t, gy, gx, part, batch, d, m, n_cluster, stream);
}

// The launch with C blocks a cluster (1 <= C <= 8).
int launch_with_cluster(const void* x, const void* log_t, const void* grad_triu,
                        void* grad_x, void* grad_log_t_part, int batch, int d,
                        int m, int n_cluster, void* stream) {
  if (batch < 0 || d < 1 || d > kMaxDim || m < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  if (n_cluster < 1 || n_cluster > kMaxCluster) return (int)cudaErrorNoDevice;
  const float* xp = static_cast<const float*>(x);
  const float* lp = static_cast<const float*>(log_t);
  const float* gyp = static_cast<const float*>(grad_triu);
  float* gxp = static_cast<float*>(grad_x);
  double* pp = static_cast<double*>(grad_log_t_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return (int)launch_for_alignment<1>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
    case 2: return (int)launch_for_alignment<2>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
    case 3: return (int)launch_for_alignment<3>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
    case 4: return (int)launch_for_alignment<4>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
    case 5: return (int)launch_for_alignment<5>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
    case 6: return (int)launch_for_alignment<6>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
    case 7: return (int)launch_for_alignment<7>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
    default: return (int)launch_for_alignment<8>(xp, lp, gyp, gxp, pp, batch, d, m, n_cluster, s);
  }
}

}  // namespace

// The blocks a launch gives each batch element, C (1 to 8): the
// caller's grad_log_t_part holds batch * C doubles.  0 without a device.
extern "C" int bdc_pool_backward_cluster(int batch, int m) {
  const int sms = device_sms();
  return sms > 0 && m >= 1 ? cluster_blocks(batch, m, sms) : 0;
}

// x [batch, d, m] fp32 contiguous; log_t one fp32 on the device;
// grad_triu [batch, d(d+1)/2] fp32 contiguous; grad_x [batch, d, m] fp32;
// grad_log_t_part [batch * bdc_pool_backward_cluster(batch, m)] fp64, whose
// sum (bdc_pool_backward_sum_log_t) is the gradient of log_t.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int bdc_pool_backward_launch(const void* x, const void* log_t,
                                        const void* grad_triu, void* grad_x,
                                        void* grad_log_t_part, int batch,
                                        int d, int m, void* stream) {
  return launch_with_cluster(x, log_t, grad_triu, grad_x, grad_log_t_part,
                             batch, d, m, bdc_pool_backward_cluster(batch, m),
                             stream);
}

// grad_log_t_part as bdc_pool_backward_launch wrote it, n = batch * C
// doubles; grad_log_t one fp32 on the device, their sum.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int bdc_pool_backward_sum_log_t(const void* grad_log_t_part, int n,
                                           void* grad_log_t, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  sum_log_t_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(grad_log_t_part), n, static_cast<float*>(grad_log_t));
  return (int)cudaGetLastError();
}

#ifdef BDC_POOL_PROFILE
// bdc_pool_backward_launch with C blocks a cluster given by the caller
// (1 <= C <= 8), for profile_bdc_pool --backward --cluster.
extern "C" int bdc_pool_backward_launch_cluster(
    const void* x, const void* log_t, const void* grad_triu, void* grad_x,
    void* grad_log_t_part, int batch, int d, int m, int n_cluster,
    void* stream) {
  return launch_with_cluster(x, log_t, grad_triu, grad_x, grad_log_t_part,
                             batch, d, m, n_cluster, stream);
}

// What bdc_pool_backward_read_phases fills: phases x (profiled blocks x
// warps a block).
extern "C" void bdc_pool_backward_phase_shape(int* phases, int* blocks,
                                              int* warps) {
  static_assert(kWarps == kProfiledWarps, "g_phase_cycles has 8 warps a block");
  *phases = kPhases;
  *blocks = kProfiledBlocks;
  *warps = kWarps;
}

// The phase clocks of the last launch, kPhases x (kProfiledBlocks * kWarps),
// and the number of blocks it ran on.
extern "C" int bdc_pool_backward_read_phases(long long* out, int* grid) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(grid, g_profiled_grid, sizeof(int));
}

// The SM each of the first kMaxProfiledGrid blocks of the last launch ran on.
extern "C" int bdc_pool_backward_read_block_sms(int* out) {
  return (int)cudaMemcpyFromSymbol(out, g_block_sm, sizeof(g_block_sm));
}
#endif
