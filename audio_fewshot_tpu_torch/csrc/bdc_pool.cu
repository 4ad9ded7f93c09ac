// Fused BDC pooling (DeepBDC head) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel audio_fewshot_tpu/ops/bdc_pallas.py
// (_bdc_kernel / bdc_pool_fused).  For each batch element x[b] of shape
// [d, M] (d channels, M = H*W positions) it computes, without leaving the
// SM:
//   gram  = x x^T                                  (fp32 accuracy, see below)
//   dist2 = max(gram_ii + gram_jj - 2 gram_ij, 0)  (diagonal read from gram)
//   dcov  = sqrt(exp(log_t) * dist2 + 1e-5)
//   out   = dcov - row_mean - col_mean + grand_mean
// and writes the upper triangle row-major ([B, d(d+1)/2], np.triu_indices
// order, i.e. triuvec fused) and, when `full` is not null, the whole [B, d, d].
//
// Bound on this card: memory traffic.  At d = 64, M = 304 an element is
// 77.8 KB of x read once and 8.3 KB written, while the upper triangle needs
// only d(d+1)M FLOPs, so the least time is the bytes over the HBM rate.  The
// design streams x and puts the rest beside the stream:
//
// * Persistent blocks.  The grid is (SMs x resident blocks per SM); a block
//   walks b = blockIdx.x, blockIdx.x + gridDim.x, ...  x arrives in chunks
//   of kChunk columns through a ring of kStages shared-memory stages.  The
//   ring runs across elements, so the loads of element b+1 are in flight
//   during the arithmetic and the epilogue of b, and the other resident
//   blocks on the SM (three in all up to d = 64) compute while this one
//   writes.
// * Loads by the TMA unit.  x is described as a [B][d][M] tensor map; one
//   thread asks for a [Dp][32] box, the unit computes the addresses,
//   zero-fills rows beyond d and columns beyond M, and counts the bytes that
//   land on an mbarrier.  No warp spends cycles on the copies or stalls on a full
//   load queue, as it does with per-thread cp.async.  An x that is not
//   16-byte aligned (M not a multiple of 4) takes 4-byte cp.async instead,
//   into the same layout.
// * No transpose, no padding.  Both operands of x x^T are rows of x,
//   contiguous along the summed axis: exactly the row.col operand layout of
//   mma.  The tensor map's 128-byte swizzle spreads the 8 rows x 4 columns of
//   a fragment over all 32 banks.
// * Half the gram, on the tensor cores.  Only the 16x8 units on or above
//   the diagonal are computed, by mma.sync m16n8k8 TF32 with fp32
//   accumulators on an error-compensated split: hi = tf32(x),
//   lo = x - hi (which the tensor core truncates to TF32),
//   gram += hi.lo + lo.hi + hi.hi (small terms first).
//   The dropped lo.lo term and the truncation of lo are ~2^-21 relative per
//   product, below the rounding of an fp32 accumulation over M terms.  A
//   single TF32 pass (2^-11) would put visible noise on the near-zero
//   distances of similar channels.
//   The 16-row blocks are paired (I, NB-1-I) so that every warp group owns
//   the same number of units (2NB + 2), and the warps of a group split the
//   8-column k-steps of a chunk between them; their partial sums meet in
//   shared memory in a fixed order, so the result is deterministic.
// * Symmetric by construction.  Entries i <= j are written from the
//   accumulators and mirrored, and the diagonal is read from that gram, so
//   dist2_ii = 0 exactly, dcov is bitwise symmetric, and the column means
//   equal the row means.  Identical rows of x give identical gram entries
//   (same operands, same order), so duplicated channels are at distance 0.
// * Parallel epilogue.  A warp owns rows, a lane columns: dcov in
//   registers, row sums by interleaved warp shuffles, the grand mean from
//   the row means, then each triu row is written as a contiguous run.
// * Latency.  With 8 warps a block and 3 blocks an SM every phase is bound by
//   the latency of dependent operations before any pipe fills, so
//   independent work is put side by side and nothing in the mma sequence
//   branches: which units a warp owns is a template parameter, the three mma
//   passes run batch-wide over different accumulators, the reduction loads
//   everything before it stores, and the epilogue's rows are reduced
//   together.
//
// 1 <= d <= 128 (padded with zero rows to a multiple of 16; the means divide
// by the true d); any M >= 1.  log_t is read through a device pointer so a
// call never synchronises with the host.

#include <cstddef>
#include <cstdint>

#include "bdc_common.cuh"

namespace {

// phase clocks (bdc_common.cuh): wait, barrier, request, k-steps, reduce,
// dcov, out
PHASE_CLOCKS(7)

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;
constexpr int kChunk = 64;              // columns of x per ring stage
constexpr int kStages = 3;              // ring depth
constexpr int kBoxCols = 32;            // one 128-byte swizzled row
constexpr int kBoxes = kChunk / kBoxCols;
constexpr int kRingAlign = 1024;        // what the 128-byte swizzle repeats over
constexpr int kStepsPerChunk = kChunk / 8;

// Dynamic shared memory of a block at Dp = 16 nb: room to align the ring,
// the ring [kStages][Dp][kChunk], the gram [Dp][Dp + 8], the diagonal and
// the row means [Dp] each, and one mbarrier per stage.
constexpr size_t smem_bytes(int nb) {
  return kRingAlign +
         (size_t)(kStages * 16 * nb * kChunk + 16 * nb * (16 * nb + 8) +
                  2 * 16 * nb) *
             sizeof(float) +
         kStages * sizeof(uint64_t);
}

// Compile-time shape of the kernel for d padded to Dp = 16 NB.
template <int NB>
struct Shape {
  static constexpr int Dp = 16 * NB;
  // row blocks are paired (I, NB-1-I); with NB odd the middle one is alone
  static constexpr int kGroups = (NB + 1) / 2;
  // warps of one group split the k-steps (kStepsPerChunk % kSplit == 0)
  static constexpr int kSplit = kWarps / kGroups >= 8 ? 8
                                : kWarps / kGroups >= 4 ? 4 : 2;
  static constexpr int kUnits = 2 * NB + 2;    // 16x8 units per warp
  static constexpr int kGramStride = Dp + 8;   // = 8 or 24 mod 32
  static constexpr int kBoxFloats = Dp * kBoxCols;
  static constexpr int kStageFloats = kBoxes * kBoxFloats;
  static constexpr size_t kSmemBytes = smem_bytes(NB);
  // Resident blocks an SM the registers are capped for.  Every phase is
  // latency-bound, so a third block is worth more than the registers it
  // takes; the scalar path's address arithmetic would spill under that cap.
  static constexpr int min_blocks(bool tma) {
    return NB > 4 ? 1 : tma ? 3 : 2;
  }
  // column blocks whose B fragments a warp holds at once
  static constexpr int kBatch = 4;
  static_assert(kStepsPerChunk % kSplit == 0 && kGroups * kSplit <= kWarps,
                "the warps of a group share a chunk's k-steps evenly");
};

// -- a stage of the ring ------------------------------------------------------
// kBoxes boxes of [Dp rows][32 columns], each row 128 bytes whose eight
// 16-byte pieces are permuted by the 128-byte swizzle of the tensor map:
// piece c of row r lies at piece c ^ (r % 8).  The 8 rows x 4 columns of an
// mma fragment then fall on 32 different banks without any padding.
// Column `col` (0 .. kChunk-1) of row `row`:
template <int DP>
__device__ __forceinline__ int stage_offset(int row, int col) {
  const int k = col % kBoxCols;
  return (col / kBoxCols) * (DP * kBoxCols) + row * kBoxCols +
         ((((k >> 2) ^ (row & 7)) << 2) | (k & 3));
}

// Columns [col0, col0 + kChunk) of one element into a stage, asked for by
// one thread.  A box that starts beyond column m is not asked for: no
// k-step reads it.
template <int DP>
__device__ __forceinline__ void request_chunk_tma(float* stage,
                                                const CUtensorMap* map, int b,
                                                int m, int col0,
                                                uint64_t* bar) {
  fence_proxy_async();  // the stage's readers are done (block barrier before)
  const int boxes = min(kBoxes, (m - col0 + kBoxCols - 1) / kBoxCols);
  mbarrier_expect(bar, boxes * DP * kBoxCols * (int)sizeof(float));
  for (int k = 0; k < boxes; ++k)
    tma_load_box(stage + k * DP * kBoxCols, map, col0 + k * kBoxCols, b, bar);
}

// The same by 4-byte copies from all threads, zero-filled past column m.
// Rows d..DP of a stage are never written and stay zero.
template <int DP>
__device__ __forceinline__ void copy_chunk_scalar(float* stage,
                                                   const float* xb, int d,
                                                   int m, int col0, int tid) {
  const int total = d * kChunk;
  for (int e = tid; e < total; e += kThreads) {
    const int row = e / kChunk;
    const int col = e % kChunk;
    const bool inside = col0 + col < m;
    const float* src = xb + (size_t)row * m + (inside ? col0 + col : 0);
    cp_async_4(stage + stage_offset<DP>(row, col), src, inside ? 4 : 0);
  }
}

// sqrt to 2^-23 relative (one operation on the special-function unit, where
// sqrtf's exact rounding takes ten); the same input gives the same output,
// so dcov stays symmetric.
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The m16n8k8 A fragment of 16 rows starting at p (which already points at
// row g of them): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4), with
// o0 and o1 the swizzled places of columns k0 + t and k0 + t + 4 in a row.
__device__ __forceinline__ void load_a(const float* p, int o0, int o1,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(p[o0], hi[0], lo[0]);
  split_tf32(p[8 * kBoxCols + o0], hi[1], lo[1]);
  split_tf32(p[o1], hi[2], lo[2]);
  split_tf32(p[8 * kBoxCols + o1], hi[3], lo[3]);
}

// What the warps of group G own: row block rb1 = G against the 8-column
// blocks J = 2 rb1 .. 2NB-1 (n1 units, accumulator slots 0 .. n1-1, slot
// jr <-> J = 2NB-1-jr) and row block rb2 = NB-1-G against J = 2 rb2 .. 2NB-1
// (n2 units, slots 2NB+1-jr).  n1 + n2 = 2NB + 2 for a pair; the middle
// block of an odd NB has n2 = 0.  All of it is known at compile time, so
// the mma sequence has no branch in it: the code is instantiated per group
// and the warp picks its copy once (for_group).
template <int NB, int G>
struct Owned {
  static constexpr int rb1 = G;
  static constexpr int rb2 = NB - 1 - G;
  static constexpr int n1 = 2 * NB - 2 * rb1;
  static constexpr int n2 = rb2 > rb1 ? 2 * rb1 + 2 : 0;
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

// f(slot, first row, first column) for every unit of the group; unrolled
// and inlined, all three are constants
template <int NB, int G, class F>
__device__ __forceinline__ void for_units(F f) {
  using O = Owned<NB, G>;
#pragma unroll
  for (int jr = 0; jr < O::n1; ++jr) {
    const int col0 = 8 * (2 * NB - 1 - jr);
    f(jr, 16 * O::rb1, col0);
    if (jr < O::n2) f(2 * NB + 1 - jr, 16 * O::rb2, col0);
  }
}

// One k-step of the units with jr in [JR0, JR0 + kBatch), then of the
// batches after it.  The three passes run over the whole batch one after
// the other, small products first, so that consecutive mma write different
// accumulators and none waits for the one before it.
template <int NB, int G, int JR0>
__device__ __forceinline__ void k_step_batch(
    const float* p, int o0, int o1, const uint32_t (&a1h)[4], const uint32_t (&a1l)[4],
    const uint32_t (&a2h)[4], const uint32_t (&a2l)[4],
    float (&acc)[2 * NB + 2][4]) {
  using O = Owned<NB, G>;
  constexpr int JR1 =
      JR0 + Shape<NB>::kBatch < O::n1 ? JR0 + Shape<NB>::kBatch : O::n1;
  // B fragment of column block J: b0 (k = t, n = g), b1 (k = t+4, n = g),
  // i.e. row 8J + g of x at columns k0 + t and k0 + t + 4.  The two column
  // blocks on a row block's diagonal are halves of its A fragment (a0 a2
  // and a1 a3) and are neither loaded nor split again.
  uint32_t bh[JR1 - JR0][2], bl[JR1 - JR0][2];
#pragma unroll
  for (int jr = JR0; jr < JR1; ++jr) {
    const int J = 2 * NB - 1 - jr;
    uint32_t(&h)[2] = bh[jr - JR0];
    uint32_t(&l)[2] = bl[jr - JR0];
    if (J / 2 == O::rb1) {
      h[0] = a1h[J % 2], h[1] = a1h[J % 2 + 2];
      l[0] = a1l[J % 2], l[1] = a1l[J % 2 + 2];
    } else if (O::n2 > 0 && J / 2 == O::rb2) {
      h[0] = a2h[J % 2], h[1] = a2h[J % 2 + 2];
      l[0] = a2l[J % 2], l[1] = a2l[J % 2 + 2];
    } else {
      const float* pb = p + 8 * J * kBoxCols;
      split_tf32(pb[o0], h[0], l[0]);
      split_tf32(pb[o1], h[1], l[1]);
    }
  }
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int jr = JR0; jr < JR1; ++jr) {
      const uint32_t(&b)[2] = pass == 0 ? bl[jr - JR0] : bh[jr - JR0];
      mma_tf32(acc[jr], pass == 1 ? a1l : a1h, b);
      if (jr < O::n2) mma_tf32(acc[2 * NB + 1 - jr], pass == 1 ? a2l : a2h, b);
    }
  }
  if constexpr (JR1 < O::n1)
    k_step_batch<NB, G, JR1>(p, o0, o1, a1h, a1l, a2h, a2l, acc);
}

// k-step `step` (columns 8 step .. 8 step + 7 of the stage) of every unit of
// group G.
template <int NB, int G>
__device__ __forceinline__ void k_step(const float* stage, int step, int g,
                                       int t, float (&acc)[2 * NB + 2][4]) {
  using O = Owned<NB, G>;
  constexpr int kStepsPerBox = kBoxCols / 8;
  // rows g, g+8, ... all have r % 8 = g, so one pair of offsets serves all
  const float* p = stage + (step / kStepsPerBox) * Shape<NB>::kBoxFloats +
                   g * kBoxCols;
  const int o0 = (((2 * (step % kStepsPerBox)) ^ g) << 2) | t;
  const int o1 = o0 ^ 4;
  uint32_t a1h[4], a1l[4], a2h[4] = {0, 0, 0, 0}, a2l[4] = {0, 0, 0, 0};
  load_a(p + 16 * O::rb1 * kBoxCols, o0, o1, a1h, a1l);
  if constexpr (O::n2 > 0) load_a(p + 16 * O::rb2 * kBoxCols, o0, o1, a2h, a2l);
  k_step_batch<NB, G, 0>(p, o0, o1, a1h, a1l, a2h, a2l, acc);
}

// One round of the k-split reduction.  The C fragment of a unit is c0 c1 at
// row g, columns 2t 2t+1 and c2 c3 at row g+8.  Every round but the first
// adds what the rounds before left in the gram (all loads before any
// store, so they overlap); every round but the last stores the sums back.
// The last writes the finished entries with i <= j, mirrors them to (j, i)
// and copies the diagonal out.  It leaves a unit's entries below the
// diagonal alone: a mirror write replaces them.
template <int NB, int G>
__device__ __forceinline__ void reduce_owned(float (&acc)[2 * NB + 2][4],
                                             float* gram, float* diag, int g,
                                             int t, bool first, bool last) {
  constexpr int GS = Shape<NB>::kGramStride;
  float* base = gram + g * GS + 2 * t;
  if (!first)
    for_units<NB, G>([&](int slot, int row0, int col0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 old = *reinterpret_cast<const float2*>(
            base + (row0 + 8 * h) * GS + col0);
        acc[slot][2 * h] += old.x;
        acc[slot][2 * h + 1] += old.y;
      }
    });
  if (!last) {
    for_units<NB, G>([&](int slot, int row0, int col0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(base + (row0 + 8 * h) * GS + col0) =
            make_float2(acc[slot][2 * h], acc[slot][2 * h + 1]);
    });
  } else {
    float* mirror = gram + 2 * t * GS + g;
    for_units<NB, G>([&](int slot, int row0, int col0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1, e = r & 1;
        if (col0 >= row0 + 16) {  // the whole unit lies above the diagonal
          base[(row0 + 8 * h) * GS + col0 + e] = acc[slot][r];
          mirror[(col0 + e) * GS + row0 + 8 * h] = acc[slot][r];
        } else {
          const int i = row0 + g + 8 * h;
          const int j = col0 + 2 * t + e;
          if (i <= j) {
            gram[i * GS + j] = acc[slot][r];
            gram[j * GS + i] = acc[slot][r];
            if (i == j) diag[i] = acc[slot][r];
          }
        }
      }
    });
  }
}

template <int NB, bool TMA>
__global__ void __launch_bounds__(kThreads, Shape<NB>::min_blocks(TMA))
bdc_pool_kernel(const __grid_constant__ CUtensorMap x_map,
                const float* __restrict__ x, const float* __restrict__ log_t,
                float* __restrict__ triu, float* __restrict__ full, int batch,
                int d, int m) {
  using S = Shape<NB>;
  constexpr int GS = S::kGramStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: the ring starts on kRingAlign
  float* ring = reinterpret_cast<float*>(
      smem_raw + (kRingAlign - smem_addr(smem_raw) % kRingAlign) % kRingAlign);
  float* gram = ring + kStages * S::kStageFloats;  // [Dp][GS]
  float* diag = gram + S::Dp * GS;               // [Dp]
  float* mean = diag + S::Dp;                    // [Dp] row (= column) means
  uint64_t* landed = reinterpret_cast<uint64_t*>(mean + S::Dp);  // [kStages]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // through a shuffle the compiler knows the warp index is the same in all
  // lanes, and branches on it cost no reconvergence
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = warp % S::kGroups;
  const int kpart = warp / S::kGroups;  // which share of the k-steps
  // false for warps left over when kGroups does not divide kWarps
  const bool active = kpart < S::kSplit;

  // rows d..Dp of every stage stay zero under the scalar copies, which never
  // touch them (the TMA unit writes the zeros itself)
  for (int e = tid; e < kStages * S::kStageFloats; e += kThreads) ring[e] = 0.f;
  if (TMA && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbarrier_init(landed + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_chunks = (m + kChunk - 1) / kChunk;
  const int n_elems = (int)blockIdx.x < batch
                          ? (batch - (int)blockIdx.x + (int)gridDim.x - 1) /
                                (int)gridDim.x
                          : 0;
  const size_t elem_floats = (size_t)d * m;
  const float scale = expf(__ldg(log_t));
  const float inv_d = 1.f / (float)d;
  const size_t n_triu = (size_t)d * (d + 1) / 2;

  // producer side of the ring: the next (element, chunk) to load
  int ld_elem = 0, ld_chunk = 0, ld_stage = 0;
  auto request_next = [&]() {
    if (ld_elem < n_elems) {
      const size_t b = blockIdx.x + (size_t)ld_elem * gridDim.x;
      float* dst = ring + ld_stage * S::kStageFloats;
      if constexpr (TMA) {
        if (tid == 0)
          request_chunk_tma<S::Dp>(dst, &x_map, (int)b, m, ld_chunk * kChunk,
                                 landed + ld_stage);
      } else {
        copy_chunk_scalar<S::Dp>(dst, x + b * elem_floats, d, m,
                                  ld_chunk * kChunk, tid);
      }
      if (++ld_chunk == n_chunks) {
        ld_chunk = 0;
        ++ld_elem;
      }
    }
    if constexpr (!TMA) cp_async_commit();  // empty groups keep the count
    if (++ld_stage == kStages) ld_stage = 0;
  };
  for (int s = 0; s < kStages - 1; ++s) request_next();

  float acc[S::kUnits][4];
  int stage = 0, parity = 0;
  PHASES_BEGIN
  for (int elem = 0; elem < n_elems; ++elem) {
#pragma unroll
    for (int u = 0; u < S::kUnits; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[u][r] = 0.f;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      if constexpr (TMA)
        mbarrier_wait(landed + stage, parity);  // the chunk landed
      else
        cp_async_wait<kStages - 2>();  // this thread's share of it landed
      PHASE_END(0)
      __syncthreads();  // all of it did, and the stage read last is free
      PHASE_END(1)
      request_next();
      PHASE_END(2)
      const float* st = ring + stage * S::kStageFloats;
      const int width = min(kChunk, m - chunk * kChunk);
      const int n_steps = (width + 7) / 8;
      if (active)
        for_group<NB>(group, [&](auto G) {
          for (int s = kpart; s < n_steps; s += S::kSplit)
            k_step<NB, decltype(G)::value>(st, s, g, t, acc);
        });
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
      PHASE_END(3)
    }

    // -- epilogue of one element --------------------------------------------
    // the kSplit partial sums meet in shared memory, in a fixed order
#pragma unroll 1
    for (int part = 0; part < S::kSplit; ++part) {
      if (active && kpart == part)
        for_group<NB>(group, [&](auto G) {
          reduce_owned<NB, decltype(G)::value>(acc, gram, diag, g, t, part == 0,
                                               part == S::kSplit - 1);
        });
      __syncthreads();
    }

    PHASE_END(4)
    // dcov into registers: a warp owns rows warp, warp + 8, ..., a lane the
    // columns lane, lane + 32, ...; all loads before the row sums, so the
    // kRows shuffle reductions overlap
    constexpr int kRows = S::Dp / kWarps;
    constexpr int kCols = (S::Dp + 31) / 32;
    float v[kRows][kCols], sum[kRows], dj[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dj[c] = lane + 32 * c < d ? diag[lane + 32 * c] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * r;
      const float dii = diag[i];
      sum[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = lane + 32 * c;
        // rows i >= d are computed like the others and never used
        const float dist2 = fmaxf(dii + dj[c] - 2.f * gram[i * GS + j], 0.f);
        v[r][c] = j < d ? sqrt_approx(scale * dist2 + 1e-5f) : 0.f;
        sum[r] += v[r][c];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (lane == r % 32) mean[warp + kWarps * r] = sum[r] * inv_d;
    __syncthreads();

    PHASE_END(5)
    // every warp sums the row means in the same order; the `< d` guard keeps
    // the padded rows out (their stored mean is not 0: dii = 0, dj is not)
    float mj[kCols], gs = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      mj[c] = lane + 32 * c < d ? mean[lane + 32 * c] : 0.f;
      gs += mj[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gs += __shfl_xor_sync(0xffffffffu, gs, off);
    const float grand = gs * inv_d;

    const size_t b = blockIdx.x + (size_t)elem * gridDim.x;
    float* tri = triu + b * n_triu;
    float* out = full ? full + b * (size_t)d * d : nullptr;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * r;
      if (i < d) {
        const float mi = mean[i];
        // row i of the triu is the run tri[i d - i(i-1)/2 + (j - i)], j >= i
        float* trow = tri + (i * d - i * (i - 1) / 2 - i);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = lane + 32 * c;
          const float val = v[r][c] - mi - mj[c] + grand;
          if (j < d && out) out[i * d + j] = val;
          if (j < d && j >= i) trow[j] = val;
        }
      }
    }
    PHASE_END(6)
    // the next element's chunk barriers order these reads of `mean` and the
    // dcov pass's reads of the gram before its epilogue writes them again
  }
  if constexpr (!TMA) cp_async_wait<0>();
  PHASES_WRITE(warp, lane)
}

// The blocks that can be resident on the current device at once: the grid of
// a launch.  Asked of the runtime once per kernel and device, with the
// opt-in to the kernel's dynamic shared memory.
template <int NB, bool TMA>
cudaError_t resident_blocks(int* blocks) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};  // every writer stores the same value
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    using S = Shape<NB>;
    auto kernel = bdc_pool_kernel<NB, TMA>;
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)S::kSmemBytes)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, S::kSmemBytes)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    cached[device] = sms * per_sm;
  }
  *blocks = cached[device];
  return cudaSuccess;
}

template <int NB, bool TMA>
cudaError_t launch(const float* x, const float* log_t, float* triu,
                   float* full, int batch, int d, int m,
                   cudaStream_t stream) {
  using S = Shape<NB>;
  int blocks = 0;
  cudaError_t err = resident_blocks<NB, TMA>(&blocks);
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap x_map = {};
  if (TMA && (err = make_x_map(&x_map, x, batch, d, m, kBoxCols, S::Dp,
                                CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  bdc_pool_kernel<NB, TMA>
      <<<batch < blocks ? batch : blocks, kThreads, S::kSmemBytes, stream>>>(
          x_map, x, log_t, triu, full, batch, d, m);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_for_alignment(const float* x, const float* log_t,
                                 float* triu, float* full, int batch, int d,
                                 int m, cudaStream_t stream) {
  return tma_aligned(x, m)
             ? launch<NB, true>(x, log_t, triu, full, batch, d, m, stream)
             : launch<NB, false>(x, log_t, triu, full, batch, d, m, stream);
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
  switch ((d + 15) / 16) {
    case 1: return (int)launch_for_alignment<1>(xp, lp, tp, fp, batch, d, m, s);
    case 2: return (int)launch_for_alignment<2>(xp, lp, tp, fp, batch, d, m, s);
    case 3: return (int)launch_for_alignment<3>(xp, lp, tp, fp, batch, d, m, s);
    case 4: return (int)launch_for_alignment<4>(xp, lp, tp, fp, batch, d, m, s);
    case 5: return (int)launch_for_alignment<5>(xp, lp, tp, fp, batch, d, m, s);
    case 6: return (int)launch_for_alignment<6>(xp, lp, tp, fp, batch, d, m, s);
    case 7: return (int)launch_for_alignment<7>(xp, lp, tp, fp, batch, d, m, s);
    default: return (int)launch_for_alignment<8>(xp, lp, tp, fp, batch, d, m, s);
  }
}

#ifdef BDC_POOL_PROFILE
namespace {

// `iters` rounds of 8 independent mma of the kind the kernel runs, from
// every warp: the rate the tensor cores reach through mma.sync.
__global__ void mma_rate_kernel(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {1, 2, 3, 4}, b[2] = {5, 6};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int u = 0; u < 8; ++u) mma_tf32(c[u], a, b);
  float sum = 0.f;
  for (int u = 0; u < 8; ++u) sum += c[u][0] + c[u][1] + c[u][2] + c[u][3];
  if (sum == 123.f) *out = sum;  // keeps the loop alive
}

}  // namespace

// What bdc_pool_read_phases fills: phases x (profiled blocks x warps a block).
extern "C" void bdc_pool_phase_shape(int* phases, int* blocks, int* warps) {
  static_assert(kWarps == kProfiledWarps, "g_phase_cycles has 8 warps a block");
  *phases = kPhases;
  *blocks = kProfiledBlocks;
  *warps = kWarps;
}

// The phase clocks of the last launch, kPhases x (kProfiledBlocks * kWarps),
// and the number of blocks it ran on.
extern "C" int bdc_pool_read_phases(long long* out, int* grid) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(grid, g_profiled_grid, sizeof(int));
}

// Launch mma_rate_kernel on `blocks` blocks of 256 threads.
extern "C" int bdc_pool_mma_rate(void* out, int blocks, int iters,
                                 void* stream) {
  mma_rate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
#endif
