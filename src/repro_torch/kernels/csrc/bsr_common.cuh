// The whole-block BSR SpMM loop for Hopper (sm_90a): Y = A·X in float32
// over the flattened BSR stream of graph/csr.py:BSRMatrix (blocks sorted
// by (block-row, block-col), [n_blocks, BR, BC] float32 tiles), whole
// blocks at a time. bsr_spmm.cu instantiates it for each tile. The
// fused-epilogue and masked kernels run the nonzero-column loop of
// bsr_nzc.cuh instead; bsr_attention.cu takes lower_bound from here.
//
// Translation of the sequential TPU grid. The Pallas kernels walk the block
// stream in order on one core and carry each block-row's output tile in
// VMEM from first_in_row to last_in_row. CTAs run in parallel and in no
// order, so here each CTA owns one (block-row, feature tile) and loops
// over that row's contiguous blocks itself, accumulating BR output rows in
// registers; the CTA's end is the row's end, so the row is written after
// the loop and neither first_in_row nor last_in_row is read. The row's
// block range comes from a device-side binary search (searchsorted) over
// the sorted block_rows. Nothing crosses CTAs: no atomics, and the sum
// order is fixed, so results are bitwise repeatable run to run.
//
// Cases: a block-row with no blocks accumulates nothing and writes zeros
// (what the reference gives for its explicit zero block); the ragged
// feature edge (any F) is masked per thread, so F is never padded. The sampler pads every batch to its bucket's worst-case
// block count with zero blocks appended to the last block-row (col 0, after
// the row's real blocks); since a row's block-columns strictly increase,
// the CTA stops at the first column that does not, and skips that tail.
//
// What bounds it. Arithmetic is fp32 FMAs (no TF32, no tensor cores), on
// whole blocks: 2·BR·BC·F flops a block, however few nonzeros it holds.
// Each block re-reads BC rows of X where a CSR product would read only the
// rows of its nonzeros: a full-graph 8x128 block holds ~1.4 nonzeros, so
// the X traffic is ~90x what the product needs, and the block values
// alone (3.76 GB for ogbn-arxiv's A) are several times the nonzero bound.
// On the sampled serving path's 8x8 buckets the blocks are denser and the
// loop costs less. A block-row runs in one CTA, so a hub row (many blocks)
// is a serial chain. The measured times are in PERF.md.
//
// Where the nonzero-column design of bsr_nzc.cuh would take it: bsr_spmm
// is the same product with no epilogue and no mask (the fused kernel's
// spec 0), so it moves onto that loop by building its operand's nonzero
// columns once (Aᵀ of full-batch training, the feature operands X, Xᵀ);
// the sampled path builds a new operand per batch, so there the build
// would run per call, on the device beside the copy.
//
// Design: one thread per output feature column (128 threads, or F rounded
// up to a warp when F < 128), BR accumulators per thread. Chunks of blocks
// (8 KB of values) and their block-columns are staged in shared memory
// cooperatively; each thread then streams BC coalesced X rows per block
// (neighbouring threads read neighbouring features) and does BR·BC FMAs.
#pragma once

#include <cuda_runtime.h>

namespace bsr {

constexpr int kThreads = 128;
constexpr int kStageFloats = 2048;  // block values staged per chunk (8 KB)

// Every operand of one launch; pointers are device pointers.
struct Args {
  const int* rows;      // [n_blocks] int32, sorted
  const int* cols;      // [n_blocks] int32
  const float* blocks;  // [n_blocks, BR, BC]
  const float* x;       // [*, f] row-major
  float* y;             // [n_block_rows*BR, f]
  int n_blocks;
  int n_block_rows;
  int f;
  cudaStream_t stream;
};

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int BR, int BC>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
           const float* __restrict__ blocks, const float* __restrict__ x,
           float* __restrict__ y, int n_blocks, int f) {
  constexpr int kTile = BR * BC;
  constexpr int kChunk = kTile >= kStageFloats ? 1 : kStageFloats / kTile;
  __shared__ float s_blk[kChunk * kTile];
  __shared__ int s_col[kChunk];
  __shared__ int s_range[2];

  const int brow = blockIdx.x;
  const int feat = blockIdx.y * blockDim.x + threadIdx.x;
  if (threadIdx.x == 0) {
    s_range[0] = lower_bound(rows, n_blocks, brow);
    s_range[1] = lower_bound(rows, n_blocks, brow + 1);
  }
  __syncthreads();
  const int begin = s_range[0];
  const int end = s_range[1];
  const bool active = feat < f;

  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;

  int prev_col = -1;
  for (int c0 = begin; c0 < end; c0 += kChunk) {
    const int nb = min(kChunk, end - c0);
    const float* src = blocks + static_cast<size_t>(c0) * kTile;
    for (int i = threadIdx.x; i < nb * kTile; i += blockDim.x) {
      s_blk[i] = __ldg(src + i);
    }
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      s_col[i] = __ldg(cols + c0 + i);
    }
    __syncthreads();
    // A row's block-columns strictly increase; the first one that does not
    // starts the zero padding tail (the same branch in every thread).
    bool padding = false;
    for (int j = 0; j < nb; ++j) {
      const int col = s_col[j];
      if (col <= prev_col) {
        padding = true;
        break;
      }
      prev_col = col;
      if (!active) continue;
      const float* xb = x + static_cast<size_t>(col) * BC * f + feat;
      const float* a = s_blk + j * kTile;
#pragma unroll 8
      for (int k = 0; k < BC; ++k) {
        const float xv = __ldg(xb + static_cast<size_t>(k) * f);
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] = fmaf(a[r * BC + k], xv, acc[r]);
      }
    }
    __syncthreads();
    if (padding) break;
  }

  if (!active) return;
  const size_t base = static_cast<size_t>(brow) * BR * f + feat;
#pragma unroll
  for (int r = 0; r < BR; ++r) y[base + static_cast<size_t>(r) * f] = acc[r];
}

template <int BR, int BC>
cudaError_t launch(const Args& a) {
  const int threads = a.f >= kThreads ? kThreads : ((a.f + 31) / 32) * 32;
  const dim3 grid(a.n_block_rows, (a.f + threads - 1) / threads);
  bsr_kernel<BR, BC><<<grid, threads, 0, a.stream>>>(
      a.rows, a.cols, a.blocks, a.x, a.y, a.n_blocks, a.f);
  return cudaGetLastError();
}

}  // namespace bsr

// The (br, bc) tiles every entry instantiates (kernels/bsr_spmm.py:TILES).
#define BSR_FOR_EACH_TILE(X) \
  X(8, 8) X(8, 16) X(8, 32) X(8, 64) X(8, 128) X(16, 16) X(16, 32) X(16, 64)
