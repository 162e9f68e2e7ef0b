// Block-sparse-row SpMM for Hopper (sm_90a): Y = A·X in float32 over the
// flattened BSR stream of graph/csr.py:BSRMatrix (blocks sorted by
// (block-row, block-col), [n_blocks, BR, BC] float32 tiles).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py:bsr_spmm
// (_kernel at :50, pallas_call at :105).
//
// Translation of the sequential TPU grid. The TPU walks the block stream in
// order on one core and carries each block-row's output tile in VMEM from
// first_in_row to the row's last block. CTAs run in parallel and in no
// order, so here each CTA owns one (block-row, feature tile) and loops over
// that row's contiguous blocks itself, accumulating BR output rows in
// registers. The row's block range comes from a device-side binary search
// (searchsorted) over the sorted block_rows, so no row pointer is built and
// first_in_row is not read. Nothing crosses CTAs: no atomics, and the sum
// order is fixed, so results are bitwise repeatable run to run.
//
// Cases: a block-row with no blocks writes zeros; the ragged feature edge
// (any F) is masked per thread, so F is never padded. The sampler pads
// every batch to its bucket's worst-case block count with zero blocks
// appended to the last block-row (col 0, after the row's real blocks);
// since a row's block-columns strictly increase, the CTA stops at the
// first column that does not, and skips that tail. At the serving
// configuration ~96% of layer 0's blocks are such padding, and walking
// them in one CTA took ~96 ms on an H100 (PERF.md).
//
// What bounds it. Arithmetic is fp32 FMAs (no TF32, no tensor cores). A
// sampled 8x8 block holds about one nonzero, so the work on whole blocks
// (2·BR·BC·F flops a block) is ~60x what the nonzeros need, and each block
// re-reads BC rows of X where a CSR product would read one. The bound is
// the bytes of the blocks that hold data, the X rows they reference and Y.
// Sampled rows hold a few blocks each, so a CTA's time is a short chain of
// dependent memory latencies (the search, staging, X rows) rather than
// bandwidth; the measured times are in PERF.md.
//
// Design: one thread per output feature column (128 threads, or F rounded
// up to a warp when F < 128), BR accumulators per thread. Chunks of blocks
// (8 KB of values) and their block-columns are staged in shared memory
// cooperatively; each thread then streams BC coalesced X rows per block
// (neighbouring threads read neighbouring features) and does BR·BC FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStageFloats = 2048;  // block values staged per chunk (8 KB)

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
bsr_spmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
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

  if (active) {
    float* yr = y + static_cast<size_t>(brow) * BR * f + feat;
#pragma unroll
    for (int r = 0; r < BR; ++r) yr[static_cast<size_t>(r) * f] = acc[r];
  }
}

template <int BR, int BC>
cudaError_t launch(const int* rows, const int* cols, const float* blocks,
                   const float* x, float* y, int n_blocks, int n_block_rows,
                   int f, cudaStream_t stream) {
  const int threads = f >= kThreads ? kThreads : ((f + 31) / 32) * 32;
  const dim3 grid(n_block_rows, (f + threads - 1) / threads);
  bsr_spmm_kernel<BR, BC><<<grid, threads, 0, stream>>>(
      rows, cols, blocks, x, y, n_blocks, f);
  return cudaGetLastError();
}

}  // namespace

// Y[n_block_rows*br, f] = A·X. All pointers are device pointers: rows and
// cols int32 [n_blocks], blocks float32 [n_blocks, br, bc], x float32
// [*, f] row-major, y float32 [n_block_rows*br, f]. Launches on `stream`
// and returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a (br, bc) tile that is not instantiated here).
extern "C" int bsr_spmm_f32(const void* rows, const void* cols,
                            const void* blocks, const void* x, void* y,
                            int n_blocks, int n_block_rows, int f, int br,
                            int bc, void* stream) {
  if (n_block_rows == 0 || f == 0) return 0;
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  const float* b = static_cast<const float*>(blocks);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BSR_SPMM_TILE(R, C)                                                 \
  if (br == R && bc == C)                                                   \
    return static_cast<int>(                                                \
        launch<R, C>(r, c, b, xx, yy, n_blocks, n_block_rows, f, s));
  BSR_SPMM_TILE(8, 8)
  BSR_SPMM_TILE(8, 16)
  BSR_SPMM_TILE(8, 32)
  BSR_SPMM_TILE(8, 64)
  BSR_SPMM_TILE(8, 128)
  BSR_SPMM_TILE(16, 16)
  BSR_SPMM_TILE(16, 32)
  BSR_SPMM_TILE(16, 64)
#undef BSR_SPMM_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
