// The BSR SpMM family for Hopper (sm_90a), shared by bsr_spmm.cu,
// bsr_spmm_fused.cu and bsr_spmm_masked.cu: Y = act(A·(M ⊙ X) + α·self +
// bias) in float32 over the flattened BSR stream of graph/csr.py:BSRMatrix
// (blocks sorted by (block-row, block-col), [n_blocks, BR, BC] float32
// tiles). Each entry file instantiates the part of the family it exports;
// a kernel's flags are template arguments, so no branch of an absent
// operand is compiled into it.
//
// Translation of the sequential TPU grid. The Pallas kernels walk the block
// stream in order on one core and carry each block-row's output tile in
// VMEM from first_in_row to last_in_row, applying the epilogue there. CTAs
// run in parallel and in no order, so here each CTA owns one (block-row,
// feature tile) and loops over that row's contiguous blocks itself,
// accumulating BR output rows in registers; the CTA's end is the row's end,
// so the epilogue runs after the loop and neither first_in_row nor
// last_in_row is read. The row's block range comes from a device-side
// binary search (searchsorted) over the sorted block_rows. Nothing crosses
// CTAs: no atomics, and the sum order is fixed, so results are bitwise
// repeatable run to run.
//
// Cases: a block-row with no blocks accumulates nothing and writes
// act(α·self + bias) (what the reference gives for its explicit zero
// block); the ragged feature edge (any F) is masked per thread, so F is
// never padded. The sampler pads every batch to its bucket's worst-case
// block count with zero blocks appended to the last block-row (col 0, after
// the row's real blocks); since a row's block-columns strictly increase,
// the CTA stops at the first column that does not, and skips that tail.
//
// What bounds it. Arithmetic is fp32 FMAs (no TF32, no tensor cores), on
// whole blocks: 2·BR·BC·F flops a block, however few nonzeros it holds.
// Each block re-reads BC rows of X where a CSR product would read only the
// rows of its nonzeros: a full-graph 8x128 block holds ~1.4 nonzeros, so
// the X traffic is ~90x what the product needs. The bound (bytes of the
// blocks that hold data, the X rows they reference and Y) is far below
// what this design moves; the measured times are in PERF.md. A block-row
// runs in one CTA, so a hub row (many blocks) is a serial chain.
//
// Design: one thread per output feature column (128 threads, or F rounded
// up to a warp when F < 128), BR accumulators per thread. Chunks of blocks
// (8 KB of values) and their block-columns are staged in shared memory
// cooperatively; each thread then streams BC coalesced X rows per block
// (neighbouring threads read neighbouring features; with MASKED, the mask
// row beside each) and does BR·BC FMAs.
#pragma once

#include <cuda_runtime.h>

namespace bsr {

constexpr int kThreads = 128;
constexpr int kStageFloats = 2048;  // block values staged per chunk (8 KB)

// Every operand of one launch. Pointers are device pointers; those a
// kernel's flags do not use may be null.
struct Args {
  const int* rows;       // [n_blocks] int32, sorted
  const int* cols;       // [n_blocks] int32
  const float* blocks;   // [n_blocks, BR, BC]
  const float* x;        // [*, f] row-major
  const float* mask_in;  // MASKED: [*, f], applied to x on load
  const float* self;     // HAS_SELF: [n_block_rows*BR, f]
  const float* bias;     // HAS_BIAS: [f]
  const float* alpha;    // HAS_SELF: 1 element, read on the device
  float* y;              // [n_block_rows*BR, f]
  float* mask_out;       // RELU: [n_block_rows*BR, f], 0/1
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

template <int BR, int BC, bool MASKED, bool HAS_SELF, bool HAS_BIAS,
          bool RELU>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
           const float* __restrict__ blocks, const float* __restrict__ x,
           const float* __restrict__ mask_in,
           const float* __restrict__ self, const float* __restrict__ bias,
           const float* __restrict__ alpha, float* __restrict__ y,
           float* __restrict__ mask_out, int n_blocks, int f) {
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
      const size_t off = static_cast<size_t>(col) * BC * f + feat;
      const float* xb = x + off;
      const float* mb = MASKED ? mask_in + off : nullptr;
      const float* a = s_blk + j * kTile;
#pragma unroll 8
      for (int k = 0; k < BC; ++k) {
        float xv = __ldg(xb + static_cast<size_t>(k) * f);
        if (MASKED) xv *= __ldg(mb + static_cast<size_t>(k) * f);
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] = fmaf(a[r * BC + k], xv, acc[r]);
      }
    }
    __syncthreads();
    if (padding) break;
  }

  if (!active) return;
  // The epilogue, in registers, in the reference's order and roundings:
  // (acc + α·self) + bias, then the ReLU and its 0/1 mask.
  const float a = HAS_SELF ? __ldg(alpha) : 0.0f;
  const float b = HAS_BIAS ? __ldg(bias + feat) : 0.0f;
  const size_t base = static_cast<size_t>(brow) * BR * f + feat;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const size_t i = base + static_cast<size_t>(r) * f;
    float v = acc[r];
    if (HAS_SELF) v = __fadd_rn(v, __fmul_rn(a, __ldg(self + i)));
    if (HAS_BIAS) v = __fadd_rn(v, b);
    if (RELU) {
      mask_out[i] = v > 0.0f ? 1.0f : 0.0f;
      v = fmaxf(v, 0.0f);
    }
    y[i] = v;
  }
}

template <int BR, int BC, bool MASKED, bool HAS_SELF, bool HAS_BIAS,
          bool RELU>
cudaError_t launch(const Args& a) {
  const int threads = a.f >= kThreads ? kThreads : ((a.f + 31) / 32) * 32;
  const dim3 grid(a.n_block_rows, (a.f + threads - 1) / threads);
  bsr_kernel<BR, BC, MASKED, HAS_SELF, HAS_BIAS, RELU>
      <<<grid, threads, 0, a.stream>>>(a.rows, a.cols, a.blocks, a.x,
                                       a.mask_in, a.self, a.bias, a.alpha,
                                       a.y, a.mask_out, a.n_blocks, a.f);
  return cudaGetLastError();
}

}  // namespace bsr

// The (br, bc) tiles every entry instantiates (kernels/bsr_spmm.py:TILES).
#define BSR_FOR_EACH_TILE(X) \
  X(8, 8) X(8, 16) X(8, 32) X(8, 64) X(8, 128) X(16, 16) X(16, 32) X(16, 64)
