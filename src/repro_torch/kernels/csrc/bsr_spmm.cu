// Block-sparse-row SpMM for Hopper (sm_90a): Y = A·X in float32.
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py:bsr_spmm
// (_kernel at :50, pallas_call at :105). The kernel body, its translation
// of the TPU grid and what bounds it are in bsr_common.cuh; this file
// instantiates it for every tile. The sampled serving path runs it per
// layer; full-batch training runs it for Aᵀ·dY of a layer without ReLU
// and for the Alg-1 sparse layer-0 X·W and its dW = Xᵀ·dY.
// At the serving configuration ~96% of layer 0's blocks are the sampler's
// padding tail, and walking them in one CTA took ~96 ms on an H100 before
// the kernel learned to stop there (PERF.md).

#include "bsr_common.cuh"

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
  bsr::Args a{};
  a.rows = static_cast<const int*>(rows);
  a.cols = static_cast<const int*>(cols);
  a.blocks = static_cast<const float*>(blocks);
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.n_blocks = n_blocks;
  a.n_block_rows = n_block_rows;
  a.f = f;
  a.stream = static_cast<cudaStream_t>(stream);
#define BSR_SPMM_TILE(R, C) \
  if (br == R && bc == C) return static_cast<int>(bsr::launch<R, C>(a));
  BSR_FOR_EACH_TILE(BSR_SPMM_TILE)
#undef BSR_SPMM_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
