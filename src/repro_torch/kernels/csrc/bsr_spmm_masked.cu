// Masked BSR SpMM for Hopper (sm_90a): Y = A·(mask ⊙ X), the backward of
// a ReLU epilogue (A is the pre-built transposed operand Aᵀ, X the
// incoming cotangent dY, mask the forward's saved 0/1 activation mask).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py:bsr_spmm_masked
// (_masked_kernel at :258, pallas_call at :312). As on the TPU, the mask
// is applied to each X value as it is loaded, so the masked cotangent
// mask ⊙ dY is never written to device memory. The row loop is the
// family's (bsr_common.cuh); the mask doubles the X traffic that bounds
// it, since each X value read comes with its mask value.

#include "bsr_common.cuh"

// Y[n_block_rows*br, f] = A·(mask ⊙ X). rows, cols, blocks, x as in
// bsr_spmm_f32; mask float32 shaped like x. Launches on `stream` and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// tile that is not instantiated).
extern "C" int bsr_spmm_masked_f32(const void* rows, const void* cols,
                                   const void* blocks, const void* x,
                                   const void* mask, void* y, int n_blocks,
                                   int n_block_rows, int f, int br, int bc,
                                   void* stream) {
  if (n_block_rows == 0 || f == 0) return 0;
  bsr::Args a{};
  a.rows = static_cast<const int*>(rows);
  a.cols = static_cast<const int*>(cols);
  a.blocks = static_cast<const float*>(blocks);
  a.x = static_cast<const float*>(x);
  a.mask_in = static_cast<const float*>(mask);
  a.y = static_cast<float*>(y);
  a.n_blocks = n_blocks;
  a.n_block_rows = n_block_rows;
  a.f = f;
  a.stream = static_cast<cudaStream_t>(stream);
#define BSR_MASKED_TILE(R, C)                                            \
  if (br == R && bc == C)                                                \
    return static_cast<int>(bsr::launch<R, C, true, false, false, false>(a));
  BSR_FOR_EACH_TILE(BSR_MASKED_TILE)
#undef BSR_MASKED_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
