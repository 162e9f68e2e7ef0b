// Masked BSR SpMM for Hopper (sm_90a): Y = A·(mask ⊙ X), the backward of
// a ReLU epilogue (A is the pre-built transposed operand Aᵀ, X the
// incoming cotangent dY, mask the forward's saved 0/1 activation mask).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py:bsr_spmm_masked
// (_masked_kernel at :258, pallas_call at :312). As on the TPU, the mask
// is applied to each X value as it is loaded, so the masked cotangent
// mask ⊙ dY is never written to device memory. The row loop is the
// nonzero-column loop of bsr_nzc.cuh: only the dY rows that Aᵀ's nonzero
// columns reference are read, each with its mask row, which doubles the
// gather traffic that bounds the kernel.

#include "bsr_nzc.cuh"

// Y[n_block_rows*br, f] = A·(mask ⊙ X) over A's nonzero columns: items,
// splits, x_rows, values and partial as in bsr_spmm_fused_f32; x and mask
// float32 [*, f] row-major. vec4: f % 4 == 0 and every feature pointer
// 16-byte aligned. Launches the row pass, and the split rows' ordered
// second pass where n_split > 0, on `stream`; returns cudaGetLastError()
// after them (cudaErrorInvalidValue for a br that is not instantiated).
extern "C" int bsr_spmm_masked_f32(const void* items, int n_items,
                                   const void* splits, int n_split,
                                   const void* x_rows, const void* values,
                                   void* partial, const void* x,
                                   const void* mask, void* y, int f, int br,
                                   int vec4, void* stream) {
  if (n_items == 0 || f == 0) return 0;
  nzc::Args a{};
  a.items = static_cast<const int4*>(items);
  a.splits = static_cast<const int*>(splits);
  a.x_rows = static_cast<const int*>(x_rows);
  a.values = static_cast<const float*>(values);
  a.partial = static_cast<float*>(partial);
  a.x = static_cast<const float*>(x);
  a.mask_in = static_cast<const float*>(mask);
  a.y = static_cast<float*>(y);
  a.n_items = n_items;
  a.n_split = n_split;
  a.f = f;
  a.vec4 = vec4 != 0;
  a.stream = static_cast<cudaStream_t>(stream);
#define BSR_MASKED_BR(R)                                                 \
  if (br == R)                                                           \
    return static_cast<int>(nzc::launch<R, true, false, false, false>(a));
  NZC_FOR_EACH_BR(BSR_MASKED_BR)
#undef BSR_MASKED_BR
  return static_cast<int>(cudaErrorInvalidValue);
}
