// Fused-epilogue BSR SpMM for Hopper (sm_90a):
//   Y = act(A·X + α·self + bias), and with ReLU also mask = (pre > 0).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py:
// bsr_spmm_fused_epilogue (_make_fused_kernel at :118, pallas_call at
// :245). The TPU applies the epilogue in VMEM at last_in_row; here the CTA
// that owns a block-row applies it in registers after its row loop
// (bsr_common.cuh), so the three [N, F] round-trips through device memory
// of an unfused bias add, self-term combine and activation disappear: the
// kernel reads self and bias once and writes y (and the mask) once.
// α is read from a 1-element device tensor, as the TPU reads it from
// SMEM: GIN's α = 1 + eps is a parameter, and reading it on the host
// would stall every step. What bounds it is the SpMM's X traffic
// (bsr_common.cuh); the epilogue adds 2-3 [N, F] streams.
//
// The spec is static, as on the TPU: one kernel per (tile, has_self,
// has_bias, relu), selected at launch.

#include "bsr_common.cuh"

namespace {

template <int BR, int BC>
cudaError_t launch_spec(const bsr::Args& a, int spec) {
  switch (spec) {
    case 0: return bsr::launch<BR, BC, false, false, false, false>(a);
    case 1: return bsr::launch<BR, BC, false, false, false, true>(a);
    case 2: return bsr::launch<BR, BC, false, false, true, false>(a);
    case 3: return bsr::launch<BR, BC, false, false, true, true>(a);
    case 4: return bsr::launch<BR, BC, false, true, false, false>(a);
    case 5: return bsr::launch<BR, BC, false, true, false, true>(a);
    case 6: return bsr::launch<BR, BC, false, true, true, false>(a);
    case 7: return bsr::launch<BR, BC, false, true, true, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Y[n_block_rows*br, f] = act(A·X + α·self + bias). rows, cols, blocks, x
// as in bsr_spmm_f32; self float32 [n_block_rows*br, f] (has_self), bias
// float32 [f] (has_bias), alpha float32 [1] on the device (has_self), mask
// float32 [n_block_rows*br, f] written 0/1 (relu); unused pointers may be
// null. Launches on `stream` and returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a tile that is not instantiated).
extern "C" int bsr_spmm_fused_f32(const void* rows, const void* cols,
                                  const void* blocks, const void* x,
                                  const void* self, const void* bias,
                                  const void* alpha, void* y, void* mask,
                                  int n_blocks, int n_block_rows, int f,
                                  int br, int bc, int has_self, int has_bias,
                                  int relu, void* stream) {
  if (n_block_rows == 0 || f == 0) return 0;
  bsr::Args a{};
  a.rows = static_cast<const int*>(rows);
  a.cols = static_cast<const int*>(cols);
  a.blocks = static_cast<const float*>(blocks);
  a.x = static_cast<const float*>(x);
  a.self = static_cast<const float*>(self);
  a.bias = static_cast<const float*>(bias);
  a.alpha = static_cast<const float*>(alpha);
  a.y = static_cast<float*>(y);
  a.mask_out = static_cast<float*>(mask);
  a.n_blocks = n_blocks;
  a.n_block_rows = n_block_rows;
  a.f = f;
  a.stream = static_cast<cudaStream_t>(stream);
  const int spec = (has_self ? 4 : 0) | (has_bias ? 2 : 0) | (relu ? 1 : 0);
#define BSR_FUSED_TILE(R, C) \
  if (br == R && bc == C) return static_cast<int>(launch_spec<R, C>(a, spec));
  BSR_FOR_EACH_TILE(BSR_FUSED_TILE)
#undef BSR_FUSED_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
