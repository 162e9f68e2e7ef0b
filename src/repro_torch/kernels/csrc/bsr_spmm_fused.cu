// Fused-epilogue BSR SpMM for Hopper (sm_90a):
//   Y = act(A·X + α·self + bias), and with ReLU also mask = (pre > 0).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py:
// bsr_spmm_fused_epilogue (_make_fused_kernel at :118, pallas_call at
// :245). The TPU walks A's 8x128 blocks and applies the epilogue in VMEM
// at last_in_row. Here the CTA that owns a block-row (or a segment of a
// hub row) walks only the row's block columns that hold a nonzero
// (bsr_nzc.cuh): a full-graph 8x128 block of ogbn-arxiv's A holds ~1.4
// nonzeros, so reading whole blocks moved ~90x the X rows the product
// needs. The epilogue is applied in registers after the row loop (or
// after the split rows' second pass), so the three [N, F] round-trips
// through device memory of an unfused bias add, self-term combine and
// activation disappear: the kernel reads self and bias once and writes y
// (and the mask) once. α is read from a 1-element device tensor, as the
// TPU reads it from SMEM: GIN's α = 1 + eps is a parameter, and reading
// it on the host would stall every step. What bounds it is the X row
// gathers, one per nonzero column (bsr_nzc.cuh); the epilogue adds 2-3
// [N, F] streams.
//
// The spec is static, as on the TPU: one kernel per (BR, vector width,
// has_self, has_bias, relu), selected at launch.

#include "bsr_nzc.cuh"

namespace {

template <int BR>
cudaError_t launch_spec(const nzc::Args& a, int spec) {
  switch (spec) {
    case 0: return nzc::launch<BR, false, false, false, false>(a);
    case 1: return nzc::launch<BR, false, false, false, true>(a);
    case 2: return nzc::launch<BR, false, false, true, false>(a);
    case 3: return nzc::launch<BR, false, false, true, true>(a);
    case 4: return nzc::launch<BR, false, true, false, false>(a);
    case 5: return nzc::launch<BR, false, true, false, true>(a);
    case 6: return nzc::launch<BR, false, true, true, false>(a);
    case 7: return nzc::launch<BR, false, true, true, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Y[n_block_rows*br, f] = act(A·X + α·self + bias) over A's nonzero
// columns (kernels/bsr_spmm.py:NonzeroColumns): items int32 [n_items, 4]
// (16-byte aligned), splits int32 [n_split, 3], x_rows int32 [n], values
// float32 [n, br] (16-byte aligned);
// partial float32 [n_slots, br, f] scratch (null when n_split is 0); x
// float32 [*, f] row-major; self float32 [n_block_rows*br, f] (has_self),
// bias float32 [f] (has_bias), alpha float32 [1] on the device
// (has_self), mask float32 [n_block_rows*br, f] written 0/1 (relu);
// unused pointers may be null. vec4: f % 4 == 0 and every feature pointer
// 16-byte aligned. Launches the row pass, and the split rows' ordered
// second pass where n_split > 0, on `stream`; returns cudaGetLastError()
// after them (cudaErrorInvalidValue for a br that is not instantiated).
extern "C" int bsr_spmm_fused_f32(const void* items, int n_items,
                                  const void* splits, int n_split,
                                  const void* x_rows, const void* values,
                                  void* partial, const void* x,
                                  const void* self, const void* bias,
                                  const void* alpha, void* y, void* mask,
                                  int f, int br, int vec4, int has_self,
                                  int has_bias, int relu, void* stream) {
  if (n_items == 0 || f == 0) return 0;
  nzc::Args a{};
  a.items = static_cast<const int4*>(items);
  a.splits = static_cast<const int*>(splits);
  a.x_rows = static_cast<const int*>(x_rows);
  a.values = static_cast<const float*>(values);
  a.partial = static_cast<float*>(partial);
  a.x = static_cast<const float*>(x);
  a.self = static_cast<const float*>(self);
  a.bias = static_cast<const float*>(bias);
  a.alpha = static_cast<const float*>(alpha);
  a.y = static_cast<float*>(y);
  a.mask_out = static_cast<float*>(mask);
  a.n_items = n_items;
  a.n_split = n_split;
  a.f = f;
  a.vec4 = vec4 != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  const int spec = (has_self ? 4 : 0) | (has_bias ? 2 : 0) | (relu ? 1 : 0);
#define BSR_FUSED_BR(R) \
  if (br == R) return static_cast<int>(launch_spec<R>(a, spec));
  NZC_FOR_EACH_BR(BSR_FUSED_BR)
#undef BSR_FUSED_BR
  return static_cast<int>(cudaErrorInvalidValue);
}
