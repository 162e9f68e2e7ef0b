// Block-sparse-row SpMM for Hopper (sm_90a): Y = A·X in float32.
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py:bsr_spmm
// (_kernel at :50, pallas_call at :105). The TPU walks A's blocks and
// multiplies each whole (BR, BC) block by BC rows of X. Here the CTA that
// owns a block-row (or a segment of a hub row) walks only the row's block
// columns that hold a nonzero (bsr_nzc.cuh's loop, with no mask and no
// epilogue: the fused kernel's spec 0), and a second pass adds the split
// rows' segments in order. A full-graph 8x128 block of ogbn-arxiv holds
// ~1.4 nonzeros, so reading whole blocks moved ~90x the X rows the
// product needs. The operand's nonzero columns are built once per
// full-batch operand (Aᵀ of training; X and Xᵀ of the Alg-1 sparse layer
// 0) and once per batch and layer on the sampled path
// (kernels/ops.py:bsr_spmm_pair: A in the forward, Aᵀ in the backward
// of training), where the sampler's zero padding
// tail gives no column, so the loop needs no padding branch. What bounds
// it is the X row gathers, one per nonzero column, and on the feature
// operands (~1.2 nonzeros a column, thousands of columns a row) the
// column stream itself (36 bytes a column at BR=8). The loop's shape (64
// threads, power-of-two lanes, 4 columns' loads a batch, 8 KB chunks
// staged synchronously, split at 1,024) is the fused kernel's: at this
// slice's narrow widths (F = 32, 40, 70) an H100 sweep of 2 or 8 loads a
// batch, cp.async double-buffered chunks and splits of 256 or 4,096 found
// none faster, and lanes sized exactly to F (F=40: 6 groups of 10, not 4
// of 16) gained a little at F=40 but cost the shared loop registers and
// slowed the masked kernel, so they were dropped. The kernels carry names
// of their own, so a profile tells them from the fused kernel's spec 0.
//
// The accumulate mode (bsr_spmm_accum_f32, the kernels' ACCUM flag): Y +=
// A·X, each output row read and added to by the CTA that owns it. It is
// what a host-streamed strip launches (runtime/streaming.py): a budget cut
// can split a block-row between two strips, and the JAX package computes
// its strips with the scatter-add oracle for that reason. Strips launch in
// order on one stream, so the sum needs no atomics; a strip's column
// stream keeps only the block-rows it touches, so a pass over S strips
// reads and writes each row of Y once a strip that touches it, in S short
// launches (their times: PERF.md §6).

#include "bsr_nzc.cuh"

namespace {

// ACCUM: y += A·X (the accumulate mode of a host-streamed strip,
// runtime/streaming.py); else y = A·X.
template <int BR, int V, bool ACCUM>
__global__ void __launch_bounds__(nzc::kThreads)
bsr_spmm_kernel(const int4* __restrict__ items, const int* __restrict__ x_rows,
                const float* __restrict__ values, float* __restrict__ partial,
                const float* __restrict__ x, float* __restrict__ y, int f,
                int lanes_log2) {
  nzc::row_pass<BR, V, false, false, false, false, ACCUM>(
      items, x_rows, values, partial, x, nullptr, nullptr, nullptr, nullptr,
      y, nullptr, f, lanes_log2);
}

template <int BR, int V, bool ACCUM>
__global__ void __launch_bounds__(nzc::kThreads)
bsr_spmm_reduce(const int* __restrict__ splits,
                const float* __restrict__ partial, float* __restrict__ y,
                int f) {
  nzc::split_pass<BR, V, false, false, false, ACCUM>(
      splits, partial, nullptr, nullptr, nullptr, y, nullptr, f);
}

template <int BR, int V, bool ACCUM>
cudaError_t launch(const nzc::Args& a) {
  const int lanes_log2 = nzc::lanes_log2_for(a.f, V);
  bsr_spmm_kernel<BR, V, ACCUM>
      <<<nzc::grid_for(a.n_items, a.f, V, lanes_log2), nzc::kThreads, 0,
         a.stream>>>(a.items, a.x_rows, a.values, a.partial, a.x, a.y, a.f,
                     lanes_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 0) return err;
  bsr_spmm_reduce<BR, V, ACCUM><<<a.n_split, nzc::kThreads, 0, a.stream>>>(
      a.splits, a.partial, a.y, a.f);
  return cudaGetLastError();
}

template <bool ACCUM>
int entry(const void* items, int n_items, const void* splits, int n_split,
          const void* x_rows, const void* values, void* partial,
          const void* x, void* y, int f, int br, int vec4, void* stream) {
  if (n_items == 0 || f == 0) return 0;
  nzc::Args a{};
  a.items = static_cast<const int4*>(items);
  a.splits = static_cast<const int*>(splits);
  a.x_rows = static_cast<const int*>(x_rows);
  a.values = static_cast<const float*>(values);
  a.partial = static_cast<float*>(partial);
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.n_items = n_items;
  a.n_split = n_split;
  a.f = f;
  a.stream = static_cast<cudaStream_t>(stream);
#define BSR_SPMM_BR(R)                                                  \
  if (br == R)                                                          \
    return static_cast<int>(vec4 ? launch<R, 4, ACCUM>(a)               \
                                 : launch<R, 1, ACCUM>(a));
  NZC_FOR_EACH_BR(BSR_SPMM_BR)
#undef BSR_SPMM_BR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Y[n_block_rows*br, f] = A·X over A's nonzero columns
// (kernels/bsr_spmm.py:NonzeroColumns): items, splits, x_rows, values and
// partial as in bsr_spmm_fused_f32; x float32 [*, f] row-major. vec4: f %
// 4 == 0 and x 16-byte aligned. Launches the row pass, and the split
// rows' ordered second pass where n_split > 0, on `stream`; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for a br that is
// not instantiated).
extern "C" int bsr_spmm_f32(const void* items, int n_items, const void* splits,
                            int n_split, const void* x_rows,
                            const void* values, void* partial, const void* x,
                            void* y, int f, int br, int vec4, void* stream) {
  return entry<false>(items, n_items, splits, n_split, x_rows, values,
                      partial, x, y, f, br, vec4, stream);
}

// Y += A·X, the accumulate mode, with bsr_spmm_f32's arguments: each
// output row an item (or a split row's second pass) owns is read, added
// to and written once, so the strips of one operand, launched in order on
// one stream, sum into y in strip order. A block-row with no item is left
// as it is; an empty item adds zero.
extern "C" int bsr_spmm_accum_f32(const void* items, int n_items,
                                  const void* splits, int n_split,
                                  const void* x_rows, const void* values,
                                  void* partial, const void* x, void* y,
                                  int f, int br, int vec4, void* stream) {
  return entry<true>(items, n_items, splits, n_split, x_rows, values,
                     partial, x, y, f, br, vec4, stream);
}
