// The nonzero-column row loop for Hopper (sm_90a), the one SpMM loop of
// the port, shared by bsr_spmm.cu, bsr_spmm_fused.cu and
// bsr_spmm_masked.cu: Y = act(A·(M ⊙ X) + α·self + bias) in float32 over
// the stream of A's block columns that hold a nonzero
// (kernels/bsr_spmm.py:nonzero_columns), not over the blocks. Each entry
// file wraps the loop's two passes (row_pass, split_pass) in kernels of
// its own names: nzc_kernel / nzc_split_reduce for the fused-epilogue and
// masked kernels, bsr_spmm_kernel / bsr_spmm_reduce for the plain product.
//
// The operand, built once per BSR operand on the device: for each column
// in stream order (block, then column k within it) the X row
// block_col·bc + k it multiplies (x_rows) and its BR values, contiguous
// (values); and the CTAs' work list (items), one (block_row, begin, end,
// slot) per CTA, longest span first. A block column with no nonzero gives
// no entry, so the sampler's zero padding tail and the explicit zero
// block of an empty block-row give none: the loop has no padding branch.
// The block-column width BC does not reach the kernel; BR does, as a
// template argument.
//
// Translation of the sequential TPU grid. The Pallas kernels walk the
// block stream in order on one core and carry each block-row's output
// tile in VMEM from first_in_row to last_in_row. Here one CTA owns one
// (item, feature tile) and loops over the item's columns itself; an item
// is a whole block-row (slot -1), whose epilogue the CTA applies after
// the loop, in registers, or one segment of a block-row longer than
// kernels/bsr_spmm.py:SPLIT_COLUMNS (a hub), whose partial sums the CTA
// writes to its slot. A second pass (nzc_split_reduce) adds each split
// row's partials in segment order and applies the epilogue. Nothing is
// summed across CTAs but in that fixed order: no atomics, and results are
// bitwise repeatable run to run. The longest items start first, so the
// hub's segments run beside the many short rows instead of after them.
//
// What bounds it. Each column costs one X row read (with MASKED, the mask
// row beside it, applied on load, so mask ⊙ dY is never written), its BR
// values and BR FMAs per feature: the bytes are those of a CSR product
// with BR rows per pointer, so the kernel is bound by its X row gathers
// (~1 KB a column at F=256, scattered over X; twice that with the mask).
// The stored zeros inside a kept column are multiplied too (~1.4 of a
// column's 8 values are nonzero on ogbn-arxiv's A).
//
// Design: 64 threads in groups of `lanes` (a power of two, 1..32, the
// feature vectors a group needs, up to a warp); a lane holds V features (4
// with float4 loads where F % 4 == 0 and every row is 16-byte aligned,
// else 1) and BR·V accumulators. Chunks of the item's columns (values and
// X rows, 8 KB) are staged in shared memory by the whole CTA; group g
// takes columns g, g + groups, ... of the item in that order, issuing
// kUnroll columns' X loads before their FMAs. After the loop each group's
// partial sums go to shared memory, and row r of the block is finished by
// group r % groups, which adds the groups' partials in group order. F is
// never padded: the ragged edge is masked per lane. Small CTAs and few
// loads a batch keep registers at ~72 and ~14 CTAs on an SM: a mean row of
// ogbn-arxiv's A holds 62 columns, so latency, not issue, sets the pace,
// and an H100 sweep of CTA size (32-256 threads), loads a batch (2-16)
// and split (256-4096 columns) found 64, 4 and 1024 the fastest on its
// arxiv calls.
//
// Numbers: for finite X the sum holds the same nonzero terms as the BSR
// product over whole blocks, in another order. A non-finite X: these
// kernels give the sparse product. An X row that no nonzero of A
// multiplies is never read, so an inf or NaN in it reaches no output:
// the answer of the JAX package's gather backend (a segment sum over the
// edges, repro/backends/gather.py) and of cuSPARSE's CSR, not the Pallas
// kernel's, whose dot multiplies the row by its block's stored zeros and
// gives NaN there (so do the port's plain versions, kernels/ref.py). A row
// that a nonzero multiplies is read for its whole block column, so its inf
// or NaN reaches that nonzero's output row, as on every backend, and the
// other rows of the block through their stored zeros (0·inf = NaN).
#pragma once

#include <cuda_runtime.h>

namespace nzc {

constexpr int kThreads = 64;
constexpr int kStageFloats = 2048;  // column values staged per chunk (8 KB)
constexpr int kUnroll = 4;          // columns whose X loads issue together

// Every operand of one launch. Pointers are device pointers; those a
// kernel's flags do not use may be null.
struct Args {
  const int4* items;     // [n_items] (block_row, begin, end, slot)
  const int* splits;     // [n_split, 3] (block_row, first_slot, n_slots)
  const int* x_rows;     // [n_columns]
  const float* values;   // [n_columns, BR]
  float* partial;        // [n_slots, BR, f]: the split rows' segments
  const float* x;        // [*, f] row-major
  const float* mask_in;  // MASKED: shaped like x, applied to x on load
  const float* self;     // HAS_SELF: [n_block_rows*BR, f]
  const float* bias;     // HAS_BIAS: [f]
  const float* alpha;    // HAS_SELF: 1 element, read on the device
  float* y;              // [n_block_rows*BR, f]
  float* mask_out;       // RELU: [n_block_rows*BR, f], 0/1
  int n_items;
  int n_split;
  int f;
  bool vec4;  // F % 4 == 0 and every feature pointer 16-byte aligned
  cudaStream_t stream;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// The epilogue of one output element vector at y[i], in the reference's
// order and roundings: (acc + α·self) + bias, then the ReLU and its 0/1
// mask. The ReLU keeps a NaN, as jnp.maximum and torch.relu do (fmaxf
// would map it to 0); its mask is 0 there (NaN > 0 is false). ACCUM (the
// plain product's accumulate mode, y += A·X) adds the sum to what y holds
// first: y[i] + acc, as the plain version's `out + bsr_spmm_ref(...)`.
// y[i] is read by plain loads, not __ldg: this launch writes it.
template <int V, bool HAS_SELF, bool HAS_BIAS, bool RELU, bool ACCUM = false>
__device__ __forceinline__ void finish(float (&out)[V], size_t i, float a,
                                       const float (&b)[V],
                                       const float* __restrict__ self,
                                       float* __restrict__ y,
                                       float* __restrict__ mask_out) {
  float s[V], m[V];
  if (HAS_SELF) load<V>(self + i, s);
  if constexpr (ACCUM) {
    float prev[V];
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(y + i);
      prev[0] = t.x;
      prev[1] = t.y;
      prev[2] = t.z;
      prev[3] = t.w;
    } else {
      prev[0] = y[i];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = __fadd_rn(prev[v], out[v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (HAS_SELF) out[v] = __fadd_rn(out[v], __fmul_rn(a, s[v]));
    if (HAS_BIAS) out[v] = __fadd_rn(out[v], b[v]);
    if (RELU) {
      m[v] = out[v] > 0.0f ? 1.0f : 0.0f;
      out[v] = out[v] > 0.0f || out[v] != out[v] ? out[v] : 0.0f;
    }
  }
  if (RELU) store<V>(mask_out + i, m);
  store<V>(y + i, out);
}

// The row pass over one work item, the CTA's whole body: blockIdx.x the
// item, blockIdx.y the feature tile of 2^lanes_log2 vectors. ACCUM adds
// the item's sum to y instead of storing it (finish): a host-streamed
// strip's items (runtime/streaming.py) add into the caller's y, since a
// strip boundary can cut a block-row in two. Strips run in order on one
// stream and a launch owns each row once, so no atomics are needed.
template <int BR, int V, bool MASKED, bool HAS_SELF, bool HAS_BIAS,
          bool RELU, bool ACCUM = false>
__device__ __forceinline__ void row_pass(
    const int4* __restrict__ items, const int* __restrict__ x_rows,
    const float* __restrict__ values, float* __restrict__ partial,
    const float* __restrict__ x, const float* __restrict__ mask_in,
    const float* __restrict__ self, const float* __restrict__ bias,
    const float* __restrict__ alpha, float* __restrict__ y,
    float* __restrict__ mask_out, int f, int lanes_log2) {
  static_assert(BR % 4 == 0, "a column's values are staged as float4");
  constexpr int kChunk = kStageFloats / BR;  // columns staged per chunk
  // the staged values during the loop, the groups' partial sums after it
  constexpr int kPartFloats = kThreads * BR * V;
  constexpr int kBufFloats =
      kPartFloats > kStageFloats ? kPartFloats : kStageFloats;
  __shared__ __align__(16) float s_buf[kBufFloats];
  __shared__ int s_row[kChunk];

  const int lanes = 1 << lanes_log2;
  const int groups = kThreads >> lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x >> lanes_log2;
  const int4 item = __ldg(items + blockIdx.x);
  const int brow = item.x, begin = item.y, end = item.z, slot = item.w;
  const int feat = (blockIdx.y * lanes + lane) * V;
  const bool active = feat < f;

  float acc[BR][V];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;
  }

  for (int c0 = begin; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    const float4* src =
        reinterpret_cast<const float4*>(values + static_cast<size_t>(c0) * BR);
    float4* dst = reinterpret_cast<float4*>(s_buf);
    for (int i = threadIdx.x; i < n * (BR / 4); i += kThreads) {
      dst[i] = __ldg(src + i);
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_row[i] = __ldg(x_rows + c0 + i);
    }
    __syncthreads();
    if (active) {
      for (int j = group; j < n; j += groups * kUnroll) {
        float xv[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = j + u * groups;
#pragma unroll
          for (int v = 0; v < V; ++v) xv[u][v] = 0.0f;
          if (c < n) {
            const size_t off = static_cast<size_t>(s_row[c]) * f + feat;
            load<V>(x + off, xv[u]);
            if (MASKED) {
              float m[V];
              load<V>(mask_in + off, m);
#pragma unroll
              for (int v = 0; v < V; ++v) xv[u][v] *= m[v];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = j + u * groups;
          if (c < n) {
            const float4* a = reinterpret_cast<const float4*>(s_buf + c * BR);
#pragma unroll
            for (int q = 0; q < BR / 4; ++q) {
              const float4 a4 = a[q];
              const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  acc[4 * q + i][v] = fmaf(av[i], xv[u][v], acc[4 * q + i][v]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk, or the partials, overwrite s_buf
  }

  // Each group's partial sums, laid out [group][r][v][lane] so that a
  // group's lanes touch consecutive banks.
#pragma unroll
  for (int r = 0; r < BR; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s_buf[((group * BR + r) * V + v) * lanes + lane] = acc[r][v];
    }
  }
  __syncthreads();
  if (!active) return;
  // Row r is finished by group r % groups: the groups' partials added in
  // group order, then the epilogue, or the segment's sum to its slot.
  const float a = HAS_SELF ? __ldg(alpha) : 0.0f;
  float b[V];
  if (HAS_BIAS) load<V>(bias + feat, b);
  for (int r = group; r < BR; r += groups) {
    float out[V];
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = s_buf[(r * V + v) * lanes + lane];
    for (int g = 1; g < groups; ++g) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        out[v] =
            __fadd_rn(out[v], s_buf[((g * BR + r) * V + v) * lanes + lane]);
      }
    }
    if (slot >= 0) {
      store<V>(partial + (static_cast<size_t>(slot) * BR + r) * f + feat, out);
    } else {
      finish<V, HAS_SELF, HAS_BIAS, RELU, ACCUM>(
          out, (static_cast<size_t>(brow) * BR + r) * f + feat, a, b, self,
          y, mask_out);
    }
  }
}

// The second pass over the split rows, one CTA a row (blockIdx.x): add
// its segments' partial sums in segment order and apply the epilogue
// (ACCUM: add the sum to y, as row_pass).
template <int BR, int V, bool HAS_SELF, bool HAS_BIAS, bool RELU,
          bool ACCUM = false>
__device__ __forceinline__ void split_pass(
    const int* __restrict__ splits, const float* __restrict__ partial,
    const float* __restrict__ self, const float* __restrict__ bias,
    const float* __restrict__ alpha, float* __restrict__ y,
    float* __restrict__ mask_out, int f) {
  const int brow = __ldg(splits + 3 * blockIdx.x);
  const int first = __ldg(splits + 3 * blockIdx.x + 1);
  const int n = __ldg(splits + 3 * blockIdx.x + 2);
  const int vectors = (f + V - 1) / V;
  const float a = HAS_SELF ? __ldg(alpha) : 0.0f;
  for (int e = threadIdx.x; e < BR * vectors; e += kThreads) {
    const int r = e / vectors;
    const int feat = (e % vectors) * V;
    float out[V], b[V];
    load<V>(partial + (static_cast<size_t>(first) * BR + r) * f + feat, out);
    for (int s = 1; s < n; ++s) {
      float p[V];
      load<V>(partial + (static_cast<size_t>(first + s) * BR + r) * f + feat,
              p);
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = __fadd_rn(out[v], p[v]);
    }
    if (HAS_BIAS) load<V>(bias + feat, b);
    finish<V, HAS_SELF, HAS_BIAS, RELU, ACCUM>(
        out, (static_cast<size_t>(brow) * BR + r) * f + feat, a, b, self, y,
        mask_out);
  }
}

// A group's lanes for F, as log2: the feature vectors F needs, rounded up
// to a power of two, at most a warp; wider F takes more CTAs along y.
inline int lanes_log2_for(int f, int v) {
  const int vectors = (f + v - 1) / v;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < vectors && lanes_log2 < 5) ++lanes_log2;
  return lanes_log2;
}

inline dim3 grid_for(int n_items, int f, int v, int lanes_log2) {
  const int vectors = (f + v - 1) / v;
  const int lanes = 1 << lanes_log2;
  return dim3(n_items, (vectors + lanes - 1) / lanes);
}

template <int BR, int V, bool MASKED, bool HAS_SELF, bool HAS_BIAS,
          bool RELU>
__global__ void __launch_bounds__(kThreads)
nzc_kernel(const int4* __restrict__ items, const int* __restrict__ x_rows,
           const float* __restrict__ values, float* __restrict__ partial,
           const float* __restrict__ x, const float* __restrict__ mask_in,
           const float* __restrict__ self, const float* __restrict__ bias,
           const float* __restrict__ alpha, float* __restrict__ y,
           float* __restrict__ mask_out, int f, int lanes_log2) {
  row_pass<BR, V, MASKED, HAS_SELF, HAS_BIAS, RELU>(
      items, x_rows, values, partial, x, mask_in, self, bias, alpha, y,
      mask_out, f, lanes_log2);
}

// MASKED is not read; it keeps the kernel's name apart from the fused
// kernel's.
template <int BR, int V, bool MASKED, bool HAS_SELF, bool HAS_BIAS,
          bool RELU>
__global__ void __launch_bounds__(kThreads)
nzc_split_reduce(const int* __restrict__ splits,
                 const float* __restrict__ partial,
                 const float* __restrict__ self,
                 const float* __restrict__ bias,
                 const float* __restrict__ alpha, float* __restrict__ y,
                 float* __restrict__ mask_out, int f) {
  split_pass<BR, V, HAS_SELF, HAS_BIAS, RELU>(splits, partial, self, bias,
                                             alpha, y, mask_out, f);
}

template <int BR, int V, bool MASKED, bool HAS_SELF, bool HAS_BIAS,
          bool RELU>
cudaError_t launch_v(const Args& a) {
  const int lanes_log2 = lanes_log2_for(a.f, V);
  nzc_kernel<BR, V, MASKED, HAS_SELF, HAS_BIAS, RELU>
      <<<grid_for(a.n_items, a.f, V, lanes_log2), kThreads, 0, a.stream>>>(
          a.items, a.x_rows, a.values, a.partial, a.x, a.mask_in, a.self,
          a.bias, a.alpha, a.y, a.mask_out, a.f, lanes_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 0) return err;
  nzc_split_reduce<BR, V, MASKED, HAS_SELF, HAS_BIAS, RELU>
      <<<a.n_split, kThreads, 0, a.stream>>>(a.splits, a.partial, a.self,
                                             a.bias, a.alpha, a.y,
                                             a.mask_out, a.f);
  return cudaGetLastError();
}

template <int BR, bool MASKED, bool HAS_SELF, bool HAS_BIAS, bool RELU>
cudaError_t launch(const Args& a) {
  return a.vec4 ? launch_v<BR, 4, MASKED, HAS_SELF, HAS_BIAS, RELU>(a)
                : launch_v<BR, 1, MASKED, HAS_SELF, HAS_BIAS, RELU>(a);
}

}  // namespace nzc

// The block heights every entry instantiates (kernels/bsr_spmm.py:BUILT_BR).
#define NZC_FOR_EACH_BR(X) X(8) X(16)
