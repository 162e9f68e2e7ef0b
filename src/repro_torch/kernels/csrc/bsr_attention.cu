// Edge-softmax attention over a BSR adjacency for Hopper (sm_90a): the
// forward and the two passes of its recompute backward, in float32 (no
// TF32, no tensor cores; expf and IEEE division, as the Pallas kernels'
// preferred_element_type=f32).
//
// Replaces the Pallas TPU kernels of repro/kernels/bsr_attention.py:
//   bsr_attention_fwd      (_attn_fwd_kernel :56, pallas_call :133),
//                          over A's nonzero columns
//   bsr_attention_bwd_row  (_attn_bwd_row_kernel :144, pallas_call :190),
//                          over A's nonzero columns
//   bsr_attention_bwd_col  (_attn_bwd_col_kernel :202, pallas_call :267),
//                          over Aᵀ's nonzero columns
// Per head h, over the nonzeros of the adjacency:
//   pre_ij = adst_ih + asrc_jh, s_ij = leaky_relu(pre_ij, 0.2)
//   forward:  out_i = Σ_j p_ij z_j / l_i, p = exp(s - m_i), l_i = Σ_j p_ij
//   row pass: dc_i  = Σ_j dpre_ij
//   col pass: dzv_j = Σ_i att_ij dy_i, dd_j = Σ_i dpre_ij   (over Aᵀ)
//   att = exp(s - m_i) / max(l_i, 1e-20), dpre = att (dy_i·z_j - r_i) lrelu'
// z and dy are head-major [rows, H*Dh]; adst, asrc, m, l, r, dc, dd [rows, H].
//
// Translation of the sequential TPU grid: the Pallas kernels walk the
// block stream in order and keep a block-row's output tiles in VMEM from
// first_in_row to last_in_row. Here every kernel walks its operand's
// nonzero columns (kernels/bsr_spmm.py:NonzeroColumns, the operand the
// SpMM kernels of bsr_nzc.cuh read): one CTA per work item (block_row,
// begin, end, slot), longest first. An item is a whole block-row (slot
// -1), or one segment of SPLIT_COLUMNS columns of a longer row (a hub),
// which writes its partial result to its slot; a second pass adds a split
// row's slots in segment order (attn_fwd_reduce, attn_bwd_row_reduce,
// attn_bwd_col_reduce). A column is its source (or, over Aᵀ, its
// destination) x_rows[c] and the BR mask values of the block-row's rows
// (values != 0). No block is read and no atomics are used: every sum has
// a fixed order, so results are bitwise repeatable. An empty block-row
// keeps an empty item, which writes zeros. One CTA covers the whole
// H·Dh width of its block-row (wider than 256·V it walks its columns
// once per 256·V-wide tile).
//
// Column groups (forward and column pass). A thread owns V elements of
// the width (V·BR accumulators, V at most 32 / BR). Where H·Dh needs fewer
// than the CTA's 256 threads, the threads form groups of the fewest (a
// power of two from a warp) that cover it, and group q takes columns q,
// q + groups, ... of each chunk; after the walk the groups' sums are
// added in group order through shared memory. So a narrow width keeps as
// many columns in flight as a wide one (H·Dh = 39: 8 groups of a warp;
// 750: one group of 256 threads, V = 3).
//
// Forward (attn_fwd_kernel): scores need only scalars, so a first walk of
// the item's columns (source row, mask bits and asrc staged in chunks)
// takes each (row, head)'s exact max, warp per pair; the second computes
// p = exp(s - m) for the chunk's (column, row, head) in shared memory (0
// off the mask: exp(NEG_INF - NEG_INF) = 1 never counts), l = Σ p per
// pair, and the aggregate: each thread reads its elements of z_j once per
// column of its group, four columns' loads issued before their FMAs, rows
// off the mask skipped. A segment writes its unnormalised (acc, m, l); the second pass
// merges the slots by the online-softmax rule (m = max m_s, l = Σ l_s
// e^{m_s - m}, out = Σ acc_s e^{m_s - m} / l), a slot with l_s = 0 adding
// nothing.
//
// Column pass (attn_bwd_col_kernel): a CTA's rows are BR sources j, its
// columns the destinations i. Per chunk, the destinations' adst, m, l, r
// are staged, and att and w = att·lrelu' computed for each (column, row,
// head). A thread owns elements of the width as in the forward and reads
// dy_i's elements once per column, accumulating dzv_j += att·dy_i and
// g_j += w·dy_i. Since Σ_i w (dy_i·z_j) = z_j·Σ_i w dy_i, the dots are
// taken once per item, after the walk: dd_j = Σ_{d∈h} z_j[d] g_j[d] -
// Σ_i w r_i, z_j's elements read from device memory once.
//
// Row pass (attn_bwd_row_kernel): a CTA stages its block-row's dy rows and
// statistics once, then walks its span, warp per column: for each of the
// column's nonzero rows, the dot dy_i·z_j per head, its lanes strided over
// Dh, and dpre added to the warp's partial dc (PERF.md: 8 warps, one
// column a warp in flight, the set bits only, were the fastest).
//
// What bounds them. The arithmetic per nonzero and head is a score, an
// exp and 2·Dh FMAs (4·Dh in the column pass): far below the card's fp32
// rate. The least bytes are the z / dy rows the nonzeros reference and
// the statistics, once: one z row (forward, row pass) or dy row (column
// pass) per nonzero column, ~3 KB at H·Dh = 750, ~4 GB a call on the
// ogbn-arxiv analog, of which L2 (50 MB) keeps little. That row stream,
// gathered at random, is what the wide calls wait on; the rest of an item
// (staging, scores, the output rows) overlaps it only as far as other
// CTAs are resident. At narrow widths the rows stay in L2 and the rounds
// of dependent loads set the pace, which the column groups cut.

#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;  // repro/kernels/bsr_attention.py:36
constexpr float kSlope = 0.2f;
constexpr float kFloor = 1e-20f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // columns whose z / dy loads issue together
constexpr int kMaxChunk = 256;      // columns staged per chunk
constexpr int kChunkFloats = 8192;  // shared memory a chunk may take (32 KB)
constexpr int kRowChunk = 256;      // the row pass's columns per chunk
constexpr size_t kMaxSmem = 227 * 1024;  // a CTA's shared memory on an H100
// CTAs an SM holds, as the register cap __launch_bounds__ sets: more
// CTAs resident overlap one item's walk with another's staging. On an
// H100 at H·Dh = 750, 4 made the forward fastest of 2, 3 and 4, and 3 the
// column pass (at 4 its 48 accumulators a thread spill)
constexpr int kFwdCtas = 4;
constexpr int kColCtas = 3;

__device__ __forceinline__ float leaky(float pre) {
  return pre >= 0.0f ? pre : kSlope * pre;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bit r: row r of column c holds a nonzero (its BR values, 16-byte aligned).
template <int BR>
__device__ __forceinline__ unsigned column_bits(const float* __restrict__ values,
                                                int c) {
  const float4* v = reinterpret_cast<const float4*>(values + static_cast<size_t>(c) * BR);
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < BR / 4; ++q) {
    const float4 t = __ldg(v + q);
    bits |= (t.x != 0.0f ? 1u : 0u) << (4 * q);
    bits |= (t.y != 0.0f ? 2u : 0u) << (4 * q);
    bits |= (t.z != 0.0f ? 4u : 0u) << (4 * q);
    bits |= (t.w != 0.0f ? 8u : 0u) << (4 * q);
  }
  return bits;
}

// Stages columns [c0, c0 + n) of the item: each column's row x_rows[c],
// its mask bits and `k` of its per-head statistics (stat[0..k), each
// [rows, H]) into s_stat[i][k][H]. The caller synchronises.
template <int BR>
__device__ __forceinline__ void stage_columns(int c0, int n,
                                              const int* __restrict__ x_rows,
                                              const float* __restrict__ values,
                                              const float* const* stat, int k,
                                              int heads, int* s_col,
                                              unsigned* s_bits, float* s_stat) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = __ldg(x_rows + c0 + i);
    s_col[i] = j;
    s_bits[i] = column_bits<BR>(values, c0 + i);
    float* dst = s_stat + i * k * heads;
    for (int s = 0; s < k; ++s) {
      const float* src = stat[s] + static_cast<size_t>(j) * heads;
      for (int h = 0; h < heads; ++h) dst[s * heads + h] = __ldg(src + h);
    }
  }
}

// Per pair q < hp (warp per pair, lanes strided over the chunk's n
// columns, an xor-shuffle sum): Σ_i a[i·hp + q]·(b ? b[i·bstride + q % H] : 1),
// added to acc[q] in chunk order. Fixed order: bitwise repeatable.
__device__ __forceinline__ void pair_sums(const float* a, const float* b,
                                          int bstride, int n, int hp,
                                          int heads, float* acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = warp; q < hp; q += kWarps) {
    const int h = q % heads;
    float v = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float x = a[i * hp + q];
      v += b ? x * b[i * bstride + h] : x;
    }
    v = warp_sum(v);
    if (lane == 0) acc[q] += v;
  }
}

// A thread's place in a width tile. The CTA's threads form column groups
// of `gs` threads (kThreads / gs groups); group `grp` takes the chunk's
// columns grp, grp + groups, ... and its thread `gl` the tile's elements
// c = k·gs + gl, e = w0 + c (k < V): a tile is gs·V wide.
template <int V>
struct Elems {
  int gs, grp, groups, gl, tw;
  int e[V];
  int h[V];   // its head
  bool on[V];
  __device__ __forceinline__ Elems(int w0, int hd, int dh, int group) {
    gs = group;
    grp = threadIdx.x / gs;
    groups = kThreads / gs;
    gl = threadIdx.x - grp * gs;
    tw = gs * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      e[k] = w0 + k * gs + gl;
      on[k] = e[k] < hd;
      h[k] = on[k] ? e[k] / dh : 0;
    }
  }
  // the slot of (group q, row r, tile element c) in a [groups][BR][tw] buffer
  __device__ __forceinline__ int at(int q, int r, int c, int br) const {
    return (q * br + r) * tw + c;
  }
};

// acc[k][r] += wt[i·hp + r·H + h_k]·x_i[e_k] over the group's columns of
// the chunk, in column order, rows off the column's mask skipped (uniform
// over the group); kUnroll columns' loads issued before their FMAs. With
// TWO, also g[k][r] += wt2[...]·x_i[e_k].
template <int BR, int V, bool TWO>
__device__ __forceinline__ void accumulate(float (&acc)[V][BR], float (&g)[V][BR],
                                           const Elems<V>& el,
                                           const float* __restrict__ x,
                                           const int* s_col, const unsigned* s_bits,
                                           const float* wt, const float* wt2,
                                           int n, int hp, int heads, int hd) {
  const int step = el.groups;
  for (int i0 = el.grp; i0 < n; i0 += step * kUnroll) {
    float xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step;
      const size_t base = i < n ? static_cast<size_t>(s_col[i]) * hd : 0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xv[u][k] = i < n && el.on[k] ? __ldg(x + base + el.e[k]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step;
      if (i >= n) break;
      const unsigned bits = s_bits[i];
      const float* w = wt + i * hp;
      const float* w2 = wt2 + i * hp;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if (!((bits >> r) & 1u)) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int o = r * heads + el.h[k];
          acc[k][r] = fmaf(w[o], xv[u][k], acc[k][r]);
          if (TWO) g[k][r] = fmaf(w2[o], xv[u][k], g[k][r]);
        }
      }
    }
  }
}

// The groups' partial sums of a tile, acc[k][r], stored to s_red
// [groups][BR][tw]; the caller synchronises, then sums each (r, c) over
// the groups in group order (group_sum).
template <int BR, int V>
__device__ __forceinline__ void store_partials(const float (&acc)[V][BR],
                                               const Elems<V>& el, float* s_red) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int r = 0; r < BR; ++r) s_red[el.at(el.grp, r, k * el.gs + el.gl, BR)] = acc[k][r];
  }
}

template <int BR, int V>
__device__ __forceinline__ float group_sum(const Elems<V>& el, const float* s_red,
                                           int r, int c) {
  float v = s_red[el.at(0, r, c, BR)];
  for (int q = 1; q < el.groups; ++q) v += s_red[el.at(q, r, c, BR)];
  return v;
}

// Columns a chunk stages: as many as kChunkFloats holds at `per_col`
// floats a column, 16 to kMaxChunk.
inline int chunk_columns(int per_col) {
  int c = kChunkFloats / per_col;
  return c < 16 ? 16 : (c > kMaxChunk ? kMaxChunk : c);
}

// ---------------------------------------------------------------------------
// Forward over A's nonzero columns: out, m, l
// ---------------------------------------------------------------------------

template <int BR, int V>
__global__ void __launch_bounds__(kThreads, kFwdCtas)
attn_fwd_kernel(const int4* __restrict__ items, const int* __restrict__ x_rows,
                const float* __restrict__ values, float* __restrict__ partial,
                const float* __restrict__ adst, const float* __restrict__ asrc,
                const float* __restrict__ z, float* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out,
                int heads, int dh, int chunk, int gs) {
  extern __shared__ __align__(16) float dyn[];
  const int hd = heads * dh, hp = heads * BR;
  const size_t stride = static_cast<size_t>(BR) * hd + 2 * hp;  // a slot
  float* s_ad = dyn;                 // [BR][H] the block-row's adst
  float* s_m = s_ad + hp;            // [BR][H] the item's max
  float* s_l = s_m + hp;             // [BR][H] Σ p
  int* s_col = reinterpret_cast<int*>(s_l + hp);                  // [chunk]
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_col + chunk);  // [chunk]
  float* s_as = reinterpret_cast<float*>(s_bits + chunk);         // [chunk][H]
  float* s_p = s_as + chunk * heads;                              // [chunk][BR][H]
  float* s_red = reinterpret_cast<float*>(s_col);  // after a tile: [groups][BR][tw]

  const int4 item = __ldg(items + blockIdx.x);
  const int begin = item.y, end = item.z, slot = item.w;
  const size_t row_base = static_cast<size_t>(item.x) * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int q = tid; q < hp; q += kThreads) {
    s_ad[q] = __ldg(adst + row_base * heads + q);
    s_m[q] = kNegInf;
    s_l[q] = 0.0f;
  }
  const float* stat[1] = {asrc};
  // walk 1: the exact max of each (row, head) over the item's nonzeros
  for (int c0 = begin; c0 < end; c0 += chunk) {
    const int n = min(chunk, end - c0);
    __syncthreads();
    stage_columns<BR>(c0, n, x_rows, values, stat, 1, heads, s_col, s_bits, s_as);
    __syncthreads();
    for (int q = warp; q < hp; q += kWarps) {
      const int r = q / heads, h = q % heads;
      const float ad = s_ad[q];
      float mx = kNegInf;
      for (int i = lane; i < n; i += 32) {
        if ((s_bits[i] >> r) & 1u) mx = fmaxf(mx, leaky(ad + s_as[i * heads + h]));
      }
      mx = warp_max(mx);
      if (lane == 0) s_m[q] = fmaxf(s_m[q], mx);
    }
  }
  // walk 2, per width tile: p, l and the aggregate; a single chunk stays
  // staged from walk 1 where one tile covers the width
  const bool restage = end - begin > chunk || hd > gs * V;
  for (int w0 = 0; w0 < hd; w0 += gs * V) {
    const Elems<V> el(w0, hd, dh, gs);
    float acc[V][BR];
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[k][r] = 0.0f;
    }
    for (int c0 = begin; c0 < end; c0 += chunk) {
      const int n = min(chunk, end - c0);
      __syncthreads();  // s_m final; the previous chunk's reads done
      if (restage) {
        stage_columns<BR>(c0, n, x_rows, values, stat, 1, heads, s_col, s_bits, s_as);
        __syncthreads();
      }
      for (int t = tid; t < n * hp; t += kThreads) {
        const int i = t / hp, q = t - i * hp;
        const int r = q / heads, h = q - r * heads;
        float p = 0.0f;
        if ((s_bits[i] >> r) & 1u) p = expf(leaky(s_ad[q] + s_as[i * heads + h]) - s_m[q]);
        s_p[t] = p;
      }
      __syncthreads();
      if (w0 == 0) pair_sums(s_p, nullptr, 0, n, hp, heads, s_l);
      accumulate<BR, V, false>(acc, acc, el, z, s_col, s_bits, s_p, s_p, n, hp,
                               heads, hd);
    }
    __syncthreads();  // s_l complete, the chunk area free
    if (el.groups > 1) {  // the groups' sums added in group order
      store_partials<BR, V>(acc, el, s_red);
      __syncthreads();
      for (int t = tid; t < BR * el.tw; t += kThreads) {
        const int r = t / el.tw, c = t - r * el.tw, e = w0 + c;
        if (e >= hd) continue;
        const float v = group_sum<BR, V>(el, s_red, r, c);
        if (slot < 0) {
          out[(row_base + r) * hd + e] = v / fmaxf(s_l[r * heads + e / dh], kFloor);
        } else {
          partial[slot * stride + r * hd + e] = v;
        }
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!el.on[k]) continue;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if (slot < 0) {
          out[(row_base + r) * hd + el.e[k]] =
              acc[k][r] / fmaxf(s_l[r * heads + el.h[k]], kFloor);
        } else {
          partial[slot * stride + r * hd + el.e[k]] = acc[k][r];
        }
      }
    }
  }
  // m clamped to 0 on rows without a nonzero; a segment keeps its raw (m, l)
  for (int q = tid; q < hp; q += kThreads) {
    if (slot < 0) {
      m_out[row_base * heads + q] = s_l[q] > 0.0f ? s_m[q] : 0.0f;
      l_out[row_base * heads + q] = s_l[q];
    } else {
      float* ml = partial + slot * stride + BR * hd;
      ml[q] = s_m[q];
      ml[hp + q] = s_l[q];
    }
  }
}

// The split rows' second pass of the forward, one CTA a row (blockIdx.x of
// `splits`, (block_row, first_slot, n_slots)): the segments' (acc, m, l)
// merged in segment order by the online-softmax rule; a segment in which
// a (row, head) has no nonzero (l_s = 0, m_s = NEG_INF) adds nothing.
__global__ void __launch_bounds__(kThreads)
attn_fwd_reduce(const int* __restrict__ splits, const float* __restrict__ partial,
                float* __restrict__ out, float* __restrict__ m_out,
                float* __restrict__ l_out, int heads, int dh, int br) {
  extern __shared__ __align__(16) float dyn[];
  const int hd = heads * dh, hp = heads * br;
  const size_t stride = static_cast<size_t>(br) * hd + 2 * hp;
  float* s_m = dyn;
  float* s_l = dyn + hp;
  const size_t brow = static_cast<size_t>(__ldg(splits + 3 * blockIdx.x));
  const float* part = partial + static_cast<size_t>(__ldg(splits + 3 * blockIdx.x + 1)) * stride;
  const int n = __ldg(splits + 3 * blockIdx.x + 2);
  const int ml = br * hd;
  for (int q = threadIdx.x; q < hp; q += kThreads) {
    float m = kNegInf;
    for (int s = 0; s < n; ++s) {
      if (__ldg(part + s * stride + ml + hp + q) > 0.0f)
        m = fmaxf(m, __ldg(part + s * stride + ml + q));
    }
    float l = 0.0f;
    for (int s = 0; s < n; ++s) {
      const float ls = __ldg(part + s * stride + ml + hp + q);
      if (ls > 0.0f) l += ls * expf(__ldg(part + s * stride + ml + q) - m);
    }
    s_m[q] = m;
    s_l[q] = l;
    m_out[brow * hp + q] = l > 0.0f ? m : 0.0f;
    l_out[brow * hp + q] = l;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < br * hd; t += kThreads) {
    const int r = t / hd;
    const int q = r * heads + (t - r * hd) / dh;
    float v = 0.0f;
    for (int s = 0; s < n; ++s) {
      if (__ldg(part + s * stride + ml + hp + q) > 0.0f)
        v += __ldg(part + s * stride + t) * expf(__ldg(part + s * stride + ml + q) - s_m[q]);
    }
    out[brow * br * hd + t] = v / fmaxf(s_l[q], kFloor);
  }
}

// ---------------------------------------------------------------------------
// Backward, row pass over A's nonzero columns: dc
// ---------------------------------------------------------------------------

// One work item of A's NonzeroColumns a CTA (blockIdx.x): the block-row's
// BR dy rows and statistics staged once, then its span of nonzero columns,
// staged in chunks (source row and mask bits), warp w taking columns w,
// w + 8, ... in order. Per head, groups of 2^lanes_log2 lanes (the head
// width rounded up to a power of two, at most a warp) each take one head
// of the column, and for each of its nonzero rows i in row order the dot
// dy_i·z_j over that head's slice of z_j, its lanes strided over Dh with
// 8 loads issued before their FMAs and an xor-shuffle sum; the group's
// first lane adds dpre_ij to its warp's partial dc[i][h] in shared
// memory. A column of ogbn-arxiv's A holds one nonzero on average
// (1,320,039 nonzeros in 1,319,816 columns), so the walk visits set bits
// only. After the span the warps' partials are added in warp order, into
// dc (a whole row, slot -1) or into the item's slot of `partial` (a
// segment of a split row), which attn_bwd_row_reduce adds up.
template <int BR>
__global__ void __launch_bounds__(kThreads)
attn_bwd_row_kernel(const int4* __restrict__ items,
                    const int* __restrict__ x_rows,
                    const float* __restrict__ values,
                    float* __restrict__ partial,
                    const float* __restrict__ adst,
                    const float* __restrict__ asrc,
                    const float* __restrict__ z, const float* __restrict__ dy,
                    const float* __restrict__ r_in,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in, float* __restrict__ dc,
                    int heads, int dh, int lanes_log2, int vec4) {
  extern __shared__ __align__(16) float row_dyn[];
  const int hd = heads * dh;
  const int hp = heads * BR;
  float* s_dy = row_dyn;         // [BR][H*Dh] the block-row's dy rows
  float* s_ad = s_dy + BR * hd;  // [BR][H] each row statistic
  float* s_m = s_ad + hp;
  float* s_l = s_m + hp;
  float* s_r = s_l + hp;
  float* s_part = s_r + hp;      // [warps][BR][H] the warps' partial dc
  __shared__ int s_col[kRowChunk];
  __shared__ unsigned s_bits[kRowChunk];

  const int4 item = __ldg(items + blockIdx.x);
  const int begin = item.y, end = item.z, slot = item.w;
  const size_t row_base = static_cast<size_t>(item.x) * BR;
  const int tid = threadIdx.x;
  if (end > begin) {
    const float* dy_rows = dy + row_base * hd;  // BR rows, contiguous
    if (vec4) {
      const float4* src = reinterpret_cast<const float4*>(dy_rows);
      for (int e = tid; e < BR * hd / 4; e += kThreads)
        reinterpret_cast<float4*>(s_dy)[e] = __ldg(src + e);
    } else {
      for (int e = tid; e < BR * hd; e += kThreads) s_dy[e] = __ldg(dy_rows + e);
    }
    for (int e = tid; e < hp; e += kThreads) {
      const size_t i = row_base * heads + e;
      s_ad[e] = __ldg(adst + i);
      s_m[e] = __ldg(m_in + i);
      s_l[e] = fmaxf(__ldg(l_in + i), kFloor);
      s_r[e] = __ldg(r_in + i);
    }
  }
  for (int e = tid; e < kWarps * hp; e += kThreads) s_part[e] = 0.0f;

  const int warp = tid >> 5, lane = tid & 31;
  const int width = 1 << lanes_log2;  // lanes of one dot
  const int subs = 32 >> lanes_log2;  // heads a warp takes at once
  const int sub = lane >> lanes_log2, sl = lane & (width - 1);
  float* my_part = s_part + warp * hp;

  for (int c0 = begin; c0 < end; c0 += kRowChunk) {
    const int n = min(kRowChunk, end - c0);
    __syncthreads();  // the staging above, or the previous chunk's reads
    for (int i = tid; i < n; i += kThreads) {
      s_col[i] = __ldg(x_rows + c0 + i);
      s_bits[i] = column_bits<BR>(values, c0 + i);
    }
    __syncthreads();
    for (int c = warp; c < n; c += kWarps) {
      const unsigned bits = s_bits[c];
      const size_t j = static_cast<size_t>(s_col[c]);
      for (int h0 = 0; h0 < heads; h0 += subs) {
        const int h = h0 + sub;
        const bool on = h < heads;
        const float as = on ? __ldg(asrc + j * heads + h) : 0.0f;
        const float* zr = z + j * hd + h * dh;
        // the column's nonzero rows (one, nearly always), in row order
        for (unsigned b = bits; b; b &= b - 1u) {
          const int r = __ffs(b) - 1;
          const float* dyr = s_dy + r * hd + h * dh;
          float dot = 0.0f;
          for (int d0 = sl; d0 < dh; d0 += 8 * width) {
            float zv[8];
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const int d = d0 + width * t;
              zv[t] = on && d < dh ? __ldg(zr + d) : 0.0f;
            }
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const int d = d0 + width * t;
              dot = fmaf(zv[t], on && d < dh ? dyr[d] : 0.0f, dot);
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            if (o < width) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          }
          if (on && sl == 0) {
            const int e = r * heads + h;
            const float pre = s_ad[e] + as;
            const float att = expf(leaky(pre) - s_m[e]) / s_l[e];
            my_part[e] += att * (dot - s_r[e]) * (pre >= 0.0f ? 1.0f : kSlope);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < hp; e += kThreads) {
    float v = s_part[e];
    for (int w = 1; w < kWarps; ++w) v += s_part[w * hp + e];
    if (slot < 0) {
      dc[row_base * heads + e] = v;
    } else {
      partial[static_cast<size_t>(slot) * hp + e] = v;
    }
  }
}

// A split row's slots (splits[blockIdx.x] = (block_row, first_slot,
// n_slots), `stride` floats each) added in segment order: the first `a_n`
// floats of a slot into a[block_row·a_n ...], the next `b_n` into b.
__device__ __forceinline__ void add_slots(const int* __restrict__ splits,
                                          const float* __restrict__ partial,
                                          size_t stride, float* __restrict__ a,
                                          int a_n, float* __restrict__ b, int b_n) {
  const size_t brow = static_cast<size_t>(__ldg(splits + 3 * blockIdx.x));
  const float* part = partial + static_cast<size_t>(__ldg(splits + 3 * blockIdx.x + 1)) * stride;
  const int n = __ldg(splits + 3 * blockIdx.x + 2);
  for (int t = threadIdx.x; t < a_n + b_n; t += kThreads) {
    float v = __ldg(part + t);
    for (int s = 1; s < n; ++s) v += __ldg(part + s * stride + t);
    if (t < a_n) {
      a[brow * a_n + t] = v;
    } else {
      b[brow * b_n + t - a_n] = v;
    }
  }
}

// The row pass's second pass: a split row's partial dc.
__global__ void __launch_bounds__(kThreads)
attn_bwd_row_reduce(const int* __restrict__ splits,
                    const float* __restrict__ partial, float* __restrict__ dc,
                    int hp) {
  add_slots(splits, partial, hp, dc, hp, nullptr, 0);
}

// Shared memory of the row pass: the dy rows, four statistics and the
// warps' partials.
inline size_t row_smem(int heads, int dh, int br) {
  return sizeof(float) * (static_cast<size_t>(br) * heads * dh +
                          static_cast<size_t>(4 + kWarps) * heads * br);
}

// ---------------------------------------------------------------------------
// Backward, column pass over Aᵀ's nonzero columns: dzv, dd (a CTA's rows
// are sources j, its columns destinations i)
// ---------------------------------------------------------------------------

template <int BR, int V>
__global__ void __launch_bounds__(kThreads, kColCtas)
attn_bwd_col_kernel(const int4* __restrict__ items, const int* __restrict__ x_rows,
                    const float* __restrict__ values, float* __restrict__ partial,
                    const float* __restrict__ asrc, const float* __restrict__ adst,
                    const float* __restrict__ z, const float* __restrict__ dy,
                    const float* __restrict__ r_in, const float* __restrict__ m_in,
                    const float* __restrict__ l_in, float* __restrict__ dzv,
                    float* __restrict__ dd, int heads, int dh, int chunk, int gs) {
  extern __shared__ __align__(16) float dyn[];
  const int hd = heads * dh, hp = heads * BR;
  const size_t stride = static_cast<size_t>(BR) * hd + hp;  // a slot
  float* s_as = dyn;           // [BR][H] the sources' asrc
  float* s_c = s_as + hp;      // [BR][H] Σ_i w r_i
  float* s_dot = s_c + hp;     // [BR][H] Σ_d z_j g_j
  float* region = s_dot + hp;  // a chunk's columns, or a tile's partials
  int* s_col = reinterpret_cast<int*>(region);                    // [chunk]
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_col + chunk);  // [chunk]
  float* s_dst = reinterpret_cast<float*>(s_bits + chunk);        // [chunk][4][H]
  float* s_att = s_dst + chunk * 4 * heads;                       // [chunk][BR][H]
  float* s_w = s_att + chunk * hp;                                // [chunk][BR][H]
  float* s_red = region;                                          // [groups][BR][tw]

  const int4 item = __ldg(items + blockIdx.x);
  const int begin = item.y, end = item.z, slot = item.w;
  const size_t row_base = static_cast<size_t>(item.x) * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int q = tid; q < hp; q += kThreads) {
    s_as[q] = __ldg(asrc + row_base * heads + q);
    s_c[q] = 0.0f;
    s_dot[q] = 0.0f;
  }
  // the destination's adst, m, l, r per column
  const float* stat[4] = {adst, m_in, l_in, r_in};
  const int h4 = 4 * heads;
  for (int w0 = 0; w0 < hd; w0 += gs * V) {
    const Elems<V> el(w0, hd, dh, gs);
    float acc[V][BR], g[V][BR];
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[k][r] = g[k][r] = 0.0f;
    }
    for (int c0 = begin; c0 < end; c0 += chunk) {
      const int n = min(chunk, end - c0);
      __syncthreads();  // the previous chunk's or tile's reads done
      stage_columns<BR>(c0, n, x_rows, values, stat, 4, heads, s_col, s_bits, s_dst);
      __syncthreads();
      for (int t = tid; t < n * hp; t += kThreads) {
        const int i = t / hp, q = t - i * hp;
        const int r = q / heads, h = q - r * heads;
        float att = 0.0f, w = 0.0f;
        if ((s_bits[i] >> r) & 1u) {
          const float* st = s_dst + i * h4;
          const float pre = s_as[q] + st[h];
          att = expf(leaky(pre) - st[heads + h]) / fmaxf(st[2 * heads + h], kFloor);
          w = att * (pre >= 0.0f ? 1.0f : kSlope);
        }
        s_att[t] = att;
        s_w[t] = w;
      }
      __syncthreads();
      if (w0 == 0) pair_sums(s_w, s_dst + 3 * heads, h4, n, hp, heads, s_c);
      accumulate<BR, V, true>(acc, g, el, dy, s_col, s_bits, s_att, s_w, n, hp,
                              heads, hd);
    }
    const int tw = el.tw;
    __syncthreads();  // the chunk area is free
    // the tile's products z_j·g_j, [BR][tw]: with several groups their g
    // added in group order first, in group 0's place
    if (el.groups > 1) {
      store_partials<BR, V>(g, el, s_red);
      __syncthreads();
      for (int t = tid; t < BR * tw; t += kThreads) {
        const int r = t / tw, c = t - r * tw, e = w0 + c;
        float prod = 0.0f;
        if (e < hd) prod = group_sum<BR, V>(el, s_red, r, c) * __ldg(z + (row_base + r) * hd + e);
        s_red[r * tw + c] = prod;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          s_red[r * tw + k * el.gs + el.gl] =
              el.on[k] ? g[k][r] * __ldg(z + (row_base + r) * hd + el.e[k]) : 0.0f;
        }
      }
    }
    __syncthreads();
    // per (row, head): the tile's slice of the head, warp per pair
    for (int q = warp; q < hp; q += kWarps) {
      const int r = q / heads, h = q - r * heads;
      const int lo = max(h * dh, w0) - w0, hi = min((h + 1) * dh, w0 + tw) - w0;
      float v = 0.0f;
      for (int d = lo + lane; d < hi; d += 32) v += s_red[r * tw + d];
      v = warp_sum(v);
      if (lane == 0) s_dot[q] += v;
    }
    __syncthreads();
    // dzv (or the slot's), several groups' partials added in group order
    float* dst = slot < 0 ? dzv + row_base * hd : partial + slot * stride;
    if (el.groups > 1) {
      store_partials<BR, V>(acc, el, s_red);
      __syncthreads();
      for (int t = tid; t < BR * tw; t += kThreads) {
        const int r = t / tw, c = t - r * tw, e = w0 + c;
        if (e < hd) dst[r * hd + e] = group_sum<BR, V>(el, s_red, r, c);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!el.on[k]) continue;
#pragma unroll
      for (int r = 0; r < BR; ++r) dst[r * hd + el.e[k]] = acc[k][r];
    }
  }
  for (int q = tid; q < hp; q += kThreads) {
    const float v = s_dot[q] - s_c[q];
    if (slot < 0) {
      dd[row_base * heads + q] = v;
    } else {
      partial[slot * stride + BR * hd + q] = v;
    }
  }
}

// The column pass's second pass: a split row's partial dzv and dd.
__global__ void __launch_bounds__(kThreads)
attn_bwd_col_reduce(const int* __restrict__ splits,
                    const float* __restrict__ partial, float* __restrict__ dzv,
                    float* __restrict__ dd, int hd, int hp, int br) {
  add_slots(splits, partial, static_cast<size_t>(br) * hd + hp, dzv, br * hd, dd, hp);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline bool shape_ok(int heads, int dh, int br) {
  return heads > 0 && dh > 0 && (br == 8 || br == 16);
}

// The column groups' width and the elements V a thread owns: the fewest
// threads a group (a power of two from a warp to the CTA) whose V, at most
// 32 / BR (V·BR accumulators a thread, twice that in the column pass),
// cover H·Dh, so narrow heads get the most groups; wider than the CTA's
// 256·V, one group and several tiles.
struct Groups {
  int gs, v;
};

inline Groups groups(int hd, int br) {
  const int most = 32 / br;
  int gs = 32;
  while (gs < kThreads && (hd + gs - 1) / gs > most) gs *= 2;
  const int need = (hd + gs - 1) / gs;
  return {gs, need < most ? need : most};
}

// Floats of a CTA's chunk area: `chunk` columns at `per_col` floats, or
// the groups' partials of a tile, [groups][BR][gs·v].
inline size_t region_floats(int chunk, int per_col, int br, int v) {
  const size_t cols = static_cast<size_t>(chunk) * per_col;
  const size_t tile = static_cast<size_t>(br) * kThreads * v;
  return cols > tile ? cols : tile;
}

}  // namespace attn

// Every entry takes an operand's NonzeroColumns (kernels/bsr_spmm.py):
// items int32 [n_items, 4] (16-byte aligned), splits int32 [n_split, 3],
// x_rows int32 [n], values float32 [n, br] (16-byte aligned), and partial,
// float32 scratch for its split rows' slots (null when n_split is 0). All
// pointers are device pointers, float32 operands row-major as in the
// header comment. Each launches its kernel on `stream`, and the split
// rows' ordered second pass where n_split > 0, and returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape it does not take (br other than 8 or 16, or shared memory beyond a
// CTA's).

// The forward over A's columns: adst [n_block_rows·br, heads] on A's
// rows, asrc and z on its columns; out, m, l on its rows; partial
// [n_slots, br·(heads·dh + 2·heads)].
extern "C" int bsr_attention_fwd_f32(const void* items, int n_items,
                                     const void* splits, int n_split,
                                     const void* x_rows, const void* values,
                                     void* partial, const void* adst,
                                     const void* asrc, const void* z, void* out,
                                     void* m, void* l, int heads, int dh, int br,
                                     void* stream) {
  if (!attn::shape_ok(heads, dh, br)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  const int hp = heads * br;
  const int per_col = 2 + heads + hp;
  const int chunk = attn::chunk_columns(per_col);
  const attn::Groups g = attn::groups(heads * dh, br);
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(hp) +
                                       attn::region_floats(chunk, per_col, br, g.v));
  if (smem > attn::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define ATTN_FWD(BR, V)                                                        \
  if (br == BR && g.v == V) {                                                  \
    cudaError_t e = attn::set_smem(attn::attn_fwd_kernel<BR, V>, smem);        \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    attn::attn_fwd_kernel<BR, V><<<n_items, attn::kThreads, smem, s>>>(        \
        static_cast<const int4*>(items), static_cast<const int*>(x_rows),      \
        static_cast<const float*>(values), static_cast<float*>(partial),       \
        static_cast<const float*>(adst), static_cast<const float*>(asrc),      \
        static_cast<const float*>(z), static_cast<float*>(out),                \
        static_cast<float*>(m), static_cast<float*>(l), heads, dh, chunk, g.gs); \
  }
  ATTN_FWD(8, 1)
  ATTN_FWD(8, 2)
  ATTN_FWD(8, 3)
  ATTN_FWD(8, 4)
  ATTN_FWD(16, 1)
  ATTN_FWD(16, 2)
#undef ATTN_FWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
  attn::attn_fwd_reduce<<<n_split, attn::kThreads, 2 * hp * sizeof(float), s>>>(
      static_cast<const int*>(splits), static_cast<const float*>(partial),
      static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(l),
      heads, dh, br);
  return static_cast<int>(cudaGetLastError());
}

// The row pass over A's columns: adst, dy, r, m, l on A's rows, asrc and z
// on its columns; dc [n_block_rows·br, heads]; partial [n_slots, br,
// heads]. vec4: dy is 16-byte aligned. cudaErrorInvalidValue also where
// the dy rows do not fit in shared memory.
extern "C" int bsr_attention_bwd_row_f32(const void* items, int n_items,
                                         const void* splits, int n_split,
                                         const void* x_rows,
                                         const void* values, void* partial,
                                         const void* adst, const void* asrc,
                                         const void* z, const void* dy,
                                         const void* r, const void* m,
                                         const void* l, void* dc, int heads,
                                         int dh, int br, int vec4,
                                         void* stream) {
  if (!attn::shape_ok(heads, dh, br)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  const size_t smem = attn::row_smem(heads, dh, br);
  if (smem > attn::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < dh && lanes_log2 < 5) ++lanes_log2;
  auto s = static_cast<cudaStream_t>(stream);
#define ATTN_ROW(BR)                                                           \
  {                                                                            \
    cudaError_t e = attn::set_smem(attn::attn_bwd_row_kernel<BR>, smem);       \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    attn::attn_bwd_row_kernel<BR><<<n_items, attn::kThreads, smem, s>>>(       \
        static_cast<const int4*>(items), static_cast<const int*>(x_rows),      \
        static_cast<const float*>(values), static_cast<float*>(partial),       \
        static_cast<const float*>(adst), static_cast<const float*>(asrc),      \
        static_cast<const float*>(z), static_cast<const float*>(dy),           \
        static_cast<const float*>(r), static_cast<const float*>(m),            \
        static_cast<const float*>(l), static_cast<float*>(dc), heads, dh,      \
        lanes_log2, vec4);                                                     \
  }
  if (br == 8) {
    ATTN_ROW(8)
  } else {
    ATTN_ROW(16)
  }
#undef ATTN_ROW
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
  attn::attn_bwd_row_reduce<<<n_split, attn::kThreads, 0, s>>>(
      static_cast<const int*>(splits), static_cast<const float*>(partial),
      static_cast<float*>(dc), heads * br);
  return static_cast<int>(cudaGetLastError());
}

// The column pass over Aᵀ's columns: asrc and z on Aᵀ's rows (the
// sources), adst, dy, r, m, l on its columns (the destinations); dzv, dd
// on its rows; partial [n_slots, br·(heads·dh + heads)].
extern "C" int bsr_attention_bwd_col_f32(const void* items, int n_items,
                                         const void* splits, int n_split,
                                         const void* x_rows,
                                         const void* values, void* partial,
                                         const void* asrc, const void* adst,
                                         const void* z, const void* dy,
                                         const void* r, const void* m,
                                         const void* l, void* dzv, void* dd,
                                         int heads, int dh, int br,
                                         void* stream) {
  if (!attn::shape_ok(heads, dh, br)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  const int hp = heads * br;
  const int per_col = 2 + 4 * heads + 2 * hp;
  const int chunk = attn::chunk_columns(per_col);
  const attn::Groups g = attn::groups(heads * dh, br);
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(hp) +
                                       attn::region_floats(chunk, per_col, br, g.v));
  if (smem > attn::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define ATTN_COL(BR, V)                                                        \
  if (br == BR && g.v == V) {                                                  \
    cudaError_t e = attn::set_smem(attn::attn_bwd_col_kernel<BR, V>, smem);    \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    attn::attn_bwd_col_kernel<BR, V><<<n_items, attn::kThreads, smem, s>>>(    \
        static_cast<const int4*>(items), static_cast<const int*>(x_rows),      \
        static_cast<const float*>(values), static_cast<float*>(partial),       \
        static_cast<const float*>(asrc), static_cast<const float*>(adst),      \
        static_cast<const float*>(z), static_cast<const float*>(dy),           \
        static_cast<const float*>(r), static_cast<const float*>(m),            \
        static_cast<const float*>(l), static_cast<float*>(dzv),                \
        static_cast<float*>(dd), heads, dh, chunk, g.gs);                      \
  }
  ATTN_COL(8, 1)
  ATTN_COL(8, 2)
  ATTN_COL(8, 3)
  ATTN_COL(8, 4)
  ATTN_COL(16, 1)
  ATTN_COL(16, 2)
#undef ATTN_COL
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
  attn::attn_bwd_col_reduce<<<n_split, attn::kThreads, 0, s>>>(
      static_cast<const int*>(splits), static_cast<const float*>(partial),
      static_cast<float*>(dzv), static_cast<float*>(dd), heads * dh, hp, br);
  return static_cast<int>(cudaGetLastError());
}
