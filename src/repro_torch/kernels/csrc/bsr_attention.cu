// Edge-softmax attention over a BSR adjacency for Hopper (sm_90a): the
// forward and the two passes of its recompute backward, in float32 (no
// TF32, no tensor cores; expf and IEEE division, as the Pallas kernels'
// preferred_element_type=f32).
//
// Replaces the Pallas TPU kernels of repro/kernels/bsr_attention.py:
//   bsr_attention_fwd      (_attn_fwd_kernel :56, pallas_call :133)
//   bsr_attention_bwd_row  (_attn_bwd_row_kernel :144, pallas_call :190)
//   bsr_attention_bwd_col  (_attn_bwd_col_kernel :202, pallas_call :267)
// Per head h, over the nonzero pattern of each 8x128 (BRxBC) block:
//   pre_ij = adst_ih + asrc_jh, s_ij = leaky_relu(pre_ij, 0.2)
//   forward:  out_i = Σ_j p_ij z_j / l_i, p = exp(s - m), online (m, l)
//   row pass: dc_i  = Σ_j dpre_ij
//   col pass: dzv_j = Σ_i att_ij dy_i, dd_j = Σ_i dpre_ij   (over Aᵀ)
//   att = exp(s - m_i) / max(l_i, 1e-20), dpre = att (dy_i·z_j - r_i) lrelu'
// z and dy are head-major [rows, H*Dh]; adst, asrc, m, l, r, dc, dd [rows, H].
//
// Translation of the sequential TPU grid, as in bsr_common.cuh: the Pallas
// kernels walk the stream in order and keep a block-row's output tiles in
// VMEM from first_in_row to last_in_row. Here each CTA owns one (block-row,
// column tile), finds the row's blocks by a device-side binary search over
// the sorted block_rows, loops over them itself, and finalises after the
// loop; first_in_row and last_in_row are not read. It stops at the first
// block-column that does not increase (the sampler's zero padding tail).
// Nothing crosses CTAs: no atomics, a fixed summation order, bitwise
// repeatable results.
//
// Per block, warp 0 reads the BRxBC values and lists the block's columns
// that hold a nonzero, in column order, with a bitmask of their rows (and,
// for the backward passes, the nonzeros themselves); only those columns'
// z / dy rows and statistics are read, and a block with no nonzero
// (padding, the explicit zero block of an empty row) is skipped. A
// full-graph 8x128 block holds ~1.4 nonzeros, so this reads ~1.4 z rows a
// block where the Pallas kernel's dense tile product reads 128; zero terms
// add nothing, so the result is the dense product's.
//
// Roles inside a CTA (blockDim is a multiple of 32, at least H·BR):
//  * thread t < H·BR owns the pair (head t / BR, row t % BR): the online
//    softmax recurrence of the forward (running m, l in registers; the
//    rescale factor exp(m_prev - m_new) to shared memory; p re-masked so a
//    fully masked row's exp(NEG_INF - NEG_INF) = 1 never counts), and the
//    dc / dd sums of the backward, sequentially over the active columns;
//  * thread c < H·Dh of the tile owns output column c (head c / Dh): BR
//    accumulators for out (forward) or dzv (col pass), one coalesced z / dy
//    element per active column;
//  * the backward's Dh-long dots dy_i·z_j are taken by one warp per
//    (nonzero, head), lanes strided over Dh, reduced by xor shuffles; the
//    row pass runs 256 threads, so 8 dots of a row at a time.
// Loads that do not depend on each other are issued together (8 per lane
// in a dot, 4 columns in an accumulation): in a loop that waited on each
// load in turn, the ogbn-arxiv analog's hub row made the row pass 230 ms
// a call on an H100 where it now takes 30 (PERF.md).
// The col pass needs dd's dots over the whole head width but dzv only its
// tile: column tile 0 does both, other tiles dzv alone, in one launch.
//
// What bounds it. The arithmetic per nonzero and head is a score, an exp
// and 2·Dh FMAs (4·Dh in the col pass): far below the card's fp32 rate.
// The least bytes are the used blocks, their indices and the z / dy rows
// and statistics they reference, once. Each column tile re-reads the row's
// blocks, and a block's three dependent steps (values, then the active
// columns' statistics, then their z rows) sit between three barriers, so
// a CTA's row is a latency-bound serial chain. The longest sets a call's
// floor: on the ogbn-arxiv analog, A's in-degree hub row (1,323 blocks,
// 17,433 nonzeros) alone takes 12 ms of a 29 ms forward and 18 ms of a
// 30 ms row pass (PERF.md).

#include "bsr_common.cuh"

namespace attn {

constexpr float kNegInf = -1e30f;  // repro/kernels/bsr_attention.py:36
constexpr float kSlope = 0.2f;
constexpr float kFloor = 1e-20f;
constexpr int kMaxBR = 16;
constexpr int kMaxBC = 128;
constexpr int kMaxThreads = 256;

// The current block's nonzero columns, in column order, and (for the
// backward passes) its nonzeros as (active column, row) pairs.
struct Stage {
  int n;                   // columns holding a nonzero
  int n_pairs;             // nonzeros
  int k[kMaxBC];           // their tile column
  unsigned bits[kMaxBC];   // bit r: row r of the column is a nonzero
  unsigned short pair[kMaxBR * kMaxBC];  // (index into k) << 4 | row
};

__device__ __forceinline__ float leaky(float pre) {
  return pre >= 0.0f ? pre : kSlope * pre;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp 0 lists block `blk`'s nonzero columns into `st` and, for each, calls
// per_col(pos, k) so the caller can stage that column's statistics; with
// PAIRS, it also lists the nonzeros, column by column. The caller
// synchronises before reading `st`.
template <int BR, bool PAIRS, typename PerCol>
__device__ __forceinline__ void stage_block(const float* __restrict__ blk,
                                            int bc, Stage& st,
                                            PerCol per_col) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int base = 0; base < bc; base += 32) {
    const int k = base + lane;
    unsigned bits = 0;
    if (k < bc) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        bits |= (__ldg(blk + r * bc + k) != 0.0f ? 1u : 0u) << r;
      }
    }
    const unsigned vote = __ballot_sync(0xffffffffu, bits != 0);
    if (bits) {
      const int pos = n + __popc(vote & below);
      st.k[pos] = k;
      st.bits[pos] = bits;
      per_col(pos, k);
    }
    n += __popc(vote);
  }
  if (lane == 0) st.n = n;
  if (!PAIRS) return;
  __syncwarp();
  int n_pairs = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const unsigned bits = i < n ? st.bits[i] : 0u;
    // exclusive prefix of the nonzero counts over the warp's columns
    const int cnt = __popc(bits);
    int scan = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, scan, o);
      if (lane >= o) scan += v;
    }
    int out = n_pairs + scan - cnt;
    for (unsigned b = bits; b; b &= b - 1u) {
      st.pair[out++] = static_cast<unsigned short>((i << 4) | (__ffs(b) - 1));
    }
    n_pairs += __shfl_sync(0xffffffffu, scan, 31);
  }
  if (lane == 0) st.n_pairs = n_pairs;
}

// The CTA's block range [begin, end) of block-row blockIdx.x.
__device__ __forceinline__ void row_range(const int* __restrict__ rows,
                                          int n_blocks, int* s_range) {
  if (threadIdx.x == 0) {
    s_range[0] = bsr::lower_bound(rows, n_blocks, blockIdx.x);
    s_range[1] = bsr::lower_bound(rows, n_blocks, blockIdx.x + 1);
  }
}

// One warp per (nonzero, head) of the staged block: dot[(h·BR + r)·bc + i]
// = Σ_d a[r-side row][h·Dh + d] · b[column-side row][h·Dh + d], where the
// row side is the CTA's rows (row_base + r) and the column side the block's
// active columns (col_base + k_i). Each lane loads its 8 strided elements
// of both rows before it multiplies, so a dot waits on one memory latency.
template <int BR>
__device__ __forceinline__ void block_dots(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           size_t row_base, size_t col_base,
                                           const Stage& st, int heads,
                                           int dh, int bc, float* dot) {
  const int lane = threadIdx.x & 31;
  const int hd = heads * dh;
  for (int t = threadIdx.x >> 5; t < st.n_pairs * heads; t += blockDim.x >> 5) {
    const int pr = st.pair[t / heads];
    const int h = t % heads;
    const int i = pr >> 4;
    const int r = pr & 15;
    const float* ar = a + (row_base + r) * hd + h * dh;
    const float* br = b + (col_base + st.k[i]) * hd + h * dh;
    float part = 0.0f;
    for (int d0 = 0; d0 < dh; d0 += 256) {
      float x[8], y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + lane + 32 * j;
        x[j] = d < dh ? __ldg(ar + d) : 0.0f;
        y[j] = d < dh ? __ldg(br + d) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) part = fmaf(x[j], y[j], part);
    }
    part = warp_sum(part);
    if (lane == 0) dot[(h * BR + r) * bc + i] = part;
  }
}

// acc[r] += Σ_i w[r·bc + i] · v[k_i·stride] over the block's n active
// columns, four columns' loads issued before their FMAs.
template <int BR>
__device__ __forceinline__ void accumulate(float (&acc)[BR],
                                           const float* __restrict__ w,
                                           const float* __restrict__ v,
                                           const Stage& st, int n, int bc,
                                           size_t stride) {
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = __ldg(v + static_cast<size_t>(st.k[i + u]) * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = fmaf(w[r * bc + i + u], x[u], acc[r]);
    }
  }
  for (; i < n; ++i) {
    const float x = __ldg(v + static_cast<size_t>(st.k[i]) * stride);
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] = fmaf(w[r * bc + i], x, acc[r]);
  }
}

// ---------------------------------------------------------------------------
// Forward over A: out, m, l
// ---------------------------------------------------------------------------

template <int BR>
__global__ void __launch_bounds__(kMaxThreads)
attn_fwd_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                const float* __restrict__ blocks,
                const float* __restrict__ adst, const float* __restrict__ asrc,
                const float* __restrict__ z, float* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out,
                int n_blocks, int heads, int dh, int bc) {
  extern __shared__ float dyn[];
  const int hp = heads * BR;
  float* s_p = dyn;                   // [H][BR][bc] p of the active columns
  float* s_as = s_p + hp * bc;        // [H][bc] asrc of the active columns
  float* s_fac = s_as + heads * bc;   // [H][BR] rescale factor, then l
  __shared__ Stage st;
  __shared__ int s_range[2];

  const int hd = heads * dh;
  const int brow = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = blockIdx.y * blockDim.x + tid;
  const bool owns_col = c < hd;
  const int ch = owns_col ? c / dh : 0;
  const bool owns_pair = tid < hp;
  const int ph = tid / BR, pr = tid % BR;
  row_range(rows, n_blocks, s_range);
  const float ad = owns_pair
      ? __ldg(adst + (static_cast<size_t>(brow) * BR + pr) * heads + ph) : 0.0f;
  float m_run = kNegInf, l_run = 0.0f;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  __syncthreads();
  const int begin = s_range[0], end = s_range[1];

  int prev_col = -1;
  for (int b = begin; b < end; ++b) {
    const int col = __ldg(cols + b);
    if (col <= prev_col) break;  // the zero padding tail (uniform)
    prev_col = col;
    const size_t col_base = static_cast<size_t>(col) * bc;
    stage_block<BR, false>(blocks + static_cast<size_t>(b) * BR * bc, bc, st,
                           [&](int pos, int k) {
                             for (int h = 0; h < heads; ++h) {
                               s_as[h * bc + pos] = __ldg(asrc + (col_base + k) * heads + h);
                             }
                           });
    __syncthreads();
    const int n = st.n;
    if (n > 0) {
      if (owns_pair) {
        // the online recurrence of _attn_fwd_kernel for (head ph, row pr)
        const float* as_h = s_as + ph * bc;
        float mb = kNegInf;
        for (int i = 0; i < n; ++i) {
          if ((st.bits[i] >> pr) & 1u) mb = fmaxf(mb, leaky(ad + as_h[i]));
        }
        const float m_new = fmaxf(m_run, mb);
        const float alpha = expf(m_run - m_new);
        float* p = s_p + (ph * BR + pr) * bc;
        float sum = 0.0f;
        for (int i = 0; i < n; ++i) {
          float pi = 0.0f;
          if ((st.bits[i] >> pr) & 1u) pi = expf(leaky(ad + as_h[i]) - m_new);
          p[i] = pi;
          sum += pi;
        }
        l_run = l_run * alpha + sum;
        m_run = m_new;
        s_fac[tid] = alpha;
      }
      __syncthreads();
      if (owns_col) {
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] *= s_fac[ch * BR + r];
        accumulate<BR>(acc, s_p + ch * BR * bc, z + col_base * hd + c, st, n,
                       bc, hd);
      }
    }
    __syncthreads();
  }

  // finalise: out / max(l, 1e-20); m clamped to 0 on rows without a nonzero
  if (owns_pair) {
    s_fac[tid] = l_run;
    if (blockIdx.y == 0) {
      const size_t i = (static_cast<size_t>(brow) * BR + pr) * heads + ph;
      m_out[i] = l_run > 0.0f ? m_run : 0.0f;
      l_out[i] = l_run;
    }
  }
  __syncthreads();
  if (!owns_col) return;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    out[(static_cast<size_t>(brow) * BR + r) * hd + c] =
        acc[r] / fmaxf(s_fac[ch * BR + r], kFloor);
  }
}

// ---------------------------------------------------------------------------
// Backward, row pass over A: dc
// ---------------------------------------------------------------------------

template <int BR>
__global__ void __launch_bounds__(kMaxThreads)
attn_bwd_row_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                    const float* __restrict__ blocks,
                    const float* __restrict__ adst,
                    const float* __restrict__ asrc,
                    const float* __restrict__ z, const float* __restrict__ dy,
                    const float* __restrict__ r_in,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in, float* __restrict__ dc,
                    int n_blocks, int heads, int dh, int bc) {
  extern __shared__ float dyn[];
  const int hp = heads * BR;
  float* s_datt = dyn;              // [H][BR][bc] dy_i·z_j of the nonzeros
  float* s_as = s_datt + hp * bc;   // [H][bc]
  __shared__ Stage st;
  __shared__ int s_range[2];

  const int brow = blockIdx.x;
  const int tid = threadIdx.x;
  const bool owns_pair = tid < hp;
  const int ph = tid / BR, pr = tid % BR;
  row_range(rows, n_blocks, s_range);
  float ad = 0.0f, mi = 0.0f, li = 1.0f, ri = 0.0f;
  if (owns_pair) {
    const size_t i = (static_cast<size_t>(brow) * BR + pr) * heads + ph;
    ad = __ldg(adst + i);
    mi = __ldg(m_in + i);
    li = fmaxf(__ldg(l_in + i), kFloor);
    ri = __ldg(r_in + i);
  }
  float dc_acc = 0.0f;
  __syncthreads();
  const int begin = s_range[0], end = s_range[1];
  const size_t row_base = static_cast<size_t>(brow) * BR;

  int prev_col = -1;
  for (int b = begin; b < end; ++b) {
    const int col = __ldg(cols + b);
    if (col <= prev_col) break;
    prev_col = col;
    const size_t col_base = static_cast<size_t>(col) * bc;
    stage_block<BR, true>(blocks + static_cast<size_t>(b) * BR * bc, bc, st,
                          [&](int pos, int k) {
                            for (int h = 0; h < heads; ++h) {
                              s_as[h * bc + pos] = __ldg(asrc + (col_base + k) * heads + h);
                            }
                          });
    __syncthreads();
    const int n = st.n;
    if (n > 0) {
      block_dots<BR>(dy, z, row_base, col_base, st, heads, dh, bc, s_datt);
      __syncthreads();
      if (owns_pair) {
        const float* as_h = s_as + ph * bc;
        const float* datt = s_datt + (ph * BR + pr) * bc;
        for (int i = 0; i < n; ++i) {
          if (!((st.bits[i] >> pr) & 1u)) continue;
          const float pre = ad + as_h[i];
          const float att = expf(leaky(pre) - mi) / li;
          dc_acc += att * (datt[i] - ri) * (pre >= 0.0f ? 1.0f : kSlope);
        }
      }
    }
    __syncthreads();
  }
  if (owns_pair) dc[(row_base + pr) * heads + ph] = dc_acc;
}

// ---------------------------------------------------------------------------
// Backward, col pass over Aᵀ: dzv, dd (CTA rows are sources j, block
// columns destinations i)
// ---------------------------------------------------------------------------

template <int BR>
__global__ void __launch_bounds__(kMaxThreads)
attn_bwd_col_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                    const float* __restrict__ blocks,
                    const float* __restrict__ asrc,
                    const float* __restrict__ adst,
                    const float* __restrict__ z, const float* __restrict__ dy,
                    const float* __restrict__ r_in,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in, float* __restrict__ dzv,
                    float* __restrict__ dd, int n_blocks, int heads, int dh,
                    int bc) {
  extern __shared__ float dyn[];
  const int hp = heads * BR;
  float* s_att = dyn;               // [H][BR][bc] att of the nonzeros
  float* s_datt = s_att + hp * bc;  // [H][BR][bc] z_j·dy_i (tile 0)
  float* s_ad = s_datt + hp * bc;   // [H][bc] destination-side statistics
  float* s_m = s_ad + heads * bc;
  float* s_l = s_m + heads * bc;
  float* s_r = s_l + heads * bc;
  __shared__ Stage st;
  __shared__ int s_range[2];

  const int hd = heads * dh;
  const int brow = blockIdx.x;
  const int tid = threadIdx.x;
  const bool tile0 = blockIdx.y == 0;
  const int c = blockIdx.y * blockDim.x + tid;
  const bool owns_col = c < hd;
  const int ch = owns_col ? c / dh : 0;
  const bool owns_pair = tid < hp;
  const int ph = tid / BR, pj = tid % BR;
  row_range(rows, n_blocks, s_range);
  const size_t row_base = static_cast<size_t>(brow) * BR;
  const float as_j = owns_pair ? __ldg(asrc + (row_base + pj) * heads + ph) : 0.0f;
  float dd_acc = 0.0f;
  float acc[BR];
#pragma unroll
  for (int j = 0; j < BR; ++j) acc[j] = 0.0f;
  __syncthreads();
  const int begin = s_range[0], end = s_range[1];

  int prev_col = -1;
  for (int b = begin; b < end; ++b) {
    const int col = __ldg(cols + b);
    if (col <= prev_col) break;
    prev_col = col;
    const size_t col_base = static_cast<size_t>(col) * bc;
    stage_block<BR, true>(blocks + static_cast<size_t>(b) * BR * bc, bc, st,
                          [&](int pos, int k) {
                      const size_t i = (col_base + k) * heads;
                      for (int h = 0; h < heads; ++h) {
                        s_ad[h * bc + pos] = __ldg(adst + i + h);
                        s_m[h * bc + pos] = __ldg(m_in + i + h);
                        s_l[h * bc + pos] = fmaxf(__ldg(l_in + i + h), kFloor);
                        s_r[h * bc + pos] = __ldg(r_in + i + h);
                      }
                    });
    __syncthreads();
    const int n = st.n;
    if (n > 0) {
      if (tile0) block_dots<BR>(z, dy, row_base, col_base, st, heads, dh, bc, s_datt);
      __syncthreads();
      if (owns_pair) {
        const int o = ph * bc;
        float* att_row = s_att + (ph * BR + pj) * bc;
        const float* datt = s_datt + (ph * BR + pj) * bc;
        for (int i = 0; i < n; ++i) {
          float att = 0.0f;
          if ((st.bits[i] >> pj) & 1u) {
            const float pre = as_j + s_ad[o + i];
            att = expf(leaky(pre) - s_m[o + i]) / s_l[o + i];
            if (tile0) {
              dd_acc += att * (datt[i] - s_r[o + i]) * (pre >= 0.0f ? 1.0f : kSlope);
            }
          }
          att_row[i] = att;
        }
      }
      __syncthreads();
      if (owns_col) {
        accumulate<BR>(acc, s_att + ch * BR * bc, dy + col_base * hd + c, st,
                       n, bc, hd);
      }
    }
    __syncthreads();
  }
  if (owns_pair && tile0) dd[(row_base + pj) * heads + ph] = dd_acc;
  if (!owns_col) return;
#pragma unroll
  for (int j = 0; j < BR; ++j) dzv[(row_base + j) * hd + c] = acc[j];
}

// Launch geometry shared by the three kernels: threads a multiple of 32,
// at least H·BR (the pair threads) and, for the column-owning kernels, the
// tile width; the grid's y covers H·Dh in tiles of that width.
struct Geometry {
  dim3 grid;
  int threads;
};

inline Geometry geometry(int n_block_rows, int heads, int dh, int br,
                         bool column_tiles) {
  const int hd = heads * dh;
  const int pairs = ((heads * br + 31) / 32) * 32;
  int threads = column_tiles ? ((hd + 31) / 32) * 32 : kMaxThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < pairs) threads = pairs;
  const int tiles = column_tiles ? (hd + threads - 1) / threads : 1;
  return {dim3(n_block_rows, tiles), threads};
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline bool shape_ok(int heads, int dh, int br, int bc) {
  return heads > 0 && dh > 0 && bc > 0 && bc <= kMaxBC &&
         heads * br <= kMaxThreads && (br == 8 || br == 16);
}

}  // namespace attn

// All pointers are device pointers (int32 rows/cols [n_blocks], float32
// otherwise, row-major, shapes as in the header comment). Each entry
// launches on `stream` and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape it does not take (br other than 8 or 16,
// bc above 128, heads·br above 256).

extern "C" int bsr_attention_fwd_f32(const void* rows, const void* cols,
                                     const void* blocks, const void* adst,
                                     const void* asrc, const void* z,
                                     void* out, void* m, void* l, int n_blocks,
                                     int n_block_rows, int heads, int dh,
                                     int br, int bc, void* stream) {
  if (!attn::shape_ok(heads, dh, br, bc)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_block_rows == 0) return 0;
  const attn::Geometry g = attn::geometry(n_block_rows, heads, dh, br, true);
  const size_t smem = sizeof(float) * (heads * br * bc + heads * bc + heads * br);
  auto s = static_cast<cudaStream_t>(stream);
#define ATTN_FWD(BR)                                                           \
  {                                                                            \
    cudaError_t e = attn::set_smem(attn::attn_fwd_kernel<BR>, smem);           \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    attn::attn_fwd_kernel<BR><<<g.grid, g.threads, smem, s>>>(                 \
        static_cast<const int*>(rows), static_cast<const int*>(cols),          \
        static_cast<const float*>(blocks), static_cast<const float*>(adst),    \
        static_cast<const float*>(asrc), static_cast<const float*>(z),         \
        static_cast<float*>(out), static_cast<float*>(m),                      \
        static_cast<float*>(l), n_blocks, heads, dh, bc);                      \
    return static_cast<int>(cudaGetLastError());                               \
  }
  if (br == 8) ATTN_FWD(8)
  ATTN_FWD(16)
#undef ATTN_FWD
}

extern "C" int bsr_attention_bwd_row_f32(const void* rows, const void* cols,
                                         const void* blocks, const void* adst,
                                         const void* asrc, const void* z,
                                         const void* dy, const void* r,
                                         const void* m, const void* l,
                                         void* dc, int n_blocks,
                                         int n_block_rows, int heads, int dh,
                                         int br, int bc, void* stream) {
  if (!attn::shape_ok(heads, dh, br, bc)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_block_rows == 0) return 0;
  const attn::Geometry g = attn::geometry(n_block_rows, heads, dh, br, false);
  const size_t smem = sizeof(float) * (heads * br * bc + heads * bc);
  auto s = static_cast<cudaStream_t>(stream);
#define ATTN_ROW(BR)                                                           \
  {                                                                            \
    cudaError_t e = attn::set_smem(attn::attn_bwd_row_kernel<BR>, smem);       \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    attn::attn_bwd_row_kernel<BR><<<g.grid, g.threads, smem, s>>>(             \
        static_cast<const int*>(rows), static_cast<const int*>(cols),          \
        static_cast<const float*>(blocks), static_cast<const float*>(adst),    \
        static_cast<const float*>(asrc), static_cast<const float*>(z),         \
        static_cast<const float*>(dy), static_cast<const float*>(r),           \
        static_cast<const float*>(m), static_cast<const float*>(l),            \
        static_cast<float*>(dc), n_blocks, heads, dh, bc);                     \
    return static_cast<int>(cudaGetLastError());                               \
  }
  if (br == 8) ATTN_ROW(8)
  ATTN_ROW(16)
#undef ATTN_ROW
}

extern "C" int bsr_attention_bwd_col_f32(const void* rows, const void* cols,
                                         const void* blocks, const void* asrc,
                                         const void* adst, const void* z,
                                         const void* dy, const void* r,
                                         const void* m, const void* l,
                                         void* dzv, void* dd, int n_blocks,
                                         int n_block_rows, int heads, int dh,
                                         int br, int bc, void* stream) {
  if (!attn::shape_ok(heads, dh, br, bc)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_block_rows == 0) return 0;
  const attn::Geometry g = attn::geometry(n_block_rows, heads, dh, br, true);
  const size_t smem = sizeof(float) * (2 * heads * br * bc + 4 * heads * bc);
  auto s = static_cast<cudaStream_t>(stream);
#define ATTN_COL(BR)                                                           \
  {                                                                            \
    cudaError_t e = attn::set_smem(attn::attn_bwd_col_kernel<BR>, smem);       \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    attn::attn_bwd_col_kernel<BR><<<g.grid, g.threads, smem, s>>>(             \
        static_cast<const int*>(rows), static_cast<const int*>(cols),          \
        static_cast<const float*>(blocks), static_cast<const float*>(asrc),    \
        static_cast<const float*>(adst), static_cast<const float*>(z),         \
        static_cast<const float*>(dy), static_cast<const float*>(r),           \
        static_cast<const float*>(m), static_cast<const float*>(l),            \
        static_cast<float*>(dzv), static_cast<float*>(dd), n_blocks, heads,    \
        dh, bc);                                                               \
    return static_cast<int>(cudaGetLastError());                               \
  }
  if (br == 8) ATTN_COL(8)
  ATTN_COL(16)
#undef ATTN_COL
}
