// Tiled causal attention with an online softmax for Hopper (sm_90a):
//   out = softmax(q·kᵀ·scale, masked)·v
// over q [B, H, Tq, D] and k, v [B, Hkv, Tk, D], float32 or bfloat16 in,
// float32 arithmetic throughout (FMAs on the CUDA cores: no tensor cores,
// no TF32; expf and IEEE division), the output in q's type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (_kernel :29, pallas_call :106), and keeps what it
// computes:
//   * logits q·k times scale, NEG_INF = -1e30 where col >= Tk (K padding)
//     or, if causal, col > row: the mask aligned top-left (query row i sees
//     keys 0..i, whatever Tk is);
//   * the running (m, l) recurrence m' = max(m, max_j s), α = exp(m - m'),
//     p = exp(s - m'), l' = l·α + Σ p, acc' = acc·α + p·v, from m = NEG_INF,
//     l = 0, acc = 0, and out = acc / max(l, 1e-20) at the end.
// Query head h reads KV head h / (H / Hkv) (the LM's grouped query
// attention; Hkv == H is the Pallas kernel's own contract).
//
// Translation of the sequential TPU grid (B·H, Tq/bq, Tk/bk), whose k axis
// carries m, l and acc in VMEM scratch from one grid step to the next:
// here one CTA owns BQ query rows and loops over the 64-key tiles itself,
// with m, l and the accumulator in registers, and normalises once after
// the loop. Nothing crosses CTAs: no atomics, a fixed summation order,
// bitwise repeatable results. Nothing is padded in memory: the ragged
// query and key edges are masked (keys beyond Tk load as zeros and score
// NEG_INF; rows beyond Tq are not written). Key tiles that lie wholly
// above the causal diagonal are not visited: for them the recurrence
// would leave m, l and acc as they are (α = 1, p = 0), so the result is
// the same. Every row sees key 0 in the first tile, so m is a real logit
// after it and a masked entry's exp(NEG_INF - m) is exactly 0. Only the
// tiles that cross the diagonal or the Tk edge test the mask; the others
// only scale.
//
// The KV group shares its tiles: a CTA's BQ rows are `hp` heads of one KV
// group times BQ/hp queries each (hp = 1, 2 or 4 dividing H/Hkv: the
// wrapper takes the largest), so each K/V tile it loads serves hp heads.
// The grid is (B·H/hp, query tiles): where hp = 1 the group's CTAs are
// neighbours in launch order and meet its K/V tiles in L2 instead. Query
// tiles are issued from the last (the longest causal loop) to the first.
//
// Inside a CTA: 128 threads as 16 (ty) x 8 (tx). Thread (ty, tx) owns the
// RM consecutive rows ty·RM.. of the tile (RM = 8, or 4 at D >= 112), the
// scores of key columns tx + 8·j (j < 8) of each key tile and the output
// columns g·8·CW + tx·CW + c (CW contiguous, the largest of 4, 2 and 1
// that D/8 divides into: 2 at D = 112; g < D/(8·CW)):
//   * S = Q·Kᵀ as RM x 8 register outer products over d: Q row-major and K
//     key-major (its rows padded by 4 floats, so the 8 tx lanes of a
//     quarter warp read distinct banks), both read as float4 along d: 8
//     FMAs per shared-memory word of each operand, 4 overall (the old
//     kernel's 4x4 scalar tiles did 2);
//   * a row's max and sum reduce over its 8 tx lanes (xor shuffles);
//   * P goes to shared memory key-major (float4 stores along the rows),
//     and acc += P·V reads P's RM rows and V's row-major columns as float4:
//     again 4 FMAs per word.
// K and V tiles are single-buffered but loaded asynchronously with
// cp.async (16-byte cp.async.cg, zero-filled past Tk): the next key tile's
// K copy is issued as soon as the scores of the current one are taken and
// lands during its softmax and P·V; the next V copy is issued after the
// P·V and lands during the next scores. The wrapper checks that q, k and
// v are float32 with 16-byte aligned row starts; bfloat16 inputs, and
// float32 ones that are not aligned, take the synchronous path inside the
// kernel (global -> register -> shared, converted to float32 per element):
// the same arithmetic, no overlap.
//
// Inputs are read through their strides (the element (b, h, t, d) at
// b·sb + h·sh + t·st + d), so the LM's [B, T, H, D] projections are read
// through a transpose view without a copy; d is contiguous. The output is
// written through its strides too.
//
// What bounds it: operations. At the LM's prefill (B 4, H 32, Hkv 8, T
// 1024, D 64, causal) the work is 4·B·H·T²·D/2 = 17.2 GFLOP against ~84 MB
// of q, k, v and out: 0.256 ms at the H100's 67 TFLOP/s of float32 FMA
// against 0.025 ms at 3.35 TB/s. At D = 256 (gemma3-1b's global layers)
// a CTA holds 64 rows: its Q, K, V and P tiles take 215,040 bytes of shared
// memory, under the H100's 227 KB opt-in, so one CTA runs on an SM, and a
// thread keeps 4 x 32 accumulators. At D = 112 (zamba2-7b's shared block,
// 3584 / 32) a CTA holds 64 rows too: 104,448 bytes, so two CTAs share an
// SM (at 128 rows, 149,504 bytes, only one would fit), and each thread
// keeps 4 x 14 accumulators in 7 float2 column pairs. Tensor cores (TF32 or bf16 operands,
// behind a flag with their own tolerance) are later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kThreads = 128;  // 16 (ty) x 8 (tx)
constexpr int kBK = 64;        // keys per tile
constexpr int kKJ = kBK / 8;   // key columns per thread: tx + 8·j
constexpr float kNegInf = -1e30f;

// The tile geometry of head width D.
template <int D>
struct Cfg {
  static constexpr int RM = D >= 112 ? 4 : 8;     // query rows per thread
  static constexpr int BQ = 16 * RM;              // query rows per CTA
  // contiguous output columns: the largest of 4, 2, 1 with D % (8·CW) == 0
  static constexpr int CW = D % 32 == 0 ? 4 : D % 16 == 0 ? 2 : 1;
  static constexpr int G = D / (8 * CW);          // their groups
  static constexpr int CN = G * CW;               // output columns per thread
  static constexpr int LDK = D + 4;               // K row: padded
  static constexpr int LDP = BQ + 4;              // P is key-major
  static constexpr int Q_FLOATS = BQ * D;
  static constexpr int K_FLOATS = kBK * LDK;
  static constexpr int V_FLOATS = kBK * D;
  static constexpr int P_FLOATS = kBK * LDP;
  static constexpr size_t SMEM =
      sizeof(float) * (Q_FLOATS + K_FLOATS + V_FLOATS + P_FLOATS);
  static constexpr int MIN_CTAS = D >= 128 ? 1 : 2;  // per SM, by smem
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ void cp_async16(float* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `rows` rows of D elements into dst at row stride `ld`: row r from
// row_ptr(r), or zeros where that is null. ASYNC (float32, 16-byte
// aligned rows) issues 16-byte cp.async copies (`base`, a valid address,
// stands in for a zero row's source, which is not read); otherwise each
// element is loaded, converted and stored.
template <typename T, int D, bool ASYNC, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          RowPtr row_ptr, const T* base) {
  if constexpr (ASYNC) {
    constexpr int C = D / 4;
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      const int r = e / C, c = e % C;
      const T* src = row_ptr(r);
      cp_async16(dst + r * ld + 4 * c, src ? src + 4 * c : base, src ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const T* src = row_ptr(r);
      dst[r * ld + c] = src ? to_float(src[c]) : 0.0f;
    }
  }
}

template <int CW>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <typename T, int D, bool ASYNC>
__global__ void __launch_bounds__(kThreads, Cfg<D>::MIN_CTAS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int heads,
                 int group, int hp, int tq, int tk, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int RM = C::RM, BQ = C::BQ, CW = C::CW, G = C::G, CN = C::CN;
  constexpr int LDK = C::LDK, LDP = C::LDP;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + C::Q_FLOATS;
  float* v_s = k_s + C::K_FLOATS;
  float* p_s = v_s + C::V_FLOATS;

  const int groups_per_b = heads / hp;
  const int b = blockIdx.x / groups_per_b;
  const int h0 = (blockIdx.x % groups_per_b) * hp;
  const int hk = h0 / group;
  const int bqh = BQ / hp;  // queries per head in the tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bqh;  // longest loop first
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int row0 = ty * RM;               // the thread's first tile row
  const int t0 = q0 + row0 % bqh;         // its query (RM divides bqh)
  const int my_head = h0 + row0 / bqh;

  const T* qb = q + b * qs.b;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  // tile row r is query q0 + r % bqh of head h0 + r / bqh
  load_tile<T, D, ASYNC>(q_s, D, BQ, [&](int r) -> const T* {
    const int t = q0 + r % bqh;
    return t < tq ? qb + (h0 + r / bqh) * qs.h + t * qs.t : nullptr;
  }, kp);
  int n_tiles = (tk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + bqh, tq) - 1) / kBK + 1);
  auto kv_rows = [&](const T* base, long long st, int k0) {
    return [=](int r) -> const T* {
      return k0 + r < tk ? base + (k0 + r) * st : nullptr;
    };
  };
  load_tile<T, D, ASYNC>(k_s, LDK, kBK, kv_rows(kp, ks.t, 0), kp);
  if constexpr (ASYNC) cp_async_commit();
  load_tile<T, D, ASYNC>(v_s, D, kBK, kv_rows(vp, vs.t, 0), vp);
  if constexpr (ASYNC) {
    cp_async_commit();
    cp_async_wait<1>();  // q and the first K tile
  }
  __syncthreads();

  float m[RM], l[RM], acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const bool more = kt + 1 < n_tiles;

    // S = Q·Kᵀ: RM rows x kKJ keys a thread, float4 along d
    float s[RM][kKJ];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) s[i][j] = 0.0f;
    // two d-steps an iteration: at D = 64 on the card a full unroll ran
    // slower, and 2, 4 or 8 steps alike
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (row0 + i) * D + d);
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const float4 kb =
            *reinterpret_cast<const float4*>(k_s + (tx + 8 * j) * LDK + d);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          s[i][j] = fmaf(qa[i].x, kb.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb.w, s[i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with k_s
    if (more) {
      load_tile<T, D, ASYNC>(k_s, LDK, kBK, kv_rows(kp, ks.t, k0 + kBK), kp);
      if constexpr (ASYNC) cp_async_commit();
    }

    // the mask only where the tile crosses the diagonal or the Tk edge
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > tk;
    if (edge) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) {
          const int col = k0 + tx + 8 * j;
          const bool ok = col < tk && (!causal || col <= t0 + i);
          s[i][j] = ok ? s[i][j] * scale : kNegInf;
        }
    } else {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) s[i][j] *= scale;
    }

    // the online softmax of each row over its 8 tx lanes
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kKJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= alpha;
    }
    // P key-major: p_s[key][row], the thread's RM rows as float4
#pragma unroll
    for (int j = 0; j < kKJ; ++j)
#pragma unroll
      for (int i = 0; i < RM; i += 4)
        *reinterpret_cast<float4*>(p_s + (tx + 8 * j) * LDP + row0 + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    if constexpr (ASYNC) {
      if (more) {
        cp_async_wait<1>();  // this tile's V; the next K may still fly
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();

    // acc += P·V: P's RM rows and V's CN columns as float4 a key
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RM], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(p_s + kk * LDP + row0 + i);
        pv[i] = t.x;
        pv[i + 1] = t.y;
        pv[i + 2] = t.z;
        pv[i + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        load_cols<CW>(v_s + kk * D + g * 8 * CW + tx * CW, vv + g * CW);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // every thread is done with v_s and p_s
    if (more) {
      load_tile<T, D, ASYNC>(v_s, D, kBK, kv_rows(vp, vs.t, k0 + kBK), vp);
      if constexpr (ASYNC) {
        cp_async_commit();
        cp_async_wait<1>();  // the next K; its V may still fly
      }
      __syncthreads();
    }
  }

  T* op = o + b * os.b + my_head * os.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = t0 + i;
    if (t >= tq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* orow = op + t * os.t;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = g * 8 * CW + tx * CW;
      if constexpr (CW == 4 && sizeof(T) == 4) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][g * CW] / denom, acc[i][g * CW + 1] / denom,
                        acc[i][g * CW + 2] / denom, acc[i][g * CW + 3] / denom);
      } else {
#pragma unroll
        for (int c = 0; c < CW; ++c) store(orow + col + c, acc[i][g * CW + c] / denom);
      }
    }
  }
}

template <typename T, int D, bool ASYNC>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int kv_heads, int hp, int tq, int tk, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  static_assert(C::SMEM <= 227 * 1024, "over the H100's shared memory a block");
  const int bqh = C::BQ / hp;
  if (bqh < C::RM) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (tq + bqh - 1) / bqh;
  const long long ctas = static_cast<long long>(batch) * (heads / hp);
  if (tiles > 65535 || ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, ASYNC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(tiles));
  flash_fwd_kernel<T, D, ASYNC><<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, heads / kv_heads,
      hp, tq, tk, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ASYNC>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int batch, int heads, int kv_heads, int hp, int tq, int tk,
             Strides qs, Strides ks, Strides vs, Strides os, float scale,
             int causal, cudaStream_t stream) {
#define FLASH_D(DIM)                                                          \
  case DIM:                                                                   \
    return launch<T, DIM, ASYNC>(q, k, v, o, batch, heads, kv_heads, hp, tq, \
                                 tk, qs, ks, vs, os, scale, causal, stream);
  switch (d) {
    FLASH_D(8)
    FLASH_D(16)
    FLASH_D(32)
    FLASH_D(64)
    FLASH_D(112)
    FLASH_D(128)
    FLASH_D(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_D
}

}  // namespace flash

// out = softmax(q·kᵀ·scale, masked)·v. q [B, H, Tq, D], k and v [B, Hkv,
// Tk, D] and out [B, H, Tq, D] are device pointers read and written through
// the given (b, h, t) element strides, d contiguous (out's rows 16-byte
// aligned: the wrapper allocates it); dtype 0 is float32, 1
// bfloat16 (all four tensors alike); D in {8, 16, 32, 64, 112, 128, 256}; Hkv divides
// H; causal masks col > row (top-left). heads_per_cta: the query heads of
// one KV group a CTA serves, 1, 2 or 4, dividing H/Hkv.
// async: q, k and v are float32 with 16-byte aligned row
// starts (the wrapper's check), so tiles load by cp.async; else they load
// synchronously. Launches on `stream` and returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int heads, int kv_heads, int tq, int tk, int d,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st,
    float scale, int causal, int heads_per_cta, int async, void* stream) {
  const int hp = heads_per_cta;
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      tq <= 0 || tk <= 0 || (hp != 1 && hp != 2 && hp != 4) ||
      (heads / kv_heads) % hp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && async)
    return flash::dispatch<float, true>(d, q, k, v, out, batch, heads,
                                        kv_heads, hp, tq, tk, qs, ks, vs, os,
                                        scale, causal, s);
  if (dtype == 0)
    return flash::dispatch<float, false>(d, q, k, v, out, batch, heads,
                                         kv_heads, hp, tq, tk, qs, ks, vs, os,
                                         scale, causal, s);
  if (dtype == 1 && !async)
    return flash::dispatch<__nv_bfloat16, false>(d, q, k, v, out, batch,
                                                 heads, kv_heads, hp, tq, tk,
                                                 qs, ks, vs, os, scale,
                                                 causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
