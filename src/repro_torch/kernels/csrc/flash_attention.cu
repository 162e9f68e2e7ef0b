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
// here one CTA owns one (batch·head, 64-row query tile) and loops over the
// 64-key tiles itself, with m, l and the accumulator in registers, and
// normalises once after the loop. Nothing crosses CTAs: no atomics, a
// fixed summation order, bitwise repeatable results. Nothing is padded in
// memory: the ragged query and key edges are masked (keys beyond Tk load as
// zeros and score NEG_INF; rows beyond Tq are not written). Key tiles that
// lie wholly above the causal diagonal are not visited: for them the
// recurrence would leave m, l and acc as they are (α = 1, p = 0), so the
// result is the same. Every row sees key 0 in the first tile, so m is a
// real logit after it and a masked entry's exp(NEG_INF - m) is exactly 0.
// Query tiles are issued from the last (the longest causal loop) to the
// first, so the long CTAs start first.
//
// Inside a CTA: 256 threads as 16 x 16 (ty, tx). Thread (ty, tx) owns the
// query rows 4·ty .. 4·ty+3 of the tile: the scores of key columns tx +
// 16·j (j < 4) of each key tile, and output columns tx + 16·c (c <
// D/16). A row's max and sum reduce over the 16 lanes of a half warp
// (xor shuffles); p goes through shared memory to the p·v product. The q
// tile stays in shared memory for the whole loop, k and v tiles are staged
// per step; rows of q and k are padded by one float so the lanes of a
// warp read distinct banks.
//
// Inputs are read through their strides (the element (b, h, t, d) at
// b·sb + h·sh + t·st + d), so the LM's [B, T, H, D] projections are read
// through a transpose view without a copy; d is contiguous. The output is
// written through its strides too.
//
// What bounds it: operations. At the LM's prefill (B 4, H 32, Hkv 8, T
// 1024, D 64, causal) the work is 4·B·H·T²·D/2 = 17.2 GFLOP against ~84 MB
// of q, k, v and out: 0.256 ms at the H100's 67 TFLOP/s of float32 FMA
// against 0.025 ms at 3.35 TB/s. This kernel feeds each 16 FMAs from
// shared memory with 8 loads (4 of them broadcast); tensor cores (TF32 or
// bf16 operands) and TMA-fed tiles are later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = 4;       // key columns per thread (kBK / 16)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, h, t;
};

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (D + 1)    // q tile
         + static_cast<size_t>(kBK) * (D + 1)  // k tile
         + static_cast<size_t>(kBK) * D        // v tile
         + static_cast<size_t>(kBQ) * (kBK + 1);  // p
}

// rows x D of one (b, h) slice into shared memory at row stride `ld`;
// rows at or beyond `limit` load as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long st, int row0, int rows,
                                          int limit) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int t = row0 + r;
    dst[r * ld + c] = t < limit ? to_float(src[t * st + c]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int heads,
                 int group, int tq, int tk, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale, int causal) {
  constexpr int kOut = (D + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * (D + 1);
  float* v_s = k_s + kBK * (D + 1);
  float* p_s = v_s + kBK * D;

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal loop first
  const int q0 = tile * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads, hk = h / group;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  load_tile<T, D>(q_s, D + 1, qp, qs.t, q0, kBQ, tq);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (tk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, tq) - 1;
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    load_tile<T, D>(k_s, D + 1, kp, ks.t, k0, kBK, tk);
    load_tile<T, D>(v_s, D, vp, vs.t, k0, kBK, tk);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = q_s[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = k_s[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < tk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? v_s[kk * D + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // k_s, v_s and p_s are rewritten by the next tile
  }

  T* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= tq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(op + row * os.t + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int kv_heads, int tq, int tk, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((tq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, heads / kv_heads,
      tq, tk, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int batch, int heads, int kv_heads, int tq, int tk, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal,
             cudaStream_t stream) {
#define FLASH_D(DIM)                                                        \
  case DIM:                                                                 \
    return launch<T, DIM>(q, k, v, o, batch, heads, kv_heads, tq, tk, qs, \
                          ks, vs, os, scale, causal, stream);
  switch (d) {
    FLASH_D(8)
    FLASH_D(16)
    FLASH_D(32)
    FLASH_D(64)
    FLASH_D(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_D
}

}  // namespace flash

// out = softmax(q·kᵀ·scale, masked)·v. q [B, H, Tq, D], k and v [B, Hkv,
// Tk, D] and out [B, H, Tq, D] are device pointers read and written through
// the given (b, h, t) element strides, d contiguous; dtype 0 is float32, 1
// bfloat16 (all four tensors alike); D in {8, 16, 32, 64, 128}; Hkv divides
// H; causal masks col > row (top-left). Launches on `stream` and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape it
// does not take).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int heads, int kv_heads, int tq, int tk, int d,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st,
    float scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      tq <= 0 || tk <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash::dispatch<float>(d, q, k, v, out, batch, heads, kv_heads, tq,
                                  tk, qs, ks, vs, os, scale, causal, s);
  if (dtype == 1)
    return flash::dispatch<__nv_bfloat16>(d, q, k, v, out, batch, heads,
                                          kv_heads, tq, tk, qs, ks, vs, os,
                                          scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
