// Fused AdamW step for Hopper (sm_90a), one elementwise pass over a leaf:
//   m' = β1·m + (1-β1)·g
//   v' = β2·v + (1-β2)·g·g
//   p' = p - lr_t·(m' / (sqrt(v') + eps) + wd·p)
// with the bias correction folded into lr_t on the host.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_adam.py:fused_adam
// (_kernel at :24, pallas_call at :86), which pads each leaf to (8, 128)
// tiles and walks them on the sequential grid. Here a grid-stride loop
// covers any length, so nothing is padded. What bounds it: bytes. It reads
// p, g, m, v and writes p', m', v' (28 bytes per parameter) for ~15 fp32
// operations, far below the card's operations per byte. One launch per
// leaf; a GCN's leaves are small, so launch latency, not bandwidth, sets
// its time (PERF.md). Every operation rounds as the reference's separate
// fp32 ops do (no contraction into FMAs), and sqrt and division are IEEE,
// so the kernel agrees with the plain version to an ulp or two.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 CTAs on each of the H100's 132 SMs

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const float* __restrict__ p, const float* __restrict__ g,
                  const float* __restrict__ m, const float* __restrict__ v,
                  float* __restrict__ p_out, float* __restrict__ m_out,
                  float* __restrict__ v_out, long long n, float lr_t,
                  float b1, float omb1, float b2, float omb2, float eps,
                  float wd) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float pi = p[i];
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, gi));
    const float vi =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(omb2, gi), gi));
    const float upd = __fadd_rn(__fdiv_rn(mi, __fadd_rn(__fsqrt_rn(vi), eps)),
                                __fmul_rn(wd, pi));
    p_out[i] = __fsub_rn(pi, __fmul_rn(lr_t, upd));
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

}  // namespace

// One AdamW step over n float32 values. p, g, m, v and the outputs are
// device pointers (outputs may alias their inputs). omb1 = 1 - β1 and
// omb2 = 1 - β2 come from the host, rounded once from double as the
// reference rounds them. Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int fused_adam_f32(const void* p, const void* g, const void* m,
                              const void* v, void* p_out, void* m_out,
                              void* v_out, long long n, float lr_t, float b1,
                              float omb1, float b2, float omb2, float eps,
                              float wd, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_adam_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<float*>(p_out), static_cast<float*>(m_out),
      static_cast<float*>(v_out), n, lr_t, b1, omb1, b2, omb2, eps, wd);
  return static_cast<int>(cudaGetLastError());
}
