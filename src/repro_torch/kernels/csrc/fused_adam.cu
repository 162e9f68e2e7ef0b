// Fused AdamW step for Hopper (sm_90a), one launch over all of a step's
// leaves; for each value of each leaf:
//   m' = β1·m + (1-β1)·g
//   v' = β2·v + (1-β2)·g·g
//   p' = p - lr_t·(m' / (sqrt(v') + eps) + wd·p)
// with the bias correction folded into lr_t on the host.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_adam.py:fused_adam
// (_kernel at :24, pallas_call at :86), which pads one leaf to (8, 128)
// tiles and walks them on the sequential grid, one call a leaf. What
// bounds it: bytes. It reads p, g, m, v and writes p', m', v' (28 bytes a
// parameter) for ~15 fp32 operations, far below the card's operations
// per byte. A step's leaves are small (a GCN's 6 hold 3 MB, a GAT's 15
// hold 51 MB), so a launch per leaf is paid for in launch latency, and a
// 40-float bias would take a CTA of its own. The design:
//  - One launch carries a table of up to kCapacity leaves: each leaf's
//    seven pointers (p, g, m, v, p', m', v'), its length and its first
//    chunk, passed by value as a kernel parameter (__grid_constant__), so
//    nothing is copied to the card and no buffer has to be guarded
//    against reuse. kCapacity keeps the table under the classic 4 KB
//    parameter limit; a step with more leaves launches once a table.
//  - The work is the table's concatenated space of 16-byte chunks (4
//    floats; each leaf rounded up to whole chunks), walked by a
//    grid-stride loop of one chunk a thread: a CTA may straddle leaves,
//    so a small leaf takes a few threads beside its neighbours. A thread
//    finds its chunk's leaf by a binary search over the table's starts:
//    no block→leaf map to build on the host and pass, and the warp's
//    threads read the same entries except at a leaf's edge.
//  - float4 loads and stores where all seven of a leaf's pointers are
//    16-byte aligned; scalar ones for a leaf's last partial chunk and for
//    a leaf with a misaligned pointer (a view at an offset).
//  - Up to 8 CTAs of 256 threads on each of the 132 SMs: each thread has
//    four 16-byte loads in flight, ~128 KB an SM.
// Every operation rounds as the reference's separate fp32 ops do (no
// contraction into FMAs), and sqrt and division are IEEE: each value is
// bitwise what the one-leaf-a-launch kernel gave, and agrees with the
// plain version to an ulp or two.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 CTAs on each of the H100's 132 SMs
// Leaves a launch carries: 73 bytes each, 3.5 KB of parameters in all.
constexpr int kCapacity = 48;

struct Table {
  const float* p[kCapacity];
  const float* g[kCapacity];
  const float* m[kCapacity];
  const float* v[kCapacity];
  float* p_out[kCapacity];
  float* m_out[kCapacity];
  float* v_out[kCapacity];
  long long n[kCapacity];          // values of each leaf (> 0)
  long long start[kCapacity + 1];  // first chunk of each; start[count] all
  unsigned char vec[kCapacity];    // 1: all seven pointers 16-byte aligned
  int count;
};

struct Step {
  float lr_t, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float adam(float p, float g, float m, float v,
                                      const Step& s, float& m_new,
                                      float& v_new) {
  m_new = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v_new = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float upd =
      __fadd_rn(__fdiv_rn(m_new, __fadd_rn(__fsqrt_rn(v_new), s.eps)),
                __fmul_rn(s.wd, p));
  return __fsub_rn(p, __fmul_rn(s.lr_t, upd));
}

// The leaf whose chunks hold chunk c: start[l] <= c < start[l + 1].
__device__ __forceinline__ int leaf_of(const Table& t, long long c) {
  int lo = 0, hi = t.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.start[mid] <= c) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
fused_adam_multi_kernel(const __grid_constant__ Table t, const Step s) {
  const long long total = t.start[t.count];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < total; c += stride) {
    const int l = leaf_of(t, c);
    const long long e = (c - t.start[l]) * 4;
    const long long rem = t.n[l] - e;
    if (t.vec[l] && rem >= 4) {
      const float4 p = *reinterpret_cast<const float4*>(t.p[l] + e);
      const float4 g = *reinterpret_cast<const float4*>(t.g[l] + e);
      const float4 m = *reinterpret_cast<const float4*>(t.m[l] + e);
      const float4 v = *reinterpret_cast<const float4*>(t.v[l] + e);
      float4 po, mo, vo;
      po.x = adam(p.x, g.x, m.x, v.x, s, mo.x, vo.x);
      po.y = adam(p.y, g.y, m.y, v.y, s, mo.y, vo.y);
      po.z = adam(p.z, g.z, m.z, v.z, s, mo.z, vo.z);
      po.w = adam(p.w, g.w, m.w, v.w, s, mo.w, vo.w);
      *reinterpret_cast<float4*>(t.p_out[l] + e) = po;
      *reinterpret_cast<float4*>(t.m_out[l] + e) = mo;
      *reinterpret_cast<float4*>(t.v_out[l] + e) = vo;
    } else {
      const int k_end = rem < 4 ? static_cast<int>(rem) : 4;
      for (int k = 0; k < k_end; ++k) {
        const long long i = e + k;
        float mo, vo;
        t.p_out[l][i] = adam(t.p[l][i], t.g[l][i], t.m[l][i], t.v[l][i], s,
                             mo, vo);
        t.m_out[l][i] = mo;
        t.v_out[l][i] = vo;
      }
    }
  }
}

}  // namespace

extern "C" int fused_adam_capacity() { return kCapacity; }

// One AdamW step over `count` (<= kCapacity) float32 leaves in one launch.
// ptrs holds seven device pointers a leaf, in the order p, g, m, v, p',
// m', v' (outputs may alias their inputs); n the leaves' lengths (each >
// 0); start their first 4-float chunk in the launch's chunk space (count
// + 1 entries: start[0] = 0, start[i + 1] = start[i] + ceil(n[i] / 4));
// vec 1 for a leaf whose seven pointers are all 16-byte aligned. omb1 =
// 1 - β1 and omb2 = 1 - β2 come from the host, rounded once from double
// as the reference rounds them. Returns cudaErrorInvalidValue, before
// launching, for a table that breaks these rules; else launches on
// `stream` and returns cudaGetLastError().
extern "C" int fused_adam_f32(int count, const unsigned long long* ptrs,
                              const long long* n, const long long* start,
                              const unsigned char* vec, float lr_t, float b1,
                              float omb1, float b2, float omb2, float eps,
                              float wd, void* stream) {
  if (count < 0 || count > kCapacity || start[0] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return 0;
  Table t;
  t.count = count;
  t.start[0] = 0;
  for (int i = 0; i < count; ++i) {
    const unsigned long long* q = ptrs + 7 * i;
    unsigned long long any = 0;
    for (int k = 0; k < 7; ++k) any |= q[k];
    if (n[i] <= 0 || start[i + 1] != start[i] + (n[i] + 3) / 4 ||
        (vec[i] && (any & 15) != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.p[i] = reinterpret_cast<const float*>(q[0]);
    t.g[i] = reinterpret_cast<const float*>(q[1]);
    t.m[i] = reinterpret_cast<const float*>(q[2]);
    t.v[i] = reinterpret_cast<const float*>(q[3]);
    t.p_out[i] = reinterpret_cast<float*>(q[4]);
    t.m_out[i] = reinterpret_cast<float*>(q[5]);
    t.v_out[i] = reinterpret_cast<float*>(q[6]);
    t.n[i] = n[i];
    t.start[i + 1] = start[i + 1];
    t.vec[i] = vec[i] ? 1 : 0;
  }
  const long long total = t.start[count];
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Step s{lr_t, b1, omb1, b2, omb2, eps, wd};
  fused_adam_multi_kernel<<<static_cast<int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(t, s);
  return static_cast<int>(cudaGetLastError());
}
