// The block-row search of bsr_attention.cu's kernels for Hopper (sm_90a):
// a CTA finds its block-row's range in the flattened BSR stream of
// graph/csr.py:BSRMatrix (blocks sorted by (block-row, block-col)) by a
// device-side binary search (searchsorted) over the sorted block_rows, so
// no row pointer is built. The three SpMM kernels walk a NonzeroColumns
// work list instead (bsr_nzc.cuh).
#pragma once

#include <cuda_runtime.h>

namespace bsr {

// The first index i in a[0, n) with a[i] >= key (a sorted ascending).
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace bsr
