// The order in which PyTorch's `torch.sort` on the card puts float keys,
// for the kernels that reproduce a stable per-row sort bit for bit
// (compact_candidates.cu, bnb_keep.cu). Rows of up to 4,096 keys are
// sorted by cub's block radix sort (`radixSortKVInPlace`), which is
// stable; its order of floats is the unsigned order of `radix_bits`.

#pragma once

#include <cuda_runtime.h>

namespace sort_order {

// A float's radix bits as cub's radix sort orders them: -0.0 taken as
// +0.0, then (Traits<float>::TwiddleIn) the sign bit set flips every bit,
// else the sign bit alone. Unsigned order of these is the order of the
// keys: -NaN, -inf, ..., -0.0 = +0.0, ..., +inf, +NaN (NaNs by payload).
__device__ __forceinline__ unsigned radix_bits(float x) {
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

}  // namespace sort_order
