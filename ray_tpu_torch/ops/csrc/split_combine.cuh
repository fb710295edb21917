// The combine step of the split-K (flash-decoding) decode-attention
// kernels, shared by decode_attention.cu (dense cache) and
// paged_decode_attention.cu (paged arena).
//
// A split kernel cuts each slot's tokens into `splits` chunks of `chunk`
// tokens; the block of chunk i writes an unnormalised partial for each of
// its query heads into a workspace the caller allocates: acc [B, Hq,
// splits, D] fp32 and (running max, running sum) [B, Hq, splits, 2] fp32.
// Blocks whose chunk lies past pos write nothing. split_combine_kernel
// merges a row's live partials,
//   out = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M),  M = max_i m_i,
// with l == 0 -> 1, in q's dtype. A slot's live splits are the first
// ceil(min(pos + 1, tokens) / chunk); an empty partial (m = -inf) weighs
// exactly 0, so no -inf - (-inf) is ever formed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCombineThreads = 256;        // a thread per element of D

struct CombineParams {
  const float* ws_acc;                      // [B, Hq, splits, D]
  const float* ws_ml;                       // [B, Hq, splits, 2]: max, sum
  const int32_t* positions;                 // [B]
  void* out;                                // [B, Hq, D], q's dtype
  int tokens;                               // the token cap: S_max or nb*bs
  int splits, chunk, hq, d;
};

// The weight e^(m - M) of a partial with running max m under the merged
// max M; an empty partial (m = -inf) weighs exactly 0.
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
}

// One block per (slot, query head), a thread per element of D: the live
// splits' partials, rescaled to their common max, summed and normalised.
template <typename QT>
__global__ void __launch_bounds__(kCombineThreads)
split_combine_kernel(const CombineParams p) {
  const int row = blockIdx.x;               // b * Hq + head
  const int d = threadIdx.x;
  const int pos = p.positions[row / p.hq];
  const int n_tok = pos < 0 ? 0 : min(pos + 1, p.tokens);
  const int live = (n_tok + p.chunk - 1) / p.chunk;
  const float* ml = p.ws_ml + static_cast<long long>(row) * p.splits * 2;
  const float* acc = p.ws_acc + static_cast<long long>(row) * p.splits * p.d;
  float M = -INFINITY;
#pragma unroll 4
  for (int i = 0; i < live; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f, o = 0.f;
#pragma unroll 4
  for (int i = 0; i < live; ++i) {
    const float w = weight(ml[2 * i], M);
    L += ml[2 * i + 1] * w;
    if (d < p.d) o += acc[static_cast<long long>(i) * p.d + d] * w;
  }
  if (d < p.d)
    store(static_cast<QT*>(p.out) + static_cast<long long>(row) * p.d + d,
          o / (L == 0.f ? 1.f : L));
}

// Launch the combine on `stream` after the split kernel; returns the
// launch's cudaError_t.
template <typename QT>
cudaError_t launch_combine(const CombineParams& p, int batch,
                           cudaStream_t stream) {
  split_combine_kernel<QT><<<batch * p.hq, (p.d + 31) / 32 * 32, 0,
                             stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
