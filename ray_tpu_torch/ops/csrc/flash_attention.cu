// Flash attention for Hopper (sm_90a) on the CUDA cores: the fp32 forward,
// dQ and dK/dV kernels.
//
// Replaces, for fp32 inputs, the TPU kernels of ray_tpu/ops/attention.py:
//   _fwd_kernel  (launched by _fwd)  -> flash_fwd_kernel
//   _dq_kernel   (launched by _bwd)  -> flash_dq_kernel
//   _dkv_kernel  (launched by _bwd)  -> flash_dkv_kernel
// bf16 inputs run all three on the tensor cores instead
// (flash_attention_sm90.cu); this file builds no bf16 instantiation.
// The arithmetic is the TPU's: q is upcast to fp32 and multiplied by `scale`
// before the product, s = (q*scale) K^T in fp32, causal masking aligned
// bottom-right (row r sees key c iff r + (sk - sq) >= c) with masked scores
// set to -0.7 * FLT_MAX (DEFAULT_MASK_VALUE), an fp32 online softmax (running
// max, sum and accumulator), out = acc / (l == 0 ? 1 : l) in q's dtype and
// lse = m + log(l) in fp32. The backward recomputes p = exp(s - lse),
// dp = dO V^T, ds = p * (dp - delta) with delta = rowsum(dO * O) computed
// before the launch, dq = scale * ds K, dk = ds^T (q*scale), dv = p^T dO.
//
// Layouts: q, out, dO and dq are [B, Sq, Hq, D]; k, v, dk and dv are
// [B, Sk, KVH, D], all contiguous; lse and delta are fp32 [B, Hq, Sq] (the
// TPU's trailing 1 of [B, Hq, Sq, 1] was a tiling artefact). Query head h
// reads kv head h / (Hq / KVH) (GQA). Inputs are fp32; all math is fp32 on
// CUDA cores.
//
// What bounds it: at the Llama-3-8B training shape (B=2, S=2048, Hq=32,
// KVH=8, D=128, causal) the work is ~69 GFLOP per forward against ~50 MB of
// inputs and outputs, about 1,400 flops per byte, so the card's arithmetic
// rate bounds it, not HBM. These kernels run that arithmetic as fp32 FMAs
// (67 TFLOP/s peak), which is fp32's own rate: tensor cores would make it
// tf32, other arithmetic. bf16 has the tensor-core kernels.
//
// Design. The TPU walks the sequential innermost grid axis with the running
// softmax (or the dq / dk / dv sums) in VMEM scratch; CUDA blocks run in no
// order, so each block owns one output tile and walks the other axis in a
// loop, with its sums in registers:
// * forward and dq: one block of 256 threads per (batch, q head, 64-row q
//   tile); it walks the 64-key K/V tiles up to the causal diagonal (tiles
//   above it are never loaded). The heaviest q tiles (the last rows) start
//   first, which evens out the tail of the causal triangle.
// * dk/dv: one block per (batch, KV head, 64-key tile); it loops over the
//   group's q heads and, for each, over the q tiles from the diagonal on, so
//   dk and dv of a kv head are summed over its whole group in fp32 registers
//   and written once in k's dtype: no per-q-head [B, Hq, Sk, D] fp32
//   intermediate and no group sum afterwards (ray_tpu/ops/attention.py:310),
//   and no atomics.
// Tiles are staged in shared memory as fp32 (q scaled on load); thread (ty, tx) of a 16 x 16 grid owns score rows ty + 16 i and
// columns tx + 16 j (i, j < 4), and output rows ty + 16 i, columns
// 4 tx + 64 jj .. +3. Row max and sum meet across the 16 lanes of a half
// warp by shuffles. Out-of-range rows and keys (lengths that are not a
// multiple of 64) are zero-filled on load, never stored, and out-of-range
// keys score -inf so they add nothing.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                      // q rows per tile
constexpr int kBK = 64;                      // keys per tile
constexpr int kPad = 4;                      // floats after each smem row
constexpr int kPRow = kBK + kPad;            // row of a score tile
constexpr int kSmemLimit = 232448;           // 227 KB per block on H100
constexpr float kMaskValue = -0.7f * FLT_MAX;

enum DType { kF32 = 0 };            // the only dtype code taken here

struct Dims {
  int hq, hkv, sq, sk, group, offs, causal;
  float scale;
};

__device__ __forceinline__ long long row_off(int b, int s, int h, int S,
                                             int H, int D) {
  return ((static_cast<long long>(b) * S + s) * H + h) * D;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows s0 .. s0+63 of head h of a [B, S, H, D] tensor into an fp32 smem
// tile [64][D + kPad], times `mul`; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int s0, int h, int S, int H,
                                          float mul) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S) {
      v = load4(src + row_off(b, s0 + r, h, S, H, D) + c);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    store4(dst + r * (D + kPad) + c, v);
  }
}

// s[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over [64][D + kPad]
// tiles.
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int kRow = D + kPad;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * kRow + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(B + (tx + 16 * j) * kRow + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][jj] += sum_t P[ty + 16 i][t] * V[t][4 tx + 64 jj .. +3] over the
// 64 columns t of P ([64][kPRow]) and the 64 rows of V ([64][D + kPad]).
template <int D>
__device__ __forceinline__ void pv_tile(float4 (&acc)[4][D / 64],
                                        const float* P, const float* V,
                                        int ty, int tx) {
  constexpr int kRow = D + kPad;
#pragma unroll 2
  for (int t = 0; t < kBK; t += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = load4(P + (ty + 16 * i) * kPRow + t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 v = load4(V + (t + u) * kRow + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y
                         : u == 2 ? p[i].z : p[i].w;
          acc[i][jj].x = fmaf(pu, v.x, acc[i][jj].x);
          acc[i][jj].y = fmaf(pu, v.y, acc[i][jj].y);
          acc[i][jj].z = fmaf(pu, v.z, acc[i][jj].z);
          acc[i][jj].w = fmaf(pu, v.w, acc[i][jj].w);
        }
      }
    }
  }
}

// Across the 16 lanes of a half warp (the threads of one score row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The number of key tiles q tile [q0, q0 + 64) reads: all of them, or up to
// the last key its last row sees under the causal mask.
__device__ __forceinline__ int key_tiles(const Dims& p, int q0) {
  const int nk = (p.sk + kBK - 1) / kBK;
  if (!p.causal) return nk;
  const int last = min(q0 + kBQ, p.sq) - 1 + p.offs;
  return last < 0 ? 0 : min(nk, last / kBK + 1);
}

// Masked score of row r and key c: -inf past the keys, the mask value
// above the causal diagonal.
__device__ __forceinline__ float masked(const Dims& p, float s, int r, int c) {
  if (c >= p.sk) return -INFINITY;
  if (p.causal && r + p.offs < c) return kMaskValue;
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const Dims p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRow = D + kPad;
  float* sQ = smem;
  float* sK = sQ + kBQ * kRow;
  float* sV = sK + kBK * kRow;
  float* sP = sV + kBK * kRow;                   // [kBQ][kPRow]
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(sQ, q, b, q0, h, p.sq, p.hq, p.scale);
  float m[4], l[4];
  float4 acc[4][D / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) acc[i][jj] = make_float4(0, 0, 0, 0);
  }
  const int nk = key_tiles(p, q0);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kBK;
    __syncthreads();                       // the last tile's readers are done
    load_tile<T, D>(sK, k, b, k0, hk, p.sk, p.hkv, 1.f);
    load_tile<T, D>(sV, v, b, k0, hk, p.sk, p.hkv, 1.f);
    __syncthreads();
    float s[4][4] = {};
    dot_tile<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(p, s[i][j], r, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        sP[(ty + 16 * i) * kPRow + tx + 16 * j] = e;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        acc[i][jj].x *= alpha; acc[i][jj].y *= alpha;
        acc[i][jj].z *= alpha; acc[i][jj].w *= alpha;
      }
    }
    __syncthreads();
    pv_tile<D>(acc, sP, sV, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + row_off(b, r, h, p.sq, p.hq, D);
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      const float4 a = acc[i][jj];
      store4(orow + 4 * tx + 64 * jj,
             make_float4(a.x / li, a.y / li, a.z / li, a.w / li));
    }
    if (tx == 0)
      lse[(static_cast<long long>(b) * p.hq + h) * p.sq + r] = m[i] + logf(li);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                const Dims p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRow = D + kPad;
  float* sQ = smem;
  float* sDO = sQ + kBQ * kRow;
  float* sK = sDO + kBQ * kRow;
  float* sV = sK + kBK * kRow;
  float* sDS = sV + kBK * kRow;                  // [kBQ][kPRow]
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(sQ, q, b, q0, h, p.sq, p.hq, p.scale);
  load_tile<T, D>(sDO, dout, b, q0, h, p.sq, p.hq, 1.f);
  float row_lse[4], row_delta[4];
  float4 acc[4][D / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const long long at = (static_cast<long long>(b) * p.hq + h) * p.sq + r;
    row_lse[i] = r < p.sq ? lse[at] : 0.f;
    row_delta[i] = r < p.sq ? delta[at] : 0.f;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) acc[i][jj] = make_float4(0, 0, 0, 0);
  }
  const int nk = key_tiles(p, q0);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kBK;
    __syncthreads();
    load_tile<T, D>(sK, k, b, k0, hk, p.sk, p.hkv, 1.f);
    load_tile<T, D>(sV, v, b, k0, hk, p.sk, p.hkv, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<D>(s, sQ, sK, ty, tx);
    dot_tile<D>(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(masked(p, s[i][j], r, k0 + tx + 16 * j)
                               - row_lse[i]);
        sDS[(ty + 16 * i) * kPRow + tx + 16 * j] =
            pij * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    pv_tile<D>(acc, sDS, sK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.sq) continue;
    T* row = dq + row_off(b, r, h, p.sq, p.hq, D);
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      const float4 a = acc[i][jj];
      store4(row + 4 * tx + 64 * jj,
             make_float4(a.x * p.scale, a.y * p.scale, a.z * p.scale,
                         a.w * p.scale));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, const Dims p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRow = D + kPad;
  float* sK = smem;
  float* sV = sK + kBK * kRow;
  float* sQ = sV + kBK * kRow;
  float* sDO = sQ + kBQ * kRow;
  float* sPt = sDO + kBQ * kRow;                 // [kBK][kPRow]: p^T
  float* sDSt = sPt + kBK * kPRow;               // [kBK][kPRow]: ds^T
  float* sL = sDSt + kBK * kPRow;                // [kBQ]
  float* sDelta = sL + kBQ;                      // [kBQ]
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nq = (p.sq + kBQ - 1) / kBQ;

  load_tile<T, D>(sK, k, b, k0, hk, p.sk, p.hkv, 1.f);
  load_tile<T, D>(sV, v, b, k0, hk, p.sk, p.hkv, 1.f);
  float4 dk_acc[4][D / 64], dv_acc[4][D / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      dk_acc[i][jj] = make_float4(0, 0, 0, 0);
      dv_acc[i][jj] = make_float4(0, 0, 0, 0);
    }
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * kBQ;
      // Below the diagonal only: the tile's last row must see key k0.
      if (p.causal && min(q0 + kBQ, p.sq) - 1 + p.offs < k0) continue;
      __syncthreads();                     // the last tile's readers are done
      load_tile<T, D>(sQ, q, b, q0, h, p.sq, p.hq, p.scale);
      load_tile<T, D>(sDO, dout, b, q0, h, p.sq, p.hq, 1.f);
      if (threadIdx.x < kBQ) {
        const int r = q0 + threadIdx.x;
        const long long at = (static_cast<long long>(b) * p.hq + h) * p.sq + r;
        sL[threadIdx.x] = r < p.sq ? lse[at] : 0.f;
        sDelta[threadIdx.x] = r < p.sq ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      dot_tile<D>(s, sQ, sK, ty, tx);       // rows: q, columns: keys
      dot_tile<D>(dp, sDO, sV, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rq = ty + 16 * i;
        const int r = q0 + rq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ck = tx + 16 * j;
          const float pij = r < p.sq
              ? expf(masked(p, s[i][j], r, k0 + ck) - sL[rq]) : 0.f;
          sPt[ck * kPRow + rq] = pij;
          sDSt[ck * kPRow + rq] = pij * (dp[i][j] - sDelta[rq]);
        }
      }
      __syncthreads();
      pv_tile<D>(dv_acc, sPt, sDO, ty, tx);    // rows: keys, sum over q
      pv_tile<D>(dk_acc, sDSt, sQ, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= p.sk) continue;
    const long long off = row_off(b, r, hk, p.sk, p.hkv, D);
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      store4(dk + off + 4 * tx + 64 * jj, dk_acc[i][jj]);
      store4(dv + off + 4 * tx + 64 * jj, dv_acc[i][jj]);
    }
  }
}

template <int D> constexpr int fwd_smem() {
  return 4 * ((kBQ + 2 * kBK) * (D + kPad) + kBQ * kPRow);
}
template <int D> constexpr int dq_smem() {
  return 4 * ((2 * kBQ + 2 * kBK) * (D + kPad) + kBQ * kPRow);
}
template <int D> constexpr int dkv_smem() {
  return 4 * ((2 * kBQ + 2 * kBK) * (D + kPad) + 2 * kBK * kPRow + 2 * kBQ);
}
static_assert(dkv_smem<128>() <= kSmemLimit, "dk/dv tiles exceed smem");

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *out, *dq, *dk, *dv;
  float* lse_out;
  int batch;
  Dims p;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t launch(Which which, const Args& a, cudaStream_t stream) {
  const Dims& p = a.p;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 q_grid((p.sq + kBQ - 1) / kBQ, p.hq, a.batch);
  cudaError_t err;
  switch (which) {
    case kFwd: {
      auto kernel = flash_fwd_kernel<T, D>;
      if ((err = prepare(kernel, fwd_smem<D>())) != cudaSuccess) return err;
      kernel<<<q_grid, kThreads, fwd_smem<D>(), stream>>>(
          q, k, v, static_cast<T*>(a.out), a.lse_out, p);
      break;
    }
    case kDq: {
      auto kernel = flash_dq_kernel<T, D>;
      if ((err = prepare(kernel, dq_smem<D>())) != cudaSuccess) return err;
      kernel<<<q_grid, kThreads, dq_smem<D>(), stream>>>(
          q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.dq), p);
      break;
    }
    case kDkv: {
      auto kernel = flash_dkv_kernel<T, D>;
      if ((err = prepare(kernel, dkv_smem<D>())) != cudaSuccess) return err;
      const dim3 grid((p.sk + kBK - 1) / kBK, p.hkv, a.batch);
      kernel<<<grid, kThreads, dkv_smem<D>(), stream>>>(
          q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), p);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(Which which, int d, const Args& a, cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(which, a, s);
    case 128: return launch<T, 128>(which, a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(Which which, int d, int dtype, Args a, void* stream) {
  if (a.batch <= 0 || a.p.hkv <= 0 || a.p.hq % a.p.hkv || a.p.sq <= 0 ||
      a.p.sk <= 0 || a.p.hq > 65535 || a.batch > 65535)
    return cudaErrorInvalidValue;
  a.p.group = a.p.hq / a.p.hkv;
  a.p.offs = a.p.sk - a.p.sq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16 runs flash_attention_sm90.cu.
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch_d<float>(which, d, a, s);
}

Args make_args(int batch, int hq, int hkv, int sq, int sk, float scale,
               int causal) {
  Args a{};
  a.batch = batch;
  a.p.hq = hq;
  a.p.hkv = hkv;
  a.p.sq = sq;
  a.p.sk = sk;
  a.p.causal = causal != 0;
  a.p.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// Each launches on `stream` with no synchronisation and no allocation, and
// returns the launch's cudaError_t (0 on success). All tensors contiguous
// fp32, in the layouts of the header; d is 64 or 128; dtype must be 0
// (fp32): any other code returns cudaErrorInvalidValue.
int ray_tpu_flash_fwd(const void* q, const void* k, const void* v,
                      void* out, float* lse, int batch, int hq, int hkv,
                      int sq, int sk, int d, float scale, int causal,
                      int dtype, void* stream) {
  Args a = make_args(batch, hq, hkv, sq, sk, scale, causal);
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse_out = lse;
  return dispatch(kFwd, d, dtype, a, stream);
}

int ray_tpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int batch, int hq,
                         int hkv, int sq, int sk, int d, float scale,
                         int causal, int dtype, void* stream) {
  Args a = make_args(batch, hq, hkv, sq, sk, scale, causal);
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse;
  a.delta = delta; a.dq = dq;
  return dispatch(kDq, d, dtype, a, stream);
}

int ray_tpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dk, void* dv, int batch,
                          int hq, int hkv, int sq, int sk, int d,
                          float scale, int causal, int dtype, void* stream) {
  Args a = make_args(batch, hq, hkv, sq, sk, scale, causal);
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse;
  a.delta = delta; a.dk = dk; a.dv = dv;
  return dispatch(kDkv, d, dtype, a, stream);
}

const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
