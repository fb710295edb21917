// Flash attention on Hopper's tensor cores (sm_90a): the bf16 forward, dQ
// and dK/dV kernels.
//
// Replaces, for bf16 inputs, the TPU kernels of ray_tpu/ops/attention.py:
//   _fwd_kernel  (:74, launched by _fwd)  -> flash_fwd_kernel_sm90
//   _dq_kernel   (:170, launched by _bwd) -> flash_dq_kernel_sm90
//   _dkv_kernel  (:207, launched by _bwd) -> flash_dkv_kernel_sm90
// fp32 inputs run the CUDA-core kernels of flash_attention.cu.
//
// Contract (that of flash_attention.cu): q, out, dO and dq are
// [B, Sq, Hq, D]; k, v, dk and dv are [B, Sk, KVH, D], contiguous bf16; lse
// and delta are fp32 [B, Hq, Sq]. Query head h reads kv head h / (Hq /
// KVH). The causal mask is aligned bottom-right (row r sees key c iff
// r + (sk - sq) >= c); masked scores are -0.7 * FLT_MAX and keys past sk
// score -inf. The forward keeps an fp32 online softmax and writes out =
// acc / (l == 0 ? 1 : l) in bf16 and lse = m + log(l); the backward
// recomputes p = exp(s - lse), ds = p * (dO V^T - delta), dq = scale * ds K,
// dv = p^T dO and dk = scale * ds^T q, dk/dv summed over the query group
// inside the block (no atomics, no per-q-head intermediate). D is 64 or
// 128; lengths need not be multiples of 64.
//
// Numerics. s is bf16 q times bf16 k summed in fp32, then times `scale`
// (the CUDA-core kernels scale q in fp32 first). p and ds are rounded to
// bf16 before the products that consume them (P V, dS K, P^T dO, dS^T Q),
// with fp32 sums; the softmax sum l is taken over the fp32 p; dq and dk are
// multiplied by `scale` once at the end.
//
// What bounds it: at the Llama-3-8B training shape (B=2, S=2048, Hq=32,
// KVH=8, D=128, causal) the forward is ~69 GFLOP, dq ~103 GFLOP and dk/dv
// ~137 GFLOP against ~50-70 MB of inputs and outputs, over 1,000 flops per
// byte: the card's bf16 tensor-core rate bounds all three (989 TFLOP/s),
// not HBM.
//
// What the design does about it (FlashAttention-2's structure):
// * Every product is mma.sync.m16n8k16 on bf16 operands with fp32
//   accumulators; shared memory holds bf16 tiles, never widened, with rows
//   padded by 16 bytes so that ldmatrix reads 8 rows from 8 distinct bank
//   groups. Operands that are row-major along the reduction (V in P V, K in
//   dS K, dO in P^T dO, Q in dS^T Q) load with ldmatrix.trans.
// * K/V (forward, dq) and Q/dO/lse/delta (dk/dv) stream through a ring of
//   two cp.async stages (16-byte copies; rows past the length zero-filled
//   by src-size 0): the next tile's copy is in flight while this one is
//   computed.
// * 4 warps per block, 87 KB (forward), 103 KB (dq) and 103 KB (dk/dv) of
//   shared memory at D = 128, so two blocks share an SM.
// * Forward and dq: one block per (batch, q head, 64-row q tile), heaviest
//   causal tiles first across all heads; each warp owns 16 q rows and turns
//   its fp32 accumulators (scores; dS) into the bf16 A fragments of the next
//   product (P V; dS K) in registers (the m16n8 accumulator layout is the A
//   layout of the next mma), so scores never touch shared memory. The mask
//   is applied only on the diagonal and the ragged last tile. The forward
//   keeps its Q fragments in registers; dq keeps Q and dO resident in
//   shared memory and reloads their fragments each 16-wide k-step, so that
//   the S and dP accumulators (32 + 32 registers) and the dq accumulator
//   (64) fit beside each other without spilling.
// * dk/dv: one block per (batch, kv head, 64-key tile), key tile 0 (the
//   one with the most q tiles under causal masking) first; K and V stay
//   resident in shared memory; each warp owns 16 key rows and walks the
//   group's q tiles from the diagonal on in 16-query chunks: S^T = K Q^T
//   and dP^T = V dO^T in registers, P^T and dS^T become A fragments in
//   registers (no transposed stores), then dV += P^T dO and dK += dS^T Q.
//   The chunking keeps the live registers to the two 16 x D fp32
//   accumulators plus 16 scores, so one warp holds all of D without
//   spilling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 64;                      // q rows per tile
constexpr int kBK = 64;                      // keys per tile
constexpr int kPad = 8;                      // bf16 after each smem row
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int batch, hq, hkv, sq, sk, group, offs, causal;
  float scale;
};

template <int D> struct Tile {
  static constexpr int kRow = D + kPad;      // elements per smem row
  static constexpr int kElems = 64 * kRow;   // one 64-row tile
  static constexpr int kChunks = D / 8;      // 16-byte chunks per row
};

__device__ __forceinline__ long long row_off(int b, int s, int h, int S,
                                             int H, int D) {
  return ((static_cast<long long>(b) * S + s) * H + h) * D;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 to a bf16 pair, round to nearest even; `lo` in the low half
// (the lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane offsets into a row-major [rows][k] smem tile for ldmatrix.x4:
// a_off: the A fragment of a 16x16 block (matrices: rows 0-7/8-15 by
//   k 0-7, then k 8-15);
// b_off: B fragments of two 8-wide n tiles from an [n][k] tile (matrices:
//   n 0-7 by k 0-7/8-15, then n 8-15);
// bt_off: the same from a [k][n] tile with .trans (matrices: k 0-7/8-15
//   by n 0-7, then n 8-15).
template <int D> __device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * Tile<D>::kRow + (lane >> 4) * 8;
}
template <int D> __device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * Tile<D>::kRow
         + ((lane >> 3) & 1) * 8;
}
template <int D> __device__ __forceinline__ int bt_off(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * Tile<D>::kRow
         + (lane >> 4) * 8;
}

// Rows s0 .. s0+63 of head h of a [B, S, H, D] tensor into a padded smem
// tile by cp.async; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int s0, int h, int S, int H) {
  constexpr int kChunks = Tile<D>::kChunks;
#pragma unroll
  for (int it = 0; it < 64 * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = s0 + r < S;
    cp_async16(dst + r * Tile<D>::kRow + c * 8,
               src + row_off(b, ok ? s0 + r : 0, h, S, H, D) + c * 8,
               ok ? 16 : 0);
  }
}

// Entries r0 .. r0+63 of one [Sq] row of lse or delta; past sq are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int sq) {
  if (threadIdx.x < 64) {
    const int r = r0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, src + (r < sq ? r : 0), r < sq ? 4 : 0);
  }
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

// 16 rows of fp32 accumulators ([n tile][4], the m16n8 layout: lane
// (g, t) holds rows g and g + 8, columns 8 j + 2 t, + 1) times `mul` to
// bf16, staged through the warp's own 16 rows of `stage` and stored as
// 16-byte rows of head h of a [B, S, H, D] tensor; rows past S are not
// stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* stage,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1,
                                           bf16* dst, int b, int s0, int h,
                                           int S, int H, int lane) {
  constexpr int kRow = Tile<D>::kRow, kChunks = Tile<D>::kChunks;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * kRow + 8 * j + 2 * t) =
        pack(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kRow + 8 * j + 2 * t) =
        pack(acc[j][2] * mul1, acc[j][3] * mul1);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / kChunks, c = i % kChunks;
    if (s0 + r < S)
      *reinterpret_cast<uint4*>(dst + row_off(b, s0 + r, h, S, H, D) + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kRow + c * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, const Dims p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = Tile<D>::kElems;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTile;                         // [2 stages][kTile]
  bf16* sV = sK + 2 * kTile;                     // [2 stages][kTile]
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int bh = p.batch * p.hq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / bh) * kBQ;
  const int h = blockIdx.x % bh % p.hq, b = blockIdx.x % bh / p.hq;
  const int hk = h / p.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;           // and row0 + 8
  const int nk = key_tiles(p, q0);

  load_tile<D>(sQ, q, b, q0, h, p.sq, p.hq);
  load_tile<D>(sK, k, b, 0, hk, p.sk, p.hkv);
  load_tile<D>(sV, v, b, 0, hk, p.sk, p.hkv);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int ik = 0; ik < nk; ++ik) {
    const int st = ik & 1;
    if (ik + 1 < nk) {
      load_tile<D>(sK + (st ^ 1) * kTile, k, b, (ik + 1) * kBK, hk, p.sk,
                   p.hkv);
      load_tile<D>(sV + (st ^ 1) * kTile, v, b, (ik + 1) * kBK, hk, p.sk,
                   p.hkv);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // tile ik (and Q) landed
    __syncthreads();
    if (ik == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        ldsm_x4(qf[ks], sQ + 16 * warp * Tile<D>::kRow + ks * 16
                            + a_off<D>(lane));
    }
    const bf16* cK = sK + st * kTile;
    const bf16* cV = sV + st * kTile;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4(r, cK + np * 16 * Tile<D>::kRow + ks * 16 + b_off<D>(lane));
        mma(s[2 * np], qf[ks], r[0], r[1]);
        mma(s[2 * np + 1], qf[ks], r[2], r[3]);
      }
    }

    const int k0 = ik * kBK;
    const bool need_mask =
        k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > q0 + p.offs);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (need_mask)
          x = masked(p, x, row0 + (e >> 1) * 8, k0 + 8 * j + 2 * t + (e & 1));
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // Row max across the quad (the 4 lanes of a row).
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * kLog2e);
    const float alpha1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f((s[j][0] - mx0) * kLog2e);
      s[j][1] = exp2f((s[j][1] - mx0) * kLog2e);
      s[j][2] = exp2f((s[j][2] - mx1) * kLog2e);
      s[j][3] = exp2f((s[j][3] - mx1) * kLog2e);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + sum0;                     // this lane's columns only
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha0; o[j][1] *= alpha0;
      o[j][2] *= alpha1; o[j][3] *= alpha1;
    }

    // O += P V: P's accumulators are the A fragments, V loads transposed.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, cV + kk * 16 * Tile<D>::kRow + np * 16 + bt_off<D>(lane));
        mma(o[2 * np], a, r[0], r[1]);
        mma(o[2 * np + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();                             // stage st free to refill
  }
  cp_async_wait<0>();
  __syncthreads();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float li0 = l0 == 0.f ? 1.f : l0, li1 = l1 == 0.f ? 1.f : l1;
  // The warp's own 16 rows of sQ stage its output.
  store_rows<D>(sQ + 16 * warp * Tile<D>::kRow, o, 1.f / li0, 1.f / li1,
                out, b, q0 + 16 * warp, h, p.sq, p.hq, lane);
  if (t == 0) {
    float* lrow = lse + (static_cast<long long>(b) * p.hq + h) * p.sq;
    if (row0 < p.sq) lrow[row0] = m0 + logf(li0);
    if (row0 + 8 < p.sq) lrow[row0 + 8] = m1 + logf(li1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     const Dims p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = Tile<D>::kElems, kRow = Tile<D>::kRow;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kTile;
  bf16* sK = sDO + kTile;                        // [2 stages][kTile]
  bf16* sV = sK + 2 * kTile;                     // [2 stages][kTile]
  float* sL = reinterpret_cast<float*>(sV + 2 * kTile);   // [64]
  float* sDelta = sL + kBQ;                               // [64]
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int bh = p.batch * p.hq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / bh) * kBQ;
  const int h = blockIdx.x % bh % p.hq, b = blockIdx.x % bh / p.hq;
  const int hk = h / p.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;           // and row0 + 8
  const int nk = key_tiles(p, q0);
  const long long lrow = (static_cast<long long>(b) * p.hq + h) * p.sq;

  load_tile<D>(sQ, q, b, q0, h, p.sq, p.hq);
  load_tile<D>(sDO, dout, b, q0, h, p.sq, p.hq);
  load_rows(sL, lse + lrow, q0, p.sq);
  load_rows(sDelta, delta + lrow, q0, p.sq);
  load_tile<D>(sK, k, b, 0, hk, p.sk, p.hkv);
  load_tile<D>(sV, v, b, 0, hk, p.sk, p.hkv);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // This lane's rows' lse and delta (rows past sq read 0: their dO rows
  // are zero, so their ds is 0).
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  const bf16* wQ = sQ + 16 * warp * kRow + a_off<D>(lane);
  const bf16* wDO = sDO + 16 * warp * kRow + a_off<D>(lane);

  for (int ik = 0; ik < nk; ++ik) {
    const int st = ik & 1;
    if (ik + 1 < nk) {
      load_tile<D>(sK + (st ^ 1) * kTile, k, b, (ik + 1) * kBK, hk, p.sk,
                   p.hkv);
      load_tile<D>(sV + (st ^ 1) * kTile, v, b, (ik + 1) * kBK, hk, p.sk,
                   p.hkv);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // tile ik (and Q, dO) landed
    __syncthreads();
    if (ik == 0) {
      lse0 = sL[16 * warp + g];
      lse1 = sL[16 * warp + g + 8];
      dl0 = sDelta[16 * warp + g];
      dl1 = sDelta[16 * warp + g + 8];
    }
    const bf16* cK = sK + st * kTile;
    const bf16* cV = sV + st * kTile;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp; the A fragments
    // of Q and dO reload from shared memory each k-step.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, wQ + ks * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4(r, cK + np * 16 * kRow + ks * 16 + b_off<D>(lane));
        mma(s[2 * np], a, r[0], r[1]);
        mma(s[2 * np + 1], a, r[2], r[3]);
      }
      ldsm_x4(a, wDO + ks * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4(r, cV + np * 16 * kRow + ks * 16 + b_off<D>(lane));
        mma(dp[2 * np], a, r[0], r[1]);
        mma(dp[2 * np + 1], a, r[2], r[3]);
      }
    }

    // P = exp(S scale - lse), dS = P (dP - delta), in place of S.
    const int k0 = ik * kBK;
    const bool need_mask =
        k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > q0 + p.offs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (need_mask)
          x = masked(p, x, row0 + (e >> 1) * 8, k0 + 8 * j + 2 * t + (e & 1));
        const float pe = exp2f((x - (e < 2 ? lse0 : lse1)) * kLog2e);
        s[j][e] = pe * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K: dS's accumulators are the A fragments, K loads
    // transposed.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, cK + kk * 16 * kRow + np * 16 + bt_off<D>(lane));
        mma(acc[2 * np], a, r[0], r[1]);
        mma(acc[2 * np + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();                             // stage st free to refill
  }
  cp_async_wait<0>();
  __syncthreads();
  // The warp's own 16 rows of sQ stage its dq.
  store_rows<D>(sQ + 16 * warp * kRow, acc, p.scale, p.scale, dq, b,
                q0 + 16 * warp, h, p.sq, p.hq, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, const Dims p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = Tile<D>::kElems;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile;
  bf16* sQ = sV + kTile;                         // [2 stages][kTile]
  bf16* sDO = sQ + 2 * kTile;                    // [2 stages][kTile]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kTile);   // [2][64]
  float* sDelta = sL + 2 * kBQ;                            // [2][64]
  const int bh = p.batch * p.hkv;
  const int k0 = static_cast<int>(blockIdx.x) / bh * kBK;
  const int hk = blockIdx.x % bh % p.hkv, b = blockIdx.x % bh / p.hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.sq + kBQ - 1) / kBQ;
  // Under the causal mask, q tiles before the one holding row k0 - offs
  // (the first row that sees key k0) see no key of this tile.
  int iq0 = 0;
  if (p.causal && k0 - p.offs > 0) iq0 = min(nq, (k0 - p.offs) / kBQ);
  const int per_head = nq - iq0;
  const int items = p.group * per_head;          // (q head, q tile) pairs

  auto load_item = [&](int it, int st) {
    const int h = hk * p.group + it / per_head;
    const int q0 = (iq0 + it % per_head) * kBQ;
    const long long row = (static_cast<long long>(b) * p.hq + h) * p.sq;
    load_tile<D>(sQ + st * kTile, q, b, q0, h, p.sq, p.hq);
    load_tile<D>(sDO + st * kTile, dout, b, q0, h, p.sq, p.hq);
    load_rows(sL + st * kBQ, lse + row, q0, p.sq);
    load_rows(sDelta + st * kBQ, delta + row, q0, p.sq);
  };

  load_tile<D>(sK, k, b, k0, hk, p.sk, p.hkv);
  load_tile<D>(sV, v, b, k0, hk, p.sk, p.hkv);
  if (items > 0) load_item(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const bf16* wK = sK + 16 * warp * Tile<D>::kRow + a_off<D>(lane);
  const bf16* wV = sV + 16 * warp * Tile<D>::kRow + a_off<D>(lane);
  const int key0 = k0 + 16 * warp + g;           // this lane's keys: +0, +8

  for (int it = 0; it < items; ++it) {
    const int st = it & 1;
    if (it + 1 < items) load_item(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (iq0 + it % per_head) * kBQ;
    const bool need_mask =
        q0 + kBQ > p.sq || (p.causal && q0 + p.offs < k0 + kBK - 1);
    const bf16* cQ = sQ + st * kTile;
    const bf16* cDO = sDO + st * kTile;
    const float* cL = sL + st * kBQ;
    const float* cDelta = sDelta + st * kBQ;

#pragma unroll 1
    for (int c = 0; c < kBQ / 16; ++c) {         // 16-query chunks
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries a warp.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const int qrow = c * 16 * Tile<D>::kRow + b_off<D>(lane);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t a[4], r[4];
        ldsm_x4(a, wK + ks * 16);
        ldsm_x4(r, cQ + qrow + ks * 16);
        mma(s[0], a, r[0], r[1]);
        mma(s[1], a, r[2], r[3]);
        ldsm_x4(a, wV + ks * 16);
        ldsm_x4(r, cDO + qrow + ks * 16);
        mma(dp[0], a, r[0], r[1]);
        mma(dp[1], a, r[2], r[3]);
      }
      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta); lane (g, t)
      // holds keys key0 (+8) and queries c*16 + 8 j + 2 t (+1).
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = c * 16 + 8 * j + 2 * t;
        const float2 L = *reinterpret_cast<const float2*>(cL + qi);
        const float2 Dl = *reinterpret_cast<const float2*>(cDelta + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? L.y : L.x;
          const float dq = (e & 1) ? Dl.y : Dl.x;
          float x = s[j][e] * p.scale;
          float pe;
          if (need_mask) {
            const int r = q0 + qi + (e & 1);
            pe = r < p.sq ? exp2f((masked(p, x, r, key0 + (e >> 1) * 8) - lq)
                                  * kLog2e)
                          : 0.f;
          } else {
            pe = exp2f((x - lq) * kLog2e);
          }
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - dq);
        }
      }
      const uint32_t ap[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                              pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
      const uint32_t ad[4] = {pack(dp[0][0], dp[0][1]),
                              pack(dp[0][2], dp[0][3]),
                              pack(dp[1][0], dp[1][1]),
                              pack(dp[1][2], dp[1][3])};
      // dV += P^T dO, dK += dS^T Q: dO and Q load transposed.
      const int trow = c * 16 * Tile<D>::kRow + bt_off<D>(lane);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, cDO + trow + np * 16);
        mma(dv_acc[2 * np], ap, r[0], r[1]);
        mma(dv_acc[2 * np + 1], ap, r[2], r[3]);
        ldsm_x4_t(r, cQ + trow + np * 16);
        mma(dk_acc[2 * np], ad, r[0], r[1]);
        mma(dk_acc[2 * np + 1], ad, r[2], r[3]);
      }
    }
    __syncthreads();                             // stage st free to refill
  }
  cp_async_wait<0>();
  __syncthreads();
  // Each warp stages its own 16 key rows of dK in sK and of dV in sV.
  store_rows<D>(sK + 16 * warp * Tile<D>::kRow, dk_acc, p.scale, p.scale,
                dk, b, k0 + 16 * warp, hk, p.sk, p.hkv, lane);
  store_rows<D>(sV + 16 * warp * Tile<D>::kRow, dv_acc, 1.f, 1.f, dv, b,
                k0 + 16 * warp, hk, p.sk, p.hkv, lane);
}

template <int D> constexpr int fwd_smem() {
  return 2 * 5 * Tile<D>::kElems;                // Q, 2 x K, 2 x V
}
template <int D> constexpr int dq_smem() {
  return 2 * 6 * Tile<D>::kElems + 2 * 4 * kBQ;  // Q, dO, 2 x (K, V), rows
}
template <int D> constexpr int dkv_smem() {
  return 2 * 6 * Tile<D>::kElems + 4 * 4 * kBQ;  // K, V, 2 x (Q, dO), rows
}
static_assert(fwd_smem<128>() <= 110 * 1024, "forward: two blocks an SM");
static_assert(dq_smem<128>() <= 110 * 1024, "dq: two blocks an SM");
static_assert(dkv_smem<128>() <= 110 * 1024, "dk/dv: two blocks an SM");

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *out, *dq, *dk, *dv;
  float* lse_out;
  Dims p;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D>
cudaError_t launch_fwd(const Args& a, cudaStream_t stream) {
  const Dims& p = a.p;
  auto kernel = flash_fwd_kernel_sm90<D>;
  cudaError_t err = prepare(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((p.sq + kBQ - 1) / kBQ) * p.hq * p.batch;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse_out, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const Dims& p = a.p;
  auto kernel = flash_dq_kernel_sm90<D>;
  cudaError_t err = prepare(kernel, dq_smem<D>());
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((p.sq + kBQ - 1) / kBQ) * p.hq * p.batch;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, dq_smem<D>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      a.lse_in, a.delta, static_cast<bf16*>(a.dq), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const Dims& p = a.p;
  auto kernel = flash_dkv_kernel_sm90<D>;
  cudaError_t err = prepare(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((p.sk + kBK - 1) / kBK) * p.hkv * p.batch;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, dkv_smem<D>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      a.lse_in, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      p);
  return cudaGetLastError();
}

bool make_dims(Dims* p, int batch, int hq, int hkv, int sq, int sk,
               float scale, int causal) {
  if (batch <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || sk <= 0) return false;
  p->batch = batch;
  p->hq = hq;
  p->hkv = hkv;
  p->sq = sq;
  p->sk = sk;
  p->group = hq / hkv;
  p->offs = sk - sq;
  p->causal = causal != 0;
  p->scale = scale;
  return true;
}

}  // namespace

extern "C" {

// Each launches on `stream` with no synchronisation and no allocation, and
// returns the launch's cudaError_t (0 on success). All tensors contiguous
// bf16 in the layouts of the header (lse and delta fp32); d is 64 or 128.
int ray_tpu_flash_fwd_sm90(const void* q, const void* k, const void* v,
                           void* out, float* lse, int batch, int hq, int hkv,
                           int sq, int sk, int d, float scale, int causal,
                           void* stream) {
  Args a{};
  if (!make_dims(&a.p, batch, hq, hkv, sq, sk, scale, causal))
    return cudaErrorInvalidValue;
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse_out = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_fwd<64>(a, s);
    case 128: return launch_fwd<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int ray_tpu_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int batch, int hq,
                              int hkv, int sq, int sk, int d, float scale,
                              int causal, void* stream) {
  Args a{};
  if (!make_dims(&a.p, batch, hq, hkv, sq, sk, scale, causal))
    return cudaErrorInvalidValue;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse;
  a.delta = delta; a.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(a, s);
    case 128: return launch_dq<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int ray_tpu_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv,
                               int batch, int hq, int hkv, int sq, int sk,
                               int d, float scale, int causal, void* stream) {
  Args a{};
  if (!make_dims(&a.p, batch, hq, hkv, sq, sk, scale, causal))
    return cudaErrorInvalidValue;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse;
  a.delta = delta; a.dk = dk; a.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64>(a, s);
    case 128: return launch_dkv<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
