// Paged single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/paged_decode_attention.py::
// _paged_kernel (launched by _paged_fused). For slot b and kv head h the
// query group q[b, h*G:(h+1)*G, :] ([G, D]) attends over the arena blocks
// named by tables[b, :]. Block j is live iff j*bs <= pos[b]; inside a live
// block column c is live iff pos[b] >= j*bs + c, so the live tokens are
// the slot's first min(pos + 1, nb * bs) logical tokens; masked scores are
// -1e30 (not -inf), as the TPU kernel masks. Softmax is an fp32 online
// softmax (running max, sum, accumulator); int8 arenas dequantize after
// the load with fp32 per-token/per-kv-head scales [NB, bs, KVH]. The
// output is acc / (l == 0 ? 1 : l) in q's dtype.
//
// What bounds it: HBM bandwidth. Each live K/V token row of a kv head is
// needed once (2 * D * itemsize bytes) and costs 4 * G * D flops, about
// G flops per byte, far below the card's ~295 flops/byte balance point;
// q and out are small. So the floor is (live K/V + q + out bytes) / 3.35
// TB/s.
//
// Design (flash-decoding), and what it does about that bound. A long
// slot must not be one block's serial walk, and the card has 132 SMs to
// fill at batch 8. So the slot's token range is cut into chunks of a fixed
// number of 64-token tiles (the host picks the split count from shapes
// alone, never from positions), and one 1-4 warp block per (slot, kv
// head or group tile of GT query heads, chunk) walks its chunk:
// * Each warp takes whole 32-token steps of the chunk (step w, w + warps,
//   ...) and loads them itself by cp.async into its own shared-memory
//   rows (K first, then V, so the scores start while V is in flight): no
//   block barrier a tile. Lane t scores token t against all GT query heads
//   (its full D dot products, q broadcast from shared memory), the warp
//   keeps its own fp32 online softmax per query head, and in P.V each lane
//   owns 8 elements of D over a strided share of the step's tokens.
// * The warps merge once at the end through shared memory, and the block
//   writes its unnormalised partial: acc [GT, D] fp32 and the running max
//   and sum per query head, into a workspace the caller allocates
//   ([B, Hq, splits, D] and [B, Hq, splits, 2]).
// * A second small kernel from the same entry point combines a row's live
//   partials: out = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M), with
//   l == 0 -> 1. Blocks whose chunk lies past pos exit at once and are
//   never read, so dead chunks contribute nothing, and no -inf - (-inf)
//   is formed.
// * The chain before the first product is kept short: a lane fetches its
//   first token's table entry beside pos, and the q group is staged (fp32
//   in shared memory) while the first K/V rows are in flight. A step's K
//   rows, once scored, hold its probabilities, so at D = 128 in bf16 a
//   4-warp block takes 72 KB and three blocks share an SM.
// The host decides the layout (group tile GT, split count, chunk tokens)
// from shapes and passes it in; the entry point checks it and never
// recomputes it.
// The block computes arena offsets from the strides it is given (lane t
// looks up its token's table entry, and the row's offset is shuffled to
// the lanes that copy it), so a slot's blocks need not be adjacent and any
// block size works. Each K/V row is read from HBM once per kv head and
// serves all GT query heads; dead tail entries and tokens past pos are
// never loaded, so K/V bytes scale with live tokens, not with the table
// width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                   // warps per block, at most
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;                   // tokens per tile: the split unit
constexpr int kStep = 32;                   // tokens per warp step, one a lane
constexpr int kMaxD = 256;
constexpr int kMaxTable = 4096;             // table entries a slot may have
constexpr int kMaxSplits = 65535;           // grid.z
constexpr int kRowPad = 16;                 // bytes after each smem row
constexpr int kSmemLimit = 232448;          // 227 KB per block on H100
constexpr float kMaskValue = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* tables;
  const int32_t* positions;
  void* out;
  float* ws_acc;                            // [B, Hq, splits, D]
  float* ws_ml;                             // [B, Hq, splits, 2]: max, sum
  int hq, hkv, d, bs, nb, group, splits;
  int chunk;                                // tokens per split, from the host
  long long q_sb, q_sh;
  long long kv_sn, kv_st, kv_sh;
  long long sc_sn, sc_st, sc_sh;
  long long tab_sb;
  float scale;
};

// Shared memory: the q group [GT][D] fp32, then one region per warp: the
// K area, V rows [kStep][row] and, for int8 arenas, K and V scales
// [kStep] each. The K area holds the step's K rows [kStep][row]; once its
// scores are taken, the step's probabilities [kStep][GT] fp32 while V's
// copies are still in flight, so it is the larger of the two (at D = 8 an
// int8 row is 24 bytes: 768 bytes of rows against 1024 of probabilities
// at GT = 8); at the end it holds the warp's partial (acc [GT][D], max
// [GT], sum [GT]), which kStep rows of at least D + 16 bytes always hold.
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int q_bytes(int gt, int d) {
  return round16(4 * gt * d);
}
__host__ __device__ inline int row_stride(int d, int itemsize) {
  return d * itemsize + kRowPad;
}
__host__ __device__ inline int k_area_bytes(int gt, int d, int itemsize) {
  const int rows = kStep * row_stride(d, itemsize);
  const int probs = kStep * gt * 4;
  return round16(rows > probs ? rows : probs);
}
__host__ __device__ inline int warp_bytes(int gt, int d, int itemsize) {
  return k_area_bytes(gt, d, itemsize) + kStep * row_stride(d, itemsize)
         + (itemsize == 1 ? 2 * kStep * 4 : 0);
}
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Eight consecutive elements of a K/V row from shared memory, to fp32.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {r.x, r.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)     // sign-extend byte i
    o[i] = static_cast<float>(
        static_cast<int32_t>(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
}

// Asynchronous global -> shared copy of N bytes (4, 8 or 16).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(N) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The weight e^(m - M) of a partial with running max m under the merged
// max M; an empty partial (m = -inf) weighs exactly 0.
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

__device__ __forceinline__ int live_tokens(const Params& p, int b) {
  const int pos = p.positions[b];
  return pos < 0 ? 0 : min(pos + 1, p.nb * p.bs);
}

template <typename QT, typename KVT, int GT>
__global__ void __launch_bounds__(kThreads, 3)
paged_split_kernel(const Params p) {
  constexpr bool kQuant = sizeof(KVT) == 1;         // int8 carries scales
  extern __shared__ __align__(16) unsigned char smem[];
  const int per_head = p.group / GT;        // blocks per kv head
  const int h = blockIdx.x / per_head;
  const int hq0 = h * p.group + (blockIdx.x % per_head) * GT;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * p.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int w0 = c0 + warp * kStep;         // this warp's first step
  // The table entry of this lane's first token, fetched beside pos.
  const int first = w0 + lane;
  const int blk0 = first < min(c0 + p.chunk, p.nb * p.bs)
                       ? p.tables[b * p.tab_sb + first / p.bs] : 0;
  const int n_tok = live_tokens(p, b);
  if (c0 >= n_tok) return;                  // the chunk lies past pos
  const int c1 = min(c0 + p.chunk, n_tok);
  const int D = p.d;
  const int row_s = row_stride(D, sizeof(KVT));
  const int w_bytes = warp_bytes(GT, D, sizeof(KVT));

  float* s_q = reinterpret_cast<float*>(smem);
  unsigned char* regions = smem + q_bytes(GT, D);
  unsigned char* k_s = regions + warp * w_bytes;
  unsigned char* v_s = k_s + k_area_bytes(GT, D, sizeof(KVT));
  float* p_s = reinterpret_cast<float*>(k_s);     // [kStep][GT], after scores
  float* ks_s = reinterpret_cast<float*>(v_s + kStep * row_s);  // int8 only
  float* vs_s = ks_s + kStep;

  constexpr int kChunk = sizeof(KVT) == 1 ? 8 : 16;   // bytes per copy
  const int cpr = D * static_cast<int>(sizeof(KVT)) / kChunk;
  const char* kg = static_cast<const char*>(p.k);
  const char* vg = static_cast<const char*>(p.v);
  // K rows (and scales) of the step at t0 as one cp.async group, V rows as
  // the next; lane t looks up token t0 + t's arena row (blk: its table
  // entry), and row r's copies come from the lanes i = r * cpr + c, which
  // learn its offset from lane r (a trip count of cpr for every lane).
  auto load_step = [&](int t0, int blk) {
    const int rows = min(kStep, c1 - t0);
    long long off = 0;
    if (lane < rows) {
      const int tok = t0 + lane;
      off = (static_cast<long long>(blk) * p.kv_sn + (tok % p.bs) * p.kv_st
             + h * p.kv_sh) * static_cast<long long>(sizeof(KVT));
      if (kQuant) {
        const long long so = static_cast<long long>(blk) * p.sc_sn
                             + (tok % p.bs) * p.sc_st + h * p.sc_sh;
        cp_async<4>(ks_s + lane, p.k_scale + so);
        cp_async<4>(vs_s + lane, p.v_scale + so);
      }
    }
    for (int i = lane; i < kStep * cpr; i += 32) {
      const int r = i / cpr, c = i % cpr;
      const long long ro = __shfl_sync(0xffffffffu, off, r);
      if (r < rows)
        cp_async<kChunk>(k_s + r * row_s + c * kChunk, kg + ro + c * kChunk);
    }
    cp_async_commit();
    for (int i = lane; i < kStep * cpr; i += 32) {
      const int r = i / cpr, c = i % cpr;
      const long long ro = __shfl_sync(0xffffffffu, off, r);
      if (r < rows)
        cp_async<kChunk>(v_s + r * row_s + c * kChunk, vg + ro + c * kChunk);
    }
    cp_async_commit();
  };
  if (w0 < c1) load_step(w0, blk0);

  // The q group, staged while the first K/V rows are in flight.
  {
    const QT* qp = static_cast<const QT*>(p.q) + b * p.q_sb;
    for (int i = tid; i < GT * D; i += blockDim.x)
      s_q[i] = to_float(qp[(hq0 + i / D) * p.q_sh + i % D]);
  }
  __syncthreads();

  const int chunks = D / 8;
  // P.V: lane (pv_g, pv_c) owns elements 8 pv_c .. +7 of the tokens
  // pv_g, pv_g + n_tg, ...; the n_tg partial sums meet after the walk.
  const int tpt = pow2_at_least(chunks);
  const int n_tg = 32 / tpt;
  const int pv_c = lane % tpt;
  const int pv_g = lane / tpt;

  float acc[GT][8];
  float m[GT], l[GT];                       // l: this lane's tokens only
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = w0; t0 < c1; t0 += n_warps * kStep) {
    if (t0 != w0) {
      const int tok = t0 + lane;
      load_step(t0, tok < c1 ? p.tables[b * p.tab_sb + tok / p.bs] : 0);
    }
    const int rows = min(kStep, c1 - t0);
    cp_async_wait<1>();                     // K rows (and scales) landed
    __syncwarp();

    // Scores: lane t against every query head of the group.
    float s[GT];
    if (lane < rows) {
#pragma unroll
      for (int g = 0; g < GT; ++g) s[g] = 0.f;
      const KVT* krow = reinterpret_cast<const KVT*>(k_s + lane * row_s);
      for (int c = 0; c < chunks; ++c) {
        float kf[8];
        load8(krow + c * 8, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float qf[8];
          load8(s_q + g * D + c * 8, qf);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[g] += qf[i] * kf[i];
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        // int8: q . (k8 * s) == (q . k8) * s, one scale per token row.
        if (kQuant) s[g] *= ks_s[lane];
        s[g] *= p.scale;
      }
    } else {
#pragma unroll
      for (int g = 0; g < GT; ++g) s[g] = kMaskValue;
    }
    __syncwarp();                           // K rows free for p_s
    // The warp's online softmax, one query head at a time.
    float alpha[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m_new = fmaxf(m[g], warp_max(s[g]));
      alpha[g] = expf(m[g] - m_new);        // 0 on the first step
      const float e = expf(s[g] - m_new);
      l[g] = alpha[g] * l[g] + e;
      m[g] = m_new;
      // V's int8 scale folds into the weight of its row.
      p_s[lane * GT + g] = lane < rows ? (kQuant ? e * vs_s[lane] : e) : 0.f;
    }
    cp_async_wait<0>();                     // V rows landed
    __syncwarp();

    // acc = acc * alpha + sum_t p_t v_t over this lane's share of tokens.
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= alpha[g];
    if (pv_c < chunks) {
      for (int t = pv_g; t < rows; t += n_tg) {
        float vf[8];
        load8(reinterpret_cast<const KVT*>(v_s + t * row_s) + pv_c * 8, vf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float pt = p_s[t * GT + g];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] += pt * vf[i];
        }
      }
    }
    __syncwarp();                           // rows are refilled next step
  }

  // The warp's partial: sums over its lanes, then into its own K rows.
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    l[g] = warp_sum(l[g]);
    for (int o = tpt; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
  }
  float* w_acc = reinterpret_cast<float*>(k_s);     // [GT][D]
  float* w_m = w_acc + GT * D;
  float* w_l = w_m + GT;
  if (pv_g == 0 && pv_c < chunks) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) w_acc[g * D + pv_c * 8 + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      w_m[g] = m[g];
      w_l[g] = l[g];
    }
  }
  __syncthreads();

  // The block's partial (warp 0 always walked a step, so M is finite).
  auto part = [&](int w) {
    return reinterpret_cast<const float*>(regions + w * w_bytes);
  };
  const long long row0 = (static_cast<long long>(b) * p.hq + hq0) * p.splits
                         + blockIdx.z;      // head g: row0 + g * splits
  for (int i = tid; i < GT * D; i += blockDim.x) {
    const int g = i / D;
    float M = -INFINITY;
    for (int w = 0; w < n_warps; ++w) M = fmaxf(M, part(w)[GT * D + g]);
    float a = 0.f;
    for (int w = 0; w < n_warps; ++w)
      a += part(w)[i] * weight(part(w)[GT * D + g], M);
    p.ws_acc[(row0 + static_cast<long long>(g) * p.splits) * D + i % D] = a;
  }
  if (tid < GT) {
    float M = -INFINITY;
    for (int w = 0; w < n_warps; ++w) M = fmaxf(M, part(w)[GT * D + tid]);
    float L = 0.f;
    for (int w = 0; w < n_warps; ++w)
      L += part(w)[GT * D + GT + tid] * weight(part(w)[GT * D + tid], M);
    float* ml = p.ws_ml + (row0 + static_cast<long long>(tid) * p.splits) * 2;
    ml[0] = M;
    ml[1] = L;
  }
}

// One block per (slot, query head), a thread per element of D: the live
// splits' partials, rescaled to their common max, summed and normalised.
template <typename QT>
__global__ void __launch_bounds__(kMaxD)
paged_combine_kernel(const Params p) {
  const int row = blockIdx.x;               // b * Hq + head
  const int d = threadIdx.x;
  const int live = (live_tokens(p, row / p.hq) + p.chunk - 1) / p.chunk;
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

template <typename QT, typename KVT, int GT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int qb = q_bytes(GT, p.d);
  const int wb = warp_bytes(GT, p.d, sizeof(KVT));
  const int warps = min(kWarps, (kSmemLimit - qb) / wb);
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = qb + warps * wb;
  auto kernel = paged_split_kernel<QT, KVT, GT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.hkv * (p.group / GT), batch, p.splits), 32 * warps, smem,
           stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  paged_combine_kernel<QT><<<batch * p.hq, (p.d + 31) / 32 * 32, 0,
                             stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t launch_gt(const Params& p, int gt, int batch, cudaStream_t s) {
  switch (gt) {
    case 8: return launch<QT, KVT, 8>(p, batch, s);
    case 4: return launch<QT, KVT, 4>(p, batch, s);
    case 2: return launch<QT, KVT, 2>(p, batch, s);
    case 1: return launch<QT, KVT, 1>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t launch_kv(const Params& p, int gt, int batch, int kv_dtype,
                      cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch_gt<QT, float>(p, gt, batch, s);
    case kBF16: return launch_gt<QT, __nv_bfloat16>(p, gt, batch, s);
    case kI8: return launch_gt<QT, int8_t>(p, gt, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (the split kernel, then the combine kernel); no
// synchronisation and no allocation. Strides are in elements; the last
// dim of q, the arena and out must be contiguous, and arena rows 16-byte
// aligned. out is [B, Hq, D] contiguous in q's dtype; ws_acc ([B, Hq,
// splits, D]) and ws_ml ([B, Hq, splits, 2]) are fp32 scratch. The
// caller's layout: blocks of gt query heads (1, 2, 4 or 8, dividing the
// group); split i covers tokens [i chunk, (i + 1) chunk), chunk a multiple
// of 64, and every split starts inside the table. Returns the launch's
// cudaError_t (0 on success).
int ray_tpu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* positions,
    void* out, void* ws_acc, void* ws_ml, int batch, int hq, int hkv, int d,
    int bs, int nb, int gt, int splits, int chunk, long long q_sb,
    long long q_sh, long long kv_sn, long long kv_st, long long kv_sh,
    long long sc_sn, long long sc_st, long long sc_sh, long long tab_sb,
    float scale, int q_dtype, int kv_dtype, void* stream) {
  const long long tokens = static_cast<long long>(nb) * bs;
  if (hkv <= 0 || hq % hkv || d <= 0 || d % 8 || d > kMaxD ||
      bs <= 0 || nb <= 0 || nb > kMaxTable || batch <= 0 || batch > 65535 ||
      tokens > (1LL << 30) || gt <= 0 || (hq / hkv) % gt ||
      splits <= 0 || splits > kMaxSplits || chunk <= 0 || chunk % kTile ||
      static_cast<long long>(splits - 1) * chunk >= tokens ||
      static_cast<long long>(splits) * chunk < tokens ||
      (kv_dtype == kI8) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int32_t*>(tables),
           static_cast<const int32_t*>(positions), out,
           static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), hq, hkv,
           d, bs, nb, hq / hkv, splits, chunk, q_sb, q_sh, kv_sn, kv_st,
           kv_sh, sc_sn, sc_st, sc_sh, tab_sb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return launch_kv<float>(p, gt, batch, kv_dtype, s);
    case kBF16: return launch_kv<__nv_bfloat16>(p, gt, batch, kv_dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
