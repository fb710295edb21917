// Dense single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/decode_attention.py::_decode_kernel
// (launched by _decode_fused). For slot b and kv head h the query group
// q[b, h*G:(h+1)*G, :] ([G, D]) attends over the slot's own dense cache
// rows cache[b, 0..pos[b], h, :]: token t is live iff pos[b] >= t, so the
// live tokens are the first min(pos + 1, S_max); masked scores are -1e30
// (not -inf), as the TPU kernel masks. Softmax is an fp32 online softmax
// (running max, sum, accumulator) over fp32 or bf16 K/V; the output is
// acc / (l == 0 ? 1 : l) in q's dtype.
//
// The cache is addressed by its strides (in elements) along batch, token
// and kv head: the serving engine hands in a per-layer view cache.k[li]
// of an [L, B, S_max, KVH, D] tensor. The last dim must be contiguous and
// every row 16-byte aligned (the wrapper checks both).
//
// What bounds it: HBM bandwidth. Each live K/V token row of a kv head is
// needed once (2 * D * itemsize bytes) and costs 4 * G * D flops, about
// G flops per byte, far below the card's ~295 flops/byte balance point;
// q, out and positions are small. So the floor is (live K/V + q + out +
// positions bytes) / 3.35 TB/s.
//
// Design, and what it does about that bound. One 256-thread block per
// (slot b, kv head h) -- or per group of GT query heads of h when G > 8 or
// G is not a power of two -- walks the slot's live tokens in tiles of 64:
// the loop takes the place of the TPU's sequential third grid axis, and
// the running max / sum / accumulator that lived in VMEM scratch live in
// registers. Tiles are 64 tokens whatever the TPU's block_k says. The q
// group is staged once in shared memory (the resident q block on the
// TPU), and each K/V row is read from HBM once per kv head and serves all
// G query heads from shared memory. Tiles arrive by cp.async into two
// shared-memory stages: the copy of tile i+1 is in flight while tile i is
// computed. Tokens past pos are never loaded, so K/V bytes scale with live
// tokens, not with S_max, and S_max need not be a multiple of 64 (the
// last tile is ragged).
//
// What it leaves on the table (later work): B * KVH blocks (64 at the
// Llama-3-8B decode shape) fill half of the 132 SMs, and a long slot is
// one block's serial walk, bound by that SM's instruction rate rather
// than by HBM. Split-K over the tokens (flash-decoding), tensor-core
// (mma) products and TMA loads are the levers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                   // tokens per tile
constexpr int kSlices = kThreads / kTile;   // D slices in the score phase
constexpr int kMaxD = 256;
constexpr int kRowPad = 16;                 // bytes after each smem row
constexpr int kSmemLimit = 232448;          // 227 KB per block on H100
constexpr float kMaskValue = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* positions;
  void* out;
  int hq, hkv, d, s_max, group;
  long long q_sb, q_sh;
  long long kv_sb, kv_st, kv_sh;            // shared by k and v
  float scale;
  int stages;                               // 1 or 2 cp.async stages
};

// Shared memory: q group [GT][D] f32, score partials [kSlices][GT][kTile],
// probabilities [GT][kTile], alpha [GT], l [GT]; then `stages` tile
// buffers {K rows, V rows}, reused at the end for the cross-thread
// reduction of the accumulators.
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int fixed_bytes(int gt, int d) {
  return round16(4 * (gt * d + kSlices * gt * kTile + gt * kTile + 2 * gt));
}
__host__ __device__ inline int row_stride(int d, int itemsize) {
  return d * itemsize + kRowPad;
}
__host__ __device__ inline int stage_bytes(int d, int itemsize) {
  return 2 * kTile * row_stride(d, itemsize);
}
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight consecutive elements of a row in shared memory, to fp32.
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
}

// Asynchronous 16-byte global -> shared copy.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename QT, typename KVT, int GT>
__global__ void __launch_bounds__(kThreads, 1)
dense_decode_kernel(const Params p) {
  static_assert(GT <= kWarps, "warp g runs query head g's softmax");
  extern __shared__ __align__(16) unsigned char smem[];
  const int per_head = p.group / GT;        // blocks per kv head
  const int h = blockIdx.x / per_head;
  const int hq0 = h * p.group + (blockIdx.x % per_head) * GT;
  const int b = blockIdx.y;
  const int D = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int pos = p.positions[b];
  const int n_tok = pos < 0 ? 0 : min(pos + 1, p.s_max);
  const int n_tiles = (n_tok + kTile - 1) / kTile;

  float* s_q = reinterpret_cast<float*>(smem);
  float* s_part = s_q + GT * D;
  float* s_p = s_part + kSlices * GT * kTile;
  float* s_alpha = s_p + GT * kTile;
  float* s_l = s_alpha + GT;
  unsigned char* s_stage = smem + fixed_bytes(GT, D);
  const int row_s = row_stride(D, sizeof(KVT));
  const int st_bytes = stage_bytes(D, sizeof(KVT));

  {
    const QT* qp = static_cast<const QT*>(p.q)
                   + static_cast<long long>(b) * p.q_sb;
    for (int i = tid; i < GT * D; i += kThreads)
      s_q[i] = to_float(qp[(hq0 + i / D) * p.q_sh + i % D]);
  }
  __syncthreads();

  // Rows of K and V of tile `tile` into stage `st`; rows past n_tok are
  // never read.
  const int cpr = D * static_cast<int>(sizeof(KVT)) / 16;   // copies a row
  const char* kg = static_cast<const char*>(p.k);
  const char* vg = static_cast<const char*>(p.v);
  const long long slot_off =
      (static_cast<long long>(b) * p.kv_sb + h * p.kv_sh) * sizeof(KVT);
  auto load_tile = [&](int tile, int st) {
    unsigned char* buf = s_stage + st * st_bytes;
    const int t0 = tile * kTile;
    const int rows = min(kTile, n_tok - t0);
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = i % cpr;
      const long long off =
          slot_off + static_cast<long long>(t0 + r) * p.kv_st * sizeof(KVT)
          + c * 16;
      cp_async16(buf + r * row_s + c * 16, kg + off);
      cp_async16(buf + (kTile + r) * row_s + c * 16, vg + off);
    }
  };

  // Score phase: thread (token st_t, D slice st_sl).
  const int st_t = tid % kTile;
  const int st_sl = tid / kTile;
  const int chunks = D / 8;
  const int per_slice = (chunks + kSlices - 1) / kSlices;
  const int c_lo = st_sl * per_slice;
  const int c_hi = min(chunks, c_lo + per_slice);
  // P.V phase: thread (token group pv_g, chunk pv_c of 8 elements); the
  // n_groups partial sums meet once, after the last tile.
  const int tpt = pow2_at_least(chunks);
  const int n_groups = kThreads / tpt;
  const int pv_c = tid % tpt;
  const int pv_g = tid / tpt;

  float acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  // Warp g keeps query head g's running max and sum.
  float m_run = -INFINITY;
  float l_run = 0.f;

  if (p.stages == 2 && n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    int st = 0;
    if (p.stages == 2) {
      st = tile & 1;
      if (tile + 1 < n_tiles) load_tile(tile + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                 // tile `tile` has landed
    } else {
      load_tile(tile, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* buf = s_stage + st * st_bytes;
    const unsigned char* k_s = buf;
    const unsigned char* v_s = buf + kTile * row_s;
    const int rows = min(kTile, n_tok - tile * kTile);

    // 1. partial q . k over this thread's D slice, for every query head.
    if (st_t < rows) {
      float part[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) part[g] = 0.f;
      const KVT* krow = reinterpret_cast<const KVT*>(k_s + st_t * row_s);
      for (int c = c_lo; c < c_hi; ++c) {
        float kf[8];
        load8(krow + c * 8, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float qf[8];
          load8(s_q + g * D + c * 8, qf);
#pragma unroll
          for (int i = 0; i < 8; ++i) part[g] += qf[i] * kf[i];
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g)
        s_part[(st_sl * GT + g) * kTile + st_t] = part[g];
    }
    __syncthreads();

    // 2. online softmax of this tile: warp g for query head g.
    if (warp < GT) {
      const int g = warp;
      float s[kTile / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int t = lane + 32 * u;
        float x = kMaskValue;
        if (t < rows) {
          x = 0.f;
#pragma unroll
          for (int sl = 0; sl < kSlices; ++sl)
            x += s_part[(sl * GT + g) * kTile + t];
          x *= p.scale;
        }
        s[u] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int t = lane + 32 * u;
        const float e = expf(s[u] - m_new);
        sum += e;
        s_p[g * kTile + t] = e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + sum;
      m_run = m_new;
      if (lane == 0) s_alpha[g] = alpha;
    }
    __syncthreads();

    // 3. acc = acc * alpha + sum_t p_t * v_t over this thread's tokens.
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float a = s_alpha[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= a;
    }
    if (pv_c < chunks) {
      for (int t = pv_g; t < rows; t += n_groups) {
        float vf[8];
        load8(reinterpret_cast<const KVT*>(v_s + t * row_s) + pv_c * 8, vf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float pt = s_p[g * kTile + t];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] += pt * vf[i];
        }
      }
    }
    __syncthreads();                // the stage is refilled next
  }
  cp_async_wait<0>();

  // 4. sum the n_groups partials of each output element.
  float* red = reinterpret_cast<float*>(s_stage);
  if (pv_c < chunks) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(pv_g * GT + g) * D + pv_c * 8 + i] = acc[g][i];
  }
  if (warp < GT && lane == 0) s_l[warp] = l_run;
  __syncthreads();
  QT* op = static_cast<QT*>(p.out)
           + (static_cast<long long>(b) * p.hq + hq0) * D;
  for (int i = tid; i < GT * D; i += kThreads) {
    const int g = i / D;
    float o = 0.f;
    for (int pg = 0; pg < n_groups; ++pg) o += red[(pg * GT + g) * D + i % D];
    const float l = s_l[g];
    store(op + i, o / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KVT, int GT>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  const int itemsize = sizeof(KVT);
  const int fixed = fixed_bytes(GT, p.d);
  const int n_groups = kThreads / pow2_at_least(p.d / 8);
  const int red = n_groups * GT * p.d * 4;
  const int st = stage_bytes(p.d, itemsize);
  p.stages = fixed + (2 * st > red ? 2 * st : red) <= kSmemLimit ? 2 : 1;
  const int smem = fixed + (p.stages * st > red ? p.stages * st : red);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = dense_decode_kernel<QT, KVT, GT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.hkv * (p.group / GT), batch), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t launch_gt(const Params& p, int batch, cudaStream_t s) {
  // The largest group tile of 8, 4, 2, 1 query heads that divides G.
  if (p.group % 8 == 0) return launch<QT, KVT, 8>(p, batch, s);
  if (p.group % 4 == 0) return launch<QT, KVT, 4>(p, batch, s);
  if (p.group % 2 == 0) return launch<QT, KVT, 2>(p, batch, s);
  return launch<QT, KVT, 1>(p, batch, s);
}

template <typename QT>
cudaError_t launch_kv(const Params& p, int batch, int kv_dtype,
                      cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch_gt<QT, float>(p, batch, s);
    case kBF16: return launch_gt<QT, __nv_bfloat16>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; no synchronisation and no allocation. Strides are
// in elements; k and v share their strides; the last dim of q and the
// cache must be contiguous, cache rows 16-byte aligned, and out a
// contiguous [batch, hq, d] tensor. Returns the launch's cudaError_t (0
// on success).
int ray_tpu_decode_attention(
    const void* q, const void* k, const void* v, const void* positions,
    void* out, int batch, int hq, int hkv, int d, int s_max,
    long long q_sb, long long q_sh, long long kv_sb, long long kv_st,
    long long kv_sh, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (hkv <= 0 || hq % hkv || d <= 0 || d % 8 || d > kMaxD ||
      s_max <= 0 || batch <= 0)
    return cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int32_t*>(positions), out, hq, hkv,
           d, s_max, hq / hkv, q_sb, q_sh, kv_sb, kv_st, kv_sh, scale, 2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return launch_kv<float>(p, batch, kv_dtype, s);
    case kBF16: return launch_kv<__nv_bfloat16>(p, batch, kv_dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
