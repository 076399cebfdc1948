// K2: paged decode attention for Hopper (sm_90a).
//
// Replaces jlama_tpu/ops/pallas_attention.py:_paged_decode_kernel (launched
// by _paged_decode_jit), and with it the library paged_attention branch of
// jlama_tpu/nn/layers.py. Computes, for one query token per batch row (T = 1)
// with GQA (g = H / n_kv query heads per KV head):
//   out[b, h] = sum_s p[s] v[s] / sum_s p[s],  p[s] = exp(z[s] - max z),
//   z[s] = cap(scale * q[b, h] . k[s])
// over the row's keys s < lengths[b] (and s >= lengths[b] - window with a
// window), read through the page table: key s lives in slot s % ps of page
// page_tables[b, s / ps]. cap(z) = tanh(z / c) * c when a softcap is given.
// Scores, running max, sum, probabilities and accumulator are f32. As in the
// TPU kernel, q8 values are dequantized (int8 times the f32 scale of their
// block of blk) and rounded to bf16 before the dots; unlike it, the
// probabilities stay f32 when they multiply V (the TPU kernel rounds them to
// the pool's value type, which ties the result to the running max). A row
// with no live key (l == 0) writes zeros.
//
// What bounds it on the H100: bytes (the live K/V pages are read once; the
// operations are 4 * g * hd per key, far below the card's rate).
//
// Design (simple first): one block of 4 warps per (KV head, batch row, group
// of up to 16 query rows), so a group g > 16 (MQA) takes ceil(g / 16) blocks
// of the same KV head, each holding its own rows. It walks only the row's live pages (the
// window skips whole pages below it), 64 keys at a time: the K/V tile is
// dequantized into shared memory as f32 (K padded by one column, so that
// consecutive keys sit in consecutive banks), then one thread per (query row,
// key) scores, one warp per query row updates the online softmax with
// shuffles, and each thread accumulates its fixed (query row, dim) outputs
// of P.V in registers. q takes any (b, h) strides; the pools any (h, page,
// slot) strides with a unit stride along hd, so a layer's slice of the
// stacked pool is read in place. hd is 64 or 128; g is any divisor of H.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum QType { kQF32 = 0, kQBF16 = 1 };
enum PoolKind { kPoolF32 = 0, kPoolBF16 = 1, kPoolQ8 = 2 };

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTK = 64;      // keys per tile
constexpr int kMaxG = 16;    // query rows per block
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  long long q_b, q_h;
  void* out;
  long long o_b, o_h;
  const void* k;
  const void* v;
  long long k_h, k_p, k_s, v_h, v_p, v_s;
  const float* ks;
  const float* vs;
  long long ks_h, ks_p, ks_s, vs_h, vs_p, vs_s;
  const int* pt;
  long long pt_b;
  int P;
  const int* lengths;
  int H, n_kv, ps, blk;
  float scale, softcap;
  int window;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int KIND>
__device__ __forceinline__ float load_kv(const void* pool, const float* scales, long long off,
                                         long long soff, int d, int blk) {
  if (KIND == kPoolF32) return static_cast<const float*>(pool)[off + d];
  if (KIND == kPoolBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[off + d]);
  const float x = static_cast<float>(static_cast<const int8_t*>(pool)[off + d]);
  return round_bf16(x * scales[soff + d / blk]);
}

template <int HD>
constexpr int smem_floats() {
  return kMaxG * HD + kTK * (HD + 1) + kTK * HD + kMaxG * kTK + 3 * kMaxG;
}

template <typename TQ, int KIND, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  constexpr int NPT = kMaxG * HD / kThreads;  // accumulator slots per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // [g][HD]
  float* k_s = q_s + kMaxG * HD;             // [kTK][HD + 1]
  float* v_s = k_s + kTK * (HD + 1);         // [kTK][HD]
  float* p_s = v_s + kTK * HD;               // [g][kTK]
  float* m_s = p_s + kMaxG * kTK;            // [g]
  float* l_s = m_s + kMaxG;                  // [g]
  float* alpha_s = l_s + kMaxG;              // [g]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;
  const int group = a.H / a.n_kv;
  const int h0 = h * group + blockIdx.z * kMaxG;  // this block's first query head
  const int g = min(kMaxG, group - blockIdx.z * kMaxG);  // this block's query rows
  const int len = a.lengths[b];

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_b;
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    q_s[i] = to_f32(qb[(h0 + r) * a.q_h + d]);
  }
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  float acc[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) acc[i] = 0.0f;

  const int k_lo = a.window > 0 ? max(0, len - a.window) : 0;  // live keys: [k_lo, len)
  const int p_begin = k_lo / a.ps;
  const int p_end = min(a.P, (len + a.ps - 1) / a.ps);
  for (int p = p_begin; p < p_end; ++p) {
    const int page = a.pt[b * a.pt_b + p];
    const long long k_base = h * a.k_h + page * a.k_p;
    const long long v_base = h * a.v_h + page * a.v_p;
    const long long ks_base = h * a.ks_h + page * a.ks_p;
    const long long vs_base = h * a.vs_h + page * a.vs_p;
    for (int s0 = 0; s0 < a.ps; s0 += kTK) {
      const int t0 = p * a.ps + s0;  // position of the tile's first key
      const int tn = min(kTK, a.ps - s0);
      if (t0 >= len || t0 + tn <= k_lo) continue;  // the same for the whole block
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < tn * HD; i += kThreads) {
        const int j = i / HD, d = i % HD;
        const int slot = s0 + j;
        k_s[j * (HD + 1) + d] =
            load_kv<KIND>(a.k, a.ks, k_base + slot * a.k_s, ks_base + slot * a.ks_s, d, a.blk);
        v_s[j * HD + d] =
            load_kv<KIND>(a.v, a.vs, v_base + slot * a.v_s, vs_base + slot * a.vs_s, d, a.blk);
      }
      __syncthreads();
      for (int i = tid; i < g * kTK; i += kThreads) {
        const int r = i / kTK, j = i % kTK;
        const int kpos = t0 + j;
        float z = kNegInf;
        if (j < tn && kpos < len && kpos >= k_lo) {
          const float* qr = q_s + r * HD;
          const float* kr = k_s + j * (HD + 1);
          float dot = 0.0f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          z = dot * a.scale;
          if (a.softcap > 0.0f) z = tanhf(z / a.softcap) * a.softcap;
        }
        p_s[i] = z;
      }
      __syncthreads();
      for (int r = warp; r < g; r += kWarps) {
        const int j0 = lane, j1 = lane + 32;
        const bool ok0 = j0 < tn && t0 + j0 < len && t0 + j0 >= k_lo;
        const bool ok1 = j1 < tn && t0 + j1 < len && t0 + j1 >= k_lo;
        const float z0 = p_s[r * kTK + j0], z1 = p_s[r * kTK + j1];
        float mx = fmaxf(ok0 ? z0 : kNegInf, ok1 ? z1 : kNegInf);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float e0 = ok0 ? expf(z0 - m_new) : 0.0f;
        const float e1 = ok1 ? expf(z1 - m_new) : 0.0f;
        float sum = e0 + e1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_old - m_new);
        __syncwarp();
        if (lane == 0) {
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
          alpha_s[r] = alpha;
        }
        p_s[r * kTK + j0] = e0;
        p_s[r * kTK + j1] = e1;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int o = tid + i * kThreads;
        if (o < g * HD) {
          const int r = o / HD, d = o % HD;
          const float* pr = p_s + r * kTK;
          float x = acc[i] * alpha_s[r];
          for (int j = 0; j < tn; ++j) x = fmaf(pr[j], v_s[j * HD + d], x);
          acc[i] = x;
        }
      }
    }
  }
  __syncthreads();
  TQ* ob = static_cast<TQ*>(a.out) + b * a.o_b;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int o = tid + i * kThreads;
    if (o < g * HD) {
      const int r = o / HD, d = o % HD;
      const float l = l_s[r];
      ob[(h0 + r) * a.o_h + d] = from_f32<TQ>(acc[i] / (l == 0.0f ? 1.0f : l));
    }
  }
}

template <typename TQ, int KIND, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<TQ, KIND, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int group = a.H / a.n_kv;
  dim3 grid(a.n_kv, B, (group + kMaxG - 1) / kMaxG);
  paged_decode_kernel<TQ, KIND, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, int KIND>
int dispatch_hd(const Args& a, int B, int hd, cudaStream_t s) {
  if (hd == 64) return launch<TQ, KIND, 64>(a, B, s);
  if (hd == 128) return launch<TQ, KIND, 128>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ>
int dispatch_pool(const Args& a, int B, int hd, int pool_kind, cudaStream_t s) {
  if (pool_kind == kPoolF32) return dispatch_hd<TQ, kPoolF32>(a, B, hd, s);
  if (pool_kind == kPoolBF16) return dispatch_hd<TQ, kPoolBF16>(a, B, hd, s);
  if (pool_kind == kPoolQ8) return dispatch_hd<TQ, kPoolQ8>(a, B, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, H, hd] (strides q_b, q_h); out [B, H, hd] (strides o_b, o_h); the K
// and V pools [n_kv, n_pages, ps, hd] (strides h, page, slot) and, for q8
// pools, their f32 scales [n_kv, n_pages, ps, hd / blk] (strides h, page,
// slot; null otherwise); page_tables int32 [B, P] (row stride pt_b); lengths
// int32 [B]. Strides are in elements. q_type: 0 f32, 1 bf16 (out has q's
// type); pool_kind: 0 f32, 1 bf16, 2 q8. softcap <= 0: none; window <= 0:
// none. Returns the cudaError_t of the launch.
extern "C" int paged_decode(
    const void* q, long long q_b, long long q_h, void* out, long long o_b, long long o_h,
    const void* k, long long k_h, long long k_p, long long k_s, const void* v, long long v_h,
    long long v_p, long long v_s, const void* ks, long long ks_h, long long ks_p,
    long long ks_s, const void* vs, long long vs_h, long long vs_p, long long vs_s,
    const void* pt, long long pt_b, int P, const void* lengths, int B, int H, int n_kv, int hd,
    int ps, int blk, float scale, float softcap, int window, int q_type, int pool_kind,
    void* stream) {
  if (B <= 0 || n_kv <= 0 || H % n_kv || P <= 0 || ps <= 0 || blk <= 0 ||
      hd % blk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool_kind == kPoolQ8 && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.q_b = q_b;
  a.q_h = q_h;
  a.out = out;
  a.o_b = o_b;
  a.o_h = o_h;
  a.k = k;
  a.v = v;
  a.k_h = k_h;
  a.k_p = k_p;
  a.k_s = k_s;
  a.v_h = v_h;
  a.v_p = v_p;
  a.v_s = v_s;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.ks_h = ks_h;
  a.ks_p = ks_p;
  a.ks_s = ks_s;
  a.vs_h = vs_h;
  a.vs_p = vs_p;
  a.vs_s = vs_s;
  a.pt = static_cast<const int*>(pt);
  a.pt_b = pt_b;
  a.P = P;
  a.lengths = static_cast<const int*>(lengths);
  a.H = H;
  a.n_kv = n_kv;
  a.ps = ps;
  a.blk = blk;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == kQF32) return dispatch_pool<float>(a, B, hd, pool_kind, s);
  if (q_type == kQBF16) return dispatch_pool<__nv_bfloat16>(a, B, hd, pool_kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
