// K3: flash prefill attention for Hopper (sm_90a).
//
// Replaces jlama_tpu/ops/pallas_attention.py:_flash_kernel (launched by
// _flash_prefill_jit). Computes, for T > 1 query tokens of a chunk that
// starts at absolute position pos0[b]:
//   out[b,h,t] = softmax_s(mask(cap(scale * q[b,h,t] . k[b,h/g,s]))) . v[b,h/g,s]
// with GQA (g = H / n_kv), keys s < S, causal s <= pos0[b] + t, an optional
// sliding window s > pos0[b] + t - window and an optional softcap
// cap(z) = tanh(z / c) * c. The softmax runs online in f32; a row whose keys
// are all masked gets l = 0 -> 1 and writes zeros.
//
// What bounds it on the H100: at prefill sizes the operations (4·T·S·hd per
// head, halved by causality); K/V bytes are small and reread from L2.
//
// Design (simple first; no tensor cores yet): one block of 4 warps per
// (query tile of 32 rows, head, batch row). Each warp owns 8 query rows. The
// block walks key tiles of 32 keys staged in shared memory (K transposed and
// padded, so that lane j reads key j without bank conflicts), skipping tiles
// entirely above the causal bound or below the window. Lane j scores key j
// for the warp's 8 rows; max and sum are warp shuffles; each lane then
// accumulates hd/32 output dimensions of P.V with P broadcast by shuffles.
// q, k, v and out take arbitrary batch/head/row strides with a unit stride on
// the last (head) dimension; hd is 64 or 128; T and S need not be multiples
// of the tile (the ragged edge is masked). Inputs and output are bf16 or f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBS = 32;                  // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + HD * (kBS + 1) + kBS * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, const int* __restrict__ pos0, int H, int n_kv, int Tq,
                     int S, long long q_sb, long long q_sh, long long q_st, long long k_sb,
                     long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, long long o_sb, long long o_sh, long long o_st,
                     float scale, float softcap, int window, int causal) {
  constexpr int DPL = HD / 32;  // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [kBQ][HD]
  float* Kt = Qs + kBQ * HD;          // [HD][kBS + 1]
  float* Vs = Kt + HD * (kBS + 1);    // [kBS][HD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / n_kv);
  const int p0 = pos0[b];

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    const int t = t0 + r;
    Qs[i] = t < Tq ? to_f32(qb[t * q_st + d]) : 0.0f;
  }

  // key range this query tile can see
  const int t_last = min(t0 + kBQ, Tq) - 1;
  int s_end = S;
  if (causal) s_end = min(S, p0 + t_last + 1);
  int s_begin = 0;
  if (window > 0) s_begin = max(0, p0 + t0 - window + 1);
  s_begin = (s_begin / kBS) * kBS;

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }
  const float* Qw = Qs + warp * kRows * HD;
  __syncthreads();

  for (int s0 = s_begin; s0 < s_end; s0 += kBS) {
    for (int i = tid; i < kBS * HD; i += kWarps * 32) {
      const int j = i / HD, d = i % HD;
      const int sp = s0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (sp < S) {
        kv = to_f32(kb[sp * k_ss + d]);
        vv = to_f32(vb[sp * v_ss + d]);
      }
      Kt[d * (kBS + 1) + j] = kv;
      Vs[j * HD + d] = vv;
    }
    __syncthreads();

    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k0 = Kt[(d + 0) * (kBS + 1) + lane];
      const float k1 = Kt[(d + 1) * (kBS + 1) + lane];
      const float k2 = Kt[(d + 2) * (kBS + 1) + lane];
      const float k3 = Kt[(d + 3) * (kBS + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * HD + d);
        sc[r] = fmaf(qv.x, k0, fmaf(qv.y, k1, fmaf(qv.z, k2, fmaf(qv.w, k3, sc[r]))));
      }
    }

    const int kpos = s0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = p0 + t0 + warp * kRows + r;
      float z = sc[r] * scale;
      if (softcap > 0.0f) z = tanhf(z / softcap) * softcap;
      const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      z = ok ? z : kNegInf;
      float mx = z;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p = ok ? expf(z - m_new) : 0.0f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      sc[r] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kBS; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = Vs[j * HD + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, sc[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
    __syncthreads();
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + warp * kRows + r;
    if (t < Tq) {
      const float inv = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) ob[t * o_st + lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, const int* pos0, int B, int H,
           int n_kv, int Tq, int S, const long long* st, float scale, float softcap, int window,
           int causal, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), pos0, H, n_kv, Tq, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, softcap, window, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q (b, h, t), k (b, h, s), v (b, h, s), o (b, h, t), in elements.
// softcap <= 0: none; window <= 0: none. Returns the cudaError_t of the launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* o,
                             const void* pos0, int dtype, int B, int H, int n_kv, int Tq, int S,
                             int hd, long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                             long long o_st, float scale, float softcap, int window, int causal,
                             void* stream) {
  if (B <= 0 || H <= 0 || n_kv <= 0 || H % n_kv || Tq <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_st};
  const int* p0 = static_cast<const int*>(pos0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s);
  if (dtype == kBF16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s);
  if (dtype == kF32 && hd == 64)
    return launch<float, 64>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s);
  if (dtype == kF32 && hd == 128)
    return launch<float, 128>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
