// K4: the KV write for Hopper (sm_90a), with RoPE on q and k fused in.
//
// Replaces jlama_tpu/ops/pallas_kv.py:_kv_write_kernel (launched by
// kv_write_dense1), generalised to the paged pool of
// jlama_tpu/kv/paged.py::write_kv_layer, together with the two
// jlama_tpu/nn/rope.py::apply_rope calls on q and k that precede the write in
// jlama_tpu/nn/layers.py (XLA fuses those with the write on the TPU). One
// launch per layer does all the work between the QKV projection and
// attention:
//   - q [B, T, H, hd] and k [B, T, n_kv, hd] are rotated with the HF
//     rotate-half rule by cos/sin [B, T, hd/2] (f32): out1 = x1 c - x2 s,
//     out2 = x2 c + x1 s, every product and sum rounded on its own
//     (__fmul_rn, __fsub_rn, __fadd_rn: no FMA contraction), then one
//     rounding to the activation dtype, as nn/rope.py::apply_rope rounds;
//   - rotated q goes to a new contiguous [B, T, H, hd] tensor;
//   - rotated k and v [B, T, n_kv, hd] go to
//       pool[h, page_tables[b, pos[b,t] / ps], pos[b,t] % ps, :]
//     and a row whose position lies past its page table (pos / ps >= P) is
//     dropped, as the JAX package's gather and scatter drop it.
// Without cos/sin nothing is rotated and only K and V are written (H = 0).
// A bf16 or f32 pool gets a plain store. A q8 pool (int8 payload, f32 scales
// [h, page, slot, hd/blk]) is quantized per block of blk in the same pass, as
// quant/blockq.py::q8_quantize does: amax/127, floor(x * 127/amax + 0.5),
// clip to +-127, and a zero scale for an all-zero block; the multiply and the
// add are rounded separately (__fmul_rn, __fadd_rn), as the plain version's
// two tensor ops are, and k is rounded to the activation dtype before it is
// quantized, as the unfused chain stores it.
//
// What bounds it on the H100: bytes (q, k, v and cos/sin read once, q and
// the pool slots written once). At a 16-slot decode step that is about
// 0.2 MB, far below what a launch costs, so the design aims at the fewest
// dependent global round trips per warp, not at bandwidth.
//
// Design: one warp per (token row, head) over the H + 2 n_kv heads of a row.
// A lane holds V = hd/64 (1, 2 or 4) values of each half of the head, the
// rotation pairs (d, d + hd/2) in its own registers. The position load is
// issued first; the row, cos and sin loads overlap it, and only the page
// table load waits on it: two round trips before the stores. V values are
// one vector load where the address allows (16 bytes for f32 at hd 256). A
// q8 block's amax is a warp shuffle reduction. Rows that map to one slot (pad
// rows and empty decode slots all write into the scratch page) race,
// harmlessly: no live row reads the scratch page, and every writer stores its
// own payload and scale, with no atomics. Inputs take any (b, t, h) strides
// (the split views of a fused QKV output need no copy) and pools any (h,
// page, slot) strides, each with a unit stride along hd. hd is even and at
// most 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum InType { kInF32 = 0, kInBF16 = 1 };
enum PoolKind { kPoolF32 = 0, kPoolBF16 = 1, kPoolQ8 = 2 };

struct Rows {  // [B, T, heads, hd], unit stride along hd
  const void* p;
  long long s_b, s_t, s_h;
};

struct Pool {  // [n_kv, n_pages, ps, hd] and, for q8, scales [n_kv, n_pages, ps, hd/blk]
  void* p;
  long long p_h, p_p, p_s;
  float* scales;
  long long c_h, c_p, c_s;
};

struct Args {
  Rows q, k, v;
  void* q_out;  // contiguous [B, T, H, hd]
  Pool kp, vp;
  const float* cos;  // [B, T, hd/2]; null: no rotation
  const float* sin;
  long long cos_b, cos_t, sin_b, sin_t;
  const int* pt;
  long long pt_b;
  int P;
  const long long* pos;
  long long pos_b;
  int B, T, H, n_kv, hd, ps, blk;
};

constexpr int kWarps = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to the activation dtype T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v) {
  if constexpr (sizeof(T) == 2) *p = __float2bfloat16_rn(v);
  else *p = v;
}

struct alignas(8) Bf16x4 {
  __nv_bfloat162 a, b;
};

// x[i] = p[i] for the i < n of the V values (0 past them): one vector load
// when all V are there and the address is aligned to them, else V loads
template <int V>
__device__ __forceinline__ void load_v(const float* p, int n, float (&x)[V]) {
  if constexpr (V > 1) {
    if (n >= V && (reinterpret_cast<uintptr_t>(p) % (V * sizeof(float))) == 0) {
      if constexpr (V == 2) {
        const float2 u = *reinterpret_cast<const float2*>(p);
        x[0] = u.x, x[1] = u.y;
      } else {
        const float4 u = *reinterpret_cast<const float4*>(p);
        x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = i < n ? p[i] : 0.0f;
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, int n, float (&x)[V]) {
  if constexpr (V > 1) {
    if (n >= V && (reinterpret_cast<uintptr_t>(p) % (V * sizeof(__nv_bfloat16))) == 0) {
      if constexpr (V == 2) {
        const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
        x[0] = u.x, x[1] = u.y;
      } else {
        const Bf16x4 w = *reinterpret_cast<const Bf16x4*>(p);
        const float2 u = __bfloat1622float2(w.a), v = __bfloat1622float2(w.b);
        x[0] = u.x, x[1] = u.y, x[2] = v.x, x[3] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = i < n ? to_f32(p[i]) : 0.0f;
}

template <typename TIn, int KIND, int V>
__global__ void __launch_bounds__(kWarps * 32) kv_write_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int heads = a.H + 2 * a.n_kv;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (unit >= static_cast<long long>(a.B) * a.T * heads) return;
  const int hh = static_cast<int>(unit % heads);
  const long long row = unit / heads;  // b * T + t
  const int t = static_cast<int>(row % a.T);
  const int b = static_cast<int>(row / a.T);
  const int side = hh < a.H ? 0 : (hh < a.H + a.n_kv ? 1 : 2);  // q, k or v
  const int h = side == 0 ? hh : hh - a.H - (side - 1) * a.n_kv;

  // the position first: only the page-table load below waits on it
  const long long p = side ? a.pos[b * a.pos_b + t] : 0;
  const Rows r = side == 0 ? a.q : (side == 1 ? a.k : a.v);
  const TIn* src = static_cast<const TIn*>(r.p) + b * r.s_b + t * r.s_t + h * r.s_h;
  const int half = a.hd >> 1;
  const int j0 = lane * V;
  const int n = half - j0;  // this lane's values in each half (none where <= 0)
  float x1[V], x2[V], c[V], s[V];
  load_v<V>(src + j0, n, x1);
  load_v<V>(src + half + j0, n, x2);
  const bool rope = a.cos != nullptr && side < 2;
  if (rope) {
    load_v<V>(a.cos + b * a.cos_b + t * a.cos_t + j0, n, c);
    load_v<V>(a.sin + b * a.sin_b + t * a.sin_t + j0, n, s);
  }
  const long long col = p / a.ps;
  const bool keep = side && col < a.P;  // k and v past the page table: dropped
  const int page = keep ? a.pt[b * a.pt_b + col] : 0;
  const int off = static_cast<int>(p % a.ps);

  if (rope) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float o1 = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
      const float o2 = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
      x1[i] = round_to<TIn>(o1);
      x2[i] = round_to<TIn>(o2);
    }
  }
  if (side == 0) {
    TIn* dst = static_cast<TIn*>(a.q_out) + (row * a.H + h) * a.hd;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < n) {
        store(dst + j0 + i, x1[i]);
        store(dst + half + j0 + i, x2[i]);
      }
    }
    return;
  }
  if (!keep) return;  // the whole warp

  const Pool pl = side == 1 ? a.kp : a.vp;
  const long long dst_off = h * pl.p_h + page * pl.p_p + off * pl.p_s;
  if constexpr (KIND == kPoolQ8) {
    float isc1[V] = {}, isc2[V] = {};
    float* scales = pl.scales + h * pl.c_h + page * pl.c_p + off * pl.c_s;
    const int n_blk = a.hd / a.blk;
    for (int bi = 0; bi < n_blk; ++bi) {
      const int lo = bi * a.blk, hi = lo + a.blk;
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int e1 = j0 + i, e2 = half + j0 + i;
        if (i < n && e1 >= lo && e1 < hi) amax = fmaxf(amax, fabsf(x1[i]));
        if (i < n && e2 >= lo && e2 < hi) amax = fmaxf(amax, fabsf(x2[i]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float iscale = amax > 0.0f ? __fdiv_rn(127.0f, amax) : 0.0f;
      if (lane == 0) scales[bi] = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int e1 = j0 + i, e2 = half + j0 + i;
        if (e1 >= lo && e1 < hi) isc1[i] = iscale;
        if (e2 >= lo && e2 < hi) isc2[i] = iscale;
      }
    }
    int8_t* dst = static_cast<int8_t*>(pl.p) + dst_off;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < n) {
        const float q1 = floorf(__fadd_rn(__fmul_rn(x1[i], isc1[i]), 0.5f));
        const float q2 = floorf(__fadd_rn(__fmul_rn(x2[i], isc2[i]), 0.5f));
        dst[j0 + i] = static_cast<int8_t>(fminf(fmaxf(q1, -127.0f), 127.0f));
        dst[half + j0 + i] = static_cast<int8_t>(fminf(fmaxf(q2, -127.0f), 127.0f));
      }
    }
  } else {
    using TPool = std::conditional_t<KIND == kPoolBF16, __nv_bfloat16, float>;
    TPool* dst = static_cast<TPool*>(pl.p) + dst_off;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < n) {
        store(dst + j0 + i, x1[i]);
        store(dst + half + j0 + i, x2[i]);
      }
    }
  }
}

template <typename TIn, int KIND, int V>
int launch(const Args& a, cudaStream_t stream) {
  const long long units = static_cast<long long>(a.B) * a.T * (a.H + 2 * a.n_kv);
  const long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kv_write_kernel<TIn, KIND, V><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn, int KIND>
int dispatch_v(const Args& a, cudaStream_t s) {
  const int half = a.hd / 2;
  if (half <= 32) return launch<TIn, KIND, 1>(a, s);
  if (half <= 64) return launch<TIn, KIND, 2>(a, s);
  return launch<TIn, KIND, 4>(a, s);
}

template <typename TIn>
int dispatch_pool(const Args& a, int pool_kind, cudaStream_t s) {
  if (pool_kind == kPoolF32) return dispatch_v<TIn, kPoolF32>(a, s);
  if (pool_kind == kPoolBF16) return dispatch_v<TIn, kPoolBF16>(a, s);
  if (pool_kind == kPoolQ8) return dispatch_v<TIn, kPoolQ8>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (pointer, b/t/h strides; null with H = 0) and q_out (contiguous [B, T,
// H, hd]); then for K and for V: the rows (pointer, b/t/h strides), the pool
// (pointer, h/page/slot strides) and the q8 scales (pointer, h/page/slot
// strides; null for a float pool); cos and sin f32 (pointers, b/t strides;
// null: no rotation, and then H must be 0). Strides are in elements.
// page_tables int32 [B, P] with row stride pt_b; positions int64 [B, T] with
// row stride pos_b. in_type (q, k and v alike): 0 f32, 1 bf16; pool_kind: 0
// f32, 1 bf16, 2 q8. Returns the cudaError_t of the launch.
extern "C" int kv_write(
    const void* q_src, long long q_sb, long long q_st, long long q_sh, void* q_out,
    const void* k_src, long long k_sb, long long k_st, long long k_sh, void* k_pool,
    long long k_ph, long long k_pp, long long k_ps, void* k_scales, long long k_ch,
    long long k_cp, long long k_cs, const void* v_src, long long v_sb, long long v_st,
    long long v_sh, void* v_pool, long long v_ph, long long v_pp, long long v_ps,
    void* v_scales, long long v_ch, long long v_cp, long long v_cs, const void* cos,
    long long cos_b, long long cos_t, const void* sin, long long sin_b, long long sin_t,
    const void* pt, long long pt_b, int P, const void* pos, long long pos_b, int B, int T,
    int H, int n_kv, int hd, int ps, int blk, int in_type, int pool_kind, void* stream) {
  if (B <= 0 || T <= 0 || H < 0 || n_kv <= 0 || hd <= 0 || hd % 2 || hd > 256 || ps <= 0 ||
      P <= 0 || blk <= 0 || hd % blk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool_kind == kPoolQ8 && (k_scales == nullptr || v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cos == nullptr) != (sin == nullptr) || (H > 0 && (cos == nullptr || q_src == nullptr ||
                                                         q_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = Rows{q_src, q_sb, q_st, q_sh};
  a.q_out = q_out;
  a.k = Rows{k_src, k_sb, k_st, k_sh};
  a.v = Rows{v_src, v_sb, v_st, v_sh};
  a.kp = Pool{k_pool, k_ph, k_pp, k_ps, static_cast<float*>(k_scales), k_ch, k_cp, k_cs};
  a.vp = Pool{v_pool, v_ph, v_pp, v_ps, static_cast<float*>(v_scales), v_ch, v_cp, v_cs};
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.cos_b = cos_b;
  a.cos_t = cos_t;
  a.sin_b = sin_b;
  a.sin_t = sin_t;
  a.pt = static_cast<const int*>(pt);
  a.pt_b = pt_b;
  a.P = P;
  a.pos = static_cast<const long long*>(pos);
  a.pos_b = pos_b;
  a.B = B;
  a.T = T;
  a.H = H;
  a.n_kv = n_kv;
  a.hd = hd;
  a.ps = ps;
  a.blk = blk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == kInF32) return dispatch_pool<float>(a, pool_kind, s);
  if (in_type == kInBF16) return dispatch_pool<__nv_bfloat16>(a, pool_kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
