// K4: the KV write for Hopper (sm_90a).
//
// Replaces jlama_tpu/ops/pallas_kv.py:_kv_write_kernel (launched by
// kv_write_dense1), generalised to the paged pool of
// jlama_tpu/kv/paged.py::write_kv_layer. One launch writes the rows
// new[b, t, h, :] (b < B, t < T, h < n_kv, hd wide) of both K and V into
//   pool[h, page_tables[b, pos[b,t] / ps], pos[b,t] % ps, :]
// and drops a row whose position lies past its page table (pos / ps >= P), as
// the JAX package's gather and scatter drop it.
// A bf16 or f32 pool gets a plain store. A q8 pool (int8 payload, f32 scales
// [h, page, slot, hd/blk]) is quantized per block of blk in the same pass, as
// quant/blockq.py::q8_quantize does: amax/127, floor(x * 127/amax + 0.5),
// clip to +-127, and a zero scale for an all-zero block. The multiply and the
// add are rounded separately (__fmul_rn, __fadd_rn), as the plain version's
// two tensor ops are, so the payload matches it exactly.
//
// What bounds it on the H100: bytes (each new row is read once and written
// once); at decode sizes a launch of a few KB, so the launch is the cost.
//
// Design: one warp per unit of work, a unit being (side, row, block): side K
// or V, row (b, t, h), and block one run of blk values along hd for a q8 pool
// (the whole row otherwise). Lanes stride the block's values; a q8 block's
// amax is a warp shuffle reduction, and lane 0 stores its scale. Rows that
// map to one slot (pad rows and empty decode slots all write into the
// scratch page) race, harmlessly: no live row reads the scratch page, and
// every writer stores its own payload and scale, with no atomics.
// Inputs take any (b, t, h) strides and pools any (h, page, slot) strides,
// each with a unit stride along hd.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum InType { kInF32 = 0, kInBF16 = 1 };
enum PoolKind { kPoolF32 = 0, kPoolBF16 = 1, kPoolQ8 = 2 };

struct Side {
  const void* src;
  long long s_b, s_t, s_h;
  void* pool;
  long long p_h, p_p, p_s;
  float* scales;
  long long c_h, c_p, c_s;
};

struct Args {
  Side side[2];
  const int* pt;
  long long pt_b;
  int P;
  const long long* pos;
  long long pos_b;
  int B, T, n_kv, hd, ps, blk;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kWarps = 4;

template <typename TIn, int KIND>
__global__ void __launch_bounds__(kWarps * 32) kv_write_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int n_blk = KIND == kPoolQ8 ? a.hd / a.blk : 1;
  const int chunk = KIND == kPoolQ8 ? a.blk : a.hd;
  const long long n_rows = static_cast<long long>(a.B) * a.T * a.n_kv;
  if (unit >= n_rows * n_blk) return;
  const Side& s = a.side[blockIdx.y];
  const int blk_i = static_cast<int>(unit % n_blk);
  const long long row = unit / n_blk;
  const int h = static_cast<int>(row % a.n_kv);
  const int t = static_cast<int>((row / a.n_kv) % a.T);
  const int b = static_cast<int>(row / (static_cast<long long>(a.n_kv) * a.T));

  const long long p = a.pos[b * a.pos_b + t];
  if (p / a.ps >= a.P) return;  // the whole warp: past the page table
  const int page = a.pt[b * a.pt_b + p / a.ps];
  const int off = static_cast<int>(p % a.ps);

  const TIn* src = static_cast<const TIn*>(s.src) + b * s.s_b + t * s.s_t + h * s.s_h +
                   blk_i * chunk;
  const long long dst_off = h * s.p_h + page * s.p_p + off * s.p_s + blk_i * chunk;

  if (KIND == kPoolQ8) {
    float amax = 0.0f;
    for (int d = lane; d < chunk; d += 32) amax = fmaxf(amax, fabsf(to_f32(src[d])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float iscale = amax > 0.0f ? __fdiv_rn(127.0f, amax) : 0.0f;
    const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 0.0f;
    int8_t* dst = static_cast<int8_t*>(s.pool) + dst_off;
    for (int d = lane; d < chunk; d += 32) {
      float q = floorf(__fadd_rn(__fmul_rn(to_f32(src[d]), iscale), 0.5f));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      dst[d] = static_cast<int8_t>(q);
    }
    if (lane == 0) s.scales[h * s.c_h + page * s.c_p + off * s.c_s + blk_i] = scale;
  } else if (KIND == kPoolBF16) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(s.pool) + dst_off;
    for (int d = lane; d < chunk; d += 32) dst[d] = __float2bfloat16(to_f32(src[d]));
  } else {
    float* dst = static_cast<float*>(s.pool) + dst_off;
    for (int d = lane; d < chunk; d += 32) dst[d] = to_f32(src[d]);
  }
}

template <typename TIn, int KIND>
int launch(const Args& a, cudaStream_t stream) {
  const int n_blk = KIND == kPoolQ8 ? a.hd / a.blk : 1;
  const long long units = static_cast<long long>(a.B) * a.T * a.n_kv * n_blk;
  const long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), 2);
  kv_write_kernel<TIn, KIND><<<grid, kWarps * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int dispatch_pool(const Args& a, int pool_kind, cudaStream_t s) {
  if (pool_kind == kPoolF32) return launch<TIn, kPoolF32>(a, s);
  if (pool_kind == kPoolBF16) return launch<TIn, kPoolBF16>(a, s);
  if (pool_kind == kPoolQ8) return launch<TIn, kPoolQ8>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Side make_side(const void* src, long long s_b, long long s_t, long long s_h, void* pool,
               long long p_h, long long p_p, long long p_s, void* scales, long long c_h,
               long long c_p, long long c_s) {
  Side s;
  s.src = src;
  s.s_b = s_b;
  s.s_t = s_t;
  s.s_h = s_h;
  s.pool = pool;
  s.p_h = p_h;
  s.p_p = p_p;
  s.p_s = p_s;
  s.scales = static_cast<float*>(scales);
  s.c_h = c_h;
  s.c_p = c_p;
  s.c_s = c_s;
  return s;
}

}  // namespace

// For K then V: the rows (pointer, b/t/h strides), the pool (pointer,
// h/page/slot strides) and the q8 scales (pointer, h/page/slot strides; null
// for a float pool). Strides are in elements. page_tables int32 [B, P] with
// row stride pt_b; positions int64 [B, T] with row stride pos_b. in_type:
// 0 f32, 1 bf16; pool_kind: 0 f32, 1 bf16, 2 q8. Returns the cudaError_t of
// the launch.
extern "C" int kv_write(
    const void* k_src, long long k_sb, long long k_st, long long k_sh, void* k_pool,
    long long k_ph, long long k_pp, long long k_ps, void* k_scales, long long k_ch,
    long long k_cp, long long k_cs, const void* v_src, long long v_sb, long long v_st,
    long long v_sh, void* v_pool, long long v_ph, long long v_pp, long long v_ps,
    void* v_scales, long long v_ch, long long v_cp, long long v_cs, const void* pt,
    long long pt_b, int P, const void* pos, long long pos_b, int B, int T, int n_kv, int hd,
    int ps, int blk, int in_type, int pool_kind, void* stream) {
  if (B <= 0 || T <= 0 || n_kv <= 0 || hd <= 0 || ps <= 0 || P <= 0 || blk <= 0 || hd % blk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool_kind == kPoolQ8 && (k_scales == nullptr || v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.side[0] = make_side(k_src, k_sb, k_st, k_sh, k_pool, k_ph, k_pp, k_ps, k_scales, k_ch, k_cp,
                        k_cs);
  a.side[1] = make_side(v_src, v_sb, v_st, v_sh, v_pool, v_ph, v_pp, v_ps, v_scales, v_ch, v_cp,
                        v_cs);
  a.pt = static_cast<const int*>(pt);
  a.pt_b = pt_b;
  a.P = P;
  a.pos = static_cast<const long long*>(pos);
  a.pos_b = pos_b;
  a.B = B;
  a.T = T;
  a.n_kv = n_kv;
  a.hd = hd;
  a.ps = ps;
  a.blk = blk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == kInF32) return dispatch_pool<float>(a, pool_kind, s);
  if (in_type == kInBF16) return dispatch_pool<__nv_bfloat16>(a, pool_kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
