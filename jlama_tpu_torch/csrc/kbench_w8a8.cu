// P2: the int8 block-dot GEMV variants of scripts/kbench_w8a8.py, for Hopper
// (sm_90a).
//
// Replaces the Pallas bodies of scripts/kbench_w8a8.py: _k_pb8 (:163,
// launched by pb8 :183, call :192), _k_pgb (:217, pgb :261, call :287; dom
// i8 and bf16), _k_di8b (:319, di8b :330, call :337) and _k_pk4 (:356, pk4
// :384, call :395). The activations are quantized outside the kernel, by the
// wrapper, with the port's q8_quantize (block 32), as the JAX benches do it
// outside theirs. The weights are the port's JQ4 bytes (uint8 [N, K/2], byte
// j of a 32-block = element j low, j + 16 high; nibbles unsigned 0..15).
//
//   kBlocks (pb8, pgb8)  y = sum_b (d_b - 8 asum_b) . xs_b . s_b: per 32-block
//       the exact int32 dot of the int8 activations with the unsigned
//       nibbles (__dp4a: the nibbles fit s8), the block's activation sum by a
//       __dp4a against 0x01010101, then an f32 combine. The TPU's choice
//       between all of K in one grid step (pb8) and a grid over the blocks
//       (pgb) is a schedule, not a function: one kernel serves both rows.
//   kFloat (pgbf)  the same with unquantized bf16 x and f32 scales:
//       sum_b (x_b . n_b - 8 bsum_b) . s_b, f32 fma.
//   kGroups (pk4)  per 256-group g of the byte columns (128 bytes), the
//       unsigned nibble planes against xq[:, :K/2] (low) and xq[:, K/2:]
//       (high), exact int32 dots summed over the 8 lanes of a group by
//       shuffles, times sg[g, n] in f32. The activation scales are dropped,
//       as the JAX kernel drops them.
//   kInt8 (di8b)  the full-K __dp4a dot of int8 x with int8 weights [N, K]
//       (values -8..7: twice the bytes), times s[n, 0]. Activation scales
//       dropped, as in the JAX kernel.
//
// Structure: K1's decode GEMV (csrc/q4_matmul.cu): one warp per output row,
// one 128-bit load per 32-block, up to 16 x rows read through the read-only
// cache, a warp-shuffle reduction.
//
// What bounds it on the H100: the weight bytes, N K/2 payload + N K/32 x 4
// f32 scales (di8b: N K), at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Kind { kBlocks = 0, kFloat = 1, kGroups = 2, kInt8 = 3 };
constexpr int kWarps = 8;

__device__ __forceinline__ void load_bf16x16(const __nv_bfloat16* p, float* out) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 u = __ldg(p4 + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      out[i * 8 + 2 * j] = f.x;
      out[i * 8 + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ int dot16(uint4 xa, uint4 wb, int acc) {
  acc = __dp4a(static_cast<int>(xa.x), static_cast<int>(wb.x), acc);
  acc = __dp4a(static_cast<int>(xa.y), static_cast<int>(wb.y), acc);
  acc = __dp4a(static_cast<int>(xa.z), static_cast<int>(wb.z), acc);
  return __dp4a(static_cast<int>(xa.w), static_cast<int>(wb.w), acc);
}

__device__ __forceinline__ uint4 lo_nibbles(uint4 w) {
  return make_uint4(w.x & 0x0F0F0F0Fu, w.y & 0x0F0F0F0Fu, w.z & 0x0F0F0F0Fu, w.w & 0x0F0F0F0Fu);
}

__device__ __forceinline__ uint4 hi_nibbles(uint4 w) {
  return make_uint4((w.x >> 4) & 0x0F0F0F0Fu, (w.y >> 4) & 0x0F0F0F0Fu,
                    (w.z >> 4) & 0x0F0F0F0Fu, (w.w >> 4) & 0x0F0F0F0Fu);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kBlocks and kFloat: lanes stride over the row's 32-blocks.
template <int KIND, int MT>
__global__ void __launch_bounds__(kWarps * 32)
block_gemv(const void* __restrict__ xv, const float* __restrict__ xs,
           const uint8_t* __restrict__ w, const float* __restrict__ s,
           __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int nb = K >> 5;
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * (K >> 1));
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
  for (int b = lane; b < nb; b += 32) {
    const uint4 pk = __ldg(wrow + b);
    const float sb = __ldg(s + (size_t)n * nb + b);
    if constexpr (KIND == kBlocks) {
      const uint4 lo = lo_nibbles(pk), hi = hi_nibbles(pk);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const uint4* xp = reinterpret_cast<const uint4*>(
              static_cast<const int8_t*>(xv) + (size_t)m * K + (size_t)b * 32);
          const uint4 xl = __ldg(xp), xh = __ldg(xp + 1);
          const int d = dot16(xh, hi, dot16(xl, lo, 0));
          const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
          const int asum = dot16(xh, ones, dot16(xl, ones, 0));
          const float df = static_cast<float>(d - 8 * asum);
          acc[m] += df * __ldg(xs + (size_t)m * nb + b) * sb;
        }
      }
    } else {  // kFloat
      const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
      float wl[16], wh[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t byte = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        wl[j] = static_cast<float>(byte & 0xFu);
        wh[j] = static_cast<float>(byte >> 4);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          float xf[32];
          const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(xv) + (size_t)m * K + (size_t)b * 32;
          load_bf16x16(xp, xf);
          load_bf16x16(xp + 16, xf + 16);
          float d = 0.0f, bs = 0.0f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            d = fmaf(xf[j], wl[j], d);
            d = fmaf(xf[16 + j], wh[j], d);
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) bs += xf[e];
          acc[m] += (d - 8.0f * bs) * sb;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      const float v = warp_sum(acc[m]);
      if (lane == 0) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
}

// kGroups and kInt8: lanes stride over the row's 16-byte chunks.
template <int KIND, int MT>
__global__ void __launch_bounds__(kWarps * 32)
chunk_gemv(const int8_t* __restrict__ xq, const uint8_t* __restrict__ w,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int row_bytes = KIND == kInt8 ? K : K >> 1;
  const int chunks = row_bytes >> 4;
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * row_bytes);
  float acc[MT];
  int iacc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) { acc[m] = 0.0f; iacc[m] = 0; }
  // a uniform trip count: the group shuffles need every lane
  for (int base = 0; base < chunks; base += 32) {
    const int i = base + lane;
    const bool live = i < chunks;
    const uint4 pk = live ? __ldg(wrow + i) : make_uint4(0, 0, 0, 0);
    if constexpr (KIND == kInt8) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M && live)
          iacc[m] = dot16(__ldg(reinterpret_cast<const uint4*>(xq + (size_t)m * K) + i), pk, iacc[m]);
      }
    } else {  // kGroups: group g = i / 8 holds the lanes 8q .. 8q+7
      const uint4 lo = lo_nibbles(pk), hi = hi_nibbles(pk);
      const int g = i >> 3;
      const float sg = live ? __ldg(s + (size_t)g * N + n) : 0.0f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          int d = 0;
          if (live) {
            const uint4* xr = reinterpret_cast<const uint4*>(xq + (size_t)m * K);
            d = dot16(__ldg(xr + i), lo, 0);                      // xq[:, :K/2]
            d = dot16(__ldg(xr + (K >> 5) + i), hi, d);           // xq[:, K/2:]
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          d += __shfl_xor_sync(0xffffffffu, d, 4);
          if ((lane & 7) == 0 && live) acc[m] += static_cast<float>(d) * sg;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float v;
      if constexpr (KIND == kInt8) {
        int q = iacc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
        v = __int2float_rn(q) * __ldg(s + (size_t)n * (K >> 5));
      } else {
        v = warp_sum(acc[m]);
      }
      if (lane == 0) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <int KIND>
void launch(const void* x, const float* xs, const uint8_t* w, const float* s, void* y, int M,
            int N, int K, cudaStream_t st) {
  const dim3 grid((N + kWarps - 1) / kWarps);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if constexpr (KIND == kBlocks || KIND == kFloat) {
    if (M == 1) block_gemv<KIND, 1><<<grid, kWarps * 32, 0, st>>>(x, xs, w, s, yp, M, N, K);
    else block_gemv<KIND, 16><<<grid, kWarps * 32, 0, st>>>(x, xs, w, s, yp, M, N, K);
  } else {
    const auto* xq = static_cast<const int8_t*>(x);
    if (M == 1) chunk_gemv<KIND, 1><<<grid, kWarps * 32, 0, st>>>(xq, w, s, yp, M, N, K);
    else chunk_gemv<KIND, 16><<<grid, kWarps * 32, 0, st>>>(xq, w, s, yp, M, N, K);
  }
}

}  // namespace

// kBlocks: x int8 [M, K], xs f32 [M, K/32], w uint8 [N, K/2], s f32 [N, K/32];
// kFloat: x bf16 [M, K], xs unused, w and s as kBlocks;
// kGroups: x int8 [M, K], w uint8 [N, K/2], s = sg f32 [K/256, N];
// kInt8: x int8 [M, K], w int8 [N, K], s f32 [N, K/32] (column 0 read).
// y bf16 [M, N]. Returns the cudaError_t of the launch; 1
// (cudaErrorInvalidValue) for arguments the kernels do not take.
extern "C" int kbench_w8a8(int kind, const void* x, const void* xs, const void* w,
                           const void* s, void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0 || (K & 31) || (kind == kGroups && (K & 255)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(s);
  switch (kind) {
    case kBlocks: launch<kBlocks>(x, xsp, wp, sp, y, M, N, K, st); break;
    case kFloat: launch<kFloat>(x, xsp, wp, sp, y, M, N, K, st); break;
    case kGroups: launch<kGroups>(x, xsp, wp, sp, y, M, N, K, st); break;
    case kInt8: launch<kInt8>(x, xsp, wp, sp, y, M, N, K, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
