// P3, second half: the q4s sigma-product probes of scripts/probe_sigma_i16.py,
// for Hopper (sm_90a).
//
// Replaces the Pallas bodies kA (scripts/probe_sigma_i16.py:73), kA2 (:85),
// kC (:96) and kD (:108), each launched by `run` (:42, call :44). All four
// compute y[M,N] = x[M,K] . (w[N,K] * sigma[N,K])^T with x int8, w uint8
// (0..15) and sigma uint8 (1..16), f32 out; they differ in the width of the
// product w * sigma (<= 240: it fits a u8) and in the dot that takes it:
//   kA   the product in 16 bits, converted to bf16, f32 fma with x as bf16;
//   kA2  the same with the product in 32 bits;
//   kC   the products in 16-bit lanes, two to a register, into __dp2a_lo /
//        __dp2a_hi against four s8 x values (an exact int32 dot);
//   kD   the product in 32 bits, packed back to four u8 lanes, into a
//        dp4a.s32.u32 against four s8 x values (an exact int32 dot).
// The card has no 16-bit integer multiply lanes: the 16- and 32-bit products
// cost the same IMAD, and the widths differ in how the dot consumes them.
// Every output is an integer below 2^24 (|y| <= K . 128 . 240), so all four
// equal numpy exactly.
//
// Structure: one warp per output row, lanes stride over 16-byte chunks of w,
// sigma and x, a warp-shuffle reduction.
//
// What bounds it on the H100: the bytes of w and sigma, 2 N K, at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Policy { kA = 0, kA2 = 1, kC = 2, kD = 3 };
constexpr int kWarps = 8;

__device__ __forceinline__ int dp4a_su(uint32_t a_s8, uint32_t b_u8, int c) {
  int d;  // four s8 of a times four u8 of b, plus c
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a_s8), "r"(b_u8), "r"(c));
  return d;
}

__device__ __forceinline__ int sext8(uint32_t word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xFFu));
}

template <int P, int MT>
__global__ void __launch_bounds__(kWarps * 32)
sigma_gemv(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
           const uint8_t* __restrict__ sg, float* __restrict__ y, int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int chunks = K >> 4;
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * K);
  const uint4* srow = reinterpret_cast<const uint4*>(sg + (size_t)n * K);
  float facc[MT];
  int iacc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) { facc[m] = 0.0f; iacc[m] = 0; }
  for (int i = lane; i < chunks; i += 32) {
    const uint4 wv = __ldg(wrow + i), sv = __ldg(srow + i);
    const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
    const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
    // the 16 products of the chunk, in the policy's width
    uint16_t p16[16];
    uint32_t p32[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t a = (ww[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      const uint32_t b = (sw[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      if constexpr (P == kA || P == kC)
        p16[j] = static_cast<uint16_t>(static_cast<uint16_t>(a) * static_cast<uint16_t>(b));
      else
        p32[j] = a * b;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const uint4 xv4 = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K) + i);
        const uint32_t xw[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
        if constexpr (P == kA || P == kA2) {
          float d = facc[m];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            float p;
            if constexpr (P == kA) p = __bfloat162float(__ushort2bfloat16_rn(p16[j]));
            else p = __bfloat162float(__uint2bfloat16_rn(p32[j]));
            const float xv = __bfloat162float(__int2bfloat16_rn(sext8(xw[j >> 2], j & 3)));
            d = fmaf(xv, p, d);
          }
          facc[m] = d;
        } else if constexpr (P == kC) {
          int d = iacc[m];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int lo = static_cast<int>(p16[4 * t] | (static_cast<uint32_t>(p16[4 * t + 1]) << 16));
            const int hi = static_cast<int>(p16[4 * t + 2] | (static_cast<uint32_t>(p16[4 * t + 3]) << 16));
            d = __dp2a_lo(lo, static_cast<int>(xw[t]), d);  // x bytes 0, 1
            d = __dp2a_hi(hi, static_cast<int>(xw[t]), d);  // x bytes 2, 3
          }
          iacc[m] = d;
        } else {  // kD
          int d = iacc[m];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const uint32_t pk = p32[4 * t] | (p32[4 * t + 1] << 8) | (p32[4 * t + 2] << 16) |
                                (p32[4 * t + 3] << 24);
            d = dp4a_su(xw[t], pk, d);
          }
          iacc[m] = d;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float v;
      if constexpr (P == kA || P == kA2) {
        v = facc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      } else {
        int q = iacc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
        v = __int2float_rn(q);
      }
      if (lane == 0) y[(size_t)m * N + n] = v;
    }
  }
}

template <int P>
void launch(const int8_t* x, const uint8_t* w, const uint8_t* sg, float* y, int M, int N, int K,
            cudaStream_t st) {
  const dim3 grid((N + kWarps - 1) / kWarps);
  if (M == 1) sigma_gemv<P, 1><<<grid, kWarps * 32, 0, st>>>(x, w, sg, y, M, N, K);
  else sigma_gemv<P, 16><<<grid, kWarps * 32, 0, st>>>(x, w, sg, y, M, N, K);
}

}  // namespace

// x int8 [M, K], w uint8 [N, K], sigma uint8 [N, K], y f32 [M, N]; K a
// multiple of 16. Returns the cudaError_t of the launch; 1
// (cudaErrorInvalidValue) for arguments the kernels do not take.
extern "C" int probe_sigma_i16(int policy, const void* x, const void* w, const void* sigma,
                               void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0 || (K & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const uint8_t*>(sigma);
  auto* yp = static_cast<float*>(y);
  switch (policy) {
    case kA: launch<kA>(xp, wp, sp, yp, M, N, K, st); break;
    case kA2: launch<kA2>(xp, wp, sp, yp, M, N, K, st); break;
    case kC: launch<kC>(xp, wp, sp, yp, M, N, K, st); break;
    case kD: launch<kD>(xp, wp, sp, yp, M, N, K, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
