// P3, first half: the native-int4 probes of scripts/probe_int4.py, for Hopper
// (sm_90a).
//
// Replaces the Pallas bodies of probe_pallas (`kern`, scripts/probe_int4.py:69;
// launched by `mm` :84, call :85) and probe_bitcast (`kern` :103; `mm` :120,
// call :121). Both compute
//   y[M,N] = x[M,K] . (u4[N,K] * s[N, c mod NB])^T
// with unsigned nibbles 0..15 and no offset, the scales tiled along K as
// pltpu.repeat tiles them (column c takes s[c mod NB], not s[c // 32]), the
// bf16 product of nibble and scale rounded to bf16, f32 sums and a bf16
// output. The card has no 4-bit load or type: both probes stream the same
// packed bytes (uint8 [N, K/2], element 2i in the low nibble of byte i and
// element 2i+1 in the high one, the order bitcast_convert_type(u8 -> 2 x u4)
// gives) and differ in how a nibble becomes a bf16 value:
//   kCvt   ("u4 storage"): per nibble, shift, mask and an integer convert;
//   kMagic ("bitcast"):    lop3 (w & 0x000F000F) | 0x43004300 splits a loaded
//                          word into two bf16 128+n, __hsub2 of 128 leaves n.
//
// Structure: K1's decode GEMV (csrc/q4_matmul.cu): one warp per output row,
// one 128-bit load per 32 nibbles, up to 16 x rows read through the read-only
// cache, a warp-shuffle reduction. NB must be a multiple of 32, so that the
// 32 scales of a load are contiguous (the probe's NB is 128).
//
// What bounds it on the H100: the weight bytes, N K/2 payload + N NB x 2 bf16
// scales, at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Policy { kCvt = 0, kMagic = 1 };
constexpr int kWarps = 8;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;  // (a & b) | c in one instruction (immLut 0xEA)
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 8 consecutive bf16 values (one 16-byte load) into floats.
__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* p, float* out) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ float2 magic_pair(uint32_t planes, float s0, float s1) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&planes);
  v = __hsub2(v, __floats2bfloat162_rn(128.0f, 128.0f));
  return __bfloat1622float2(__hmul2(v, __floats2bfloat162_rn(s0, s1)));
}

// 16 packed bytes -> the bf16-rounded weights of its 32 elements.
template <int P>
__device__ __forceinline__ void dequant32(uint4 pk, const float* sc, float* wv) {
  const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = words[i];
    const int e = 8 * i;  // word i holds elements e .. e+7
    if constexpr (P == kMagic) {
      // halves: (e, e+4), (e+1, e+5), (e+2, e+6), (e+3, e+7)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 p = magic_pair(lop3_and_or(w >> (4 * t), 0x000F000Fu, 0x43004300u),
                                    sc[e + t], sc[e + t + 4]);
        wv[e + t] = p.x;
        wv[e + t + 4] = p.y;
      }
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        wv[e + t] = bf16r(static_cast<float>((w >> (4 * t)) & 0xFu) * sc[e + t]);
    }
  }
}

template <int P, int MT>
__global__ void __launch_bounds__(kWarps * 32)
u4_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
        const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int N, int K,
        int NB) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int chunks = K >> 5;  // 32 elements per 16-byte load
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * (K >> 1));
  const __nv_bfloat16* srow = s + (size_t)n * NB;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
  for (int i = lane; i < chunks; i += 32) {
    const uint4 pk = __ldg(wrow + i);
    float sc[32], wv[32];
    const int c0 = (32 * i) % NB;  // columns 32 i .. 32 i + 31 take s[c0 .. c0 + 31]
#pragma unroll
    for (int q = 0; q < 4; ++q) load_bf16x8(srow + c0 + 8 * q, sc + 8 * q);
    dequant32<P>(pk, sc, wv);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float xv[32];
#pragma unroll
        for (int q = 0; q < 4; ++q) load_bf16x8(x + (size_t)m * K + (size_t)i * 32 + 8 * q, xv + 8 * q);
        float d = acc[m];
#pragma unroll
        for (int e = 0; e < 32; ++e) d = fmaf(xv[e], wv[e], d);
        acc[m] = d;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float v = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <int P>
void launch(const void* x, const uint8_t* w, const void* s, void* y, int M, int N, int K, int NB,
            cudaStream_t st) {
  const dim3 grid((N + kWarps - 1) / kWarps);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (M == 1)
    u4_gemv<P, 1><<<grid, kWarps * 32, 0, st>>>(xp, w, sp, yp, M, N, K, NB);
  else if (M <= 8)
    u4_gemv<P, 8><<<grid, kWarps * 32, 0, st>>>(xp, w, sp, yp, M, N, K, NB);
  else
    u4_gemv<P, 16><<<grid, kWarps * 32, 0, st>>>(xp, w, sp, yp, M, N, K, NB);
}

}  // namespace

// x bf16 [M, K], w uint8 [N, K/2], s bf16 [N, NB], y bf16 [M, N]. Returns the
// cudaError_t of the launch; 1 (cudaErrorInvalidValue) for arguments the
// kernel does not take.
extern "C" int probe_int4(int policy, const void* x, const void* w, const void* s, void* y,
                          int M, int N, int K, int NB, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0 || (K & 31) || NB <= 0 || (NB & 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  if (policy == kCvt) launch<kCvt>(x, wp, s, y, M, N, K, NB, st);
  else if (policy == kMagic) launch<kMagic>(x, wp, s, y, M, N, K, NB, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
