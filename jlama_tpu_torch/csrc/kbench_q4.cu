// P1: the q4 GEMV design variants of scripts/kbench_q4.py, for Hopper (sm_90a).
//
// Replaces the Pallas bodies of scripts/kbench_q4.py: _k_v3a (:46), _k_v3b
// (:87), _k_v4 (:125), _k_v7 (:171), _k_v8 (:244), _k_v8b (:348), _k_v9
// (:295), _k_v11 (:404), and the diagnostics _k_dot2 (:456), _k_di8 (:487)
// and _k_stream (:538); plus the bench's rows of K1's own body
// (jlama_tpu/ops/pallas_q4.py:113, rows v2cur, v2p*, v2par).
//
// Every variant computes y[M,N] = x[M,K] . deq(W)[N,K]^T from the port's JQ4
// layout (uint8 [N, K/2]: byte j of a 32-block holds element j in the low
// nibble and element j+16 in the high nibble) with bf16 block scales, as the
// JAX bench passes them. Each rounds where its TPU kernel rounds: the product
// of a plane value and its scale is rounded to bf16, the dot sums in f32, and
// the output is bf16. What differs is how a variant gets there, its policy:
//
//   kI32        (v2cur, v2p*, v11) per byte, shift and mask in 32-bit registers;
//   kSwar8      (v8, v9)  mask and shift the whole 32-bit word, four bytes at once;
//   kSwar8Mask  (v8b u8)  masks only: the high plane keeps its x16 and takes s/16;
//   kSwar16Mask (v8b i16) prmt two bytes into 16-bit lanes, then masks only;
//   kI32Mask    (v8b i32) masks only, per byte in 32-bit registers;
//   kMagicSub   (v3a) lop3 (w & 0x000F000F) | 0x43004300 gives two bf16 128+n
//                     in one register; __hsub2 of 136 leaves n-8 exactly;
//   kMagic      (v4)  the same planes 128+n with no subtract;
//   kFloor      (v3b) the byte as a float, hi = floor(b/16), lo = b - 16 hi;
//   kByte       (v7)  the byte itself feeds the dot against x_lo, and only hi
//                     is extracted, against x_hi - 16 x_lo rounded to bf16.
// The -8 offset is removed in registers (kMagicSub, kFloor) or by the rank-1
// term C . sum_b bsum_b s_b with f32 block sums of x (C = 136 for kMagic, 8
// for the rest). The scales are per block (bf16 [N, K/32]) or pre-expanded
// (bf16 [N, K/2], one per byte in the JQ4 repeat order: v9 and v11, whose
// JAX forms differ only in the byte order of that array).
//
// The structure is K1's decode GEMV (csrc/q4_matmul.cu): one warp per output
// row, one 128-bit load per 32-block, up to 16 x rows read through the
// read-only cache, a warp-shuffle reduction. `rows` is the JAX block_n sweep
// read as output rows per thread block: 8 warps walk a block's rows in turn,
// so few, wide blocks leave SMs idle. It is a launch argument, not a template
// parameter, so one instantiation serves every width.
//
// The diagnostics take the raw byte matrix with the JAX column -> scale map
// (column c takes s[c mod nb]) and x[:, :K/2]: `stream` (x . bytes^T + the
// row's scale sum: the least math that keeps every byte live, the card's
// roofline for these bytes), `dot2` (the same plus a scaled second dot) and
// `di8` (a __dp4a GEMV over the bytes as s8 against int8(clip(16 x)), plus
// s[0, 0]).
//
// What bounds it on the H100: the weight bytes, N K/2 payload + N K/32 x 2
// bf16 scales (n K for pre-expanded scales: twice the payload), at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Policy {
  kI32 = 0,
  kSwar8 = 1,
  kSwar8Mask = 2,
  kSwar16Mask = 3,
  kI32Mask = 4,
  kMagicSub = 5,
  kMagic = 6,
  kFloor = 7,
  kByte = 8,
};
enum Diag { kStream = 0, kDot2 = 1, kDi8 = 2 };

constexpr int kWarps = 8;

template <int P> struct Offset { static constexpr float value = 8.0f; };
template <> struct Offset<kMagicSub> { static constexpr float value = 0.0f; };
template <> struct Offset<kFloor> { static constexpr float value = 0.0f; };
template <> struct Offset<kMagic> { static constexpr float value = 136.0f; };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;  // (a & b) | c in one instruction (immLut 0xEA)
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 16 consecutive bf16 values into floats.
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

// A pair of magic-split planes (bf16 128+n in each half) times its scales.
template <int P>
__device__ __forceinline__ float2 magic_pair(uint32_t planes, float s0, float s1) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&planes);
  if (P == kMagicSub) v = __hsub2(v, __floats2bfloat162_rn(136.0f, 136.0f));
  return __bfloat1622float2(__hmul2(v, __floats2bfloat162_rn(s0, s1)));
}

// One 32-block (16 packed bytes) -> the bf16-rounded weights of its low
// plane wl[j] (element j) and high plane wh[j] (element j + 16), each byte j
// under scale sc[j]. For kByte wl is byte * s (against x_lo) and wh is
// hi * s (against x_hi - 16 x_lo).
template <int P>
__device__ __forceinline__ void dequant_block(uint4 pk, const float* sc, float* wl, float* wh) {
  const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = words[i];
    if constexpr (P == kMagicSub || P == kMagic) {
      const uint32_t l02 = lop3_and_or(w, 0x000F000Fu, 0x43004300u);
      const uint32_t l13 = lop3_and_or(w >> 8, 0x000F000Fu, 0x43004300u);
      const uint32_t h02 = lop3_and_or(w >> 4, 0x000F000Fu, 0x43004300u);
      const uint32_t h13 = lop3_and_or(w >> 12, 0x000F000Fu, 0x43004300u);
      const int j = 4 * i;
      float2 a = magic_pair<P>(l02, sc[j], sc[j + 2]);
      float2 b = magic_pair<P>(l13, sc[j + 1], sc[j + 3]);
      float2 c = magic_pair<P>(h02, sc[j], sc[j + 2]);
      float2 d = magic_pair<P>(h13, sc[j + 1], sc[j + 3]);
      wl[j] = a.x; wl[j + 2] = a.y; wl[j + 1] = b.x; wl[j + 3] = b.y;
      wh[j] = c.x; wh[j + 2] = c.y; wh[j + 1] = d.x; wh[j + 3] = d.y;
    } else if constexpr (P == kSwar16Mask) {
      const uint32_t p01 = __byte_perm(w, 0, 0x4140);  // bytes 0, 1 -> 16-bit lanes
      const uint32_t p23 = __byte_perm(w, 0, 0x4342);  // bytes 2, 3
      const uint32_t lo[2] = {p01 & 0x000F000Fu, p23 & 0x000F000Fu};
      const uint32_t hi[2] = {p01 & 0x00F000F0u, p23 & 0x00F000F0u};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * i + t, sh = 16 * (t & 1);
        wl[j] = bf16r(static_cast<float>((lo[t >> 1] >> sh) & 0xFFFFu) * sc[j]);
        wh[j] = bf16r(static_cast<float>((hi[t >> 1] >> sh) & 0xFFFFu) * bf16r(sc[j] * 0.0625f));
      }
    } else if constexpr (P == kSwar8 || P == kSwar8Mask) {
      const uint32_t lo4 = w & 0x0F0F0F0Fu;
      const uint32_t hi4 = P == kSwar8 ? (w >> 4) & 0x0F0F0F0Fu : w & 0xF0F0F0F0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * i + t;
        const float hs = P == kSwar8 ? sc[j] : bf16r(sc[j] * 0.0625f);
        wl[j] = bf16r(static_cast<float>((lo4 >> (8 * t)) & 0xFFu) * sc[j]);
        wh[j] = bf16r(static_cast<float>((hi4 >> (8 * t)) & 0xFFu) * hs);
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * i + t;
        const uint32_t b = (w >> (8 * t)) & 0xFFu;
        if constexpr (P == kI32) {
          wl[j] = bf16r(static_cast<float>(b & 0xFu) * sc[j]);
          wh[j] = bf16r(static_cast<float>(b >> 4) * sc[j]);
        } else if constexpr (P == kI32Mask) {
          wl[j] = bf16r(static_cast<float>(b & 0x0Fu) * sc[j]);
          wh[j] = bf16r(static_cast<float>(b & 0xF0u) * bf16r(sc[j] * 0.0625f));
        } else if constexpr (P == kFloor) {
          const float f = static_cast<float>(b);
          const float hi = floorf(f * 0.0625f);
          const float lo = f - hi * 16.0f;
          wl[j] = bf16r((lo - 8.0f) * sc[j]);
          wh[j] = bf16r((hi - 8.0f) * sc[j]);
        } else {  // kByte
          wl[j] = bf16r(static_cast<float>(b) * sc[j]);
          wh[j] = bf16r(static_cast<float>(b >> 4) * sc[j]);
        }
      }
    }
  }
}

template <int P, bool EXPANDED, int MT>
__global__ void __launch_bounds__(kWarps * 32)
q4_variant_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ srep,
                __nv_bfloat16* __restrict__ y, int M, int N, int K, int rows) {
  constexpr float C = Offset<P>::value;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nb = K >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(N, r0 + rows);
  for (int n = r0 + warp; n < r1; n += kWarps) {
    const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * (K >> 1));
    const __nv_bfloat16* srow = s + (size_t)n * nb;
    float acc[MT], corr[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = corr[m] = 0.0f;
    for (int b = lane; b < nb; b += 32) {
      const uint4 pk = __ldg(wrow + b);
      const float sb = __bfloat162float(srow[b]);
      float sc[16];
      if constexpr (EXPANDED) {
        load_bf16x16(srep + (size_t)n * (K >> 1) + (size_t)b * 16, sc);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) sc[j] = sb;
      }
      float wl[16], wh[16];
      dequant_block<P>(pk, sc, wl, wh);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          float xv[32];
          load_bf16x16(x + (size_t)m * K + (size_t)b * 32, xv);
          load_bf16x16(x + (size_t)m * K + (size_t)b * 32 + 16, xv + 16);
          float d = acc[m];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            d = fmaf(xv[j], wl[j], d);
            if constexpr (P == kByte) {
              d = fmaf(bf16r(xv[16 + j] - 16.0f * xv[j]), wh[j], d);
            } else {
              d = fmaf(xv[16 + j], wh[j], d);
            }
          }
          acc[m] = d;
          if constexpr (C != 0.0f) {
            float bs = 0.0f;
#pragma unroll
            for (int e = 0; e < 32; ++e) bs += xv[e];
            corr[m] = fmaf(bs, sb, corr[m]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float d = acc[m], c = corr[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          d += __shfl_xor_sync(0xffffffffu, d, off);
          c += __shfl_xor_sync(0xffffffffu, c, off);
        }
        if (lane == 0) y[(size_t)m * N + n] = __float2bfloat16_rn(d - C * c);
      }
    }
  }
}

// The diagnostics: lanes stride over the row's 16-byte chunks; chunk i holds
// byte columns 16 i .. 16 i + 15, against x[:, 16 i .. 16 i + 15].
template <int D, int MT>
__global__ void __launch_bounds__(kWarps * 32)
q4_diag_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
             const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int N,
             int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int kh = K >> 1, nb = K >> 5, chunks = kh >> 4;
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * kh);
  const __nv_bfloat16* srow = s + (size_t)n * nb;
  float acc[MT];
  int iacc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) { acc[m] = 0.0f; iacc[m] = 0; }
  float ssum = 0.0f;
  if constexpr (D == kStream) {
    for (int b = lane; b < nb; b += 32) ssum += __bfloat162float(srow[b]);
  }
  for (int i = lane; i < chunks; i += 32) {
    const uint4 pk = __ldg(wrow + i);
    const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
    float wb[16], ws[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) wb[j] = static_cast<float>((words[j >> 2] >> (8 * (j & 3))) & 0xFFu);
    if constexpr (D == kDot2) {
      int c = (16 * i) % nb;  // column 16 i + j takes s[(16 i + j) mod nb]
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        ws[j] = bf16r(wb[j] * __bfloat162float(srow[c]));
        if (++c == nb) c = 0;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float xv[16];
        load_bf16x16(x + (size_t)m * K + (size_t)i * 16, xv);
        if constexpr (D == kDi8) {
          int q = iacc[m];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            uint32_t xw = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = fminf(fmaxf(16.0f * xv[4 * t + e], -127.0f), 127.0f);
              xw |= (static_cast<uint32_t>(static_cast<int>(v)) & 0xFFu) << (8 * e);
            }
            q = __dp4a(static_cast<int>(xw), static_cast<int>(words[t]), q);
          }
          iacc[m] = q;
        } else {
          float d = acc[m];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            d = fmaf(xv[j], wb[j], d);
            if constexpr (D == kDot2) d = fmaf(xv[j], ws[j], d);
          }
          acc[m] = d;
        }
      }
    }
  }
  const float s00 = __bfloat162float(s[0]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ssum += __shfl_xor_sync(0xffffffffu, ssum, off);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float v;
      if constexpr (D == kDi8) {
        int q = iacc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
        v = __int2float_rn(q) + s00;
      } else {
        v = acc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if constexpr (D == kStream) v += ssum;
      }
      if (lane == 0) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <int P, bool EXPANDED>
void launch_variant(const void* x, const uint8_t* w, const void* s, const void* srep, void* y,
                    int M, int N, int K, int rows, cudaStream_t st) {
  const dim3 grid((N + rows - 1) / rows);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* rp = static_cast<const __nv_bfloat16*>(srep);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (M == 1)
    q4_variant_gemv<P, EXPANDED, 1><<<grid, kWarps * 32, 0, st>>>(xp, w, sp, rp, yp, M, N, K, rows);
  else
    q4_variant_gemv<P, EXPANDED, 16><<<grid, kWarps * 32, 0, st>>>(xp, w, sp, rp, yp, M, N, K, rows);
}

template <int D>
void launch_diag(const void* x, const uint8_t* w, const void* s, void* y, int M, int N, int K,
                 cudaStream_t st) {
  const dim3 grid((N + kWarps - 1) / kWarps);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (M == 1)
    q4_diag_gemv<D, 1><<<grid, kWarps * 32, 0, st>>>(xp, w, sp, yp, M, N, K);
  else
    q4_diag_gemv<D, 16><<<grid, kWarps * 32, 0, st>>>(xp, w, sp, yp, M, N, K);
}

}  // namespace

// x bf16 [M, K], w uint8 [N, K/2], s bf16 [N, K/32], srep bf16 [N, K/2] (only
// with `expanded`), y bf16 [M, N]. Returns the cudaError_t of the launch;
// 1 (cudaErrorInvalidValue) for arguments no instantiation takes.
extern "C" int kbench_q4_gemv(int policy, int expanded, const void* x, const void* w,
                              const void* s, const void* srep, void* y, int M, int N, int K,
                              int rows, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0 || (K & 31) || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const int key = policy * 2 + (expanded ? 1 : 0);
  switch (key) {
    case kI32 * 2: launch_variant<kI32, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kI32 * 2 + 1: launch_variant<kI32, true>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kSwar8 * 2: launch_variant<kSwar8, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kSwar8 * 2 + 1: launch_variant<kSwar8, true>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kSwar8Mask * 2:
      launch_variant<kSwar8Mask, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kSwar16Mask * 2:
      launch_variant<kSwar16Mask, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kI32Mask * 2: launch_variant<kI32Mask, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kMagicSub * 2:
      launch_variant<kMagicSub, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kMagic * 2: launch_variant<kMagic, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kFloor * 2: launch_variant<kFloor, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    case kByte * 2: launch_variant<kByte, false>(x, wp, s, srep, y, M, N, K, rows, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [M, K] (the kernels read x[:, :K/2]), w uint8 [N, K/2], s bf16
// [N, K/32], y bf16 [M, N].
extern "C" int kbench_q4_diag(int kind, const void* x, const void* w, const void* s, void* y,
                              int M, int N, int K, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0 || (K & 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  switch (kind) {
    case kStream: launch_diag<kStream>(x, wp, s, y, M, N, K, st); break;
    case kDot2: launch_diag<kDot2>(x, wp, s, y, M, N, K, st); break;
    case kDi8: launch_diag<kDi8>(x, wp, s, y, M, N, K, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
