// K1: fused JQ4 dequant + matmul for Hopper (sm_90a).
//
// Replaces jlama_tpu/ops/pallas_q4.py:_q4_matmul_kernel (launched by
// q4k_matmul_2d). Computes y[M,N] = x[M,K] . deq(W)[N,K]^T with f32
// accumulation, where W is the checkpoint's JQ4 payload as it is:
//   packed uint8 [N, K/2]: byte j of a 32-block holds element j in the low
//   nibble and element j+16 in the high nibble, value = (nibble - 8) * scale;
//   scales float32 [N, K/32] (kept f32: the TPU kernel rounds them to bf16,
//   this one does not, so the decode path dequantizes exactly).
// One 16-byte load is exactly one 32-block, so the TPU's q4k column
// permutation (a Mosaic tiling workaround) is not needed, and the -8 offset is
// subtracted in registers instead of the TPU kernel's rank-1 correction.
//
// What bounds it on the H100: in decode (M <= 16) the weight stream, 0.625
// bytes per weight (4-bit payload + f32 block scale) against 3.35 TB/s; the
// x rows are tiny and stay in L1/L2. In prefill (M in the hundreds) the
// tensor cores (989 TFLOP/s bf16 dense).
//
// Design:
//   decode  - q4_gemv_kernel: one warp per output row; lanes stride over the
//             K/32 blocks with one 128-bit load each, dequantize in registers
//             and dot with up to 16 x rows read through the read-only cache;
//             a warp-shuffle reduction ends each row.
//   prefill - q4_gemm_kernel: 64x128 output tile per block of 8 warps; each
//             64-wide K step dequantizes the W tile to bf16 in shared memory
//             and multiplies with nvcuda::wmma bf16 -> f32 (16x16x16). No
//             cp.async/TMA pipelining and no wgmma yet: a later PR's work.
// Ragged M and N edges are masked; K must be a multiple of 32; x and y are
// row-major contiguous; x is bf16 or f32, y is bf16 or f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 32 consecutive x values (one block's worth) into registers.
__device__ __forceinline__ void load_x32(const __nv_bfloat16* p, float* out) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

__device__ __forceinline__ void load_x32(const float* p, float* out) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4 f = __ldg(p4 + i);
    out[i * 4 + 0] = f.x;
    out[i * 4 + 1] = f.y;
    out[i * 4 + 2] = f.z;
    out[i * 4 + 3] = f.w;
  }
}

// One packed 32-block (16 bytes) -> 32 signed values (nibble - 8), in
// element order.
__device__ __forceinline__ void unpack_block(uint4 pk, float* wv) {
  const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t byte = (words[i] >> (8 * j)) & 0xFFu;
      wv[i * 4 + j] = static_cast<float>(byte & 0xFu) - 8.0f;
      wv[16 + i * 4 + j] = static_cast<float>(byte >> 4) - 8.0f;
    }
  }
}

constexpr int kGemvWarps = 8;

template <typename TX, typename TY, int MT>
__global__ void __launch_bounds__(kGemvWarps * 32)
q4_gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ s, TY* __restrict__ y, int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + warp;
  if (n >= N) return;  // whole warp leaves together
  const int nb = K >> 5;
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * (K >> 1));
  const float* srow = s + (size_t)n * nb;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;

  for (int b = lane; b < nb; b += 32) {
    const uint4 pk = __ldg(wrow + b);
    const float sc = __ldg(srow + b);
    float wv[32];
    unpack_block(pk, wv);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float xv[32];
        load_x32(x + (size_t)m * K + (size_t)b * 32, xv);
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < 32; ++e) d = fmaf(xv[e], wv[e], d);
        acc[m] = fmaf(d, sc, acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float v = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) y[(size_t)m * N + n] = from_f32<TY>(v);
    }
  }
}

constexpr int BM = 64, BN = 128, BK = 64, LDS = BK + 8, kGemmThreads = 256;

template <typename TX, typename TY>
__global__ void __launch_bounds__(kGemmThreads)
q4_gemm_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ s, TY* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDS];
  __shared__ __align__(32) float Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = warp >> 2;  // 2 warp rows of 32 output rows
  const int wn = warp & 3;   // 4 warp columns of 32 output columns
  const int nb = K >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [BM, BK] -> bf16 in shared memory (zero past M and K)
    for (int i = tid; i < BM * BK; i += kGemmThreads) {
      const int r = i / BK, col = i % BK;
      const int gm = m0 + r, gk = k0 + col;
      const float v = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.0f;
      As[r * LDS + col] = __float2bfloat16(v);
    }
    // W tile: BN rows x 2 blocks of 32, one (row, block) per thread
    {
      const int r = tid >> 1, blk = tid & 1;
      const int gn = n0 + r, kb = (k0 >> 5) + blk;
      __nv_bfloat16* dst = Bs + r * LDS + blk * 32;
      if (gn < N && kb < nb) {
        const uint4 pk = __ldg(reinterpret_cast<const uint4*>(w + (size_t)gn * (K >> 1)) + kb);
        const float sc = __ldg(s + (size_t)gn * nb + kb);
        float wv[32];
        unpack_block(pk, wv);
#pragma unroll
        for (int e = 0; e < 32; ++e) dst[e] = __float2bfloat16(wv[e] * sc);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) dst[e] = __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], bfr[j], c[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time, then writes the
  // in-range elements in the output type
  float* cw = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cw, c[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * 32 + i * 16 + (e >> 4);
        const int gn = n0 + wn * 32 + j * 16 + (e & 15);
        if (gm < M && gn < N) y[(size_t)gm * N + gn] = from_f32<TY>(cw[e]);
      }
      __syncwarp();
    }
  }
}

template <typename TX, typename TY, int MT>
void launch_gemv(const void* x, const uint8_t* w, const float* s, void* y, int M, int N,
                 int K, cudaStream_t st) {
  dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  q4_gemv_kernel<TX, TY, MT><<<grid, kGemvWarps * 32, 0, st>>>(
      static_cast<const TX*>(x), w, s, static_cast<TY*>(y), M, N, K);
}

template <typename TX, typename TY>
void launch(const void* x, const uint8_t* w, const float* s, void* y, int M, int N, int K,
            cudaStream_t st) {
  if (M <= 1) launch_gemv<TX, TY, 1>(x, w, s, y, M, N, K, st);
  else if (M <= 2) launch_gemv<TX, TY, 2>(x, w, s, y, M, N, K, st);
  else if (M <= 4) launch_gemv<TX, TY, 4>(x, w, s, y, M, N, K, st);
  else if (M <= 8) launch_gemv<TX, TY, 8>(x, w, s, y, M, N, K, st);
  else if (M <= 16) launch_gemv<TX, TY, 16>(x, w, s, y, M, N, K, st);
  else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    q4_gemm_kernel<TX, TY><<<grid, kGemmThreads, 0, st>>>(
        static_cast<const TX*>(x), w, s, static_cast<TY*>(y), M, N, K);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1 (cudaErrorInvalidValue)
// for arguments the kernel does not take.
extern "C" int q4_matmul(const void* x, int x_dtype, const void* w, const void* scales,
                         void* y, int y_dtype, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (K & 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  if (x_dtype == kBF16 && y_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, wp, sp, y, M, N, K, st);
  else if (x_dtype == kBF16 && y_dtype == kF32)
    launch<__nv_bfloat16, float>(x, wp, sp, y, M, N, K, st);
  else if (x_dtype == kF32 && y_dtype == kBF16)
    launch<float, __nv_bfloat16>(x, wp, sp, y, M, N, K, st);
  else if (x_dtype == kF32 && y_dtype == kF32)
    launch<float, float>(x, wp, sp, y, M, N, K, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
