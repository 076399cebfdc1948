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
// bytes per weight (4-bit payload + f32 block scale) against the SXM data
// sheet's 3.35 TB/s (0.239 ms for one 16-slot Llama-3.2-1B decode step: 16 x
// (wqkv, wo, w13, w2) + the lm_head); the x rows are small and stay in L1/L2.
// In prefill (M in the hundreds) the tensor cores (989 TFLOP/s bf16 dense).
//
// Routes:
//   M = 1, and f32 x at M <= 16 - q4_gemv_kernel: one warp per output row;
//             lanes stride over the K/32 blocks with one 128-bit load each,
//             dequantize in registers and dot with up to 16 x rows read
//             through the read-only cache; a warp-shuffle reduction ends each
//             row. Every product and sum is f32 on the CUDA cores, x as given.
//   bf16 x, 2 <= M <= 16 - q4_mma_kernel: the same sums on the bf16 tensor
//             cores (mma.sync m16n8k16, f32 accumulate). At M = 16 the GEMV
//             spends 16 multiply-adds a weight on the CUDA cores and runs at a
//             few percent of the weight stream's bound; the tensor cores take
//             them off. Numerics are the GEMV's: (nibble - 8) is exact in
//             bf16, each product x * (nibble - 8) is exact in f32, and each
//             32-block's partial sum is scaled by its f32 scale with one fmaf
//             per weight row (the scale is never rounded to bf16 nor folded
//             into the weights); only the order of the f32 sums differs.
//             Design (see the kernel's comment):
//             * A is the dequantized weights (16 rows x k16), B the
//               activations (k16 x 8 tokens), C 16 rows x 8 tokens; NT = 1 or
//               2 token tiles for M <= 8 or <= 16. A thread's C rows (gid,
//               gid + 8) are the rows whose bytes and scales it loads.
//             * The k order inside one mma is free as long as A and B share
//               it: thread t = lane & 3 takes block elements 4t..4t+3 (and
//               16 + 4t..), so its weights for one 32-block are the 32-bit
//               word t of the row's 16 bytes, as JQ4 stores them (no repack,
//               so a tied lm_head still shares the embedding table). Low
//               nibbles feed the first k16 step, high nibbles the second;
//               (r & 0x000F000F) | 0x43004300 is the bf16 pair (128 + n),
//               and one bf16x2 subtraction of 136 leaves n - 8.
//             * A block of 8 warps owns 16 * RT rows (RT = 2 where that
//               still gives every SM a block, else 1) and its warps split
//               the 32-blocks (warp w takes b = w, w + 8, ..., so the block
//               reads whole 32-byte sectors of each row together); x is read
//               through L1, where the warps and blocks on an SM share it.
//               The warps' partials are summed in shared memory in warp
//               order, so the result is deterministic. On the H100, 64 rows
//               a block, 16 warps, a deeper unroll and weight loads that skip
//               L1 were each no faster at the six bench shapes.
//             No cp.async/TMA pipeline, no wgmma, no new layout yet.
//   M > 16  - q4_gemm_kernel: 64x128 output tile per block of 8 warps; each
//             64-wide K step dequantizes the W tile to bf16 in shared memory
//             and multiplies with nvcuda::wmma bf16 -> f32 (16x16x16). No
//             cp.async/TMA pipelining and no wgmma yet: a later PR's work.
// Each route returns its own launch error; none falls back to another.
// Ragged M and N edges are masked; K must be a multiple of 32; x and y are
// row-major contiguous; x is bf16 or f32, y is bf16 or f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// ---- bf16 x, 2 <= M <= 16: q4_mma_kernel ---------------------------------

constexpr int kMmaWarps = 8;
constexpr uint32_t kBf16x2_136 = 0x43084308u;  // (136, 136) in bf16

// The nibbles at bits [3:0] and [19:16] of v as the bf16 pair (n_lo - 8,
// n_hi - 8), exactly: the OR makes 128 + n (exponent 2^7, n in the low
// mantissa bits), the subtraction of 136 is exact.
__device__ __forceinline__ uint32_t dq2(uint32_t v) {
  uint32_t r = (v & 0x000F000Fu) | 0x43004300u, k = kBf16x2_136;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<__nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&h);
}

// d = A (16x16 bf16, row) . B (16x8 bf16, col) + c, f32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1,
                                         const float* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// y[M, N] for bf16 x and 2 <= M <= 16; block = 16 * RT weight rows, NT token
// tiles of 8.
//
// Fragments (lane = 4 * gid + t). The k slots (2t, 2t+1, 2t+8, 2t+9) of one
// k16 step s stand for block elements (16s + 4t, +2, +1, +3). With r the
// thread's word t of a row's 32-block (bytes 4t..4t+3; byte j holds element j
// low, j + 16 high):
//   A step 0: a0/a1 = dq2(r) of rows gid/gid+8 (elements 4t, 4t+2),
//             a2/a3 = dq2(r >> 8) (4t+1, 4t+3);
//   A step 1: the same with r >> 4 and r >> 12 (elements 16 + ...);
//   B step s: from the 8 bytes x[token][32b + 16s + 4t .. +3] = (x0 x1, x2 x3),
//             b0 = (x0, x2), b1 = (x1, x3), token = 8j + gid.
//   C: c0/c1 row gid, tokens 8j + 2t, +1; c2/c3 row gid + 8.
// Rows at or past N read row N - 1 and tokens at or past M read token M - 1
// (valid memory, no divergence); their outputs are never stored.
template <typename TY, int RT, int NT>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
q4_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ s, TY* __restrict__ y, int M, int N, int K) {
  constexpr int kFrags = RT * NT * 4;  // f32 accumulators a thread
  __shared__ float red[kMmaWarps][kFrags][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * (RT * 16);
  const int nb = K >> 5;

  const uint32_t* wr[RT][2];  // word tig of block 0 of each of the thread's rows
  const float* sr[RT][2];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = min(n0 + 16 * i + 8 * h + gid, N - 1);
      wr[i][h] = reinterpret_cast<const uint32_t*>(w + (size_t)n * (K >> 1)) + tig;
      sr[i][h] = s + (size_t)n * nb;
    }
  const __nv_bfloat16* xr[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) xr[j] = x + (size_t)min(8 * j + gid, M - 1) * K + 4 * tig;

  float acc[RT][NT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};

#pragma unroll 2
  for (int b = warp; b < nb; b += kMmaWarps) {
    uint32_t wv[RT][2];
    float sc[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wv[i][h] = __ldg(wr[i][h] + 4 * b);
        sc[i][h] = __ldg(sr[i][h] + b);
      }
    uint32_t bx[NT][4];  // step 0 (b0, b1), step 1 (b0, b1)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(xr[j] + 32 * b + 16 * st));
        bx[j][2 * st] = __byte_perm(v.x, v.y, 0x5410);
        bx[j][2 * st + 1] = __byte_perm(v.x, v.y, 0x7632);
      }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const uint32_t r0 = wv[i][0], r1 = wv[i][1];
      const uint32_t lo[4] = {dq2(r0), dq2(r1), dq2(r0 >> 8), dq2(r1 >> 8)};
      const uint32_t hi[4] = {dq2(r0 >> 4), dq2(r1 >> 4), dq2(r0 >> 12), dq2(r1 >> 12)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float c[4];
        mma_bf16(c, lo, bx[j][0], bx[j][1], zero);
        mma_bf16(c, hi, bx[j][2], bx[j][3], c);
        acc[i][j][0] = fmaf(c[0], sc[i][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(c[1], sc[i][0], acc[i][j][1]);
        acc[i][j][2] = fmaf(c[2], sc[i][1], acc[i][j][2]);
        acc[i][j][3] = fmaf(c[3], sc[i][1], acc[i][j][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][(i * NT + j) * 4 + e][lane] = acc[i][j][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kFrags * 32; idx += kMmaWarps * 32) {
    const int f = idx >> 5, l = idx & 31;
    float v = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kMmaWarps; ++wp) v += red[wp][f][l];
    const int e = f & 3, j = (f >> 2) % NT, i = (f >> 2) / NT;
    const int row = n0 + 16 * i + (l >> 2) + 8 * (e >> 1);
    const int tok = 8 * j + 2 * (l & 3) + (e & 1);
    if (row < N && tok < M) y[(size_t)tok * N + row] = from_f32<TY>(v);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename TY, int NT>
void launch_mma(const __nv_bfloat16* x, const uint8_t* w, const float* s, TY* y, int M, int N,
                int K, cudaStream_t st) {
  // 32 rows a block once that still gives every SM a block, else 16
  const int blocks2 = (N + 31) / 32;
  if (blocks2 >= sm_count())
    q4_mma_kernel<TY, 2, NT><<<blocks2, kMmaWarps * 32, 0, st>>>(x, w, s, y, M, N, K);
  else
    q4_mma_kernel<TY, 1, NT><<<(N + 15) / 16, kMmaWarps * 32, 0, st>>>(x, w, s, y, M, N, K);
}

// ---- M > 16: q4_gemm_kernel -----------------------------------------------

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
  if (M <= 1) {
    launch_gemv<TX, TY, 1>(x, w, s, y, M, N, K, st);
  } else if (M <= 16) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
      TY* yp = static_cast<TY*>(y);
      if (M <= 8) launch_mma<TY, 1>(xp, w, s, yp, M, N, K, st);
      else launch_mma<TY, 2>(xp, w, s, yp, M, N, K, st);
    } else {
      if (M <= 2) launch_gemv<TX, TY, 2>(x, w, s, y, M, N, K, st);
      else if (M <= 4) launch_gemv<TX, TY, 4>(x, w, s, y, M, N, K, st);
      else if (M <= 8) launch_gemv<TX, TY, 8>(x, w, s, y, M, N, K, st);
      else launch_gemv<TX, TY, 16>(x, w, s, y, M, N, K, st);
    }
  } else {
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
