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
//   M = 1, and f32 x at M <= 16 - q4_gemv_kernel (single-stream decode): the
//             weight stream on the CUDA cores. Each weight row is read once,
//             a 16-byte 32-block a lane, a warp's next loads in flight while it
//             computes; as many blocks as the SMs hold, each walking tiles of
//             rows; x's block read once for a warp's rows; (n - 8) made
//             exactly by a byte permute under 2^23 and one subtraction, no
//             conversion; rows a warp and slices of K from the wrapper's plan
//             (gemv_plan), so that every SM gets a tile where N allows. Each
//             product x * (n - 8) exact in f32, f32 sums, each 32-block's
//             partial scaled by its f32 scale; the slices meet in shared
//             memory in order (no atomics). A tensor-core GEMV at M = 1 was no
//             faster: the stream, not the math, bounds it (PERF.md, PR 12).
//             See the kernel's comment.
//   bf16 x, 2 <= M <= 16 - q4_mma_kernel: the same sums on the bf16 tensor
//             cores (mma.sync m16n8k16, f32 accumulate). At M = 16 a CUDA-core
//             GEMV spends 16 multiply-adds a weight and runs at a few percent
//             of the weight stream's bound; the tensor cores take them off.
//             Numerics are the GEMVs': (nibble - 8) is exact in
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
//   bf16 x, M > 16 - q4_wgmma_kernel (prefill: Engine's 512-token bucket, the
//             scheduler's 256-token chunks times rows, perplexity windows of
//             1024 whose f32 x the wrapper casts to bf16 first, as the TPU
//             wrapper does): a warp-specialised Hopper GEMM. One producer warp
//             keeps a ring of 4 shared-memory stages fed with TMA (x, packed W)
//             under mbarriers; one warpgroup dequantizes each stage's W to
//             bf16((n - 8) * s) in the 128-byte swizzle; one or two
//             warpgroups run wgmma bf16 -> f32 on it. The
//             tile (64 or 128 tokens x 64 or 128 rows) is chosen per shape so
//             that every SM gets a block. See the kernel's comment.
// Each route returns its own launch error; none falls back to another.
// Ragged M and N edges are masked; K must be a multiple of 32; x and y are
// row-major contiguous; x is bf16 or f32 (bf16 only past M = 16), y is bf16 or f32.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- M = 1, and f32 x at M <= 16: q4_gemv_kernel ----------------------------
//
// The weight stream on the CUDA cores. A tile of R * kGemvWarps / S rows is
// one block's work: each warp R rows (R = 4, 2 or 1 at M = 1, else 1) and one
// of S slices of their 32-blocks; R and S come from the wrapper's plan
// (q4_matmul.py:gemv_plan), which picks them from N, K and the SM count so that
// every SM gets a tile where N and K allow. The grid is as many blocks as the SMs hold at once (at
// most one a tile), and each block walks tiles blockIdx.x, + gridDim.x, ...
// A lane takes 32-blocks kb0 + lane, + 32, ...: each load is one 16-byte
// 32-block, and a warp's load of a row is 512 contiguous bytes. A load group
// is kGemvSteps such loads for each of the warp's R rows, with their scales;
// a warp issues the next group's loads (the next tile's, at a tile's end)
// before it computes the current one, so the stream does not stop while the
// SM does arithmetic. Then it reads x's 32 values of each block once (through
// L1, where the SM's warps share them) and dots them with that block of each
// of its rows. (n - 8) is made exactly without a conversion: __byte_perm puts
// the nibble under the exponent of 2^23 (the float 2^23 + n), and one
// subtraction of 2^23 + 8 leaves n - 8. Each product x * (n - 8) is exact in
// f32, each 32-block's f32 partial is scaled by its f32 scale (fmaf), and a
// tile's sums meet in shared memory in slice order: no atomics, so a repeat
// gives the same bits. x as given (bf16 or f32, never rounded). Rows at or
// past N read row N - 1 and are not stored.

constexpr int kGemvWarps = 8;
constexpr int kGemvSteps = 1;  // 32-blocks of each row a lane loads in one group

// A slice [kb0, kb1) of K's 32-blocks: S runs of gemv_slice_len blocks, whole
// multiples of 32, the last one short.
__device__ __forceinline__ int gemv_slice_len(int nb, int S) {
  return ((nb + 31) / 32 + S - 1) / S * 32;
}

__device__ __forceinline__ void gemv_slice(int nb, int S, int slice, int& kb0, int& kb1) {
  kb0 = min(nb, slice * gemv_slice_len(nb, S));
  kb1 = min(nb, kb0 + gemv_slice_len(nb, S));
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

// n - 8 of byte j of v, whose bytes each hold one nibble, exactly: the byte
// under the exponent bits of 2^23 is the float 2^23 + n.
__device__ __forceinline__ float nib(uint32_t v, int j) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650u | j)) - 8388616.0f;
}

// One packed 32-block -> its 32 values (n - 8), in element order: byte j holds
// element j low and j + 16 high.
__device__ __forceinline__ void deq_block(uint4 pk, float* wv) {
  const uint32_t wd[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = wd[i] & 0x0F0F0F0Fu, hi = (wd[i] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wv[4 * i + j] = nib(lo, j);
      wv[16 + 4 * i + j] = nib(hi, j);
    }
  }
}

__device__ __forceinline__ float dot32(const float* a, const float* b) {
  float d = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) d = fmaf(a[e], b[e], d);
  return d;
}

template <typename TX, typename TY, int MT, int R>
__global__ void __launch_bounds__(kGemvWarps * 32)
q4_gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ s, TY* __restrict__ y, int M, int N, int K, int S) {
  __shared__ float red[kGemvWarps][R * MT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kGemvWarps / S, grp = warp / S, slice = warp % S;
  const int nb = K >> 5;
  int kb0, kb1;
  gemv_slice(nb, S, slice, kb0, kb1);
  // The block's warps walk the same items (tile, load group): tiles blockIdx.x,
  // + gridDim.x, ..., each in the load groups of the longest slice, so that
  // the block's barriers line up; a short slice's last groups load nothing.
  const int n_it = (gemv_slice_len(nb, S) + 32 * kGemvSteps - 1) / (32 * kGemvSteps);
  const int tiles = (N + R * groups - 1) / (R * groups);

  const auto load = [&](int tile, int it, uint4 (*qk)[R], float (*qs)[R]) {
    const int n0 = (tile * groups + grp) * R, b0 = kb0 + it * 32 * kGemvSteps + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = min(n0 + r, N - 1);
      const uint4* wr = reinterpret_cast<const uint4*>(w + (size_t)n * (K >> 1));
      const float* sr = s + (size_t)n * nb;
#pragma unroll
      for (int u = 0; u < kGemvSteps; ++u) {
        const bool live = tile < tiles && b0 + 32 * u < kb1;
        qk[u][r] = live ? __ldg(wr + b0 + 32 * u) : make_uint4(0u, 0u, 0u, 0u);
        qs[u][r] = live ? __ldg(sr + b0 + 32 * u) : 0.0f;
      }
    }
  };
  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.0f;

  uint4 pk[kGemvSteps][R];
  float sc[kGemvSteps][R];
  int tile = blockIdx.x, it = 0;
  load(tile, it, pk, sc);
  while (tile < tiles) {
    int next_tile = tile, next_it = it + 1;
    if (next_it == n_it) {
      next_it = 0;
      next_tile += gridDim.x;
    }
    uint4 nk[kGemvSteps][R];
    float ns[kGemvSteps][R];
    load(next_tile, next_it, nk, ns);  // in flight while this group computes
#pragma unroll
    for (int u = 0; u < kGemvSteps; ++u) {
      const int b = kb0 + it * 32 * kGemvSteps + lane + 32 * u;
      if (b >= kb1) break;
      float xv[32], wv[32];
      if constexpr (MT == 1) {
        load_x32(x + (size_t)b * 32, xv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          deq_block(pk[u][r], wv);
          acc[r][0] = fmaf(dot32(xv, wv), sc[u][r], acc[r][0]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          deq_block(pk[u][r], wv);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < M) {
              load_x32(x + (size_t)m * K + (size_t)b * 32, xv);
              acc[r][m] = fmaf(dot32(xv, wv), sc[u][r], acc[r][m]);
            }
          }
        }
      }
    }
    if (next_it == 0) {  // the tile's sums: across the lanes, then the slices in order
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float v = acc[r][m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) red[warp][r * MT + m] = v;
          acc[r][m] = 0.0f;
        }
      __syncthreads();
      if (threadIdx.x < groups * R * MT) {
        const int g = threadIdx.x / (R * MT), q = threadIdx.x % (R * MT);
        const int r = q / MT, m = q % MT;
        float v = 0.0f;
        for (int sl = 0; sl < S; ++sl) v += red[g * S + sl][q];
        const int n = (tile * groups + g) * R + r;
        if (n < N && m < M) y[(size_t)m * N + n] = from_f32<TY>(v);
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kGemvSteps; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pk[u][r] = nk[u][r];
        sc[u][r] = ns[u][r];
      }
    tile = next_tile;
    it = next_it;
  }
}

// ---- bf16 x, 2 <= M <= 16: q4_mma_kernel ---------------------------------

constexpr int kMmaWarps = 8;

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

// ---- bf16 x, M > 16: q4_wgmma_kernel ----------------------------------------
//
// A TN GEMM per (BM tokens x BN weight rows) output tile, K in steps of kBK =
// 64 (one 128-byte row of bf16), through a ring of kStages shared-memory stages:
//   * the producer warp (the block's last) waits for a stage to be free, then
//     one lane starts two TMA loads into it under full[s]: x [BM x 64] bf16
//     (128-byte swizzle, as wgmma reads it) and the packed W bytes [BN x 32];
//   * warpgroup 0 dequantizes the stage's packed bytes into the bf16 W tile
//     [BN x 64], written in the same 128-byte swizzle as TMA writes x (16-byte
//     chunk c of row r at chunk c ^ (r % 8)): dq2 makes the exact bf16 pair (n
//     - 8), which is widened to f32, multiplied by the f32 scale (read from
//     global one step ahead) and rounded once to bf16, so each weight is
//     bf16((n - 8) * s) with the product in f32, as before; then
//     fence.proxy.async (the stores are generic, wgmma reads through the
//     async proxy) and bready[s];
//   * BM / 64 consumer warpgroups each run four wgmma.mma_async
//     m64nBNk16 bf16 -> f32 a stage on their 64 token rows (A = x, B = the W
//     tile, both K-major from shared memory), keep one stage's group in flight
//     and free the stage before it (empty[s], with warpgroup 0's arrival);
//   * the accumulators [64 tokens x BN rows] are y's own row-major layout: the
//     epilogue stores them in the output type, masking tokens >= M, rows >= N.
// x and W past M, N or K arrive as zeros (TMA's out-of-bounds fill) and their
// scales as 0, so every product there is 0 * finite. Each output is one
// block's sum in a fixed order: the result is deterministic.
// On the H100 a deeper ring (up to 8 stages, or a separate ring of W tiles),
// two dequant warpgroups taking turns, suspend-hinted barrier waits and one
// polling lane a warp were each no faster; what holds the route at about 2x
// torch.matmul is measured in PERF.md.

constexpr int kStages = 4;
constexpr int kBK = 64;             // K per stage
constexpr int kRowBytes = kBK * 2;  // one row of an x or W tile in shared memory
constexpr int kDqThreads = 128;     // warpgroup 0

template <int BM, int BN>
struct TileCfg {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = kDqThreads + 128 * kConsumers + 32;  // + the producer warp
  static constexpr int kProducerWarp = (kThreads - 32) / 32;
  static constexpr int kMinBlocks = (BM == 64 && BN == 64) ? 2 : 1;
  static constexpr int kXBytes = BM * kRowBytes;       // x tile, bf16, swizzled
  static constexpr int kBBytes = BN * kRowBytes;       // dequantized W tile, bf16, swizzled
  static constexpr int kPBytes = BN * kBK / 2;         // packed W tile
  // the three rings, then full/bready/empty barriers, plus slack to align to 1024
  static constexpr int kSmem = kStages * (kXBytes + kBBytes + kPBytes) + 3 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The exact bf16 pair (n - 8) times the f32 scale, each product rounded once.
__device__ __forceinline__ uint32_t scale2(uint32_t pair, float f) {
  const float lo = __uint_as_float(pair << 16) * f;
  const float hi = __uint_as_float(pair & 0xFFFF0000u) * f;
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); the tile's base is 1024-aligned, and a
// k16 step within the 64-wide row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x BN] = A[64 x 16] . B[BN x 16]^T (+ d if accumulate), bf16 in, f32 out
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void store2(float* y, size_t i, bool pair, bool second, float a,
                                       float b) {
  if (pair) {
    *reinterpret_cast<float2*>(y + i) = make_float2(a, b);
  } else {
    y[i] = a;
    if (second) y[i + 1] = b;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* y, size_t i, bool pair, bool second,
                                       float a, float b) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(y + i) = __floats2bfloat162_rn(a, b);
  } else {
    y[i] = __float2bfloat16(a);
    if (second) y[i + 1] = __float2bfloat16(b);
  }
}

template <typename TY, int BM, int BN>
__global__ void __launch_bounds__(TileCfg<BM, BN>::kThreads, TileCfg<BM, BN>::kMinBlocks)
q4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, const float* __restrict__ s,
                TY* __restrict__ y, int M, int N, int K) {
  using C = TileCfg<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: tiles start 1024-aligned
  uint8_t* const xs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const bs = xs + kStages * C::kXBytes;
  uint8_t* const pk = bs + kStages * C::kBBytes;
  // full[s]: x and packed W landed; bready[s]: W tile dequantized; empty[s]:
  // the stage's last readers are done
  const uint32_t full0 = smem_u32(pk + kStages * C::kPBytes);
  const uint32_t bready0 = full0 + 8 * kStages, empty0 = bready0 + 8 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nb = K >> 5, n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);  // the TMA lane's expect_tx
      mbar_init(bready0 + 8 * i, kDqThreads / 32);
      mbar_init(empty0 + 8 * i, kDqThreads / 32 + 4 * C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kProducerWarp) {
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages, lap = kt / kStages;
      if (lap > 0) mbar_wait(empty0 + 8 * st, (lap - 1) & 1);
      const uint32_t full = full0 + 8 * st;
      if (lane == 0) {
        mbar_arrive_expect_tx(full, C::kXBytes + C::kPBytes);
        tma_load_2d(smem_u32(xs + st * C::kXBytes), &xmap, kt * kBK, m0, full);
        tma_load_2d(smem_u32(pk + st * C::kPBytes), &wmap, kt * (kBK / 2), n0, full);
      }
    }
  } else if (warp < kDqThreads / 32) {
    // each thread's scales (one per 32-block it dequantizes), read one step
    // ahead: their row stride, 4 K / 32 bytes, is not a multiple of 16 at
    // every K, so they take no TMA
    float f_next[BN / 64];
    const auto load_scales = [&](int kt, float* f) {
#pragma unroll
      for (int i = 0; i < BN / 64; ++i) {
        const int q = threadIdx.x + kDqThreads * i;
        const int gn = n0 + (q >> 1), kb = 2 * kt + (q & 1);
        f[i] = (gn < N && kb < nb) ? __ldg(s + (size_t)gn * nb + kb) : 0.0f;
      }
    };
    load_scales(0, f_next);
    for (int kt = 0; kt < n_k; ++kt) {
      float f_now[BN / 64];
#pragma unroll
      for (int i = 0; i < BN / 64; ++i) f_now[i] = f_next[i];
      if (kt + 1 < n_k) load_scales(kt + 1, f_next);
      const int st = kt % kStages;
      mbar_wait(full0 + 8 * st, (kt / kStages) & 1);
      const uint8_t* const pks = pk + st * C::kPBytes;
      uint8_t* const b = bs + st * C::kBBytes;
#pragma unroll
      for (int i = 0; i < BN / 64; ++i) {
        const int q = threadIdx.x + kDqThreads * i;  // 32-block q % 2 of row q / 2
        const int row = q >> 1, blk = q & 1;
        const uint4 p = *reinterpret_cast<const uint4*>(pks + 16 * q);
        const float f = f_now[i];
        const uint32_t wd[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // chunk c holds block elements 8c..8c+7: the low nibbles of bytes 0-7
          // (c = 0) and 8-15 (c = 1), the high nibbles of the same (c = 2, 3).
          // Byte order (b0, b2, b1, b3) puts elements (e, e+1) where dq2 reads
          // its pair, and (e+2, e+3) eight bits up.
          const int sh = 4 * (c >> 1);
          const uint32_t v0 = __byte_perm(wd[2 * (c & 1)], 0, 0x3120) >> sh;
          const uint32_t v1 = __byte_perm(wd[2 * (c & 1) + 1], 0, 0x3120) >> sh;
          uint4 o;
          o.x = scale2(dq2(v0), f);
          o.y = scale2(dq2(v0 >> 8), f);
          o.z = scale2(dq2(v1), f);
          o.w = scale2(dq2(v1 >> 8), f);
          *reinterpret_cast<uint4*>(b + row * kRowBytes + (((blk * 4 + c) ^ (row & 7)) << 4)) = o;
        }
      }
      // generic stores and reads of the stage, ordered before the async
      // proxy's next use of it (wgmma reads, the next round's TMA writes)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bready0 + 8 * st);
        mbar_arrive(empty0 + 8 * st);
      }
    }
  } else {
    const int cw = warp - kDqThreads / 32;  // consumer warp; warpgroup cw / 4 owns 64 tokens
    // no zero fill: the first product overwrites d (an instruction writing
    // the accumulators would make ptxas serialize the wgmmas)
    float d[BN / 2];
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      const uint32_t ph = (kt / kStages) & 1;
      mbar_wait(full0 + 8 * st, ph);
      mbar_wait(bready0 + 8 * st, ph);
      const uint32_t a = smem_u32(xs + st * C::kXBytes + (cw >> 2) * 64 * kRowBytes);
      const uint32_t bb = smem_u32(bs + st * C::kBBytes);
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_k16(d, sw128_desc(a + 32 * kk), sw128_desc(bb + 32 * kk), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      fence_operands(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_operands(d);
    // d[4j + 2h + e]: token 16 (cw % 4) + lane / 4 + 8h, row 8j + 2 (lane % 4) + e
    const int tok = m0 + 64 * (cw >> 2) + 16 * (cw & 3) + (lane >> 2);
    const bool even_n = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = tok + 8 * h;
        if (m < M)
          store2(y, (size_t)m * N + n, even_n && n + 1 < N, n + 1 < N, d[4 * j + 2 * h],
                 d[4 * j + 2 * h + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled (libcuda) looked up through the CUDA runtime, so the
// library links no -lcuda; the lookup needs CUDA 12.5 or later
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A 2-D map over a row-major [rows, cols] array, box [box_rows, box_cols].
bool encode_2d(CUtensorMap* map, CUtensorMapDataType dt, int elem_bytes, const void* ptr,
               uint64_t rows, uint64_t cols, uint32_t box_rows, uint32_t box_cols,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The packed weights' maps, by (address, N, K, BN): a weight keeps its map
// across calls; a new tensor at a freed one's address and shape gets the same
// map, so an entry never goes stale.
bool weight_map(CUtensorMap* map, const uint8_t* w, int N, int K, int BN) {
  static std::mutex mu;
  static std::map<std::tuple<uintptr_t, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(w), N, K, BN);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K / 2, BN, kBK / 2,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return false;
  cache.emplace(key, *map);
  return true;
}

template <typename TY, int BM, int BN>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* w, const float* s, TY* y, int M,
                         int N, int K, cudaStream_t st) {
  using C = TileCfg<BM, BN>;
  CUtensorMap xmap, wmap;  // x's address changes with every call: its map is made per launch
  if (!encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM, kBK,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !weight_map(&wmap, w, N, K, BN))
    return cudaErrorInvalidValue;
  static uint32_t smem_set = 0;  // devices whose attribute is set (bit per device)
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(smem_set >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        q4_wgmma_kernel<TY, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set |= 1u << dev;
  }
  // token tiles fastest: the blocks that share a weight tile run together
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  q4_wgmma_kernel<TY, BM, BN><<<grid, C::kThreads, C::kSmem, st>>>(xmap, wmap, s, y, M, N, K);
  return cudaGetLastError();
}

// The largest tile that still gives every SM a block; 128 tokens only past 64.
template <typename TY>
cudaError_t launch_tiled(const __nv_bfloat16* x, const uint8_t* w, const float* s, TY* y, int M,
                         int N, int K, cudaStream_t st) {
  const auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  const int sms = sm_count();
  if (M > 64 && blocks(128, 128) >= sms) return launch_wgmma<TY, 128, 128>(x, w, s, y, M, N, K, st);
  if (M > 64 && blocks(128, 64) >= sms) return launch_wgmma<TY, 128, 64>(x, w, s, y, M, N, K, st);
  if (blocks(64, 128) >= sms) return launch_wgmma<TY, 64, 128>(x, w, s, y, M, N, K, st);
  return launch_wgmma<TY, 64, 64>(x, w, s, y, M, N, K, st);
}

// As many blocks as the SMs hold at once, at most one a tile: each block walks
// tiles blockIdx.x, + gridDim.x, ...
template <typename TX, typename TY, int MT, int R>
cudaError_t launch_gemv_tiles(const TX* x, const uint8_t* w, const float* s, TY* y, int M, int N,
                              int K, int S, int tiles, cudaStream_t st) {
  static int per_sm = 0;  // blocks an SM holds, from the kernel's registers
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, q4_gemv_kernel<TX, TY, MT, R>, kGemvWarps * 32, 0);
    if (e != cudaSuccess) return e;
    per_sm = max(per_sm, 1);
  }
  const int grid = min(tiles, per_sm * sm_count());
  q4_gemv_kernel<TX, TY, MT, R><<<grid, kGemvWarps * 32, 0, st>>>(x, w, s, y, M, N, K, S);
  return cudaGetLastError();
}

// The GEMV with the plan's rows a warp (R) and slices a row (S).
template <typename TX, typename TY>
cudaError_t launch_gemv(const TX* x, const uint8_t* w, const float* s, TY* y, int M, int N,
                        int K, int rows, int S, cudaStream_t st) {
  if (S < 1 || S > kGemvWarps || kGemvWarps % S) return cudaErrorInvalidValue;
  const int tiles = (N + rows * (kGemvWarps / S) - 1) / (rows * (kGemvWarps / S));
  if (M == 1) {
    if (rows == 4) return launch_gemv_tiles<TX, TY, 1, 4>(x, w, s, y, M, N, K, S, tiles, st);
    if (rows == 2) return launch_gemv_tiles<TX, TY, 1, 2>(x, w, s, y, M, N, K, S, tiles, st);
    if (rows == 1) return launch_gemv_tiles<TX, TY, 1, 1>(x, w, s, y, M, N, K, S, tiles, st);
    return cudaErrorInvalidValue;
  } else if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    return cudaErrorInvalidValue;  // bf16 x at M = 2-16 takes the mma route
  } else {
    if (rows != 1) return cudaErrorInvalidValue;
    if (M <= 2) return launch_gemv_tiles<TX, TY, 2, 1>(x, w, s, y, M, N, K, S, tiles, st);
    if (M <= 4) return launch_gemv_tiles<TX, TY, 4, 1>(x, w, s, y, M, N, K, S, tiles, st);
    if (M <= 8) return launch_gemv_tiles<TX, TY, 8, 1>(x, w, s, y, M, N, K, S, tiles, st);
    return launch_gemv_tiles<TX, TY, 16, 1>(x, w, s, y, M, N, K, S, tiles, st);
  }
}

template <typename TX, typename TY>
cudaError_t launch(const void* xv, const uint8_t* w, const float* s, void* yv, int M, int N,
                   int K, int rows, int slices, cudaStream_t st) {
  const TX* x = static_cast<const TX*>(xv);
  TY* y = static_cast<TY*>(yv);
  constexpr bool bf16 = std::is_same<TX, __nv_bfloat16>::value;
  if (M == 1 || (!bf16 && M <= 16))
    return launch_gemv<TX, TY>(x, w, s, y, M, N, K, rows, slices, st);
  if constexpr (bf16) {
    if (M <= 8) launch_mma<TY, 1>(x, w, s, y, M, N, K, st);
    else if (M <= 16) launch_mma<TY, 2>(x, w, s, y, M, N, K, st);
    else return launch_tiled<TY>(x, w, s, y, M, N, K, st);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // the wrapper casts f32 x to bf16 past M = 16
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1 (cudaErrorInvalidValue)
// for arguments the kernel does not take (f32 x at M > 16 among them). rows
// and slices are the GEMV routes' plan (q4_matmul.py:gemv_plan): weight rows a
// warp and slices of K a row; the other routes ignore them.
extern "C" int q4_matmul(const void* x, int x_dtype, const void* w, const void* scales,
                         void* y, int y_dtype, int M, int N, int K, int rows, int slices,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (K & 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  if (x_dtype == kBF16 && y_dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(x, wp, sp, y, M, N, K, rows,
                                                                 slices, st));
  if (x_dtype == kBF16 && y_dtype == kF32)
    return static_cast<int>(launch<__nv_bfloat16, float>(x, wp, sp, y, M, N, K, rows, slices, st));
  if (x_dtype == kF32 && y_dtype == kBF16)
    return static_cast<int>(launch<float, __nv_bfloat16>(x, wp, sp, y, M, N, K, rows, slices, st));
  if (x_dtype == kF32 && y_dtype == kF32)
    return static_cast<int>(launch<float, float>(x, wp, sp, y, M, N, K, rows, slices, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
