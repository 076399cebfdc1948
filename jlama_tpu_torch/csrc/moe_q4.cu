// K6: the grouped expert q4 matmul for Hopper (sm_90a).
//
// Replaces two pieces of JAX code, neither a Pallas kernel of its own:
//   * the per-selection linear(xi, w[e]) calls of jlama_tpu/nn/layers.py:
//     _moe_gathered (taken at B*T*K <= 8), which index one expert's QArray
//     slice per (token, k) selection;
//   * QArray.dequantize(bf16) plus jax.lax.ragged_dot in _moe_ragged (taken
//     above that), which sorts the selections by expert and runs grouped
//     matmuls.
// Computes y[r] = x[order-free row of r] . deq(W[e[r]])^T for R selections r,
// where W is one stacked expert projection in the checkpoint's JQ4 layout:
//   packed uint8 [E, N, K/2] (byte j of a 32-block holds element j in the low
//   nibble and element j + 16 in the high nibble, value (nibble - 8) * scale),
//   scales float32 [E, N, K/32], one expert's matrix every N * K/2 bytes.
// x is bf16 [R / x_div, K]: selection r reads row r / x_div (x_div = top-k for
// gate and up, whose input is one row a token; 1 for down, whose input is one
// row a selection), so the repeat of x by k is never materialised. y is
// [R, N] in selection order (no unsort pass), bf16 or f32.
//
// Two launches a call site:
//   moe_group_kernel (once a layer, shared by its three projections): one block
//     turns the expert ids e [R] into a stable order by expert, order [R],
//     and per-expert offsets [E + 1] (rows offsets[x] .. offsets[x + 1] - 1 of
//     the order are expert x's, in selection order). Counts by shared-memory
//     atomics, then each chunk of rows ranks itself by a scan of the chunk's
//     ids: deterministic, no host sync, so a decode step stays capturable.
//   moe_q4_mma_kernel: a static grid (tiles of 32 weight rows) x E x
//     ceil(R / TM) row tiles of TM = 8, 16 or 32 selections (by R), so the
//     launch shape depends on R only. A block reads its expert's offsets and
//     exits at once when its row tile lies past the expert's row count: an
//     expert no selection chose costs its blocks' exits and none of its bytes.
//
// What bounds it on the H100: at decode (R <= 32, one row tile an expert),
// the touched experts' weight bytes, 0.625 bytes a weight (4-bit payload + f32
// block scale) against 3.35 TB/s: 21.9 us for a Mixtral-8x7B projection at R =
// 2 with two distinct experts (73.4 MB). At prefill (R in the thousands) the
// tensor cores (120 GFLOP a projection at R = 1024, 121.6 us at 989 TFLOP/s).
// The design is K1's decode route (csrc/q4_matmul.cu, q4_mma_kernel) with
// the expert and the rows taken through the order: bf16 mma.sync m16n8k16, A
// the dequantized weights (16 rows x k16), B the activations (k16 x 8
// selections), the nibbles dequantized to exact bf16 (n - 8) in registers,
// each 32-block's f32 partial multiplied by its f32 scale (fmaf), the 8
// warps' partials summed in shared memory in warp order. Numerics are K1's:
// each product x * (n - 8) exact in f32, f32 sums (in another order than the
// plain version's f32 matmul of the dequantized weights), the scale never
// rounded. A prefill reads each expert's weights once a row tile (TM = 32):
// no TMA ring and no wgmma yet (ROADMAP: K6's Hopper redesign).
// Ids must lie in [0, E): a selection with another id is in no group and its
// y row is not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- the grouping pre-pass -------------------------------------------------

constexpr int kGroupThreads = 256;

// One block. Shared memory: next[E] (the next free slot of each expert's run
// in the order) and ids[kGroupThreads] (the current chunk's ids).
__global__ void __launch_bounds__(kGroupThreads)
moe_group_kernel(const int* __restrict__ e, int R, int E, int* __restrict__ order,
                 int* __restrict__ offsets) {
  extern __shared__ int smem[];
  int* next = smem;
  int* ids = smem + E;
  for (int i = threadIdx.x; i < E; i += blockDim.x) next[i] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int x = e[r];
    if (x >= 0 && x < E) atomicAdd(&next[x], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // E is small (8 for Mixtral): a serial prefix sum
    int sum = 0;
    for (int i = 0; i < E; ++i) {
      const int c = next[i];
      offsets[i] = sum;
      next[i] = sum;
      sum += c;
    }
    offsets[E] = sum;
  }
  __syncthreads();
  for (int base = 0; base < R; base += blockDim.x) {
    const int r = base + threadIdx.x;
    const int x = r < R ? e[r] : -1;
    ids[threadIdx.x] = x;
    __syncthreads();
    if (x >= 0 && x < E) {
      int rank = 0;  // earlier rows of this chunk on the same expert
      for (int j = 0; j < threadIdx.x; ++j) rank += ids[j] == x;
      order[next[x] + rank] = r;
    }
    __syncthreads();
    const int n = min((int)blockDim.x, R - base);
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      int c = 0;
      for (int j = 0; j < n; ++j) c += ids[j] == i;
      next[i] += c;
    }
    __syncthreads();
  }
}

// ---- the grouped matmul ----------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRT = 2;  // 16-row weight tiles a block: 32 weight rows

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
// n_hi - 8), exactly: the OR makes 128 + n, the subtraction of 136 is exact.
__device__ __forceinline__ uint32_t dq2(uint32_t v) {
  uint32_t r = (v & 0x000F000Fu) | 0x43004300u, k = kBf16x2_136;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<__nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Block (blockIdx.x, expert blockIdx.y, row tile blockIdx.z): weight rows
// 32 * blockIdx.x .. + 31 of the expert, its selections
// offsets[ex] + TM * blockIdx.z .. + TM - 1 of the order (TM = 8 * NT).
// Fragments as in K1's q4_mma_kernel (lane = 4 * gid + t): the k slots (2t,
// 2t+1, 2t+8, 2t+9) of one k16 step s stand for block elements (16s + 4t,
// +2, +1, +3), so a thread's weights of one 32-block are the 32-bit word t
// of the row's 16 bytes, as JQ4 stores them; low nibbles feed step 0, high
// nibbles step 1; B from the 8 bytes x[row][32b + 16s + 4t .. +3]; C rows
// gid, gid + 8, selections 8j + 2t, +1. Weight rows at or past N read row
// N - 1 and selections past the tile's count read its last one (valid memory,
// no divergence); their outputs are never stored.
template <typename TY, int NT>
__global__ void __launch_bounds__(kWarps * 32, 2)
moe_q4_mma_kernel(const __nv_bfloat16* __restrict__ x, int x_div, const uint8_t* __restrict__ w,
                  const float* __restrict__ s, const int* __restrict__ order,
                  const int* __restrict__ offsets, TY* __restrict__ y, int N, int K) {
  constexpr int kFrags = kRT * NT * 4;  // f32 accumulators a thread
  __shared__ float red[kWarps][kFrags][32];

  const int ex = blockIdx.y;
  const int g1 = offsets[ex + 1];
  const int t0 = offsets[ex] + blockIdx.z * (NT * 8);
  if (t0 >= g1) return;  // past the expert's rows (an untouched expert: all its blocks)
  const int M = min(NT * 8, g1 - t0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * (kRT * 16);
  const int nb = K >> 5;
  w += (size_t)ex * N * (K >> 1);
  s += (size_t)ex * N * nb;

  const uint32_t* wr[kRT][2];  // word tig of block 0 of each of the thread's rows
  const float* sr[kRT][2];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = min(n0 + 16 * i + 8 * h + gid, N - 1);
      wr[i][h] = reinterpret_cast<const uint32_t*>(w + (size_t)n * (K >> 1)) + tig;
      sr[i][h] = s + (size_t)n * nb;
    }
  const __nv_bfloat16* xr[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int r = order[t0 + min(8 * j + gid, M - 1)];
    xr[j] = x + (size_t)(r / x_div) * K + 4 * tig;
  }

  float acc[kRT][NT][4];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};

#pragma unroll 2
  for (int b = warp; b < nb; b += kWarps) {
    uint32_t wv[kRT][2];
    float sc[kRT][2];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
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
    for (int i = 0; i < kRT; ++i) {
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
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[warp][(i * NT + j) * 4 + q][lane] = acc[i][j][q];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kFrags * 32; idx += kWarps * 32) {
    const int f = idx >> 5, l = idx & 31;
    float v = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) v += red[wp][f][l];
    const int q = f & 3, j = (f >> 2) % NT, i = (f >> 2) / NT;
    const int row = n0 + 16 * i + (l >> 2) + 8 * (q >> 1);
    const int tok = 8 * j + 2 * (l & 3) + (q & 1);
    if (row < N && tok < M) y[(size_t)order[t0 + tok] * N + row] = from_f32<TY>(v);
  }
}

template <typename TY>
cudaError_t launch(const __nv_bfloat16* x, int x_div, const uint8_t* w, const float* s,
                   const int* order, const int* offsets, TY* y, int R, int E, int N, int K,
                   int tm, cudaStream_t st) {
  const dim3 block(kWarps * 32);
  const dim3 grid((N + kRT * 16 - 1) / (kRT * 16), E, (R + tm - 1) / tm);
  if (grid.z > 65535 || grid.y > 65535) return cudaErrorInvalidValue;
  if (tm == 8)
    moe_q4_mma_kernel<TY, 1><<<grid, block, 0, st>>>(x, x_div, w, s, order, offsets, y, N, K);
  else if (tm == 16)
    moe_q4_mma_kernel<TY, 2><<<grid, block, 0, st>>>(x, x_div, w, s, order, offsets, y, N, K);
  else if (tm == 32)
    moe_q4_mma_kernel<TY, 4><<<grid, block, 0, st>>>(x, x_div, w, s, order, offsets, y, N, K);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// The grouping pre-pass: order [R] and offsets [E + 1], int32 on the device.
extern "C" int moe_group(const void* e, int R, int E, void* order, void* offsets, void* stream) {
  if (R < 0 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(E + kGroupThreads) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  moe_group_kernel<<<1, kGroupThreads, smem, st>>>(static_cast<const int*>(e), R, E,
                                                  static_cast<int*>(order),
                                                  static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// y [R, N] (y_dtype) = x [R / x_div, K] (bf16) through each selection's expert,
// with the groups of moe_group; tm: selections a row tile (8, 16 or 32).
// Returns the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for
// arguments the kernel does not take.
extern "C" int moe_q4_matmul(const void* x, int x_div, const void* w, const void* scales,
                             const void* order, const void* offsets, void* y, int y_dtype,
                             int R, int E, int N, int K, int tm, void* stream) {
  if (R <= 0 || E <= 0 || N <= 0 || K <= 0 || (K & 31) || x_div <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  const int* op = static_cast<const int*>(order);
  const int* fp = static_cast<const int*>(offsets);
  if (y_dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(xp, x_div, wp, sp, op, fp,
                                                  static_cast<__nv_bfloat16*>(y), R, E, N, K,
                                                  tm, st));
  if (y_dtype == kF32)
    return static_cast<int>(launch<float>(xp, x_div, wp, sp, op, fp, static_cast<float*>(y), R,
                                          E, N, K, tm, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
