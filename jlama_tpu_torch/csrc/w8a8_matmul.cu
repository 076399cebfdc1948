// K5: W4A8 matmul for Hopper (sm_90a): int8 activations x q4s weights.
//
// Replaces jlama_tpu/ops/pallas_w8a8.py:_w8a8_kernel (launched by
// q4s_matmul_2d, with the activation quantization of its :266). Computes
//   y[M,N] = sum_g (d_g[m,n] * xs[m,g]) * swk[n,g],   f32, g in [0, K/256),
//   d_g[m,n] = sum_{c in group g} xq[m,c] * (value[n,c] * sigma[n,c/32]),
// where (xq, xs) = q8_quantize(x, 256) (int8 per 256-group, amax/127) is
// computed inside this launch, and the weights are the port's q4s layout
// (ops/w8a8.py): packed uint8 [N, K/2], each (row, group) of 128 bytes stored
// as [quad t][block b][byte i] of JQ4 half-block bytes (low nibble element
// j, high nibble element j+16 of byte j = 4t+i), nibble = value + 8 in
// [1, 15]; sigma uint8 [N, K/32] in [1, 16]; swk float32 [N, K/256].
//
// The signed form. Each weight is built as the s8 value (nibble - 8) * sigma,
// in [-112, 112] since q4s never stores nibble 0: nibble * sigma <= 240 fits a
// byte, so one 32-bit multiply scales four nibbles, and a per-byte
// subtraction of 8 * sigma modulo 256 (no borrow between bytes) leaves each
// byte the two's complement s8 of (nibble - 8) * sigma. With that no +8
// offset correction is needed: the int32 group sum d_g equals the TPU
// kernel's offset form d - 8 * corr (:216-231) exactly, both being exact
// integers below 2^24 (|d_g| <= 256 * 127 * 112).
//
// The activation quantization equals quant/blockq.py::q8_quantize exactly:
// iscale = 127 / amax and scale = amax / 127, each one correctly rounded
// division, q = floor(x * iscale + 0.5) with the multiply and the
// add rounded separately (no FMA contraction), clip to +-127, scale 0 for an
// all-zero group. An input that quantizes losslessly, with power-of-two group
// scales on both sides, makes every product and sum exact, so the output
// equals the plain version's bit for bit only if every code and scale does.
//
// What bounds it on the H100: in decode (M <= 16) the weight stream, 4.375
// bits per weight against 3.35 TB/s (the x rows are a few KB and stay in
// L1/L2); in prefill (M in the hundreds or thousands) the int8 tensor cores
// (1,979 TOP/s dense).
//
// Design: int8 tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32). One
// k32 step is exactly one 32-block, so the B fragment of a thread (column n,
// k rows 4t..4t+3 and 16+4t..16+4t+3) is the low and high nibbles of one
// 4-byte word of the block, all under one sigma; the layout puts a thread's
// words of the group's 8 blocks in 32 contiguous bytes (two 16-byte loads).
// The x tile of a group is quantized into shared memory (int8 rows padded to
// 272 bytes, so the A fragment loads are free of bank conflicts) by the block
// that reads it: each block redoes this for the x rows it needs, a few KB per
// group, so that the whole linear is one launch. After each group the int32
// fragment is scaled by xs and swk into f32 registers.
//   decode  (M <= 16) - w8a8_decode_kernel: a block of 8 warps owns 8 * NF
//           output columns (NF = 2 or 4 n8 fragments), and its warps split
//           the groups (warp w takes g = w, w + 8, ...), each quantizing its
//           own groups' x tile (16 rows, rows >= M zero); the 8 warps' f32
//           partials are summed in warp order at the end. Many blocks stream
//           the weights at small N.
//   prefill (M > 16)  - w8a8_prefill_kernel: 64 x 64 output tile per block of
//           8 warps (2 along M x 4 along N, each 2 m16 x 2 n8 fragments),
//           looping over the groups in order with a block-wide quantized x
//           tile per group. Its f32 sums run over g in order, as the plain
//           version's do; the decode kernel's order is (per warp, in order)
//           then over warps.
// No cp.async/TMA pipelining and no wgmma yet: a later PR's work. Ragged M
// and N edges are masked; K must be a multiple of 256; x and y are row-major
// contiguous; x is bf16 or f32, y is bf16 or f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kGroup = 256;             // activation group and swk group
constexpr int kBlocksPerGroup = 8;      // 32-blocks (sigma) per group
constexpr int kRowBytes = kGroup + 16;  // padded int8 row of a quantized x tile

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive x values (16-byte aligned) as f32.
__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load_x8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One warp quantizes one 256-group of an x row: lane l holds values 8l..8l+7
// in `v` and stores their int8 codes, 8 bytes, at `dst` (the lane's own
// slot). Returns the group's scale (every lane).
__device__ __forceinline__ float quantize8(const float* v, uint2* dst) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float iscale = amax > 0.0f ? __fdiv_rn(127.0f, amax) : 0.0f;
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float q = floorf(__fadd_rn(__fmul_rn(v[i], iscale), 0.5f));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    w[i >> 2] |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * (i & 3));
  }
  *dst = make_uint2(w[0], w[1]);
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 0.0f;
}

// Rows r0 + i * rstep (i < R) of a quantized x tile from x rows m0 + r0 +
// i * rstep, group g; rows at or past M become zeros with scale 0. The R
// rows' loads are issued together, so a warp waits for memory once per R
// rows.
template <int R, typename TX>
__device__ __forceinline__ void quantize_rows(const TX* __restrict__ x, int M, int K, int g,
                                              int lane, int r0, int rstep, int m0,
                                              int8_t* tile, float* xs) {
  float v[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + r0 + i * rstep;
    if (m < M) load_x8(x + (size_t)m * K + g * kGroup + lane * 8, v[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * rstep;
    uint2* dst = reinterpret_cast<uint2*>(tile + r * kRowBytes + lane * 8);
    float sc = 0.0f;
    if (m0 + r < M) sc = quantize8(v[i], dst);
    else *dst = make_uint2(0u, 0u);
    if (lane == 0) xs[r] = sc;
  }
}

// (nibble - 8) * sigma for the four nibbles of `nib4` (one per byte, each in
// [0, 15]) as four s8 bytes: nibble * sigma <= 240 leaves no carry between
// bytes, and the SWAR subtraction a - b computes each byte modulo 256 without
// borrows between bytes.
__device__ __forceinline__ uint32_t signed_weights(uint32_t nib4, uint32_t sigma) {
  const uint32_t a = nib4 * sigma;
  const uint32_t b = (8u * sigma) * 0x01010101u;
  return ((a | 0x80808080u) - (b & 0x7F7F7F7Fu)) ^ ((a ^ ~b) & 0x80808080u);
}

// c[0..3] += A (16x32 s8, row) . B (32x8 s8, col), int32.
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A fragment of rows r0..r0+15 of a quantized x tile for k32 step b:
// a0/a1 rows gid/gid+8 at bytes 4t..4t+3, a2/a3 the same rows at 16+4t.
__device__ __forceinline__ void load_a(const int8_t* tile, int r0, int b, int gid, int tig,
                                       uint32_t* a) {
  const int8_t* p = tile + (r0 + gid) * kRowBytes + b * 32 + tig * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes + 16);
}

// One n8 fragment's weights for one group: the thread's B column n (its
// 32 bytes of the group, 8 sigmas) and the swk of its two C columns.
struct WFrag {
  uint4 w[2];
  uint2 s;
  float sw[2];
};

__device__ __forceinline__ void load_w(const uint8_t* __restrict__ w,
                                       const uint8_t* __restrict__ sg,
                                       const float* __restrict__ sw, int nb, int gid, int tig,
                                       int g, int N, int K, WFrag& f) {
  const int n = nb + gid;
  if (n < N) {
    const uint4* p = reinterpret_cast<const uint4*>(w + (size_t)n * (K >> 1) + g * 128 + tig * 32);
    f.w[0] = __ldg(p);
    f.w[1] = __ldg(p + 1);
    f.s = __ldg(reinterpret_cast<const uint2*>(sg + (size_t)n * (K >> 5) + g * kBlocksPerGroup));
  } else {
    f.w[0] = f.w[1] = make_uint4(0u, 0u, 0u, 0u);
    f.s = make_uint2(0u, 0u);
  }
  const int G = K / kGroup;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int nc = nb + tig * 2 + c;
    f.sw[c] = nc < N ? __ldg(sw + (size_t)nc * G + g) : 0.0f;
  }
}

// The B fragment of k32 step b (block b of the group).
__device__ __forceinline__ void build_b(const WFrag& f, int b, uint32_t* bb) {
  const uint32_t word = reinterpret_cast<const uint32_t*>(f.w)[b];
  const uint32_t sig = ((b < 4 ? f.s.x : f.s.y) >> (8 * (b & 3))) & 0xFFu;
  bb[0] = signed_weights(word & 0x0F0F0F0Fu, sig);
  bb[1] = signed_weights((word >> 4) & 0x0F0F0F0Fu, sig);
}

// acc += (d * xs[row]) * swk[col], each product and the sum rounded apart.
__device__ __forceinline__ void scale_add(float* acc, const int* c, float xs0, float xs1,
                                          const float* sw) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(__fmul_rn(static_cast<float>(c[0]), xs0), sw[0]));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn(static_cast<float>(c[1]), xs0), sw[1]));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(static_cast<float>(c[2]), xs1), sw[0]));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(__fmul_rn(static_cast<float>(c[3]), xs1), sw[1]));
}

constexpr int kDecWarps = 8;

template <typename TX, typename TY, int NF>
__global__ void __launch_bounds__(kDecWarps * 32)
w8a8_decode_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w,
                   const uint8_t* __restrict__ sg, const float* __restrict__ sw,
                   TY* __restrict__ y, int M, int N, int K) {
  // per warp: a 16-row quantized x tile; reused for the partial sums at the end
  __shared__ __align__(16) int8_t tiles[kDecWarps][16 * kRowBytes];
  __shared__ float xs[kDecWarps][16];
  static_assert(kDecWarps * NF * 4 * 32 * sizeof(float) <= sizeof(tiles), "reduction space");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * (NF * 8);
  const int G = K / kGroup;
  int8_t* tile = tiles[warp];
  for (int r = M; r < 16; ++r)  // rows past M stay zero
    *reinterpret_cast<uint2*>(tile + r * kRowBytes + lane * 8) = make_uint2(0u, 0u);
  if (lane < 16 && lane >= M) xs[warp][lane] = 0.0f;

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int g = warp; g < G; g += kDecWarps) {
    WFrag f[NF];  // issued first: their latency overlaps the quantization
#pragma unroll
    for (int j = 0; j < NF; ++j) load_w(w, sg, sw, n0 + j * 8, gid, tig, g, N, K, f[j]);
    __syncwarp();  // the previous group's A loads are done
    for (int r0 = 0; r0 < M; r0 += 4) quantize_rows<4>(x, M, K, g, lane, r0, 1, 0, tile, xs[warp]);
    __syncwarp();
    int c[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0;
#pragma unroll
    for (int b = 0; b < kBlocksPerGroup; ++b) {
      uint32_t a[4];
      load_a(tile, 0, b, gid, tig, a);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        uint32_t bb[2];
        build_b(f[j], b, bb);
        mma_s8(c[j], a[0], a[1], a[2], a[3], bb[0], bb[1]);
      }
    }
    const float xs0 = xs[warp][gid], xs1 = xs[warp][gid + 8];
#pragma unroll
    for (int j = 0; j < NF; ++j) scale_add(acc[j], c[j], xs0, xs1, f[j].sw);
  }

  __syncthreads();  // every warp is done with its tile: reuse the space
  float* red = reinterpret_cast<float*>(&tiles[0][0]);  // [warp][NF * 4][32 lanes]
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[((warp * NF + j) * 4 + e) * 32 + lane] = acc[j][e];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < kDecWarps; ++v) s += red[((v * NF + j) * 4 + e) * 32 + lane];
      const int row = gid + (e >> 1) * 8;
      const int col = n0 + j * 8 + tig * 2 + (e & 1);
      if (row < M && col < N) y[(size_t)row * N + col] = from_f32<TY>(s);
    }
  }
}

constexpr int kPfWarpsM = 2, kPfWarpsN = 4;  // warps along M and N
constexpr int kPfMF = 2, kPfNF = 2;          // m16 and n8 fragments per warp
constexpr int kPfBM = kPfWarpsM * kPfMF * 16;  // 64
constexpr int kPfBN = kPfWarpsN * kPfNF * 8;   // 64
constexpr int kPfThreads = kPfWarpsM * kPfWarpsN * 32;

template <typename TX, typename TY>
__global__ void __launch_bounds__(kPfThreads)
w8a8_prefill_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w,
                    const uint8_t* __restrict__ sg, const float* __restrict__ sw,
                    TY* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) int8_t tile[kPfBM * kRowBytes];
  __shared__ float xs[kPfBM];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / kPfWarpsN, wn = warp % kPfWarpsN;
  const int m0 = blockIdx.y * kPfBM;
  const int nw = blockIdx.x * kPfBN + wn * kPfNF * 8;
  const int G = K / kGroup;

  float acc[kPfMF][kPfNF][4];
#pragma unroll
  for (int i = 0; i < kPfMF; ++i)
#pragma unroll
    for (int j = 0; j < kPfNF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int g = 0; g < G; ++g) {
    WFrag f[kPfNF];
#pragma unroll
    for (int j = 0; j < kPfNF; ++j) load_w(w, sg, sw, nw + j * 8, gid, tig, g, N, K, f[j]);
    __syncthreads();  // the previous group's A loads are done
    // warp w quantizes tile rows w, w + 8, ..., w + 56, four at a time
    constexpr int kWarps = kPfThreads / 32;
#pragma unroll
    for (int r0 = 0; r0 < kPfBM; r0 += 4 * kWarps)
      quantize_rows<4>(x, M, K, g, lane, r0 + warp, kWarps, m0, tile, xs);
    __syncthreads();
    int c[kPfMF][kPfNF][4];
#pragma unroll
    for (int i = 0; i < kPfMF; ++i)
#pragma unroll
      for (int j = 0; j < kPfNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0;
#pragma unroll
    for (int b = 0; b < kBlocksPerGroup; ++b) {
      uint32_t bb[kPfNF][2];
#pragma unroll
      for (int j = 0; j < kPfNF; ++j) build_b(f[j], b, bb[j]);
#pragma unroll
      for (int i = 0; i < kPfMF; ++i) {
        uint32_t a[4];
        load_a(tile, wm * kPfMF * 16 + i * 16, b, gid, tig, a);
#pragma unroll
        for (int j = 0; j < kPfNF; ++j) mma_s8(c[i][j], a[0], a[1], a[2], a[3], bb[j][0], bb[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPfMF; ++i) {
      const int r = wm * kPfMF * 16 + i * 16 + gid;
      const float xs0 = xs[r], xs1 = xs[r + 8];
#pragma unroll
      for (int j = 0; j < kPfNF; ++j) scale_add(acc[i][j], c[i][j], xs0, xs1, f[j].sw);
    }
  }

#pragma unroll
  for (int i = 0; i < kPfMF; ++i) {
#pragma unroll
    for (int j = 0; j < kPfNF; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * kPfMF * 16 + i * 16 + gid + (e >> 1) * 8;
        const int col = nw + j * 8 + tig * 2 + (e & 1);
        if (row < M && col < N) y[(size_t)row * N + col] = from_f32<TY>(acc[i][j][e]);
      }
    }
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

template <typename TX, typename TY>
void launch(const void* x, const uint8_t* w, const uint8_t* sg, const float* sw, void* y,
            int M, int N, int K, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  TY* yp = static_cast<TY*>(y);
  if (M <= 16) {
    // 4 fragments a block once that still gives two blocks per SM, else 2
    if ((N + 31) / 32 >= 2 * sm_count())
      w8a8_decode_kernel<TX, TY, 4><<<(N + 31) / 32, kDecWarps * 32, 0, st>>>(xp, w, sg, sw, yp, M, N, K);
    else
      w8a8_decode_kernel<TX, TY, 2><<<(N + 15) / 16, kDecWarps * 32, 0, st>>>(xp, w, sg, sw, yp, M, N, K);
  } else {
    dim3 grid((N + kPfBN - 1) / kPfBN, (M + kPfBM - 1) / kPfBM);
    w8a8_prefill_kernel<TX, TY><<<grid, kPfThreads, 0, st>>>(xp, w, sg, sw, yp, M, N, K);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1 (cudaErrorInvalidValue)
// for arguments the kernel does not take.
extern "C" int w8a8_matmul(const void* x, int x_dtype, const void* w, const void* sigma,
                           const void* swk, void* y, int y_dtype, int M, int N, int K,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kGroup) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const uint8_t* sp = static_cast<const uint8_t*>(sigma);
  const float* swp = static_cast<const float*>(swk);
  if (x_dtype == kBF16 && y_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, wp, sp, swp, y, M, N, K, st);
  else if (x_dtype == kBF16 && y_dtype == kF32)
    launch<__nv_bfloat16, float>(x, wp, sp, swp, y, M, N, K, st);
  else if (x_dtype == kF32 && y_dtype == kBF16)
    launch<float, __nv_bfloat16>(x, wp, sp, swp, y, M, N, K, st);
  else if (x_dtype == kF32 && y_dtype == kF32)
    launch<float, float>(x, wp, sp, swp, y, M, N, K, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
