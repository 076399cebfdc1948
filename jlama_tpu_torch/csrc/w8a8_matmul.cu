// K5: W4A8 matmul for Hopper (sm_90a): int8 activations x q4s weights.
//
// Replaces jlama_tpu/ops/pallas_w8a8.py:_w8a8_kernel (launched by
// q4s_matmul_2d, with the activation quantization of its :266). Computes
//   y[M,N] = sum_g (d_g[m,n] * xs[m,g]) * swk[n,g],   f32, g in [0, K/256) in order,
//   d_g[m,n] = sum_{c in group g} xq[m,c] * (value[n,c] * sigma[n,c/32]),
// where (xq, xs) = q8_quantize(x, 256) (int8 per 256-group, amax/127), and
// the weights are the port's q4s layout (ops/w8a8.py): packed uint8 [N, K/2],
// each (row, group) of 128 bytes stored as [quad t][block b][byte i] of JQ4
// half-block bytes (low nibble element j, high nibble element j+16 of byte j
// = 4t+i), nibble = value + 8 in [1, 15]; sigma uint8 [N, K/32] in [1, 16];
// swk float32 [N, K/256].
//
// The signed form. Each weight is built as the s8 value (nibble - 8) * sigma,
// in [-112, 112] since q4s never stores nibble 0: nibble * sigma <= 240 fits a
// byte, so one 32-bit multiply scales four nibbles, and a per-byte
// subtraction of 8 * sigma modulo 256 (no borrow between bytes) leaves each
// byte the two's complement s8 of (nibble - 8) * sigma. With that no +8
// offset correction is needed: the int32 group sum d_g equals the TPU
// kernel's offset form d - 8 * corr (:216-231) exactly, both being exact
// integers: |d_g| <= 256 * 127 * 128 < 2^22, a nibble 0 (-128) included.
//
// The activation quantization equals quant/blockq.py::q8_quantize exactly:
// iscale = 127 / amax and scale = amax / 127, each one correctly rounded
// division, q = floor(x * iscale + 0.5) with the multiply and the add rounded
// separately (no FMA contraction), clip to +-127, scale 0 for an all-zero
// group, from x as given (f32 x is never rounded to bf16 first). Each group's
// (d_g * xs) * swk and its sum into the f32 accumulator are rounded once each,
// in g order, as the plain version's are, so both routes equal
// q4s_matmul_plain bit for bit on any input.
//
// What bounds it on the H100: in decode (M <= 16) the weight stream, 4.375
// bits per weight against 3.35 TB/s (the x rows are a few KB and stay in
// L1/L2); in prefill (M in the hundreds or thousands) the int8 tensor cores
// (1,979 TOP/s dense).
//
// Routes:
//   decode  (M <= 16) - two launches, one wrapper call (one at M <= 2):
//     w8a8_quantize_kernel<TX, true>: x once into xq (each group's codes as
//           the decode kernel's B fragment tile, frag_offset) and xs f32
//           [K/256, Mp], so no block quantizes x again;
//     w8a8_decode_kernel<TY, T, J, W>: launched with programmatic dependent
//           launch, so its blocks issue their first weight loads and scale
//           loads while the pre-pass runs and wait for it (griddepcontrol.wait)
//           only before copying its codes. A block owns 16 T weight rows (T =
//           2 once that gives every SM a block, else 1); its W warps (8; 16
//           at T = 1 with more than 8 groups and at most a block an SM) split
//           the 256-groups in rounds
//           (warp w takes g = W r + w). Each warp streams its groups' [16 T
//           rows x 128 bytes] weight boxes by TMA (the prefill route's map,
//           128-byte swizzle) into its own ring of stages under mbarriers,
//           issued a ring ahead, and its groups' code tiles and scales by
//           bulk copies into its own buffer, one group ahead. The weights are
//           mma.sync.m16n8k32 s8's A operand from registers (rows gid and gid
//           + 8, k 4 tig.. and 16 + 4 tig..: the low and high nibbles of word
//           tig of each 32-block, expand_lo/hi); the tokens are its n8 side,
//           so M <= 8 takes one product per row tile and k32 step (J = 1),
//           M <= 16 two (J = 2), where x on the M side would always take 16
//           rows. Each group's f32 products (float(d) * xs) * swk go to
//           shared memory; after each round the block sums them into its
//           accumulators in group order, so the result is the plain
//           version's. sigma and swk are read from global (rows of 24 and 12
//           bytes at K = 768, which TMA cannot map), a round ahead. At M <=
//           kInlineMaxM (2, the faster side of a timed comparison at M = 1,
//           2, 4, 8 and 16 on the H100) each warp quantizes its group's rows
//           of x itself instead: one launch, no scratch.
//   prefill (M > 16)  - two launches, one wrapper call:
//     w8a8_quantize_kernel: x once into xq int8 [M, K] and xs f32 [K/256, Mp]
//           (group-major, Mp = M rounded up to 4, so that one group's scales
//           of a token tile are one TMA box), one warp per (row, group), as
//           the TPU wrapper quantizes x once before its kernel;
//     w8a8_wgmma_kernel<TY, BM, WG>: a warp-specialised GEMM per (BM tokens x
//           BN = 64 WG weight rows) output tile, one 256-group per stage of a
//           kStages ring in shared memory under full/empty mbarriers:
//       * a producer warpgroup (one lane issues, setmaxnreg gives its
//         registers to the consumers) loads by TMA the group's xq [BM x 256]
//         (two boxes of 128-byte rows in the 128-byte swizzle, as wgmma reads
//         them), the packed weight bytes [BN x 128] (128-byte swizzle: the
//         consumers' 16-byte reads of them are then free of bank conflicts)
//         and xs [BM];
//       * consumer warpgroup c owns weight rows 64c..64c+63 of the tile: the
//         weights are wgmma's A operand from registers (weight rows are the
//         instruction's M side, tokens its N side, so the accumulator is
//         y^T). Thread (gid, t) of warp w holds rows 16w + gid and + 8, k
//         4t..4t+3 and 16+4t..16+4t+3 of each k32 step: exactly the low and
//         high nibbles of word t of each 32-block, which the q4s layout puts
//         in bytes 32t..32t+31 of the row's group. Two 16-byte shared loads
//         a row and four integer operations a word (expand_lo/hi) give the
//         group's eight A fragments; no shared-memory store and no proxy
//         fence. B = the xq tile (K-major, the 128-byte swizzle descriptor,
//         +32 bytes a k32 step). Eight wgmma.mma_async m64nBMk32 .s32.s8.s8
//         a group, the first with scale-d = 0, so the s32 accumulator starts
//         each group at 0 without an instruction writing it; then wait and
//         promote: acc += (float(d) * xs[tok]) * swk[row], each operation
//         rounded once, and free the stage. float(d) is exact without I2F
//         (a quarter of the FP32 rate): |d| < 2^22, so the bits d +
//         0x4B400000 are the float 1.5 * 2^23 + d, and subtracting 1.5 *
//         2^23 is exact. sigma and swk (rows of 24 and 12 bytes at K = 768,
//         which TMA cannot map) are read from global one group ahead. With
//         two consumer warpgroups, named barriers make them take turns at the
//         tensor cores (0, 1, 0, 1, ...), so one's products run while the
//         other expands and promotes;
//       * epilogue: every consumer is done with the ring, so each warpgroup
//         stages its [BM tokens x 64 rows] of y in the output type in the
//         ring's x area (128-byte swizzle, so the accumulator layout's
//         scattered stores meet no bank conflicts), a proxy fence, and TMA
//         stores of 128-byte boxes: rows past M and N are dropped there, as
//         TMA zero-fills xq, the weights and xs past M and N on the way in
//         (sigma and swk read as 0 there).
//       The role branches take the warp index through a shuffle, so ptxas
//       knows them warp-uniform: in a branch it cannot prove uniform it
//       serializes register-A wgmmas behind warpgroup arrives (C7520). Tiles:
//       128 x 128 (two consumer warpgroups, one block an SM) once that gives
//       two thirds of the SMs a block, else 64 x 64 (one, two blocks an SM).
//       Each output is one block's sum in g order: the result is
//       deterministic and equal to the plain version's. What bounds it on
//       the H100 (scripts/k5_ablate.py): the CUDA-core work of a 128 x 128
//       group, about 600 instructions a consumer thread (expansion and
//       promotion), exceeds the 1,024 cycles its products take on the int8
//       tensor cores, and overlaps them only in part.
// Ragged M and N edges are masked; K must be a multiple of 256; x and y are
// row-major; x is contiguous, y's rows are ldy >= N elements apart; x is
// bf16 or f32, y is bf16 or f32. Past M = 16 the TMA store needs y's row
// stride a 16-byte multiple (the wrapper pads it for any N, and the store
// drops the columns past N), and the caller supplies the xq/xs scratch.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kGroup = 256;             // activation group and swk group
constexpr int kBlocksPerGroup = 8;      // 32-blocks (sigma) per group

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
// in `v`; their int8 codes come back as two words (values 8l..8l+3 in `lo`,
// 8l+4..8l+7 in `hi`, byte i the value i of each four). Returns the group's
// scale (every lane).
__device__ __forceinline__ float quantize8(const float* v, uint32_t& lo, uint32_t& hi) {
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
  lo = w[0];
  hi = w[1];
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 0.0f;
}

// Byte offset, in a group's fragment tile [j (J)][q (4)][mma lane (32)][16
// bytes], of lane l's code word `word` (0: values 8l..8l+3, 1: 8l+4..8l+7 of
// the group) of token m: code k = 32 b + 16 h + 4 t + i of token 8 j + gid is
// byte 4 ((2 b + h) % 4) + i of chunk q = (2 b + h) / 4 of mma lane 4 gid + t,
// so that lane's B fragments (b0 = half 0, b1 = half 1 of each block) are its
// four 16-byte chunks, and a warp's read of one chunk each is conflict-free.
__device__ __forceinline__ int frag_offset(int m, int lane, int word) {
  const int w2 = 2 * (lane >> 2) + ((lane >> 1) & 1), t = 2 * (lane & 1) + word;
  return (((m >> 3) * 4 + (w2 >> 2)) * 32 + 4 * (m & 7) + t) * 16 + (w2 & 3) * 4;
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

constexpr int kDecodeMaxM = 16;  // the decode route's largest M; the prefill route above it

// ---- the pre-pass of both routes: w8a8_quantize_kernel ------------------------

constexpr int kQuantWarps = 8;

// xq[m, g-th group] and xs[g, m] = q8_quantize of x[m, group g]: one warp per
// (row, group), lane l taking values 8l..8l+7. kDecodeOrder: xq holds each
// group's codes as one fragment tile of the decode kernel's B operand
// (frag_offset; J = ceil(M / 8) token tiles, 2048 J bytes a group, tokens
// past M unwritten), else in element order ([M, K]).
// It lets the grid that depends on it launch at once (programmatic dependent
// launch): that grid's griddepcontrol.wait still waits for this one to end.
template <typename TX, bool kDecodeOrder>
__global__ void __launch_bounds__(kQuantWarps * 32)
w8a8_quantize_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                     int M, int K, int Mp) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int G = K / kGroup;
  const int item = blockIdx.x * kQuantWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (item >= M * G) return;  // warp-uniform
  const int m = item / G, g = item - m * G;
  const size_t row = (size_t)m * K + g * kGroup;
  float v[8];
  load_x8(x + row + lane * 8, v);
  uint32_t lo, hi;
  const float sc = quantize8(v, lo, hi);
  if (kDecodeOrder) {
    int8_t* const tile = xq + (size_t)g * ((M + 7) >> 3) * 2048;
    *reinterpret_cast<uint32_t*>(tile + frag_offset(m, lane, 0)) = lo;
    *reinterpret_cast<uint32_t*>(tile + frag_offset(m, lane, 1)) = hi;
  } else {
    *reinterpret_cast<uint2*>(xq + row + lane * 8) = make_uint2(lo, hi);
  }
  if (lane == 0) xs[(size_t)g * Mp + m] = sc;
}

// ---- M > 16: w8a8_quantize_kernel, then w8a8_wgmma_kernel --------------------

constexpr int kStages = 4;
constexpr int kBoxBytes = 128;  // one row of a TMA box: one 128-byte swizzle row

template <int BM, int WG>
struct Tile {
  static constexpr int kBN = 64 * WG;                  // weight rows
  static constexpr int kThreads = 128 * (WG + 1);     // + the producer warpgroup
  static constexpr int kMinBlocks = WG == 1 ? 2 : 1;
  // registers a thread after setmaxnreg: the producer's few, the rest of the
  // block's (65536 / kMinBlocks at entry) to the consumers, in units of 8
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs =
      (65536 / kMinBlocks - 128 * kProducerRegs) / (128 * WG) / 8 * 8;
  static constexpr int kXBytes = BM * kGroup;          // xq: two boxes [BM x 128]
  static constexpr int kWBytes = kBN * (kGroup / 2);   // packed weights [BN x 128]
  static constexpr int kSBytes = BM * 4;               // xs of the BM tokens
  // the x, W and xs rings, then the full/empty barriers, plus slack to align to 1024
  static constexpr int kSmem = kStages * (kXBytes + kWBytes + kSBytes) + 2 * kStages * 8 + 1024;
  // the epilogue's staging, f32 at most, fits in the x ring
  static_assert(WG * BM * 64 * 4 <= kStages * kXBytes, "staging space");
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

// One box of shared memory out to a 2-D map, in the bulk async group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); the tile's base is 1024-aligned, and a
// k32 step of int8 within the 128-byte row advances the start address by 32.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[kBlocksPerGroup][4]) {
#pragma unroll
  for (int i = 0; i < kBlocksPerGroup; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T, s8 in, s32 out; A from registers
// (four s8x4 a thread), B K-major in shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, the same at BM = 128
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// float(d), exactly, for |d| < 2^22: the bits d + 0x4B400000 are the float
// 1.5 * 2^23 + d (one ulp is 1 there), and the subtraction is exact.
__device__ __forceinline__ float exact_f32(int d) {
  return __fadd_rn(__int_as_float(d + 0x4B400000), -12582912.0f);
}

// The four s8 weights (nibble - 8) * sigma of the low (hi = 0) or high (hi =
// 1) nibbles of the packed word w, in four integer operations: with c = the
// bytes 256 - 8 sigma, byte i of n_i * sigma + c is (n_i - 8) * sigma mod 256
// and carries one into byte i + 1 exactly where n_i >= 8 (bit 3 of n_i), so
// subtracting those carries leaves the bytes, with no per-byte masking.
// `c` = 0x01010100 - sigma * 0x08080808 (mod 2^32), one per block and row.
__device__ __forceinline__ uint32_t expand_lo(uint32_t w, uint32_t sigma, uint32_t c) {
  return (w & 0x0F0F0F0Fu) * sigma + c - ((w & 0x08080808u) << 5);
}
__device__ __forceinline__ uint32_t expand_hi(uint32_t w, uint32_t sigma, uint32_t c) {
  return ((w >> 4) & 0x0F0F0F0Fu) * sigma + c - ((w & 0x80808080u) << 1);
}

// Named barriers of the prefill kernel (0 is __syncthreads): every consumer;
// warpgroup c's own (2 + c); the two warpgroups' turns at the tensor cores.
constexpr int kBarConsumers = 1, kBarOwn = 2, kBarTurn = 4;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of element (row r, column c) of a staged y box: rows of 128
// bytes in the 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)),
// 128 / sizeof(TY) columns a box, boxes of `rows` rows one after another.
template <typename TY>
__device__ __forceinline__ uint32_t staged(int r, int c, int rows) {
  constexpr int kCols = kBoxBytes / sizeof(TY);
  const uint32_t byte = (c % kCols) * sizeof(TY);
  return (c / kCols) * rows * kBoxBytes + r * kBoxBytes + ((((byte >> 4) ^ r) & 7) << 4) +
         (byte & 15);
}

// A consumer warpgroup's part of w8a8_wgmma_kernel: warpgroup wg (warp wq of
// it) owns weight rows 64 wg..64 wg + 63 of the tile.
template <typename TY, int BM, int WG>
__device__ __forceinline__ void consume(uint8_t* xt, const uint8_t* wt, const float* st,
                                        uint32_t full0, uint32_t empty0, const CUtensorMap* ymap,
                                        const uint8_t* __restrict__ sg,
                                        const float* __restrict__ sw, int wg, int wq, int lane,
                                        int m0, int n0, int N, int K) {
  using T = Tile<BM, WG>;
  const int G = K / kGroup;
  const int gid = lane >> 2, tig = lane & 3;
  const int rl = 64 * wg + 16 * wq + gid;  // the thread's tile rows: rl and rl + 8
  const int r0 = n0 + rl, r1 = r0 + 8;
  // sigma and swk of the thread's two rows, read one group ahead (0 past N)
  uint2 sig_next[2];
  float swk_next[2];
  const auto load_scales = [&](int g) {
    const int rows[2] = {r0, r1};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = rows[h] < N;
      sig_next[h] = in ? __ldg(reinterpret_cast<const uint2*>(sg + (size_t)rows[h] * (K >> 5)) + g)
                       : make_uint2(0u, 0u);
      swk_next[h] = in ? __ldg(sw + (size_t)rows[h] * G + g) : 0.0f;
    }
  };
  load_scales(0);

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
  int d[BM / 2];  // the group's s32 sums, d[4j + 2h + e]: row rl + 8h, token 8j + 2 tig + e

  for (int g = 0; g < G; ++g) {
    const int s = g % kStages;
    const uint2 sig[2] = {sig_next[0], sig_next[1]};
    const float swk[2] = {swk_next[0], swk_next[1]};
    if (g + 1 < G) load_scales(g + 1);
    mbar_wait(full0 + 8 * s, (g / kStages) & 1);
    // word b of a row = block b's bytes 4 tig..4 tig + 3: chunks 2 tig and
    // 2 tig + 1 of the row's 128 bytes, swizzled by the row (rl % 8 = gid)
    const uint8_t* const wr = wt + s * T::kWBytes + rl * kBoxBytes;
    uint32_t w0[kBlocksPerGroup], w1[kBlocksPerGroup];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int off = ((2 * tig + c) ^ gid) << 4;
      const uint4 p0 = *reinterpret_cast<const uint4*>(wr + off);
      const uint4 p1 = *reinterpret_cast<const uint4*>(wr + 8 * kBoxBytes + off);
      w0[4 * c] = p0.x; w0[4 * c + 1] = p0.y; w0[4 * c + 2] = p0.z; w0[4 * c + 3] = p0.w;
      w1[4 * c] = p1.x; w1[4 * c + 1] = p1.y; w1[4 * c + 2] = p1.z; w1[4 * c + 3] = p1.w;
    }
    // the A fragments of the group's eight k32 steps: rows rl / rl + 8 at k
    // 4 tig.. (low nibbles) and 16 + 4 tig.. (high nibbles)
    uint32_t a[kBlocksPerGroup][4];
#pragma unroll
    for (int b = 0; b < kBlocksPerGroup; ++b) {
      const uint32_t s0 = ((b < 4 ? sig[0].x : sig[0].y) >> (8 * (b & 3))) & 0xFFu;
      const uint32_t s1 = ((b < 4 ? sig[1].x : sig[1].y) >> (8 * (b & 3))) & 0xFFu;
      const uint32_t c0 = 0x01010100u - s0 * 0x08080808u, c1 = 0x01010100u - s1 * 0x08080808u;
      a[b][0] = expand_lo(w0[b], s0, c0);
      a[b][1] = expand_lo(w1[b], s1, c1);
      a[b][2] = expand_hi(w0[b], s0, c0);
      a[b][3] = expand_hi(w1[b], s1, c1);
    }
    const uint32_t xa = smem_u32(xt + s * T::kXBytes);
    // two warpgroups take turns at the tensor cores (0, 1, 0, 1, ...), so
    // one's products run while the other promotes and expands
    if (WG == 2 && (wg == 1 || g > 0)) named_sync(kBarTurn + wg, 256);
    fence_operands(a);  // every A fragment is built before the first product reads one
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < kBlocksPerGroup; ++b)
      wgmma_s8(d, a[b], sw128_desc(xa + (b >> 2) * BM * kBoxBytes + 32 * (b & 3)), b > 0);
    wgmma_commit();
    if (WG == 2 && (wg == 0 || g + 1 < G)) named_arrive(kBarTurn + 1 - wg, 256);
    wgmma_wait0();
    fence_operands(d);
    fence_operands(a);  // the A registers stay untouched until the products are done
    const float* const xs = st + s * BM;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(xs + 8 * j + 2 * tig);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float x = e ? xv.y : xv.x;
          acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(exact_f32(d[i]), x), swk[h]));
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage's xq, weights and xs are read
  }

  // every consumer is done with the ring: stage y^T's tile as y in its x area
  named_sync(kBarConsumers, 128 * WG);
  TY* const yt = reinterpret_cast<TY*>(xt + wg * BM * 64 * sizeof(TY));
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = 8 * j + 2 * tig + e, col = 16 * wq + gid + 8 * h;
        *reinterpret_cast<TY*>(reinterpret_cast<uint8_t*>(yt) + staged<TY>(tok, col, BM)) =
            from_f32<TY>(acc[4 * j + 2 * h + e]);
      }
  // generic stores, then the async proxy's reads of them (the TMA store)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(kBarOwn + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    constexpr int kCols = kBoxBytes / sizeof(TY);
#pragma unroll
    for (int bx = 0; bx < 64 / kCols; ++bx)
      tma_store_2d(ymap, smem_u32(reinterpret_cast<uint8_t*>(yt) + bx * BM * kBoxBytes),
                   n0 + 64 * wg + bx * kCols, m0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the block exits
  }
}

template <typename TY, int BM, int WG>
__global__ void __launch_bounds__(Tile<BM, WG>::kThreads, Tile<BM, WG>::kMinBlocks)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap smap,
                  const __grid_constant__ CUtensorMap ymap, const uint8_t* __restrict__ sg,
                  const float* __restrict__ sw, int N, int K) {
  using T = Tile<BM, WG>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: tiles start 1024-aligned
  uint8_t* const xt = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const wt = xt + kStages * T::kXBytes;
  float* const st = reinterpret_cast<float*>(wt + kStages * T::kWBytes);
  // full[s]: the stage's xq, weights and xs landed; empty[s]: its readers are done
  const uint32_t full0 = smem_u32(st + kStages * BM), empty0 = full0 + 8 * kStages;

  // warp and warpgroup through a shuffle: values the compiler knows to be
  // warp-uniform, so the role branches below are not divergent paths (in one,
  // ptxas serializes the register-A wgmmas behind warpgroup arrives)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * T::kBN;
  const int G = K / kGroup;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);            // the TMA lane's expect_tx
      mbar_init(empty0 + 8 * i, 4 * WG);      // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {  // the producer warpgroup: one lane issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (threadIdx.x == 128 * WG) {
      for (int g = 0; g < G; ++g) {
        const int s = g % kStages, lap = g / kStages;
        if (lap > 0) mbar_wait(empty0 + 8 * s, (lap - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t xdst = smem_u32(xt + s * T::kXBytes);
        mbar_arrive_expect_tx(full, T::kXBytes + T::kWBytes + T::kSBytes);
        tma_load_2d(xdst, &xmap, g * kGroup, m0, full);
        tma_load_2d(xdst + BM * kBoxBytes, &xmap, g * kGroup + kBoxBytes, m0, full);
        tma_load_2d(smem_u32(wt + s * T::kWBytes), &wmap, g * (kGroup / 2), n0, full);
        tma_load_2d(smem_u32(st + s * BM), &smap, m0, g, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
    consume<TY, BM, WG>(xt, wt, st, full0, empty0, &ymap, sg, sw, wg, warp & 3, lane, m0, n0, N,
                        K);
  }
}

// ---- M <= 16: w8a8_quantize_kernel<TX, true>, then w8a8_decode_kernel ---------

// At or below this M the decode kernel quantizes x itself, each warp its
// group's rows (one launch); above it the pre-pass does, once per call.
constexpr int kInlineMaxM = 2;
static_assert(kInlineMaxM >= 0 && kInlineMaxM <= 8, "in-launch quantization takes one token tile");

// A decode block: W warps, 16 T weight rows (T row tiles of 16), 8 J tokens
// (J = 1 for M <= 8, else 2).
template <int T, int J, int W>
struct DecTile {
  static constexpr int kBN = 16 * T;
  static constexpr int kBox = kBN * kBoxBytes;           // one (row tile, group) box of weights
  static constexpr int kS = T == 1 ? 2 : 1;              // weight stages a warp
  static constexpr int kTok = 8 * J;
  static constexpr int kPStride = kBN + 4;               // floats a token's products: no bank conflicts
  static constexpr int kXCodes = J * 2048;               // a group's fragment tile of codes
  static constexpr int kXBuf = kXCodes + 4 * kDecodeMaxM;  // codes, then the group's scales
  static constexpr int kRing = W * kS * kBox;
  static constexpr int kProd = W * kTok * kPStride * 4;
  static constexpr int kX = W * kXBuf;
  static constexpr int kSmem = kRing + kProd + kX + W * (kS + 1) * 8 + 1024;
  static constexpr int kAcc = (kTok * kBN + W * 32 - 1) / (W * 32);
  static constexpr int kMinBlocks = W == 8 ? 2 : 1;
  static_assert(kRing % 1024 == 0 && kProd % 16 == 0 && kXBuf % 16 == 0, "layout");
};

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, by the bulk-copy engine, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// y[M, N] for M <= 16, as the file's header sets out: block b owns weight
// rows 16 T b.. 16 T b + 16 T - 1, warp w of it the groups g = W r + w; each
// group's products go to shared memory, and after each round the block sums
// them into its f32 accumulators in group order, each sum rounded once, as
// the plain version does: deterministic, and equal to it bit for bit. The
// weights, the codes and the scales come a ring, a group and a round ahead;
// the even and odd blocks' products go to two accumulators (two chains of
// mma.sync a token tile). kInline (M <= kInlineMaxM): each warp quantizes its
// group's M rows of x itself, into its code buffer.
template <typename TX, typename TY, int T, int J, int W, bool kInline>
__global__ void __launch_bounds__(W * 32, DecTile<T, J, W>::kMinBlocks)
w8a8_decode_kernel(const __grid_constant__ CUtensorMap wmap, const TX* __restrict__ x,
                   const int8_t* xq, const float* xs, const uint8_t* __restrict__ sg,
                   const float* __restrict__ sw, TY* __restrict__ y, int M, int N, int K,
                   int ldy, int Mp) {
  using D = DecTile<T, J, W>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: boxes start 1024-aligned
  uint8_t* const ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* const prod = reinterpret_cast<float*>(ring + D::kRing);  // [warp][token][row]
  uint8_t* const xbufs = ring + D::kRing + D::kProd;
  const uint32_t bar0 = smem_u32(xbufs + D::kX);

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * D::kBN;
  const int G = K / kGroup;
  const int rounds = (G + W - 1) / W;
  uint8_t* const wring = ring + warp * D::kS * D::kBox;
  const uint32_t full0 = bar0 + 8 * warp * D::kS;  // the weight stages' barriers
  const uint32_t xbar = bar0 + 8 * (W * D::kS + warp);  // the x buffer's
  float* const wprod = prod + warp * D::kTok * D::kPStride;
  uint8_t* const xb = xbufs + warp * D::kXBuf;
  float* const xbs = reinterpret_cast<float*>(xb + D::kXCodes);
  const uint32_t xbytes = D::kXCodes + 4 * Mp;
  const size_t xstride = (size_t)((M + 7) >> 3) * 2048;  // the pre-pass's bytes a group

  if (lane == 0) {  // the warp's ring: its first kS groups
    for (int s = 0; s <= D::kS; ++s) mbar_init(s < D::kS ? full0 + 8 * s : xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int r = 0; r < D::kS && r * W + warp < G; ++r) {
      mbar_arrive_expect_tx(full0 + 8 * r, D::kBox);
      tma_load_2d(smem_u32(wring + r * D::kBox), &wmap, (r * W + warp) * (kGroup / 2), n0,
                  full0 + 8 * r);
    }
  }
  __syncwarp();
  // sigma (the group's 8 block scales) and swk of the thread's rows 16 i + gid
  // and + 8 of each row tile (0 past N), loaded a round ahead
  uint2 sig[T][2];
  float swk[T][2];
  const auto load_scales = [&](int g) {
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = n0 + 16 * i + gid + 8 * h;
        const bool in = row < N;
        sig[i][h] = in ? __ldg(reinterpret_cast<const uint2*>(sg + (size_t)row * (K >> 5)) + g)
                       : make_uint2(0u, 0u);
        swk[i][h] = in ? __ldg(sw + (size_t)row * G + g) : 0.0f;
      }
  };
  if (warp < G) load_scales(warp);
  if constexpr (!kInline) {
    // the pre-pass may still run: xq and xs are read only past this
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (lane == 0 && warp < G) {
      mbar_arrive_expect_tx(xbar, xbytes);
      bulk_load(smem_u32(xb), xq + warp * xstride, D::kXCodes, xbar);
      bulk_load(smem_u32(xbs), xs + (size_t)warp * Mp, 4 * Mp, xbar);
    }
  }

  float acc[D::kAcc];
#pragma unroll
  for (int q = 0; q < D::kAcc; ++q) acc[q] = 0.0f;

  for (int r = 0; r < rounds; ++r) {
    const int g = r * W + warp;
    if (g < G) {  // warp-uniform
      if constexpr (kInline) {  // the group's M rows of x, quantized by this warp
        constexpr int R = kInlineMaxM > 0 ? kInlineMaxM : 1;
        float v[R][8];
#pragma unroll
        for (int m = 0; m < R; ++m)
          if (m < M) load_x8(x + (size_t)m * K + g * kGroup + lane * 8, v[m]);
#pragma unroll
        for (int m = 0; m < R; ++m)
          if (m < M) {
            uint32_t lo, hi;
            const float sc = quantize8(v[m], lo, hi);
            *reinterpret_cast<uint32_t*>(xb + frag_offset(m, lane, 0)) = lo;
            *reinterpret_cast<uint32_t*>(xb + frag_offset(m, lane, 1)) = hi;
            if (lane == 0) xbs[m] = sc;
          }
        __syncwarp();
      } else {
        mbar_wait(xbar, r & 1);
      }
      // the group's B fragments (tokens past M hold what they hold: their
      // products are never summed) and the scales of tokens 8 j + 2 tig and + 1
      uint32_t bx[J][16];
      float xv[J][2];
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 u = *reinterpret_cast<const uint4*>(xb + ((j * 4 + q) * 32 + lane) * 16);
          bx[j][4 * q] = u.x; bx[j][4 * q + 1] = u.y; bx[j][4 * q + 2] = u.z; bx[j][4 * q + 3] = u.w;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) xv[j][e] = xbs[min(8 * j + 2 * tig + e, M - 1)];
      }
      if constexpr (!kInline) {
        __syncwarp();  // every lane has read the buffer: the next group's, one round ahead
        if (lane == 0 && g + W < G) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive_expect_tx(xbar, xbytes);
          bulk_load(smem_u32(xb), xq + (g + W) * xstride, D::kXCodes, xbar);
          bulk_load(smem_u32(xbs), xs + (size_t)(g + W) * Mp, 4 * Mp, xbar);
        }
      }
      const int s = r % D::kS;
      mbar_wait(full0 + 8 * s, (r / D::kS) & 1);
      const uint8_t* const box = wring + s * D::kBox;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        // word b of rows 16 i + gid (w0) and + 8 (w1): block b's bytes 4 tig..
        // 4 tig + 3, chunks 2 tig and 2 tig + 1 of the row, swizzled by the row
        const uint8_t* const wr = box + (16 * i + gid) * kBoxBytes;
        uint32_t w0[kBlocksPerGroup], w1[kBlocksPerGroup];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int off = ((2 * tig + c) ^ gid) << 4;
          const uint4 p0 = *reinterpret_cast<const uint4*>(wr + off);
          const uint4 p1 = *reinterpret_cast<const uint4*>(wr + 8 * kBoxBytes + off);
          w0[4 * c] = p0.x; w0[4 * c + 1] = p0.y; w0[4 * c + 2] = p0.z; w0[4 * c + 3] = p0.w;
          w1[4 * c] = p1.x; w1[4 * c + 1] = p1.y; w1[4 * c + 2] = p1.z; w1[4 * c + 3] = p1.w;
        }
        int d[2][J][4];  // the even and the odd blocks' sums: two chains of products
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[p][j][e] = 0;
#pragma unroll
        for (int b = 0; b < kBlocksPerGroup; ++b) {
          const uint32_t s0 = ((b < 4 ? sig[i][0].x : sig[i][0].y) >> (8 * (b & 3))) & 0xFFu;
          const uint32_t s1 = ((b < 4 ? sig[i][1].x : sig[i][1].y) >> (8 * (b & 3))) & 0xFFu;
          const uint32_t c0 = 0x01010100u - s0 * 0x08080808u, c1 = 0x01010100u - s1 * 0x08080808u;
          const uint32_t a0 = expand_lo(w0[b], s0, c0), a1 = expand_lo(w1[b], s1, c1);
          const uint32_t a2 = expand_hi(w0[b], s0, c0), a3 = expand_hi(w1[b], s1, c1);
#pragma unroll
          for (int j = 0; j < J; ++j)
            mma_s8(d[b & 1][j], a0, a1, a2, a3, bx[j][2 * b], bx[j][2 * b + 1]);
        }
        // d[j][e]: row 16 i + gid + 8 (e / 2), token 8 j + 2 tig + e % 2
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wprod[(8 * j + 2 * tig + (e & 1)) * D::kPStride + 16 * i + gid + 8 * (e >> 1)] =
                __fmul_rn(__fmul_rn(exact_f32(d[0][j][e] + d[1][j][e]), xv[j][e & 1]),
                          swk[i][e >> 1]);
      }
      if (g + W < G) load_scales(g + W);
      __syncwarp();  // every lane has read the stage: refill it, kS groups ahead
      if (lane == 0 && g + D::kS * W < G) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_expect_tx(full0 + 8 * s, D::kBox);
        tma_load_2d(smem_u32(box), &wmap, (g + D::kS * W) * (kGroup / 2), n0, full0 + 8 * s);
      }
    }
    __syncthreads();  // the round's products are in
    // acc += the products of groups W r, W r + 1, ... in order
    const int ngr = min(W, G - r * W);
#pragma unroll
    for (int q = 0; q < D::kAcc; ++q) {
      const int idx = threadIdx.x + q * W * 32;
      const int tok = idx / D::kBN, row = idx % D::kBN;
      if (idx < D::kTok * D::kBN && tok < M)
        for (int v = 0; v < ngr; ++v)
          acc[q] = __fadd_rn(acc[q], prod[(v * D::kTok + tok) * D::kPStride + row]);
    }
    if (r + 1 < rounds) __syncthreads();  // the products are read: the next round's may come
  }
#pragma unroll
  for (int q = 0; q < D::kAcc; ++q) {
    const int idx = threadIdx.x + q * W * 32;
    const int tok = idx / D::kBN, n = n0 + idx % D::kBN;
    if (idx < D::kTok * D::kBN && tok < M && n < N) y[(size_t)tok * ldy + n] = from_f32<TY>(acc[q]);
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

// A 2-D map over [rows, cols] elements with a row stride of `stride` bytes,
// box [box_rows, box_cols]; loads past an edge are zero-filled, stores there
// dropped.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr, uint64_t rows,
               uint64_t cols, uint64_t stride, uint32_t box_rows, uint32_t box_cols,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride};
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
  if (!encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, K / 2, BN, kBoxBytes,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  cache.emplace(key, *map);
  return true;
}

// One decode launch; after the pre-pass (kInline false) with programmatic
// dependent launch, so its blocks start their weight loads while the pre-pass
// runs.
template <typename TX, typename TY, int T, int J, int W, bool kInline>
cudaError_t launch_decode_kernel(const uint8_t* w, const TX* x, const int8_t* xq, const float* xs,
                                 const uint8_t* sg, const float* sw, TY* y, int M, int N, int K,
                                 int ldy, int Mp, cudaStream_t st) {
  using D = DecTile<T, J, W>;
  CUtensorMap wmap;
  if (!weight_map(&wmap, w, N, K, D::kBN)) return cudaErrorInvalidValue;
  static uint32_t smem_set = 0;  // devices whose attribute is set (bit per device)
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(smem_set >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(w8a8_decode_kernel<TX, TY, T, J, W, kInline>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, D::kSmem);
    if (e != cudaSuccess) return e;
    smem_set |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + D::kBN - 1) / D::kBN);
  cfg.blockDim = dim3(W * 32);
  cfg.dynamicSmemBytes = D::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = kInline ? 0 : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w8a8_decode_kernel<TX, TY, T, J, W, kInline>, wmap,
                                           x, xq, xs, sg, sw, y, M, N, K, ldy, Mp);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename TX, typename TY, int T, int W>
cudaError_t launch_decode_tile(const TX* x, const uint8_t* w, const uint8_t* sg, const float* sw,
                               TY* y, int M, int N, int K, int ldy, int8_t* xq, float* xs,
                               cudaStream_t st) {
  const int Mp = (M + 3) & ~3;
  if constexpr (kInlineMaxM > 0) {
    if (M <= kInlineMaxM)
      return launch_decode_kernel<TX, TY, T, 1, W, true>(w, x, nullptr, nullptr, sg, sw, y, M, N,
                                                         K, ldy, Mp, st);
  }
  if (xq == nullptr || xs == nullptr) return cudaErrorInvalidValue;
  const int items = M * (K / kGroup);
  w8a8_quantize_kernel<TX, true><<<(items + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, st>>>(
      x, xq, xs, M, K, Mp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (M <= 8)
    return launch_decode_kernel<int8_t, TY, T, 1, W, false>(w, nullptr, xq, xs, sg, sw, y, M, N, K,
                                                            ldy, Mp, st);
  return launch_decode_kernel<int8_t, TY, T, 2, W, false>(w, nullptr, xq, xs, sg, sw, y, M, N, K,
                                                          ldy, Mp, st);
}

template <typename TX, typename TY>
cudaError_t launch_decode(const void* x, const uint8_t* w, const uint8_t* sg, const float* sw,
                          void* y, int M, int N, int K, int ldy, int8_t* xq, float* xs,
                          cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  TY* yp = static_cast<TY*>(y);
  // 32-row tiles once that gives every SM a block; else 16-row tiles, and 16
  // warps a block (half the rounds) when the groups outnumber 8 warps and
  // the blocks fit on the SMs at once
  const int sms = sm_count(), G = K / kGroup;
  if ((N + 31) / 32 >= sms)
    return launch_decode_tile<TX, TY, 2, 8>(xp, w, sg, sw, yp, M, N, K, ldy, xq, xs, st);
  if (G > 8 && (N + 15) / 16 <= sms)
    return launch_decode_tile<TX, TY, 1, 16>(xp, w, sg, sw, yp, M, N, K, ldy, xq, xs, st);
  return launch_decode_tile<TX, TY, 1, 8>(xp, w, sg, sw, yp, M, N, K, ldy, xq, xs, st);
}

template <typename TY, int BM, int WG>
cudaError_t launch_wgmma(const int8_t* xq, const float* xs, int Mp, const uint8_t* w,
                         const uint8_t* sg, const float* sw, TY* y, int M, int N, int K,
                         int ldy, cudaStream_t st) {
  using T = Tile<BM, WG>;
  const CUtensorMapDataType ydt =
      sizeof(TY) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // xq, xs and y change with every call: their maps are made per launch. y's
  // map has N columns over rows of ldy: the store drops the columns past N.
  CUtensorMap xmap, wmap, smap, ymap;
  if (!encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, BM, kBoxBytes,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !weight_map(&wmap, w, N, K, T::kBN) ||
      !encode_2d(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xs, K / kGroup, M, (uint64_t)Mp * 4, 1,
                 BM, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_2d(&ymap, ydt, y, M, N, (uint64_t)ldy * sizeof(TY), BM, kBoxBytes / sizeof(TY),
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static uint32_t smem_set = 0;  // devices whose attribute is set (bit per device)
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(smem_set >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_wgmma_kernel<TY, BM, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    smem_set |= 1u << dev;
  }
  // token tiles fastest: the blocks that share a weight tile run together
  const dim3 grid((M + BM - 1) / BM, (N + T::kBN - 1) / T::kBN);
  w8a8_wgmma_kernel<TY, BM, WG><<<grid, T::kThreads, T::kSmem, st>>>(xmap, wmap, smap, ymap, sg,
                                                                     sw, N, K);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_prefill(const void* x, const uint8_t* w, const uint8_t* sg, const float* sw,
                           void* y, int M, int N, int K, int ldy, int8_t* xq, float* xs,
                           cudaStream_t st) {
  if (xq == nullptr || xs == nullptr || (long long)M * (K / kGroup) >= (1ll << 31) ||
      ((long long)ldy * sizeof(TY)) % 16)
    return cudaErrorInvalidValue;
  const int Mp = (M + 3) & ~3;
  const int items = M * (K / kGroup);
  w8a8_quantize_kernel<TX, false><<<(items + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, st>>>(
      static_cast<const TX*>(x), xq, xs, M, K, Mp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // 128 x 128 once that gives two thirds of the SMs a block, else 64 x 64 at
  // two blocks an SM (measured on the H100 at the Llama-3.2-1B prefill shapes)
  TY* yp = static_cast<TY*>(y);
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (M > 64 && 3 * big >= 2 * sm_count())
    return launch_wgmma<TY, 128, 2>(xq, xs, Mp, w, sg, sw, yp, M, N, K, ldy, st);
  return launch_wgmma<TY, 64, 1>(xq, xs, Mp, w, sg, sw, yp, M, N, K, ldy, st);
}

template <typename TX, typename TY>
cudaError_t launch(const void* x, const uint8_t* w, const uint8_t* sg, const float* sw, void* y,
                   int M, int N, int K, int ldy, int8_t* xq, float* xs, cudaStream_t st) {
  if (M <= kDecodeMaxM) return launch_decode<TX, TY>(x, w, sg, sw, y, M, N, K, ldy, xq, xs, st);
  return launch_prefill<TX, TY>(x, w, sg, sw, y, M, N, K, ldy, xq, xs, st);
}

}  // namespace

// The decode route's largest M (the prefill route above it), which the
// wrapper reads to shape y's row stride and the scratch.
extern "C" int w8a8_decode_max_m() { return kDecodeMaxM; }

// The largest M at which the decode kernel quantizes x itself: the caller's
// scratch is not read there and may be null.
extern "C" int w8a8_inline_max_m() { return kInlineMaxM; }

// Returns the cudaError_t of the launch (0 on success); 1 (cudaErrorInvalidValue)
// for arguments the kernels do not take. y's rows are ldy >= N elements apart;
// past w8a8_decode_max_m() the TMA store needs them 16-byte multiples (the
// columns past N are not written). xq (int8 [max(M, w8a8_decode_max_m()), K])
// and xs (f32 [K/256, Mp], Mp = M rounded up to 4) are the caller's scratch,
// 16-byte aligned, written and read by the launches of this call (not read at
// M <= w8a8_inline_max_m(), where they may be null).
extern "C" int w8a8_matmul(const void* x, int x_dtype, const void* w, const void* sigma,
                           const void* swk, void* y, int y_dtype, int M, int N, int K, int ldy,
                           void* xq, void* xs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kGroup || ldy < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const uint8_t* sp = static_cast<const uint8_t*>(sigma);
  const float* swp = static_cast<const float*>(swk);
  int8_t* xqp = static_cast<int8_t*>(xq);
  float* xsp = static_cast<float*>(xs);
  if (x_dtype == kBF16 && y_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, wp, sp, swp, y, M, N, K, ldy, xqp, xsp, st);
  if (x_dtype == kBF16 && y_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, wp, sp, swp, y, M, N, K, ldy, xqp, xsp, st);
  if (x_dtype == kF32 && y_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, wp, sp, swp, y, M, N, K, ldy, xqp, xsp, st);
  if (x_dtype == kF32 && y_dtype == kF32)
    return launch<float, float>(x, wp, sp, swp, y, M, N, K, ldy, xqp, xsp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
