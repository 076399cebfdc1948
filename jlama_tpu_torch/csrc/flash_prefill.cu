// K3: flash prefill attention for Hopper (sm_90a).
//
// Replaces jlama_tpu/ops/pallas_attention.py:_flash_kernel (launched by
// _flash_prefill_jit). Computes, for T > 1 query tokens of a chunk that
// starts at absolute position pos0[b]:
//   out[b,h,t] = softmax_s(mask(cap(scale * q[b,h,t] . k[b,h/g,s]))) . v[b,h/g,s]
// with GQA (g = H / n_kv), keys s < S, causal s <= pos0[b] + t, an optional
// sliding window s > pos0[b] + t - window and an optional softcap
// cap(z) = tanh(z / c) * c. The softmax runs online in f32; a row whose keys
// are all masked gets l = 0 -> 1 and writes zeros.
//
// What bounds it on the H100: at prefill sizes the operations (4·T·S·hd per
// head, halved by causality); K/V bytes are small and reread from L2.
//
// Two routes, by the inputs' type:
//
// bf16 - flash_prefill_wgmma_kernel, on the tensor cores. One block per
//   (query tile of BQ = 64 or 128 rows, head, batch row): one consumer
//   warpgroup per 64 query rows and a producer warp. The producer's lane 0
//   loads the Q tile once and walks the key tiles (BS = 8192 / hd keys: 128
//   at hd 64, 64 at hd 128, 32 at hd 256, so one K or V tile is 16 KB), each K and V tile
//   by TMA into a ring of kStages shared-memory stages under full / empty
//   mbarriers, in the 128-byte swizzle. The maps are 4-D over the strided
//   [B, heads, rows, hd] views and cut hd into boxes of 64 columns (one
//   128-byte swizzle row), so rows past T or S are zero-filled by the
//   hardware and never read the next head. Each consumer warpgroup, per tile:
//     S = Q . K^T   wgmma m64nBSk16, both operands K-major in shared memory
//                   (m64n32k16 at hd 256);
//     softmax       on the accumulator registers, in straight passes: the
//                   softcap (if any, in the log2 domain); the mask only on
//                   the tiles that need it (the causal diagonal, the ragged S
//                   edge, the window edge); the row max over the quad of
//                   lanes that holds a row; P = 2^(scale log2(e) (s - m)) in
//                   one FFMA and one MUFU.EX2; the online f32 max and sum.
//                   Masked entries are -1e30 and give P = 0, also while a
//                   row has seen no live key (its exponents are then taken
//                   against 0, not against its max of -1e30), so a tile
//                   wholly masked for a row adds nothing;
//     O += P . V    wgmma m64nHDk16 (m64n256k16 at hd 256, the largest N,
//                   its V descriptor spanning four 64-column boxes) with
//                   A = P from registers: the f32 S
//                   accumulator packed pairwise to bf16x2 is the A fragment
//                   of m64k16 as it stands; B = V as stored ([keys x hd],
//                   hd contiguous) through the transposed-B (MN-major)
//                   descriptor.
//   P is rounded to bf16 against its tile's running max before P . V, as
//   the TPU kernel does (p.astype(v.dtype)); ops/attention.py's
//   flash_prefill_tiled_plain is this rounding in plain PyTorch. Key tiles
//   above the causal bound or below the window are skipped. The query tile
//   is the largest that still gives every SM a block, and the last (heaviest
//   causal) query tiles are launched first. wgmma reads only the TMA tiles
//   from shared memory (P stays in registers), so no proxy fence is needed
//   there. Epilogue: O / l in bf16 into the warpgroup's own Q rows (free by
//   then), in the same swizzle, a proxy fence, and one TMA store a box into
//   the [B, T, H, hd] output: whole 128-byte rows instead of the accumulator
//   layout's scattered 4-byte pairs, and rows past T are dropped by the
//   hardware. Not yet: overlap of one tile's softmax with the next one's
//   products inside a warpgroup, setmaxnreg, persistent blocks.
//
// f32 - flash_prefill_kernel, on the CUDA cores (a perplexity window, held
//   to 2e-5 of the plain version; neither bf16 nor TF32 products can be).
//   One block of 4 warps per (query tile of 32 rows, head, batch row). Each
//   warp owns 8 query rows. The block walks key tiles of 32 keys staged in
//   shared memory (K transposed and padded, so that lane j reads key j
//   without bank conflicts), skipping tiles entirely above the causal bound
//   or below the window. Lane j scores key j for the warp's 8 rows; max and
//   sum are warp shuffles; each lane then accumulates hd/32 output
//   dimensions of P.V with P broadcast by shuffles.
//
// q, k, v and out take arbitrary batch/head/row strides with a unit stride on
// the last (head) dimension (the bf16 route: 16-byte aligned bases and
// strides, for TMA); hd is 64, 128 or 256; T and S need not be multiples of
// the tiles (the ragged edge is masked). At hd 256 a consumer thread holds
// 128 f32 of O, so the query tile is 64 rows and a block asks for no second
// one on its SM; the f32 route's shared memory (99 KB) is set by the same
// attribute as at 64 and 128.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr float kNegInf = -1e30f;

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

// ---- f32: flash_prefill_kernel, CUDA cores ------------------------------------

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBS = 32;                  // keys per tile (one per lane)

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + HD * (kBS + 1) + kBS * HD;
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     const int* __restrict__ pos0, int H, int n_kv, int Tq, int S,
                     long long q_sb, long long q_sh, long long q_st, long long k_sb,
                     long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, long long o_sb, long long o_sh, long long o_st,
                     float scale, float softcap, int window, int causal) {
  constexpr int DPL = HD / 32;  // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [kBQ][HD]
  float* Kt = Qs + kBQ * HD;          // [HD][kBS + 1]
  float* Vs = Kt + HD * (kBS + 1);    // [kBS][HD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / n_kv);
  const int p0 = pos0[b];

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    const int t = t0 + r;
    Qs[i] = t < Tq ? qb[t * q_st + d] : 0.0f;
  }

  // key range this query tile can see
  const int t_last = min(t0 + kBQ, Tq) - 1;
  int s_end = S;
  if (causal) s_end = min(S, p0 + t_last + 1);
  int s_begin = 0;
  if (window > 0) s_begin = max(0, p0 + t0 - window + 1);
  s_begin = (s_begin / kBS) * kBS;

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }
  const float* Qw = Qs + warp * kRows * HD;
  __syncthreads();

  for (int s0 = s_begin; s0 < s_end; s0 += kBS) {
    for (int i = tid; i < kBS * HD; i += kWarps * 32) {
      const int j = i / HD, d = i % HD;
      const int sp = s0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (sp < S) {
        kv = kb[sp * k_ss + d];
        vv = vb[sp * v_ss + d];
      }
      Kt[d * (kBS + 1) + j] = kv;
      Vs[j * HD + d] = vv;
    }
    __syncthreads();

    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k0 = Kt[(d + 0) * (kBS + 1) + lane];
      const float k1 = Kt[(d + 1) * (kBS + 1) + lane];
      const float k2 = Kt[(d + 2) * (kBS + 1) + lane];
      const float k3 = Kt[(d + 3) * (kBS + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * HD + d);
        sc[r] = fmaf(qv.x, k0, fmaf(qv.y, k1, fmaf(qv.z, k2, fmaf(qv.w, k3, sc[r]))));
      }
    }

    const int kpos = s0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = p0 + t0 + warp * kRows + r;
      float z = sc[r] * scale;
      if (softcap > 0.0f) z = tanhf(z / softcap) * softcap;
      const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      z = ok ? z : kNegInf;
      float mx = z;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p = ok ? expf(z - m_new) : 0.0f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      sc[r] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kBS; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = Vs[j * HD + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, sc[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
    __syncthreads();
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + warp * kRows + r;
    if (t < Tq) {
      const float inv = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) ob[t * o_st + lane + 32 * i] = acc[r][i] * inv;
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, const int* pos0, int B,
               int H, int n_kv, int Tq, int S, const long long* st, float scale, float softcap,
               int window, int causal, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), pos0, H, n_kv, Tq, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, softcap, window, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: flash_prefill_wgmma_kernel, TMA + mbarriers + wgmma ----------------

constexpr int kStages = 2;       // K/V ring depth
constexpr int kBoxCols = 64;     // hd columns per TMA box: one 128-byte swizzle row
constexpr int kRowBytes = 128;   // one row of a box in shared memory
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int BQ>
struct Wg {
  static constexpr int kBS = 8192 / HD;              // keys per tile
  static constexpr int kBoxes = HD / kBoxCols;       // boxes per Q, K or V tile
  static constexpr int kTileBytes = kBS * HD * 2;    // one K or V tile
  static constexpr int kQBytes = BQ * HD * 2;
  static constexpr int kConsumers = BQ / 64;         // warpgroups, 64 query rows each
  static constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
  static constexpr int kProducerWarp = 4 * kConsumers;
  // at hd 256 a consumer thread holds 128 f32 of O: no register cap for two blocks
  static constexpr int kMinBlocks = BQ == 64 && HD < 256 ? 2 : 1;
  // Q, the K ring, the V ring, then the q / full / empty barriers, plus slack
  // to align the tiles to 1024
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + (1 + 2 * kStages) * 8 + 1024;
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

// One box of a 4-D map: coordinates (column, row, head, batch row).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of shared memory out to a 4-D map, in the bulk async group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); the tile's base is 1024-aligned, and a
// k16 step within a 64-wide row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for an MN-major (transposed) B tile: rows of 128 bytes along N
// (64 bf16 of hd), one row per k (key). SBO is the step between groups of 8
// keys (1024 bytes); LBO the step to the next 64 columns of N, the next box.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
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

// d[64 x 32] (+)= A[64 x 16] . B[32 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers (four bf16x2 a thread), B
// MN-major in shared memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A from registers (four bf16x2 a thread), B
// MN-major in shared memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 256] (+)= A[64 x 16] . B[16 x 256], A from registers (four bf16x2 a thread), B
// MN-major in shared memory (the transposed-B form): hd 256's P . V, the largest N wgmma takes
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// 2^x in one MUFU.EX2 (subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD, int BQ>
__global__ void __launch_bounds__(Wg<HD, BQ>::kThreads, Wg<HD, BQ>::kMinBlocks)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap omap,
                           const int* __restrict__ pos0, int H, int n_kv, int Tq, int S,
                           float scale, float softcap, int window, int causal) {
  using C = Wg<HD, BQ>;
  constexpr int BS = C::kBS;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: tiles start 1024-aligned
  uint8_t* const qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const ks = qs + C::kQBytes;
  uint8_t* const vs = ks + kStages * C::kTileBytes;
  // qbar: Q landed; full[s]: K and V of stage s landed; empty[s]: every
  // consumer warp is done with stage s
  const uint32_t qbar = smem_u32(vs + kStages * C::kTileBytes);
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the last (heaviest) query tiles first
  const int kvh = h / (H / n_kv);
  const int p0 = pos0[b];
  // the key tiles this query tile can see, at multiples of BS from key 0
  const int t_last = min(t0 + BQ, Tq) - 1;
  const int s_end = causal ? min(S, p0 + t_last + 1) : S;
  const int s_begin = window > 0 ? max(0, p0 + t0 - window + 1) / BS * BS : 0;
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + BS - 1) / BS : 0;

  if (warp == C::kProducerWarp && lane == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&omap);
  }
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);  // the TMA lane's expect_tx
      mbar_init(empty0 + 8 * i, 4 * C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kProducerWarp) {
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, C::kQBytes);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
        tma_load_4d(smem_u32(qs + bx * BQ * kRowBytes), &qmap, bx * kBoxCols, t0, h, b, qbar);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages, lap = it / kStages;
        if (lap > 0) mbar_wait(empty0 + 8 * st, (lap - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const int s0 = s_begin + it * BS;
        mbar_arrive_expect_tx(full, 2 * C::kTileBytes);
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          const int off = st * C::kTileBytes + bx * BS * kRowBytes;
          tma_load_4d(smem_u32(ks + off), &kmap, bx * kBoxCols, s0, kvh, b, full);
          tma_load_4d(smem_u32(vs + off), &vmap, bx * kBoxCols, s0, kvh, b, full);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows 64 wg ..; this thread rows r, r + 8
  // (accumulator element 4j + 2i + e: row r + 8i, column 8j + 2 (lane % 4) + e)
  const int wg = warp >> 2;
  const int r = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int qpos = p0 + t0 + r;  // absolute positions qpos, qpos + 8
  const int col = 2 * (lane & 3);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float s[BS / 2];
  float acc[HD / 2];  // no zero fill: the first P . V overwrites it
  uint32_t pa[BS / 16][4];
  const bool capped = softcap > 0.0f;
  const float zscale = scale / softcap, zcap = softcap * kLog2e;
  // the exponents' units: z = zs s, with s the raw score or, under a softcap,
  // already log2(e) cap(scale q.k)
  const float zs = capped ? 1.0f : scale * kLog2e;
  const uint32_t qa = smem_u32(qs) + wg * 64 * kRowBytes;
  // the keys row qpos + 8 i sees: lo[i] < key <= hi[i]
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    hi[i] = causal ? min(S - 1, qpos + 8 * i) : S - 1;
    lo[i] = window > 0 ? qpos + 8 * i - window : -1;
  }

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(full0 + 8 * st, (it / kStages) & 1);
    const uint32_t kb = smem_u32(ks + st * C::kTileBytes);
    const uint32_t vb = smem_u32(vs + st * C::kTileBytes);

    // S = Q . K^T, hd in k16 steps: four a box, then the next box
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, kmajor_desc(qa + (kk >> 2) * BQ * kRowBytes + 32 * (kk & 3)),
               kmajor_desc(kb + (kk >> 2) * BS * kRowBytes + 32 * (kk & 3)), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);

    // the online softmax, in the log2 domain: z = log2(e) cap(scale q.k)
    if (capped) {
#pragma unroll
      for (int x = 0; x < BS / 2; ++x) s[x] = tanhf(s[x] * zscale) * zcap;
    }
    const int s0 = s_begin + it * BS;
    // the mask, only where a key of the tile lies past S, above the causal
    // bound or below the window for some row of the block
    if (s0 + BS > S || (causal && s0 + BS - 1 > p0 + t0) ||
        (window > 0 && s0 <= p0 + t_last - window)) {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int key = s0 + 8 * j + col + (x & 1), i = x >> 1;
          s[4 * j + x] = (key > lo[i]) & (key <= hi[i]) ? s[4 * j + x] : kNegInf;
        }
    }
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};  // by x = 2i + e: two chains a row
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) mx[x] = fmaxf(mx[x], s[4 * j + x]);
    float alpha[2], nbase[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float r = fmaxf(mx[2 * i], mx[2 * i + 1]);
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      const float m_new = fmaxf(m[i], r);
      alpha[i] = ex2((m[i] - m_new) * zs);
      m[i] = m_new;
      // a row that has seen no live key keeps m = -inf: its exponents are
      // taken against 0, so its masked entries give P = 0 and not 1
      nbase[i] = -(m_new == kNegInf ? 0.0f : m_new) * zs;
    }
    float ls[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        // z - max in one FFMA; a masked key gives ex2(-1e29) = 0
        const float p = ex2(fmaf(s[4 * j + x], zs, nbase[x >> 1]));
        s[4 * j + x] = p;
        ls[x] += p;
      }
    // this thread's share of each row's sum; the quad's add up at the end
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + (ls[2 * i] + ls[2 * i + 1]);
    // P to bf16: k16 chunk c of the S accumulator is the A fragment of m64k16
#pragma unroll
    for (int c = 0; c < BS / 16; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[c][x] = pack_bf16(s[8 * c + 2 * x], s[8 * c + 2 * x + 1]);
    if (it > 0) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[4 * j + x] *= alpha[x >> 1];
    }

    // O += P . V, keys in k16 steps of 16 rows (2048 bytes) of each V box
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BS / 16; ++c)
      wgmma_rs(acc, pa[c], mnmajor_desc(vb + c * 16 * kRowBytes, BS * kRowBytes), it > 0 || c > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(acc);
    fence_operands(pa);  // P's registers stay untouched until the products are done
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
  }
  // the output tile goes through shared memory, into this warpgroup's Q rows
  // (no longer read), in the 128-byte swizzle, and out by one TMA store a
  // box: full 128-byte rows, and rows past T are not written
  uint8_t* const ot = qs + wg * 64 * kRowBytes;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r - 64 * wg + 8 * i;  // row within the warpgroup's 64
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float a0 = n_tiles > 0 ? acc[4 * j + 2 * i] * inv[i] : 0.0f;
      const float a1 = n_tiles > 0 ? acc[4 * j + 2 * i + 1] * inv[i] : 0.0f;
      uint8_t* const row = ot + (j >> 3) * BQ * kRowBytes + rr * kRowBytes;
      *reinterpret_cast<uint32_t*>(row + ((((j & 7) ^ (rr & 7)) << 4) | (2 * col))) =
          pack_bf16(a0, a1);
    }
  }
  // generic stores, then the async proxy's reads of them (the TMA store)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's rows are in
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int bx = 0; bx < C::kBoxes; ++bx)
      tma_store_4d(&omap, smem_u32(ot + bx * BQ * kRowBytes), bx * kBoxCols, t0 + 64 * wg, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the block exits
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

// A 4-D bf16 map over a strided [batch, heads, rows, HD] view (element
// strides sb, sh, sr; unit stride on hd), box [1, 1, box_rows, 64] in the
// 128-byte swizzle; reads past a dimension's end are zero-filled, stores
// there dropped. A stride of
// a dimension of size 1 is never used: it is replaced by a packed one, so
// that any view takes a map.
bool encode_view(CUtensorMap* map, const void* ptr, int hd, int rows, int heads, int batch,
                 long long sr, long long sh, long long sb, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  long long st[3] = {sr, sh, sb};
  long long packed = hd;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = packed;
    packed = st[i] * static_cast<long long>(dims[i + 1]);
  }
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[0]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2};
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BQ>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, const int* pos0,
                         int B, int H, int n_kv, int Tq, int S, const long long* st, float scale,
                         float softcap, int window, int causal, cudaStream_t stream) {
  using C = Wg<HD, BQ>;
  // the views' addresses change with every call: maps per launch
  CUtensorMap qmap, kmap, vmap, omap;
  if (!encode_view(&qmap, q, HD, Tq, H, B, st[2], st[1], st[0], BQ) ||
      !encode_view(&kmap, k, HD, S, n_kv, B, st[5], st[4], st[3], C::kBS) ||
      !encode_view(&vmap, v, HD, S, n_kv, B, st[8], st[7], st[6], C::kBS) ||
      !encode_view(&omap, o, HD, Tq, H, B, st[11], st[10], st[9], 64))
    return cudaErrorInvalidValue;
  static uint32_t smem_set = 0;  // devices whose attribute is set (bit per device)
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(smem_set >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_wgmma_kernel<HD, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set |= 1u << dev;
  }
  // heads (and batch rows) fastest; query tiles slowest, the last ones first
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_prefill_wgmma_kernel<HD, BQ><<<grid, C::kThreads, C::kSmem, stream>>>(
      qmap, kmap, vmap, omap, pos0, H, n_kv, Tq, S, scale, softcap, window, causal);
  return cudaGetLastError();
}

// 128 query rows a block where that still gives every SM a block, else 64;
// at hd 256 always 64: with 128 rows (288 threads, at most 224 registers
// each) the 128 f32 of O a thread spilled (248 bytes, ptxas on sm_90a)
template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const int* pos0,
                        int B, int H, int n_kv, int Tq, int S, const long long* st, float scale,
                        float softcap, int window, int causal, cudaStream_t stream) {
  if constexpr (HD < 256) {
    if (static_cast<long long>((Tq + 127) / 128) * H * B >= sm_count())
      return launch_wgmma<HD, 128>(q, k, v, o, pos0, B, H, n_kv, Tq, S, st, scale, softcap,
                                   window, causal, stream);
  }
  return launch_wgmma<HD, 64>(q, k, v, o, pos0, B, H, n_kv, Tq, S, st, scale, softcap, window,
                              causal, stream);
}

}  // namespace

// strides: q (b, h, t), k (b, h, s), v (b, h, s), o (b, h, t), in elements.
// softcap <= 0: none; window <= 0: none. Returns the cudaError_t of the launch
// (1, cudaErrorInvalidValue, for arguments the kernels do not take, a bf16
// view that TMA cannot map among them).
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* o,
                             const void* pos0, int dtype, int B, int H, int n_kv, int Tq, int S,
                             int hd, long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                             long long o_st, float scale, float softcap, int window, int causal,
                             void* stream) {
  if (B <= 0 || H <= 0 || n_kv <= 0 || H % n_kv || Tq <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_st};
  const int* p0 = static_cast<const int*>(pos0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && hd == 64)
    return static_cast<int>(launch_bf16<64>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s));
  if (dtype == kBF16 && hd == 128)
    return static_cast<int>(launch_bf16<128>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s));
  if (dtype == kBF16 && hd == 256)
    return static_cast<int>(launch_bf16<256>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s));
  if (dtype == kF32 && hd == 64)
    return launch_f32<64>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s);
  if (dtype == kF32 && hd == 128)
    return launch_f32<128>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s);
  if (dtype == kF32 && hd == 256)
    return launch_f32<256>(q, k, v, o, p0, B, H, n_kv, Tq, S, st, scale, softcap, window, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
