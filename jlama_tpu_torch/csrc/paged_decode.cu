// K2: paged decode attention for Hopper (sm_90a), split over the keys.
//
// Replaces jlama_tpu/ops/pallas_attention.py:_paged_decode_kernel (launched
// by _paged_decode_jit), and with it the library paged_attention branch of
// jlama_tpu/nn/layers.py; it also takes the Engine's dense T = 1 attention,
// whose cache [B, n_kv, S, hd] is a pool of B pages of S slots to it.
// Computes, for one query token per batch row (T = 1) with GQA (g = H / n_kv
// query heads per KV head):
//   out[b, h] = sum_s p[s] v[s] / sum_s p[s],  p[s] = exp(z[s] - max z),
//   z[s] = cap(scale * q[b, h] . k[s])
// over the row's keys s < lengths[b] (and s >= lengths[b] - window with a
// window), read through the page table: key s lives in slot s % ps of page
// page_tables[b, s / ps]. cap(z) = tanh(z / c) * c when a softcap is given.
// Scores, running max, sum, probabilities and accumulator are f32. As in the
// TPU kernel, q8 values are dequantized (int8 times the f32 scale of their
// block of blk) and rounded to bf16 before the dots; unlike it, the
// probabilities stay f32 when they multiply V (on the tensor cores as two
// bf16 halves, 16 bits short of f32; the TPU kernel rounds them to the pool's
// value type, which ties the result to the running max). A row with no live
// key writes zeros.
//
// What bounds it on the H100: the live K/V bytes, each read once (26 MB for
// 16 ragged serving rows at Llama-3.2-1B's shapes: 7.8 us at 3.35 TB/s). The
// operations, 4 g hd per key, are far below the tensor cores' rate; as f32
// FMAs on the CUDA cores, with the loads and conversions around them, they
// were what a block spent most of its time on (k2_ablate's trace).
//
// Design (flash-decoding):
// - The keys are split over blocks. A block takes one (key split, KV head
//   with up to 16 or 32 of its query rows, batch row); the grid is sized
//   from the static shapes only (page_tables.shape[1] * ps keys, cut by the
//   caller to its window; paged_decode_plan), and a block whose split holds
//   none of its row's live keys returns at once, so the host never reads
//   the lengths.
// - All query rows of a KV head share a block, so each K/V tile is read once
//   per KV head, MQA's 32 rows included.
// - 64-key K and V tiles stream through a ring of 2 shared-memory stages by
//   16-byte cp.async in the pool's own type (bf16, f32, or int8 with its f32
//   scales), the 16-byte units XOR-swizzled so that the readers are free of
//   bank conflicts; each thread copies a fixed column of a few keys, whose
//   page lookups (up to 8 tiles' worth) are loaded at the block's start in
//   flight with the row's length. V rows outside the live keys are zeros.
// - Each warp owns 16 keys of every tile and keeps its own online softmax,
//   so the only block barrier of a tile is the ring's. bf16 q on a bf16 or
//   q8 pool takes the tensor cores: mma.sync m16n8k16 computes S = Q K^T
//   (q's rows as the A operand from registers, K by ldmatrix; bf16 products
//   are exact in f32), the softmax runs on the S fragments in log2 units,
//   and O += P V takes P from the same registers, split into bf16 high and
//   low halves so that P keeps 16 more bits (V by ldmatrix.trans; a q8 tile
//   is first converted to bf16 in shared memory). f32 q or an f32 pool takes
//   the CUDA cores (f32 FMAs, q as f32 in shared memory), held to 2e-5.
// - The warps' partials combine in warp order; a split writes its (m, l,
//   acc) in f32 to the wrapper's scratch, and the last block of its (row,
//   KV head, row group) to take a ticket (an atomic count in the wrapper's
//   ticket buffer) merges the live splits in split order, writes the output
//   and resets the ticket to 0. The merge's order does not depend on which
//   block comes last, so a repeat is equal bit for bit. A row whose live
//   keys lie in one split writes its output at once.
// q takes any (b, h) strides; the pools any (h, page, slot) strides that
// are multiples of 16 bytes, with a unit stride along hd, so a layer's slice
// of the stacked pool and the dense cache's (window-cut) view are read in
// place. hd is 64, 128 or 256; g is any divisor of H; q8 blocks are
// multiples of 16 dividing hd.
// At hd 256 (Gemma, Gemma 2) the tensor-core route keeps q in shared memory
// as bf16 and loads its A fragments by ldmatrix at each k-step (in registers
// they would take 64 more a thread beside the 128 of the output fragments),
// and an f32 pool's 64 KB tiles leave room for one stage only: its copies
// then wait for the tile before it has been read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum QType { kQF32 = 0, kQBF16 = 1 };
enum PoolKind { kPoolF32 = 0, kPoolBF16 = 1, kPoolQ8 = 2 };

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTK = 64;          // keys per tile
constexpr int kKW = kTK / kWarps;  // keys of a tile a warp owns: two lanes a key
constexpr int kMaxG = 32;        // query rows per block
constexpr int kBlocksPerSM = 8;  // what the split aims for, were every row full
constexpr int kMaxSplits = 64;   // splits of a row at most (the merge's weights)
constexpr int kMergeRows = 256;  // splits x query rows one merge reads at most
constexpr int kLk = 8;           // tiles whose page lookups a block holds
// a split's tiles at least, once the (row, KV head) pairs fill a quarter of
// the SMs: a merge costs about as much as a few tiles (k2_ablate)
constexpr int kMinSplitTiles = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  long long q_b, q_h;
  void* out;
  long long o_b, o_h;
  const void* k;
  const void* v;
  long long k_h, k_p, k_s, v_h, v_p, v_s;
  const float* ks;
  const float* vs;
  long long ks_h, ks_p, ks_s, vs_h, vs_p, vs_s;
  const int* pt;
  long long pt_b;
  int P;
  const int* lengths;
  int H, n_kv, ps, blk;
  float scale, softcap;
  int window;
  int q_type;
  float* part;   // [B, n_kv * n_grp, n_splits] entries of (acc [GM, hd], m [GM], l [GM])
  int* tickets;  // [B, n_kv * n_grp], 0 between calls
  int n_splits, split_keys, n_grp;
};

template <int KIND>
constexpr int elem_bytes() {
  return KIND == kPoolF32 ? 4 : KIND == kPoolBF16 ? 2 : 1;
}

template <int KIND, int HD, int GM, bool TC>
struct Cfg {
  static constexpr int kEB = elem_bytes<KIND>();
  static constexpr int kE = 16 / kEB;                  // elements of a 16-byte unit
  static constexpr int kUnits = HD / kE;               // units of one key's row
  static constexpr int kTileBytes = kTK * HD * kEB;    // one K or V tile
  static constexpr int kSMax = KIND == kPoolQ8 ? HD / 16 : 0;  // scales of a key
  static constexpr int kScaleBytes = kTK * kSMax * 4;
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kScaleBytes;
  // more blocks an SM beat a deeper ring (k2_ablate); an f32 pool at hd 256
  // (64 KB a tile) fits one stage
  static constexpr int kStages = 4 * kTileBytes <= 160 * 1024 ? 2 : 1;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kQHalf = HD / 2 + 4;  // half a q row, off the other half's banks
  static constexpr int kQRow = 2 * kQHalf;
  static constexpr int kQPT = (GM * HD + kThreads - 1) / kThreads;  // q values a thread stages
  // the tensor-core route keeps q's A fragments in registers, at hd 256 in
  // shared memory as bf16 rows of kQSRow bytes (16 bytes of padding put the
  // 8 rows an ldmatrix phase reads on 8 different bank groups)
  static constexpr bool kQS = TC && HD == 256;
  static constexpr int kQSRow = HD * 2 + 16;
  static constexpr int kQFloats = TC ? (kQS ? GM * kQSRow / 4 : 0) : GM * kQRow;
  static constexpr int kMT = GM / 16;                   // tensor-core route: 16-row tiles of q
  static constexpr int kBTile = kTK * HD * 2;           // a K or V tile in bf16
  // tensor-core route, q8 pool: the tile's K and V converted to bf16 for ldmatrix
  static constexpr int kCvtBytes = TC && KIND == kPoolQ8 ? 2 * kBTile : 0;
  static constexpr int kNC = HD / 8;             // P.V: chunks of 8 dims
  static constexpr int kIPL = (GM * kNC + 31) / 32;  // P.V: (row, chunk) items a lane
  // after the ring: q, each warp's scores [GM][kKW] and (m, l, alpha) [3][GM],
  // the warps' weights [kWarps][GM], the block's (m, l) [2][GM], a flag, the
  // tiles' page lookups [kLk][kTK]
  static constexpr int kSmem = kRing + kCvtBytes +
      (kQFloats + kWarps * GM * kKW + kWarps * 3 * GM + kWarps * GM + 2 * GM + 4) * 4 +
      kLk * kTK * 8;
  static constexpr int kEntry = GM * HD + 2 * GM;  // floats of a split's partial
  // after the last tile the ring holds the block's sum [GM][HD], then the
  // merge's per-split maxima (as weights); the warps' scores its sums
  static_assert((GM * HD + kMaxSplits * GM) * 4 <= kRing && kMaxSplits <= kWarps * kKW,
                "merge buffers");
  static constexpr int kNO = (GM * HD / 4 + kThreads - 1) / kThreads;  // merge: float4s a thread
  static constexpr int kMB = kNO >= 4 ? 16 / kNO : 8;                 // merge: splits a batch
};

__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 7); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
// with src-size 0: the 16 (4) bytes are zeros and nothing is read
__device__ __forceinline__ void cp_async16_zero(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async4_zero(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, 0;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the tensor-core route keeps its maxima in log2 units (exp2); the CUDA-core
// route, held to 2e-5, in natural ones (expf)
template <bool TC>
__device__ __forceinline__ float ex(float x) {
  return TC ? exp2f(x) : expf(x);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float s8(uint32_t w, int k) {
  return static_cast<float>(static_cast<signed char>((w >> (8 * k)) & 0xffu));
}

// one 16-byte unit in shared memory as f32: 4 (f32), 8 (bf16) or 16 (q8,
// each int8 times sc, rounded to bf16) values
template <int KIND>
__device__ __forceinline__ void unit_f32(const unsigned char* p, float sc, float* x) {
  if constexpr (KIND == kPoolF32) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (KIND == kPoolBF16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_lo(w[i]);
      x[2 * i + 1] = bf16_hi(w[i]);
    }
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) x[4 * i + k] = round_bf16(s8(w[i], k) * sc);
  }
}

// dims [8c, 8c + 8) of key j of a V tile as f32
template <int KIND, int U>
__device__ __forceinline__ void chunk8_f32(const unsigned char* tile, int j, int c, float sc,
                                           float* x) {
  if constexpr (KIND == kPoolBF16) {
    unit_f32<KIND>(tile + swz(j * U + c) * 16, 0.0f, x);
  } else if constexpr (KIND == kPoolF32) {
    unit_f32<KIND>(tile + swz(j * U + 2 * c) * 16, 0.0f, x);
    unit_f32<KIND>(tile + swz(j * U + 2 * c + 1) * 16, 0.0f, x + 4);
  } else {
    const uint2 v =
        *reinterpret_cast<const uint2*>(tile + swz(j * U + (c >> 1)) * 16 + (c & 1) * 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = round_bf16(s8(v.x, k) * sc);
      x[4 + k] = round_bf16(s8(v.y, k) * sc);
    }
  }
}

__device__ __forceinline__ void store_out(const Args& a, long long idx, float v) {
  if (a.q_type == kQBF16)
    static_cast<__nv_bfloat16*>(a.out)[idx] = __float2bfloat16(v);
  else
    static_cast<float*>(a.out)[idx] = v;
}

template <int KIND, int HD, int GM, bool TC>
__global__ void __launch_bounds__(kThreads, TC && GM == 16 && HD == 64 ? 4 : 1)
    paged_decode_split_kernel(Args a) {
  using C = Cfg<KIND, HD, GM, TC>;
  constexpr int U = C::kUnits;
  constexpr int MT = C::kMT;
  constexpr int U16 = HD / 8;  // bf16 units of a key's row
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* cvt = smem + C::kRing;                                 // [2][kTK][HD] bf16
  float* q_s = reinterpret_cast<float*>(smem + C::kRing + C::kCvtBytes);  // [GM][2][kQHalf]
  float* pw_all = q_s + C::kQFloats;                      // [kWarps][GM][kKW]
  float* st_all = pw_all + kWarps * GM * kKW;             // [kWarps][3][GM]: m, l, alpha
  float* cw_s = st_all + kWarps * 3 * GM;                 // [kWarps][GM]
  float* bm_s = cw_s + kWarps * GM;                       // [GM]: the block's max
  float* bl_s = bm_s + GM;                                // [GM]: the block's sum
  int* flag_s = reinterpret_cast<int*>(bl_s + GM);
  int2* pk_s = reinterpret_cast<int2*>(flag_s + 4);       // [kLk][kTK] (page, slot)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / a.n_grp;
  const int grp = blockIdx.y % a.n_grp;
  const int b = blockIdx.z;
  const int group = a.H / a.n_kv;
  const int h0 = kvh * group + grp * GM;        // the block's first query head
  const int G = min(GM, group - grp * GM);      // its query rows
  const int* ptb = a.pt + b * a.pt_b;
  const int len = a.lengths[b];

  // in flight with the length: the page lookups of the split's first kLk
  // tiles (keys from the split's start; a window that starts later redoes
  // them) and the q rows
  const int n_keys = a.P * a.ps;
  auto lookup = [&](int key) -> int2 {
    return key < n_keys ? make_int2(ptb[key / a.ps], key % a.ps) : make_int2(-1, 0);
  };
  const int t0 = split * (a.split_keys / kTK);
  constexpr int kLkPT = kLk * kTK / kThreads;  // lookups a thread: key tid % kTK of tiles
  int2 lk[kLkPT];
#pragma unroll
  for (int i = 0; i < kLkPT; ++i)
    lk[i] = lookup((t0 + (tid + i * kThreads) / kTK) * kTK + tid % kTK);
  const long long q_base = b * a.q_b + static_cast<long long>(h0) * a.q_h;
  // CUDA-core route: q values to stage as f32; tensor-core route: q's A
  // fragments (rows g and g + 8 of each 16-row tile, dims 2t, 2t + 1 and
  // + 8 of each 16-dim step; rows past G are zeros), at hd 256 staged in
  // shared memory below instead
  constexpr bool QR = TC && !C::kQS;  // q's A fragments in registers
  float qv[TC ? 1 : C::kQPT];
  uint32_t qa[QR ? MT : 1][QR ? HD / 16 : 1][4];
  if constexpr (QR) {
    const unsigned short* qh = static_cast<const unsigned short*>(a.q);
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = 16 * mt + g8 + 8 * (x & 1), d = 16 * ks + 2 * t4 + 8 * (x >> 1);
          const long long qi = q_base + r * a.q_h + d;
          qa[mt][ks][x] = r < G ? static_cast<uint32_t>(qh[qi]) |
                                      (static_cast<uint32_t>(qh[qi + 1]) << 16)
                                : 0u;
        }
  } else if constexpr (!TC) {
#pragma unroll
    for (int i = 0; i < C::kQPT; ++i) {
      const int e = tid + i * kThreads;
      const long long qi = q_base + (e / HD) * a.q_h + e % HD;
      qv[i] = e >= G * HD ? 0.0f
              : a.q_type == kQBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                                   : static_cast<const float*>(a.q)[qi];
    }
  }

  const int hi = min(len, n_keys);  // live keys: [lo, hi)
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  const bool any = lo < hi;
  const int s_first = any ? lo / a.split_keys : 0;
  const int s_last = any ? (hi - 1) / a.split_keys : 0;
  if (split < s_first || split > s_last) return;
  const long long o_base = b * a.o_b + static_cast<long long>(h0) * a.o_h;
  if (!any) {  // split 0 of a row with no live key
    for (int o = tid; o < G * HD; o += kThreads)
      store_out(a, o_base + (o / HD) * a.o_h + o % HD, 0.0f);
    return;
  }
  const int n_live = s_last - s_first + 1;
  const int k_begin = max(lo, split * a.split_keys);
  const int k_end = min(hi, (split + 1) * a.split_keys);
  const int t_begin = k_begin / kTK;  // tiles from key 0; a split is whole tiles
  const int n_t = (k_end + kTK - 1) / kTK - t_begin;

  const long long k_head = kvh * a.k_h, v_head = kvh * a.v_h;
  const long long ks_head = kvh * a.ks_h, vs_head = kvh * a.vs_h;
  const int ns = HD / a.blk;  // q8 scales of a key

  // (page, slot) of key j of local tile lt, (-1, 0) outside the split's
  // live keys
  auto live_lookup = [&](int lt, int j, int2 got) -> int2 {
    const int key = (t_begin + lt) * kTK + j;
    return lt < n_t && key >= k_begin && key < k_end ? got : make_int2(-1, 0);
  };
  // local tile lt into stage lt % kStages, from its lookups: a thread
  // copies 16-byte unit tid % U of keys tid / U + n * (kThreads / U), of K
  // and of V (zeros for V outside the split: the tensor cores multiply P = 0
  // by it)
  const unsigned char* kbase = static_cast<const unsigned char*>(a.k) + k_head * C::kEB;
  const unsigned char* vbase = static_cast<const unsigned char*>(a.v) + v_head * C::kEB;
  auto issue = [&](int lt) {
    constexpr int KPI = kThreads / U;  // keys an instruction covers
    unsigned char* st = ring + (lt % C::kStages) * C::kStageBytes;
    const int2* lkt = pk_s + (lt % kLk) * kTK;
    const int c = tid % U;
#pragma unroll
    for (int n = 0; n < kTK / KPI; ++n) {
      const int j = tid / U + n * KPI;
      const int2 ps = lkt[j];
      const uint32_t dk = smem_u32(st + swz(j * U + c) * 16);
      if (ps.x >= 0) {
        const long long pg = ps.x, sl = ps.y;
        cp_async16(dk, kbase + (pg * a.k_p + sl * a.k_s) * C::kEB + c * 16);
        cp_async16(dk + C::kTileBytes, vbase + (pg * a.v_p + sl * a.v_s) * C::kEB + c * 16);
      } else {
        cp_async16_zero(dk + C::kTileBytes, a.v);
      }
    }
    if constexpr (KIND == kPoolQ8) {
      float* sc = reinterpret_cast<float*>(st + 2 * C::kTileBytes);  // [2][kTK][kSMax]
      for (int i = tid; i < kTK * ns; i += kThreads) {
        const int j = i / ns, e = i % ns;
        const int2 ps = lkt[j];
        const uint32_t dk = smem_u32(sc + j * C::kSMax + e);
        if (ps.x >= 0) {
          const long long pg = ps.x, sl = ps.y;
          cp_async4(dk, a.ks + ks_head + pg * a.ks_p + sl * a.ks_s + e);
          cp_async4(dk + kTK * C::kSMax * 4, a.vs + vs_head + pg * a.vs_p + sl * a.vs_s + e);
        } else {
          cp_async4_zero(dk + kTK * C::kSMax * 4, a.vs);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kLkPT; ++i) {
    const int lt = (tid + i * kThreads) / kTK, j = tid % kTK;
    if (t_begin != t0) lk[i] = lookup((t_begin + lt) * kTK + j);  // a window's first split
    pk_s[lt * kTK + j] = live_lookup(lt, j, lk[i]);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_t) issue(s);
    cp_commit();
  }
  // q as f32, each half of hd padded apart; the warps' running (m, l)
  if constexpr (!TC) {
#pragma unroll
    for (int i = 0; i < C::kQPT; ++i) {
      const int e = tid + i * kThreads;
      if (e < GM * HD) {
        const int r = e / HD, d = e % HD;
        q_s[r * C::kQRow + (d / (HD / 2)) * C::kQHalf + d % (HD / 2)] = qv[i];
      }
    }
  }
  if constexpr (C::kQS) {  // q as bf16 rows of kQSRow bytes; rows past G zeros
    const unsigned short* qh = static_cast<const unsigned short*>(a.q);
    unsigned short* qs16 = reinterpret_cast<unsigned short*>(q_s);
    for (int e = tid; e < GM * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      qs16[r * (C::kQSRow / 2) + d] = r < G ? qh[q_base + r * a.q_h + d] : 0;
    }
  }
  float* pw = pw_all + warp * GM * kKW;  // this warp's scores, then probabilities
  float* m_w = st_all + warp * 3 * GM;   // this warp's running max, sum, rescale
  float* l_w = m_w + GM;
  float* al_w = l_w + GM;
  for (int r = lane; r < GM; r += 32) {
    m_w[r] = kNegInf;
    l_w[r] = 0.0f;
  }

  // P.V: lane items (row, chunk of 8 dims); with fewer items than lanes,
  // KS key subsets of the warp's keys, summed by a butterfly at the end
  const int n_items = G * C::kNC;
  const int KS = n_items >= 32 ? 1 : 32 / n_items;
  const int pks = n_items >= 32 ? 0 : lane / n_items;
  const bool pv_on = pks < KS;
  auto item_of = [&](int i) {  // lane's item i; n_items where it has none
    return n_items >= 32 ? lane + 32 * i : i == 0 ? lane % n_items : n_items;
  };
  float acc[TC ? 1 : C::kIPL][8];
#pragma unroll
  for (int i = 0; i < (TC ? 1 : C::kIPL); ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  // tensor-core route: the output fragments and each of the lane's rows'
  // running (m, l) (rows g, g + 8 of each 16-row tile; a quad shares a row)
  float o[TC ? MT : 1][TC ? HD / 8 : 1][4];
  float m_r[TC ? MT : 1][2], l_r[TC ? MT : 1][2];
#pragma unroll
  for (int mt = 0; mt < (TC ? MT : 1); ++mt) {
#pragma unroll
    for (int nd = 0; nd < (TC ? HD / 8 : 1); ++nd)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[mt][nd][x] = 0.0f;
    m_r[mt][0] = m_r[mt][1] = kNegInf;
    l_r[mt][0] = l_r[mt][1] = 0.0f;
  }

  for (int it = 0; it < n_t; ++it) {
    if constexpr (C::kStages == 1) {  // the one stage, once its last tile is read
      __syncthreads();
      issue(it);
      cp_commit();
      cp_wait<0>();
    } else {
      cp_wait<C::kStages - 2>();
    }
    __syncthreads();  // tile it has landed; the stage refilled below is free
    if constexpr (C::kStages > 1) {
      const int nx = it + C::kStages - 1;
      if (nx < n_t) issue(nx);
      cp_commit();
    }
    // a split of more than kLk tiles: the lookups of local tile it + kLk,
    // loaded now, kept after P.V
    const bool roll = tid < kTK && it + kLk < n_t;
    const int2 next_lk =
        roll ? live_lookup(it + kLk, tid, lookup((t_begin + it + kLk) * kTK + tid))
             : make_int2(-1, 0);
    const unsigned char* st = ring + (it % C::kStages) * C::kStageBytes;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * C::kTileBytes);
    const float* vsc = ksc + kTK * C::kSMax;
    const int key0 = (t_begin + it) * kTK;
    // this warp's keys of the tile: [warp * kKW, warp * kKW + kKW), live [j_lo, j_hi)
    const int j_lo = max(k_begin - key0, warp * kKW);
    const int j_hi = min(k_end - key0, warp * kKW + kKW);

    if constexpr (TC && KIND == kPoolQ8) {
      // the tile's K and V as bf16 (int8 times its scale, rounded), by all threads
      for (int i = tid; i < 2 * kTK * U16; i += kThreads) {
        const int kv = i / (kTK * U16), r = i % (kTK * U16);
        const int j = r / U16, c = r % U16;
        float x[8];
        chunk8_f32<KIND, U>(st + kv * C::kTileBytes, j, c,
                            ksc[(kv * kTK + j) * C::kSMax + (c * 8) / a.blk], x);
        uint4 w;
        w.x = pack_bf16(x[0], x[1]);
        w.y = pack_bf16(x[2], x[3]);
        w.z = pack_bf16(x[4], x[5]);
        w.w = pack_bf16(x[6], x[7]);
        *reinterpret_cast<uint4*>(cvt + kv * C::kBTile + swz(j * U16 + c) * 16) = w;
      }
      __syncthreads();
    }

    if constexpr (TC) {
      if (j_lo < j_hi) {
        const unsigned char* kt = KIND == kPoolQ8 ? cvt : st;  // bf16 K tile, then V
        const unsigned char* vt = kt + (KIND == kPoolQ8 ? C::kBTile : C::kTileBytes);
        const int g8 = lane >> 2, t4 = lane & 3, kb = warp * kKW;
        // S = Q K^T over the warp's 16 keys: two n8 tiles a 16-row tile
        float sf[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int x = 0; x < 8; ++x) sf[mt][x >> 2][x & 3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t kf[4];  // keys kb..+7 dims 16ks..+7, +8..15; keys kb+8..+15 the same
          ldsm_x4(smem_u32(kt + swz((kb + (lane & 7) + ((lane >> 4) << 3)) * U16 + 2 * ks +
                                    ((lane >> 3) & 1)) * 16), kf);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (C::kQS) {
              // rows 16 mt + (lane & 15), dims 16 ks + 8 (lane >> 4) ..: the
              // A fragment's four 8 x 8 matrices
              uint32_t af[4];
              ldsm_x4(smem_u32(reinterpret_cast<const unsigned char*>(q_s) +
                               (16 * mt + (lane & 15)) * C::kQSRow + (2 * ks + (lane >> 4)) * 16),
                      af);
              mma_bf16(sf[mt][0], af, kf[0], kf[1]);
              mma_bf16(sf[mt][1], af, kf[2], kf[3]);
            } else {
              mma_bf16(sf[mt][0], qa[mt][ks], kf[0], kf[1]);
              mma_bf16(sf[mt][1], qa[mt][ks], kf[2], kf[3]);
            }
          }
        }
        // the online softmax of the lane's rows over the warp's keys (a quad)
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const bool row = 16 * mt + g8 + 8 * hr < G;
            float z[4];
            bool ok[4];
            float mx = kNegInf;
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int j = kb + 8 * (x >> 1) + 2 * t4 + (x & 1);
              float v = sf[mt][x >> 1][2 * hr + (x & 1)] * a.scale;
              if (a.softcap > 0.0f) v = tanhf(v / a.softcap) * a.softcap;
              z[x] = v * kLog2e;
              ok[x] = row && j >= j_lo && j < j_hi;
              // the max in z's own (log2) units: the probabilities then stay
              // <= 1 (a max of the natural scores left exp2(0.44 max) in P,
              // which overflowed past scores of ~285)
              mx = fmaxf(mx, ok[x] ? z[x] : kNegInf);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_r[mt][hr], mx);
            const float alpha = exp2f(m_r[mt][hr] - m_new);
            float sum = 0.0f;
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const float pv = ok[x] ? exp2f(z[x] - m_new) : 0.0f;
              sf[mt][x >> 1][2 * hr + (x & 1)] = pv;
              sum += pv;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l_r[mt][hr] = l_r[mt][hr] * alpha + sum;
            m_r[mt][hr] = m_new;
            if (alpha != 1.0f) {
#pragma unroll
              for (int nd = 0; nd < HD / 8; ++nd) {
                o[mt][nd][2 * hr] *= alpha;
                o[mt][nd][2 * hr + 1] *= alpha;
              }
            }
          }
          // P as the A operand (the S fragments' layout), split into bf16
          // high and low halves so that P stays f32 to 2^-16
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float p0 = sf[mt][x >> 1][2 * (x & 1)], p1 = sf[mt][x >> 1][2 * (x & 1) + 1];
            ph[mt][x] = pack_bf16(p0, p1);
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&ph[mt][x]);
            pl[mt][x] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
          }
        }
        // O += P V: V fragments transposed from the [key][dim] tile
#pragma unroll
        for (int nd2 = 0; nd2 < HD / 16; ++nd2) {
          uint32_t vf[4];  // dims 16nd2..+7 keys kb..+7, kb+8..+15; dims +8..15 the same
          ldsm_x4_t(smem_u32(vt + swz((kb + (lane & 7) + (((lane >> 3) & 1) << 3)) * U16 +
                                      2 * nd2 + (lane >> 4)) * 16), vf);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * nd2], ph[mt], vf[0], vf[1]);
            mma_bf16(o[mt][2 * nd2], pl[mt], vf[0], vf[1]);
            mma_bf16(o[mt][2 * nd2 + 1], ph[mt], vf[2], vf[3]);
            mma_bf16(o[mt][2 * nd2 + 1], pl[mt], vf[2], vf[3]);
          }
        }
      }
    } else if (j_lo < j_hi) {
      // scores: lanes (key j, half hf) dot key j's half with every row
      const int j = warp * kKW + (lane >> 1), hf = lane & 1;
      float dot[GM];
#pragma unroll
      for (int r = 0; r < GM; ++r) dot[r] = 0.0f;
#pragma unroll
      for (int cu = 0; cu < U / 2; ++cu) {
        const int c = hf * (U / 2) + cu;
        float x[C::kE];
        const float sc = KIND == kPoolQ8 ? ksc[j * C::kSMax + (c * C::kE) / a.blk] : 0.0f;
        unit_f32<KIND>(st + swz(j * U + c) * 16, sc, x);
#pragma unroll
        for (int r = 0; r < GM; ++r) {
          if (r < G) {
            const float* qr = q_s + r * C::kQRow + hf * C::kQHalf + cu * C::kE;
#pragma unroll
            for (int e = 0; e < C::kE; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + e);
              dot[r] = fmaf(qq.x, x[e], dot[r]);
              dot[r] = fmaf(qq.y, x[e + 1], dot[r]);
              dot[r] = fmaf(qq.z, x[e + 2], dot[r]);
              dot[r] = fmaf(qq.w, x[e + 3], dot[r]);
            }
          }
        }
      }
      const bool live = j >= j_lo && j < j_hi;
#pragma unroll
      for (int r = 0; r < GM; ++r) {
        if (r < G) {
          const float d = dot[r] + __shfl_xor_sync(0xffffffffu, dot[r], 1);
          if ((r & 1) == hf) {
            float z = d * a.scale;
            if (a.softcap > 0.0f) z = tanhf(z / a.softcap) * a.softcap;
            pw[r * kKW + (lane >> 1)] = live ? z : kNegInf;
          }
        }
      }
      __syncwarp();

      // the warp's online softmax: a half-warp per row, a lane per key
      {
        const int hw = lane >> 4, jj = lane & 15;
        const bool ok = warp * kKW + jj >= j_lo && warp * kKW + jj < j_hi;
        for (int r0 = 0; r0 < G; r0 += 2) {
          const int r = r0 + hw;
          const bool row = r < G;
          const float z = row ? pw[r * kKW + jj] : kNegInf;
          float mx = ok ? z : kNegInf;
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_old = row ? m_w[r] : kNegInf;
          const float m_new = fmaxf(m_old, mx);
          const float p = ok && row ? expf(z - m_new) : 0.0f;
          float sum = p;
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (row) {
            pw[r * kKW + jj] = p;
            if (jj == 0) {
              const float alpha = expf(m_old - m_new);
              l_w[r] = l_w[r] * alpha + sum;
              m_w[r] = m_new;
              al_w[r] = alpha;
            }
          }
        }
      }
      __syncwarp();

      // P.V over the warp's live keys of the tile
      if (pv_on) {
        const unsigned char* vt = st + C::kTileBytes;
#pragma unroll
        for (int i = 0; i < C::kIPL; ++i) {
          const int item = item_of(i);
          if (item < n_items) {
            const float al = al_w[item / C::kNC];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i][e] *= al;
          }
        }
#pragma unroll 2
        for (int j = j_lo + pks; j < j_hi; j += KS) {
          const float* pj = pw + (j - warp * kKW);
#pragma unroll
          for (int i = 0; i < C::kIPL; ++i) {
            const int item = item_of(i);
            if (item < n_items) {
              const int r = item / C::kNC, c = item % C::kNC;
              float x[8];
              const float sc = KIND == kPoolQ8 ? vsc[j * C::kSMax + (c * 8) / a.blk] : 0.0f;
              chunk8_f32<KIND, U>(vt, j, c, sc, x);
              const float p = pj[r * kKW];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p, x[e], acc[i][e]);
            }
          }
        }
      }
    }
    // tile it's lookups were used when it was issued
    if (roll) pk_s[(it % kLk) * kTK + tid] = next_lk;
  }

  // the warps' key subsets, then the warps in order: the block's max, sum
  // and weights, and its sum [G][HD] in red
  if (!TC && KS > 1) {
#pragma unroll
    for (int i = 0; i < C::kIPL; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        for (int o = n_items; o < 32; o <<= 1)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
  }
  if constexpr (TC) {  // the lane's rows' (m, l), from one lane of each quad
    if ((lane & 3) == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * mt + (lane >> 2) + 8 * hr;
          m_w[r] = m_r[mt][hr];
          l_w[r] = l_r[mt][hr];
        }
    }
  }
  cp_wait<0>();
  __syncthreads();
  for (int r = tid; r < G; r += kThreads) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, st_all[w * 3 * GM + r]);
    float l = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex<TC>(st_all[w * 3 * GM + r] - m);
      l += st_all[w * 3 * GM + GM + r] * c;
      cw_s[w * GM + r] = c;
    }
    bm_s[r] = m;
    bl_s[r] = l;
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [G][HD]
  if constexpr (TC) {
    // each warp's outputs times its weight into its own buffer [GM][HD]
    // (the ring and the bf16 tiles after it), then their sum in warp order
    // into red, the first buffer
    static_assert(kWarps * GM * HD * 4 <= C::kRing + C::kCvtBytes, "warp buffers");
    float* wb = red + warp * GM * HD;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * mt + (lane >> 2) + 8 * hr;
        if (r < G) {
          const float c = cw_s[warp * GM + r];
#pragma unroll
          for (int nd = 0; nd < HD / 8; ++nd)
            *reinterpret_cast<float2*>(wb + r * HD + nd * 8 + 2 * (lane & 3)) =
                make_float2(o[mt][nd][2 * hr] * c, o[mt][nd][2 * hr + 1] * c);
        }
      }
    __syncthreads();
    for (int i = tid; i < G * HD; i += kThreads) {
      float x = red[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += red[w * GM * HD + i];
      red[i] = x;
    }
    __syncthreads();
  } else {
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w && pks == 0) {
#pragma unroll
        for (int i = 0; i < C::kIPL; ++i) {
          const int item = item_of(i);
          if (item < n_items) {
            const int r = item / C::kNC;
            const float c = cw_s[w * GM + r];
            float* dst = red + r * HD + (item % C::kNC) * 8;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dst[e] = w == 0 ? acc[i][e] * c : fmaf(acc[i][e], c, dst[e]);
          }
        }
      }
      __syncthreads();
    }
  }

  if (n_live == 1) {  // the row's only split: the output at once
    for (int o = tid; o < G * HD; o += kThreads)
      store_out(a, o_base + (o / HD) * a.o_h + o % HD, red[o] / bl_s[o / HD]);
    return;
  }

  // this split's partial, then a ticket; the last block merges
  const int tb = b * gridDim.y + blockIdx.y;
  float* mine = a.part + (static_cast<long long>(tb) * a.n_splits + split) * C::kEntry;
  for (int o = tid; o < G * HD; o += kThreads) mine[o] = red[o];
  for (int r = tid; r < G; r += kThreads) {
    mine[GM * HD + r] = bm_s[r];
    mine[GM * HD + GM + r] = bl_s[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) flag_s[0] = atomicAdd(a.tickets + tb, 1) == n_live - 1;
  __syncthreads();
  if (!flag_s[0]) return;
  __threadfence();
  const float* first = a.part + (static_cast<long long>(tb) * a.n_splits + s_first) * C::kEntry;
  // every split's (m, l) of the block's rows at once, then per row the max
  // M and the sum L over the splits in order, and each split's weight
  // exp(m - M); then the outputs, float4s of the splits in batches of kMB
  // loaded together, summed in split order
  float* w_s = red + GM * HD;             // [n_live][GM]: m, then the weight
  float* lw_s = pw_all;                   // [n_live][GM]: l
  float4 v[C::kMB][C::kNO];
  auto load_batch = [&](int s0) {
#pragma unroll
    for (int u = 0; u < C::kMB; ++u)
#pragma unroll
      for (int i = 0; i < C::kNO; ++i) {
        const int q4 = tid + i * kThreads;
        v[u][i] = s0 + u < n_live && q4 < G * HD / 4
                      ? __ldcg(reinterpret_cast<const float4*>(first + (s0 + u) * C::kEntry) + q4)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
  };
  load_batch(0);  // in flight with the (m, l) loads
  for (int i = tid; i < n_live * G; i += kThreads) {
    const int sp = i / G, r = i % G;
    const float* e = first + sp * C::kEntry + GM * HD;
    w_s[sp * GM + r] = __ldcg(e + r);
    lw_s[sp * GM + r] = __ldcg(e + GM + r);
  }
  __syncthreads();
  for (int r = tid; r < G; r += kThreads) {
    float m = kNegInf;
    for (int sp = 0; sp < n_live; ++sp) m = fmaxf(m, w_s[sp * GM + r]);
    float l = 0.0f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float w = ex<TC>(w_s[sp * GM + r] - m);
      l += lw_s[sp * GM + r] * w;
      w_s[sp * GM + r] = w;
    }
    bl_s[r] = l;
  }
  __syncthreads();
  float4 o4[C::kNO];
#pragma unroll
  for (int i = 0; i < C::kNO; ++i) o4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = 0; s0 < n_live; s0 += C::kMB) {
    if (s0 > 0) load_batch(s0);
#pragma unroll
    for (int u = 0; u < C::kMB; ++u)
#pragma unroll
      for (int i = 0; i < C::kNO; ++i) {
        const int q4 = tid + i * kThreads;
        if (s0 + u < n_live && q4 < G * HD / 4) {
          const float w = w_s[(s0 + u) * GM + q4 * 4 / HD];
          o4[i].x = fmaf(v[u][i].x, w, o4[i].x);
          o4[i].y = fmaf(v[u][i].y, w, o4[i].y);
          o4[i].z = fmaf(v[u][i].z, w, o4[i].z);
          o4[i].w = fmaf(v[u][i].w, w, o4[i].w);
        }
      }
  }
#pragma unroll
  for (int i = 0; i < C::kNO; ++i) {
    const int q4 = tid + i * kThreads;
    if (q4 < G * HD / 4) {
      const int r = q4 * 4 / HD, d = q4 * 4 % HD;
      const float inv = 1.0f / bl_s[r];
      const long long o = o_base + r * a.o_h + d;
      store_out(a, o, o4[i].x * inv);
      store_out(a, o + 1, o4[i].y * inv);
      store_out(a, o + 2, o4[i].z * inv);
      store_out(a, o + 3, o4[i].w * inv);
    }
  }
  if (tid == 0) a.tickets[tb] = 0;  // every split has taken its ticket
}

// bf16 q on a bf16 or q8 pool takes the tensor cores; f32 q or an f32 pool
// the CUDA cores (f32 products, held to 2e-5)
bool tensor_cores(int q_type, int pool_kind) {
  return q_type == kQBF16 && pool_kind != kPoolF32;
}

// query rows a block: the tensor cores 16 (32 at hd 64 past 16 rows); the
// CUDA cores 4, 8, or 32 at hd 64, 16 at hd 128 and 8 at hd 256 (P.V's
// registers)
int rows_per_block(int g, int hd, bool tc) {
  if (tc) return g <= 16 || hd != 64 ? 16 : kMaxG;
  return g <= 4 ? 4 : g <= 8 || hd == 256 ? 8 : hd == 64 ? kMaxG : 16;
}

template <int KIND, int HD, int GM, bool TC>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<KIND, HD, GM, TC>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_split_kernel<KIND, HD, GM, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid(a.n_splits, a.n_kv * a.n_grp, B);
  paged_decode_split_kernel<KIND, HD, GM, TC><<<grid, kThreads, C::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int HD>
int dispatch_g(const Args& a, int B, bool tc, cudaStream_t s) {
  const int gm = rows_per_block(a.H / a.n_kv, HD, tc);
  if (tc) {
    if constexpr (KIND == kPoolF32) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (gm == 16) return launch<KIND, HD, 16, true>(a, B, s);
      if constexpr (HD == 64) return launch<KIND, HD, kMaxG, true>(a, B, s);
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (gm == 4) return launch<KIND, HD, 4, false>(a, B, s);
  if (gm == 8) return launch<KIND, HD, 8, false>(a, B, s);
  if constexpr (HD == 256) return static_cast<int>(cudaErrorInvalidValue);
  else return launch<KIND, HD, HD == 64 ? kMaxG : 16, false>(a, B, s);
}

template <int KIND>
int dispatch_hd(const Args& a, int B, int hd, bool tc, cudaStream_t s) {
  if (hd == 64) return dispatch_g<KIND, 64>(a, B, tc, s);
  if (hd == 128) return dispatch_g<KIND, 128>(a, B, tc, s);
  if (hd == 256) return dispatch_g<KIND, 256>(a, B, tc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool shapes_ok(int B, int H, int n_kv, int hd, int P, int ps) {
  return B > 0 && n_kv > 0 && H % n_kv == 0 && P > 0 && ps > 0 &&
         (hd == 64 || hd == 128 || hd == 256);
}

}  // namespace

// The split of a call, from its static shapes, its route and the card's SM count:
// out = {n_splits, split_keys, floats of the partials' scratch, tickets}.
// Returns a cudaError_t.
extern "C" int paged_decode_plan(int B, int H, int n_kv, int hd, int P, int ps, int q_type,
                                 int pool_kind, int device, long long* out) {
  if (!shapes_ok(B, H, n_kv, hd, P, ps)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int g = H / n_kv, gm = rows_per_block(g, hd, tensor_cores(q_type, pool_kind));
  const long long pairs = static_cast<long long>(B) * n_kv * ((g + gm - 1) / gm);
  const long long n_tiles = (static_cast<long long>(P) * ps + kTK - 1) / kTK;
  long long want = (static_cast<long long>(kBlocksPerSM) * sms + pairs - 1) / pairs;
  want = want < 1 ? 1 : want > n_tiles ? n_tiles : want;
  const int max_splits = kMergeRows / gm < kMaxSplits ? kMergeRows / gm : kMaxSplits;
  want = want > max_splits ? max_splits : want;
  long long per = (n_tiles + want - 1) / want;  // tiles a split
  const long long min_per = pairs * 4 >= sms ? kMinSplitTiles : 1;
  per = per < min_per ? (n_tiles < min_per ? n_tiles : min_per) : per;
  const long long n_splits = (n_tiles + per - 1) / per;
  out[0] = n_splits;
  out[1] = per * kTK;
  out[2] = pairs * n_splits * (static_cast<long long>(gm) * hd + 2 * gm);
  out[3] = pairs;
  return 0;
}

// q [B, H, hd] (strides q_b, q_h); out [B, H, hd] (strides o_b, o_h); the K
// and V pools [n_kv, n_pages, ps, hd] (strides h, page, slot) and, for q8
// pools, their f32 scales [n_kv, n_pages, ps, hd / blk] (strides h, page,
// slot; null otherwise); page_tables int32 [B, P] (row stride pt_b); lengths
// int32 [B]; part f32 and tickets int32 (zeroed) as paged_decode_plan sizes
// them, with its n_splits and split_keys. Strides are in elements; the pools'
// bases and strides are 16-byte multiples. q_type: 0 f32, 1 bf16 (out has
// q's type); pool_kind: 0 f32, 1 bf16, 2 q8. softcap <= 0: none; window <= 0:
// none. Returns the cudaError_t of the launch.
extern "C" int paged_decode(
    const void* q, long long q_b, long long q_h, void* out, long long o_b, long long o_h,
    const void* k, long long k_h, long long k_p, long long k_s, const void* v, long long v_h,
    long long v_p, long long v_s, const void* ks, long long ks_h, long long ks_p,
    long long ks_s, const void* vs, long long vs_h, long long vs_p, long long vs_s,
    const void* pt, long long pt_b, int P, const void* lengths, int B, int H, int n_kv, int hd,
    int ps, int blk, float scale, float softcap, int window, int q_type, int pool_kind,
    void* part, void* tickets, int n_splits, int split_keys, void* stream) {
  if (!shapes_ok(B, H, n_kv, hd, P, ps) || blk <= 0 || blk % 16 || hd % blk ||
      n_splits <= 0 || n_splits > kMaxSplits || split_keys <= 0 || split_keys % kTK ||
      part == nullptr ||
      tickets == nullptr || (q_type != kQF32 && q_type != kQBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool_kind == kPoolQ8 && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = tensor_cores(q_type, pool_kind);
  const int g = H / n_kv, gm = rows_per_block(g, hd, tc);
  Args a;
  a.q = q;
  a.q_b = q_b;
  a.q_h = q_h;
  a.out = out;
  a.o_b = o_b;
  a.o_h = o_h;
  a.k = k;
  a.v = v;
  a.k_h = k_h;
  a.k_p = k_p;
  a.k_s = k_s;
  a.v_h = v_h;
  a.v_p = v_p;
  a.v_s = v_s;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.ks_h = ks_h;
  a.ks_p = ks_p;
  a.ks_s = ks_s;
  a.vs_h = vs_h;
  a.vs_p = vs_p;
  a.vs_s = vs_s;
  a.pt = static_cast<const int*>(pt);
  a.pt_b = pt_b;
  a.P = P;
  a.lengths = static_cast<const int*>(lengths);
  a.H = H;
  a.n_kv = n_kv;
  a.ps = ps;
  a.blk = pool_kind == kPoolQ8 ? blk : hd;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  a.q_type = q_type;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.n_splits = n_splits;
  a.split_keys = split_keys;
  a.n_grp = (g + gm - 1) / gm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_kind == kPoolF32) return dispatch_hd<kPoolF32>(a, B, hd, tc, s);
  if (pool_kind == kPoolBF16) return dispatch_hd<kPoolBF16>(a, B, hd, tc, s);
  if (pool_kind == kPoolQ8) return dispatch_hd<kPoolQ8>(a, B, hd, tc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
