// K6: the grouped expert q4 matmul for Hopper (sm_90a).
//
// Replaces two pieces of JAX code, neither a Pallas kernel of its own:
//   * the per-selection linear(xi, w[e]) calls of jlama_tpu/nn/layers.py:
//     _moe_gathered (taken at B*T*K <= 8), which index one expert's QArray
//     slice per (token, k) selection;
//   * QArray.dequantize(bf16) plus jax.lax.ragged_dot in _moe_ragged (taken
//     above that), which sorts the selections by expert and runs grouped
//     matmuls.
// Computes y[r] = x[row of r] . deq(W[e[r]])^T for R selections r, where W is
// one stacked expert projection in the checkpoint's JQ4 layout:
//   packed uint8 [E, N, K/2] (byte j of a 32-block holds element j in the low
//   nibble and element j + 16 in the high nibble, value (nibble - 8) * scale),
//   scales float32 [E, N, K/32], one expert's matrix every N * K/2 bytes.
// x is bf16 [R / x_div, K]: selection r reads row r / x_div (x_div = top-k for
// gate and up, whose input is one row a token; 1 for down, whose input is one
// row a selection), so the repeat of x by k is never materialised. y is
// [R, N] in selection order (no unsort pass), bf16 or f32. One launch may take
// two weight stacks of one shape (gate and up) over the same x rows and
// grouping, writing two outputs: a MoE layer is one grouping and two matmul
// launches, each preceded on the prefill route by a gather of its x rows.
//
// The grouping (moe_group_kernel, once a layer, shared by its projections):
// one block turns the expert ids e [R] into a stable order by expert, order
// [R], per-expert offsets [E + 1] (rows offsets[x] .. offsets[x + 1] - 1 of the
// order are expert x's, in selection order) and the two routes' work lists,
// row tiles (expert, first row in the order, rows) of at most kBM rows (the
// prefill route's, [ceil(R / kBM) + E][3]) and of at most kDecTileRows rows
// (the decode route's, [ceil(R / kDecTileRows) + E][3]: the touched experts,
// one tile each while an expert has at most 16 rows, as at every decode
// step measured), experts ascending, in buffers whose sizes depend on R only,
// each with its count on the device. Entries past a count hold -1. Counts by
// shared-memory atomics, then each chunk of rows ranks itself by a scan of
// the chunk's ids: deterministic, no host sync, so a decode step stays
// capturable, and a replay reads the new routing. An untouched expert gets no
// work item.
//
// Two routes, by R (kDecodeMaxR, read by ops/moe_q4.py:decode_max_r):
//   decode (R <= kDecodeMaxR) - moe_q4_decode_kernel: what bounds it is the
//     touched experts' weight bytes, 0.625 a weight (4-bit payload + f32 block
//     scale) against 3.35 TB/s: 21.9 us for a Mixtral-8x7B projection at R = 2
//     with two distinct experts (73.4 MB). As many blocks as the SMs hold walk
//     the items (decode tile, projection, 16 weight rows), so the SMs share
//     the bytes evenly and no block is launched only to exit; a block keeps
//     the tiles and the order in shared memory and steps through its items
//     by cursors, without divisions. Its 8 warps split K; a warp step takes
//     8 32-blocks (128 contiguous bytes) of each of the item's 16 rows and
//     their scales by cp.async into the warp's ring of shared-memory slots,
//     kDecAhead steps ahead and across item boundaries, so the next item's
//     weights are in flight while the warps' sums of one item meet; a row
//     padded to 144 bytes in a slot lets each lane read its mma fragment words
//     with no bank conflict. Tensor cores with the weights as A (16 rows x
//     k16) and the tile's selections on n8 (one 8-column tile, or two past
//     R = 8). On the H100 the copies alone take about 1.5x the byte bound at
//     R = 2, and deeper rings (fewer blocks an SM) or 1 or 3 blocks an SM are
//     slower (scripts/k6_ablate.py); so were earlier drafts with loads into
//     registers, or 16-byte copies a lane and a transpose across the quad
//     (PERF.md). Numerics are the grid kernel's: exact bf16 (n - 8), exact f32
//     products, each 32-block's f32 partial times its f32 scale (fmaf), f32
//     sums in a fixed order (the blocks of each group of a warp in order, its
//     groups in order, then the 8 warps in warp order through shared
//     memory), so a row's bits depend neither on the batch nor on the other
//     rows.
//   prefill (R above) - moe_q4_wgmma_kernel: what bounds it is the tensor
//     cores (120 GFLOP a projection at R = 1024, 121.6 us at 989 TFLOP/s).
//     K1's q4_wgmma_kernel (csrc/q4_matmul.cu) over the grouping's row tiles:
//     a block takes (a row tile) x (kBN weight rows of one projection); the
//     grid is (ceil(R / kBM) + E) x (projections x ceil(N / kBN)), row tiles
//     fastest, so the blocks that share a weight tile run together, and a
//     block past the tile count exits. One producer warp keeps a ring of
//     kStages shared-memory stages fed under mbarriers: the packed weights by
//     a 3-D TMA map [E, N, K/2] (the out-of-bounds fill stops at each
//     expert's N) and the tile's x rows by a 2-D map over a gathered copy,
//     xg[i] = x[order[i] / x_div], which moe_gather_kernel writes first (a
//     launch of its own, C entry moe_gather; 8 MB at w1 and 29 MB at w2 for
//     R = 1024). A gather by cp.async in the producer warp, with no copy, was
//     3.5x slower at R = 1024 on the H100: one warp's copies could not feed
//     the wgmma (PERF.md). One warpgroup dequantizes each stage to
//     bf16((n - 8) * s) in the swizzle, scales read one step ahead (their row
//     stride is not always a multiple of 16 bytes); two consumer warpgroups
//     run wgmma m64n128k16 bf16 -> f32 on 64 rows each (a warpgroup whose
//     rows all lie past the tile's skips its products) and store y rows
//     through the order. Numerics are _moe_ragged's and K1's M > 16 route's:
//     x bf16, each weight bf16((n - 8) * s) with the product in f32, f32
//     products and sums; each output one block's sum in a fixed order.
// moe_q4_mma_kernel, the grid kernel (a static grid of (N / 32) x E x
// ceil(R / TM) blocks, most of which exit at once), stays built for comparison
// only (its own C entry, moe_q4_mma_matmul); no route of moe_q4_matmul reaches
// it.
// Ids must lie in [0, E): a selection with another id is in no group, the
// gather skips it and its y row is not written.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

// Selections up to which a call takes the decode route; above it the prefill
// route. Picked on the H100 by timing both routes at R = 32, 64, 128 and 256
// (PERF.md). Provisional: the serving steps measured route by random weights.
constexpr int kDecodeMaxR = 64;
constexpr int kBM = 128;  // rows of a prefill row tile

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// ---- the grouping pre-pass -------------------------------------------------

constexpr int kGroupThreads = 256;
constexpr int kDecTileRows = 16;  // rows of a decode tile: two 8-selection mma tiles

__host__ __device__ __forceinline__ int max_tiles(int R, int E, int rows) {
  return (R + rows - 1) / rows + E;
}

// One block. Shared memory: next[E] (the next free slot of each expert's run
// in the order) and ids[kGroupThreads] (the current chunk's ids).
__global__ void __launch_bounds__(kGroupThreads)
moe_group_kernel(const int* __restrict__ e, int R, int E, int* __restrict__ order,
                 int* __restrict__ offsets, int* __restrict__ tiles, int* __restrict__ dtiles,
                 int* __restrict__ counts) {
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
  if (threadIdx.x == 0) {  // E is small (8 for Mixtral): serial prefix sum and lists
    int sum = 0, nt = 0, nd = 0;
    for (int i = 0; i < E; ++i) {
      const int c = next[i];
      offsets[i] = sum;
      next[i] = sum;
      for (int f = 0; f < c; f += kBM, ++nt) {
        tiles[3 * nt] = i;
        tiles[3 * nt + 1] = sum + f;
        tiles[3 * nt + 2] = min(kBM, c - f);
      }
      for (int f = 0; f < c; f += kDecTileRows, ++nd) {
        dtiles[3 * nd] = i;
        dtiles[3 * nd + 1] = sum + f;
        dtiles[3 * nd + 2] = min(kDecTileRows, c - f);
      }
      sum += c;
    }
    offsets[E] = sum;
    counts[0] = nt;
    counts[1] = nd;
    for (int i = 3 * nt; i < 3 * max_tiles(R, E, kBM); ++i) tiles[i] = -1;
    for (int i = 3 * nd; i < 3 * max_tiles(R, E, kDecTileRows); ++i) dtiles[i] = -1;
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

// ---- mma.sync helpers (the decode route and the grid kernel) --------------

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

// ---- the decode route: moe_q4_decode_kernel --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes global -> shared, through L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


constexpr int kDecWarps = 8;
constexpr int kDecRows = 16;    // weight rows an item
constexpr int kDecBlocks = 8;   // 32-blocks of each row a warp step takes: 128 bytes a row
constexpr int kDecAhead = 2;    // steps of copies in flight ahead of the computed one
constexpr int kDecSlots = kDecAhead + 1;  // a warp's ring slots
// One slot: the step's 16 rows x 128 packed bytes, each row padded to 144 so
// that a warp's reads of word tig of one block of rows gid (and gid + 8) meet
// 32 distinct banks, then their 16 x 8 scales.
constexpr int kDecRowStride = kDecBlocks * 16 + 16;
constexpr int kDecSlotBytes = kDecRows * kDecRowStride + kDecRows * kDecBlocks * 4;
constexpr int kDecRingBytes = kDecWarps * kDecSlots * kDecSlotBytes;

// The 8 bytes x[32 b + 16 h .. + 3] from a lane's x row pointer (already
// offset by 4 tig): its B fragment of k16 step h of 32-block b.
__device__ __forceinline__ uint2 ldg_x(const __nv_bfloat16* p, int b, int h) {
  return __ldg(reinterpret_cast<const uint2*>(p + 32 * b + 16 * h));
}

// The block's items blockIdx.x, + gridDim.x, ... in order: ordinal i, weight-row
// tile, projection p, decode tile d, stepped without divisions.
struct ItemCursor {
  int i, tile, p, d;
  __device__ __forceinline__ void start(int it, int n_tiles, int P) {
    i = 0;
    tile = it % n_tiles;
    p = (it / n_tiles) % P;
    d = it / n_tiles / P;
  }
  __device__ __forceinline__ void next(int stride, int n_tiles, int P) {
    ++i;
    tile += stride;
    while (tile >= n_tiles) {
      tile -= n_tiles;
      if (++p == P) {
        p = 0;
        ++d;
      }
    }
  }
};

// Items (decode tile d, projection p, tile of kDecRows weight rows), weight
// tiles fastest; block b takes items b, b + gridDim.x, ... A block's 8 warps
// split K into groups of kDecBlocks 32-blocks (warp w takes groups w, w + 8,
// ...), each warp the same n_it steps an item (a group past K copies
// nothing), so the steps of all the block's items form one sequence a warp
// walks with its copies kDecAhead steps ahead, across item boundaries: lane
// 8r + c copies 16-byte block c of the group from rows r, r + 4, r + 8, r + 12
// (128 contiguous bytes a row, 4 rows a copy instruction) and their scales by
// cp.async into its warp's ring of shared-memory slots. After its wait a lane
// reads its mma fragments from the slot: a warp's own copies are complete for
// each lane, and __syncwarp makes them visible to the warp. After an item's
// last step the warps' partials meet in shared memory in warp order.
// Fragments (lane = 4 * gid + tig) as in K1's q4_mma_kernel: the k slots (2t,
// 2t+1, 2t+8, 2t+9) of one k16 step s stand for block elements (16s + 4t, +2,
// +1, +3), so a thread's weights of one 32-block are its word t of the row's
// 16 bytes; low nibbles feed step 0, high nibbles step 1; B from the 8 bytes
// x[row][32b + 16s + 4t .. +3]; C rows gid, gid + 8, selections 8j + 2t, +1.
// Weight rows at or past N read row N - 1, blocks past K read zeros with
// scale 0, and selections past the tile's count read its last one; their
// outputs are never stored. Shared memory (dynamic): the rings, then the
// decode tiles and the order.
template <typename TY, int NT>
__global__ void __launch_bounds__(kDecWarps * 32, 2)
moe_q4_decode_kernel(const __nv_bfloat16* __restrict__ x, int x_div,
                     const uint8_t* __restrict__ wa, const float* __restrict__ sa,
                     const uint8_t* __restrict__ wb, const float* __restrict__ sb,
                     const int* __restrict__ order, const int* __restrict__ dtiles,
                     const int* __restrict__ counts, TY* __restrict__ ya, TY* __restrict__ yb,
                     int R, int P, int N, int K) {
  constexpr int kFrags = NT * 4;  // f32 accumulators a thread
  __shared__ float red[kDecWarps][kFrags][32];
  extern __shared__ __align__(16) uint8_t dsmem[];
  const int n_dt = counts[1];
  int* const s_tiles = reinterpret_cast<int*>(dsmem + kDecRingBytes);
  int* const s_order = s_tiles + 3 * n_dt;
  for (int i = threadIdx.x; i < 3 * n_dt; i += blockDim.x) s_tiles[i] = dtiles[i];
  for (int i = threadIdx.x; i < R; i += blockDim.x) s_order[i] = order[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int cr = lane >> 3, cb = lane & 7;  // the copies: row cr + 4m, block cb of a group
  const int nb = K >> 5, ng = (nb + kDecBlocks - 1) / kDecBlocks;
  const int n_it = (ng + kDecWarps - 1) / kDecWarps;
  const int n_tiles = (N + kDecRows - 1) / kDecRows;
  const int items = n_dt * P * n_tiles;
  const int mine = (int)blockIdx.x < items ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int stride = gridDim.x;
  const size_t wstride = (size_t)N * (K >> 1), sstride = (size_t)N * nb;
  uint8_t* const ring = dsmem + warp * kDecSlots * kDecSlotBytes;

  // Two cursors walk the block's steps (item, group step k of n_it): the
  // copies kDecAhead steps ahead, and the products.
  ItemCursor wc, cc;
  wc.start(blockIdx.x, n_tiles, P);
  cc = wc;
  int wk = 0, ck = 0;
  const uint8_t* wrow[4];  // rows cr + 4m of the copy cursor's tile
  const float* srow[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wrow[m] = wa;
    srow[m] = sa;
  }
  const auto w_item = [&]() {  // the copy cursor's row pointers
    if (wc.i >= mine) return;
    const int ex = s_tiles[3 * wc.d];
    const uint8_t* w = (wc.p ? wb : wa) + (size_t)ex * wstride;
    const float* sc = (wc.p ? sb : sa) + (size_t)ex * sstride;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = min(wc.tile * kDecRows + cr + 4 * m, N - 1);
      wrow[m] = w + (size_t)r * (K >> 1);
      srow[m] = sc + (size_t)r * nb;
    }
  };
  const auto copy_w = [&](int t) {  // the copy cursor's step into slot t, then step it
    const int b = kDecBlocks * (warp + kDecWarps * wk) + cb;
    const bool ok = wc.i < mine && b < nb;
    const uint32_t dw = smem_u32(ring + t * kDecSlotBytes) + cr * kDecRowStride + 16 * cb;
    const uint32_t ds = smem_u32(ring + t * kDecSlotBytes + kDecRows * kDecRowStride) +
                        (cr * kDecBlocks + cb) * 4;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      cp_async16(dw + 4 * m * kDecRowStride,
                 ok ? static_cast<const void*>(wrow[m] + 16 * b) : wa, ok ? 16 : 0);
      cp_async4(ds + 4 * m * kDecBlocks * 4, ok ? static_cast<const void*>(srow[m] + b) : sa,
                ok ? 4 : 0);
    }
    cp_async_commit();
    if (++wk == n_it) {
      wk = 0;
      wc.next(stride, n_tiles, P);
      w_item();
    }
  };
  // the current item's rows, and this lane's x rows
  int rows = 0, first = 0, nt = 0;
  const __nv_bfloat16* xr[NT];
  const auto c_item = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j) xr[j] = x;
    rows = nt = 0;
    if (cc.i >= mine) return;
    first = s_tiles[3 * cc.d + 1];
    rows = s_tiles[3 * cc.d + 2];
    nt = (rows + 7) >> 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int sel = s_order[first + min(8 * j + gid, rows - 1)];
      xr[j] = x + (size_t)(sel / x_div) * K + 4 * tig;
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  w_item();
#pragma unroll
  for (int t = 0; t < kDecAhead; ++t) copy_w(t);
  c_item();
  for (int st = 0, n_steps = mine * n_it; st < n_steps; ++st) {
    copy_w((st + kDecAhead) % kDecSlots);  // in flight while this step computes
    const int g = warp + kDecWarps * ck;
    if (g < ng) {  // uniform in the warp
      const int b0 = kDecBlocks * g;
      uint2 xv[NT][kDecBlocks][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < kDecBlocks; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[j][i][h] = (j < nt && b0 + i < nb) ? ldg_x(xr[j], b0 + i, h) : make_uint2(0u, 0u);
      cp_async_wait<kDecAhead>();  // this lane's copies of the step have landed
      __syncwarp();                // and the warp's
      const uint8_t* const slot = ring + (st % kDecSlots) * kDecSlotBytes;
      const uint32_t* const wr0 =
          reinterpret_cast<const uint32_t*>(slot + gid * kDecRowStride) + tig;
      const uint32_t* const wr1 = wr0 + 8 * kDecRowStride / 4;
      const float* const sr0 =
          reinterpret_cast<const float*>(slot + kDecRows * kDecRowStride) + gid * kDecBlocks;
      const float* const sr1 = sr0 + 8 * kDecBlocks;
#pragma unroll
      for (int i = 0; i < kDecBlocks; ++i) {
        if (b0 + i >= nb) break;  // uniform: K's last group may be short
        const uint32_t r0 = wr0[4 * i], r1 = wr1[4 * i];
        const float sca = sr0[i], scb = sr1[i];
        const uint32_t lo[4] = {dq2(r0), dq2(r1), dq2(r0 >> 8), dq2(r1 >> 8)};
        const uint32_t hi[4] = {dq2(r0 >> 4), dq2(r1 >> 4), dq2(r0 >> 12), dq2(r1 >> 12)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) break;
          const uint2 v0 = xv[j][i][0], v1 = xv[j][i][1];
          float c[4];
          mma_bf16(c, lo, __byte_perm(v0.x, v0.y, 0x5410), __byte_perm(v0.x, v0.y, 0x7632),
                   zero);
          mma_bf16(c, hi, __byte_perm(v1.x, v1.y, 0x5410), __byte_perm(v1.x, v1.y, 0x7632), c);
          acc[j][0] = fmaf(c[0], sca, acc[j][0]);
          acc[j][1] = fmaf(c[1], sca, acc[j][1]);
          acc[j][2] = fmaf(c[2], scb, acc[j][2]);
          acc[j][3] = fmaf(c[3], scb, acc[j][3]);
        }
      }
      __syncwarp();  // the slot is read before a later step's copies overwrite it
    }
    if (++ck == n_it) {  // the item's last step: the warps' sums, in warp order
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[warp][j * 4 + e][lane] = acc[j][e];
          acc[j][e] = 0.0f;
        }
      __syncthreads();
      TY* const y = cc.p ? yb : ya;
      for (int idx = threadIdx.x; idx < nt * 4 * 32; idx += kDecWarps * 32) {
        const int f = idx >> 5, l = idx & 31;
        float v = 0.0f;
#pragma unroll
        for (int wp = 0; wp < kDecWarps; ++wp) v += red[wp][f][l];
        const int e = f & 3, j = f >> 2;
        const int row = cc.tile * kDecRows + (l >> 2) + 8 * (e >> 1);
        const int tok = 8 * j + 2 * (l & 3) + (e & 1);
        if (row < N && tok < rows) y[(size_t)s_order[first + tok] * N + row] = from_f32<TY>(v);
      }
      __syncthreads();
      ck = 0;
      cc.next(stride, n_tiles, P);
      c_item();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// As many blocks as the SMs hold at once, at most one an item of the largest
// possible list: the grid depends on R only.
template <typename TY, int NT>
cudaError_t launch_decode(const __nv_bfloat16* x, int x_div, const uint8_t* wa, const float* sa,
                          const uint8_t* wb, const float* sb, const int* order,
                          const int* dtiles, const int* counts, TY* ya, TY* yb, int P, int R,
                          int E, int N, int K, cudaStream_t st) {
  constexpr int kMetaMax = 16 * 1024;  // the tiles and the order, at most
  const int max_dt = min(max_tiles(R, E, kDecTileRows), R);
  const size_t meta = (size_t)(3 * max_dt + R) * sizeof(int);
  if (meta > kMetaMax) return cudaErrorInvalidValue;
  static int per_sm = 0;  // blocks an SM holds, from the kernel's registers and shared memory
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(moe_q4_decode_kernel<TY, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDecRingBytes + kMetaMax);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, moe_q4_decode_kernel<TY, NT>,
                                                      kDecWarps * 32, kDecRingBytes + kMetaMax);
    if (e != cudaSuccess) return e;
    per_sm = max(per_sm, 1);
  }
  const long items = (long)max_dt * P * ((N + kDecRows - 1) / kDecRows);
  const long cap = (long)per_sm * sm_count();
  const int grid = (int)(items < cap ? items : cap);
  moe_q4_decode_kernel<TY, NT><<<grid, kDecWarps * 32, kDecRingBytes + meta, st>>>(
      x, x_div, wa, sa, wb, sb, order, dtiles, counts, ya, yb, R, P, N, K);
  return cudaGetLastError();
}

// ---- the prefill route: moe_q4_wgmma_kernel --------------------------------

constexpr int kStages = 4;
constexpr int kBK = 64;             // K per stage
constexpr int kRowBytes = kBK * 2;  // one row of an x or W tile in shared memory
constexpr int kBN = 128;            // weight rows a block
constexpr int kDqThreads = 128;     // warpgroup 0
constexpr int kConsumers = kBM / 64;
constexpr int kPfThreads = kDqThreads + 128 * kConsumers + 32;  // + the producer warp
constexpr int kProducerWarp = (kPfThreads - 32) / 32;
constexpr int kXBytes = kBM * kRowBytes;  // x tile, bf16, swizzled
constexpr int kBBytes = kBN * kRowBytes;  // dequantized W tile, bf16, swizzled
constexpr int kPBytes = kBN * kBK / 2;    // packed W tile
// the three rings, the full/bready/empty barriers, the tile's rows' selections,
// plus slack to align to 1024
constexpr int kPfSmem = kStages * (kXBytes + kBBytes + kPBytes) + 3 * kStages * 8 + kBM * 4 +
                        1024;

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// generic-proxy accesses of shared memory ordered before the async proxy's
// next ones (wgmma reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d[64 x 128] = A[64 x 16] . B[128 x 16]^T (+ d if accumulate), bf16 in, f32 out
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

// A TN GEMM per (row tile blockIdx.x of the grouping's list) x (kBN weight rows
// of projection blockIdx.y / ceil(N / kBN)), K in steps of kBK through the ring:
//   * the producer warp waits for a stage to be free; one lane starts the TMA
//     loads of the tile's x rows [kBM x 64] from the gathered copy and of the
//     packed W bytes [kBN x 32] of the tile's expert, both under full[s];
//   * warpgroup 0 dequantizes the stage's packed bytes into the bf16 W tile in
//     the same swizzle, as K1 does, then fence.proxy.async and bready[s];
//   * consumer warpgroup c runs four wgmma m64n128k16 a stage on tile rows
//     64c .. 64c + 63, keeps one stage's group in flight and frees the stage
//     before it (empty[s]); a warpgroup whose rows all lie past the tile's
//     count only waits for each stage and frees it;
//   * the epilogue stores row i < rows of the tile to y row order[first + i].
// x rows past R, W rows past the expert's N and K past its end arrive as
// zeros, their scales as 0; x rows of the next expert inside the tile are
// computed and never stored.
template <typename TY>
__global__ void __launch_bounds__(kPfThreads, 1)
moe_q4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap_a,
                    const __grid_constant__ CUtensorMap wmap_b,
                    const float* __restrict__ sa, const float* __restrict__ sb,
                    const int* __restrict__ order, const int* __restrict__ tiles,
                    const int* __restrict__ counts, TY* __restrict__ ya, TY* __restrict__ yb,
                    int N, int K) {
  if ((int)blockIdx.x >= counts[0]) return;  // past the list: the whole block
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: tiles start 1024-aligned
  uint8_t* const xs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const bs = xs + kStages * kXBytes;
  uint8_t* const pk = bs + kStages * kBBytes;
  uint8_t* const bars = pk + kStages * kPBytes;
  int* const xsel = reinterpret_cast<int*>(bars + 3 * kStages * 8);  // selection, or -1
  // full[s]: x and packed W landed; bready[s]: W tile dequantized; empty[s]:
  // the stage's last readers are done
  const uint32_t full0 = smem_u32(bars);
  const uint32_t bready0 = full0 + 8 * kStages, empty0 = bready0 + 8 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ex = tiles[3 * blockIdx.x], first = tiles[3 * blockIdx.x + 1];
  const int rows = tiles[3 * blockIdx.x + 2];
  const int n_tiles_n = (N + kBN - 1) / kBN;
  const int p = blockIdx.y / n_tiles_n, n0 = (blockIdx.y % n_tiles_n) * kBN;
  const int nb = K >> 5, n_k = (K + kBK - 1) / kBK;

  for (int i = threadIdx.x; i < kBM; i += blockDim.x) xsel[i] = i < rows ? order[first + i] : -1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(bready0 + 8 * i, kDqThreads / 32);
      mbar_init(empty0 + 8 * i, kDqThreads / 32 + 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    const CUtensorMap* wmap = p ? &wmap_b : &wmap_a;
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages, lap = kt / kStages;
      if (lap > 0) mbar_wait(empty0 + 8 * st, (lap - 1) & 1);
      const uint32_t full = full0 + 8 * st;
      if (lane == 0) {
        mbar_arrive_expect_tx(full, kXBytes + kPBytes);
        tma_load_2d(smem_u32(xs + st * kXBytes), &xmap, kt * kBK, first, full);
        tma_load_3d(smem_u32(pk + st * kPBytes), wmap, kt * (kBK / 2), n0, ex, full);
      }
    }
  } else if (warp < kDqThreads / 32) {
    const float* s = (p ? sb : sa) + (size_t)ex * N * nb;
    // each thread's scales (one per 32-block it dequantizes), read one step
    // ahead: their row stride, 4 K / 32 bytes, is not a multiple of 16 at
    // every K, so they take no TMA
    float f_next[kBN / 64];
    const auto load_scales = [&](int kt, float* f) {
#pragma unroll
      for (int i = 0; i < kBN / 64; ++i) {
        const int q = threadIdx.x + kDqThreads * i;
        const int gn = n0 + (q >> 1), kb = 2 * kt + (q & 1);
        f[i] = (gn < N && kb < nb) ? __ldg(s + (size_t)gn * nb + kb) : 0.0f;
      }
    };
    load_scales(0, f_next);
    for (int kt = 0; kt < n_k; ++kt) {
      float f_now[kBN / 64];
#pragma unroll
      for (int i = 0; i < kBN / 64; ++i) f_now[i] = f_next[i];
      if (kt + 1 < n_k) load_scales(kt + 1, f_next);
      const int st = kt % kStages;
      mbar_wait(full0 + 8 * st, (kt / kStages) & 1);
      const uint8_t* const pks = pk + st * kPBytes;
      uint8_t* const b = bs + st * kBBytes;
#pragma unroll
      for (int i = 0; i < kBN / 64; ++i) {
        const int q = threadIdx.x + kDqThreads * i;  // 32-block q % 2 of row q / 2
        const int row = q >> 1, blk = q & 1;
        const uint4 pv = *reinterpret_cast<const uint4*>(pks + 16 * q);
        const float f = f_now[i];
        const uint32_t wd[4] = {pv.x, pv.y, pv.z, pv.w};
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
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bready0 + 8 * st);
        mbar_arrive(empty0 + 8 * st);
      }
    }
  } else {
    const int cw = warp - kDqThreads / 32;  // consumer warp; warpgroup cw / 4 owns 64 rows
    const int wg_row0 = 64 * (cw >> 2);
    if (wg_row0 >= rows) {  // no row of this warpgroup is the tile's: only free the stages
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % kStages;
        mbar_wait(full0 + 8 * st, (kt / kStages) & 1);
        if (lane == 0) mbar_arrive(empty0 + 8 * st);
      }
      return;
    }
    // no zero fill: the first product overwrites d (an instruction writing
    // the accumulators would make ptxas serialize the wgmmas)
    float d[kBN / 2];
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      const uint32_t ph = (kt / kStages) & 1;
      mbar_wait(full0 + 8 * st, ph);
      mbar_wait(bready0 + 8 * st, ph);
      const uint32_t a = smem_u32(xs + st * kXBytes + wg_row0 * kRowBytes);
      const uint32_t bb = smem_u32(bs + st * kBBytes);
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
    // d[4j + 2h + e]: tile row wg_row0 + 16 (cw % 4) + lane / 4 + 8h, weight
    // row n0 + 8j + 2 (lane % 4) + e
    TY* const y = p ? yb : ya;
    const int r0 = wg_row0 + 16 * (cw & 3) + (lane >> 2);
    const int sel0 = xsel[r0], sel1 = xsel[r0 + 8];
    const bool even_n = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;
      if (sel0 >= 0)
        store2(y, (size_t)sel0 * N + n, even_n && n + 1 < N, n + 1 < N, d[4 * j], d[4 * j + 1]);
      if (sel1 >= 0)
        store2(y, (size_t)sel1 * N + n, even_n && n + 1 < N, n + 1 < N, d[4 * j + 2],
               d[4 * j + 3]);
    }
  }
}

// Copies the x rows of the grouped selections into order rows of xg [R, K]:
// xg[i] = x[order[i] / x_div] for i < offsets[E] (the rows of selections with
// an id in [0, E); rows past it are left unwritten), 16 bytes a thread (the
// prefill route's gathered copy, which its kernel then loads by TMA).
__global__ void __launch_bounds__(256)
moe_gather_kernel(const __nv_bfloat16* __restrict__ x, int x_div, const int* __restrict__ order,
                  const int* __restrict__ offsets, int E, int K, __nv_bfloat16* __restrict__ xg) {
  const int i = blockIdx.x;
  if (i >= offsets[E]) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(order[i] / x_div) * K);
  uint4* dst = reinterpret_cast<uint4*>(xg + (size_t)i * K);
  for (int c = threadIdx.x; c < K / 8; c += blockDim.x) dst[c] = src[c];
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

// The gathered x copy [rows, K] bf16, box [kBM rows, kBK], 128-byte swizzle.
bool x_map(CUtensorMap* map, const void* xg, int rows, int K) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(xg), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The packed expert stack [E, N, K/2] as a 3-D map, box [1, kBN, kBK / 2]: an
// expert's box past its N reads zeros, never the next expert's rows. Cached by
// (address, E, N, K): a weight keeps its map across calls; a new tensor at a
// freed one's address and shape gets the same map, so an entry never goes
// stale.
bool weight_map(CUtensorMap* map, const uint8_t* w, int E, int N, int K) {
  static std::mutex mu;
  static std::map<std::tuple<uintptr_t, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(w), E, N, K);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)K / 2;
  const cuuint64_t dims[3] = {row, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t strides[2] = {row, row * N};  // bytes; K % 32 == 0 keeps both 16-byte multiples
  const cuuint32_t box[3] = {kBK / 2, kBN, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(w), dims, strides, box,
         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache.emplace(key, *map);
  return true;
}

// xg: moe_gather_kernel's copy of x (the caller's scratch, written earlier on
// the stream).
template <typename TY>
cudaError_t launch_wgmma(const __nv_bfloat16* xg, const uint8_t* wa, const float* sa,
                         const uint8_t* wb, const float* sb, const int* order, const int* tiles,
                         const int* counts, TY* ya, TY* yb, int P, int R, int E, int N, int K,
                         cudaStream_t st) {
  CUtensorMap xmap{}, wmap_a{}, wmap_b{};
  if (!weight_map(&wmap_a, wa, E, N, K) || (P == 2 && !weight_map(&wmap_b, wb, E, N, K)) ||
      xg == nullptr || !x_map(&xmap, xg, R, K))
    return cudaErrorInvalidValue;
  static uint32_t smem_set = 0;  // devices whose attribute is set (bit per device)
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(smem_set >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_q4_wgmma_kernel<TY>, cudaFuncAttributeMaxDynamicSharedMemorySize, kPfSmem);
    if (e != cudaSuccess) return e;
    smem_set |= 1u << dev;
  }
  const dim3 grid(max_tiles(R, E, kBM), P * ((N + kBN - 1) / kBN));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  moe_q4_wgmma_kernel<TY><<<grid, kPfThreads, kPfSmem, st>>>(
      xmap, wmap_a, P == 2 ? wmap_b : wmap_a, sa, P == 2 ? sb : sa, order, tiles, counts, ya,
      P == 2 ? yb : ya, N, K);
  return cudaGetLastError();
}

enum Route { kDecode = 1, kPrefill = 2 };

template <typename TY>
cudaError_t launch(const __nv_bfloat16* x, int x_div, const uint8_t* wa, const float* sa,
                   const uint8_t* wb, const float* sb, const int* order, const int* tiles,
                   const int* dtiles, const int* counts, TY* ya, TY* yb, int R, int E, int N,
                   int K, int route, __nv_bfloat16* xg, cudaStream_t st) {
  const int P = wb != nullptr ? 2 : 1;
  if (route == kDecode) {
    // one 8-column tile (R <= 8) or two
    if (R <= 8)
      return launch_decode<TY, 1>(x, x_div, wa, sa, wb, sb, order, dtiles, counts, ya, yb, P, R,
                                  E, N, K, st);
    return launch_decode<TY, 2>(x, x_div, wa, sa, wb, sb, order, dtiles, counts, ya, yb, P, R, E,
                                N, K, st);
  }
  if (route == kPrefill)
    return launch_wgmma<TY>(xg, wa, sa, wb, sb, order, tiles, counts, ya, yb, P, R, E, N, K, st);
  return cudaErrorInvalidValue;
}

// ---- the grid kernel, for comparison only: moe_q4_mma_kernel ----------------

constexpr int kWarps = 8;
constexpr int kRT = 2;  // 16-row weight tiles a block: 32 weight rows

// Block (blockIdx.x, expert blockIdx.y, row tile blockIdx.z): weight rows
// 32 * blockIdx.x .. + 31 of the expert, its selections
// offsets[ex] + TM * blockIdx.z .. + TM - 1 of the order (TM = 8 * NT), a
// static grid (N / 32) x E x ceil(R / TM): a block past its expert's rows
// exits at once. Each lane loads one 4-byte word of a row's 32-block and its
// scale; the 8 warps interleave the 32-blocks and meet in shared memory in
// warp order. The decode route's numerics.
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
cudaError_t launch_mma(const __nv_bfloat16* x, int x_div, const uint8_t* w, const float* s,
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

// The threshold and the two routes' tile rows, for ops/moe_q4.py.
extern "C" int moe_q4_decode_max_r() { return kDecodeMaxR; }
extern "C" int moe_q4_tile_rows() { return kBM; }
extern "C" int moe_q4_decode_tile_rows() { return kDecTileRows; }

// The grouping pre-pass: order [R], offsets [E + 1], tiles [ceil(R / kBM) + E,
// 3], dtiles [ceil(R / kDecTileRows) + E, 3], counts [2] (tiles, dtiles),
// int32 on the device.
extern "C" int moe_group(const void* e, int R, int E, void* order, void* offsets, void* tiles,
                         void* dtiles, void* counts, void* stream) {
  if (R < 0 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(E + kGroupThreads) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  moe_group_kernel<<<1, kGroupThreads, smem, st>>>(
      static_cast<const int*>(e), R, E, static_cast<int*>(order), static_cast<int*>(offsets),
      static_cast<int*>(tiles), static_cast<int*>(dtiles), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The prefill route's gathered copy: xg [R, K] (bf16, 16-byte aligned rows)
// row i = x [R / x_div, K] row order[i] / x_div, for the rows of moe_group's
// order that hold a selection (offsets[E] of them, read on the device).
extern "C" int moe_gather(const void* x, int x_div, const void* order, const void* offsets,
                          int R, int E, int K, void* xg, void* stream) {
  if (R <= 0 || E <= 0 || K <= 0 || (K & 7) || x_div <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_gather_kernel<<<R, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), x_div, static_cast<const int*>(order),
      static_cast<const int*>(offsets), E, K, static_cast<__nv_bfloat16*>(xg));
  return static_cast<int>(cudaGetLastError());
}

// y_a [R, N] (y_dtype) = x [R / x_div, K] (bf16) through each selection's
// expert of w_a (packed [E, N, K/2], scales [E, N, K/32]), with moe_group's
// order, lists and counts; with w_b not null, y_b from w_b (same shape) in
// the same launch.
// route: 1 decode (the caller takes it up to moe_q4_decode_max_r()
// selections), 2 prefill, which reads x from xg, moe_gather's copy (bf16
// [R, K]), and not from x.
// Returns the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for
// arguments the kernels do not take.
extern "C" int moe_q4_matmul(const void* x, int x_div, const void* w_a, const void* s_a,
                             const void* w_b, const void* s_b, const void* order,
                             const void* tiles, const void* dtiles, const void* counts, void* y_a,
                             void* y_b, int y_dtype, int R, int E, int N, int K, int route,
                             void* xg, void* stream) {
  if (R <= 0 || E <= 0 || N <= 0 || K <= 0 || (K & 31) || x_div <= 0 ||
      (w_b != nullptr) != (y_b != nullptr) || (w_b != nullptr && s_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wa = static_cast<const uint8_t*>(w_a);
  const auto* wb = static_cast<const uint8_t*>(w_b);
  const auto* sa = static_cast<const float*>(s_a);
  const auto* sb = static_cast<const float*>(s_b);
  const auto* op = static_cast<const int*>(order);
  const auto* tp = static_cast<const int*>(tiles);
  const auto* dp = static_cast<const int*>(dtiles);
  const auto* cp = static_cast<const int*>(counts);
  auto* gp = static_cast<__nv_bfloat16*>(xg);
  if (y_dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(
        xp, x_div, wa, sa, wb, sb, op, tp, dp, cp, static_cast<__nv_bfloat16*>(y_a),
        static_cast<__nv_bfloat16*>(y_b), R, E, N, K, route, gp, st));
  if (y_dtype == kF32)
    return static_cast<int>(launch<float>(xp, x_div, wa, sa, wb, sb, op, tp, dp, cp,
                                          static_cast<float*>(y_a), static_cast<float*>(y_b), R,
                                          E, N, K, route, gp, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The grid kernel (comparison only): y [R, N] = x [R / x_div, K] through each
// selection's expert, with moe_group's order and offsets; tm: selections a
// row tile (8, 16 or 32).
extern "C" int moe_q4_mma_matmul(const void* x, int x_div, const void* w, const void* scales,
                                 const void* order, const void* offsets, void* y, int y_dtype,
                                 int R, int E, int N, int K, int tm, void* stream) {
  if (R <= 0 || E <= 0 || N <= 0 || K <= 0 || (K & 31) || x_div <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* op = static_cast<const int*>(order);
  const auto* fp = static_cast<const int*>(offsets);
  if (y_dtype == kBF16)
    return static_cast<int>(launch_mma<__nv_bfloat16>(xp, x_div, wp, sp, op, fp,
                                                      static_cast<__nv_bfloat16*>(y), R, E, N, K,
                                                      tm, st));
  if (y_dtype == kF32)
    return static_cast<int>(launch_mma<float>(xp, x_div, wp, sp, op, fp, static_cast<float*>(y),
                                              R, E, N, K, tm, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
