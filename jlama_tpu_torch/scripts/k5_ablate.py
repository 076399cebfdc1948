"""Ablations of K5's routes on the card: where their time goes.

    python -m jlama_tpu_torch.scripts.k5_ablate [--route prefill|decode] [--source FILE]
                                                [--out FILE]

`--route prefill` (the default) ablates the wgmma route (M > 16) as below;
`--route decode` the decode route (M <= 16), further below.

Builds `csrc/w8a8_matmul.cu` as it is and copies of it with parts of the
prefill route cut out, each with nvcc into `_build/ablate_w8a8_matmul/`, and
times every build at Llama-3.2-1B's prefill shapes (M = 512, bf16 x and y)
beside `torch.matmul` on a bf16 weight, `torch._int_mm` on the int8 codes (no
group scales) and the bound:

- `route`: the source as it is;
- `no_mma`: the consumers run no `wgmma` (their s32 sums are left opaque);
- `no_expand`: the weights' A fragments are the packed words as loaded,
  without the (nibble - 8) * sigma expansion;
- `no_promote`: each group's s32 sums are added to the f32 accumulator as
  they are, without the conversion and the two scale products;
- `loads_only`: none of the three: the pre-pass, TMA loads, barriers, the
  weights' shared-memory reads, the scale loads and the epilogue;
- `no_tma`: `loads_only` without the TMA loads (the stages hold what they
  held);
- `no_prepass`: the route without the pre-pass launch; it reads the codes
  and scales that the `route` build left in the same scratch, so its output
  is still right, and its time is the GEMM's alone;
- `no_turns`: the two consumer warpgroups issue their products in any order
  (the 128 x 128 tile; the 64 x 64 tile has one);
- `trace`: the route with `clock64` stamps, one thread a consumer warpgroup,
  at each group's start, after its stage landed, after the fence before its
  products, after their issue, after their end and after the promotion; the
  row gives each phase's median cycles over blocks and groups g >= 1, and the
  period from one group's start to the next.

Every row says whether its output equals the plain version's (`route`,
`no_prepass`, `no_turns` and `trace` compute the function).

`--route decode` times its builds at Llama-3.2-1B's decode shapes (wqkv,
wo, w13, w2 with bf16 x and y, the lm_head with f32 y) at M = 1 and 16,
beside `torch.matmul` on a bf16 weight and the bound, and sums each build's
16-slot decode step (16 layers and the lm_head). The decode kernel's cuts:

- `route`: the source as it is;
- `no_mma`: no `mma.sync` (the fragments are kept live, the sums opaque);
- `no_expand`: the weights' A fragments are the packed words as loaded;
- `no_promote`: no conversion and scale products of the group sums;
- `loads_only`: none of the three;
- `no_prepass`: no pre-pass launch (the kernel reads the codes the `route`
  build left in the same scratch; M > kInlineMaxM);
- `cp_async`: the weight boxes by the warp's `cp.async.cg` 16-byte copies,
  completing on the same mbarriers, in place of TMA (the same function);
- `inline_upto_0`, `inline_upto_8`: x quantized by the pre-pass at every M,
  or in the launch up to M = 8 (the split point's comparison; these and
  `route` are also timed at M = 2, 4 and 8), and `prepass_no_pdl`: the
  pre-pass at every M, without programmatic dependent launch;
- `trace`: `clock64` stamps by lane 0 of every warp in each round: the x
  buffer's wait (or the in-launch quantization) and the B fragments' reads,
  the weight stage's wait, the products, the promotion (summed over the row
  tiles) and the block's ordered sum of the round's products: median cycles
  of each phase, and the period of a round.

`--source FILE` ablates another copy of `csrc/w8a8_matmul.cu`: the decode
kernel at commit f4e550f (`w8a8_decode_kernel` with x quantized in every
block and x on the M side of `mma.sync`; `git show
f4e550f:jlama_tpu_torch/csrc/w8a8_matmul.cu`) takes the cuts of
`DECODE_ABLATIONS_OLD`: `route`, `no_quant` (no in-launch quantization),
`no_mma`, `no_expand`, `no_promote`, `loads_only` (none of the four), and
`trace` (stamps at each group's start, after its quantization, after its
products, their weight loads' wait included, and after its promotion).

Card only: it raises without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..nn.qarray import QArray
from ..ops import _build
from ..ops.w8a8 import (_SIGNATURES, BITS_PER_WEIGHT, GROUP, int8_operands, q4s_matmul_plain,
                        to_q4s)
from ..utils.cuda_timer import INT8_OPS_PER_S, Timer, bound
from ._common import SLEEP_CYCLES, build_cut_copies

_MMA = ("      wgmma_s8(d, a[b], sw128_desc(xa + (b >> 2) * BM * kBoxBytes + 32 * (b & 3)), "
        "b > 0);\n")
_EXPAND = """      a[b][0] = expand_lo(w0[b], s0, c0);
      a[b][1] = expand_lo(w1[b], s1, c1);
      a[b][2] = expand_hi(w0[b], s0, c0);
      a[b][3] = expand_hi(w1[b], s1, c1);
"""
_RAW = """      a[b][0] = w0[b] ^ c0;
      a[b][1] = w1[b] ^ c1;
      a[b][2] = w0[b] >> 4;
      a[b][3] = w1[b] >> 4;
"""
_PROMOTE = "acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(exact_f32(d[i]), x), swk[h]));"
_PREPASS = """  w8a8_quantize_kernel<TX, false><<<(items + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, st>>>(
      static_cast<const TX*>(x), xq, xs, M, K, Mp);
"""

_TMA = """        tma_load_2d(xdst, &xmap, g * kGroup, m0, full);
        tma_load_2d(xdst + BM * kBoxBytes, &xmap, g * kGroup + kBoxBytes, m0, full);
        tma_load_2d(smem_u32(wt + s * T::kWBytes), &wmap, g * (kGroup / 2), n0, full);
        tma_load_2d(smem_u32(st + s * BM), &smap, m0, g, full);
"""
_EXPECT = "mbar_arrive_expect_tx(full, T::kXBytes + T::kWBytes + T::kSBytes);"

_TURNS = [("    if (WG == 2 && (wg == 1 || g > 0)) named_sync(kBarTurn + wg, 256);\n", ""),
          ("    if (WG == 2 && (wg == 0 || g + 1 < G)) named_arrive(kBarTurn + 1 - wg, 256);\n",
           "")]
# the trace: thread 0 of each consumer warpgroup stamps phase i of group g at
# TRACE[2 + ((block * WG + wg) * G + g) * 8 + i]; TRACE[0..1] = WG, blocks
_TRACE_SLOTS = 1 << 22


def _stamp(i: int) -> str:
    return ("    if ((threadIdx.x & 127) == 0) { const size_t at = 2 + (((size_t)(blockIdx.y * "
            "gridDim.x + blockIdx.x) * WG + wg) * G + g) * 8 + %d; if (at < %d) k5_trace[at] = "
            "clock64(); }\n" % (i, _TRACE_SLOTS))


_TRACE_AT = [
    "    const uint2 sig[2] = {sig_next[0], sig_next[1]};\n",
    "    mbar_wait(full0 + 8 * s, (g / kStages) & 1);\n",
    "    wgmma_fence();\n",
    "    wgmma_commit();\n",
    "    wgmma_wait0();\n",
    "    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage's xq, weights and xs are read\n",
]
_TRACE = [("constexpr int kStages = 4;",
           f"constexpr int kStages = 4;\n__device__ unsigned long long k5_trace[{_TRACE_SLOTS}];"),
          ("  if (threadIdx.x == 0) {\n    for (int i = 0; i < kStages; ++i) {",
           "  if (threadIdx.x == 0) {\n    if (blockIdx.x + blockIdx.y == 0) { k5_trace[0] = WG; "
           "k5_trace[1] = gridDim.x * gridDim.y; }\n    for (int i = 0; i < kStages; ++i) {"),
          ("}  // namespace\n",
           "}  // namespace\n\nextern \"C\" int w8a8_trace(void* dst, unsigned long long bytes) {\n"
           "  return static_cast<int>(cudaMemcpyFromSymbol(dst, k5_trace, bytes));\n}\n")]
_TRACE += [(_TRACE_AT[0], _stamp(0) + _TRACE_AT[0])]
_TRACE += [(line, line + _stamp(i)) for i, line in enumerate(_TRACE_AT) if i]
PHASES = ("stage_wait", "expand_and_turn", "issue", "products", "promote")

_NO_MMA = [(_MMA, "      fence_operands(d);\n")]
_NO_EXPAND = [(_EXPAND, _RAW)]
_NO_PROMOTE = [(_PROMOTE, "acc[i] = __fadd_rn(acc[i], __int_as_float(d[i]) + x);")]
ABLATIONS = {
    "route": [],
    "no_mma": _NO_MMA,
    "no_expand": _NO_EXPAND,
    "no_promote": _NO_PROMOTE,
    "loads_only": _NO_MMA + _NO_EXPAND + _NO_PROMOTE,
    "no_tma": _NO_MMA + _NO_EXPAND + _NO_PROMOTE + [(_TMA, ""), (_EXPECT, "mbar_arrive(full);")],
    "no_prepass": [(_PREPASS, "  (void)items;\n")],
    "no_turns": _TURNS,
    "trace": _TRACE,
}
# Llama-3.2-1B's prefill shapes (N, K) at M = 512
SHAPES = {"wqkv": (3072, 2048), "wo": (2048, 2048), "w13": (16384, 2048), "w2": (2048, 8192),
          "lm_head": (128256, 2048)}
M = 512


def trace_phases(lib, G: int) -> dict:
    """Median cycles of each phase of a group (g >= 1) and of the period from
    one group's start to the next, per consumer warpgroup, from the `trace`
    build's last launch."""
    head = np.zeros(2, dtype=np.uint64)
    _build.check(lib.w8a8_trace(head.ctypes.data, head.nbytes), "k5_ablate trace")
    wg, blocks = int(head[0]), int(head[1])
    buf = np.zeros(2 + blocks * wg * G * 8, dtype=np.uint64)
    _build.check(lib.w8a8_trace(buf.ctypes.data, buf.nbytes), "k5_ablate trace")
    t = buf[2:].astype(np.int64).reshape(blocks, wg, G, 8)
    out = {}
    for c in range(wg):
        phases = np.median(np.diff(t[:, c, 1:, :6], axis=-1), axis=(0, 1))
        out[f"wg{c}"] = dict(zip(PHASES, phases.tolist()),
                             period=float(np.median(np.diff(t[:, c, :, 0], axis=-1))))
    return out


def run(dev: torch.device) -> list[dict]:
    libs = build_cut_copies("w8a8_matmul", ABLATIONS, _SIGNATURES)
    libs["trace"].w8a8_trace.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    libs["trace"].w8a8_trace.restype = ctypes.c_int
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = torch.bfloat16
    rows = []
    for shape, (n, k) in SHAPES.items():
        q4 = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=dev,
                                  dtype=torch.uint8),
                    (torch.rand((n, k // 32), generator=g, device=dev) + 0.5) * 0.0043)
        w = to_q4s(q4)
        sigma, swk = w.scales
        x = torch.randn((M, k), generator=g, device=dev).to(bf16)
        y = torch.empty((M, n), dtype=bf16, device=dev)
        xq = torch.empty((M, k), dtype=torch.int8, device=dev)
        xs = torch.empty((k // GROUP, (M + 3) // 4 * 4), dtype=torch.float32, device=dev)
        plain = q4s_matmul_plain(x, w, bf16)
        wd = w.dequantize(bf16)
        lib_ms = timer(lambda: torch.matmul(x, wd.t()))
        del wd
        xq8, wq8 = int8_operands(x, w)
        int_mm_ms = timer(lambda: torch._int_mm(xq8, wq8.t()))
        del xq8, wq8
        nbytes = n * k * BITS_PER_WEIGHT / 8 + M * k * 2 + M * n * 2
        b_ms, b_by = bound(nbytes, 2.0 * M * n * k, INT8_OPS_PER_S)
        row = dict(shape=shape, M=M, N=n, K=k, library_ms=lib_ms, int_mm_ms=int_mm_ms,
                   bound_ms=b_ms, bound_by=b_by)
        args = (x.data_ptr(), 1, w.data.data_ptr(), sigma.data_ptr(), swk.data_ptr(),
                y.data_ptr(), 1, M, n, k, n, xq.data_ptr(), xs.data_ptr(), stream)
        for name, lib in libs.items():  # "route" first: it fills the scratch no_prepass reads
            _build.check(lib.w8a8_matmul(*args), f"k5_ablate {name}")
            torch.cuda.synchronize(dev)
            row[name] = dict(ms=timer(lambda: lib.w8a8_matmul(*args), sleep_cycles=SLEEP_CYCLES),
                             equal=bool(torch.equal(y, plain)))
        row["trace"]["cycles"] = trace_phases(libs["trace"], k // GROUP)
        rows.append(row)
        print(f"{shape} M={M} N={n} K={k}: torch.matmul bf16 {lib_ms:.4f} ms, torch._int_mm "
              f"{int_mm_ms:.4f}, bound {b_ms:.4f}; "
              + ", ".join(f"{a} {row[a]['ms']:.4f}{'' if row[a]['equal'] else ' (differs)'}"
                          for a in libs), flush=True)
        for c, ph in row["trace"]["cycles"].items():
            print(f"  trace {c}: " + ", ".join(f"{a} {v:.0f}" for a, v in ph.items()), flush=True)
        del q4, w, x, y, xq, xs, plain
    return rows


# ---- the decode route (M <= 16) ------------------------------------------

# stamps i of (block, warp, iteration it) at DTRACE[4 + ((block * warps + warp)
# * iters + it) * 8 + i]; DTRACE[0..2] = warps a block, blocks, iterations
_DTRACE_DECL = "__device__ unsigned long long k5_trace[%d];\n" % _TRACE_SLOTS
_DTRACE_FN = ("}  // namespace\n",
              "}  // namespace\n\nextern \"C\" int w8a8_trace(void* dst, unsigned long long bytes) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(dst, k5_trace, bytes));\n}\n")


def _dstamp(i: int, warp: str, warps: str, iters: str, it: str, lead: str = "lane == 0") -> str:
    return ("    if (%s) { const size_t at = 4 + (((size_t)blockIdx.x * %s + %s) * %s + %s) * 8 + %d;"
            " if (at < %d) k5_trace[at] = clock64(); }\n"
            % (lead, warps, warp, iters, it, i, _TRACE_SLOTS))


def _dhead(warps: str, iters: str) -> str:
    return ("  if (blockIdx.x == 0 && threadIdx.x == 0) { k5_trace[0] = %s; k5_trace[1] = gridDim.x;"
            " k5_trace[2] = %s; }\n" % (warps, iters))


# the decode kernel at commit f4e550f (x quantized by every block's warps,
# mma.sync with x as A)
_OLD_MARK = "    for (int r0 = 0; r0 < M; r0 += 4) quantize_rows<4>(x, M, K, g, lane, r0, tile, xs[warp]);\n"
_OLD_MMA = "        mma_s8(c[j], a[0], a[1], a[2], a[3], bb[0], bb[1]);\n"
_OLD_EXPAND = ("  bb[0] = signed_weights(word & 0x0F0F0F0Fu, sig);\n"
               "  bb[1] = signed_weights((word >> 4) & 0x0F0F0F0Fu, sig);\n")
_OLD_PROMOTE = "    for (int j = 0; j < NF; ++j) scale_add(acc[j], c[j], xs0, xs1, f[j].sw);\n"
_OLD_ITERS, _OLD_IT = "((G + kDecWarps - 1) / kDecWarps)", "(g / kDecWarps)"
_OLD_AT = ["    WFrag f[NF];  // issued first: their latency overlaps the quantization\n",
           "    int c[NF][4];\n",
           "    const float xs0 = xs[warp][gid], xs1 = xs[warp][gid + 8];\n"]
_OLD_TRACE = [("constexpr int kRowBytes = kGroup + 16;  // padded int8 row of a quantized x tile\n",
               "constexpr int kRowBytes = kGroup + 16;  // padded int8 row of a quantized x tile\n"
               + _DTRACE_DECL),
              ("  int8_t* tile = tiles[warp];\n",
               "  int8_t* tile = tiles[warp];\n" + _dhead("kDecWarps", _OLD_ITERS)),
              _DTRACE_FN]
_OLD_TRACE += [(line, _dstamp(i, "warp", "kDecWarps", _OLD_ITERS, _OLD_IT) + line)
               for i, line in enumerate(_OLD_AT)]
_OLD_TRACE += [(_OLD_PROMOTE, _OLD_PROMOTE + _dstamp(3, "warp", "kDecWarps", _OLD_ITERS, _OLD_IT))]
_OLD_NO = {
    "no_quant": [(_OLD_MARK, "")],
    "no_mma": [(_OLD_MMA, '        asm volatile("" : "+r"(c[j][0]) : "r"(a[0] ^ a[1] ^ a[2] ^ a[3]), '
                          '"r"(bb[0] ^ bb[1]));\n')],
    "no_expand": [(_OLD_EXPAND, "  bb[0] = word ^ sig;\n  bb[1] = word >> 4;\n")],
    "no_promote": [(_OLD_PROMOTE, "    for (int j = 0; j < NF; ++j) for (int e = 0; e < 4; ++e) "
                                  "acc[j][e] += __int_as_float(c[j][e] + "
                                  "__float_as_int(f[j].sw[e & 1]));\n")],
}
DECODE_ABLATIONS_OLD = {"route": [], **_OLD_NO,
                        "loads_only": [c for cut in _OLD_NO.values() for c in cut],
                        "trace": _OLD_TRACE}
OLD_PHASES = ("quantize", "products", "promote")

# the decode kernel of this tree
_D_MMA = "            mma_s8(d[b & 1][j], a0, a1, a2, a3, bx[j][2 * b], bx[j][2 * b + 1]);\n"
_D_EXPAND = ("          const uint32_t a0 = expand_lo(w0[b], s0, c0), a1 = expand_lo(w1[b], s1, c1);\n"
             "          const uint32_t a2 = expand_hi(w0[b], s0, c0), a3 = expand_hi(w1[b], s1, c1);\n")
_D_PROMOTE = ("                __fmul_rn(__fmul_rn(exact_f32(d[0][j][e] + d[1][j][e]), xv[j][e & 1]),\n"
              "                          swk[i][e >> 1]);\n")
_D_PREPASS = """  w8a8_quantize_kernel<TX, true><<<(items + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, st>>>(
      x, xq, xs, M, K, Mp);
"""
_D_PDL = "  attr[0].val.programmaticStreamSerializationAllowed = kInline ? 0 : 1;\n"
_D_NO = {
    "no_mma": [(_D_MMA, '            asm volatile("" : "+r"(d[b & 1][j][0]) : "r"(a0 ^ a1 ^ a2 ^ a3), '
                        '"r"(bx[j][2 * b] ^ bx[j][2 * b + 1]));\n')],
    "no_expand": [(_D_EXPAND, "          const uint32_t a0 = w0[b] ^ c0, a1 = w1[b] ^ c1, "
                              "a2 = w0[b] >> 4, a3 = w1[b] >> 4;\n")],
    "no_promote": [(_D_PROMOTE, "                __int_as_float(d[0][j][e] + d[1][j][e]) + "
                                "xv[j][e & 1] + swk[i][e >> 1];\n")],
}
_D_ITERS = "((G + W - 1) / W)"
_D_STAMP = lambda i: _dstamp(i, "warp", "W", "rounds", "r")  # noqa: E731
_D_AT = ["    if (g < G) {  // warp-uniform\n", "      const int s = r % D::kS;\n",
         "      if (g + W < G) load_scales(g + W);\n"]
_D_TRACE = [("constexpr int kInlineMaxM = ", _DTRACE_DECL + "constexpr int kInlineMaxM = "),
            ("  float* const wprod = prod + warp * D::kTok * D::kPStride;\n",
             "  float* const wprod = prod + warp * D::kTok * D::kPStride;\n" + _dhead("W", _D_ITERS)),
            _DTRACE_FN,
            (_D_AT[0], _D_AT[0] + _D_STAMP(0) + "      long long tprom_ = 0;\n"),
            (_D_AT[1], _D_STAMP(1) + _D_AT[1]),
            ("      const uint8_t* const box = wring + s * D::kBox;\n",
             "      const uint8_t* const box = wring + s * D::kBox;\n" + _D_STAMP(2)),
            ("        // d[j][e]: row 16 i + gid + 8 (e / 2), token 8 j + 2 tig + e % 2\n",
             "        const long long tp0_ = clock64();\n"
             "        // d[j][e]: row 16 i + gid + 8 (e / 2), token 8 j + 2 tig + e % 2\n"),
            (_D_PROMOTE + "      }\n", _D_PROMOTE + "        tprom_ += clock64() - tp0_;\n      }\n"),
            (_D_AT[2], _D_STAMP(3).replace("clock64()", "clock64() - tprom_") + _D_STAMP(4)
             + _D_AT[2]),
            ("    if (r + 1 < rounds) __syncthreads();  // the products are read: the next round's "
             "may come\n",
             "    if (r + 1 < rounds) __syncthreads();  // the products are read: the next round's "
             "may come\n" + _D_STAMP(5))]
DECODE_PHASES = ("x", "stage_wait", "products", "promote", "combine")
# the weights by cp.async.cg in place of TMA: the warp's lanes copy each box,
# 16 bytes a lane at a time, into the same 128-byte swizzle (rows past N
# zero-filled), and each lane's copies complete on the stage's barrier
_CP_BOX = """  const auto cp_box = [&](int g, uint32_t dst, uint32_t bar) {
    for (int c = lane; c < D::kBN * 8; c += 32) {
      const int row = c >> 3, ch = c & 7, n = n0 + row;
      const uint8_t* src = wraw + (size_t)(n < N ? n : 0) * (K / 2) + g * 128 + ch * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(
                       dst + row * 128 + ((ch ^ (row & 7)) << 4)),
                   "l"(__cvta_generic_to_global(src)), "r"(n < N ? 16 : 0) : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\\n" ::"r"(bar) : "memory");
  };
  if (lane == 0) {
    for (int s = 0; s <= D::kS; ++s) mbar_init(s < D::kS ? full0 + 8 * s : xbar, s < D::kS ? 32 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncwarp();
  for (int r = 0; r < D::kS && r * W + warp < G; ++r)
    cp_box(r * W + warp, smem_u32(wring + r * D::kBox), full0 + 8 * r);
"""
_TMA_RING = """  if (lane == 0) {  // the warp's ring: its first kS groups
    for (int s = 0; s <= D::kS; ++s) mbar_init(s < D::kS ? full0 + 8 * s : xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    for (int r = 0; r < D::kS && r * W + warp < G; ++r) {
      mbar_arrive_expect_tx(full0 + 8 * r, D::kBox);
      tma_load_2d(smem_u32(wring + r * D::kBox), &wmap, (r * W + warp) * (kGroup / 2), n0,
                  full0 + 8 * r);
    }
  }
  __syncwarp();
"""
_TMA_REFILL = """      if (lane == 0 && g + D::kS * W < G) {
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        mbar_arrive_expect_tx(full0 + 8 * s, D::kBox);
        tma_load_2d(smem_u32(box), &wmap, (g + D::kS * W) * (kGroup / 2), n0, full0 + 8 * s);
      }
"""
_CP_ASYNC = [
    ("w8a8_decode_kernel(const __grid_constant__ CUtensorMap wmap, const TX* __restrict__ x,\n",
     "w8a8_decode_kernel(const __grid_constant__ CUtensorMap wmap, const uint8_t* __restrict__ wraw,\n"
     "                   const TX* __restrict__ x,\n"),
    ("w8a8_decode_kernel<TX, TY, T, J, W, kInline>, wmap,\n",
     "w8a8_decode_kernel<TX, TY, T, J, W, kInline>, wmap, w,\n"),
    (_TMA_RING, _CP_BOX),
    (_TMA_REFILL, "      if (g + D::kS * W < G) cp_box(g + D::kS * W, smem_u32(box), full0 + 8 * s);\n")]


def _inline_cuts() -> dict:
    """The split point's comparison: builds with x quantized by the pre-pass
    at every M (with and without programmatic dependent launch) and in the
    launch up to M = 8, beside the source's own kInlineMaxM."""
    src = (_build.CSRC / "w8a8_matmul.cu").read_text()
    found = re.search(r"constexpr int kInlineMaxM = (\d+);\n", src)
    if found is None:
        return {}
    cuts = {f"inline_upto_{v}": [(found.group(0), f"constexpr int kInlineMaxM = {v};\n")]
            for v in (0, 8) if v != int(found.group(1))}
    cuts["prepass_no_pdl"] = [(found.group(0), "constexpr int kInlineMaxM = 0;\n"),
                              (_D_PDL, _D_PDL.replace("kInline ? 0 : 1", "0"))]
    return cuts


DECODE_ABLATIONS = {"route": [], **_D_NO, "loads_only": [c for cut in _D_NO.values() for c in cut],
                    "no_prepass": [(_D_PREPASS, "  (void)items;\n")], "cp_async": _CP_ASYNC,
                    **_inline_cuts(), "trace": _D_TRACE}
# builds timed at every M of DECODE_MS_ALL (the others at M = 1 and 16)
DECODE_SPLIT = ("route", "inline_upto_0", "inline_upto_8", "prepass_no_pdl")
DECODE_MS_ALL = (1, 2, 4, 8, 16)

DECODE_SHAPES = {"wqkv": (3072, 2048), "wo": (2048, 2048), "w13": (16384, 2048),
                 "w2": (2048, 8192), "lm_head": (128256, 2048)}
LAYERS = 16  # Llama-3.2-1B: a decode step is 16 x (wqkv, wo, w13, w2) + the lm_head


def decode_trace(lib, phases: tuple[str, ...]) -> dict:
    """Median cycles of each phase (between consecutive stamps) over the
    warps and iterations that stamped all of them, and of the period from
    one iteration's start to the next, from the `trace` build's last launch."""
    head = np.zeros(4, dtype=np.uint64)
    _build.check(lib.w8a8_trace(head.ctypes.data, head.nbytes), "k5_ablate trace")
    warps, blocks, iters = (int(v) for v in head[:3])
    n = min(_TRACE_SLOTS, 4 + blocks * warps * iters * 8)
    buf = np.zeros(n, dtype=np.uint64)
    _build.check(lib.w8a8_trace(buf.ctypes.data, buf.nbytes), "k5_ablate trace")
    rows = (n - 4) // 8
    t = buf[4:4 + rows * 8].astype(np.int64).reshape(rows, 8)[:, :len(phases) + 1]
    full = t[(t > 0).all(axis=1)]
    out = dict(zip(phases, np.median(np.diff(full, axis=1), axis=0).tolist()))
    if iters > 1 and rows == blocks * warps * iters:
        starts = t[:, 0].reshape(blocks * warps, iters)
        ok = (starts > 0).all(axis=1)
        if ok.any():
            out["period"] = float(np.median(np.diff(starts[ok], axis=1)))
    return out


def run_decode(dev: torch.device, source: str | None = None, ms=(1, 16)) -> list[dict]:
    src = Path(source).read_text() if source else None
    old = src is not None and _OLD_MARK in src
    cuts = DECODE_ABLATIONS_OLD if old else DECODE_ABLATIONS
    text = src if src is not None else (_build.CSRC / "w8a8_matmul.cu").read_text()
    sigs = {fn: a for fn, a in _SIGNATURES.items() if fn in text}  # the old source has fewer
    libs = build_cut_copies("w8a8_matmul", cuts, sigs, src=src,
                            tag="_decode_old" if old else "_decode")
    libs["trace"].w8a8_trace.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    libs["trace"].w8a8_trace.restype = ctypes.c_int
    phases = OLD_PHASES if old else DECODE_PHASES
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for shape, (n, k) in DECODE_SHAPES.items():
        q4 = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=dev,
                                  dtype=torch.uint8),
                    (torch.rand((n, k // 32), generator=g, device=dev) + 0.5) * 0.0043)
        w = to_q4s(q4)
        sigma, swk = w.scales
        wd = w.dequantize(bf16)
        out_dtype = f32 if shape == "lm_head" else bf16
        split = any(a in DECODE_SPLIT for a in libs)
        for m in sorted(set(ms) | (set(DECODE_MS_ALL) if split else set())):
            mset = [a for a in libs if m in (DECODE_MS_ALL if a in DECODE_SPLIT else ms)]
            x = torch.randn((m, k), generator=g, device=dev).to(bf16)
            y = torch.empty((m, n), dtype=out_dtype, device=dev)
            xq = torch.empty((max(m, libs["route"].w8a8_decode_max_m()), k), dtype=torch.int8,
                             device=dev)
            xs = torch.empty((k // GROUP, (m + 3) // 4 * 4), dtype=f32, device=dev)
            plain = q4s_matmul_plain(x, w, out_dtype)
            lib_ms = timer(lambda: torch.matmul(x, wd.t()))
            nbytes = n * k * BITS_PER_WEIGHT / 8 + m * k * 2 + m * n * y.element_size()
            b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
            row = dict(shape=shape, M=m, N=n, K=k, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            args = (x.data_ptr(), 1, w.data.data_ptr(), sigma.data_ptr(), swk.data_ptr(),
                    y.data_ptr(), 1 if out_dtype == bf16 else 0, m, n, k, n, xq.data_ptr(),
                    xs.data_ptr(), stream)
            for name in mset:  # "route" first: it fills the scratch no_prepass reads
                lib = libs[name]
                _build.check(lib.w8a8_matmul(*args), f"k5_ablate {name}")
                torch.cuda.synchronize(dev)
                err = (y.float() - plain.float()).abs().max().item()
                row[name] = dict(ms=timer(lambda: lib.w8a8_matmul(*args),
                                          sleep_cycles=SLEEP_CYCLES),
                                 equal=bool(torch.equal(y, plain)),
                                 rel_err=err / max(plain.float().abs().max().item(), 1e-30))
            if "trace" in mset:
                _build.check(libs["trace"].w8a8_matmul(*args), "k5_ablate trace")
                torch.cuda.synchronize(dev)
                row["trace"]["cycles"] = decode_trace(libs["trace"], phases)
            rows.append(row)
            print(f"{shape} M={m} N={n} K={k}: torch.matmul bf16 {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f}; " + ", ".join(
                      f"{a} {row[a]['ms']:.4f}{'' if row[a]['equal'] else ' (differs)'}"
                      for a in mset), flush=True)
            if "trace" in mset:
                print("  trace: " + ", ".join(f"{a} {v:.0f}"
                                              for a, v in row["trace"]["cycles"].items()),
                      flush=True)
            del x, y, xq, xs, plain
        del q4, w, wd
    # each build's 16-slot decode step: 16 layers x (wqkv, wo, w13, w2) + the lm_head
    for m in sorted({r["M"] for r in rows}):
        at = {r["shape"]: r for r in rows if r["M"] == m}
        if set(at) != set(DECODE_SHAPES):
            continue
        names = [a for a in libs if a in at["lm_head"]] + ["library"]
        step = {}
        for a in names:
            key = (lambda r: r["library_ms"]) if a == "library" else (lambda r, a=a: r[a]["ms"])
            step[a] = LAYERS * sum(key(at[s]) for s in DECODE_SHAPES if s != "lm_head") \
                + key(at["lm_head"])
        bound_step = LAYERS * sum(at[s]["bound_ms"] for s in DECODE_SHAPES if s != "lm_head") \
            + at["lm_head"]["bound_ms"]
        rows.append(dict(shape="decode_step", M=m, step_ms=step, bound_ms=bound_step))
        print(f"decode step M={m}: " + ", ".join(f"{a} {v:.4f}" for a, v in step.items())
              + f" ms, bound {bound_step:.4f}", flush=True)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("prefill", "decode"), default="prefill")
    ap.add_argument("--source", help="decode: ablate this copy of csrc/w8a8_matmul.cu")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    rows = run(dev) if args.route == "prefill" else run_decode(dev, args.source)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=torch.cuda.get_device_name(dev),
                                                  rows=rows), indent=1))
    return rows


if __name__ == "__main__":
    main()
