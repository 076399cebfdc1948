"""Ablations of K5's wgmma route (M > 16) on the card: where its time goes.

    python -m jlama_tpu_torch.scripts.k5_ablate [--out FILE]

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
`no_prepass`, `no_turns` and `trace` compute the function). Card only: it
raises without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
_PREPASS = """  w8a8_quantize_kernel<TX><<<(items + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, st>>>(
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


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    rows = run(dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=torch.cuda.get_device_name(dev),
                                                  rows=rows), indent=1))
    return rows


if __name__ == "__main__":
    main()
