"""Ablations of K2 (split-KV paged decode) on the card: where its time goes.

    python -m jlama_tpu_torch.scripts.k2_ablate [--out FILE]

Builds `csrc/paged_decode.cu` as it is and copies of it with parts of its
tensor-core route (bf16 q, which every case here takes) cut out,
each with nvcc into `_build/ablate_paged_decode/`, and times every build
through the `paged_decode` wrapper at the cases of `chip_smoke.py`'s phase 3
(Llama-3.2-1B's heads at 16 ragged serving rows, lengths 1-2048 on pages of
64, bf16 and q8 pools; 32 query heads on one KV head; head size 128 with
softcap and window; the Engine's dense row, 640 live keys of a 2,048-slot
cache cut to a 1,024-slot window), beside the bound, the yardstick (the
gather of the live pages and SDPA, or SDPA on the dense prefix) and an empty
launch:

- `route`: the source as it is;
- `no_qk`: no Q.K `mma` (the scores stay 0; the K fragments are still loaded);
- `no_pv`: no P.V `mma` (the V fragments are still loaded);
- `no_exp`: the probabilities' exponential cut to its argument;
- `no_math`: all three: the loads, the barriers, the partials and the merge;
- `no_loads`: no cp.async of K/V (the math runs on stale shared memory);
- `no_merge`: a row over several splits writes its partials and takes its
  ticket, and no block merges (its output is not written);
- `no_partials`: such a row's blocks return before writing their partials;
- `launch_only`: every block returns once it has read its row's length;
- `stages_3`, `stages_4`: a ring of 3 or 4 stages in place of 2;
- `trace`: the route with `clock64` and `%globaltimer` stamps by thread 0 of
  each block (`trace_phases`: when each block starts and ends, and the
  cycles of each phase, median and max over the live blocks).

With the route's build, the split: `one_split` (one block walks each (row,
KV head) from its first key to its last, as the kernel before the split
did), `half_splits` and `double_splits` (half and twice the route's splits).

The timer's L2 flush (PERF.md §7): each case is also timed back to back,
without a flush, over four copies of its pools in turn (`rotate_ms`: each
copy's live bytes are cold in a 50 MB L2 after the other three) and over one
copy (`warm_ms`: they stay in L2). Only `route` and the split variants compute
the function; each row gives its max |error| against the plain version.
Card only: it raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..nn.qarray import QArray
from ..ops import _build, attention
from ..ops.attention import _PD_SIGNATURES, paged_decode, paged_decode_plain
from ..ops.kv_write import POOL_CODE, dense_page_table, dense_pool_view
from ..quant.blockq import q8_quantize
from ..utils.cuda_timer import Timer, bound
from ._common import SLEEP_CYCLES, build_cut_copies

# the cuts act on the tensor-core route, which the cases' bf16 q take
_NO_QK = [("              mma_bf16(sf[mt][0], qa[mt][ks], kf[0], kf[1]);\n"
           "              mma_bf16(sf[mt][1], qa[mt][ks], kf[2], kf[3]);\n", "")]
_NO_PV = [("            mma_bf16(o[mt][2 * nd2], ph[mt], vf[0], vf[1]);\n"
           "            mma_bf16(o[mt][2 * nd2], pl[mt], vf[0], vf[1]);\n"
           "            mma_bf16(o[mt][2 * nd2 + 1], ph[mt], vf[2], vf[3]);\n"
           "            mma_bf16(o[mt][2 * nd2 + 1], pl[mt], vf[2], vf[3]);\n", "")]
_NO_EXP = [("const float pv = ok[x] ? exp2f(z[x] - m_new) : 0.0f;",
            "const float pv = ok[x] ? (z[x] - m_new) : 0.0f;")]
_STAGES = "  static constexpr int kStages = 4 * kTileBytes <= 160 * 1024 ? 2 : 1;"
# the trace: thread 0 of block n stamps TRACE[4 + 16 n + i] (`k2_trace`);
# clock64 cycles unless named: 0 start (globaltimer ns), 1 start, 2 its row's
# length read and its split live, 3 q staged (the main loop starts), 4-7 the
# tiles' sums (warp 0, tensor-core route) of: the wait for a tile, the next
# tile's copies issued and S = Q K^T, the softmax, P.V; 8 the
# loop's end, 9 the key subsets summed, 10 the output written or the ticket
# taken, 11 the last stamp (globaltimer ns), 12 the merge's end, 13 1 for the
# merging block, 14 tiles, 15 1 for a live block
_TRACE_SLOTS = 1 << 20
_T = "TR_[%d]"


def _stamp(body: str) -> str:
    return f"  if (threadIdx.x == 0 && TR_ != nullptr) {{ {body} }}\n"


_TRACE = [
    ("constexpr float kNegInf = -1e30f;\n",
     "constexpr float kNegInf = -1e30f;\n"
     f"__device__ unsigned long long k2_trace[{_TRACE_SLOTS}];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t;\n}\n"),
    ("  const int b = blockIdx.z;\n",
     "  const int b = blockIdx.z;\n"
     "  const long long tr_n = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x;\n"
     f"  unsigned long long* TR_ = 4 + 16 * tr_n + 16 <= {_TRACE_SLOTS} ? k2_trace + 4 + 16 * tr_n "
     ": nullptr;\n"
     + _stamp("for (int i = 0; i < 16; ++i) TR_[i] = 0; TR_[0] = gtime(); TR_[1] = clock64();")),
    ("  if (split < s_first || split > s_last) return;\n",
     "  if (split < s_first || split > s_last) return;\n"
     + _stamp("TR_[2] = clock64(); TR_[15] = 1; TR_[11] = gtime();")),
    ("  float* pw = pw_all + warp * GM * kKW;",
     _stamp("TR_[3] = clock64(); TR_[14] = n_t;") + "  float* pw = pw_all + warp * GM * kKW;"),
    ("  for (int it = 0; it < n_t; ++it) {\n",
     "  long long tr_c = clock64();\n  for (int it = 0; it < n_t; ++it) {\n"
     "  " + _stamp("if (it > 0) TR_[7] += clock64() - tr_c;") + "    tr_c = clock64();\n"),
    ("    __syncthreads();  // tile it has landed; the stage refilled below is free\n",
     "    __syncthreads();  // tile it has landed; the stage refilled below is free\n"
     "  " + _stamp("TR_[4] += clock64() - tr_c;") + "    tr_c = clock64();\n"),
    ("        // the online softmax of the lane's rows over the warp's keys (a quad)\n",
     "      " + _stamp("TR_[5] += clock64() - tr_c;") + "        tr_c = clock64();\n"
     "        // the online softmax of the lane's rows over the warp's keys (a quad)\n"),
    ("        // O += P V: V fragments transposed from the [key][dim] tile\n",
     "      " + _stamp("TR_[6] += clock64() - tr_c;") + "        tr_c = clock64();\n"
     "        // O += P V: V fragments transposed from the [key][dim] tile\n"),
    ("  // the warps' key subsets, then the warps in order: the block's max, sum\n",
     _stamp("if (n_t > 0) TR_[7] += clock64() - tr_c; TR_[8] = clock64();")
     + "  // the warps' key subsets, then the warps in order: the block's max, sum\n"),
    ("\n  if (n_live == 1) {  // the row's only split: the output at once\n",
     _stamp("TR_[9] = clock64();")
     + "\n  if (n_live == 1) {  // the row's only split: the output at once\n"),
    ("      store_out(a, o_base + (o / HD) * a.o_h + o % HD, red[o] / bl_s[o / HD]);\n    return;\n",
     "      store_out(a, o_base + (o / HD) * a.o_h + o % HD, red[o] / bl_s[o / HD]);\n"
     "  " + _stamp("TR_[10] = clock64(); TR_[11] = gtime();") + "    return;\n"),
    ("  if (!flag_s[0]) return;\n",
     _stamp("TR_[10] = clock64(); TR_[11] = gtime();") + "  if (!flag_s[0]) return;\n"),
    ("  if (tid == 0) a.tickets[tb] = 0;  // every split has taken its ticket\n",
     "  if (tid == 0) a.tickets[tb] = 0;  // every split has taken its ticket\n"
     + _stamp("TR_[12] = clock64(); TR_[11] = gtime(); TR_[13] = 1;")),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int paged_decode_trace(void* dst, unsigned long long bytes) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, k2_trace, bytes));\n}\n"),
]
ABLATIONS = {
    "route": [],
    "no_qk": _NO_QK,
    "no_pv": _NO_PV,
    "no_exp": _NO_EXP,
    "no_math": _NO_QK + _NO_PV + _NO_EXP,
    "no_loads": [("        cp_async16(dk, kbase + (pg * a.k_p + sl * a.k_s) * C::kEB + c * 16);\n"
                  "        cp_async16(dk + C::kTileBytes, vbase + (pg * a.v_p + sl * a.v_s) * C::kEB"
                  " + c * 16);\n", "")],
    "no_merge": [("  if (!flag_s[0]) return;", "  return;")],
    "no_partials": [("  // this split's partial, then a ticket; the last block merges\n",
                     "  return;\n")],
    "launch_only": [("  if (split < s_first || split > s_last) return;",
                     "  if (split >= 0) return;")],
    "stages_3": [(_STAGES, _STAGES.replace("? 2 :", "? 3 :"))],
    "stages_4": [(_STAGES, _STAGES.replace("? 2 :", "? 4 :"))],
    "trace": _TRACE,
}
COMPUTES = ("route", "stages_3", "stages_4", "trace")
# chip_smoke.py's K2_LENGTHS, pages and dense row
LENGTHS = [1, 2048, 1500, 1024, 777, 64, 65, 300, 2000, 129, 1, 513, 1800, 256, 999, 1234]
N_PAGES, PAGE, P_MAX = 512, 64, 32
DENSE_S, DENSE_WIN, DENSE_LIVE = 2048, 1024, 640
CASES = {  # name: (H, n_kv, hd, pool kind, softcap, window)
    "serving_bf16": (32, 8, 64, "bf16", None, None),
    "serving_q8": (32, 8, 64, "q8", None, None),
    "mqa": (32, 1, 64, "bf16", None, None),
    "hd128_cap_win": (32, 8, 128, "bf16", 30.0, 256),
    "dense_engine": (32, 8, 64, "bf16", None, None),
}
N_COPIES = 4


def kp_kind(kind):
    """The pool kind as `POOL_CODE` keys it."""
    return "q8" if kind == "q8" else torch.bfloat16


def _inputs(case, dev, g):
    """(q bf16, [(k pool, v pool)] * N_COPIES, page tables, lengths, SDPA call)."""
    H, n_kv, hd, kind, cap, win = CASES[case]
    if case == "dense_engine":
        caches = [[torch.randn((1, n_kv, DENSE_S, hd), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(2)] for _ in range(N_COPIES)]
        pools = [tuple(dense_pool_view(c[:, :, :DENSE_WIN]) for c in kv) for kv in caches]
        pt = dense_page_table(1, dev)
        lens = [DENSE_LIVE]
        q = torch.randn((1, H, hd), generator=g, device=dev).to(torch.bfloat16)
        k0, v0 = caches[0]
        lib = (lambda: F.scaled_dot_product_attention(
            q[:, :, None], k0[:, :, :DENSE_LIVE], v0[:, :, :DENSE_LIVE], scale=hd ** -0.5,
            enable_gqa=True))
        return q, pools, pt, torch.tensor(lens, dtype=torch.int32, device=dev), lib, lens

    def pool():
        x = torch.randn((n_kv, N_PAGES, PAGE, hd), generator=g, device=dev)
        return QArray(*q8_quantize(x), "q8") if kind == "q8" else x.to(torch.bfloat16)

    pools = [(pool(), pool()) for _ in range(N_COPIES)]
    pt = torch.zeros((len(LENGTHS), P_MAX), dtype=torch.int32)
    perm = (torch.randperm(N_PAGES - 1, generator=torch.Generator().manual_seed(4)) + 1)
    nxt = 0
    for b, ln in enumerate(LENGTHS):
        if ln > 1:
            n = -(-ln // PAGE)
            pt[b, :n] = perm[nxt:nxt + n].to(torch.int32)
            nxt += n
    pt = pt.to(dev)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((len(LENGTHS), H, hd), generator=g, device=dev).to(torch.bfloat16)
    lib = None
    if cap is None:
        kpos = torch.arange(P_MAX * PAGE, device=dev)[None, :]
        mask = (kpos < lengths[:, None].long())[:, None, None, :]

        def gather(p):
            if kind == "q8":
                d, sc = p.data[:, pt.long()], p.scales[:, pt.long()]
                x = (d.float().reshape(*d.shape[:-1], -1, 32) * sc[..., None]).reshape(d.shape)
                x = x.to(torch.bfloat16)
            else:
                x = p[:, pt.long()]
            return x.permute(1, 0, 2, 3, 4).reshape(len(LENGTHS), n_kv, P_MAX * PAGE, hd)

        k0, v0 = pools[0]
        lib = (lambda: F.scaled_dot_product_attention(
            q[:, :, None], gather(k0), gather(v0), attn_mask=mask, scale=hd ** -0.5,
            enable_gqa=True))
    return q, pools, pt, lengths, lib, LENGTHS


def _back_to_back_ms(calls, reps=40) -> float:
    """Device ms a call, `reps` calls queued back to back (no flush)."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    s.record()
    for i in range(reps):
        calls[i % len(calls)]()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def trace_phases(lib, n_blocks: int) -> dict:
    """Medians and maxima over the live blocks of one traced launch: µs from
    the first block's start to each block's start and end (globaltimer), and
    cycles of each phase (clock64; the tiles' phases per tile)."""
    import ctypes

    import numpy as np

    lib.paged_decode_trace.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    lib.paged_decode_trace.restype = ctypes.c_int
    buf = np.zeros(4 + 16 * n_blocks, dtype=np.uint64)
    _build.check(lib.paged_decode_trace(buf.ctypes.data, buf.nbytes), "k2_ablate trace")
    t = buf[4:].reshape(n_blocks, 16).astype(np.float64)
    t = t[t[:, 15] == 1]
    t0 = t[:, 0].min()
    tiles = np.maximum(t[:, 14], 1)
    cols = {
        "start_us": (t[:, 0] - t0) / 1e3,
        "end_us": (t[:, 11] - t0) / 1e3,
        "block_us": (t[:, 11] - t[:, 0]) / 1e3,
        "length_read": t[:, 2] - t[:, 1],
        "q_staged": t[:, 3] - t[:, 2],
        "tile_wait": t[:, 4] / tiles,
        "tile_issue_qk": t[:, 5] / tiles,
        "tile_softmax": t[:, 6] / tiles,
        "tile_pv": t[:, 7] / tiles,
        "tiles": t[:, 14],
        "subset_sum": t[:, 9] - t[:, 8],
        "out_or_ticket": t[:, 10] - t[:, 9],
    }
    m = t[t[:, 13] == 1]
    if len(m):
        cols["merge"] = m[:, 12] - m[:, 10]
    return {k: dict(median=float(np.median(v)), max=float(np.max(v))) for k, v in cols.items()}


def _split_plan(route_plan, n_tiles, n_splits):
    """A plan of `n_splits` (at most one per 64-key tile) with the route's
    entry size."""
    r_splits, _, floats, tickets = route_plan
    n_splits = max(1, min(n_tiles, n_splits, 64))  # csrc/paged_decode.cu's kMaxSplits
    per = -(-n_tiles // n_splits)
    n_splits = -(-n_tiles // per)
    return (n_splits, per * 64, floats // r_splits * n_splits, tickets)


def run(dev: torch.device) -> list[dict]:
    libs = build_cut_copies("paged_decode", ABLATIONS, _PD_SIGNATURES)
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    route_plan_fn = attention._plan
    rows = []
    try:
        for case, (H, n_kv, hd, kind, cap, win) in CASES.items():
            q, pools, pt, lengths, lib_call, lens = _inputs(case, dev, g)
            kp, vp = pools[0]
            scale = hd ** -0.5

            def call(k=kp, v=vp):
                return paged_decode(q, k, v, pt, lengths, scale, cap, win)

            ref = paged_decode_plain(q, kp, vp, pt, lengths, scale, cap, win).float()
            live = [ln - (max(0, ln - win) if win else 0) for ln in lens]
            per_key = hd + hd // 32 * 4 if kind == "q8" else 2 * hd
            nbytes = sum(live) * n_kv * 2 * per_key + 4 * len(lens) * H * hd
            b_ms, b_by = bound(nbytes, 4.0 * H * hd * sum(live))
            row = dict(case=case, H=H, n_kv=n_kv, hd=hd, pool=kind, softcap=cap, window=win,
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=timer(lib_call) if lib_call else None,
                       empty_launch_ms=timer(lambda: torch.cuda._sleep(1)))
            for name, lib in libs.items():
                _build._LIBS["paged_decode"] = lib
                attention._TICKETS.clear()  # no_merge leaves its tickets taken
                got = call().float()
                torch.cuda.synchronize(dev)
                row[name] = dict(ms=timer(call, sleep_cycles=SLEEP_CYCLES),
                                 err=(got - ref).abs().max().item())
                if name == "trace":  # the last timed launch's stamps
                    P, ps = pt.shape[1], kp.shape[2] if kind != "q8" else PAGE
                    n_splits, _, _, pairs = attention._plan(
                        len(lens), H, n_kv, hd, P, ps, 1, POOL_CODE[kp_kind(kind)],
                        q.device.index)
                    row["trace_phases"] = trace_phases(lib, n_splits * pairs)
                if name == "route":
                    calls = [lambda k=k, v=v: call(k, v) for k, v in pools]
                    row["rotate_ms"] = _back_to_back_ms(calls)
                    row["warm_ms"] = _back_to_back_ms(calls[:1])
            _build._LIBS["paged_decode"] = libs["route"]
            attention._TICKETS.clear()
            P, ps = pt.shape[1], kp.shape[2] if kind != "q8" else PAGE
            plan = route_plan_fn(len(lens), H, n_kv, hd, P, ps, 1, POOL_CODE[kp_kind(kind)],
                                 q.device.index)
            n_tiles = -(-P * ps // 64)
            row["route_splits"] = plan[0]
            for name, n in (("one_split", 1), ("half_splits", max(1, plan[0] // 2)),
                            ("double_splits", 2 * plan[0])):
                sp = _split_plan(plan, n_tiles, n)
                attention._plan = lambda *a, sp=sp: sp
                got = call().float()
                torch.cuda.synchronize(dev)
                row[name] = dict(ms=timer(call, sleep_cycles=SLEEP_CYCLES), splits=sp[0],
                                 err=(got - ref).abs().max().item())
                attention._plan = route_plan_fn
            rows.append(row)
            names = list(libs) + ["one_split", "half_splits", "double_splits"]
            print(f"  trace {case}: " + ", ".join(
                f"{k} {v['median']:.1f}/{v['max']:.1f}" for k, v in row["trace_phases"].items()),
                flush=True)
            print(f"{case}: bound {b_ms:.4f} ms by {b_by}, library {row['library_ms']}, empty "
                  f"launch {row['empty_launch_ms']:.4f}, {plan[0]} splits; route flushed "
                  f"{row['route']['ms']:.4f}, rotated {row['rotate_ms']:.4f}, warm "
                  f"{row['warm_ms']:.4f}; " + ", ".join(f"{a} {row[a]['ms']:.4f}" for a in names),
                  flush=True)
            bad = {a: row[a]["err"] for a in list(COMPUTES) + names[-3:] if row[a]["err"] > 3e-2}
            if bad:
                raise RuntimeError(f"k2_ablate {case}: a computing build disagrees: {bad}")
            del q, pools, kp, vp, ref
    finally:
        attention._plan = route_plan_fn
        _build._LIBS.pop("paged_decode", None)
        attention._TICKETS.clear()
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
