"""Ablations of K1's routes on the card: where their time goes.

    python -m jlama_tpu_torch.scripts.k1_ablate [--route prefill|gemv] [--baseline FILE]
                                                [--out FILE]

`--route prefill` (the default) ablates the wgmma route (M > 16) as below;
`--route gemv` the GEMV (M = 1), further below.

Builds `csrc/q4_matmul.cu` as it is and copies of it with parts of the
wgmma route cut out, each with nvcc into `_build/ablate_q4_matmul/`, and
times every build at Llama-3.2-1B's prefill shapes (M = 512) beside
`torch.matmul` on a bf16 weight and the bound:

- `route`: the source as it is;
- `no_fence`: without the dequant warpgroup's `fence.proxy.async` (its output
  is wrong: the check shows what the fence is for);
- `no_dequant`: the dequant warpgroup copies the packed bytes instead of
  converting them;
- `no_mma`: the consumers run no `wgmma`;
- `loads_only`: neither dequant arithmetic nor `wgmma`: TMA loads, scale
  loads, barriers, the shared-memory copy and the epilogue;
- `no_tma`: `loads_only` without the TMA loads.

Only `route` and `no_fence` compute y; every row gives its distance from the
route's rounding model (`q4_matmul_tiled_plain`) in units of the card test's
limit.

`--route gemv` times its builds at Llama-3.2-1B's decode shapes at M = 1
(wqkv, wo, w13, w2 with bf16 x and y, the lm_head with f32 y), each with the
plan `gemv_plan` gives it, beside `torch.matmul` on a bf16 weight, the bound
and one timed empty launch, and sums each build's single-stream step (16
layers and the lm_head). Its builds of `q4_gemv_kernel`:

- `route`: the source as it is;
- `no_dequant`: the dots take the packed words as floats (no (n - 8));
- `no_x`: x is a constant: no x loads;
- `loads_only`: neither (n - 8) nor the dots: the weight, scale and x loads
  folded into the sums, the reduction and the stores;
- `launch_only`: the kernel returns at once;
- `steps2`: 2 loads a row a lane in one load group (the route: 1);
- `no_prefetch`: a load group issued when it computes, not one group ahead;
- `all_tiles`: a block a tile (the route: as many blocks as the SMs hold at
  once, each walking tiles);
- `v1`: both, and 2 loads a row a lane: the first design of this route;

and three plans on the route's build: `rows1` and `rows4` (1 or 4 rows a
warp, the plan's slices) and `max_split` (the plan's rows, K in as many
slices as it takes, up to 8). Every row gives its distance from the plain
version over the card test's limit (1e-4 max|ref|, plus a bf16 ulp for bf16
y) where the build computes y. `--baseline FILE` also builds FILE, an
earlier copy of `csrc/q4_matmul.cu` whose `q4_matmul` entry takes no plan
(commit c11001d's: `git show c11001d:jlama_tpu_torch/csrc/q4_matmul.cu`),
times its M = 1 route at the same shapes (`baseline`), and times both at
f32 x, M = 1 and 16, on w13 with f32 y (`f32_rows`).

Card only: it raises without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from ..device import resolve_device
from ..nn.qarray import QArray
from ..ops import _build
from ..ops.q4_matmul import (_SIGNATURES, gemv_plan, q4_matmul_plain, q4_matmul_tiled_plain,
                             sm_count)
from ..utils.cuda_timer import Timer, bound
from ._common import SLEEP_CYCLES, build_cut_copies

_DEQUANT = """          uint4 o;
          o.x = scale2(dq2(v0), f);
          o.y = scale2(dq2(v0 >> 8), f);
          o.z = scale2(dq2(v1), f);
          o.w = scale2(dq2(v1 >> 8), f);"""
_COPY = "          uint4 o = make_uint4(v0, v1, v0 ^ 1u, v1 ^ 2u);"
_MMA = "wgmma_k16(d, sw128_desc(a + 32 * kk), sw128_desc(bb + 32 * kk), kt > 0 || kk > 0);"
_FENCE = '      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
_TMA_X = "        tma_load_2d(smem_u32(xs + st * C::kXBytes), &xmap, kt * kBK, m0, full);\n"
_TMA_W = "        tma_load_2d(smem_u32(pk + st * C::kPBytes), &wmap, kt * (kBK / 2), n0, full);\n"
_EXPECT = "mbar_arrive_expect_tx(full, C::kXBytes + C::kPBytes);"

_LOADS_ONLY = [(_DEQUANT, _COPY), (_MMA, "{}")]
ABLATIONS = {
    "route": [],
    "no_fence": [(_FENCE, "")],
    "no_dequant": [(_DEQUANT, _COPY)],
    "no_mma": [(_MMA, "{}")],
    "loads_only": _LOADS_ONLY,
    "no_tma": _LOADS_ONLY + [(_TMA_X, ""), (_TMA_W, ""),
                             (_EXPECT, "mbar_arrive_expect_tx(full, 0);")],
}
# Llama-3.2-1B's prefill shapes (N, K) at M = 512
SHAPES = {"wqkv": (3072, 2048), "wo": (2048, 2048), "w13": (16384, 2048), "w2": (2048, 8192),
          "lm_head": (128256, 2048)}
M = 512


def run(dev: torch.device) -> list[dict]:
    libs = build_cut_copies("q4_matmul", ABLATIONS, _SIGNATURES)
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for shape, (n, k) in SHAPES.items():
        w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8),
                   (torch.rand((n, k // 32), generator=g, device=dev) + 0.5) * 0.0043)
        x = torch.randn((M, k), generator=g, device=dev).to(torch.bfloat16)
        y = torch.empty((M, n), dtype=torch.bfloat16, device=dev)
        model = q4_matmul_tiled_plain(x, w.data, w.scales, torch.float32)
        # the card test's limit: 1e-4 max|model| plus one bf16 ulp
        lim = 1e-4 * model.abs().max() + 2.0 ** -7 * model.abs()
        wd = w.dequantize(torch.bfloat16)
        lib_ms = timer(lambda: torch.matmul(x, wd.t()))
        b_ms, b_by = bound(M * k * 2 + n * k // 2 + n * k // 8 + M * n * 2, 2.0 * M * n * k)
        row = dict(shape=shape, M=M, N=n, K=k, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        for name, lib in libs.items():
            args = (x.data_ptr(), 1, w.data.data_ptr(), w.scales.data_ptr(), y.data_ptr(), 1,
                    M, n, k, 0, 0, stream)
            _build.check(lib.q4_matmul(*args), f"k1_ablate {name}")
            torch.cuda.synchronize(dev)
            err = ((y.float() - model).abs() / lim).max().item()
            row[name] = dict(ms=timer(lambda: lib.q4_matmul(*args), sleep_cycles=SLEEP_CYCLES),
                             err_over_limit=err)
        rows.append(row)
        print(f"{shape} M={M} N={n} K={k}: torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f}; "
              + ", ".join(f"{a} {row[a]['ms']:.4f}" for a in libs), flush=True)
        del w, wd, x, y, model, lim
    return rows


# ---- the GEMV (M = 1) ------------------------------------------------------

_G_DQ = """          deq_block(pk[u][r], wv);
          acc[r][0] = fmaf(dot32(xv, wv), sc[u][r], acc[r][0]);
"""
_G_RAW = """          const uint32_t q[4] = {pk[u][r].x, pk[u][r].y, pk[u][r].z, pk[u][r].w};
#pragma unroll
          for (int e = 0; e < 32; ++e) wv[e] = __uint_as_float(q[e & 3]);
          acc[r][0] = fmaf(dot32(xv, wv), sc[u][r], acc[r][0]);
"""
# keeps every weight, scale and x load live: a sum no shift or XOR can cancel
_G_FOLD = """          const uint4 q = pk[u][r];
          acc[r][0] += __uint_as_float((q.x + 3u * q.y + 5u * q.z + 7u * q.w) & 0x007FFFFFu) *
                       sc[u][r] + xv[0] + xv[8] + xv[16] + xv[24];
"""
_G_X = "        load_x32(x + (size_t)b * 32, xv);\n"
_G_NO_X = """#pragma unroll
        for (int e = 0; e < 32; ++e) xv[e] = 1.0f + e;
"""
_G_STEPS = "constexpr int kGemvSteps = 1;"
_G_TOP = "  __shared__ float red[kGemvWarps][R * MT];\n"
_G_PREFETCH = "    load(next_tile, next_it, nk, ns);  // in flight while this group computes\n"
_G_SWAP = """        pk[u][r] = nk[u][r];
        sc[u][r] = ns[u][r];
"""
_G_NO_PREFETCH = [(_G_PREFETCH, "    if (it > 0 || tile != blockIdx.x) load(tile, it, pk, sc);\n"),
                  (_G_SWAP, "")]
_G_GRID = "  const int grid = min(tiles, per_sm * sm_count());"
_G_ALL_TILES = [(_G_GRID, "  const int grid = tiles;")]
GEMV_ABLATIONS = {
    "route": [],
    "no_dequant": [(_G_DQ, _G_RAW)],
    "no_x": [(_G_X, _G_NO_X)],
    "loads_only": [(_G_DQ, _G_FOLD)],
    "launch_only": [(_G_TOP, _G_TOP + "  if (N > 0) return;\n")],
    "steps2": [(_G_STEPS, "constexpr int kGemvSteps = 2;")],
    "no_prefetch": _G_NO_PREFETCH,
    "all_tiles": _G_ALL_TILES,
    "v1": _G_NO_PREFETCH + _G_ALL_TILES + [(_G_STEPS, "constexpr int kGemvSteps = 2;")],
}
# builds that compute y, and the plans timed on the route's build: (rows,
# slices) from the shape and the route's own plan
_G_EXACT = ("route", "steps2", "no_prefetch", "all_tiles", "v1")


def _max_split(k: int) -> int:
    units = -(-(k // 32) // 32)
    return max(s for s in (1, 2, 4, 8) if (s - 1) * -(-units // s) < units)


_G_PLANS = {"rows1": lambda n, k, p: (1, p[1]), "rows4": lambda n, k, p: (4, p[1]),
            "max_split": lambda n, k, p: (p[0], _max_split(k))}
GEMV_SHAPES = {"wqkv": (3072, 2048), "wo": (2048, 2048), "w13": (16384, 2048),
               "w2": (2048, 8192), "lm_head": (128256, 2048)}
N_LAYERS = 16  # Llama-3.2-1B: a step is 16 x (wqkv, wo, w13, w2) + the lm_head


_BASELINE_SIGNATURES = {"q4_matmul": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
                        + [ctypes.c_void_p]}


def run_gemv(dev: torch.device, baseline: str | None = None) -> dict:
    libs = build_cut_copies("q4_matmul", GEMV_ABLATIONS, _SIGNATURES, tag="_gemv")
    base = None
    if baseline is not None:
        base = build_cut_copies("q4_matmul", {"baseline": []}, _BASELINE_SIGNATURES,
                                src=Path(baseline).read_text(), tag="_baseline")["baseline"]
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    empty_ms = timer(lambda: torch.cuda._sleep(1), sleep_cycles=SLEEP_CYCLES)

    def case(n, k, m, x_dtype, out_dtype):
        w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8),
                   (torch.rand((n, k // 32), generator=g, device=dev) + 0.5) * 0.0043)
        x = torch.randn((m, k), generator=g, device=dev).to(x_dtype)
        y = torch.empty((m, n), dtype=out_dtype, device=dev)
        ref = q4_matmul_plain(x, w.data, w.scales, torch.float32)
        lim = 1e-4 * ref.abs().max()
        if out_dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * ref.abs()
        codes = (1 if x_dtype == torch.bfloat16 else 0, 1 if out_dtype == torch.bfloat16 else 0)
        return w, x, y, ref, lim, codes

    def timed(lib, args, y, ref, lim, exact):
        y.fill_(float("nan"))  # a build that writes nothing must not pass on stale output
        _build.check(lib.q4_matmul(*args), "k1_ablate")
        torch.cuda.synchronize(dev)
        err = ((y.float() - ref).abs() / lim).max().item() if exact else None
        return dict(ms=timer(lambda: lib.q4_matmul(*args), sleep_cycles=SLEEP_CYCLES),
                    err_over_limit=err)

    rows = []
    for shape, (n, k) in GEMV_SHAPES.items():
        out_dtype = torch.float32 if shape == "lm_head" else torch.bfloat16
        w, x, y, ref, lim, (cx, cy) = case(n, k, 1, torch.bfloat16, out_dtype)
        wd = w.dequantize(torch.bfloat16)
        lib_ms = timer(lambda: torch.matmul(x, wd.t()), sleep_cycles=SLEEP_CYCLES)
        nbytes = k * 2 + n * k // 2 + n * k // 8 + n * y.element_size()
        b_ms, b_by = bound(nbytes, 2.0 * n * k)
        row = dict(shape=shape, M=1, N=n, K=k, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   plan=list(gemv_plan(1, n, k, sms)))
        head = (x.data_ptr(), cx, w.data.data_ptr(), w.scales.data_ptr(), y.data_ptr(), cy, 1, n, k)
        runs = [(name, lib, row["plan"][:2]) for name, lib in libs.items()]
        runs += [(name, libs["route"], plan(n, k, row["plan"])) for name, plan in _G_PLANS.items()]
        for name, lib, (pr, ps) in runs:
            row[name] = timed(lib, head + (pr, ps, stream), y, ref, lim,
                              name in _G_EXACT or name in _G_PLANS)
            row[name]["plan"] = [pr, ps]
        if base is not None:
            row["baseline"] = timed(base, head + (stream,), y, ref, lim, True)
        rows.append(row)
        names = [a for a in row if isinstance(row[a], dict)]
        print(f"gemv {shape} M=1 N={n} K={k} plan {row['plan']}: torch.matmul {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f}; " + ", ".join(f"{a} {row[a]['ms']:.4f}" for a in names),
              flush=True)
        del w, wd, x, y, ref, lim
    names = [a for a in rows[0] if isinstance(rows[0][a], dict)]
    step = {}
    for key in names + ["library_ms", "bound_ms"]:
        per = {r["shape"]: (r[key]["ms"] if isinstance(r[key], dict) else r[key]) for r in rows}
        step[key] = N_LAYERS * sum(per[s] for s in ("wqkv", "wo", "w13", "w2")) + per["lm_head"]
    print(f"gemv one decode step (65 launches), empty launch {empty_ms:.4f} ms: "
          + ", ".join(f"{a} {v:.4f}" for a, v in step.items()), flush=True)
    f32_rows = []
    if base is not None:  # f32 x through the route's build and the baseline's
        n, k = GEMV_SHAPES["w13"]
        for m in (1, 16):
            w, x, y, ref, lim, (cx, cy) = case(n, k, m, torch.float32, torch.float32)
            pr, ps, _ = gemv_plan(m, n, k, sms)
            head = (x.data_ptr(), cx, w.data.data_ptr(), w.scales.data_ptr(), y.data_ptr(), cy,
                    m, n, k)
            r = dict(shape="w13", M=m, x_dtype="f32", plan=[pr, ps],
                     route=timed(libs["route"], head + (pr, ps, stream), y, ref, lim, True),
                     baseline=timed(base, head + (stream,), y, ref, lim, True))
            f32_rows.append(r)
            print(f"gemv w13 M={m} f32 x, f32 y, plan [{pr}, {ps}]: route {r['route']['ms']:.4f} "
                  f"ms, baseline {r['baseline']['ms']:.4f} ms", flush=True)
            del w, x, y, ref, lim
    return dict(empty_launch_ms=empty_ms, rows=rows, step_ms=step, f32_rows=f32_rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("prefill", "gemv"), default="prefill")
    ap.add_argument("--baseline", help="gemv: an earlier csrc/q4_matmul.cu to time beside")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    rows = run(dev) if args.route == "prefill" else run_gemv(dev, args.baseline)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=torch.cuda.get_device_name(dev),
                                                  route=args.route, rows=rows), indent=1))
    return rows


if __name__ == "__main__":
    main()
