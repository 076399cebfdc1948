"""Ablations of K1's wgmma route (M > 16) on the card: where its time goes.

    python -m jlama_tpu_torch.scripts.k1_ablate [--out FILE]

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
limit. Card only: it raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..device import resolve_device
from ..nn.qarray import QArray
from ..ops import _build
from ..ops.q4_matmul import _SIGNATURES, q4_matmul_tiled_plain
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
                    M, n, k, stream)
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
