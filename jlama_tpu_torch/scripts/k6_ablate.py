"""Ablations of K6's decode route on the card: where its time goes.

    python -m jlama_tpu_torch.scripts.k6_ablate [--out FILE]

Builds `csrc/moe_q4.cu` as it is and copies of it with parts of the decode
route (`moe_q4_decode_kernel`) cut out or changed, each with nvcc into
`_build/ablate_moe_q4/`, and times every build through the route (the C
entry's route 1) at Mixtral-8x7B's expert shapes, random JQ4 stacks of 8
experts: gate and up in one call ("w13": w1 and w3, N 14336, K 4096, one x
row a token, bf16 y) and w2 (N 4096, K 14336, one x row a selection, f32 y),
at R = 2 (the `Engine`'s decode step: 2 experts), R = 32 with random top-2
routing (8 experts) and R = 32 as the 16-slot serving steps route (2 experts,
16 rows each), beside the bound and the grid kernel (`moe_q4_mma_kernel`, one
launch a stack):

- `route`: the source as it is;
- `no_mma`: no `mma.sync`: the dequantized weights and x are folded into the
  sums by one XOR;
- `no_dequant`: the packed words go to the `mma` as they are (no (n - 8));
- `loads_only`: both: the copies of the weights and scales, the x loads, the
  reads of the slots, the sums across the warps and the stores;
- `no_x`: x is a constant: no x loads;
- `ahead1`, `ahead4`, `ahead8`: the weight copies of 1, 4 or 8 steps in
  flight ahead of the computed one (the route: 2);
- `blocks1`, `blocks3`: launch bounds asking 1 or 3 blocks an SM (the
  route: 2).

Every row gives its distance from the plain version (`moe_q4_matmul_plain`)
over the card test's limit (1e-4 max|ref|, plus a bf16 ulp for bf16 y) where
the build computes y.

Card only: it raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..device import resolve_device
from ..nn.qarray import QArray
from ..ops import _build
from ..ops.moe_q4 import (_DTYPE_CODE, _ROUTES, _SIGNATURES, moe_groups, moe_q4_matmul_plain,
                          row_tile)
from ..utils.cuda_timer import Timer, bound
from ._common import SLEEP_CYCLES, build_cut_copies

_MMA = """          mma_bf16(c, lo, __byte_perm(v0.x, v0.y, 0x5410), __byte_perm(v0.x, v0.y, 0x7632),
                   zero);
          mma_bf16(c, hi, __byte_perm(v1.x, v1.y, 0x5410), __byte_perm(v1.x, v1.y, 0x7632), c);"""
_NO_MMA = """          c[0] = __uint_as_float(lo[0] ^ lo[1] ^ lo[2] ^ lo[3] ^ hi[0] ^ hi[1] ^ hi[2] ^ hi[3] ^
                                 v0.x ^ v0.y ^ v1.x ^ v1.y) * 1e-30f;
          c[1] = c[2] = c[3] = c[0];"""
_DQ = """        const uint32_t lo[4] = {dq2(r0), dq2(r1), dq2(r0 >> 8), dq2(r1 >> 8)};
        const uint32_t hi[4] = {dq2(r0 >> 4), dq2(r1 >> 4), dq2(r0 >> 12), dq2(r1 >> 12)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) break;"""
_NO_DQ = """        const uint32_t lo[4] = {r0, r1, r0 >> 8, r1 >> 8};
        const uint32_t hi[4] = {r0 >> 4, r1 >> 4, r0 >> 12, r1 >> 12};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) break;"""
_X = "? ldg_x(xr[j], b0 + i, h)"
_BOUNDS = "__global__ void __launch_bounds__(kDecWarps * 32, 2)\nmoe_q4_decode_kernel("
_AHEAD = "constexpr int kDecAhead = 2;"

DECODE_ABLATIONS: dict[str, list[tuple[str, str]]] = {
    "route": [],
    "no_mma": [(_MMA, _NO_MMA)],
    "no_dequant": [(_DQ, _NO_DQ)],
    "loads_only": [(_MMA, _NO_MMA), (_DQ, _NO_DQ)],
    "no_x": [(_X, "? make_uint2(b0 + i, h)")],
    "ahead1": [(_AHEAD, "constexpr int kDecAhead = 1;")],
    "ahead4": [(_AHEAD, "constexpr int kDecAhead = 4;")],
    "ahead8": [(_AHEAD, "constexpr int kDecAhead = 8;")],
    "blocks1": [(_BOUNDS, _BOUNDS.replace("32, 2)", "32, 1)"))],
    "blocks3": [(_BOUNDS, _BOUNDS.replace("32, 2)", "32, 3)"))],
}
_EXACT = ("route", "ahead1", "ahead4", "ahead8", "blocks1", "blocks3")
N_EXPERTS, TOP_K, N_LAYERS = 8, 2, 32  # Mixtral-8x7B
SHAPES = {"w13": (14336, 4096), "w2": (4096, 14336)}


def _stack(g, dev, n, k):
    return QArray(torch.randint(0, 256, (N_EXPERTS, n, k // 2), generator=g, device=dev,
                                dtype=torch.uint8),
                  (torch.rand((N_EXPERTS, n, k // 32), generator=g, device=dev) + 0.5) * 0.0043)


def _ids(g, dev, r, routing):
    """[r / 2, 2] top-2 ids: "random" (distinct experts of 8 per token), or
    "serving" (every token on experts 2 and 5, as the serving steps measured
    route: 2 experts, R / 2 rows each)."""
    t = r // TOP_K
    if routing == "serving":
        return torch.tensor([[2, 5]] * t, dtype=torch.int32, device=dev)
    pick = torch.rand((t, N_EXPERTS), generator=g, device=dev).argsort(dim=1)[:, :TOP_K]
    return pick.to(torch.int32)


def run(dev: torch.device) -> dict:
    libs = build_cut_copies("moe_q4", DECODE_ABLATIONS, _SIGNATURES)
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    stacks = {"w13": [_stack(g, dev, *SHAPES["w13"]) for _ in range(2)],
              "w2": [_stack(g, dev, *SHAPES["w2"])]}
    rows = []
    for r, routing in ((2, "random"), (32, "random"), (32, "serving")):
        for proj, ws in stacks.items():
            n, k = SHAPES[proj]
            e = _ids(g, dev, r, routing)
            if proj == "w2":  # one x row a selection
                e = e.reshape(-1)
            x = torch.randn((e.shape[0], k), generator=g, device=dev).to(torch.bfloat16)
            per = r // e.shape[0]
            out_dtype = torch.bfloat16 if proj == "w13" else torch.float32
            groups = moe_groups(e, N_EXPERTS)
            ys = [torch.empty((r, n), dtype=out_dtype, device=dev) for _ in ws]
            refs = [moe_q4_matmul_plain(x, w, e, torch.float32).reshape(r, n) for w in ws]
            lims = []
            for ref in refs:
                lim = 1e-4 * ref.abs().max()
                lims.append(lim + 2.0 ** -7 * ref.abs() if out_dtype == torch.bfloat16 else lim)
            args = (x.data_ptr(), per, ws[0].data.data_ptr(), ws[0].scales.data_ptr(),
                    ws[1].data.data_ptr() if len(ws) > 1 else None,
                    ws[1].scales.data_ptr() if len(ws) > 1 else None, groups.order.data_ptr(),
                    groups.tiles.data_ptr(), groups.dtiles.data_ptr(), groups.counts.data_ptr(),
                    ys[0].data_ptr(), ys[1].data_ptr() if len(ws) > 1 else None,
                    _DTYPE_CODE[out_dtype], r, N_EXPERTS, n, k, _ROUTES["decode"], None, stream)
            touched = int(torch.unique(e).numel())
            nbytes = len(ws) * (touched * n * k * 5 // 8 + r * n * ys[0].element_size()) \
                + x.numel() * 2 + e.numel() * 4
            b_ms, b_by = bound(nbytes, 2.0 * r * n * k * len(ws))
            row = dict(shape=proj, R=r, routing=routing, N=n, K=k, experts_touched=touched,
                       bound_ms=b_ms, bound_by=b_by)
            for name, lib in libs.items():
                for y in ys:
                    y.fill_(float("nan"))  # a build that writes nothing must not pass on stale y
                _build.check(lib.moe_q4_matmul(*args), "k6_ablate")
                torch.cuda.synchronize(dev)
                err = max(((y.float() - ref).abs() / lim).max().item()
                          for y, ref, lim in zip(ys, refs, lims)) if name in _EXACT else None
                row[name] = dict(ms=timer(lambda: lib.moe_q4_matmul(*args),
                                          sleep_cycles=SLEEP_CYCLES), err_over_limit=err)

            def grid():
                for w, y in zip(ws, ys):
                    _build.check(libs["route"].moe_q4_mma_matmul(
                        x.data_ptr(), per, w.data.data_ptr(), w.scales.data_ptr(),
                        groups.order.data_ptr(), groups.offsets.data_ptr(), y.data_ptr(),
                        _DTYPE_CODE[out_dtype], r, N_EXPERTS, n, k, row_tile(r), stream),
                        "k6_ablate")

            row["grid"] = dict(ms=timer(grid, sleep_cycles=SLEEP_CYCLES))
            rows.append(row)
            names = [a for a in row if isinstance(row[a], dict)]
            print(f"k6 decode {proj} R={r} {routing} ({touched} experts): bound {b_ms:.4f} ms; "
                  + ", ".join(f"{a} {row[a]['ms']:.4f}" for a in names), flush=True)
            del x, e, ys, refs, lims, groups
    names = [a for a in rows[0] if isinstance(rows[0][a], dict)]
    steps = {}
    for r, routing in ((2, "random"), (32, "serving")):
        sel = [row for row in rows if row["R"] == r and row["routing"] == routing]
        steps[f"R{r}_{routing}"] = {a: N_LAYERS * sum(row[a]["ms"] for row in sel)
                                    for a in names}
        print(f"k6 decode summed over a step ({N_LAYERS} x (w13, w2)), R = {r} {routing}: "
              + ", ".join(f"{a} {v:.3f}" for a, v in steps[f"R{r}_{routing}"].items()),
              flush=True)
    return dict(rows=rows, steps_ms=steps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    out = run(dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=torch.cuda.get_device_name(dev), **out),
                                             indent=1))
    return out


if __name__ == "__main__":
    main()
