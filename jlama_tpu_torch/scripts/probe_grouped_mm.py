"""Probe of the card's `torch._grouped_mm` for the float (bf16) MoE experts.

    python -m jlama_tpu_torch.scripts.probe_grouped_mm [--out FILE]

The JAX package runs float experts through `jax.lax.ragged_dot`, an XLA op
and no Pallas body, so the port may take a library grouped product there if
the card's PyTorch has one that reads the group offsets on the device (no
host sync: a decode step must stay capturable in a CUDA graph). This prints
one JSON object saying, for this PyTorch build:

- whether `torch._grouped_mm` exists and takes bf16 x [R, K] against a bf16
  stack [E, K, N] with int32 device offsets, for the stack as a transposed
  view of [E, N, K] (the checkpoint's layout) and as a contiguous [E, K, N];
- whether it takes `out_dtype=torch.float32` (the JAX package keeps the down
  projection in f32);
- its largest distance from a plain per-group f32 product rounded to bf16,
  with an empty expert and with every row on one expert, and whether a
  repeat is bit-equal;
- whether a CUDA graph captures it and a replay reads offsets written in
  place after the capture;
- its median ms after an L2 flush at Mixtral-8x7B's expert shapes (8
  experts, gate [R, 4096] x [8, 4096, 14336], down [R, 14336] x [8, 14336,
  4096]) at R = 2, 32 and 1024 (top-2 routing over 1, 16 and 512 tokens),
  beside the bound (the touched experts' bf16 bytes at 3.35 TB/s or the
  operations at 989 TFLOP/s).

Card only: it raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import traceback

import torch

from ..device import resolve_device
from ..utils.cuda_timer import Timer, bound


def _plain(x, w, offs):
    """Per-group f32 products of bf16 values, rounded to bf16."""
    y = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32, device=x.device)
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        if hi > lo:
            y[lo:hi] = x[lo:hi].float() @ w[g].float()
        lo = hi
    return y


def _offsets(e: torch.Tensor, n_exp: int) -> torch.Tensor:
    return torch.cumsum(torch.bincount(e, minlength=n_exp), 0).to(torch.int32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    out: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                 "device": torch.cuda.get_device_name(0),
                 "has_grouped_mm": hasattr(torch, "_grouped_mm")}
    if not out["has_grouped_mm"]:
        print(json.dumps(out))
        return
    g = torch.Generator(device=dev).manual_seed(0)
    n_exp, k, n = 8, 256, 512
    x = torch.randn((64, k), generator=g, device=dev).to(torch.bfloat16)
    base = torch.randn((n_exp, n, k), generator=g, device=dev).to(torch.bfloat16)
    layouts = {"transposed_view": base.transpose(-1, -2),
               "contiguous": base.transpose(-1, -2).contiguous()}
    cases = {
        "random": torch.randint(0, n_exp, (64,), generator=g, device=dev),
        "empty_expert": torch.randint(0, n_exp - 1, (64,), generator=g, device=dev),
        "one_expert": torch.full((64,), 3, device=dev),
    }
    for lname, w in layouts.items():
        res = {}
        for cname, e in cases.items():
            offs = _offsets(e, n_exp)
            xs = x[torch.sort(e, stable=True).indices]
            try:
                y = torch._grouped_mm(xs, w, offs=offs)
                y2 = torch._grouped_mm(xs, w, offs=offs)
                ref = _plain(xs, w, offs)
                res[cname] = {"dtype": str(y.dtype),
                              "max_abs_err": float((y.float() - ref).abs().max()),
                              "ref_max": float(ref.abs().max()),
                              "repeat_equal": bool(torch.equal(y, y2))}
            except Exception as ex:  # the probe reports what the build refuses
                res[cname] = {"error": f"{type(ex).__name__}: {ex}"}
        try:
            offs = _offsets(cases["random"], n_exp)
            y = torch._grouped_mm(x, w, offs=offs, out_dtype=torch.float32)
            res["out_dtype_f32"] = {"dtype": str(y.dtype),
                                    "max_abs_err": float((y - _plain(x, w, offs)).abs().max())}
        except Exception as ex:
            res["out_dtype_f32"] = {"error": f"{type(ex).__name__}: {ex}"}
        out[lname] = res

    # graph capture: offsets written in place after the capture
    w = layouts["transposed_view"]
    try:
        offs = _offsets(cases["random"], n_exp).clone()
        xs = x.clone()
        torch._grouped_mm(xs, w, offs=offs)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            yg = torch._grouped_mm(xs, w, offs=offs)
        offs.copy_(_offsets(cases["one_expert"], n_exp))
        graph.replay()
        torch.cuda.synchronize()
        out["graph"] = {"replay_equals_eager": bool(torch.equal(
            yg, torch._grouped_mm(xs, w, offs=offs)))}
    except Exception as ex:
        out["graph"] = {"error": f"{type(ex).__name__}: {ex}",
                        "trace": traceback.format_exc()[-800:]}

    # timing at Mixtral-8x7B's expert shapes
    timer = Timer(dev)
    d, h = 4096, 14336
    w13 = (torch.randn((n_exp, h, d), generator=g, device=dev) * 0.02).to(
        torch.bfloat16).transpose(-1, -2)
    w2 = (torch.randn((n_exp, d, h), generator=g, device=dev) * 0.02).to(
        torch.bfloat16).transpose(-1, -2)
    times = {}
    for r in (2, 32, 1024):
        e = torch.randint(0, n_exp, (r,), generator=g, device=dev)
        if r == 2:
            e = torch.tensor([1, 5], device=dev)
        offs = _offsets(e, n_exp)
        touched = int((torch.bincount(e, minlength=n_exp) > 0).sum())
        xa = torch.randn((r, d), generator=g, device=dev).to(torch.bfloat16)
        xb = torch.randn((r, h), generator=g, device=dev).to(torch.bfloat16)
        row = {}
        for name, xx, ww, kk, nn in (("gate", xa, w13, d, h), ("down", xb, w2, h, d)):
            ms = timer(lambda: torch._grouped_mm(xx, ww, offs=offs))
            b, by = bound(touched * kk * nn * 2 + r * (kk + nn) * 2, 2 * r * kk * nn)
            row[name] = {"ms": ms, "bound_ms": b, "bound_by": by, "experts": touched}
        times[str(r)] = row
    out["mixtral_times"] = times
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
