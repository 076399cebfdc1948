"""Ablations of K3's bf16 route (TMA + wgmma) on the card: where its time goes.

    python -m jlama_tpu_torch.scripts.k3_ablate [--out FILE]

Builds `csrc/flash_prefill.cu` as it is and copies of it with parts of the
bf16 route cut out, each with nvcc into `_build/ablate_flash_prefill/`, and
times every build at Llama-3.2-1B's 512-token prefill (B 1, H 32, n_kv 8,
T = S = 512, hd 64), at Llama-3.1-8B's head size (hd 128) and at a
512-token chunk after 512 cached tokens, beside SDPA and the bound:

- `route`: the source as it is;
- `no_mask`: no tile is masked (wrong output: the causal diagonal leaks);
- `no_exp`: the softmax's two `ex2` cut to their arguments;
- `no_qk`: no S = Q·Kᵀ `wgmma`;
- `no_pv`: no O += P·V `wgmma`;
- `no_mma`: neither `wgmma`;
- `skeleton`: neither `wgmma` nor `ex2`: TMA loads, barriers, the row max,
  the mask, the bf16 packing and the epilogue;
- `no_tma`: `skeleton` without the K/V loads (Q is still loaded);
- `no_tiles`: no key tile at all: the launch, the Q load and the epilogue;
- `no_q`: `no_tiles` without the Q load;
- `launch_only`: `no_q` without the output's TMA store: the launch, the
  barriers' set-up, the staging of zeros in shared memory and the exit.

Beside them each row times an empty launch (`torch.cuda._sleep(1)`), what
the timer reads for any kernel.

Only `route` computes the function; every row gives its distance from the
route's rounding model (`flash_prefill_tiled_plain`). Card only: it raises
without a GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import _build
from ..ops.attention import _SIGNATURES, flash_prefill_tiled_plain
from ..utils.cuda_timer import Timer, bound
from ._common import SLEEP_CYCLES, build_cut_copies

_QK = """      wgmma_ss(s, kmajor_desc(qa + (kk >> 2) * BQ * kRowBytes + 32 * (kk & 3)),
               kmajor_desc(kb + (kk >> 2) * BS * kRowBytes + 32 * (kk & 3)), kk > 0);
"""
_PV = ("      wgmma_rs(acc, pa[c], mnmajor_desc(vb + c * 16 * kRowBytes, BS * kRowBytes), "
       "it > 0 || c > 0);\n")
# without a product its accumulator is left opaque, so nothing after it folds away
_NO_QK = [(_QK, "      fence_operands(s);\n")]
_NO_PV = [(_PV, "      fence_operands(acc);\n")]
_NO_EXP = [("ex2((m[i] - m_new) * zs)", "((m[i] - m_new) * zs)"),
           ("ex2(fmaf(s[4 * j + x], zs, nbase[x >> 1]))", "fmaf(s[4 * j + x], zs, nbase[x >> 1])")]
_EDGE = """    if (s0 + BS > S || (causal && s0 + BS - 1 > p0 + t0) ||
        (window > 0 && s0 <= p0 + t_last - window)) {
"""
_TMA_KV = """          tma_load_4d(smem_u32(ks + off), &kmap, bx * kBoxCols, s0, kvh, b, full);
          tma_load_4d(smem_u32(vs + off), &vmap, bx * kBoxCols, s0, kvh, b, full);
"""
_N_TILES = "const int n_tiles = s_end > s_begin ? (s_end - s_begin + BS - 1) / BS : 0;"
_NO_TILES = [(_N_TILES, "const int n_tiles = 0 * (s_end - s_begin);")]
_Q_LOAD = """      mbar_arrive_expect_tx(qbar, C::kQBytes);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
        tma_load_4d(smem_u32(qs + bx * BQ * kRowBytes), &qmap, bx * kBoxCols, t0, h, b, qbar);
"""
_O_STORE = ("      tma_store_4d(&omap, smem_u32(ot + bx * BQ * kRowBytes), bx * kBoxCols, "
            "t0 + 64 * wg, h, b);\n")
_NO_Q = _NO_TILES + [(_Q_LOAD, "      mbar_arrive_expect_tx(qbar, 0);\n")]
_SKELETON = _NO_QK + _NO_PV + _NO_EXP
ABLATIONS = {
    "route": [],
    "no_mask": [(_EDGE, "    if (false) {\n")],
    "no_exp": _NO_EXP,
    "no_qk": _NO_QK,
    "no_pv": _NO_PV,
    "no_mma": _NO_QK + _NO_PV,
    "skeleton": _SKELETON,
    "no_tma": _SKELETON + [(_TMA_KV, ""), ("mbar_arrive_expect_tx(full, 2 * C::kTileBytes);",
                                           "mbar_arrive_expect_tx(full, 0);")],
    "no_tiles": _NO_TILES,
    "no_q": _NO_Q,
    "launch_only": _NO_Q + [(_O_STORE, "      {}\n")],
}
H, N_KV = 32, 8
CASES = {  # name: (T, S, pos0, hd)
    "1b_prefill": (512, 512, 0, 64),
    "8b_prefill": (512, 512, 0, 128),
    "1b_after_512": (512, 1024, 512, 64),
}


def run(dev: torch.device) -> list[dict]:
    libs = build_cut_copies("flash_prefill", ABLATIONS, _SIGNATURES)
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for case, (T, S, p0, hd) in CASES.items():
        q = torch.randn((1, H, T, hd), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((1, N_KV, S, hd), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((1, N_KV, S, hd), generator=g, device=dev).to(torch.bfloat16)
        pos0 = torch.full((1,), p0, dtype=torch.int32, device=dev)
        out = torch.empty((1, T, H, hd), dtype=torch.bfloat16, device=dev).transpose(1, 2)
        scale = hd ** -0.5
        model = flash_prefill_tiled_plain(q, k, v, pos0, scale).float()
        if T == S and p0 == 0:
            lib_ms = timer(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                  scale=scale, enable_gqa=True))
        else:
            kp = torch.arange(S, device=dev)[None, :]
            mask = kp <= p0 + torch.arange(T, device=dev)[:, None]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                  scale=scale, enable_gqa=True))
        live = sum(min(S, p0 + t + 1) for t in range(T)) * H
        b_ms, b_by = bound(2 * (2 * H * T * hd + 2 * N_KV * S * hd), 4.0 * hd * live)
        row = dict(case=case, T=T, S=S, pos0=p0, hd=hd, sdpa_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, empty_launch_ms=timer(lambda: torch.cuda._sleep(1)))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), pos0.data_ptr(), 1, 1,
                H, N_KV, T, S, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], scale, 0.0, 0, 1, stream)
        for name, lib in libs.items():
            _build.check(lib.flash_prefill(*args), f"k3_ablate {name}")
            torch.cuda.synchronize(dev)
            err = (out.float() - model).abs().max().item()
            row[name] = dict(ms=timer(lambda: lib.flash_prefill(*args), sleep_cycles=SLEEP_CYCLES),
                             err_from_model=err)
        rows.append(row)
        print(f"{case} T={T} S={S} pos0={p0} hd={hd}: sdpa {lib_ms:.4f} ms, bound {b_ms:.4f}, "
              f"empty launch {row['empty_launch_ms']:.4f}; "
              + ", ".join(f"{a} {row[a]['ms']:.4f}" for a in libs), flush=True)
        del q, k, v, out, model
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
